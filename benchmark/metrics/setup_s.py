"""setup_s: seconds from the process's start to the first timed call."""


def read(rec):
    return rec.get("setup_s")
