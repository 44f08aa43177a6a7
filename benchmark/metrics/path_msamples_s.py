"""path_msamples_s: pixel samples of the window's whole frames, in
millions, over the seconds from the window's start to the end of the
last frame."""


def read(rec):
    if not rec.get("frames"):
        return None
    return rec["samples"] / rec["window_s"] / 1e6
