"""peak_mem_gb.iile: the device memory allocated at its peak during the
window of IILE frames (the allocator's peak, reset at the window's start),
in GB."""


def read(rec):
    b = rec.get("window_peak_bytes")
    return b / 1e9 if b else None
