"""peak_mem_gb.path: the device memory allocated at its peak during the
window (the allocator's peak, reset at the window's start), in GB."""


def read(rec):
    b = rec.get("window_peak_bytes")
    return b / 1e9 if b else None
