"""device_idle_pct.path: the share of an untraced frame's wall time in
which no operation ran on the device, in %.

The busy time is the union of device intervals of the traced frame, which
runs after the window; the wall time is the window's mean whole frame of
the same run.  The traced frame's own wall is not used: the profiler's
cost on each launch lengthens it by half or more, while the device's
intervals are those of the untraced work."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not rec.get("frames") or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / (rec["window_s"] / rec["frames"]))
