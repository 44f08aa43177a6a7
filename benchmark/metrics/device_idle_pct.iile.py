"""device_idle_pct.iile: the share of an untraced IILE frame's wall time in
which no operation ran on the device, in %.

The frame is one of the traffic's ``traced`` schedule, rendered after the
window twice from one seed: its busy time is the union of device
intervals of the traced rendering, its wall the untraced one's (the
profiler lengthens the traced rendering's own wall)."""


def read(rec):
    tr, wall = rec.get("trace"), rec.get("untraced_wall_s")
    if not tr or not wall:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / wall)
