"""k1_roofline: K1's least time (benchmark/roofline.py's count of the work
its calls need, at the chip's float32 and HBM peaks) over its device time
in the trace, for the calls of the traced frame's first pass, in %."""


def read(rec):
    k1 = rec.get("k1")
    if not k1 or k1["device_s"] <= 0:
        return None
    return 100.0 * k1["least_s"] / k1["device_s"]
