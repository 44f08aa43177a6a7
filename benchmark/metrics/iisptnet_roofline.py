"""iisptnet_roofline: IISPTNet's least time (benchmark/roofline_iile.py's
operations and bytes of the traced frame's probes, at the chip's float32
and HBM peaks) over the device time of the operations launched inside
the traced frame's ``iile/cnn`` spans, in %."""


def read(rec):
    n = rec.get("iisptnet")
    if not n or n["device_s"] <= 0:
        return None
    return 100.0 * n["least_s"] / n["device_s"]
