"""probes_device_ms.iile: device ms of the operations launched inside the
``iile/probes`` spans of the traced frame (the probes' specular chase and
their G-buffer trace), over its tasks."""


def read(rec):
    by, tasks = rec.get("iile_spans"), rec.get("iile_trace_tasks")
    if not by or not tasks or "iile/probes" not in by:
        return None
    return 1e3 * by["iile/probes"]["device_s"] / tasks
