"""chase_kernels_per_task.iile: device kernels launched inside the
``iile/chase`` spans of the traced frame (the pixels' specular chase,
innermost ``iile/`` span), over its tasks."""


def read(rec):
    by, tasks = rec.get("iile_spans"), rec.get("iile_trace_tasks")
    if not by or not tasks or "iile/chase" not in by:
        return None
    return by["iile/chase"]["kernels"] / tasks
