"""kernels_per_pass: device kernels in the traced frame over its passes."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["n_kernels"]:
        return None
    return tr["n_kernels"] / rec["trace_passes"]
