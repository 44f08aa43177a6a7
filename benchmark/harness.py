"""One run of one cell: ``python benchmark/run.py --workload NAME --seed N
--seconds S --trace 0|1``.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
its traffic in ``benchmark/workloads/<cell>.json`` (which names the driver
in ``benchmark/drivers/``), its configuration's file, and one reader a
metric in ``benchmark/metrics/<metric>.py``.  The driver returns a record;
each reader takes its metric from the record, or returns None when the
record has nothing for it.  The last line of standard output is the
result as one JSON object; the numbers compared, each with its limit, are
the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import types

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "pbrt_v3_iile_tpu")


class RunFailed(Exception):
    """The run cannot give a result (no card, a forbidden module)."""


def cache_env(root: str) -> dict:
    """Fixed cache directories inside the checkout."""
    base = os.path.join(root, "build", "bench_cache")
    return {"TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "CUDA_CACHE_PATH": os.path.join(base, "cuda")}


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT):
    """-> (manifest, workload entry, traffic dict, configuration dict)."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise RunFailed(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    with open(os.path.join(BENCH, "workloads", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    return man, cell, traffic, config


def metrics_for(man: dict, cell: str, trace: bool) -> list:
    """The manifest's metric entries that this cell reports."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, rec: dict):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    each name compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return ""


def result(man, cell_name, rec, trace, device_info) -> dict:
    """The record -> the result line's object."""
    metrics = {}
    for m in metrics_for(man, cell_name, trace):
        v = read_metric(m["name"], rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": rec["failed"] == 0 and rec["attempted"] > 0,
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device_info}
    if trace and rec.get("trace"):
        out["device"]["busy_s"] = rec["trace"]["busy_s"]
        out["device"]["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = {k: {"value": rec["checks"][k], "limit": rec["limits"][k]}
                     for k in rec["limits"]}
    return out


def main(argv=None, t_start=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        man, cell, traffic, config = load_cell(args.workload)
        import torch

        if not torch.cuda.is_available():
            raise RunFailed("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunFailed(f"{torch.cuda.device_count()} CUDA devices, the cell "
                            f"asks for {cell['chips']}")
        driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
        ctx = types.SimpleNamespace(root=ROOT, seed=args.seed, seconds=args.seconds,
                                    trace=bool(args.trace), config=config,
                                    traffic=traffic, t_start=t_start, device="cuda")
        rec = driver.run(ctx)
        bad = forbidden_modules()
        if bad:
            raise RunFailed(f"modules loaded that the benchmark must not load: {bad}")
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell["chips"], "memory_peak_bytes": int(rec["memory_peak_bytes"])}
        out = result(man, args.workload, rec, bool(args.trace), info)
    except RunFailed as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    out["power"] = power_limit()
    checks = out.pop("checks")
    out["checks"] = checks           # the compared numbers come last
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
