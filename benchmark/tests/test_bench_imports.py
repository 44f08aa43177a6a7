"""Nothing the harness loads is JAX or the JAX package, top-level names
compared whole, and the reference loads nothing of the port."""

import os
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); {code}; "
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_driver_load_no_jax():
    mods = _modules_after(
        "from benchmark import harness, calibrate, compare, roofline, tracing; "
        "from benchmark.drivers import path_frames; "
        "from pbrt_v3_iile_tpu_torch.integrators import render")
    assert not mods & set(harness.FORBIDDEN)
    assert "pbrt_v3_iile_tpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after("from benchmark.reference import pbrt_path")
    assert not mods & set(harness.FORBIDDEN)
    assert "pbrt_v3_iile_tpu_torch" not in mods


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules({"pbrt_v3_iile_tpu_torch.ops": 1, "numpy": 1}) == []
    assert harness.forbidden_modules({"pbrt_v3_iile_tpu.ops.bsdf": 1}) == ["pbrt_v3_iile_tpu"]
    assert harness.forbidden_modules({"jax.numpy": 1, "jaxlib": 1, "flaxy": 1}) == \
        ["jax", "jaxlib"]


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "atrium-path-1440sq", "--seed", str(2**31 + 7),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()
