"""The IILE reference loads nothing of the program or JAX and turns TF32
off; the IILE driver and its calibration load no JAX; IISPTNet's count of
operations is the port's."""

import os
import subprocess
import sys

from benchmark import harness, roofline_iile

ROOT = harness.ROOT


def _after(code):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); {code}"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


def test_iile_reference_loads_nothing_of_the_program_and_turns_tf32_off():
    mods, tf32 = _after(
        "import torch; from benchmark.reference import pbrt_iile; "
        "print((sorted({m.split('.')[0] for m in sys.modules}), "
        "(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))")
    assert not set(mods) & set(harness.FORBIDDEN)
    assert "pbrt_v3_iile_tpu_torch" not in mods
    assert tf32 == (False, False)


def test_iile_driver_and_calibration_load_no_jax():
    mods = _after(
        "from benchmark import calibrate_iile, roofline_iile; "
        "from benchmark.drivers import iile_frames; "
        "from benchmark.reference import pbrt_iile; "
        "from pbrt_v3_iile_tpu_torch.integrators import iispt; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert not set(mods) & set(harness.FORBIDDEN)
    assert "pbrt_v3_iile_tpu_torch" in mods


def test_iisptnet_count_is_the_ports():
    from pbrt_v3_iile_tpu_torch.models import iisptnet

    assert roofline_iile.probe_flops(32) == iisptnet.forward_flops(32) == 990117888
    assert roofline_iile.probe_flops(16) == iisptnet.forward_flops(16)
    net = iisptnet.IISPTNet()
    n = sum(p.numel() for p in net.parameters())
    n += sum(b.numel() for b in net.buffers() if b.dtype.is_floating_point)
    assert roofline_iile.weight_count() == n
    w = roofline_iile.iisptnet_work(121)
    assert w["flops"] == 121 * 990117888
    assert w["bytes"] == 4 * (n + 121 * 32 * 32 * 10)
