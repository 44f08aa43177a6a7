"""Times the Sobol draw kernel on the 2,073,600-lane wave on one NVIDIA GPU.

Run from the repository root:  python3 tools/time_sobol_draw.py

Builds ``pbrt_v3_iile_tpu_torch/csrc/sobol_draw.cu`` with ptxas's report
(registers, spills), then on the 2,073,600-lane wave (a 1440^2 pass) times
each draw shape of the path pass -- the Owen mode with k = 1 to 4 columns
(``sobol_kernel.owen_draw_cuda``) and the camera's XOR mode
(``sobol_kernel.xor_pair_cuda``) -- and its plain version
(``samplers.owen_draw_plain``, ``samplers.sobol_pixel_samples_plain``).
``chip_smoke.py`` holds the kernel bit for bit against the plain versions
on a 512^2 pass and times it there as the host issues it; this tool
times what that leaves out, by CUDA events over 20 calls:
  queued_ms  the calls queued behind a ~50 ms device sleep, so the device
             runs them back to back: the kernel's time alone, with the
             16.6 MB of pixel ids in the 50 MB L2 cache (host_us: the
             host's time a call);
  cold_ms    one call at a time after a 256 MB read has flushed the L2
             cache (a read leaves no dirty lines to write back during the
             call), by events around the call alone;
  plain_queued_ms  the plain version queued as the kernel is;
with bound_ms, the bytes (8 a lane in, 4 a lane a column out) at
3.35 TB/s.  Prints one JSON line a draw, then the card's name and power
limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from _timing import events_ms  # noqa: E402  (tools/_timing.py)

N = 2_073_600
REPS = 20
HBM_BYTES_S = 3.35e12


def cold_ms(fn):
    """Mean ms of fn() by events around each call alone, each after a
    256 MB read that flushes the L2 cache (the host issues the call while
    the device still reads, so the call's launch is hidden)."""
    flush = torch.ones(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(REPS):
        flush.sum()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / REPS


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_sobol_draw: needs an NVIDIA GPU")
    from pbrt_v3_iile_tpu_torch import _build
    from pbrt_v3_iile_tpu_torch.ops import samplers as smplr
    from pbrt_v3_iile_tpu_torch.ops import sobol_kernel

    _build.load("sobol_draw", verbose=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device="cpu").manual_seed(17)
    pix = torch.randint(0, 2 ** 32, (N,), dtype=torch.int64, generator=gen).to(dev)
    index, salt, bounce, purpose = 5, 0x2F6B1D3A, 2, smplr.DIM_BSDF_DIR
    ctx = smplr.SampleCtx(pixel=pix, index=index, salt=salt)
    cases = [(f"owen_k{k}", k,
              lambda s=((N,) if k == 1 else (N, k)): sobol_kernel.owen_draw_cuda(
                  pix, index, salt, bounce, purpose, s),
              lambda s=((N,) if k == 1 else (N, k)): smplr.owen_draw_plain(
                  ctx, bounce, purpose, s))
             for k in (1, 2, 3, 4)]
    cases.append(("xor_pixel_samples", 2,
                  lambda: sobol_kernel.xor_pair_cuda(pix, index),
                  lambda: smplr.sobol_pixel_samples_plain(pix, index)))
    for name, columns, kernel, plain in cases:
        row = dict(draw=name, lanes=N, columns=columns,
                   bound_ms=(8 + 4 * columns) * N / HBM_BYTES_S * 1e3)
        row["queued_ms"], row["host_us"] = events_ms(kernel, queued=True, reps=REPS)
        row["cold_ms"] = cold_ms(kernel)
        row["plain_queued_ms"], row["plain_host_us"] = events_ms(
            plain, queued=True, reps=REPS)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
