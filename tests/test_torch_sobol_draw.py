"""The Sobol draw kernel's arithmetic on the CPU (``csrc/sobol_draw.cu``,
wrapper ``ops/sobol_kernel.py``).

A numpy uint32 model of the kernel's per-lane work, written as the
``.cu`` writes it (a byte-table bit reversal for ``__brev``, multiplies
that wrap in 32 bits, a uint32 -> float32 conversion), fed the host
values the wrapper hands the kernel (``draw_mix``, ``CAMERA_MIX``, the
index's (0,2) bits), is held bit-equal to the plain versions that CPU
tensors run: ``ctx_uniform`` on a SampleCtx for k = 1 to 4, every
purpose, bounces 0-5, and ``pixel_samples`` for each sobol kind.
The kernel itself is held to the plain versions on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu_torch.ops import lds
from pbrt_v3_iile_tpu_torch.ops import samplers as smplr
from pbrt_v3_iile_tpu_torch.ops import sobol_kernel
from pbrt_v3_iile_tpu_torch.utils import stats as statslib

U = np.uint32
_REV8 = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint32)
_LK = (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6)
PURPOSES = sorted(v for k, v in vars(smplr).items() if k.startswith("DIM_"))
INDICES = [0, 1, 2 ** 31, 2 ** 32 - 1, 7, 1000, 0x5A5A5A5A, 2 ** 31 - 1]
SALTS = [0, 0x7FFFFFFE, 0x12345678, 0xFFFFFFFF]


def brev(x):
    return ((_REV8[x & U(0xFF)] << U(24)) | (_REV8[(x >> U(8)) & U(0xFF)] << U(16))
            | (_REV8[(x >> U(16)) & U(0xFF)] << U(8)) | _REV8[x >> U(24)])


def hash_u32(x):
    x = (x ^ U(61)) ^ (x >> U(16))
    x = x * U(9)
    x = x ^ (x >> U(4))
    x = x * U(0x27D4EB2D)
    return x ^ (x >> U(15))


def unit(x):
    return x.astype(np.float32) * np.float32(2.0 ** -32)


def model_draw(pixel, index, salt, bounce, purpose, k):
    """The owen mode: (N, k) float32."""
    p = pixel.astype(np.uint32)
    xb, yb = lds.sobol02_bits_int(index)
    cols = []
    for c, word in enumerate(sobol_kernel.draw_mix(salt, bounce, purpose, k)):
        seed = hash_u32(p ^ U(word))
        x = brev(np.full_like(p, xb if c % 2 == 0 else yb)) + seed
        for m in _LK:
            x = x ^ (x * U(m))
        cols.append(np.minimum(unit(brev(x)), np.float32(1.0 - 1e-7)))
    return np.stack(cols, axis=-1)


def model_pixel_pair(pixel, pass_idx):
    """The xor mode: (N, 2) float32."""
    p = pixel.astype(np.uint32)
    bits = lds.sobol02_bits_int(pass_idx)
    return np.stack([unit(U(b) ^ hash_u32(p ^ U(w)))
                     for b, w in zip(bits, sobol_kernel.CAMERA_MIX)], axis=-1)


def pixels(n=31, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([[0, 1, 2 ** 31, 2 ** 32 - 1],
                           rng.integers(0, 2 ** 32, n - 4)]).astype(np.int64)


def same_bits(a, b):
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("shape_k", [None, 1, 2, 3, 4])
def test_model_matches_ctx_uniform(shape_k):
    """Every purpose, the bounces 0-5, the indices and the salts cycled
    over the purposes; shape (N,) for None, else (N, k)."""
    pix = pixels(seed=shape_k or 0)
    k = shape_k or 1
    for j, purpose in enumerate(PURPOSES):
        bounce, index, salt = j % 6, INDICES[j % len(INDICES)], SALTS[j % len(SALTS)]
        ctx = smplr.SampleCtx(pixel=torch.from_numpy(pix), index=index, salt=salt)
        shape = (len(pix),) if shape_k is None else (len(pix), k)
        got = smplr.ctx_uniform(ctx, None, bounce, purpose, shape)
        want = model_draw(pix, index, salt, bounce, purpose, k)
        assert same_bits(got.numpy(), want.reshape(shape)), (purpose, bounce, index)


@pytest.mark.parametrize("kind", ["sobol", "lowdiscrepancy", "02sequence",
                                  "zerotwosequence"])
def test_model_matches_pixel_samples(kind):
    pix = pixels(seed=7)
    for pass_idx in INDICES:
        got = smplr.pixel_samples(kind, None, torch.from_numpy(pix), pass_idx, 16)
        assert same_bits(got.numpy(), model_pixel_pair(pix, pass_idx)), pass_idx


def test_cpu_draw_counts_as_plain():
    """With the tracer on a CPU draw counts under samples/plain_draws (and
    samples/kernel_draws stays 0); off, nothing is counted."""
    ctx = smplr.SampleCtx(pixel=torch.from_numpy(pixels()), index=3, salt=5)
    statslib.reset()
    smplr.ctx_uniform(ctx, None, 0, smplr.DIM_BSDF_DIR, (31, 2))
    assert statslib.counters() == {}
    statslib.enable(True)
    try:
        smplr.ctx_uniform(ctx, None, 0, smplr.DIM_BSDF_DIR, (31, 2))
        smplr.ctx_uniform(ctx, None, 1, smplr.DIM_RR, (31,))
        assert statslib.counters() == {"samples/plain_draws": 2,
                                       "samples/kernel_draws": 0}
        assert "samples/kernel_draws" in statslib.report()
    finally:
        statslib.enable(False)
        statslib.reset()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper's checks come before any build: CPU tensors and five
    columns are refused."""
    pix = torch.from_numpy(pixels())
    with pytest.raises(ValueError, match="CUDA"):
        sobol_kernel.owen_draw_cuda(pix, 0, 0, 0, 0, (31, 2))
    with pytest.raises(ValueError, match="CUDA"):
        sobol_kernel.xor_pair_cuda(pix, 0)
    with pytest.raises(ValueError, match="1 to 4"):
        sobol_kernel.owen_draw_cuda(pix, 0, 0, 0, 0, (31, 5))
