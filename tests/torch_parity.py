"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

A parity test feeds the same numpy inputs to a JAX function of
``pbrt_v3_iile_tpu`` (on the CPU) and to its port in
``pbrt_v3_iile_tpu_torch`` (device "cpu", plain kernel versions), and
compares the outputs with a stated tolerance.
"""

from __future__ import annotations

import os
from dataclasses import fields

import numpy as np
import torch

from pbrt_v3_iile_tpu_torch.scene.state import ClusterPack, DeviceScene
from pbrt_v3_iile_tpu_torch.scene.textures import TextureTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATRIUM = os.path.join(REPO, "scenes", "atrium.pbrt")


def to_np(x):
    """JAX array, torch tensor, python number or a (nested) dataclass /
    NamedTuple / dict of them -> numpy (same structure)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    if hasattr(x, "_asdict"):
        return {k: to_np(v) for k, v in x._asdict().items()}
    if hasattr(x, "__dataclass_fields__"):
        return {k: to_np(getattr(x, k)) for k in x.__dataclass_fields__}
    if isinstance(x, (tuple, list)):
        return type(x)(to_np(v) for v in x)
    return np.asarray(x)


def tt(a, dtype=None):
    """numpy -> CPU torch tensor (float64 -> float32 unless dtype given)."""
    a = np.asarray(a)
    if dtype is None and a.dtype == np.float64:
        a = a.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def diff(a, b) -> dict:
    """Max abs and max relative difference of two arrays."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = np.abs(a - b)
    rel = d / np.maximum(np.abs(b), 1e-30)
    return dict(max_abs=float(d.max(initial=0.0)),
                max_rel=float(np.where(d > 0, rel, 0.0).max(initial=0.0)))


def run_both(jax_fn, torch_fn, *arrays):
    """Call jax_fn on jnp arrays and torch_fn on CPU tensors made from the
    same numpy arrays; returns both outputs as numpy structures."""
    import jax.numpy as jnp

    out_j = jax_fn(*(jnp.asarray(a) for a in arrays))
    out_t = torch_fn(*(tt(a) for a in arrays))
    return to_np(out_j), to_np(out_t)


def assert_close(a, b, rtol, atol=0.0, name=""):
    """Elementwise |a - b| <= atol + rtol |b|, with the worst case reported."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    bad = ~(np.abs(a - b) <= atol + rtol * np.abs(b))
    bad &= ~(np.isnan(a) & np.isnan(b))
    assert not bad.any(), (f"{name}: {int(bad.sum())} of {bad.size} outside "
                           f"rtol={rtol} atol={atol}; {diff(a, b)}")


def assert_mostly_close(a, b, rtol, atol=0.0, name="", frac=0.999,
                        rtol_all=1e-3, atol_all=1e-5):
    """|a - b| <= atol + rtol |b| on >= frac of the elements, and
    <= atol_all + rtol_all |b| on all of them: for outputs that are
    ill-conditioned in their inputs (a glossy lobe's f at a sampled
    direction), where one-ulp input differences are amplified."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    d = np.abs(a - b)
    ok = d <= atol + rtol * np.abs(b)
    assert ok.mean() >= frac, f"{name}: only {ok.mean():.5f} within rtol={rtol}; {diff(a, b)}"
    loose = d <= atol_all + rtol_all * np.abs(b)
    assert loose.all(), f"{name}: outside rtol_all={rtol_all}; {diff(a, b)}"


def golden_criterion(img, ref):
    """tests/test_golden.py's criterion: mean within 2%, and >= 99% of
    pixels within 5% relative (+1e-2)."""
    mean_ok = abs(float(img.mean()) - float(ref.mean())) < 0.02 * ref.mean()
    rel = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    frac = float((rel < 0.05).mean())
    return mean_ok and frac > 0.99, dict(mean=float(img.mean()),
                                         ref_mean=float(ref.mean()), frac=frac)


def jax_scene_leaves(ds) -> dict:
    """Numpy leaves of a JAX DeviceScene under the names the port's
    ``scene_from_numpy`` reads (the port's fields only)."""
    out = {}
    for f in fields(DeviceScene):
        if f.name == "textures":
            for g in fields(TextureTable):
                out[f"textures.{g.name}"] = np.asarray(getattr(ds.textures, g.name))
        elif f.name == "clusters":
            if ds.clusters is not None:
                for g in fields(ClusterPack):
                    out[f"clusters.{g.name}"] = np.asarray(getattr(ds.clusters, g.name))
        else:
            out[f.name] = np.asarray(getattr(ds, f.name))
    return out
