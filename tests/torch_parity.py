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

# the tests run in several worker processes at once: two threads each
# keep torch's CPU kernels from oversubscribing the cores
torch.set_num_threads(2)

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


def pack_bvh(nodes_min, nodes_max, right, count, axis, p0, e1, e2):
    """A FlatBVH's arrays and its triangles (in BVH order) -> the scene's
    ``nodes_packed`` (M, 8) i32 and ``tris_packed`` (T, 12) f32."""
    nodes = np.zeros((nodes_min.shape[0], 8), np.int32)
    nodes[:, 0:3] = nodes_min.astype(np.float32).view(np.int32)
    nodes[:, 3:6] = nodes_max.astype(np.float32).view(np.int32)
    nodes[:, 6] = right
    nodes[:, 7] = (count << 2) | axis
    tris = np.zeros((p0.shape[0], 12), np.float32)
    tris[:, 0:3], tris[:, 3:6], tris[:, 6:9] = p0, e1, e2
    return nodes, tris


def coincident_soup(rng, T, groups):
    """(p0, e1, e2) f32 of T random triangles (tests/test_clusters.py's
    soup) and, for each entry g of `groups`, g more triangles whose
    bounding boxes share one centre, so that the BVH builders put each
    group in one leaf of g triangles.  Coordinates are multiples of 1/64,
    so the centres are exactly equal; the triangles differ in size and
    cross the centre's z line at distinct depths.  Also returns the
    centres."""
    p0 = rng.uniform(-1, 1, (T, 3))
    e1 = rng.uniform(-0.4, 0.4, (T, 3))
    e2 = rng.uniform(-0.4, 0.4, (T, 3))
    verts, centres = [np.stack([p0, p0 + e1, p0 + e2], 1)], []
    for i, g in enumerate(groups):
        c = np.array([1.5 * (-1) ** i, 0.25, -0.5])
        centres.append(c)
        for k in range(g):
            s, h = (k + 2) / 16, (k + 1) / 16
            z2 = h / 2 if k % 2 else -h / 2
            verts.append((c + np.array([[-s, -s, -h], [s, -s, h],
                                        [0.0, s, z2]]))[None])
    v = np.concatenate(verts).astype(np.float32)
    return v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], np.array(centres)


def rays_at(rng, centres, N):
    """N unit rays: from 2 away towards one of `centres` (jittered by up
    to 0.05), every fifth with t_max 2 and the others 1e30."""
    c = centres[np.arange(N) % len(centres)]
    u = rng.normal(size=(N, 3))
    o = c + 2 * u / np.linalg.norm(u, axis=1, keepdims=True)
    d = c + rng.uniform(-0.05, 0.05, (N, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(N) % 5 == 0, 2.0, 1e30)
    return o.astype(np.float32), d.astype(np.float32), tmax.astype(np.float32)


def motion_soup(rng, T=600, M=4):
    """A soup for the BVH kernel's motion tables: T random triangles of
    which a third stay put, a third turn 40 degrees about the y axis and a
    third move by (0.3, 0.1, 0) over the shutter, at M sub-keyframes.
    Returns (steps (M, T, 12) f32: p0, e1, e2, pad at each sub-keyframe,
    in the order of a numpy BVH over their union, as the device scene
    orders them; that BVH's ``nodes_packed``)."""
    from pbrt_v3_iile_tpu_torch.ops import bvh
    from pbrt_v3_iile_tpu_torch.ops.intersect_kernel import pack_nodes_np

    c = rng.uniform(-2, 2, (T, 1, 3))
    p = c + rng.uniform(-0.4, 0.4, (T, 3, 3))
    kind = np.arange(T) % 3
    frames = []
    for s in np.linspace(0.0, 1.0, M):
        a = np.deg2rad(40.0) * s
        rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]])
        q = np.where((kind == 1)[:, None, None], p @ rot.T, p)
        q = np.where((kind == 2)[:, None, None], p + s * np.array([0.3, 0.1, 0]), q)
        frames.append(q.astype(np.float32))
    p_steps = np.stack(frames)                           # (M, T, 3, 3)
    flat = bvh.build_bvh(np.concatenate(list(p_steps), axis=1),
                         use_native=False)
    return pack_steps(p_steps[:, flat.prim_order]), pack_nodes_np(flat)


def pack_steps(p_steps):
    """Sub-keyframe vertices (M, T, 3, 3) -> the rows of
    ``tris_steps_packed`` (M, T, 12) f32: p0, e1, e2, pad."""
    steps = np.zeros(p_steps.shape[:2] + (12,), np.float32)
    steps[..., 0:3] = p_steps[:, :, 0]
    steps[..., 3:6] = p_steps[:, :, 1] - p_steps[:, :, 0]
    steps[..., 6:9] = p_steps[:, :, 2] - p_steps[:, :, 0]
    return steps


def kd_tie_scene(device, T=200, n_dup=60, seed=23):
    """A soup whose kd leaves hold ties: triangle T + j is a bit-equal copy
    of triangle dup[j], and every leaf's prim list is reversed, so that
    the copy (the larger id) comes first in leaf order.
    Rays aim at the duplicated triangles from 3 away.  Returns (scene
    with the kd-tree kernel's fields, (o, d, t_max), first), first[p] the
    id that a tie between p and its twin returns (the first in leaf
    order)."""
    from types import SimpleNamespace

    from pbrt_v3_iile_tpu_torch.ops import kdtree

    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-2, 2, (T, 3)).astype(np.float32)
    e1 = rng.uniform(-0.4, 0.4, (T, 3)).astype(np.float32)
    e2 = rng.uniform(-0.4, 0.4, (T, 3)).astype(np.float32)
    dup = rng.choice(T, n_dup, replace=False)
    p0, e1, e2 = (np.concatenate([x, x[dup]]) for x in (p0, e1, e2))
    kd = kdtree.build_kdtree(p0, e1, e2)
    prims = kd.prims.copy()
    leaf = (kd.meta & 3) == 3
    for off, cnt in zip(kd.offset[leaf], kd.meta[leaf] >> 2):
        prims[off:off + cnt] = prims[off:off + cnt][::-1].copy()
    first = np.arange(T + n_dup)
    first[dup] = T + np.arange(n_dup)
    tris = np.zeros((T + n_dup, 12), np.float32)
    tris[:, 0:3], tris[:, 3:6], tris[:, 6:9] = p0, e1, e2
    N = 2048
    target = p0[dup] + (e1[dup] + e2[dup]) / 3
    c = target[np.arange(N) % n_dup]
    u = rng.normal(size=(N, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o, d = (c + 3 * u).astype(np.float32), (-u).astype(np.float32)
    as_t = lambda x: torch.as_tensor(x, device=device)
    scene = SimpleNamespace(
        kd_split=as_t(kd.split), kd_meta=as_t(kd.meta), kd_offset=as_t(kd.offset),
        kd_prims=as_t(prims), kd_bounds=as_t(kd.bounds), tris_packed=as_t(tris),
        kd_tris=as_t(kdtree.kd_tris_np(prims, tris)), has_kdtree=True)
    rays = (as_t(o), as_t(d), as_t(np.full(N, 1e30, np.float32)))
    return scene, rays, as_t(first.astype(np.int32))


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
    ``scene_from_numpy`` reads (the port's fields only).  The BVH kernel's
    4-wide nodes, which the reference lacks, are collapsed by the port's
    ``build_bvh4_np`` from the reference's ``nodes_packed``, and its motion
    tables are built by the port's ``build_motion_split_np`` from the
    reference's ``tris_steps_packed`` (in its prim order) and
    ``nodes_packed``, and the kd-tree kernel's leaf-ordered triangles by
    ``kd_tris_np``."""
    from pbrt_v3_iile_tpu_torch.ops.intersect_kernel import (
        build_bvh4_np, build_motion_split_np)
    from pbrt_v3_iile_tpu_torch.ops.kdtree import kd_tris_np

    out = {}
    for f in fields(DeviceScene):
        if f.name.startswith(("bvh4_", "mot_")) or f.name == "kd_tris":
            continue
        if f.name == "textures":
            for g in fields(TextureTable):
                out[f"textures.{g.name}"] = np.asarray(getattr(ds.textures, g.name))
        elif f.name == "clusters":
            if ds.clusters is not None:
                for g in fields(ClusterPack):
                    out[f"clusters.{g.name}"] = np.asarray(getattr(ds.clusters, g.name))
        elif f.name == "fourier":
            if ds.fourier is not None:
                for k, v in ds.fourier._asdict().items():
                    out[f"fourier.{k}"] = np.asarray(v)
        else:
            out[f.name] = np.asarray(getattr(ds, f.name))
    wide, depth = build_bvh4_np(out["nodes_packed"])
    out["bvh4_nodes"], out["bvh4_stack"] = wide, np.int32(depth)
    out.update(build_motion_split_np(out["tris_steps_packed"],
                                     out["nodes_packed"]))
    out["kd_tris"] = kd_tris_np(out["kd_prims"], out["tris_packed"])
    return out


def _transport_tool():
    """tools/make_transport_golden.py as a module (its top level imports
    no jax)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_transport_golden",
        os.path.join(REPO, "tools", "make_transport_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def transport_golden(name):
    """tests/golden/transport16_<name>.npz and the port's parse of its
    scene (its features and overrides applied)."""
    import json

    from pbrt_v3_iile_tpu_torch.scene import api as tapi

    z = np.load(os.path.join(REPO, "tests", "golden", f"transport16_{name}.npz"))
    case = dict(scene=str(z["scene"]), features=json.loads(str(z["features"])),
                lookat=str(z["lookat"]), overrides=json.loads(str(z["overrides"])))
    return z, _transport_tool().load_case(tapi, case)


def render_transport_golden(name):
    """The port's render of a transport16 golden's settings on the CPU
    (the BVH walker): render(), or with the golden's compact schedule the
    compacted pass loop.  Returns (image, golden, stats)."""
    import json

    from pbrt_v3_iile_tpu_torch.integrators import render as trender

    z, sd = transport_golden(name)
    compact = json.loads(str(z["compact"]))
    if compact:
        assert tuple(compact) == trender.COMPACT_SCHEDULE
    img, st = trender.render(sd, spp=int(z["spp"]), seed=int(z["seed"]),
                             accel=str(z["accel"]), compact=bool(compact),
                             device="cpu")
    return img, z, st


def camera_tool():
    """tools/make_camera_golden.py as a module (its top level imports no
    jax)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_camera_golden",
        os.path.join(REPO, "tools", "make_camera_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def camera_golden(name, api=None):
    """tests/golden/<name>.npz (a camera16_*/camera128_* golden) and the
    parse of its scene by ``api`` (the port's unless given), with its
    settings applied."""
    if api is None:
        from pbrt_v3_iile_tpu_torch.scene import api
    tool = camera_tool()
    z = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz"))
    return z, tool.load_case(api, tool.case_from_golden(z))


def render_camera_golden(name, scene=None):
    """The port's render of a camera golden's settings on the CPU:
    render() with the golden's accel, and its compact schedule when it
    has one.  scene: a device scene of the golden's scene file to render
    with (its camera is made for the golden's film).  Returns (image,
    golden, stats)."""
    import json

    from pbrt_v3_iile_tpu_torch.integrators import render as trender
    from pbrt_v3_iile_tpu_torch.ops import camera as tcam

    z, sd = camera_golden(name)
    prebuilt = None
    if scene is not None:
        prebuilt = (scene, tcam.make_camera(sd.camera, sd.film, "cpu"))
    compact = json.loads(str(z["compact"]))
    if compact:
        assert tuple(compact) == trender.COMPACT_SCHEDULE
    img, st = trender.render(sd, spp=int(z["spp"]), seed=int(z["seed"]),
                             accel=str(z["accel"]), compact=bool(compact),
                             device="cpu", prebuilt=prebuilt)
    return img, z, st
