"""The port's own scene host code against the JAX package's.

``pbrt_v3_iile_tpu_torch`` carries copies of the JAX package's jax-free
host modules (scene parser and API, shapes, PLY, Loop subdivision,
transforms, spectra, image IO, log, the BVH builder).  Here the same
scene files go through both: the scene descriptions must agree field by
field with every array exact, and the BVH built from atrium's triangles
must be the same ``FlatBVH``.
"""

import dataclasses
import os

import numpy as np
import pytest

from pbrt_v3_iile_tpu.ops import bvh as jbvh
from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu_torch.ops import bvh as tbvh
from pbrt_v3_iile_tpu_torch.scene import api as tapi

from torch_parity import ATRIUM, REPO


def assert_same(a, b, path="sd"):
    """Recursive equality of two scene descriptions: the same structure,
    the same class names, numpy arrays equal in dtype, shape and value
    (NaN equal to NaN)."""
    assert type(a).__name__ == type(b).__name__, (path, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        assert_same(vars(a), vars(b), path)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def atrium_pair():
    return japi.load_scene(ATRIUM), tapi.load_scene(ATRIUM)


def test_port_parses_atrium_like_jax(atrium_pair):
    jsd, tsd = atrium_pair
    assert tsd.n_triangles > 90_000
    assert_same(jsd, tsd)


@pytest.mark.parametrize("name", ["interior_v1", "interior_v2", "interior_v3"])
def test_port_parses_interior_scenes_like_jax(name):
    path = os.path.join(REPO, "scenes", f"{name}.pbrt")
    assert_same(japi.load_scene(path), tapi.load_scene(path))


def test_port_builds_atrium_bvh_like_jax(atrium_pair):
    _, tsd = atrium_pair
    tri = np.concatenate([b["p"] for b in tsd.tri_blocks], axis=0)
    jflat = jbvh.build_bvh(tri)
    tflat = tbvh.build_bvh(tri)
    assert_same(jflat, tflat, "bvh")
    assert tflat.node_count.sum() == tri.shape[0]


def test_port_numpy_bvh_builder_matches_jax_on_a_soup():
    """The numpy builder (the path taken without g++) on a random soup."""
    rng = np.random.default_rng(2)
    p0 = rng.uniform(-1, 1, (500, 1, 3))
    tri = (p0 + rng.normal(scale=0.05, size=(500, 3, 3))).astype(np.float32)
    assert_same(jbvh.build_bvh(tri, use_native=False),
                tbvh.build_bvh(tri, use_native=False), "bvh")


def test_port_fourier_material_raises():
    """A Fourier material whose table cannot be read no longer raises:
    both packages degrade it to matte (the reference's semantics)."""
    text = '''
            Camera "perspective"
            WorldBegin
            Material "fourier" "string bsdffile" "missing.bsdf"
            WorldEnd'''
    jsd, tsd = japi.load_scene_string(text), tapi.load_scene_string(text)
    assert tsd.materials[-1].kind == tapi.MAT_MATTE
    assert tsd.materials[-1].fourier_table is None
    assert_same(jsd, tsd)
