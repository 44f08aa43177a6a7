"""The port's device scene equals the JAX package's, leaf by leaf, on atrium.

Integer leaves are exact; float leaves agree within 1e-6 relative (both
builds run the same numpy code; the tolerance covers float64 -> float32
casts taken at a different step).  The cluster pack of the fused kernel
is included.
"""

import numpy as np
import pytest
import torch

from pbrt_v3_iile_tpu.scene import api as apilib
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu_torch.scene import device as tdev
from pbrt_v3_iile_tpu_torch.scene.state import DeviceScene, scene_from_numpy

from torch_parity import ATRIUM, assert_close, jax_scene_leaves


@pytest.fixture(scope="module")
def atrium_leaves():
    sd = apilib.load_scene(ATRIUM)
    j = jax_scene_leaves(jdev.build_device_scene(sd, with_clusters=True))
    t = tdev.build_leaves(sd, with_clusters=True)
    return j, t


def test_every_leaf_matches_jax(atrium_leaves):
    j, t = atrium_leaves
    port = scene_from_numpy(t, "cpu").leaves()
    assert set(port) == set(j), set(port) ^ set(j)
    for name, want in j.items():
        got = port[name]
        want = np.asarray(want)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        if want.dtype.kind in "iub":
            assert got.dtype == np.int32, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got.dtype == np.float32, name
            assert_close(got, want, rtol=1e-6, atol=0.0, name=name)


def test_cluster_pack_shape_and_atrium_size(atrium_leaves):
    j, _ = atrium_leaves
    feat = np.asarray(j["clusters.feat"])
    assert feat.shape[1:] == (24, 128)
    assert np.asarray(j["clusters.tri_cnt"]).max() <= 128
    assert np.asarray(j["clusters.tri_cnt"]).sum() == np.asarray(j["tri_p0"]).shape[0]


def test_scene_from_jax_leaves_roundtrip(atrium_leaves):
    j, _ = atrium_leaves
    ds = scene_from_numpy(j, torch.device("cpu"))
    assert isinstance(ds, DeviceScene)
    assert ds.tri_p0.dtype == torch.float32 and ds.tri_mat.dtype == torch.int32
    assert ds.nodes_packed.dtype == torch.int32 and ds.nodes_packed.shape[1] == 8
    assert ds.clusters.feat.shape[1:] == (24, 128)
    back = ds.leaves()
    for name, want in j.items():
        np.testing.assert_array_equal(back[name], np.asarray(want), err_msg=name)


def test_unported_features_raise():
    """The device build ports every feature of the reference's scenes
    (motion blur and the kd-tree since the cameras-and-aggregates slice:
    a scene that asks for the kd-tree gets it, one without it the
    reference's placeholder leaf); what stays unported raises: the
    integrators of ROADMAP Queue 1 item 9."""
    from pbrt_v3_iile_tpu_torch.integrators import render as trender

    text = """
        Camera "perspective"
        Film "image" "integer xresolution" [8] "integer yresolution" [8]
        {accel}
        WorldBegin
        LightSource "point" "rgb I" [1 1 1]
        Material "hair"
        Shape "trianglemesh" "integer indices" [0 1 2]
            "point P" [0 0 1  1 0 1  0 1 1]
        WorldEnd"""
    sd = apilib.load_scene_string(text.format(accel=""))
    leaves = tdev.build_leaves(sd)
    assert "tri_med_in" in leaves
    assert leaves["kd_meta"].tolist() == [3] and not leaves["kd_bounds"].any()
    sd = apilib.load_scene_string(text.format(accel='Accelerator "kdtree"'))
    leaves = tdev.build_leaves(sd)
    assert leaves["kd_meta"].tolist() == [3 | 1 << 2]
    assert leaves["kd_bounds"].any()
    sd.integrator.kind = "bdpt"
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        trender.make_integrator_config(sd, device="cpu")
