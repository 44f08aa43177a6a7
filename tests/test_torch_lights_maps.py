"""Goniometric and projection lights, port vs JAX: the device scene's
light maps, rotations, projection windows, powers and selection tables
(the map's mean luminance is a factor of the power, so it moves the
light-selection distribution), and ``sample_li`` on both kinds with a
map and without one, on maps the test writes (as
tests/test_lights_extra.py writes them).

Tolerances are those of the port's existing ``sample_li`` parity
(tests/test_torch_shading.py): 1e-5 relative (+1e-6 absolute), unit
vectors 1e-5 per component, and for li, pdf and dist the 1e-5 bound on
>= 99.9% of the samples and 1e-3 on all (a map's bilinear tap amplifies
one ulp of a direction); tables built by the same numpy code are held
to 1e-6 relative, integer leaves and delta flags exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pbrt_v3_iile_tpu.ops import lights as jlights
from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu.scene import device as jdev
from pbrt_v3_iile_tpu.utils import image as imglib
from pbrt_v3_iile_tpu_torch.ops import lights as tlights
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.scene import device as tdev
from pbrt_v3_iile_tpu_torch.scene.state import scene_from_numpy

from torch_parity import (assert_close, assert_mostly_close, jax_scene_leaves,
                          to_np, tt)

RTOL, ATOL = 1e-5, 1e-6
DIR_ATOL = 1e-5
N = 4096

SCENE = """
LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [55]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Integrator "path" "integer maxdepth" [3]{strategy}
WorldBegin
AttributeBegin
  Translate 0 2 0
  Rotate 30 1 0 0
  LightSource "goniometric" "rgb I" [6 5 4]{gonio_map}
AttributeEnd
AttributeBegin
  Translate 1 2.5 -1
  Rotate 80 1 0 0
  LightSource "projection" "rgb I" [9 9 9] "float fov" [50]{proj_map}
AttributeEnd
LightSource "point" "point from" [-1 2 0] "rgb I" [2 2 2]
Material "matte" "rgb Kd" [0.6 0.6 0.6]
Shape "trianglemesh" "point P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
    "integer indices" [0 1 2 0 2 3]
WorldEnd
"""


@pytest.fixture(scope="module", params=["maps-power", "bare-spatial"])
def scenes(request, tmp_path_factory):
    if request.param == "maps-power":
        d = tmp_path_factory.mktemp("maps")
        rng = np.random.default_rng(0)
        yy, xx = np.mgrid[0:16, 0:32]
        gonio = (0.2 + np.stack([np.sin(xx / 5.0) ** 2, yy / 16.0,
                                 np.full_like(xx, 0.5, float)], -1))
        imglib.write_pfm(str(d / "gonio.pfm"), gonio.astype(np.float32))
        proj = rng.uniform(0.0, 2.0, (12, 20, 3)).astype(np.float32)
        proj[:, :10] *= 0.1   # a dark left half, a wide window
        imglib.write_pfm(str(d / "proj.pfm"), proj)
        text = SCENE.format(strategy=' "string lightsamplestrategy" "power"',
                            gonio_map=f' "string mapname" "{d}/gonio.pfm"',
                            proj_map=f' "string mapname" "{d}/proj.pfm"')
    else:
        text = SCENE.format(strategy="", gonio_map="", proj_map="")
    js = jdev.build_device_scene(japi.load_scene_string(text))
    t_leaves = tdev.build_leaves(tapi.load_scene_string(text))
    return js, t_leaves


def test_light_tables_match_jax(scenes):
    js, t_leaves = scenes
    j = jax_scene_leaves(js)
    port = scene_from_numpy(t_leaves, "cpu")
    assert port.has_map_lights
    got = port.leaves()
    for name in ("light_kind", "light_img_id", "light_w2l", "light_img",
                 "light_proj_ax", "light_proj_ay", "light_pos", "light_L",
                 "light_pdf", "light_cdf", "spatial_pdf", "spatial_cdf"):
        want = np.asarray(j[name])
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        else:
            assert_close(got[name], want, 1e-6, 0.0, name)
    # the powers are not uniform: selection follows the maps' luminance
    assert np.ptp(got["light_pdf"][:3]) > 0 or np.ptp(got["spatial_pdf"]) > 0


def test_sample_li_matches_jax(scenes):
    js, _ = scenes
    ts = scene_from_numpy(jax_scene_leaves(js), "cpu")
    rng = np.random.default_rng(1)
    lid = (np.arange(N) % 3).astype(np.int32)
    p = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    p[:, 1] = rng.uniform(0.0, 1.0, N)
    u3 = rng.random((N, 3), dtype=np.float32)
    jl = to_np(jlights.sample_li(js, jnp.asarray(lid), jnp.asarray(p),
                                 jnp.asarray(u3)))
    tl = to_np(tlights.sample_li(ts, tt(lid), tt(p), tt(u3)))
    np.testing.assert_array_equal(tl["is_delta"], jl["is_delta"])
    for k in ("wi", "n_l"):
        assert_close(tl[k], jl[k], RTOL, DIR_ATOL, f"sample_li {k}")
    for k in ("li", "pdf", "dist"):
        assert_mostly_close(tl[k], jl[k], RTOL, ATOL, f"sample_li {k}")
    # the projection light lights only its window: some samples are dark
    li_proj = tl["li"][lid == 1].max(-1)
    assert (li_proj == 0).any() and (li_proj > 0).any()
    a = np.asarray(jlights.choose_light(js, jnp.asarray(u3[:, 0])))
    b = to_np(tlights.choose_light(ts, tt(u3[:, 0])))
    np.testing.assert_array_equal(b[0], np.asarray(a[0]))
