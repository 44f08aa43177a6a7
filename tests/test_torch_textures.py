"""Texture parity, port vs JAX: the Perlin noise (``perlin``, ``fbm``,
``turbulence``), every procedural kind through ``eval_texture`` (uv,
dots, bilerp, fbm, wrinkled, windy, marble, imagemap with a ray-cone
width, and nested scale / mix / checkerboard over procedural children),
and ptex (the bordered face tables and ``_eval_ptex`` on a .ptx the test
writes).

Tolerance: within 1e-6 of each output's largest magnitude.  The two
libraries' float32 arithmetic differs in the last ulp (XLA on the CPU
contracts the noise's smootherstep and lerps into fused multiply-adds;
``sin`` differs by an ulp), and a noise sums up to 8 octaves of it.
Integer leaves of the tables are exact and float leaves equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pbrt_v3_iile_tpu.scene import api as japi
from pbrt_v3_iile_tpu.scene import ptex as jptex
from pbrt_v3_iile_tpu.scene import textures as jtex
from pbrt_v3_iile_tpu.utils import image as imglib
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.scene import ptex as tptex
from pbrt_v3_iile_tpu_torch.scene import textures as ttex

from torch_parity import to_np, tt

N = 2048
TOL = 1e-6   # of each output's largest magnitude

SCENE = """
WorldBegin
Texture "uvt" "color" "uv" "float uscale" [3] "float vscale" [2]
Texture "dots" "color" "dots" "rgb inside" [0.9 0.2 0.1] "rgb outside" [0.1 0.2 0.7]
    "float uscale" [6] "float vscale" [6]
Texture "bil" "color" "bilerp" "rgb v00" [0.1 0.2 0.3] "rgb v11" [0.9 0.7 0.5]
    "float uscale" [2] "float vscale" [3]
Texture "fbm" "float" "fbm" "integer octaves" [6] "float roughness" [0.6]
Texture "wrk" "float" "wrinkled" "integer octaves" [5] "float roughness" [0.45]
Texture "wind" "float" "windy"
Texture "marb" "color" "marble" "integer octaves" [7] "float roughness" [0.55]
    "float scale" [2.5] "float variation" [0.4]
Texture "img" "color" "imagemap" "string filename" "{img}"
    "float uscale" [2] "float vscale" [2]
Texture "scaled" "color" "scale" "texture tex1" "fbm" "rgb tex2" [0.8 0.5 0.2]
Texture "mixed" "color" "mix" "texture tex1" "marb" "texture tex2" "dots"
    "float amount" [0.3]
Texture "check" "color" "checkerboard" "texture tex1" "wrk" "texture tex2" "wind"
    "float uscale" [4] "float vscale" [4]
WorldEnd
"""


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    p = rng.uniform(-12.0, 12.0, (N, 3)).astype(np.float32)
    return uv, p


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (name, err, scale)


def test_noise_matches_jax():
    _, p = _inputs(1)
    rng = np.random.default_rng(2)
    octv = rng.integers(1, 9, N).astype(np.float32)
    omg = rng.uniform(0.2, 0.8, N).astype(np.float32)
    _close(ttex.perlin(tt(p)).numpy(), np.asarray(jtex.perlin(jnp.asarray(p))),
           "perlin")
    for name in ("fbm", "turbulence"):
        want = getattr(jtex, name)(jnp.asarray(p), jnp.asarray(octv),
                                   jnp.asarray(omg))
        got = getattr(ttex, name)(tt(p), tt(octv), tt(omg))
        _close(got.numpy(), np.asarray(want), name)
    # negative lattice coordinates wrap as the reference's uint32 casts do
    ix = rng.integers(-2 ** 31, 2 ** 31 - 1, N).astype(np.int32)
    h_j = np.asarray(jtex._hash3(jnp.asarray(ix), jnp.asarray(-ix),
                                 jnp.asarray(ix // 3)))
    h_t = ttex._hash3(tt(ix), tt(-ix), tt(ix // 3)).numpy()
    np.testing.assert_array_equal(h_t, h_j.astype(np.int64))


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("tex")
    rng = np.random.default_rng(3)
    img = str(d / "img.pfm")
    imglib.write_pfm(img, rng.uniform(0.0, 1.0, (24, 40, 3)).astype(np.float32))
    text = SCENE.format(img=img)
    jt, jids = jtex.build_table(japi.load_scene_string(text).textures)
    leaves, tids = ttex.build_table_np(tapi.load_scene_string(text).textures)
    return jt, ttex.table_from_numpy(leaves, "cpu"), jids, tids


def test_table_matches_jax(tables):
    jt, t, jids, tids = tables
    assert jids == tids
    port = {k.split(".", 1)[1]: v for k, v in to_np(t.leaves()).items()}
    for name, want in to_np(jt._asdict()).items():
        np.testing.assert_array_equal(port[name], want, err_msg=name)
    assert t.kinds == {ttex.KIND_IDS[k] for k in (
        "uv", "dots", "bilerp", "fbm", "wrinkled", "windy", "marble",
        "imagemap", "scale", "mix", "checkerboard")}
    assert t.nested


NAMES = ["uvt", "dots", "bil", "fbm", "wrk", "wind", "marb", "img",
         "scaled", "mixed", "check"]


@pytest.fixture(scope="module")
def evaluated(tables):
    """Both packages' eval_texture on the same lanes, each lane's texture
    one of NAMES in turn (every seventh lane none): one call each."""
    jt, t, jids, _ = tables
    uv, p = _inputs(4)
    names = np.asarray([NAMES[k % len(NAMES)] for k in range(N)])
    tid = np.asarray([jids[n] for n in names], np.int32)
    tid[::7] = -1   # no texture: zero
    width = np.random.default_rng(5).uniform(0.0, 0.05, N).astype(np.float32)
    want = np.asarray(jtex.eval_texture(jt, jnp.asarray(tid), jnp.asarray(uv),
                                        jnp.asarray(p), jnp.asarray(width)))
    got = ttex.eval_texture(t, tt(tid), tt(uv), tt(p), tt(width)).numpy()
    return names, tid, got, want


@pytest.mark.parametrize("name", NAMES)
def test_eval_texture_matches_jax(evaluated, name):
    names, tid, got, want = evaluated
    lanes = (names == name) & (tid >= 0)
    _close(got[lanes], want[lanes], name)
    assert np.abs(want[lanes]).max() > 0
    assert (got[tid < 0] == 0).all()


def _ptex_file(res, colors):
    pf = tptex.PtexFile()
    nf = len(colors)
    pf.res = np.full((nf, 2), res, np.int32)
    pf.adjfaces = np.full((nf, 4), -1, np.int32)
    pf.adjfaces[0, 1], pf.adjfaces[1, 3] = 1, 0   # faces 0 and 1 share an edge
    pf.adjedges = np.zeros(nf, np.uint32)
    pf.const = np.zeros((nf, 3), np.float32)
    n = 1 << res
    rng = np.random.default_rng(6)
    pf.faces = [np.clip(np.asarray(c, np.float32)
                        + rng.uniform(-0.05, 0.05, (n, n, 3)), 0, 1)
                .astype(np.float32) for c in colors]
    return pf


def test_ptex_tables_and_eval_match_jax(tmp_path):
    colors = [(0.9, 0.1, 0.1), (0.1, 0.9, 0.1), (0.1, 0.1, 0.9)]
    path = str(tmp_path / "faces.ptx")
    tptex.write_ptx(path, _ptex_file(2, colors))
    # the copy reads what it writes, and the JAX package reads it the same
    jf, tf = jptex.read_ptx(path), tptex.read_ptx(path)
    for a, b in zip(jf.faces, tf.faces):
        np.testing.assert_array_equal(a, b)
    jb, jtabs = jptex.build_face_tables([jf])
    tb, ttabs = tptex.build_face_tables([tf])
    assert jb == tb == [0]
    for a, b in zip(jtabs, ttabs):
        np.testing.assert_array_equal(a, b)
    text = f"""WorldBegin
Texture "faces" "color" "ptex" "string filename" "{path}" "float gamma" [1]
Texture "other" "color" "fbm"
WorldEnd"""
    jt, _ = jtex.build_table(japi.load_scene_string(text).textures)
    leaves, _ = ttex.build_table_np(tapi.load_scene_string(text).textures)
    t = ttex.table_from_numpy(leaves, "cpu")
    for k in ("ptex_base", "ptex_off", "ptex_resu", "ptex_resv", "ptex_texels"):
        np.testing.assert_array_equal(to_np(getattr(t, k)),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    rng = np.random.default_rng(7)
    uv = rng.uniform(-0.1, 1.1, (N, 2)).astype(np.float32)
    p = np.zeros((N, 3), np.float32)
    face = rng.integers(0, 3, N).astype(np.int32)
    tid = np.zeros(N, np.int32)
    want = np.asarray(jtex.eval_texture(jt, jnp.asarray(tid), jnp.asarray(uv),
                                        jnp.asarray(p), face=jnp.asarray(face)))
    got = ttex.eval_texture(t, tt(tid), tt(uv), tt(p), face=tt(face)).numpy()
    _close(got, want, "ptex")
    # each face reads its own colour at its centre
    mid = ttex.eval_texture(t, tt(np.zeros(3, np.int32)),
                            tt(np.full((3, 2), 0.5, np.float32)),
                            tt(np.zeros((3, 3), np.float32)),
                            face=tt(np.arange(3, dtype=np.int32))).numpy()
    assert np.abs(mid - np.asarray(colors)).max() < 0.06
