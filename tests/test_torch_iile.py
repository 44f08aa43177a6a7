"""IILE parity, port vs JAX, on atrium at 16^2 with 8^2 hemispheres,
seed 0, the BVH walker on both sides and the pretrained IISPTNet.

The JAX side ran the stages of its first task with the package's own
cached programs (``iispt._anchor_fns``, ``_ff_fn``, ``_probes_fn``,
``_mis_stage``) and its ``render_iile``; their inputs and outputs are
tests/golden/parity_iile_task16.npz (tools/make_parity_golden.py), so
no JAX program compiles here.  Each port stage gets the JAX stage's
inputs, so every comparison starts from identical data.  The RNG streams are bit-exact; f32 rounding differs between the
libraries in the last ulp, and can flip a rare discrete decision (a
lobe pick, a grazing hit).  Tolerances:
  - probe G-buffer: distance and normal within 1e-5 on >= 99.9% of the
    rays, each probe's mean intensity within 1e-3 relative;
  - specular chase (the task's one pixel chunk: 8,192 lanes over the
    256 pixels): found and mat equal on >= 99.9%, p and n within 1e-5;
  - hemisphere MIS: rgb within 1e-4 relative on >= 99.9% of the pixels;
  - render_iile with 1 task and 1 direct pass: each image's mean within
    0.5%, and >= 99% of the pixels within 1e-3 of the image's maximum.
"""

import os

import numpy as np
import pytest

from pbrt_v3_iile_tpu_torch.integrators import iispt as tiispt
from pbrt_v3_iile_tpu_torch.integrators import probes as tprobes
from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.models import weights as tweights
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene import api as tapi

from torch_parity import ATRIUM, REPO, tt

RES, HEMI, SEED = 16, 8, 0
GOLDEN = os.path.join(REPO, "tests", "golden", "parity_iile_task16.npz")


def _sd(api):
    sd = api.load_scene(ATRIUM)
    sd.film.x_resolution = sd.film.y_resolution = RES
    return sd


@pytest.fixture(scope="module")
def port():
    sd = _sd(tapi)
    scene, cam = trender.build(sd, "cpu")
    return dict(sd=sd, scene=scene, cam=cam,
                key=threefry.fold_in(threefry.prng_key(SEED), 1000),
                net=tweights.load_iisptnet(device="cpu"))


@pytest.fixture(scope="module")
def jax_task():
    """The JAX package's first task at 16^2, stage by stage (numpy), and
    its render_iile images, from the golden: arrays "a/b" as j["a"]["b"],
    "mis_in/<i>" as the tuple j["mis_in"]."""
    out = {}
    with np.load(GOLDEN) as z:
        for key in z.files:
            *head, last = key.split("/")
            d = out
            for h in head:
                d = d.setdefault(h, {})
            d[last] = z[key]
    out["mis_in"] = tuple(out["mis_in"][str(i)]
                          for i in range(len(out["mis_in"])))
    out["ts"] = int(out["ts"])
    return out


def _frac_close(a, b, tol, axis=-1):
    """Share of rows (over `axis`) with every |a - b| <= tol."""
    return float((np.abs(a - b) <= tol).all(axis=axis).mean())


def test_probe_anchors(port, jax_task):
    j = jax_task
    o, d = tiispt._probe_rays(port["cam"], port["key"], tt(j["coords"]), 0)
    assert np.abs(o.numpy() - j["o"]).max() <= 1e-5
    assert np.abs(d.numpy() - j["d"]).max() <= 1e-6
    fi = tprobes.find_first_nonspecular(port["scene"], tt(j["o"]), tt(j["d"]),
                                        port["key"])
    assert np.array_equal(fi["found"].numpy(), j["fi"]["found"])
    assert np.array_equal(fi["mat"].numpy(), j["fi"]["mat"])
    assert np.abs(fi["p"].numpy() - j["fi"]["p"]).max() <= 1e-4


def test_render_probes(port, jax_task):
    j = jax_task
    gb = tprobes.render_probes(port["scene"], tt(j["fi"]["p"]), tt(j["fi"]["n"]),
                               port["key"], HEMI)
    ref = j["gb"]
    P = ref["distance"].shape[0]
    assert P == 121
    for name in ("right", "up", "look", "origin"):
        assert np.abs(getattr(gb, name).numpy() - ref[name]).max() <= 1e-6, name
    dist, nrm = gb.distance.numpy(), gb.normals.numpy()
    assert _frac_close(dist, ref["distance"], 1e-5) >= 0.999
    assert _frac_close(nrm, ref["normals"], 1e-5) >= 0.999
    mi = gb.intensity.numpy().mean(axis=(1, 2, 3))
    mr = ref["intensity"].mean(axis=(1, 2, 3))
    assert (np.abs(mi - mr) <= 1e-3 * np.abs(mr)).all(), np.abs(mi - mr).max()
    assert mr.min() > 0.0


def test_cnn_stage(port, jax_task):
    j = jax_task
    gb = tprobes.ProbeGBuffer(**{k: tt(v) for k, v in j["gb"].items()})
    R = tiispt.probe_radiance(port["net"], gb, tt(j["mis_in"][1]))
    err = np.abs(R.numpy() - j["R"]).max()
    assert err <= 1e-4 * np.abs(j["R"]).max() + 1e-5, err


def test_find_first_nonspecular_chunk(port, jax_task):
    j = jax_task
    ff = tprobes.find_first_nonspecular(
        port["scene"], tt(j["fo"]), tt(j["fd"]),
        threefry.fold_in(port["key"], 8))
    ref = j["ff"]
    for k in ("found", "mat"):
        assert (ff[k].numpy() == ref[k]).mean() >= 0.999, k
    both = ff["found"].numpy() & ref["found"]
    assert both.mean() > 0.9
    for k in ("p", "n"):
        assert _frac_close(ff[k].numpy()[both], ref[k][both], 1e-5) >= 0.999, k
    for k in ("beta", "wo"):
        assert _frac_close(ff[k].numpy(), ref[k], 1e-5) >= 0.999, k


def test_mis_stage(port, jax_task):
    j = jax_task
    rgb, valid = tiispt._mis_stage(
        port["scene"], port["cam"], *(tt(a) for a in j["mis_in"]),
        threefry.fold_in(port["key"], 9), j["ts"], HEMI)
    rgb = rgb.numpy()
    assert np.array_equal(valid.numpy(), j["valid"])
    ok = (np.abs(rgb - j["rgb"]) <= 1e-4 * np.abs(j["rgb"])).all(-1)
    assert ok.mean() >= 0.999, (ok.mean(), np.abs(rgb - j["rgb"]).max())
    # the 256 in-image lanes: most see a diffuse surface with indirect light
    assert j["valid"][:RES * RES].mean() > 0.8 and j["rgb"].mean() > 0.0


def test_render_iile_matches_jax(jax_task):
    ref = jax_task["render"]
    got = tiispt.render_iile(_sd(tapi), seed=SEED, indirect_tasks=1,
                             direct_samples=1, hemi_size=HEMI, device="cpu")
    assert got[3]["accel"] == "bvh" and got[3]["tasks"] == 1
    for name, a in zip(("combined", "direct", "indirect"), got[:3]):
        b = ref[name]
        assert a.shape == b.shape == (RES, RES, 3), name
        assert abs(a.mean() - b.mean()) <= 0.005 * b.mean(), (name, a.mean(),
                                                              b.mean())
        frac = (np.abs(a - b) <= 1e-3 * np.abs(b).max()).mean()
        assert frac >= 0.99, (name, frac)


def test_cli_iispt_writes_images(tmp_path, capsys):
    from pbrt_v3_iile_tpu_torch.cli import main as tcli
    from pbrt_v3_iile_tpu_torch.utils import image as imglib

    scene = tmp_path / "room.pbrt"
    scene.write_text("""
        LookAt 0 1 -4  0 0.5 0  0 1 0
        Camera "perspective" "float fov" [55]
        Film "image" "integer xresolution" [8] "integer yresolution" [8]
        Sampler "random" "integer pixelsamples" [1]
        Integrator "path" "integer maxdepth" [3]
        WorldBegin
        LightSource "point" "rgb I" [30 30 30] "point from" [0 3 0]
        Material "matte" "rgb Kd" [0.7 0.7 0.7]
        Shape "trianglemesh" "integer indices" [0 1 2 0 2 3 4 5 6 4 6 7]
            "point P" [-6 -0.5 4  6 -0.5 4  6 6 4  -6 6 4
                       -6 -0.5 -6  6 -0.5 -6  6 -0.5 4  -6 -0.5 4]
        WorldEnd""")
    out = tmp_path / "out.pfm"
    assert tcli.main([str(scene), str(out), "--integrator", "iispt",
                      "--iileIndirect", "1", "--iileDirect", "2",
                      "--iispt_hemi_size", "8", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "#INDPROGRESS!1.0" in lines
    assert "#DIRECTPROGRESS!0.5" in lines and "#DIRECTPROGRESS!1.0" in lines
    assert "#FINISH!" in lines
    img = imglib.read_pfm(str(out))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0
    for name in ("iispt_direct.exr", "iispt_indirect.exr"):
        assert (tmp_path / name).stat().st_size > 0
