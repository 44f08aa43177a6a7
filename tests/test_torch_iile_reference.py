"""The plain IILE reference of the benchmark
(``benchmark/reference/pbrt_iile.py``) against the port, on the CPU.

The reference shares no code with the port, so its pieces are held to the
port's on the same inputs, and its frames to the port's frames in mean:

- the U-Net's eval forward equals ``IISPTNet`` at K = 64 on three 32x32
  probes, with seeded random weights (BatchNorm statistics drawn too) and
  with the committed net, to 1e-5 of the output's largest magnitude: both
  run fp32 convolutions of the same weights on the CPU and differ only in
  how BatchNorm's affine map is rounded;
- the network-input transforms and their inverse equal the port's to 1e-6
  relative (the same float32 operations);
- the neighbour weights equal the port's to 1e-6, and the hemisphere MIS
  the port's ``_mis_stage`` on the first task of the 16^2 atrium golden,
  with the uniforms drawn by the port's samplers: the same pixels valid,
  and rgb within 1e-4 relative on >= 99.5% of the lanes (a last-ulp
  difference can move a BSDF direction across a map pixel's edge);
- a whole ``render_iile`` at 24^2 with 2 tasks, 2 direct passes and 8^2
  hemispheres against two reference frames of the same traffic: each
  image's mean within NOISE_BOUND, four standard deviations of the
  difference of two 2-frame means at this size;
- ``render_iile`` with and without ``prebuilt=`` gives the same images bit
  for bit.
"""

import os

import numpy as np
import pytest
import torch

from benchmark.reference import pbrt_iile as ri
from benchmark.reference import pbrt_path as rp
from pbrt_v3_iile_tpu_torch.integrators import iispt as tiispt
from pbrt_v3_iile_tpu_torch.integrators import render as trender
from pbrt_v3_iile_tpu_torch.models import iisptnet
from pbrt_v3_iile_tpu_torch.models import transforms as nnx
from pbrt_v3_iile_tpu_torch.models import weights as tweights
from pbrt_v3_iile_tpu_torch.ops import bsdf as tbsdf
from pbrt_v3_iile_tpu_torch.ops import camera as tcam
from pbrt_v3_iile_tpu_torch.ops import samplers as smplr
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.scene import api as tapi
from pbrt_v3_iile_tpu_torch.utils import vecmath as vm

from torch_parity import ATRIUM, REPO, tt

GOLDEN = os.path.join(REPO, "tests", "golden", "parity_iile_task16.npz")
RES, TASKS, DIRECT, HEMI = 24, 2, 2, 8
# each image's mean, relative: at this size one frame's mean varies by
# about 3% (direct), 6% (indirect) and 3% (combined) of itself
NOISE_BOUND = {"combined": 0.12, "direct": 0.12, "indirect": 0.24}
KINDS = {tapi.MAT_MATTE: rp.MATTE, tapi.MAT_PLASTIC: rp.PLASTIC, tapi.MAT_UBER: rp.UBER,
         tapi.MAT_METAL: rp.METAL, tapi.MAT_GLASS: rp.GLASS}


def _flat(variables):
    out = {}
    for top in ("params", "batch_stats"):
        for layer, arrs in variables[top].items():
            for k, v in arrs.items():
                out[f"{top}/{layer}/{k}"] = torch.from_numpy(np.asarray(v, np.float32))
    return out


def _seeded_net(seed):
    g = torch.Generator().manual_seed(seed)
    net = iisptnet.init_params(iisptnet.IISPTNet(), g)
    with torch.no_grad():
        for bn in net.bn:
            c = bn.running_mean.shape[0]
            bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
            bn.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=g))
            bn.bias.copy_(0.1 * torch.randn(c, generator=g))
    return net.eval()


@pytest.mark.parametrize("which", ["seeded", "committed"])
def test_unet_equals_iisptnet(which):
    if which == "seeded":
        net = _seeded_net(7)
        w = _flat(tweights.flax_from_state_dict(net.state_dict()))
    else:
        net = tweights.load_iisptnet(device="cpu")
        w = {k: torch.from_numpy(v) for k, v in ri.load_weights(tweights.DEFAULT_NPZ).items()}
    assert net.k == 64
    x = 0.5 * torch.randn((3, 32, 32, 7), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = net(x)
        got = ri.unet(x, w)
    assert got.shape == want.shape == (3, 32, 32, 3)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-5 * scale


def _gbuffer(seed, P=3, H=32):
    g = torch.Generator().manual_seed(seed)
    intensity = 0.1 * torch.exp(torch.randn((P, H, H, 3), generator=g))
    normals = vm.normalize(torch.randn((P, H, H, 3), generator=g))
    distance = 5.0 * torch.rand((P, H, H, 1), generator=g)
    distance = torch.where(torch.rand((P, H, H, 1), generator=g) < 0.1, -1.0, distance)
    return intensity, normals, distance


def test_transforms_equal_the_port():
    intensity, normals, distance = _gbuffer(11)
    x_p, aux = nnx.probe_to_network_input(intensity, normals, distance)
    x_r, chan = ri.network_input(intensity, normals, distance)
    torch.testing.assert_close(x_r, x_p, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(chan, aux["chan_means"], rtol=1e-6, atol=0)
    y = torch.randn((3, 32, 32, 3), generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(ri.network_output(y, chan),
                               nnx.network_output_to_radiance(y, aux), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def task16():
    """The port's atrium at 16^2 and the first task's MIS inputs of the
    golden (tests/test_torch_iile.py)."""
    sd = tapi.load_scene(ATRIUM)
    sd.film.x_resolution = sd.film.y_resolution = 16
    scene, cam = trender.build(sd, "cpu")
    with np.load(GOLDEN) as z:
        mis_in = tuple(tt(z[f"mis_in/{i}"]) for i in range(19))
        ts = int(z["ts"])
    return dict(scene=scene, cam=cam, mis_in=mis_in, ts=ts,
                key=threefry.fold_in(threefry.fold_in(threefry.prng_key(0), 1000), 9))


def test_neighbour_weights_and_mis_equal_the_port(task16):
    scene, cam, ts = task16["scene"], task16["cam"], task16["ts"]
    (R, pv, look, orig, right, up, look2, coords_f, n_ids, fx, fy, in_img, found, beta,
     p, n, wo, mat, uv) = task16["mis_in"]
    n_ids = n_ids.long()
    want = tiispt.neighbour_weights(cam, coords_f[n_ids], pv[n_ids], look[n_ids],
                                    orig[n_ids], fx, fy, p, n, ts)
    got = ri.neighbour_weights(fx, fy, coords_f[n_ids], tcam.camera_position(cam), p, n,
                               look[n_ids], orig[n_ids], pv[n_ids], ts)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

    key = task16["key"]
    rgb_p, valid_p = tiispt._mis_stage(scene, cam, *task16["mis_in"], key, ts, HEMI)
    # the uniforms of _mis_stage, drawn by the port's samplers
    S = (fx.shape[0], 4, tiispt.HEMISPHERIC_IMPORTANCE_SAMPLES)
    u = lambda i, dim, shape: smplr.uniform(smplr.wave_key(key, 4, i, dim), shape)
    u_sel, u_xy = u(0, smplr.DIM_HEMI, S), u(1, smplr.DIM_HEMI, (*S, 2))
    u_bs, u_bl = u(2, smplr.DIM_BSDF_DIR, (*S, 2)), u(3, smplr.DIM_BSDF_LOBE, S)
    prm = tbsdf.gather_params(scene, torch.clamp(mat, min=0), uv=uv, p=p)
    kind = torch.full_like(prm.kind, -1).long()
    for a, b in KINDS.items():
        kind = torch.where(prm.kind == a, b, kind)
    assert (kind >= 0).all()
    m = ri.Mat(kind, prm.kd, prm.ks, prm.alpha, prm.eta, prm.metal_eta, prm.metal_k)
    px = in_img & found & (vm.luminance(beta) > 0)
    rgb_r, valid_r = ri.hemisphere_mis(R, m, n, wo, beta, px, got, n_ids, right, up, look2,
                                       HEMI, u_sel, u_xy, u_bs, u_bl)
    assert torch.equal(valid_r, valid_p)
    ok = ((rgb_r - rgb_p).abs() <= 1e-4 * rgb_p.abs() + 1e-9).all(-1)
    assert float(ok.float().mean()) >= 0.995
    assert float(rgb_p[valid_p].mean()) > 0


@pytest.fixture(scope="module")
def atrium24():
    sd = tapi.load_scene(ATRIUM)
    sd.film.x_resolution = sd.film.y_resolution = RES
    sd.integrator.max_depth = 5
    return sd, trender.build(sd, "cpu"), tweights.load_iisptnet(device="cpu")


def test_render_iile_agrees_with_the_reference_in_mean(atrium24):
    sd, prebuilt, net = atrium24
    port = [tiispt.render_iile(sd, net=net, seed=s, indirect_tasks=TASKS,
                               direct_samples=DIRECT, hemi_size=HEMI, device="cpu",
                               prebuilt=prebuilt)[:3] for s in (1, 2)]
    ref = ri.Iile(ri.load_scene(ATRIUM, RES, RES, 5), ri.load_weights(tweights.DEFAULT_NPZ),
                  "cpu")
    refs = [[x.numpy() for x in ref.frame(s, TASKS, DIRECT, HEMI)] for s in (3, 4)]
    for i, name in enumerate(("combined", "direct", "indirect")):
        a = np.mean([f[i].mean() for f in port])
        b = np.mean([f[i].mean() for f in refs])
        assert b > 0 and abs(a - b) <= NOISE_BOUND[name] * b, (name, a, b)


ROOM = """LookAt 0 1 -4  0 0.5 0  0 1 0
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
WorldEnd
"""


def test_prebuilt_gives_the_same_images(tmp_path):
    path = tmp_path / "room.pbrt"
    path.write_text(ROOM)
    sd = tapi.load_scene(str(path))
    kw = dict(seed=5, indirect_tasks=1, direct_samples=1, hemi_size=8, device="cpu")
    built = tiispt.render_iile(sd, **kw)
    pre = tiispt.render_iile(sd, prebuilt=trender.build(sd, "cpu"), **kw)
    for a, b in zip(built[:3], pre[:3]):
        assert a.mean() > 0
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="cluster pack"):
        tiispt.render_iile(sd, prebuilt=trender.build(sd, "cpu", with_clusters=False),
                           accel="clusters", **kw)
