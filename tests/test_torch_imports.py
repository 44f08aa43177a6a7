"""The port imports neither jax nor the JAX package: with
``sys.modules["jax"]`` and ``sys.modules["pbrt_v3_iile_tpu"]`` set to None
every module of pbrt_v3_iile_tpu_torch imports (the training modules
``ml/{losses,dataset,train,evalstats}``, ``utils/metrics`` and
``cli/train``, and ``integrators/ao``, ``scene/ptex``,
``utils/{stats,config}``, ``parallel/*``, the tools ``cli/{imgtool,
obj2pbrt,cyhair2pbrt,tools,gui}`` and the viewers
``ml/interactive{,_web}`` among them), a 4x4 scene parsed by the port's
own ``scene/api.py`` renders (also row-sharded over 2 shards; the tools'
bsdftest runs; also on the kd-tree, and with ``bdpt``,
``sppm``, ``mlt`` and ``grad`` at 8x8), a scene with camera
and object motion (its device scene with the BVH kernel's motion tables,
which the kernel's plain version walks) and one through a realistic lens
render, a scene
without a Sampler line (pbrt's
default, halton), with a procedural texture and a goniometric light,
renders with ``path``, ``whitted`` and ``ambientocclusion``, a volpath
scene with fog, a grid medium, kdsubsurface, Fourier and hair materials
(``ops/hair.py``, ``ops/fourierbsdf.py``) renders, the first
scene at 8x8 renders with IILE (1
task, 1 direct pass, 8x8 hemispheres, the pretrained IISPTNet read from
its npz), and a narrow net takes a train step on batches made by the
port's dataset module.

The check runs in a fresh interpreter, since the test process itself
has jax loaded (tests/conftest.py).
"""

import os
import subprocess
import sys

from torch_parity import REPO

SCRIPT = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(2)
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["pbrt_v3_iile_tpu"] = None   # ... and of the JAX package
import pbrt_v3_iile_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert {"pbrt_v3_iile_tpu_torch." + m for m in (
    "ml.losses", "ml.dataset", "ml.train", "ml.evalstats", "utils.metrics",
    "cli.train", "integrators.ao", "scene.ptex", "utils.stats",
    "utils.config", "ops.hair", "ops.fourierbsdf", "ops.kdtree",
    "ops.kd_kernel", "integrators.bdpt", "integrators.mlt",
    "integrators.sppm", "integrators.grad", "ops.photon_kernel",
    "parallel.distributed", "parallel.mesh", "parallel.sharded",
    "parallel.sharded_iile", "cli.imgtool", "cli.obj2pbrt", "cli.cyhair2pbrt",
    "cli.tools", "cli.gui", "ml.interactive", "ml.interactive_web")} <= set(names)
from pbrt_v3_iile_tpu_torch.scene import api as apilib
from pbrt_v3_iile_tpu_torch.integrators import render
sd = apilib.load_scene_string('''
    LookAt 0 1 -4  0 0.5 0  0 1 0
    Camera "perspective" "float fov" [55]
    Film "image" "integer xresolution" [4] "integer yresolution" [4]
    Sampler "sobol" "integer pixelsamples" [1]
    Integrator "path" "integer maxdepth" [2]
    WorldBegin
    LightSource "point" "rgb I" [30 30 30] "point from" [0 3 0]
    LightSource "infinite" "rgb L" [0.2 0.2 0.2]
    Material "matte" "rgb Kd" [0.7 0.7 0.7]
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
        "point P" [-6 -0.5 4  6 -0.5 4  6 6 4  -6 6 4]
    WorldEnd''')
img, stats = render.render(sd, spp=1, device="cpu")
assert img.shape == (4, 4, 3) and (img >= 0).all() and img.mean() > 0
from pbrt_v3_iile_tpu_torch.cli import tools
from pbrt_v3_iile_tpu_torch.ops import threefry
from pbrt_v3_iile_tpu_torch.parallel import sharded
scene4, cam4 = render.build(sd, "cpu")
L4, _, _ = sharded.sharded_render_pass(sd, device="cpu", n_shards=2)(
    scene4, cam4, threefry.prng_key(0), 0)
assert L4.shape == (4, 4, 3) and bool(L4.isfinite().all())
assert tools.bsdf_estimates("matte", 4096, device="cpu")["matte"]["ok"]
import numpy as np
img_kd, _ = render.render(sd, spp=1, device="cpu", accel="kdtree")
assert np.isfinite(img_kd).all() and img_kd.mean() > 0
sd_m = apilib.load_scene_string('''
    TransformTimes 0 1
    LookAt 0 1 -4  0 0.5 0  0 1 0
    ActiveTransform EndTime
    Translate 0.1 0 0
    ActiveTransform All
    Camera "perspective" "float fov" [55]
      "float shutteropen" [0] "float shutterclose" [1]
    Film "image" "integer xresolution" [4] "integer yresolution" [4]
    WorldBegin
    LightSource "point" "rgb I" [30 30 30] "point from" [0 3 0]
    Material "matte" "rgb Kd" [0.7 0.7 0.7]
    AttributeBegin
      ActiveTransform EndTime
      Rotate 30 0 1 0
      ActiveTransform All
      Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
          "point P" [-6 -0.5 4  6 -0.5 4  6 6 4  -6 6 4]
    AttributeEnd
    WorldEnd''')
assert sd_m.has_motion and sd_m.camera.cam_to_world_end is not None
img_m, _ = render.render(sd_m, spp=2, device="cpu")
assert np.isfinite(img_m).all() and img_m.mean() > 0
from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as K2
scene_m, _ = render.build(sd_m, "cpu")
M = scene_m.tris_steps_packed.shape[0]
assert M >= 2 and scene_m.mot_moving_tris.shape == (M - 1, 2, 24)
o_m = torch.tensor([[0.0, 1.0, -4.0]]).expand(8, 3).contiguous()
d_m = torch.tensor([[0.0, -0.1, 1.0]]) / torch.tensor([[0.0, -0.1, 1.0]]).norm()
hit_m = K2.bvh_traverse_motion_plain(scene_m, o_m, d_m.expand(8, 3).contiguous(),
                                     torch.full((8,), 1e30),
                                     torch.linspace(0, 1, 8))
assert bool((hit_m[1] >= 0).all())
sd_r = apilib.load_scene_string('''
    LookAt 0 1 -4  0 0.5 0  0 1 0
    Camera "realistic" "string lensfile" "scenes/lens_wide22.dat"
      "float aperturediameter" [8] "float focusdistance" [4]
    Film "image" "integer xresolution" [4] "integer yresolution" [4]
    WorldBegin
    LightSource "point" "rgb I" [30 30 30] "point from" [0 3 0]
    Material "matte" "rgb Kd" [0.7 0.7 0.7]
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
        "point P" [-6 -0.5 4  6 -0.5 4  6 6 4  -6 6 4]
    WorldEnd''', ".")
img_r, _ = render.render(sd_r, spp=4, device="cpu")
assert np.isfinite(img_r).all() and img_r.mean() > 0
text = '''
    LookAt 0 1 -4  0 0.5 0  0 1 0
    Camera "perspective" "float fov" [55]
    Film "image" "integer xresolution" [4] "integer yresolution" [4]
    WorldBegin
    LightSource "goniometric" "rgb I" [30 30 30] "point from" [0 3 0]
    Texture "n" "float" "wrinkled"
    Texture "kd" "color" "scale" "texture tex1" "n" "rgb tex2" [0.7 0.7 0.7]
    Material "matte" "texture Kd" "kd"
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
        "point P" [-6 -0.5 4  6 -0.5 4  6 6 4  -6 6 4]
    WorldEnd'''
for kind in ("path", "whitted", "ambientocclusion"):
    sd2 = apilib.load_scene_string(text)
    assert sd2.sampler.kind == "halton"
    sd2.integrator.kind = kind
    img2, _ = render.render(sd2, spp=2, device="cpu")
    assert img2.shape == (4, 4, 3) and np.isfinite(img2).all(), kind
    assert img2.mean() > 0, kind
from pbrt_v3_iile_tpu_torch.integrators import iispt
sd.film.x_resolution = sd.film.y_resolution = 8
imgs = iispt.render_iile(sd, indirect_tasks=1, direct_samples=1, hemi_size=8,
                         device="cpu")[:3]
assert all(x.shape == (8, 8, 3) and np.isfinite(x).all() for x in imgs)
assert imgs[0].mean() > 0   # one wall: the probes see no lit surface
sd3 = apilib.load_scene_string('''
    LookAt 0 1 -4  0 0.5 0  0 1 0
    Camera "perspective" "float fov" [55]
    Film "image" "integer xresolution" [6] "integer yresolution" [6]
    Integrator "volpath" "integer maxdepth" [3]
    MakeNamedMedium "fog" "string type" "homogeneous"
      "rgb sigma_a" [0.01 0.01 0.01] "rgb sigma_s" [0.1 0.1 0.1] "float g" [0.3]
    MediumInterface "" "fog"
    WorldBegin
    LightSource "point" "rgb I" [30 30 30] "point from" [0 3 0]
    Material "kdsubsurface" "rgb Kd" [0.8 0.8 0.8] "float mfp" [0.3]
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
        "point P" [-6 -0.5 4  6 -0.5 4  6 6 4  -6 6 4]
    Material "fourier" "string bsdffile" "scenes/atrium_transport.bsdf"
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
        "point P" [-6 -0.5 -6  6 -0.5 -6  6 -0.5 4  -6 -0.5 4]
    AttributeBegin
      MakeNamedMedium "smoke" "string type" "heterogeneous"
        "rgb sigma_a" [0.5 0.5 0.5] "rgb sigma_s" [2 2 2]
        "integer nx" [2] "integer ny" [2] "integer nz" [2]
        "float density" [0 1 1 0 1 0 0 1]
        "point p0" [-1 -0.5 -1] "point p1" [1 1.5 1]
      Material ""
      MediumInterface "smoke" "fog"
      Shape "trianglemesh" "point P" [-1 -0.5 -1  1 -0.5 -1  1 1.5 -1  -1 1.5 -1
          -1 -0.5 1  1 -0.5 1  1 1.5 1  -1 1.5 1]
        "integer indices" [0 2 1 0 3 2 4 5 6 4 6 7 0 1 5 0 5 4 3 6 2 3 7 6
          0 7 3 0 4 7 1 2 6 1 6 5]
    AttributeEnd
    Material "hair" "float eumelanin" [0.8]
    Shape "curve" "string type" "cylinder" "point P" [1.5 -0.5 0  1.5 0 0.1
        1.6 0.5 0  1.5 1 0] "integer splitdepth" [1] "float width0" [0.2]
        "float width1" [0.1]
    WorldEnd''', ".")
assert apilib.MAT_FOURIER in [m.kind for m in sd3.materials]
cfg3 = render.make_integrator_config(sd3, device="cpu")
assert (cfg3.volumetric and cfg3.grid_media and cfg3.has_hair
        and cfg3.has_subsurface)
img3, _ = render.render(sd3, spp=2, device="cpu")
assert img3.shape == (6, 6, 3) and np.isfinite(img3).all() and img3.mean() > 0
for kind in ("bdpt", "sppm"):
    sd.integrator.kind = kind
    img4, _ = render.render(sd, spp=4, device="cpu")
    assert img4.shape == (8, 8, 3) and np.isfinite(img4).all() and img4.mean() > 0
from pbrt_v3_iile_tpu_torch.integrators import grad, mlt
sd.integrator.kind = "mlt"
img5, _ = mlt.render_mlt(sd, mutations_per_pixel=4, device="cpu",
                         cfg=mlt.MLTConfig(max_depth=2, n_chains=64,
                                           n_bootstrap=128))
assert np.isfinite(img5).all() and img5.mean() > 0
sd.integrator.kind = "path"
scene6, cam6 = render.build(sd, "cpu")
img6, g6 = grad.make_image_and_grad_fn(sd, spp=1, device="cpu")(
    scene6, cam6, (0, 0))
assert set(g6) == set(grad.DIFF_FIELDS) and float(g6["mat_kd"].abs().sum()) > 0
import torch
from pbrt_v3_iile_tpu_torch.ml import dataset, train
from pbrt_v3_iile_tpu_torch.ops import threefry
state = train.init_training(torch.Generator().manual_seed(0), 8, device="cpu")
rng = np.random.default_rng(0)
raw = [{k: np.abs(rng.normal(size=(8, 8, 1 if k == "z" else 3))).astype(np.float32)
        for k in "pdnz"} for _ in range(2)]
state, losses = train.train(raw, state, threefry.prng_key(0), max_epochs=1,
                            batch_size=4, log=None, max_steps=2)
assert len(losses) == 2 and all(np.isfinite(losses))
assert not any(m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
               for m, v in sys.modules.items() if v is not None)
assert not any(m == "pbrt_v3_iile_tpu" or m.startswith("pbrt_v3_iile_tpu.")
               for m, v in sys.modules.items() if v is not None)
print("OK", len(names))
"""


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().startswith("OK")
    assert int(res.stdout.split()[-1]) >= 20   # every module was walked
