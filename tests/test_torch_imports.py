"""The port imports no jax: with ``sys.modules["jax"] = None`` every
module of pbrt_v3_iile_tpu_torch imports, and a 4x4 render runs.

The check runs in a fresh interpreter, since the test process itself
has jax loaded (tests/conftest.py).
"""

import os
import subprocess
import sys

from torch_parity import REPO

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
import pbrt_v3_iile_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from pbrt_v3_iile_tpu.scene import api as apilib
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
assert not any(m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
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
