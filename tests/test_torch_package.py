"""The port stands alone: its own copy of the committed net, its console
scripts, its relocatable bundle (``cli/package.py``), and no string in its
sources that points into the JAX package's tree.

The bundle test runs the bundle in fresh interpreters whose only import
path is the bundle's ``lib`` (and whose working directory is outside the
checkout), with ``jax`` and ``pbrt_v3_iile_tpu`` blocked in
``sys.modules``: every launcher's ``--help``, and an 8x8 IILE render on the
CPU with the bundle's default net, which must be finite.
"""

import ast
import hashlib
import importlib
import json
import os
import re
import subprocess
import sys
import tomllib

import numpy as np
import pytest

from pbrt_v3_iile_tpu_torch.cli import package
from pbrt_v3_iile_tpu_torch.cli import train as tcli_train
from pbrt_v3_iile_tpu_torch.models import weights as tweights
from pbrt_v3_iile_tpu_torch.utils import image as timage

from torch_parity import REPO

PORT = os.path.join(REPO, "pbrt_v3_iile_tpu_torch")
# 8x8 film of the training CLI's Cornell-style box
SCENE8 = tcli_train.DEMO_SCENE.replace(
    '"integer xresolution" [128] "integer yresolution" [128]',
    '"integer xresolution" [8] "integer yresolution" [8]')
# a child interpreter's threads, as the test workers cap theirs
ENV_THREADS = {"OMP_NUM_THREADS": "2"}


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_committed_net_is_the_ports_own_copy():
    """(a) The port's net is the JAX package's file byte for byte, and the
    default every IILE entry point reads lies inside the port."""
    jax_npz = os.path.join(REPO, "pbrt_v3_iile_tpu", "ml", "pretrained",
                           "iispt_pretrained.npz")
    assert _sha256(tweights.DEFAULT_NPZ) == _sha256(jax_npz)
    port = os.path.realpath(PORT) + os.sep
    for path in (tweights.DEFAULT_NPZ, tweights.TRAINED_NPZ):
        assert os.path.realpath(path).startswith(port), path
    from pbrt_v3_iile_tpu_torch.ml import train as ttrain

    assert ttrain.default_pretrained_path() == tweights.DEFAULT_NPZ


def test_port_console_scripts_resolve():
    """(d) Each console script of the port names a module with main(),
    the bundle's shims are the same set, and the torch extra and the nets'
    package data are declared."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        cfg = tomllib.load(f)
    scripts = {k: v for k, v in cfg["project"]["scripts"].items()
               if k.startswith("pbrt-iile-torch")}
    assert scripts == {k: f"{m}:main" for k, m in package.LAUNCHERS.items()}
    for target in scripts.values():
        mod, fn = target.split(":")
        assert callable(getattr(importlib.import_module(mod), fn)), target
    assert cfg["project"]["optional-dependencies"]["torch"] == ["torch", "numpy"]
    data = cfg["tool"]["setuptools"]["package-data"]["pbrt_v3_iile_tpu_torch"]
    assert "ml/pretrained/*.npz" in data


def _string_constants(tree):
    """The str constants of a module's AST that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    return [n for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_source_names_the_jax_tree():
    """(e) No string literal of the port's sources (docstrings excepted)
    names ``pbrt_v3_iile_tpu`` as a path or module component."""
    bad = []
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in _string_constants(tree):
                if "pbrt_v3_iile_tpu" in re.split(r"[/\\.]", node.value):
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno}")
    assert not bad, bad


_CHILD = r"""
import importlib, json, os, sys
sys.modules["jax"] = None
sys.modules["pbrt_v3_iile_tpu"] = None
lib, scene, out = sys.argv[1:4]
mods = sys.argv[4:]
import torch
torch.set_num_threads(2)
import pbrt_v3_iile_tpu_torch as pkg
from pbrt_v3_iile_tpu_torch.cli import main as climain
from pbrt_v3_iile_tpu_torch.models import weights
helps = {}
for mod in mods:
    try:
        helps[mod] = importlib.import_module(mod).main(["--help"])
    except SystemExit as e:
        helps[mod] = e.code
rc = climain.main([scene, out, "--integrator", "iispt", "--iileIndirect", "1",
                   "--iileDirect", "1", "--iispt_hemi_size", "8",
                   "--device", "cpu", "--quiet"])
loaded = [m for m, v in sys.modules.items() if v is not None
          and (m.split(".")[0] in ("jax", "pbrt_v3_iile_tpu"))]
print(json.dumps(dict(pkg=pkg.__file__, default_npz=weights.DEFAULT_NPZ,
                      helps=helps, rc=rc, loaded=loaded)))
"""


def test_bundle_runs_without_the_repo(tmp_path):
    """(c) The bundle holds the package alone (its CUDA and C++ sources and
    both nets, no caches, no built libraries); each launcher shim answers
    --help from the bundle alone; with jax and the JAX package blocked,
    every launcher's main answers --help and the CLI renders an 8x8 IILE
    image with the default net, finite."""
    out = package.build_bundle(str(tmp_path / "bundle"))
    lib = os.path.join(out, "lib")
    assert os.listdir(lib) == ["pbrt_v3_iile_tpu_torch"]
    pkg = os.path.join(lib, "pbrt_v3_iile_tpu_torch")
    copied = [os.path.relpath(os.path.join(d, f), pkg)
              for d, dirs, files in os.walk(pkg) for f in files + dirs]
    assert not [p for p in copied if "__pycache__" in p or p.endswith(".so")]
    for rel in ("csrc/cluster_traverse.cu", "csrc/bvh_traverse.cu",
                "native/bvh_builder.cpp", "ml/pretrained/iispt_pretrained.npz",
                "ml/pretrained/iispt_trained_h100.npz"):
        assert os.path.exists(os.path.join(pkg, rel)), rel
    assert _sha256(os.path.join(pkg, "ml/pretrained/iispt_pretrained.npz")) == \
        _sha256(tweights.DEFAULT_NPZ)

    run_dir = tmp_path / "run"
    run_dir.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(ENV_THREADS)
    shims = {name: subprocess.Popen([os.path.join(out, name), "--help"],
                                    cwd=run_dir, env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
             for name in package.LAUNCHERS}
    for name, p in shims.items():
        text, _ = p.communicate(timeout=120)
        assert os.access(os.path.join(out, name), os.X_OK), name
        # the reference's imgtool, obj2pbrt and cyhair2pbrt print their
        # usage and exit 1; the argparse launchers exit 0
        assert p.returncode in (0, 1), (name, text)
        assert name.replace("pbrt-iile-torch-", "") in text, (name, text)

    scene = run_dir / "box8.pbrt"
    scene.write_text(SCENE8)
    image = run_dir / "box8.pfm"
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, lib, str(scene), str(image),
         *package.LAUNCHERS.values()],
        cwd=run_dir, env=dict(env, PYTHONPATH=lib), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["pkg"].startswith(lib) and got["default_npz"].startswith(lib)
    assert got["loaded"] == []
    assert got["rc"] == 0
    for mod, rc in got["helps"].items():
        assert rc in (0, 1), (mod, rc)
    img = timage.read_pfm(str(image))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0
