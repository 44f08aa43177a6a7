"""Build a relocatable bundle of the PyTorch port (port of
``scripts/package.py``, the reference's tools/autopackage.py role).

The bundle is the package alone, ``<out>/lib/pbrt_v3_iile_tpu_torch/``
(its CUDA sources ``csrc/``, the native BVH builder's source ``native/``
and the committed nets under ``ml/pretrained/``; no ``__pycache__``, no
built ``.so``), and one launcher shim per console script of the port,
each running ``python3 -m <module>`` with ``<out>/lib`` on PYTHONPATH.
Nothing of the JAX package is copied or needed.  The kernels and the
native builder are built at first use into ``<out>/lib/build/``
(``_build.py``'s ``build/torch_kernels`` beside the package), so the
bundle needs ``nvcc`` on the machine that runs it on a GPU, and ``g++``
for the native BVH builder (numpy's builder runs without it).

Usage: python -m pbrt_v3_iile_tpu_torch.cli.package [outdir]
"""

from __future__ import annotations

import os
import shutil
import stat
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# shim name -> module; the names of pyproject.toml's console scripts
LAUNCHERS = {
    "pbrt-iile-torch": "pbrt_v3_iile_tpu_torch.cli.main",
    "pbrt-iile-torch-train": "pbrt_v3_iile_tpu_torch.cli.train",
    "pbrt-iile-torch-gui": "pbrt_v3_iile_tpu_torch.cli.gui",
    "pbrt-iile-torch-tools": "pbrt_v3_iile_tpu_torch.cli.tools",
    "pbrt-iile-torch-imgtool": "pbrt_v3_iile_tpu_torch.cli.imgtool",
    "pbrt-iile-torch-obj2pbrt": "pbrt_v3_iile_tpu_torch.cli.obj2pbrt",
    "pbrt-iile-torch-cyhair2pbrt": "pbrt_v3_iile_tpu_torch.cli.cyhair2pbrt",
}

_SHIM = """#!/bin/sh
# relocatable launcher: resolve the bundle root
HERE="$(cd "$(dirname "$0")" && pwd)"
PYTHONPATH="$HERE/lib${{PYTHONPATH:+:$PYTHONPATH}}" exec python3 -m {mod} "$@"
"""


def build_bundle(outdir: str) -> str:
    """Copy the package into ``outdir/lib`` (replacing an earlier copy)
    and write the launcher shims; returns ``outdir``."""
    os.makedirs(outdir, exist_ok=True)
    dst = os.path.join(outdir, "lib", os.path.basename(PKG))
    if os.path.isdir(dst):
        shutil.rmtree(dst)
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    for name, mod in LAUNCHERS.items():
        path = os.path.join(outdir, name)
        with open(path, "w") as f:
            f.write(_SHIM.format(mod=mod))
        os.chmod(path, os.stat(path).st_mode
                 | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
    return outdir


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    path = build_bundle(argv[0] if argv else os.path.join("dist", "pbrt-iile-torch"))
    n = sum(len(f) for _, _, f in os.walk(path))
    print(f"bundle at {path} ({n} files)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
