"""PyTorch + CUDA port of the pbrt_v3_iile_tpu renderer.

The JAX package ``pbrt_v3_iile_tpu`` stays the reference; this package
renders the same scenes with the wavefront ``path`` integrator in eager
PyTorch, with the two traversal kernels written by hand in CUDA for
Hopper (``csrc/``).  Host-only modules of the reference (the scene
parser, the BVH builder, image I/O) carry no JAX import and are used
from there directly.  Importing this package imports nothing.
"""
