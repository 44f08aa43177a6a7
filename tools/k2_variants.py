"""Times the BVH kernel (K2) against variants of it on one NVIDIA GPU.

Run from the repository root:  python3 tools/k2_variants.py

Builds, one nvcc each and all at once, into build/k2_variants/:
  wide4      pbrt_v3_iile_tpu_torch/csrc/bvh_traverse.cu as it is;
  wide8      the same source with kWidth 8 (and 2 blocks an SM), on an
             8-wide collapse of the same BVH;
  top64, top256
             the first 64 or 256 wide nodes (8 or 32 KB) copied to each
             block's shared memory with cp.async and read from there;
  refill1, refill32
             a warp refills its lanes once 1 or 32 of them are idle (8);
  grid_half  a persistent grid of half the resident blocks;
  binary     tools/bvh_traverse_binary.cu, the design the kernel replaced
             (one thread a ray over the binary nodes).
Each variant is the source with named lines replaced (each must match
exactly once), so it differs from the kernel only where it says.

On the 65,536-ray diffuse-bounce wave of the atrium 512^2 film (made as
chip_smoke.py makes it) each wide variant must equal
bvh_traverse_wide_plain bit for bit, and the binary kernel the binary
walker.  Each is then timed by CUDA events over 20 back-to-back launches
of its bare ctypes entry point, two ways:
  ms         the launches as the host issues them, as chip_smoke.py times
             its kernels (any gap the host leaves between launches counts);
  queued_ms  the same launches queued behind a ~50 ms device sleep, so the
             device runs them back to back: the kernel's time alone;
and host_us, the host's time per launch call in the queued run.  Also
times the package's wrapper (intersect_kernel.bvh_traverse_cuda), the
call the render path makes, both ways.  Prints one JSON line per variant,
then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CSRC = os.path.join(REPO, "pbrt_v3_iile_tpu_torch", "csrc")
OUT = os.path.join(REPO, "build", "k2_variants")
REPS = 20


def _top(n):
    return [
        ("#include <stdint.h>\n",
         '#include <stdint.h>\n\n#include "cp_async.cuh"\n'),
        ("template <bool kMotion>\nconstexpr size_t smem_bytes() {\n"
         "  return sizeof(int2) * kShort * kThreads + sizeof(WarpTestsT<kMotion>) * kWarps;\n",
         f"constexpr int kTopNodes = {n};\n"
         "template <bool kMotion>\nconstexpr size_t smem_bytes() {\n"
         "  return sizeof(int2) * kShort * kThreads + sizeof(WarpTestsT<kMotion>) * kWarps +\n"
         "         sizeof(float4) * kNodeF4 * kTopNodes;\n"),
        ("      reinterpret_cast<WarpTestsT<kMotion>*>(ring + kShort * kThreads);\n",
         "      reinterpret_cast<WarpTestsT<kMotion>*>(ring + kShort * kThreads);\n"
         "  float4* top = reinterpret_cast<float4*>(tests + kWarps);\n"
         "  for (int i = threadIdx.x; i < kTopNodes * kNodeF4; i += kThreads)\n"
         "    cp_async::copy16(top + i, wide + i);\n"
         "  cp_async::commit();\n"
         "  cp_async::wait_all();\n"
         "  __syncthreads();\n"),
        ("      const float4* p = wide + (size_t)node * kNodeF4;\n"
         "#pragma unroll\n"
         "      for (int i = 0; i < kLoadF4; ++i) q[i] = __ldg(p + i);\n",
         "      if (node < kTopNodes) {\n"
         "#pragma unroll\n"
         "        for (int i = 0; i < kLoadF4; ++i) q[i] = top[node * kNodeF4 + i];\n"
         "      } else {\n"
         "        const float4* p = wide + (size_t)node * kNodeF4;\n"
         "#pragma unroll\n"
         "        for (int i = 0; i < kLoadF4; ++i) q[i] = __ldg(p + i);\n"
         "      }\n"),
    ]


# name -> (width of the collapse, [(line, replacement), ...]); the binary
# kernel is built from its own file
VARIANTS = {
    "wide4": (4, []),
    "wide8": (8, [("constexpr int kWidth = 4;", "constexpr int kWidth = 8;"),
                  ("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 2;")]),
    "top64": (4, _top(64)),
    "top256": (4, _top(256)),
    "refill1": (4, [("constexpr int kRefillMin = 8;", "constexpr int kRefillMin = 1;")]),
    "refill32": (4, [("constexpr int kRefillMin = 8;", "constexpr int kRefillMin = 32;")]),
    "grid_half": (4, [("const int grid = want < mb ? want : mb;",
                       "const int grid = want < mb / 2 ? want : mb / 2;")]),
}
TOP_NODES = 256  # the scene must have at least this many wide nodes


def build(name):
    """nvcc of one variant (the package's flags); returns its ctypes lib
    and what ptxas says of its registers and spills."""
    from pbrt_v3_iile_tpu_torch import _build

    if name == "binary":
        src = os.path.join(REPO, "tools", "bvh_traverse_binary.cu")
    else:
        with open(os.path.join(CSRC, "bvh_traverse.cu")) as f:
            text = f.read()
        for old, new in VARIANTS[name][1]:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
    lib = os.path.join(OUT, f"lib{name}.so")
    cmd = ([_build._nvcc()] + _build.NVCC_FLAGS
           + ["-Xptxas=-v", "-I", CSRC, "-o", lib, src])
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    ptxas = [ln.split(":", 1)[-1].strip() for ln in r.stderr.splitlines()
             if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(lib), ptxas


def bounce_wave(dev):
    """The atrium 512^2 scene and the 65,536-ray bounce wave of
    chip_smoke.py (primary rays of wave 0, cosine bounces, seed 3)."""
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import intersect as isect
    from pbrt_v3_iile_tpu_torch.ops import sampling as smp
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.scene import api as apilib
    from pbrt_v3_iile_tpu_torch.utils import vecmath as vm

    sd = apilib.load_scene(os.path.join(REPO, "scenes", "atrium.pbrt"))
    sd.film.x_resolution = sd.film.y_resolution = 512
    scene, cam = renderlib.build(sd, dev, with_clusters=False)
    prep = renderlib.make_wave_prep(sd, dev, chunk_rows=128)
    o_p, d_p, *_ = prep(cam, threefry.prng_key(0), 0, 0)
    hp = isect.intersect_bvh(scene, o_p, d_p, torch.full_like(o_p[:, 0], 1e30))
    it = isect.make_interaction(scene, o_p, d_p, hp)
    ng = vm.face_forward(it.ng, -d_p)
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.random((o_p.shape[0], 2), dtype=np.float32),
                        device=dev)
    tf, bf = vm.coordinate_system(ng)
    d_b = vm.to_world(smp.cosine_sample_hemisphere(u), tf, bf, ng)
    o_b = vm.offset_ray_origin(it.p, ng, d_b)
    tm_b = torch.where(hp.valid, 1e30, -1.0)
    return scene, (o_b.contiguous(), d_b.contiguous(), tm_b.contiguous())


def events_ms(fn, queued):
    """Mean ms per call of fn() over REPS calls by CUDA events, and the
    host's us per call; queued: behind a device sleep."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clock
    a.record()
    h0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    host_us = (time.perf_counter() - h0) / REPS * 1e6
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS, host_us


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: needs an NVIDIA GPU")
    from pbrt_v3_iile_tpu_torch.ops import intersect as isect
    from pbrt_v3_iile_tpu_torch.ops import intersect_kernel as K2

    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda:0")
    names = list(VARIANTS) + ["binary"]
    with ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(build, names)))
    scene, (o, d, tm) = bounce_wave(dev)
    n = o.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    nodes_np = scene.nodes_packed.cpu().numpy()
    wides = {w: K2.build_bvh4_np(nodes_np, width=w) for w in (4, 8)}
    if wides[4][0].shape[0] < TOP_NODES:
        raise SystemExit(f"the scene has fewer than {TOP_NODES} wide nodes")
    outs = [torch.empty(n, dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
    ptrs = [x.data_ptr() for x in outs]
    walker = isect.intersect_bvh(scene, o, d, tm)
    rows = []
    for name in names:
        lib, ptxas = built[name]
        fn = lib.bvh_traverse
        fn.restype = ctypes.c_int
        if name == "binary":
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p])
            args = (scene.nodes_packed.data_ptr(), scene.tris_packed.data_ptr(),
                    o.data_ptr(), d.data_ptr(), tm.data_ptr(), *ptrs, n, 0,
                    stream)
            want = (walker.t, walker.prim, walker.b1, walker.b2)
        else:
            width = VARIANTS[name][0]
            wide_np, depth = wides[width]
            wide = torch.as_tensor(wide_np, device=dev)
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p] * 2)
            lib.bvh_traverse_spill_entries.restype = ctypes.c_int
            entries = lib.bvh_traverse_spill_entries(depth)
            if entries < 0:
                raise SystemExit(f"{name}: cudaError {-entries}")
            work = torch.zeros(2 + 2 * entries, dtype=torch.int32, device=dev)
            args = (wide.data_ptr(), scene.tris_packed.data_ptr(), o.data_ptr(),
                    d.data_ptr(), tm.data_ptr(), *ptrs, n, 0, work.data_ptr(),
                    stream)
            want = K2.bvh_traverse_wide_plain(wide, scene.tris_packed, o, d, tm)

        def launch(fn=fn, args=args, name=name):
            err = fn(*args)
            if err:
                raise SystemExit(f"{name}: launch failed: cudaError {err}")

        launch()
        torch.cuda.synchronize()
        identical = [bool(torch.equal(a, b.to(a.dtype))) for a, b in zip(outs, want)]
        if not all(identical):
            raise SystemExit(f"{name}: differs from its plain version: {identical}")
        ms, _ = events_ms(launch, queued=False)
        queued_ms, host_us = events_ms(launch, queued=True)
        rows.append(dict(variant=name, ms=ms, queued_ms=queued_ms,
                         host_us=host_us, identical=identical, ptxas=ptxas))
        print(json.dumps(rows[-1]), flush=True)

    wrap = lambda: K2.bvh_traverse_cuda(scene.bvh4_nodes, scene.bvh4_stack,
                                        scene.tris_packed, o, d, tm)
    ms, _ = events_ms(wrap, queued=False)
    queued_ms, host_us = events_ms(wrap, queued=True)
    print(json.dumps(dict(variant="wide4_wrapper", ms=ms, queued_ms=queued_ms,
                          host_us=host_us)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
