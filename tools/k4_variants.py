"""Times SPPM's photon range query (K4) against the design it replaced, and
variants of both, on one NVIDIA GPU.

Run from the repository root:  python3 tools/k4_variants.py [--slots-only]

Builds, one nvcc each and all at once, into build/k4_variants/ (the
package's flags, with ptxas's registers and spills printed):
  slots        tools/photon_gather_slots.cu, the design it replaced: one thread a
               visible point writes its row of an (N, 8 * K_CAP) slot
               table, each cell's bucket bounds by two binary searches;
  no_table     the same with the slot table's store taken out (M and
               dropped only);
  start_table  the same with each cell's bucket bounds read from a
               bucket-start table (start[h], start[h + 1], made here by
               torch.searchsorted) in place of the searches;
  no_table_start_table
               both changes: the searches' share once the table is gone;
  query        pbrt_v3_iile_tpu_torch/csrc/photon_gather.cu as it is (16
               visible points a warp in the count and fill passes);
  query_8_points, query_4_points
               the same with 2 or 1 cell offsets a lane (8 or 4 points a
               warp) in place of 4;
  query_start_thread
               the start table filled by one thread a sorted index, each
               its own gap of buckets, in place of a warp's lanes together;
  query_start_search
               the start table made by one thread a bucket, each a binary
               search of h_sorted;
  query_start_shortcut
               the warps' fill with a round that lies in one lane's range
               given to that lane without the owner search (the owner
               carried from round to round);
  query_start_unroll4
               the warps' fill with its rounds unrolled by 4.
Each variant is a source with named lines replaced (each must match
exactly once), so it differs from its source only where it says.

The inputs are chip_smoke.py phase 13(a)'s: the first SPPM iteration of
atrium 512^2 (the file's depth 6, radius 0.05, one photon a pixel, seed
3).  Timed by CUDA events over 20 back-to-back calls, each held first to
the slots kernel's output:
  the slots variants' bare ctypes entry point (M and dropped equal, and
  the table where there is one), and slots_compacted: the slots kernel
  followed by the compaction the gather made of its table before the pair
  list (torch.nonzero of slots >= 0 and the gather of the photons, with
  its host sync);
  unless --slots-only: the query variants through the package's wrapper
  (photon_kernel.photon_query_cuda: every launch, the prefix sum and the
  host's read of the pair count; the pair list equal to the slots table's
  compaction, M and dropped to the slots kernel's), each with its
  kernels' device times by torch.profiler;
  then gather and gather_slots: integrators/sppm.py::_gather with the
  package's query and with the slot-table query (the slots kernel, its table
  held to the gather's end as that gather held it, compacted by nonzero),
  in turns (slots, package, package, slots, twice): ms, and the device
  memory peak over what the gather is handed.
Prints one JSON line each, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "build", "k4_variants")
SLOTS_SRC = os.path.join(REPO, "tools", "photon_gather_slots.cu")
QUERY_SRC = os.path.join(REPO, "pbrt_v3_iile_tpu_torch", "csrc", "photon_gather.cu")
REPS = 20
FILM = 512
RADIUS = 0.05
SEED = 3

NO_TABLE = [("      row[o * kCap + k] = slot;\n", "")]
START_TABLE = [("      lo = bound(h_sorted, n_photons, hc, false);\n"
                "      hi = bound(h_sorted, n_photons, hc, true);\n",
                "      lo = __ldg(h_sorted + hc);  // h_sorted is the start table here\n"
                "      hi = __ldg(h_sorted + hc + 1);\n")]
# the start table's fill as csrc/photon_gather.cu has it, and its loop
START_BODY = (
    "  const int lane = threadIdx.x & 31;\n"
    "  const int j = blockIdx.x * kThreads + threadIdx.x;\n"
    "  if (j - lane > n) return;  // the whole warp\n"
    "  int prev = -1, cur = -1;\n"
    "  if (j <= n) {\n"
    "    prev = j > 0 ? min(__ldg(h_sorted + j - 1), m) : -1;\n"
    "    cur = j < n ? min(__ldg(h_sorted + j), m) : m;\n"
    "  }\n"
    "  const int gap = j <= n ? max(cur - prev, 0) : 0;\n"
    "  const int incl = inclusive_sum(gap, lane);\n"
    "  const int total = __shfl_sync(kFull, incl, 31);\n"
    "  const int b0 = __shfl_sync(kFull, prev, 0) + 1;\n")
START_LOOP = (
    "  for (int g0 = 0; g0 < total; g0 += 32) {\n"
    "    const int t = g0 + lane;\n"
    "    const int own = owner_lane(incl, t);\n"
    "    if (t < total) start[b0 + t] = j - lane + own;\n"
    "  }\n")
START_THREAD = [(START_BODY + START_LOOP,
                 "  const int j = blockIdx.x * kThreads + threadIdx.x;\n"
                 "  if (j > n) return;\n"
                 "  const int prev = j > 0 ? __ldg(h_sorted + j - 1) : -1;\n"
                 "  const int cur = j < n ? min(__ldg(h_sorted + j), m) : m;\n"
                 "  for (int b = prev + 1; b <= cur; ++b) start[b] = j;\n")]
START_SEARCH = [
    (START_BODY + START_LOOP,
     "  const int b = blockIdx.x * kThreads + threadIdx.x;\n"
     "  if (b > m) return;\n"
     "  int lo = 0, hi = n;\n"
     "  while (lo < hi) {\n"
     "    const int mid = (lo + hi) >> 1;\n"
     "    if (__ldg(h_sorted + mid) < b) lo = mid + 1; else hi = mid;\n"
     "  }\n"
     "  start[b] = lo;\n"),
    ("  bucket_start_kernel<<<n_photons / kThreads + 1, kThreads, 0, st>>>(",
     "  bucket_start_kernel<<<m / kThreads + 1, kThreads, 0, st>>>(")]
START_SHORTCUT = [(START_LOOP,
                   "  int own0 = 0;  // the owner of bucket g0 - 1\n"
                   "  for (int g0 = 0; g0 < total; g0 += 32) {\n"
                   "    const int t = g0 + lane;\n"
                   "    const int own = __shfl_sync(kFull, incl, own0) > g0 + 31\n"
                   "                        ? own0 : owner_lane(incl, t);\n"
                   "    if (t < total) start[b0 + t] = j - lane + own;\n"
                   "    own0 = __shfl_sync(kFull, own, 31);\n"
                   "  }\n")]
START_UNROLL = [(START_LOOP, "#pragma unroll 4\n" + START_LOOP)]
SLOTS = lambda k: [("constexpr int kSlots = 4;", f"constexpr int kSlots = {k};")]
# name -> (source, [(lines, replacement), ...])
VARIANTS = {"slots": (SLOTS_SRC, []), "no_table": (SLOTS_SRC, NO_TABLE),
            "start_table": (SLOTS_SRC, START_TABLE),
            "no_table_start_table": (SLOTS_SRC, NO_TABLE + START_TABLE),
            "query": (QUERY_SRC, []),
            "query_8_points": (QUERY_SRC, SLOTS(2)),
            "query_4_points": (QUERY_SRC, SLOTS(1)),
            "query_start_thread": (QUERY_SRC, START_THREAD),
            "query_start_search": (QUERY_SRC, START_SEARCH),
            "query_start_shortcut": (QUERY_SRC, START_SHORTCUT),
            "query_start_unroll4": (QUERY_SRC, START_UNROLL)}


def build(name):
    """nvcc of one variant (the package's flags); returns its ctypes
    library and what ptxas says of its registers and spills."""
    from pbrt_v3_iile_tpu_torch import _build

    src_path, edits = VARIANTS[name]
    with open(src_path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    src = os.path.join(OUT, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(OUT, f"lib{name}.so")
    cmd = [_build._nvcc()] + _build.NVCC_FLAGS + ["-Xptxas=-v", "-o", lib, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    ptxas = [ln.split(":", 1)[-1].strip() for ln in r.stderr.splitlines()
             if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(lib), ptxas


def sppm_inputs(dev):
    """The first SPPM iteration of atrium 512^2, made as chip_smoke.py
    phase 13(a) makes it: _gather's arguments (vp, ph, radius,
    grid_origin, cell) and the range query's."""
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.integrators import sppm as sppmlib
    from pbrt_v3_iile_tpu_torch.ops import camera as camlib
    from pbrt_v3_iile_tpu_torch.ops import samplers as smplr
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.scene import api as apilib

    sd = apilib.load_scene(os.path.join(REPO, "scenes", "atrium.pbrt"))
    sd.film.x_resolution = sd.film.y_resolution = FILM
    scene, cam = renderlib.build(sd, dev, with_clusters=False)
    N = FILM * FILM
    depth = sd.integrator.max_depth
    key = threefry.fold_in(threefry.prng_key(SEED), 0)
    py, px = torch.meshgrid(torch.arange(FILM, dtype=torch.float32, device=dev),
                            torch.arange(FILM, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([px, py], -1).reshape(-1, 2)
    jitter = smplr.uniform(smplr.wave_key(key, 0, 0, smplr.DIM_PIXEL_JITTER),
                           (N, 2), dev)
    o0, d0 = camlib.generate_rays(cam, pix + jitter)
    _, vp = sppmlib._camera_pass(scene, o0, d0, key, depth)
    ph = sppmlib._photon_pass(scene, key, N, depth, dev)
    radius = torch.full((N,), RADIUS, device=dev)
    grid_origin = 0.5 * (scene.world_min + scene.world_max) - scene.world_radius
    cell = 2.0 * torch.clamp(torch.max(radius), min=1e-6)
    m, h_sorted, order = sppmlib.photon_map(ph[0], ph[3], grid_origin, cell)
    lo_c, hi_c = sppmlib.cell_ranges(vp, radius, grid_origin, cell)
    args = (lo_c, hi_c, vp["valid"], vp["p"].contiguous(), radius * radius,
            h_sorted, ph[0][order].contiguous(), m)
    return vp, ph, radius, grid_origin, cell, args


def events_ms(fn):
    """Mean ms per call of fn() over REPS back-to-back calls, by CUDA
    events (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def device_us(fn):
    """Device time per call of each kernel and copy fn() runs, in us over
    REPS calls by torch.profiler (not the aten operators and runtime
    calls that launched them), by short name."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (getattr(e, "device_time_total", 0) > 0
                and not e.key.startswith(("aten::", "cuda", "Activity"))):
            k = re.search(r"\w+_kernel(<\d+, \w+>)?|\w+Kernel|Memcpy \w+", e.key)
            k = k.group(0) if k else e.key[:60]
            out[k] = out.get(k, 0.0) + e.device_time_total / REPS
    return out


def slots_variants(built, args):
    """The slots kernel and its variants, each held to the slots kernel;
    returns the slots kernel's function, its (slots, M, dropped) and its
    table's compaction (pair_point, pair_photon)."""
    lo_c, hi_c, valid, vp_p, r2, h_sorted, p_sorted, m = args
    N, Pn = lo_c.shape[0], h_sorted.shape[0]
    dev = lo_c.device
    valid_u8 = valid.to(torch.uint8)
    start = torch.searchsorted(h_sorted, torch.arange(
        m + 1, dtype=torch.int32, device=dev)).to(torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ref = pairs = slots_fn = None
    for name, (lib, ptxas) in built.items():
        if VARIANTS[name][0] != SLOTS_SRC:
            continue
        fn = lib.photon_gather
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
        slots = torch.full((N, 8 * 32), -1, dtype=torch.int32, device=dev)
        M = torch.empty(N, dtype=torch.float32, device=dev)
        dropped = torch.empty(N, dtype=torch.int32, device=dev)
        table = start if name.endswith("start_table") else h_sorted

        def launch(fn=fn, table=table, slots=slots, M=M, dropped=dropped,
                   name=name):
            err = fn(lo_c.data_ptr(), hi_c.data_ptr(), valid_u8.data_ptr(),
                     vp_p.data_ptr(), r2.data_ptr(), table.data_ptr(),
                     p_sorted.data_ptr(), Pn, m, slots.data_ptr(), M.data_ptr(),
                     dropped.data_ptr(), N, stream)
            if err:
                raise SystemExit(f"{name}: launch failed: cudaError {err}")

        launch()
        torch.cuda.synchronize()
        if ref is None:
            ref, slots_fn = (slots, M, dropped), fn
        same = [bool(torch.equal(M, ref[1])), bool(torch.equal(dropped, ref[2]))]
        if not name.startswith("no_table"):
            same.append(bool(torch.equal(slots, ref[0])))
        if not all(same):
            raise SystemExit(f"{name}: differs from the slots kernel: {same}")
        print(json.dumps(dict(variant=name, ms=events_ms(launch), ptxas=ptxas)),
              flush=True)
        if pairs is None:
            def compacted(launch=launch, slots=slots):
                launch()
                n_idx, k_idx = torch.nonzero(slots >= 0, as_tuple=True)
                return n_idx.to(torch.int32), slots[n_idx, k_idx]

            pairs = compacted()
            print(json.dumps(dict(variant="slots_compacted",
                                  ms=events_ms(compacted),
                                  pairs=int(pairs[0].shape[0]))), flush=True)
    return slots_fn, ref, pairs


def query_variants(K4, built, args, ref, pairs):
    """The query variants through the package's wrapper (its library
    swapped for each), held to the slots kernel's output, timed and
    profiled."""
    query = lambda: K4.photon_query_cuda(*args)
    package_lib = K4._lib
    try:
        for name, (lib, ptxas) in built.items():
            if VARIANTS[name][0] != QUERY_SRC:
                continue
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.photon_count.restype = lib.photon_fill.restype = i32
            lib.photon_points_per_warp.restype = i32
            lib.photon_points_per_warp.argtypes = []
            lib.photon_count.argtypes = [ptr] * 7 + [i32] * 3 + [ptr] * 5
            lib.photon_fill.argtypes = [ptr] * 7 + [i32] * 2 + [ptr] * 4
            K4._lib = lambda lib=lib: lib
            got = query()
            torch.cuda.synchronize()
            same = [bool(torch.equal(got[0], pairs[0])),
                    bool(torch.equal(got[1], pairs[1])),
                    bool(torch.equal(got[2], ref[1])),
                    bool(torch.equal(got[3], ref[2]))]
            if not all(same):
                raise SystemExit(f"{name}: differs from the slots kernel: {same}")
            print(json.dumps(dict(
                variant=name, points_per_warp=lib.photon_points_per_warp(),
                ms=events_ms(query), pairs=int(got[0].shape[0]),
                device_us=device_us(query), ptxas=ptxas)), flush=True)
    finally:
        K4._lib = package_lib


def gathers(K4, slots_fn, gather):
    """The whole gather with the package's query and with the slot-table query,
    in turns: ms, the memory peak, and both held to each other (M and
    dropped equal, Phi within 1e-5 of its max: the card adds by atomics)."""
    from pbrt_v3_iile_tpu_torch.integrators import sppm as sppmlib

    vp, ph, radius, grid_origin, cell, args = gather
    lo_c, hi_c, valid, vp_p, r2, h_sorted, p_sorted, m = args
    N = lo_c.shape[0]
    held = []

    def slots_query(*a):
        held.clear()
        slots = torch.empty((N, 8 * K4.K_CAP), dtype=torch.int32, device=lo_c.device)
        M = torch.empty(N, dtype=torch.float32, device=lo_c.device)
        dropped = torch.empty(N, dtype=torch.int32, device=lo_c.device)
        err = slots_fn(lo_c.data_ptr(), hi_c.data_ptr(),
                       valid.to(torch.uint8).data_ptr(), vp_p.data_ptr(),
                       r2.data_ptr(), h_sorted.data_ptr(), p_sorted.data_ptr(),
                       h_sorted.shape[0], m, slots.data_ptr(), M.data_ptr(),
                       dropped.data_ptr(), N,
                       torch.cuda.current_stream(lo_c.device).cuda_stream)
        if err:
            raise SystemExit(f"slots: launch failed: cudaError {err}")
        held.append(slots)   # the slot-table gather held it to its end
        n_idx, k_idx = torch.nonzero(slots >= 0, as_tuple=True)
        return n_idx.to(torch.int32), slots[n_idx, k_idx], M, dropped

    run = lambda: sppmlib._gather(vp, *ph, radius, grid_origin, cell)
    package_query = K4.photon_query
    results = {}
    for name in ("gather_slots", "gather", "gather", "gather_slots") * 2:
        K4.photon_query = slots_query if name == "gather_slots" else package_query
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            out = run()
            torch.cuda.synchronize()
            peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 1e6
            held.clear()
            ms = events_ms(run)
            held.clear()
        finally:
            K4.photon_query = package_query
        results.setdefault(name, out)
        print(json.dumps(dict(variant=name, ms=ms, peak_mb=peak_mb)), flush=True)
    a, b = results["gather"], results["gather_slots"]
    phi_err = float((a[0] - b[0]).abs().max() / b[0].abs().max().clamp(min=1e-30))
    if not (torch.equal(a[1], b[1]) and int(a[2]) == int(b[2]) and phi_err <= 1e-5):
        raise SystemExit(f"the two gathers differ: Phi by {phi_err} of its max")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k4_variants: needs an NVIDIA GPU")
    from pbrt_v3_iile_tpu_torch.ops import photon_kernel as K4

    slots_only = "--slots-only" in sys.argv[1:]
    names = [n for n in VARIANTS
             if not (slots_only and VARIANTS[n][0] == QUERY_SRC)]
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda:0")
    with ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(build, names)))
    gather = sppm_inputs(dev)
    slots_fn, ref, pairs = slots_variants(built, gather[-1])
    if not slots_only:
        query_variants(K4, built, gather[-1], ref, pairs)
        gathers(K4, slots_fn, gather)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
