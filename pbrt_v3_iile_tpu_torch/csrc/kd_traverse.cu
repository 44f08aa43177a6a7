// kd-tree traversal kernel (K3) for Hopper: closest-hit or any-hit of each
// ray against the scene's kd-tree.
//
// Replaces the XLA walker pbrt_v3_iile_tpu/ops/kdtree.py:150 (intersect_kd,
// a lax.while_loop: the reference has no pallas_call for it).  The contract
// is that walker's, and the port's plain version ops/kdtree.py::
// intersect_kd_plain does the same rounded operations in the same order, so
// the two agree bit for bit (t, prim, barycentrics):
//   entry  clip the ray against the world bounds: tmin = max(0, slab near),
//          tmax = min(slab far * 1.0000004, t_max); no node when tmin > tmax;
//   step   a node whose tmin is not below the ray's t is culled (it pops);
//          a leaf tests the triangles kd_prims[off, off + count)
//          (Moller-Trumbore, 0 < t' < the ray's t at the step's start),
//          keeps the least t', a tie to the first in leaf order, which is
//          what the walker's in-order tests (each needing t' below the t
//          the earlier ones left) keep, and pops.  An interior node
//          computes tplane = (split - o) / d on its axis and takes the
//          near child only when tplane > tmax or tplane <= 0 (pbrt's
//          ordered test), the far child only when tplane < tmin, else the
//          near child with tmax = tplane after pushing (far, tplane, tmax);
//   pop    the top (node, tmin, tmax) entry, or the end of the walk;
//   any    any-hit ends the walk after the step that found a hit.
// The stack holds 48 entries (STACK_DEPTH of ops/kdtree.py); a push onto a
// full stack overwrites its top entry, as the walker's does.  Unlike the
// reference's walker, which tests only the first 8 triangles of a leaf,
// every triangle of a leaf is tested (ops/kdtree.py's docstring).
//
// Bound on the H100 (PERF.md, chip_smoke.py): the node visits (a 12-byte
// node, ~10 operations) and triangle tests (a 48-byte triangle, 53
// operations) that the run's rays make, against the bytes of the tree, the
// triangles and the rays; on atrium's 65,536-ray bounce wave ~6 us, bound
// by operations.  The first version walked one ray a thread with its stack
// in local memory, ~100x from that bound: the wave makes 4.5 M node visits
// and 7.0 M triangle tests (107 a ray) over leaves of up to 115
// triangles, and one lane tested its leaf serially, one dependent load a
// triangle, while the rest of its warp waited.  The design follows K2's
// (csrc/bvh_traverse.cu):
//   1. persistent warps with refill: a grid of the blocks the SMs hold at
//      once; a warp whose idle lanes reach kRefillMin (or all 32) takes
//      that many consecutive rays from a device counter, and rays with no
//      node (they miss the world box) are written at once.  The counters
//      live in a workspace the host zeroes once; the last block to finish
//      zeroes them again;
//   2. a step's leaf tests pooled over the warp: the lanes on an active
//      leaf count their tests, and every lane takes the next 32 of the
//      warp's pool.  K2's materialised list does not fit here (32 lanes x
//      115 tests is 14.7 KB a warp), so a pooled index q maps to its owner
//      lane by a binary search over the warp's 32 inclusive prefix sums
//      (five shuffles) and to k = q - the owner's exclusive sum; the
//      owner's ray comes by shuffles too.  Each ray's best is one 64-bit
//      key (bits of t') << 32 | k, reduced by a shared-memory atomicMin:
//      ties go to the first in leaf order, and the winning test writes
//      its prim and barycentrics;
//   3. the (node, tmin, tmax) stack: each thread keeps its top kShort
//      entries in shared memory ([entry][thread], no bank conflicts), as
//      a ring that spills its oldest entries to a per-thread global region
//      only past kShort (the tree's depth bounds the stack: 30 levels on
//      atrium);
//   4. fewer dependent loads a step: a node's split is loaded with its
//      meta and offset, not after them, and a test reads its triangle
//      from kd_tris, the triangles in leaf order (kd_tris[i] is triangle
//      kd_prims[i], its prim id in column 9: ops/kdtree.py::kd_tris_np),
//      so it follows no index and a leaf's rows are contiguous.  And a
//      step's next node does not wait for its leaf's tests: a leaf pops,
//      and an interior node picks its child, from the node alone (the
//      tests change t, which the next node's early out reads then), so
//      the next node's loads are issued first and are in flight while
//      the warp tests the triangles.
//
// Built with --fmad=false so each product and sum rounds as in the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "moller.cuh"

namespace {

constexpr int kThreads = 256;    // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;    // blocks an SM: caps registers at 85
constexpr int kStack = 48;       // STACK_DEPTH of ops/kdtree.py
constexpr int kShort = 8;        // stack entries a thread keeps in shared memory
constexpr int kRefillMin = 8;    // idle lanes that make a warp fetch rays
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoHit = ~0ull;

static_assert((kShort & (kShort - 1)) == 0, "kShort must be a power of two");

// Per warp, in shared memory: per lane, its best (t', k) of the step as one
// key, and the winning test's prim and barycentrics.
struct WarpBest {
  unsigned long long key[32];
  int prim[32];
  float2 uv[32];
};

// A stack entry in shared memory: the node, and tmin, tmax as bits.
constexpr size_t smem_bytes() {
  return (sizeof(int) + sizeof(float2)) * kShort * kThreads +
         sizeof(WarpBest) * kWarps;
}

__device__ __forceinline__ float inv_dir(float x) {
  return fabsf(x) > 1e-12f ? 1.0f / (x == 0.f ? 1.0f : x)
                           : (x >= 0.f ? 1e30f : -1e30f);
}

__device__ __forceinline__ float pick(int axis, float x, float y, float z) {
  return axis == 0 ? x : (axis == 1 ? y : z);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
kd_traverse_kernel(const float* __restrict__ split,
                   const int* __restrict__ meta, const int* __restrict__ offset,
                   const float4* __restrict__ kd_tris, int n_prims,
                   const float* __restrict__ bounds,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max, float* __restrict__ t_out,
                   int* __restrict__ prim_out, float* __restrict__ b1_out,
                   float* __restrict__ b2_out, int n, int any_hit,
                   int* __restrict__ counters, int4* __restrict__ spill) {
  // counters[0]: the next ray to hand out; counters[1]: blocks finished.
  // Both are 0 at the launch, and the last block to finish zeroes them.
  int* next_ray = counters;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* ring_t = reinterpret_cast<float2*>(smem);
  int* ring_n = reinterpret_cast<int*>(ring_t + kShort * kThreads);
  WarpBest* bests = reinterpret_cast<WarpBest*>(ring_n + kShort * kThreads);

  const int lane = threadIdx.x & 31;
  WarpBest& wb = bests[threadIdx.x >> 5];
  // stack entry s: in shared memory at [(s % kShort) * kThreads] of my_ring_*
  // while it is among the top kShort, else at my_spill[s * stride]
  float2* my_ring_t = ring_t + threadIdx.x;
  int* my_ring_n = ring_n + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kThreads;
  int4* my_spill = spill + (size_t)blockIdx.x * kThreads + threadIdx.x;

  const float wlo_x = __ldg(bounds), wlo_y = __ldg(bounds + 1),
              wlo_z = __ldg(bounds + 2);
  const float whi_x = __ldg(bounds + 3), whi_y = __ldg(bounds + 4),
              whi_z = __ldg(bounds + 5);

  int ray = -1;            // this lane's ray, -1 when idle
  bool exhausted = false;  // warp-uniform: every ray has been handed out
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float ix = 0.f, iy = 0.f, iz = 0.f;
  float t = 0.f, b1 = 0.f, b2 = 0.f, smin = 0.f, smax = 0.f;
  int prim = -1, node = 0, sp = 0, spilled = 0;
  // the node's meta, offset and split, loaded a step ahead
  int node_m = 3, node_off = 0;
  float node_split = 0.f;

  while (true) {
    // ---- refill: the idle lanes take the next consecutive rays ----
    const unsigned idle = __ballot_sync(kFull, ray < 0);
    if (!exhausted && idle != 0u &&
        (__popc(idle) >= kRefillMin || idle == kFull)) {
      const int want = __popc(idle);
      int base = 0;
      if (lane == 0) base = atomicAdd(next_ray, want);
      base = __shfl_sync(kFull, base, 0);
      exhausted = base + want >= n;
      const int r = base + __popc(idle & ((1u << lane) - 1u));
      if (ray < 0 && r < n) {
        const float ax = o[3 * r], ay = o[3 * r + 1], az = o[3 * r + 2];
        const float bx = d[3 * r], by = d[3 * r + 1], bz = d[3 * r + 2];
        const float jx = inv_dir(bx), jy = inv_dir(by), jz = inv_dir(bz);
        const float tm = t_max[r];
        // the world bounds, in the plain version's order
        const float lx = (wlo_x - ax) * jx, hx = (whi_x - ax) * jx;
        const float ly = (wlo_y - ay) * jy, hy = (whi_y - ay) * jy;
        const float lz = (wlo_z - az) * jz, hz = (whi_z - az) * jz;
        const float tnear =
            fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
        const float tfar =
            fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
        const float lo = fmaxf(tnear, 0.f);
        const float hi = fminf(tfar * 1.0000004f, tm);
        if (lo <= hi) {
          ray = r;
          ox = ax; oy = ay; oz = az;
          dx = bx; dy = by; dz = bz;
          ix = jx; iy = jy; iz = jz;
          t = tm;
          prim = -1;
          b1 = 0.f;
          b2 = 0.f;
          smin = lo;
          smax = hi;
          node = 0;
          node_m = __ldg(meta);
          node_off = __ldg(offset);
          node_split = __ldg(split);
          sp = 0;
          spilled = 0;
        } else {  // the ray misses the world box
          t_out[r] = tm;
          prim_out[r] = -1;
          b1_out[r] = 0.f;
          b2_out[r] = 0.f;
        }
      }
    }
    if (__ballot_sync(kFull, ray >= 0) == 0u) {
      if (exhausted) break;
      continue;
    }

    // ---- the node: the next one is known before the leaf's tests ----
    const int m = node_m, off = node_off;
    const bool active = ray >= 0 && smin <= t;  // the early out
    const int axis = m & 3;
    const int count = (active && axis == 3) ? (m >> 2) : 0;
    int nxt = -1;
    if (ray >= 0) {
      if (active && axis != 3) {  // an interior node: the plane test
        const float o_ax = pick(axis, ox, oy, oz);
        const float i_ax = pick(axis, ix, iy, iz);
        const float d_ax = pick(axis, dx, dy, dz);
        const float tplane = (node_split - o_ax) * i_ax;
        const bool below_first =
            o_ax < node_split || (o_ax == node_split && d_ax <= 0.f);
        const int first = below_first ? node + 1 : off;
        const int second = below_first ? off : node + 1;
        const bool only_near = tplane > smax || tplane <= 0.f;
        const bool only_far = tplane < smin && !only_near;
        if (!only_near && !only_far) {
          if (sp == kStack) --sp;  // a full stack: the push overwrites its top
          if (sp - spilled == kShort) {  // the ring is full: spill its oldest
            const int slot = (spilled & (kShort - 1)) * kThreads;
            const float2 et = my_ring_t[slot];
            my_spill[(size_t)spilled * stride] =
                make_int4(my_ring_n[slot], __float_as_int(et.x),
                          __float_as_int(et.y), 0);
            ++spilled;
          }
          const int slot = (sp & (kShort - 1)) * kThreads;
          my_ring_n[slot] = second;
          my_ring_t[slot] = make_float2(tplane, smax);
          ++sp;
          smax = tplane;
        }
        nxt = only_far ? second : first;
      } else if (sp > 0) {  // a leaf, or a culled node: pop (a leaf's
        --sp;               // tests read neither smin nor smax)
        if (sp >= spilled) {
          const int slot = (sp & (kShort - 1)) * kThreads;
          nxt = my_ring_n[slot];
          const float2 et = my_ring_t[slot];
          smin = et.x;
          smax = et.y;
        } else {  // the ring is empty: the entry is in the spill region
          const int4 e = my_spill[(size_t)sp * stride];
          nxt = e.x;
          smin = __int_as_float(e.y);
          smax = __int_as_float(e.z);
          spilled = sp;
        }
      }
      if (nxt >= 0) {  // in flight while the leaf's triangles are tested
        node_m = __ldg(meta + nxt);
        node_off = __ldg(offset + nxt);
        node_split = __ldg(split + nxt);
      }
    }

    // ---- the active leaves' tests, pooled over the warp ----
    int incl = count;  // inclusive prefix sum over the lanes
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (total > 0) {
      const int excl = incl - count;
      __syncwarp();  // the last step's reads of wb are done
      if (count > 0) wb.key[lane] = kNoHit;
      __syncwarp();
      for (int g0 = 0; g0 < total; g0 += 32) {
        const int q = g0 + lane;
        // the owner: the first lane whose inclusive sum exceeds q
        int own = 0;
#pragma unroll
        for (int s = 16; s >= 1; s >>= 1) {
          const int v = __shfl_sync(kFull, incl, own + s - 1);
          if (v <= q) own += s;
        }
        own &= 31;
        const int k = q - __shfl_sync(kFull, excl, own);
        const int lo_off = __shfl_sync(kFull, off, own);
        const float rox = __shfl_sync(kFull, ox, own);
        const float roy = __shfl_sync(kFull, oy, own);
        const float roz = __shfl_sync(kFull, oz, own);
        const float rdx = __shfl_sync(kFull, dx, own);
        const float rdy = __shfl_sync(kFull, dy, own);
        const float rdz = __shfl_sync(kFull, dz, own);
        const float rt = __shfl_sync(kFull, t, own);
        bool pass = false;
        unsigned long long kk = 0;
        int pid = 0;
        float tt = 0.f, u = 0.f, v = 0.f;
        if (q < total) {
          int pidx = lo_off + k;
          pidx = pidx < 0 ? 0 : (pidx > n_prims - 1 ? n_prims - 1 : pidx);
          const Tri tri = load_tri_id(kd_tris, pidx, pid);
          // below the owner's t at the step's start
          pass = moller_tri(tri, rox, roy, roz, rdx, rdy, rdz, tt, u, v) &&
                 tt < rt;
          if (pass) {
            kk = ((unsigned long long)__float_as_uint(tt) << 32) |
                 (unsigned)k;
            atomicMin(&wb.key[own], kk);
          }
        }
        __syncwarp();
        if (pass && wb.key[own] == kk) {
          wb.prim[own] = pid;
          wb.uv[own] = make_float2(u, v);
        }
        __syncwarp();
      }
      if (count > 0 && wb.key[lane] != kNoHit) {
        t = __uint_as_float((unsigned)(wb.key[lane] >> 32));
        prim = wb.prim[lane];
        const float2 uv = wb.uv[lane];
        b1 = uv.x;
        b2 = uv.y;
      }
    }
    if (ray < 0) continue;

    if (any_hit && prim >= 0) nxt = -1;
    if (nxt < 0) {
      t_out[ray] = t;
      prim_out[ray] = prim;
      b1_out[ray] = b1;
      b2_out[ray] = b2;
      ray = -1;
    } else {
      node = nxt;
    }
  }
  // every warp of the block is past its last atomicAdd on next_ray
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(counters + 1, 1) == (int)gridDim.x - 1) {
      counters[0] = 0;
      counters[1] = 0;
    }
  }
}

int g_max_blocks[64];  // per device: resident blocks of the kernel, 0 unknown

// Resident blocks on the current device (the persistent grid), raising the
// kernel's shared-memory limit on first use; a negative cudaError on failure.
int max_blocks() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  int* cached = dev < 64 ? &g_max_blocks[dev] : nullptr;
  if (cached && *cached > 0) return *cached;
  err = cudaFuncSetAttribute(kd_traverse_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes());
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kd_traverse_kernel, kThreads, smem_bytes());
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm <= 0) return -(int)cudaErrorInvalidConfiguration;
  if (cached) *cached = per_sm * sms;
  return per_sm * sms;
}

}  // namespace

// The workspace the kernel needs on the current device, in int4 units:
// one for the two counters (which must be 0; the kernel leaves them 0),
// then the stack spill of every thread of the persistent grid.  A negative
// cudaError on failure.
extern "C" int kd_traverse_work_entries() {
  const int b = max_blocks();
  if (b <= 0) return b;
  return 1 + (kStack - kShort) * b * kThreads;
}

// Launches the persistent grid on `stream`; returns the launch's CUDA
// error.  kd_tris: the (n_prims, 12) triangles in leaf order; bounds: the
// (2, 3) world box; work: kd_traverse_work_entries() int4s, the first
// zeroed.
extern "C" int kd_traverse(const void* split, const void* meta,
                           const void* offset, const void* kd_tris,
                           int n_prims, const void* bounds, const void* o,
                           const void* d, const void* t_max, void* t_out,
                           void* prim_out, void* b1_out, void* b2_out, int n,
                           int any_hit, void* work, void* stream) {
  if (n <= 0) return 0;
  const int mb = max_blocks();
  if (mb <= 0) return -mb;
  const int want = (n + kThreads - 1) / kThreads;
  const int grid = want < mb ? want : mb;
  kd_traverse_kernel<<<grid, kThreads, smem_bytes(), (cudaStream_t)stream>>>(
      (const float*)split, (const int*)meta, (const int*)offset,
      (const float4*)kd_tris, n_prims, (const float*)bounds, (const float*)o,
      (const float*)d, (const float*)t_max, (float*)t_out, (int*)prim_out,
      (float*)b1_out, (float*)b2_out, n, any_hit, (int*)work,
      (int4*)work + 1);
  return (int)cudaGetLastError();
}
