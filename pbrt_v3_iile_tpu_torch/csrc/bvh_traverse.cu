// BVH traversal kernel (K2) for Hopper: closest-hit or any-hit of each ray
// against the triangle BVH, walked as a 4-wide BVH.
//
// Replaces the TPU packet kernel pbrt_v3_iile_tpu/ops/intersect_pallas.py:171
// (_traverse_kernel + _traverse_packet, pallas_call at :301, wrapper
// intersect_bvh_pallas), which walks 1024-ray packets with one shared
// scalar stack because the TPU has no vector gather.  The contract is the
// reference walker's (pbrt_v3_iile_tpu/ops/intersect.py::intersect_bvh):
// slab tests against [0, t] with tfar *= 1.0000004, up to 4 triangles a
// leaf, Moller-Trumbore with a 1e-12 determinant threshold, an exact
// divide and 0 < t' < t, BVH-order prim ids.  The order is the 4-wide one
// of ops/intersect_kernel.py (its module docstring; its plain version
// bvh_traverse_wide_plain does the same rounded operations, so the two
// agree bit for bit):
//   step   test the 4 child boxes of one wide node against [0, t]; test the
//          triangles of the hit leaf children; of the hit inner children
//          with tnear < t, take the nearest by (tnear, slot) next and push
//          the others far first, each with its tnear;
//   pop    with no child to take, pop until an entry's tnear is below t;
//   best   the least (t, prim): an exact tie in t goes to the smaller prim
//          id, so the order of a step's triangle tests does not matter;
//   any    any-hit stops after the first step that finds a hit.
//
// Bound on the H100 (PERF.md, chip_smoke.py): on the 65,536-ray atrium
// bounce wave the binary walker's work is ~2.2 M node visits (26 ops) and
// ~0.15 M triangle tests (53 ops), 0.065 G ops, against 10.7 MB of BVH,
// triangles and rays: bound by bytes, at ~3.2 us.  What holds a traversal
// far from that is the chain of dependent steps of the slowest rays of
// each warp.  What the design does about the four causes that held the
// first version (one thread a ray over the binary nodes, kept as
// tools/bvh_traverse_binary.cu to time against):
//   1. too few warps to hide the latency, and a warp's steps made long by
//      its lanes' serial triangle tests (up to 16 a step, one dependent
//      L2 round trip each, while the other lanes idled): here each step's
//      triangle tests are spread over the whole warp (each lane lists its
//      tests in shared memory and every lane takes the next 32 of the
//      warp's list); each ray's best (t, prim) is one 64-bit key, reduced
//      by a shared-memory atomicMin, so a step costs one round of loads
//      for all its triangles;
//   2. binary nodes: here a node is one 128-byte line of 4 child boxes
//      (SoA) and the 4 children (inner index, or a leaf's first prim and
//      count), collapsed on the host (build_bvh4_np) with the binary boxes
//      bit for bit; a ray makes about a quarter of the binary walker's
//      node visits;
//   3. the 64-deep stack lived in local memory and a popped node was
//      fetched again only to be culled: here each entry carries its tnear
//      and is dropped at the pop without a fetch, and each thread keeps
//      its top kShort entries in shared memory ([entry][thread], no bank
//      conflicts whatever the depths), as a ring that spills its oldest
//      entries to a per-thread global region only past kShort (the build
//      bounds the depth: 30 on atrium, 13 seen);
//   4. a warp ran until its longest ray ended, with no work for the lanes
//      whose rays were done: here the grid is persistent (the blocks the
//      SMs hold at once) and a warp whose idle lanes reach kRefillMin (or
//      all 32) takes that many consecutive rays from a device counter, so
//      lanes are refilled until the wave is exhausted; rays with
//      t_max <= 0 are written as misses at once (they can hit nothing).
//      The two counters live in a workspace the host zeroes once; the
//      last block to finish zeroes them again, so a launch costs the host
//      no memset.
// The top of the tree is NOT kept in shared memory: tools/k2_variants.py
// times this kernel against variants made from this source (the first 64
// or 256 wide nodes copied to shared memory with cp.async, an 8-wide BVH,
// other refill thresholds, a grid of half the resident blocks) and
// against the binary kernel it replaced; PERF.md has the readings.
//
// The motion variant (kMotion, the same kernel with a compile-time flag:
// the static kernel's code and arithmetic are unchanged) carries object
// motion blur, the reference's keyframe-lerping walker
// (pbrt_v3_iile_tpu/ops/intersect.py:56 with time, lerp at :111-124; an XLA
// while_loop, no pallas_call): each ray has a time in [0, 1], with
// tf = time*(M-1), seg = clip(int(tf), 0, M-2), tl = tf - seg.  Its first
// design walked K2's body over one BVH built around the union of all M
// sub-keyframes: on atrium_motion three shapes (26% of the triangles) turn
// or move, their boxes cover the whole sweep, the build around them
// degrades, and the 65,536-ray bounce wave made 28.6 triangle tests a ray
// (2.3 on the static atrium), each reading and lerping two rows, also for
// the 74% of triangles that never move: ~100x its bound.  Here the host
// (ops/intersect_kernel.py::build_motion_split_np) splits the triangles:
//   static  every sub-keyframe row bit-equal: one 4-wide BVH from node 0
//           over them, whose leaves index a (S, 12) table read as the
//           static kernel reads tris (no lerp);
//   moving  per keyframe segment s, a 4-wide BVH from roots[s] over the
//           moving triangles boxed over keyframes s and s+1 (padded for
//           the lerp's rounding), whose leaves index segment s's part of
//           a (M-1, V, 24) table: the two keyframe rows of a triangle
//           side by side, 96 contiguous bytes, lerped r0 + tl (r1 - r0).
// Column 9 of each row holds the triangle's prim id in the scene's BVH
// order (int bits), so the result and the (t, prim) key rule are the
// static kernel's.  A ray walks the static BVH, then (unless any-hit
// found a hit) the moving BVH of its segment, bounded by the (t, prim)
// the first walk left; the least (t, prim) over both is the union walk's
// result.  Persistent warps, refill, the warp-spread tests and the stack
// ring are the static kernel's; a lane's walk is in the warp's shared
// seg[] (-1 on the static BVH), so one step may mix lanes of both walks.
// The plain version is bvh_traverse_motion_plain, in this order.  Its
// bound on the H100 (chip_smoke.py phase 8) is the bytes of these tables
// (23.9 MB on atrium_motion) and of the rays, ~8 us; the first design's
// ~100x was by the union BVH's yardstick (39.2 MB, ~12 us).
//
// Built with --fmad=false so each product and sum rounds as in the plain
// PyTorch versions.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "moller.cuh"

namespace {

constexpr int kWidth = 4;        // children per wide node (WIDTH of the host)
constexpr int kThreads = 256;    // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;    // blocks an SM: caps registers at 85
constexpr int kShort = 16;       // stack entries a thread keeps in shared memory
constexpr int kNodeF4 = 2 * kWidth;       // float4 per wide node (32 W bytes)
constexpr int kLoadF4 = 7 * kWidth / 4;   // of which boxes and children
constexpr int kTests = 32 * 4 * kWidth;   // triangle tests a warp step holds
                                          // (build_bvh4_np caps a leaf at 4)
constexpr int kRefillMin = 8;    // idle lanes that make a warp fetch rays
constexpr unsigned kFull = 0xffffffffu;

// Per warp, in shared memory: the step's triangle tests and, per lane, its
// ray, its best (t, prim) as one key and the barycentrics of that best.
struct WarpTests {
  int list[kTests];                 // (prim << 5) | owner lane
  unsigned long long key[32];       // (bits of t) << 32 | prim: the order
  float4 ray_o[32];                 // o, t at the step's start
  float4 ray_d[32];                 // d, prim at the step's start (bits)
  float2 uv[32];
};
// ... and in the motion variant each lane's keyframe segment (-1 while it
// walks the static BVH) and lerp parameter
struct WarpTestsMotion : WarpTests {
  int seg[32];
  float tl[32];
};
template <bool kMotion>
using WarpTestsT =
    typename std::conditional<kMotion, WarpTestsMotion, WarpTests>::type;

template <bool kMotion>
constexpr size_t smem_bytes() {
  return sizeof(int2) * kShort * kThreads + sizeof(WarpTestsT<kMotion>) * kWarps;
}

static_assert((kShort & (kShort - 1)) == 0, "kShort must be a power of two");

// Component c of v, for a c known at compile time.
__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// (t, prim) as one 64-bit key whose unsigned order is (t, prim)'s for t > 0.
__device__ __forceinline__ unsigned long long hit_key(float t, int prim) {
  return ((unsigned long long)__float_as_uint(t) << 32) | (unsigned)prim;
}

// Moving triangle pid of segment seg, lerp parameter tl, of the (M-1, V,
// 24) table (its rows at keyframes seg and seg+1): r0 + tl * (r1 - r0) per
// float, as the plain version; its prim id in id.
__device__ __forceinline__ Tri lerp_tri(const float4* __restrict__ moving,
                                        int n_moving, int seg, float tl,
                                        int pid, int& id) {
  const int row = 2 * (seg * n_moving + pid);
  const Tri a = load_tri_id(moving, row, id);
  const Tri b = load_tri(moving, row + 1);
  return Tri{a.p0x + tl * (b.p0x - a.p0x), a.p0y + tl * (b.p0y - a.p0y),
             a.p0z + tl * (b.p0z - a.p0z), a.e1x + tl * (b.e1x - a.e1x),
             a.e1y + tl * (b.e1y - a.e1y), a.e1z + tl * (b.e1z - a.e1z),
             a.e2x + tl * (b.e2x - a.e2x), a.e2y + tl * (b.e2y - a.e2y),
             a.e2z + tl * (b.e2z - a.e2z)};
}

// tris: the (T, 12) table, or in the motion variant the static triangles
// (S, 12) with the moving ones (M-1, V, 24), each segment's root, time
// (N,), n_steps = M and n_moving = V.
template <bool kMotion>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bvh4_traverse_kernel(const float4* __restrict__ wide,
                     const float4* __restrict__ tris,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ b1_out, float* __restrict__ b2_out,
                     int n, int any_hit, int* __restrict__ counters,
                     int2* __restrict__ spill, const float* __restrict__ time,
                     const float4* __restrict__ moving,
                     const int* __restrict__ roots, int n_steps,
                     int n_moving) {
  // counters[0]: the next ray to hand out; counters[1]: blocks finished.
  // Both are 0 at the launch, and the last block to finish zeroes them.
  int* next_ray = counters;
  extern __shared__ __align__(16) unsigned char smem[];
  int2* ring = reinterpret_cast<int2*>(smem);
  WarpTestsT<kMotion>* tests =
      reinterpret_cast<WarpTestsT<kMotion>*>(ring + kShort * kThreads);

  const int lane = threadIdx.x & 31;
  WarpTestsT<kMotion>& wt = tests[threadIdx.x >> 5];
  // stack entry s: in shared memory at my_ring[(s % kShort) * kThreads]
  // while it is among the top kShort, else at my_spill[s * stride]
  int2* my_ring = ring + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kThreads;
  int2* my_spill = spill + (size_t)blockIdx.x * kThreads + threadIdx.x;

  int ray = -1;            // this lane's ray, -1 when idle
  bool exhausted = false;  // warp-uniform: every ray has been handed out
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float ix = 0.f, iy = 0.f, iz = 0.f;
  float t = 0.f, b1 = 0.f, b2 = 0.f;
  int prim = -1, node = 0, sp = 0, spilled = 0;
  int seg = 0;       // motion: the ray's keyframe segment
  float tl = 0.f;    // ... and lerp parameter
  bool on_static = false;  // motion: the lane walks the static BVH

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
        const float tm = t_max[r];
        if (tm > 0.f) {
          ray = r;
          ox = o[3 * r];
          oy = o[3 * r + 1];
          oz = o[3 * r + 2];
          dx = d[3 * r];
          dy = d[3 * r + 1];
          dz = d[3 * r + 2];
          ix = fabsf(dx) > 1e-12f ? 1.0f / dx : (dx >= 0.f ? 1e30f : -1e30f);
          iy = fabsf(dy) > 1e-12f ? 1.0f / dy : (dy >= 0.f ? 1e30f : -1e30f);
          iz = fabsf(dz) > 1e-12f ? 1.0f / dz : (dz >= 0.f ? 1e30f : -1e30f);
          t = tm;
          prim = -1;
          b1 = 0.f;
          b2 = 0.f;
          node = 0;
          sp = 0;
          spilled = 0;
          if (kMotion) {
            const float tf = time[r] * (float)(n_steps - 1);
            seg = (int)tf;
            seg = seg < 0 ? 0 : (seg > n_steps - 2 ? n_steps - 2 : seg);
            tl = tf - (float)seg;
            on_static = true;
          }
        } else {  // 0 < t' < t_max is impossible: a miss
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

    // ---- one wide node: the child boxes against [0, t] ----
    float tn[kWidth];
    bool hit[kWidth];
    int child[kWidth];
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      tn[k] = 0.f;
      hit[k] = false;
      child[k] = -1;
    }
    int n_tri = 0;
    if (ray >= 0) {
      // float f of the node: comp(q[f / 4], f % 4); block a of kWidth
      // floats is min x, y, z, max x, y, z, then the children
      float4 q[kLoadF4];
      const float4* p = wide + (size_t)node * kNodeF4;
#pragma unroll
      for (int i = 0; i < kLoadF4; ++i) q[i] = __ldg(p + i);
#define NODE_F(a, k) comp(q[((a) * kWidth + (k)) >> 2], ((a) * kWidth + (k)) & 3)
#pragma unroll
      for (int k = 0; k < kWidth; ++k) child[k] = __float_as_int(NODE_F(6, k));
#pragma unroll
      for (int k = 0; k < kWidth; ++k) {
        const float tlo_x = (NODE_F(0, k) - ox) * ix;
        const float tlo_y = (NODE_F(1, k) - oy) * iy;
        const float tlo_z = (NODE_F(2, k) - oz) * iz;
        const float thi_x = (NODE_F(3, k) - ox) * ix;
        const float thi_y = (NODE_F(4, k) - oy) * iy;
        const float thi_z = (NODE_F(5, k) - oz) * iz;
        const float tnear =
            fmaxf(fmaxf(fminf(tlo_x, thi_x), fminf(tlo_y, thi_y)),
                  fminf(tlo_z, thi_z));
        float tfar = fminf(fminf(fmaxf(tlo_x, thi_x), fmaxf(tlo_y, thi_y)),
                           fmaxf(tlo_z, thi_z));
        tfar = tfar * 1.0000004f;
        tn[k] = tnear;
        hit[k] = (tnear <= tfar) && (tnear < t) && (tfar > 0.f);
        if (hit[k] && child[k] < 0) n_tri += (~child[k]) & 7;
      }
#undef NODE_F
    }

    // ---- the hit leaf children's triangles, spread over the warp: each
    // lane lists its tests, every lane takes the next 32 of the warp's
    // list, and the best (t, prim) of each ray is a shared atomicMin ----
    int off = n_tri;  // inclusive prefix sum over the lanes
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(kFull, off, s);
      if (lane >= s) off += v;
    }
    const int total = __shfl_sync(kFull, off, 31);
    if (total > 0) {
      off -= n_tri;
      __syncwarp();  // the last step's reads of wt are done
      const unsigned long long key0 = hit_key(t, prim);
      if (n_tri > 0) {
        wt.ray_o[lane] = make_float4(ox, oy, oz, t);
        wt.ray_d[lane] = make_float4(dx, dy, dz, __int_as_float(prim));
        wt.key[lane] = key0;
        if constexpr (kMotion) {
          wt.seg[lane] = on_static ? -1 : seg;
          wt.tl[lane] = tl;
        }
#pragma unroll
        for (int k = 0; k < kWidth; ++k) {
          if (hit[k] && child[k] < 0) {
            const int code = ~child[k];
            const int first = code >> 3;
            for (int j = 0; j < (code & 7); ++j)
              wt.list[off++] = ((first + j) << 5) | lane;
          }
        }
      }
      __syncwarp();
      for (int g0 = 0; g0 < total; g0 += 32) {
        bool pass = false;
        unsigned long long kk = 0;
        int own = 0;
        float tt = 0.f, u = 0.f, v = 0.f;
        if (g0 + lane < total) {
          const int e = wt.list[g0 + lane];
          const int pid = e >> 5;
          own = e & 31;
          const float4 ro = wt.ray_o[own];
          const float4 rd = wt.ray_d[own];
          Tri tri;
          int id = pid;  // the prim id of the key
          if constexpr (kMotion) {
            const int sg = wt.seg[own];
            if (sg < 0)
              tri = load_tri_id(tris, pid, id);
            else
              tri = lerp_tri(moving, n_moving, sg, wt.tl[own], pid, id);
          } else {
            tri = load_tri(tris, pid);
          }
          // below the owner's (t, prim) at the step's start: a lower key
          pass = moller_tri(tri, ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, tt, u,
                            v) &&
                 (tt < ro.w || (tt == ro.w && id < __float_as_int(rd.w)));
          if (pass) {
            kk = hit_key(tt, id);
            atomicMin(&wt.key[own], kk);
          }
        }
        __syncwarp();
        if (pass && wt.key[own] == kk) wt.uv[own] = make_float2(u, v);
        __syncwarp();
      }
      if (n_tri > 0) {
        const unsigned long long kk = wt.key[lane];
        if (kk != key0) {
          t = __uint_as_float((unsigned)(kk >> 32));
          prim = (int)(unsigned)(kk & 0xffffffffu);
          const float2 uv = wt.uv[lane];
          b1 = uv.x;
          b2 = uv.y;
        }
      }
    }
    if (ray < 0) continue;

    bool done = any_hit && prim >= 0;
    if (!done) {
      // the hit inner children nearer than t, ranked by (tnear, slot)
      bool in[kWidth];
#pragma unroll
      for (int k = 0; k < kWidth; ++k)
        in[k] = hit[k] && child[k] >= 0 && tn[k] < t;
      int rank[kWidth];
#pragma unroll
      for (int k = 0; k < kWidth; ++k) {
        rank[k] = 0;
#pragma unroll
        for (int j = 0; j < kWidth; ++j)
          rank[k] += (j != k && in[j] &&
                      (tn[j] < tn[k] || (tn[j] == tn[k] && j < k)))
                         ? 1
                         : 0;
      }
      int next = -1;
#pragma unroll
      for (int r = kWidth - 1; r >= 1; --r) {  // push far first
#pragma unroll
        for (int k = 0; k < kWidth; ++k) {
          if (in[k] && rank[k] == r) {
            if (sp - spilled == kShort) {  // the ring is full: spill its oldest
              my_spill[(size_t)spilled * stride] =
                  my_ring[(spilled & (kShort - 1)) * kThreads];
              ++spilled;
            }
            my_ring[(sp & (kShort - 1)) * kThreads] =
                make_int2(child[k], __float_as_int(tn[k]));
            ++sp;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kWidth; ++k)
        if (in[k] && rank[k] == 0) next = child[k];
      while (next < 0 && sp > 0) {  // pop; drop entries not nearer than t
        --sp;
        int2 e;
        if (sp >= spilled) {
          e = my_ring[(sp & (kShort - 1)) * kThreads];
        } else {  // the ring is empty: the entry is in the spill region
          e = my_spill[(size_t)sp * stride];
          spilled = sp;
        }
        if (__int_as_float(e.y) < t) next = e.x;
      }
      if (next < 0) {
        if (kMotion && on_static) {  // the static BVH is done (its stack
          on_static = false;         // is empty): the segment's moving one
          node = __ldg(roots + seg);
        } else {
          done = true;
        }
      } else {
        node = next;
      }
    }
    if (done) {
      t_out[ray] = t;
      prim_out[ray] = prim;
      b1_out[ray] = b1;
      b2_out[ray] = b2;
      ray = -1;
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

int g_max_blocks[2][64];  // per variant and device: resident blocks of the
                          // kernel, 0 unknown

// Resident blocks on the current device (the persistent grid), raising the
// kernel's shared-memory limit on first use; a negative cudaError on failure.
template <bool kMotion>
int max_blocks() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  int* cached = dev < 64 ? &g_max_blocks[kMotion][dev] : nullptr;
  if (cached && *cached > 0) return *cached;
  err = cudaFuncSetAttribute(bvh4_traverse_kernel<kMotion>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<kMotion>());
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bvh4_traverse_kernel<kMotion>, kThreads, smem_bytes<kMotion>());
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm <= 0) return -(int)cudaErrorInvalidConfiguration;
  if (cached) *cached = per_sm * sms;
  return per_sm * sms;
}

template <bool kMotion>
int spill_entries(int depth) {
  const int b = max_blocks<kMotion>();
  if (b <= 0) return b;
  return depth > kShort ? (depth - kShort) * b * kThreads : 0;
}

template <bool kMotion>
int launch(const void* wide, const void* tris, const void* o, const void* d,
           const void* t_max, void* t_out, void* prim_out, void* b1_out,
           void* b2_out, int n, int any_hit, void* work, void* stream,
           const void* time, const void* moving, const void* roots,
           int n_steps, int n_moving) {
  if (n <= 0) return 0;
  const int mb = max_blocks<kMotion>();
  if (mb <= 0) return -mb;
  const int want = (n + kThreads - 1) / kThreads;
  const int grid = want < mb ? want : mb;
  bvh4_traverse_kernel<kMotion>
      <<<grid, kThreads, smem_bytes<kMotion>(), (cudaStream_t)stream>>>(
          (const float4*)wide, (const float4*)tris, (const float*)o,
          (const float*)d, (const float*)t_max, (float*)t_out, (int*)prim_out,
          (float*)b1_out, (float*)b2_out, n, any_hit, (int*)work,
          (int2*)work + 1, (const float*)time, (const float4*)moving,
          (const int*)roots, n_steps, n_moving);
  return (int)cudaGetLastError();
}

}  // namespace

// The spill entries (int2) that stacks of `depth` entries need on the
// current device: each thread of the persistent grid keeps kShort in
// shared memory and spills the rest.  A negative cudaError on failure.
extern "C" int bvh_traverse_spill_entries(int depth) {
  return spill_entries<false>(depth);
}

// ... for the motion variant's grid.
extern "C" int bvh_traverse_motion_spill_entries(int depth) {
  return spill_entries<true>(depth);
}

// Launches the persistent grid on `stream`.  work: two ints that are 0
// (the kernel leaves them 0), then bvh_traverse_spill_entries(depth)
// int2 entries.  Returns the launch's CUDA error.
extern "C" int bvh_traverse(const void* wide, const void* tris, const void* o,
                            const void* d, const void* t_max, void* t_out,
                            void* prim_out, void* b1_out, void* b2_out, int n,
                            int any_hit, void* work, void* stream) {
  return launch<false>(wide, tris, o, d, t_max, t_out, prim_out, b1_out,
                       b2_out, n, any_hit, work, stream, nullptr, nullptr,
                       nullptr, 0, 0);
}

// The motion variant on build_motion_split_np's tables: wide (its nodes:
// the static BVH from 0, segment s's from roots[s]), static_tris (S, 12),
// moving_tris (n_steps - 1, n_moving, 24), time (n,) in [0, 1]; the
// workspace as above, sized by bvh_traverse_motion_spill_entries.
extern "C" int bvh_traverse_motion(const void* wide, const void* roots,
                                   const void* static_tris,
                                   const void* moving_tris, const void* o,
                                   const void* d, const void* t_max,
                                   const void* time, void* t_out,
                                   void* prim_out, void* b1_out, void* b2_out,
                                   int n, int any_hit, int n_steps,
                                   int n_moving, void* work, void* stream) {
  return launch<true>(wide, static_tris, o, d, t_max, t_out, prim_out, b1_out,
                      b2_out, n, any_hit, work, stream, time, moving_tris,
                      roots, n_steps, n_moving);
}
