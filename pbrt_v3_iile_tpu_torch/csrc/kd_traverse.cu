// kd-tree traversal kernel (K3) for Hopper: closest-hit or any-hit of each
// ray against the scene's kd-tree, one thread a ray.
//
// Replaces the XLA walker pbrt_v3_iile_tpu/ops/kdtree.py:150 (intersect_kd,
// a lax.while_loop: the reference has no pallas_call for it).  The contract
// is that walker's, and the port's plain version ops/kdtree.py::
// intersect_kd_plain does the same rounded operations in the same order, so
// the two agree bit for bit (t, prim, barycentrics):
//   entry  clip the ray against the world bounds: tmin = max(0, slab near),
//          tmax = min(slab far * 1.0000004, t_max); no node when tmin > tmax;
//   step   a node whose tmin is not below the ray's t is culled (it pops);
//          a leaf tests its triangles through kd_prims in order
//          (Moller-Trumbore, 0 < t' < t, each hit lowering t) and pops; an
//          interior node computes tplane = (split - o) / d on its axis and
//          takes the near child only when tplane > tmax or tplane <= 0
//          (pbrt's ordered test), the far child only when tplane < tmin,
//          else the near child with tmax = tplane after pushing
//          (far, tplane, tmax);
//   pop    the top (node, tmin, tmax) entry, or the end of the walk;
//   any    any-hit ends the walk after the step that found a hit.
// The stack holds 48 entries (STACK_DEPTH of ops/kdtree.py); a push onto a
// full stack overwrites its top entry, as the walker's does.  Unlike the
// reference's walker, which tests only the first 8 triangles of a leaf,
// every triangle of a leaf is tested (ops/kdtree.py's docstring).
//
// Bound on the H100 (PERF.md, chip_smoke.py): the node visits (a 12-byte
// node, ~15 operations) and triangle tests (a 48-byte triangle, 53
// operations) that the run's rays make, against the bytes of the tree, the
// triangles and the rays.  A simple kernel: one thread walks one ray with
// its stack in local memory; what holds it from the bound is the chain of
// dependent node loads of the longest rays of each warp.
//
// Built with --fmad=false so each product and sum rounds as in the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "moller.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 48;     // STACK_DEPTH of ops/kdtree.py

__device__ __forceinline__ float inv_dir(float x) {
  return fabsf(x) > 1e-12f ? 1.0f / (x == 0.f ? 1.0f : x)
                           : (x >= 0.f ? 1e30f : -1e30f);
}

__global__ void __launch_bounds__(kThreads)
kd_traverse_kernel(const float* __restrict__ split,
                   const int* __restrict__ meta, const int* __restrict__ offset,
                   const int* __restrict__ prims, int n_prims,
                   const float* __restrict__ bounds,
                   const float4* __restrict__ tris,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max, float* __restrict__ t_out,
                   int* __restrict__ prim_out, float* __restrict__ b1_out,
                   float* __restrict__ b2_out, int n, int any_hit) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const float oc[3] = {o[3 * r], o[3 * r + 1], o[3 * r + 2]};
  const float dc[3] = {d[3 * r], d[3 * r + 1], d[3 * r + 2]};
  const float ic[3] = {inv_dir(dc[0]), inv_dir(dc[1]), inv_dir(dc[2])};
  float t = t_max[r];
  float b1 = 0.f, b2 = 0.f;
  int prim = -1;

  // the world bounds
  float tnear = -3.0e38f, tfar = 3.0e38f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float tlo = (__ldg(bounds + a) - oc[a]) * ic[a];
    const float thi = (__ldg(bounds + 3 + a) - oc[a]) * ic[a];
    tnear = a == 0 ? fminf(tlo, thi) : fmaxf(tnear, fminf(tlo, thi));
    tfar = a == 0 ? fmaxf(tlo, thi) : fminf(tfar, fmaxf(tlo, thi));
  }
  float smin = fmaxf(tnear, 0.f);
  float smax = fminf(tfar * 1.0000004f, t);
  int node = smin <= smax ? 0 : -1;

  int st_n[kStack];
  float st_lo[kStack], st_hi[kStack];
  int sp = 0;
  while (node >= 0) {
    const int m = __ldg(meta + node);
    const int axis = m & 3;
    const int off = __ldg(offset + node);
    const bool active = smin <= t;  // the early out
    bool interior = false;
    int nxt = -1;
    if (active && axis == 3) {
      const int count = m >> 2;
#pragma unroll 1
      for (int k = 0; k < count; ++k) {
        int pidx = off + k;
        pidx = pidx < 0 ? 0 : (pidx > n_prims - 1 ? n_prims - 1 : pidx);
        const int pid = __ldg(prims + pidx);
        float tt, u, v;
        if (moller_tri(load_tri(tris, pid), oc[0], oc[1], oc[2], dc[0], dc[1],
                       dc[2], tt, u, v) &&
            tt < t) {
          t = tt;
          prim = pid;
          b1 = u;
          b2 = v;
        }
      }
    } else if (active) {
      interior = true;
      const float sp_ = __ldg(split + node);
      const float o_ax = axis == 0 ? oc[0] : (axis == 1 ? oc[1] : oc[2]);
      const float i_ax = axis == 0 ? ic[0] : (axis == 1 ? ic[1] : ic[2]);
      const float d_ax = axis == 0 ? dc[0] : (axis == 1 ? dc[1] : dc[2]);
      const float tplane = (sp_ - o_ax) * i_ax;
      const bool below_first = o_ax < sp_ || (o_ax == sp_ && d_ax <= 0.f);
      const int first = below_first ? node + 1 : off;
      const int second = below_first ? off : node + 1;
      const bool only_near = tplane > smax || tplane <= 0.f;
      const bool only_far = tplane < smin && !only_near;
      if (!only_near && !only_far) {
        const int push = sp < kStack - 1 ? sp : kStack - 1;
        st_n[push] = second;
        st_lo[push] = tplane;
        st_hi[push] = smax;
        sp = push + 1;
        smax = tplane;
      }
      nxt = only_far ? second : first;
    }
    if (!interior && sp > 0) {  // a leaf, or a culled node: pop
      --sp;
      nxt = st_n[sp];
      smin = st_lo[sp];
      smax = st_hi[sp];
    }
    if (any_hit && prim >= 0) nxt = -1;
    node = nxt;
  }
  t_out[r] = t;
  prim_out[r] = prim;
  b1_out[r] = b1;
  b2_out[r] = b2;
}

}  // namespace

// Launches one thread a ray on `stream`; returns the launch's CUDA error.
// bounds: the (2, 3) world box; n_prims: the length of prims.
extern "C" int kd_traverse(const void* split, const void* meta,
                           const void* offset, const void* prims, int n_prims,
                           const void* bounds, const void* tris, const void* o,
                           const void* d, const void* t_max, void* t_out,
                           void* prim_out, void* b1_out, void* b2_out, int n,
                           int any_hit, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  kd_traverse_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)split, (const int*)meta, (const int*)offset,
      (const int*)prims, n_prims, (const float*)bounds, (const float4*)tris,
      (const float*)o, (const float*)d, (const float*)t_max, (float*)t_out,
      (int*)prim_out, (float*)b1_out, (float*)b2_out, n, any_hit);
  return (int)cudaGetLastError();
}
