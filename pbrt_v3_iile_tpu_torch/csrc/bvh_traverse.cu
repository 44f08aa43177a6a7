// BVH traversal kernel (K2) for Hopper: closest-hit or any-hit of each ray
// against the whole triangle BVH in LinearBVHNode layout.
//
// Replaces the TPU packet kernel pbrt_v3_iile_tpu/ops/intersect_pallas.py
// (_traverse_kernel + _traverse_packet, launched by intersect_bvh_pallas),
// which walks 1024-ray packets with one shared scalar stack.  This kernel
// follows the per-ray semantics of the reference's XLA walker instead
// (pbrt_v3_iile_tpu/ops/intersect.py::intersect_bvh), which the CPU tests
// use: slab test against [0, t] with tfar *= 1.0000004, near child by the
// ray's own direction sign, a depth-64 stack whose push is clamped at the
// top slot, up to 4 triangles per leaf, Moller-Trumbore with a 1e-12
// determinant threshold, T_MIN = 0, and any-hit stopping at the first hit.
//
// Design: one thread per ray, the stack in local memory (L1-resident),
// nodes read as two 16-byte loads from nodes_packed (M,8) i32 (float
// bounds bit-cast back), triangles as three 16-byte loads from
// tris_packed (T,12) f32.  What bounds it on the H100: the dependent
// node-fetch latency of divergent rays (each step is one 32-byte node and
// at most four 48-byte triangles, far below both the FLOP and the HBM
// peaks; the 95k-node atrium BVH, 3 MB, and its 4.8 MB of triangles stay
// in the 50 MB L2).  This first version does nothing about that latency
// beyond keeping every read a coalesced-width vector load; ray
// reordering and wide (8-ary) nodes are later work.
//
// Built with --fmad=false so each product and sum rounds as in the
// reference walker.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStackDepth = 64;
constexpr int kMaxLeaf = 4;

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__global__ void bvh_traverse_kernel(const int4* __restrict__ nodes,
                                    const float4* __restrict__ tris,
                                    const float* __restrict__ o,
                                    const float* __restrict__ d,
                                    const float* __restrict__ t_max,
                                    float* __restrict__ t_out,
                                    int* __restrict__ prim_out,
                                    float* __restrict__ b1_out,
                                    float* __restrict__ b2_out,
                                    int n, int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float inv_x = fabsf(dx) > 1e-12f ? 1.0f / dx : (dx >= 0.f ? 1e30f : -1e30f);
  const float inv_y = fabsf(dy) > 1e-12f ? 1.0f / dy : (dy >= 0.f ? 1e30f : -1e30f);
  const float inv_z = fabsf(dz) > 1e-12f ? 1.0f / dz : (dz >= 0.f ? 1e30f : -1e30f);

  float t = t_max[i];
  int prim = -1;
  float b1 = 0.f, b2 = 0.f;
  int stack[kStackDepth];
  int sp = 0;
  int node = 0;

  while (node >= 0) {
    const int4 lo = nodes[2 * node];
    const int4 hi = nodes[2 * node + 1];
    const float tlo_x = (__int_as_float(lo.x) - ox) * inv_x;
    const float tlo_y = (__int_as_float(lo.y) - oy) * inv_y;
    const float tlo_z = (__int_as_float(lo.z) - oz) * inv_z;
    const float thi_x = (__int_as_float(lo.w) - ox) * inv_x;
    const float thi_y = (__int_as_float(hi.x) - oy) * inv_y;
    const float thi_z = (__int_as_float(hi.y) - oz) * inv_z;
    const int right = hi.z;
    const int count = hi.w >> 2;
    const int axis = hi.w & 3;
    const float tnear = fmaxf(fmaxf(fminf(tlo_x, thi_x), fminf(tlo_y, thi_y)),
                              fminf(tlo_z, thi_z));
    float tfar = fminf(fminf(fmaxf(tlo_x, thi_x), fmaxf(tlo_y, thi_y)),
                       fmaxf(tlo_z, thi_z));
    tfar = tfar * 1.0000004f;
    const bool box_hit = (tnear <= tfar) && (tnear < t) && (tfar > 0.f);

    if (box_hit && count > 0) {
      for (int k = 0; k < kMaxLeaf; ++k) {
        if (k >= count) break;
        const int pid = right + k;
        const float4 r0 = tris[3 * pid];
        const float4 r1 = tris[3 * pid + 1];
        const float4 r2 = tris[3 * pid + 2];
        const float p0x = r0.x, p0y = r0.y, p0z = r0.z;
        const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
        const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
        // pv = d x e2
        const float pvx = dy * e2z - dz * e2y;
        const float pvy = dz * e2x - dx * e2z;
        const float pvz = dx * e2y - dy * e2x;
        const float det = dot3(e1x, e1y, e1z, pvx, pvy, pvz);
        const bool det_ok = fabsf(det) > 1e-12f;
        const float inv = det_ok ? 1.0f / (det == 0.f ? 1.0f : det) : 0.f;
        const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
        const float u = dot3(tvx, tvy, tvz, pvx, pvy, pvz) * inv;
        // qv = tv x e1
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float v = dot3(dx, dy, dz, qvx, qvy, qvz) * inv;
        const float tt = dot3(e2x, e2y, e2z, qvx, qvy, qvz) * inv;
        if (det_ok && u >= 0.f && v >= 0.f && u + v <= 1.f && tt > 0.f &&
            tt < t) {
          t = tt;
          prim = pid;
          b1 = u;
          b2 = v;
        }
      }
    }

    int next;
    if (box_hit && count == 0) {
      const bool neg = (axis == 0 ? dx : (axis == 1 ? dy : dz)) < 0.f;
      const int first = node + 1;
      const int push_sp = sp < kStackDepth - 1 ? sp : kStackDepth - 1;
      stack[push_sp] = neg ? first : right;
      sp = push_sp + 1;
      next = neg ? right : first;
    } else if (sp > 0) {
      sp -= 1;
      next = stack[sp];
    } else {
      next = -1;
    }
    if (any_hit && prim >= 0) next = -1;
    node = next;
  }
  t_out[i] = t;
  prim_out[i] = prim;
  b1_out[i] = b1;
  b2_out[i] = b2;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int bvh_traverse(const void* nodes_packed, const void* tris_packed,
                            const void* o, const void* d, const void* t_max,
                            void* t_out, void* prim_out, void* b1_out,
                            void* b2_out, int n, int any_hit, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bvh_traverse_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int4*)nodes_packed, (const float4*)tris_packed, (const float*)o,
      (const float*)d, (const float*)t_max, (float*)t_out, (int*)prim_out,
      (float*)b1_out, (float*)b2_out, n, any_hit);
  return (int)cudaGetLastError();
}
