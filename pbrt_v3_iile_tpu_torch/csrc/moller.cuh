// Moller-Trumbore triangle test shared by the traversal kernels: the plain
// versions' rounded operations in their order (ops/intersect.py::
// _moller_raw; the kernels are built with --fmad=false).
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// One triangle (p0, e1, e2) as nine floats.
struct Tri {
  float p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// Triangle pid of the packed (T, 12) table (p0, e1, e2, pad).
__device__ __forceinline__ Tri load_tri(const float4* __restrict__ tris,
                                        int pid) {
  const float4 r0 = __ldg(tris + 3 * pid);
  const float4 r1 = __ldg(tris + 3 * pid + 1);
  const float4 r2 = __ldg(tris + 3 * pid + 2);
  return Tri{r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x};
}

// Row pid of a table of 12-float rows (p0, e1, e2, id bits, pad) that
// carry their triangle's prim id in column 9: the triangle, and the id.
__device__ __forceinline__ Tri load_tri_id(const float4* __restrict__ rows,
                                           int pid, int& id) {
  const float4 r0 = __ldg(rows + 3 * pid);
  const float4 r1 = __ldg(rows + 3 * pid + 1);
  const float4 r2 = __ldg(rows + 3 * pid + 2);
  id = __float_as_int(r2.y);
  return Tri{r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x};
}

// True when the ray (o, d) meets the triangle at tt > 0, with (tt, u, v).
__device__ __forceinline__ bool moller_tri(const Tri& tr, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float& tt, float& u,
                                           float& v) {
  // pv = d x e2
  const float pvx = dy * tr.e2z - dz * tr.e2y;
  const float pvy = dz * tr.e2x - dx * tr.e2z;
  const float pvz = dx * tr.e2y - dy * tr.e2x;
  const float det = dot3(tr.e1x, tr.e1y, tr.e1z, pvx, pvy, pvz);
  const bool det_ok = fabsf(det) > 1e-12f;
  const float inv = det_ok ? 1.0f / (det == 0.f ? 1.0f : det) : 0.f;
  const float tvx = ox - tr.p0x, tvy = oy - tr.p0y, tvz = oz - tr.p0z;
  u = dot3(tvx, tvy, tvz, pvx, pvy, pvz) * inv;
  // qv = tv x e1
  const float qvx = tvy * tr.e1z - tvz * tr.e1y;
  const float qvy = tvz * tr.e1x - tvx * tr.e1z;
  const float qvz = tvx * tr.e1y - tvy * tr.e1x;
  v = dot3(dx, dy, dz, qvx, qvy, qvz) * inv;
  tt = dot3(tr.e2x, tr.e2y, tr.e2z, qvx, qvy, qvz) * inv;
  return det_ok && u >= 0.f && v >= 0.f && u + v <= 1.f && tt > 0.f;
}
