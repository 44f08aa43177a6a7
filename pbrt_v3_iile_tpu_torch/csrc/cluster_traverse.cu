// Fused cluster traversal kernel (K1) for Hopper: closest-hit or any-hit of
// each ray of a 64-ray group against the group's candidate clusters, in
// entry-distance (tnear) order, with an exact early break.
//
// Replaces the TPU kernel pbrt_v3_iile_tpu/ops/clusters_pallas.py
// (_traverse_group_kernel, launched by _run_kernel from
// intersect_clusters_fused).  What it computes is kept; the TPU blocking
// (3-slot DMA ring of 4-cluster bundles, per-lane deferred best, Newton
// reciprocal) is not.  Per cluster of up to 128 BVH-order triangles the
// packed (24,128) f32 feature block holds, per triangle, a x b and b - a
// for its three edges (rows 0..17), the plane normal n (rows 18..20) and
// n . p0 (row 21).  For ray features r = [d, o x d, -o, 1]:
//   w_q = r[0:6] . feat[6q:6q+6]          (Pluecker edge sides)
//   s   = w0 + w1 + w2,  t = (r[6:10] . feat[18:22]) / s   (exact divide)
// and a triangle counts when the sides agree (pairwise products >= 0),
// |s| > 1e-12, 1e-5 < t < best and lane < cnt.  Ties at equal t go to the
// smallest prim id.  After each cluster the block stops once every ray's
// best t is <= the next candidate's tnear (any-hit: or the ray has a hit).
//
// Design: one block per group, one thread per ray; each candidate's 22
// live feature rows (11 KB) are copied into shared memory by the whole
// block with 16-byte loads, then every thread walks the cluster's cnt
// triangles reading the same triangle at the same moment (a shared-memory
// broadcast); the running best t and prim stay in registers; the
// early-break vote is __syncthreads_and.  What bounds it on the H100: per
// candidate 11 KB is read (from L2 for the 13.6 MB atrium pack) against
// about 25 FMA-equivalents x 128 triangles x 64 rays, i.e. ~36 flop/byte,
// so a group is latency bound on the load -> barrier -> compute chain with
// one 64-thread block per group; this version relies on several resident
// blocks per SM to overlap that chain (cp.async/TMA double buffering is
// later work).
//
// Built with --fmad=false so the side products and sums round exactly as
// in the reference's interpret mode and the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 64;      // rays per group (one thread each)
constexpr int kC = 128;         // triangle slots per cluster
constexpr int kRows = 24;       // packed feature rows per cluster
constexpr int kLiveRows = 22;   // rows the test reads
constexpr int kNoPrim = 1 << 30;

__global__ void __launch_bounds__(kGroup)
cluster_traverse_kernel(const float* __restrict__ feat,
                        const int* __restrict__ cand,
                        const int* __restrict__ cpk,
                        const float* __restrict__ ctn,
                        const int* __restrict__ ncand,
                        const float* __restrict__ rays,
                        const float* __restrict__ t_max,
                        float* __restrict__ t_out, int* __restrict__ prim_out,
                        int maxc, int any_hit) {
  __shared__ __align__(16) float sf[kLiveRows * kC];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int ray = g * kGroup + tid;
  const float* rp = rays + (size_t)ray * 16;
  float r[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) r[k] = rp[k];
  const float tm = t_max[ray];
  float best = tm > 0.f ? tm : -3.0e38f;  // dead rays match nothing
  int bprim = kNoPrim;

  const int n = ncand[g];
  const int* cg = cand + (size_t)g * maxc;
  const int* pg = cpk + (size_t)g * maxc;
  const float* tg = ctn + (size_t)g * maxc;
  for (int i = 0; i < n; ++i) {
    const int cid = cg[i];
    const int pk = pg[i];
    const int cnt = pk & 255;
    const int off = pk >> 8;
    __syncthreads();  // the previous cluster's reads are done
    const float4* src = reinterpret_cast<const float4*>(
        feat + (size_t)cid * (kRows * kC));
    float4* dst = reinterpret_cast<float4*>(sf);
    for (int k = tid; k < kLiveRows * kC / 4; k += kGroup) dst[k] = src[k];
    __syncthreads();

    for (int j = 0; j < cnt; ++j) {
      float w[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float* f = sf + (6 * q) * kC + j;
        float acc = r[0] * f[0];
        acc = acc + r[1] * f[kC];
        acc = acc + r[2] * f[2 * kC];
        acc = acc + r[3] * f[3 * kC];
        acc = acc + r[4] * f[4 * kC];
        acc = acc + r[5] * f[5 * kC];
        w[q] = acc;
      }
      const float* fp = sf + 18 * kC + j;
      float num = r[6] * fp[0];
      num = num + r[7] * fp[kC];
      num = num + r[8] * fp[2 * kC];
      num = num + r[9] * fp[3 * kC];
      const float s = w[0] + w[1] + w[2];
      const float s_safe = fabsf(s) > 1e-12f ? s : (s >= 0.f ? 1e-12f : -1e-12f);
      const float t = num / s_safe;
      const bool same = (w[0] * w[1] >= 0.f) && (w[1] * w[2] >= 0.f) &&
                        (w[0] * w[2] >= 0.f);
      const int pid = off + j;
      const bool closer = t < best || (t == best && bprim != kNoPrim && pid < bprim);
      if (same && fabsf(s) > 1e-12f && t > 1e-5f && closer) {
        best = t;
        bprim = pid;
      }
    }

    const float nxt = tg[i + 1 < maxc ? i + 1 : maxc - 1];
    bool fin = best <= nxt;
    if (any_hit) fin = fin || (best < tm);
    if (__syncthreads_and(fin)) break;
  }
  const bool hit = bprim != kNoPrim;
  t_out[ray] = hit ? best : tm;
  prim_out[ray] = hit ? bprim : -1;
}

}  // namespace

// Launches one block per group on `stream`; returns cudaGetLastError().
extern "C" int cluster_traverse(const void* feat, const void* cand,
                                const void* cpk, const void* ctn,
                                const void* ncand, const void* rays,
                                const void* t_max, void* t_out, void* prim_out,
                                int n_groups, int maxc, int any_hit,
                                void* stream) {
  if (n_groups <= 0) return 0;
  cluster_traverse_kernel<<<n_groups, kGroup, 0, (cudaStream_t)stream>>>(
      (const float*)feat, (const int*)cand, (const int*)cpk,
      (const float*)ctn, (const int*)ncand, (const float*)rays,
      (const float*)t_max, (float*)t_out, (int*)prim_out, maxc, any_hit);
  return (int)cudaGetLastError();
}
