// Fused cluster traversal kernel (K1) for Hopper: for each 64-ray group of
// coherence-sorted rays, the exact per-ray cull of every cluster box, the
// group's candidate list in (entry distance, cluster id) order, and the
// closest-hit or any-hit traversal of those candidates with an exact early
// break, all in one block.
//
// Replaces the TPU kernel pbrt_v3_iile_tpu/ops/clusters_pallas.py:143
// (_traverse_group_kernel, pallas_call at :365, wrapper
// intersect_clusters_fused) and absorbs the cull that fed it, the XLA
// per_ray_cull (pbrt_v3_iile_tpu/ops/clusters.py:287) with its candidate
// sort.  The contract is the reference's:
//   cull   per ray: inv = 1/d (IEEE) where |d| > 1e-12, else +-1e30;
//          per axis lo = (bmin - o) * inv, hi = (bmax - o) * inv,
//          tn = max(tn, min(lo, hi)), tf = min(tf, max(lo, hi)) from
//          tn = 0, tf = 3e38; tf *= 1.0000004;  a ray enters the box iff
//          tn <= tf && tf > 0 && tn <= t_max && t_max > 0;  the group
//          needs the cluster iff some ray enters it, at tnear = the least
//          max(tn, 0) of those rays.
//   order  candidates ascending by (tnear, cluster id), the stable sort's
//          order; n_cand > MAXC sends the whole group to the BVH kernel
//          (this kernel then reports t = t_max, prim = -1).
//   test   per cluster of <= 128 BVH-order triangles the packed (24,128)
//          f32 block holds per triangle a x b and b - a for its three edges
//          (rows 0..17), the plane normal n (18..20) and n . p0 (21).  With
//          r = [d, o x d, -o, 1]:  w_q = r[0:6] . feat[6q:6q+6],
//          s = w0 + w1 + w2, t = (r[6:10] . feat[18:22]) / s (exact
//          divide); a triangle counts when w0 w1, w1 w2, w0 w2 >= 0,
//          |s| > 1e-12, 1e-5 < t and (t, prim) is below the best so far
//          (t < t_max for the first hit; ties go to the smallest prim id).
//   break  after each candidate the block stops once every ray's best t
//          is <= the next candidate's tnear (any-hit: or it has a hit).
//
// Bound on the H100 (PERF.md, computed by chip_smoke.py): the 65,536-ray
// atrium bounce wave needs 1,024 x 64 x 1,104 slab tests (28 fp32 ops)
// and, for the candidates the exact break cannot skip, 64 Pluecker tests
// (50 ops) per triangle: ~6.7 G ops against ~15 MB of pack, rays and
// results, so it is bound by operations, at ~0.1 ms against the 67 TFLOP/s
// fp32 peak (which counts an FMA as two; --fmad=false issues every product
// and sum on its own, so half that rate is the reachable ceiling).  What
// the design does about the four causes that held the first version, with
// the cull outside it, at ~10% of the bound:
//   1. the cull and its tables lived in device memory, built by about a
//      hundred torch ops per wave: here the block culls the 1,104 boxes
//      against its 64 rays read from shared memory as broadcasts, appends
//      the hits to a shared list (warp ballot + one shared counter) and
//      ranks the list in place; nothing of size (groups, K) is written;
//   2. the load -> barrier -> compute chain of each candidate was exposed
//      (2 warps, registers -> shared copy): here 4 warps, and two stages
//      filled by cp.async, so the next candidate's 11 KB is in flight while
//      one is tested (deeper rings were no faster on the card);
//   3. every triangle paid the IEEE divide: here only triangles that pass
//      the sign test and |s| > 1e-12 divide (t is the same number);
//   4. 22 scalar shared loads per triangle: here two threads per ray each
//      take every other run of 4 triangles and read a row's 4 values with
//      one 16-byte load, then combine their bests with a shuffle.
//
// Built with --fmad=false so every product and sum rounds exactly as in
// the plain PyTorch version (ops/clusters_kernel.py) and the reference's
// interpret mode.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kGroup = 64;       // rays per group
constexpr int kThreads = 128;    // 4 warps: two threads per ray
constexpr int kC = 128;          // triangle slots per cluster
constexpr int kRows = 24;        // packed feature rows per cluster
constexpr int kLiveRows = 22;    // rows the test reads
constexpr int kStages = 2;       // feature ring depth
constexpr int kStageFloats = kLiveRows * kC;
constexpr float kBigT = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory: the ring, the group's rays for the cull, the
// unordered hit list and the ordered candidate list.
__host__ __device__ constexpr size_t smem_bytes(int maxc) {
  return sizeof(float) * kStages * kStageFloats + sizeof(float4) * 2 * kGroup +
         sizeof(int) * 6 * (size_t)maxc;
}

__device__ __forceinline__ void write_miss(const float* __restrict__ t_max,
                                           float* __restrict__ t_out,
                                           int* __restrict__ prim_out,
                                           size_t base, int tid) {
  if (tid < kGroup) {
    t_out[base + tid] = t_max[base + tid];
    prim_out[base + tid] = -1;
  }
}

__global__ void __launch_bounds__(kThreads)
cluster_traverse_kernel(const float* __restrict__ feat,
                        const float* __restrict__ aabb_min,
                        const float* __restrict__ aabb_max,
                        const int* __restrict__ tri_off,
                        const int* __restrict__ tri_cnt, int K,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ t_max,
                        float* __restrict__ t_out, int* __restrict__ prim_out,
                        int* __restrict__ ncand_out, int maxc, int any_hit) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float4* ray_o = reinterpret_cast<float4*>(ring + kStages * kStageFloats);
  float4* ray_i = ray_o + kGroup;
  float* list_tn = reinterpret_cast<float*>(ray_i + kGroup);
  int* list_id = reinterpret_cast<int*>(list_tn + maxc);
  float* cand_tn = reinterpret_cast<float*>(list_id + maxc);
  int* cand_id = reinterpret_cast<int*>(cand_tn + maxc);
  int* cand_off = cand_id + maxc;
  int* cand_cnt = cand_off + maxc;
  __shared__ int s_count;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t base = (size_t)g * kGroup;

  // ---- 1. the group's rays for the cull (o, 1/d, t_max or -3e38) ----
  bool live = false;
  if (tid == 0) s_count = 0;
  if (tid < kGroup) {
    const size_t r = base + tid;
    const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
    const float dd[3] = {d[3 * r], d[3 * r + 1], d[3 * r + 2]};
    float inv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      inv[a] = fabsf(dd[a]) > 1e-12f ? __frcp_rn(dd[a])
                                     : (dd[a] >= 0.f ? 1e30f : -1e30f);
    const float tm = t_max[r];
    live = tm > 0.f;
    ray_o[tid] = make_float4(ox, oy, oz, live ? tm : -kBigT);
    ray_i[tid] = make_float4(inv[0], inv[1], inv[2], 0.f);
  }
  if (__syncthreads_count(live) == 0) {  // a dead group needs no cluster
    write_miss(t_max, t_out, prim_out, base, tid);
    if (tid == 0) ncand_out[g] = 0;
    return;
  }

  // ---- 2. cull: thread k tests cluster k (mod 128) against all rays ----
  for (int k0 = 0; k0 < K; k0 += kThreads) {
    const int k = k0 + tid;
    bool need = false;
    float tnear = kBigT;
    if (k < K) {
      const float bl[3] = {aabb_min[3 * k], aabb_min[3 * k + 1],
                           aabb_min[3 * k + 2]};
      const float bh[3] = {aabb_max[3 * k], aabb_max[3 * k + 1],
                           aabb_max[3 * k + 2]};
#pragma unroll 4
      for (int r = 0; r < kGroup; ++r) {
        const float4 ro = ray_o[r];
        const float4 ri = ray_i[r];
        const float oa[3] = {ro.x, ro.y, ro.z};
        const float ia[3] = {ri.x, ri.y, ri.z};
        float tn = 0.f, tf = kBigT;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float lo = (bl[a] - oa[a]) * ia[a];
          const float hi = (bh[a] - oa[a]) * ia[a];
          tn = fmaxf(tn, fminf(lo, hi));
          tf = fminf(tf, fmaxf(lo, hi));
        }
        tf = tf * 1.0000004f;
        if (tn <= tf && tf > 0.f && tn <= ro.w) {
          need = true;
          tnear = fminf(tnear, fmaxf(tn, 0.f));
        }
      }
    }
    const unsigned hits = __ballot_sync(kFull, need);
    if (hits) {
      int wbase = 0;
      if (lane == 0) wbase = atomicAdd(&s_count, __popc(hits));
      wbase = __shfl_sync(kFull, wbase, 0);
      const int pos = wbase + __popc(hits & ((1u << lane) - 1u));
      if (need && pos < maxc) {
        list_tn[pos] = tnear;
        list_id[pos] = k;
      }
    }
  }
  __syncthreads();
  const int n_cand = s_count;
  if (tid == 0) ncand_out[g] = n_cand;
  if (n_cand > maxc) {  // the whole group goes to the BVH kernel
    write_miss(t_max, t_out, prim_out, base, tid);
    return;
  }
  const int n = n_cand;

  // ---- 3. order: rank by (tnear, cluster id), a total order ----
  for (int i = tid; i < n; i += kThreads) {
    const float ti = list_tn[i];
    const int ci = list_id[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float tj = list_tn[j];
      rank += (tj < ti || (tj == ti && list_id[j] < ci)) ? 1 : 0;
    }
    cand_tn[rank] = ti;
    cand_id[rank] = ci;
    cand_off[rank] = tri_off[ci];
    cand_cnt[rank] = tri_cnt[ci];
  }
  __syncthreads();

  // ---- 4. traverse: two threads per ray, a cp.async ring of features ----
  const int half = tid & 1;
  const size_t ray = base + (tid >> 1);
  float r[10];
  {
    const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
    const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
    r[0] = dx;
    r[1] = dy;
    r[2] = dz;
    r[3] = oy * dz - oz * dy;  // o x d, each product rounded
    r[4] = oz * dx - ox * dz;
    r[5] = ox * dy - oy * dx;
    r[6] = -ox;
    r[7] = -oy;
    r[8] = -oz;
    r[9] = 1.f;
  }
  const float tm = t_max[ray];
  float best = tm > 0.f ? tm : -kBigT;  // dead rays match nothing
  int bprim = -1;                       // -1: no hit yet (t == t_max loses)

  auto issue = [&](int i) {
    if (i < n) {
      const int nq = (cand_cnt[i] + 3) >> 2;  // 16-byte runs per row
      const float* src = feat + (size_t)cand_id[i] * (kRows * kC);
      float* dst = ring + (i % kStages) * kStageFloats;
      for (int idx = tid; idx < kLiveRows * nq; idx += kThreads) {
        const int row = idx / nq;
        const int q = idx - row * nq;
        cp_async::copy16(dst + row * kC + 4 * q, src + row * kC + 4 * q);
      }
    }
    cp_async::commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int i = 0; i < n; ++i) {
    issue(i + kStages - 1);
    cp_async::wait<kStages - 1>();
    __syncthreads();  // candidate i's rows are in shared memory
    const float* sf = ring + (i % kStages) * kStageFloats;
    const int cnt = cand_cnt[i];
    const int off = cand_off[i];
    const int nq = (cnt + 3) >> 2;
    for (int q = half; q < nq; q += 2) {
      const float* fq = sf + 4 * q;
      float4 w[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        float4 f = *reinterpret_cast<const float4*>(fq + (6 * e) * kC);
        float4 acc = make_float4(r[0] * f.x, r[0] * f.y, r[0] * f.z, r[0] * f.w);
#pragma unroll
        for (int c = 1; c < 6; ++c) {
          f = *reinterpret_cast<const float4*>(fq + (6 * e + c) * kC);
          acc.x = acc.x + r[c] * f.x;
          acc.y = acc.y + r[c] * f.y;
          acc.z = acc.z + r[c] * f.z;
          acc.w = acc.w + r[c] * f.w;
        }
        w[e] = acc;
      }
      float4 f = *reinterpret_cast<const float4*>(fq + 18 * kC);
      float4 num = make_float4(r[6] * f.x, r[6] * f.y, r[6] * f.z, r[6] * f.w);
#pragma unroll
      for (int c = 1; c < 4; ++c) {
        f = *reinterpret_cast<const float4*>(fq + (18 + c) * kC);
        num.x = num.x + r[6 + c] * f.x;
        num.y = num.y + r[6 + c] * f.y;
        num.z = num.z + r[6 + c] * f.z;
        num.w = num.w + r[6 + c] * f.w;
      }
      const float w0[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
      const float w1[4] = {w[1].x, w[1].y, w[1].z, w[1].w};
      const float w2[4] = {w[2].x, w[2].y, w[2].z, w[2].w};
      const float nm[4] = {num.x, num.y, num.z, num.w};
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int j = 4 * q + l;
        const float s = w0[l] + w1[l] + w2[l];
        const bool same = (w0[l] * w1[l] >= 0.f) && (w1[l] * w2[l] >= 0.f) &&
                          (w0[l] * w2[l] >= 0.f);
        if (same && fabsf(s) > 1e-12f && j < cnt) {
          const float t = __fdiv_rn(nm[l], s);
          const int pid = off + j;
          if (t > 1e-5f && (t < best || (t == best && pid < bprim))) {
            best = t;
            bprim = pid;
          }
        }
      }
    }
    // the two halves of a ray agree on its best (t, prim)
    const float ob = __shfl_xor_sync(kFull, best, 1);
    const int op = __shfl_xor_sync(kFull, bprim, 1);
    if (ob < best || (ob == best && op < bprim)) {
      best = ob;
      bprim = op;
    }
    const float nxt = i + 1 < n ? cand_tn[i + 1] : kBigT;
    bool fin = best <= nxt;
    if (any_hit) fin = fin || best < tm;
    if (__syncthreads_and(fin)) break;  // also frees stage i for reuse
  }
  cp_async::wait_all();  // no copy may land after the block exits

  if (half == 0) {
    const bool hit = bprim >= 0;
    t_out[ray] = hit ? best : tm;
    prim_out[ray] = hit ? bprim : -1;
  }
}

}  // namespace

// Launches one 128-thread block per 64-ray group on `stream`; returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
extern "C" int cluster_traverse(const void* feat, const void* aabb_min,
                                const void* aabb_max, const void* tri_off,
                                const void* tri_cnt, int n_clusters,
                                const void* o, const void* d,
                                const void* t_max, void* t_out,
                                void* prim_out, void* ncand_out, int n_groups,
                                int maxc, int any_hit, void* stream) {
  if (n_groups <= 0) return 0;
  const size_t smem = smem_bytes(maxc);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_traverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cluster_traverse_kernel<<<n_groups, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)aabb_min, (const float*)aabb_max,
      (const int*)tri_off, (const int*)tri_cnt, n_clusters, (const float*)o,
      (const float*)d, (const float*)t_max, (float*)t_out, (int*)prim_out,
      (int*)ncand_out, maxc, any_hit);
  return (int)cudaGetLastError();
}
