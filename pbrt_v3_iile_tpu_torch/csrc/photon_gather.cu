// SPPM photon gather, the range query (K4) for Hopper: for each visible
// point, the photons of the hashed photon map that lie within its radius.
//
// Replaces the range query of pbrt_v3_iile_tpu/integrators/sppm.py:212-276
// (_gather: a fori_loop of K_CAP steps in each of the <= 8 grid cells that a
// visible point's ball overlaps; the reference has no pallas_call for it).
// The photons arrive hashed into m buckets (m a power of two) and stably
// sorted by bucket (h_sorted, p_sorted).  One thread takes one visible
// point and walks the 8 cell offsets in the reference's (ox, oy, oz) order:
//   cell    cc = lo_c + (ox, oy, oz), in range when cc <= hi_c on every
//           axis and the point is valid; a cell whose bucket an earlier
//           in-range offset of the point already visited is skipped (two
//           neighbour cells can hash to one bucket);
//   bucket  h = |x*73856093 ^ y*19349663 ^ z*83492791| mod m, the products
//           wrapped in 32 bits (as XLA wraps int32) and the abs of the
//           two's-complement bits (abs(INT_MIN) = INT_MIN) masked by m - 1,
//           which is the reference's non-negative remainder for any h;
//   run     [lo, hi) of the bucket in h_sorted by binary search; the first
//           K_CAP photons of the run are taken (the sort is stable, so these
//           are the first deposited), the rest count as dropped;
//   test    d2 = (dx*dx + dy*dy) + dz*dz <= r2, rounded as the plain version
//           rounds it (built with --fmad=false).
// It writes slot o*K_CAP + k of the point's row of the slot table: the
// sorted index of the photon that passed, or -1; M, the number that passed;
// dropped, the photons beyond K_CAP in its in-range cells.  The BSDF
// evaluation of the pairs found stays in PyTorch (integrators/sppm.py).
//
// Bound on the H100 (PERF.md, chip_smoke.py): the bytes read (the points'
// cells, positions and radii, the sorted buckets and positions of the
// photons visited) and written (the slot table, N x 256 x 4 bytes, is the
// largest).  A simple kernel: one thread a point, its slot row written
// 4 bytes at a time, the binary searches and the photon loads served by L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCap = 32;       // K_CAP of integrators/sppm.py
constexpr int kOffsets = 8;

__device__ __forceinline__ int hash_cell(int x, int y, int z, int m) {
  const uint32_t h = ((uint32_t)x * 73856093u) ^ ((uint32_t)y * 19349663u) ^
                     ((uint32_t)z * 83492791u);
  const uint32_t a = (h & 0x80000000u) ? 0u - h : h;
  return (int)(a & (uint32_t)(m - 1));
}

// first index in [0, n) with v[i] >= key (upper: v[i] > key), else n
__device__ __forceinline__ int bound(const int* __restrict__ v, int n, int key,
                                     bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int x = __ldg(v + mid);
    if (upper ? (x <= key) : (x < key)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
photon_gather_kernel(const int* __restrict__ lo_c, const int* __restrict__ hi_c,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ vp_p, const float* __restrict__ r2,
                     const int* __restrict__ h_sorted,
                     const float* __restrict__ p_sorted, int n_photons, int m,
                     int* __restrict__ slots, float* __restrict__ count,
                     int* __restrict__ dropped, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int lx = lo_c[3 * i], ly = lo_c[3 * i + 1], lz = lo_c[3 * i + 2];
  const int hx = hi_c[3 * i], hy = hi_c[3 * i + 1], hz = hi_c[3 * i + 2];
  const bool ok = valid[i] != 0;
  const float px = vp_p[3 * i], py = vp_p[3 * i + 1], pz = vp_p[3 * i + 2];
  const float rr = r2[i];
  int seen_h[kOffsets];
  bool seen_in[kOffsets];
  int* row = slots + (size_t)i * (kOffsets * kCap);
  int found = 0, drop = 0;
#pragma unroll
  for (int o = 0; o < kOffsets; ++o) {
    const int cx = lx + (o >> 2), cy = ly + ((o >> 1) & 1), cz = lz + (o & 1);
    bool in_range = ok && cx <= hx && cy <= hy && cz <= hz;
    const int hc = hash_cell(cx, cy, cz, m);
#pragma unroll
    for (int q = 0; q < o; ++q) in_range = in_range && !(seen_in[q] && seen_h[q] == hc);
    seen_h[o] = hc;
    seen_in[o] = in_range;
    int lo = 0, hi = 0;
    if (in_range) {
      lo = bound(h_sorted, n_photons, hc, false);
      hi = bound(h_sorted, n_photons, hc, true);
      drop += hi - min(hi, lo + kCap);
    }
    const int hi_cap = min(hi, lo + kCap);
    for (int k = 0; k < kCap; ++k) {
      int slot = -1;
      const int j = lo + k;
      if (in_range && j < hi_cap) {
        const float dx = __ldg(p_sorted + 3 * j) - px;
        const float dy = __ldg(p_sorted + 3 * j + 1) - py;
        const float dz = __ldg(p_sorted + 3 * j + 2) - pz;
        const float d2 = (dx * dx + dy * dy) + dz * dz;
        if (d2 <= rr) {
          slot = j;
          ++found;
        }
      }
      row[o * kCap + k] = slot;
    }
  }
  count[i] = (float)found;
  dropped[i] = drop;
}

}  // namespace

extern "C" int photon_gather(const void* lo_c, const void* hi_c,
                             const void* valid, const void* vp_p,
                             const void* r2, const void* h_sorted,
                             const void* p_sorted, int n_photons, int m,
                             void* slots, void* count, void* dropped, int n,
                             void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  photon_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)lo_c, (const int*)hi_c, (const uint8_t*)valid,
      (const float*)vp_p, (const float*)r2, (const int*)h_sorted,
      (const float*)p_sorted, n_photons, m, (int*)slots, (float*)count,
      (int*)dropped, n);
  return (int)cudaGetLastError();
}
