// SPPM photon gather, the range query (K4) for Hopper: for each visible
// point, the photons of the hashed photon map that lie within its radius,
// as a compacted list of (point, photon) pairs.
//
// Replaces the range query of pbrt_v3_iile_tpu/integrators/sppm.py:212-276
// (_gather: a fori_loop of K_CAP steps in each of the <= 8 grid cells that a
// visible point's ball overlaps; the reference has no pallas_call for it).
// The photons arrive hashed into m buckets (m a power of two) and stably
// sorted by bucket (h_sorted, p_sorted; an invalid photon in the sentinel
// bucket m).  A visible point walks the 8 cell offsets in the reference's
// (ox, oy, oz) order:
//   cell    cc = lo_c + (ox, oy, oz), in range when cc <= hi_c on every
//           axis and the point is valid; a cell whose bucket an earlier
//           in-range offset of the point already visited is skipped (two
//           neighbour cells can hash to one bucket);
//   bucket  h = |x*73856093 ^ y*19349663 ^ z*83492791| mod m, the products
//           wrapped in 32 bits (as XLA wraps int32) and the abs of the
//           two's-complement bits (abs(INT_MIN) = INT_MIN) masked by m - 1,
//           which is the reference's non-negative remainder for any h;
//   run     [start[h], start[h + 1]) of the bucket-start table; the first
//           K_CAP photons of the run are taken (the sort is stable, so these
//           are the first deposited), the rest count as dropped;
//   test    d2 = (dx*dx + dy*dy) + dz*dz <= r2, rounded as the plain version
//           rounds it (built with --fmad=false).
// The pairs that pass are written in (point, offset, k) order: the
// row-major order of the reference's (N, 8, K_CAP) slots.  The BSDF
// evaluation of the pairs stays in PyTorch (integrators/sppm.py).
//
// Three kernels, with a prefix sum between the last two (torch.cumsum in
// ops/photon_kernel.py, whose host read of the total sizes the pair list):
//   bucket_start  start[b] = the first sorted index whose bucket is >= b,
//                 b in [0, m]: sorted index j owns the buckets (h[j-1], h[j]]
//                 (h[-1] = -1, h[n] = m), and a warp's lanes fill its 32
//                 indices' buckets together, no atomics;
//   count         M, dropped and the pairs of each group of points;
//   fill          the pairs, each group from its offset.
// count and fill walk alike.  A warp takes kPts consecutive points, each
// point kLanes = 8 / kSlots lanes that hash kSlots cell offsets apiece,
// dedupe them over shuffles and read two bucket bounds a cell.  The
// group's candidate runs are concatenated in (point, offset, k) order (at
// most 32 a cell) and tested a warp-width at a time: a lane finds the
// cell that owns its candidate by a search over the lanes' prefix sums
// (as K3 pools its leaf tests), so a round's photon loads are contiguous
// runs of p_sorted.  fill writes a passing pair at the group's offset
// plus the passes before it: popc(ballot & lanemask_lt) and the earlier
// rounds', so the stores of a round are contiguous.
//
// Bound on the H100 (PERF.md, chip_smoke.py): the bytes, 43 MB on atrium
// 512^2 (the points' inputs, two bucket bounds a visited cell, 12 bytes a
// photon tested, 8 bytes a pair, M and dropped): 0.013 ms.  What the
// design does about the slot-table kernel's 15x that bound: no (N, 256) slot
// table (1.29 of its 1.39 ms went to storing it), two loads a cell in
// place of two binary searches, and a warp's lanes shared by the
// candidates of its points in place of one thread walking its own.  The
// passes read the points' inputs twice; the query as a whole waits on the
// host (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCap = 32;       // K_CAP of integrators/sppm.py
constexpr int kOffsets = 8;
constexpr unsigned kFull = 0xffffffffu;
// cell offsets a lane in the count and fill passes: 8 / kSlots lanes a
// point, kPts points a warp (16; 8 and 4 were slower on atrium 512^2,
// PERF.md)
constexpr int kSlots = 4;
constexpr int kLanes = kOffsets / kSlots;
constexpr int kPts = 32 / kLanes;

__device__ __forceinline__ int hash_cell(int x, int y, int z, int m) {
  const uint32_t h = ((uint32_t)x * 73856093u) ^ ((uint32_t)y * 19349663u) ^
                     ((uint32_t)z * 83492791u);
  const uint32_t a = (h & 0x80000000u) ? 0u - h : h;
  return (int)(a & (uint32_t)(m - 1));
}

// the lanes l with a <= l < b, a and b clamped to [0, 32]
__device__ __forceinline__ unsigned lane_range(int a, int b) {
  a = min(max(a, 0), 32);
  b = min(max(b, 0), 32);
  const unsigned below_b = b >= 32 ? kFull : (1u << b) - 1u;
  const unsigned below_a = a >= 32 ? kFull : (1u << a) - 1u;
  return below_b & ~below_a;
}

// the first lane whose inclusive sum (incl, over the warp) exceeds q; 31
// when none does
__device__ __forceinline__ int owner_lane(int incl, int q) {
  int own = 0;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const int v = __shfl_sync(kFull, incl, own + s - 1);
    if (v <= q) own += s;
  }
  return own;
}

__device__ __forceinline__ int inclusive_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += v;
  }
  return x;
}

// sorted index j owns the buckets (h[j-1], h[j]] (h[-1] = -1, h[n] = m);
// a warp's 32 indices own a contiguous range of buckets, which its lanes
// fill together, 32 consecutive buckets a round, each lane's bucket to
// the lane whose range holds it.  On atrium 512^2 (11,648 valid photons
// in 2^21 buckets: gaps of ~180) this takes 14 us; one thread a gap took
// 56, one thread a bucket by a binary search 24, and a shortcut for a
// round within one lane's range (carrying the owner from round to round)
// 24 (PERF.md, tools/k4_variants.py)
__global__ void __launch_bounds__(kThreads)
bucket_start_kernel(const int* __restrict__ h_sorted, int n, int m,
                    int* __restrict__ start) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j - lane > n) return;  // the whole warp
  int prev = -1, cur = -1;
  if (j <= n) {
    prev = j > 0 ? min(__ldg(h_sorted + j - 1), m) : -1;
    cur = j < n ? min(__ldg(h_sorted + j), m) : m;
  }
  const int gap = j <= n ? max(cur - prev, 0) : 0;
  const int incl = inclusive_sum(gap, lane);
  const int total = __shfl_sync(kFull, incl, 31);
  const int b0 = __shfl_sync(kFull, prev, 0) + 1;
  for (int g0 = 0; g0 < total; g0 += 32) {
    const int t = g0 + lane;
    const int own = owner_lane(incl, t);
    if (t < total) start[b0 + t] = j - lane + own;
  }
}

// kFill false: M, dropped and group_pairs; true: the pairs, group g's from
// group_end[g - 1] (the inclusive prefix sum of group_pairs)
template <bool kFill>
__global__ void __launch_bounds__(kThreads)
query_kernel(const int* __restrict__ lo_c, const int* __restrict__ hi_c,
             const uint8_t* __restrict__ valid, const float* __restrict__ vp_p,
             const float* __restrict__ r2, const int* __restrict__ start,
             const float* __restrict__ p_sorted, int m, int n,
             float* __restrict__ count, int* __restrict__ dropped,
             long long* __restrict__ group_pairs,
             const long long* __restrict__ group_end,
             int* __restrict__ pair_point, int* __restrict__ pair_photon) {
  const int lane = threadIdx.x & 31;
  const int group = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int p0 = group * kPts;
  if (p0 >= n) return;  // the whole warp
  const int first = (lane / kLanes) * kLanes;  // the point's first lane
  const int i = p0 + lane / kLanes;
  const int o0 = (lane % kLanes) * kSlots;     // the lane's first offset
  int lx = 0, ly = 0, lz = 0, hx = -1, hy = -1, hz = -1;
  float px = 0.f, py = 0.f, pz = 0.f, rr = -1.f;
  bool ok = false;
  if (i < n) {
    lx = __ldg(lo_c + 3 * i); ly = __ldg(lo_c + 3 * i + 1); lz = __ldg(lo_c + 3 * i + 2);
    hx = __ldg(hi_c + 3 * i); hy = __ldg(hi_c + 3 * i + 1); hz = __ldg(hi_c + 3 * i + 2);
    px = __ldg(vp_p + 3 * i); py = __ldg(vp_p + 3 * i + 1); pz = __ldg(vp_p + 3 * i + 2);
    rr = __ldg(r2 + i);
    ok = __ldg(valid + i) != 0;
  }
  // each slot's cell: its bucket and whether it is in range
  int hc[kSlots];
  bool in[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int o = o0 + s;
    const int cx = (int)((uint32_t)lx + (uint32_t)(o >> 2));
    const int cy = (int)((uint32_t)ly + (uint32_t)((o >> 1) & 1));
    const int cz = (int)((uint32_t)lz + (uint32_t)(o & 1));
    in[s] = ok && cx <= hx && cy <= hy && cz <= hz;
    hc[s] = hash_cell(cx, cy, cz, m);
  }
  // skip a cell whose bucket an earlier in-range offset of the point has
  // (the first in-range offset of a bucket is always kept, so comparing
  // with the offsets' own range tests is the reference's order)
  bool keep[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) keep[s] = in[s];
#pragma unroll
  for (int q = 0; q < kOffsets - 1; ++q) {
    const int src = first + q / kSlots;
    const int hq = __shfl_sync(kFull, hc[q % kSlots], src);
    const int iq = __shfl_sync(kFull, (int)in[q % kSlots], src);
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (q < o0 + s && iq && hq == hc[s]) keep[s] = false;
  }
  // the runs: at most kCap candidates a cell, the rest dropped
  int lo[kSlots], len[kSlots];
  int cand = 0, drop = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    lo[s] = 0;
    len[s] = 0;
    if (keep[s]) {
      const int a = __ldg(start + hc[s]);
      const int b = __ldg(start + hc[s] + 1);
      lo[s] = a;
      len[s] = min(b - a, kCap);
      drop += b - a - len[s];
    }
    cand += len[s];
  }
  // the group's candidates, concatenated in (point, offset, k) order
  const int incl = inclusive_sum(cand, lane);
  const int total = __shfl_sync(kFull, incl, 31);
  const int excl = incl - cand;
  // the lane's point's candidates [c_lo, c_hi)
  const int c_lo = __shfl_sync(kFull, excl, first);
  const int c_hi = __shfl_sync(kFull, incl, first + kLanes - 1);
  int found = 0, group_found = 0;
  long long out = 0;
  if (kFill) out = group > 0 ? group_end[group - 1] : 0;
  for (int g0 = 0; g0 < total; g0 += 32) {
    const int q = g0 + lane;
    const int own = owner_lane(incl, q);  // the lane whose cells hold q
    int k = q - __shfl_sync(kFull, excl, own);
    int j = -1;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int lo_s = __shfl_sync(kFull, lo[s], own);
      const int len_s = __shfl_sync(kFull, len[s], own);
      if (j < 0 && k < len_s) j = lo_s + k;
      k -= len_s;
    }
    const float ox = __shfl_sync(kFull, px, own);
    const float oy = __shfl_sync(kFull, py, own);
    const float oz = __shfl_sync(kFull, pz, own);
    const float orr = __shfl_sync(kFull, rr, own);
    bool pass = false;
    if (q < total) {
      const float dx = __ldg(p_sorted + 3 * (size_t)j) - ox;
      const float dy = __ldg(p_sorted + 3 * (size_t)j + 1) - oy;
      const float dz = __ldg(p_sorted + 3 * (size_t)j + 2) - oz;
      const float d2 = (dx * dx + dy * dy) + dz * dz;
      pass = d2 <= orr;
    }
    const unsigned ball = __ballot_sync(kFull, pass);
    if (kFill) {
      if (pass) {
        const long long at = out + __popc(ball & ((1u << lane) - 1u));
        pair_point[at] = p0 + own / kLanes;
        pair_photon[at] = j;
      }
      out += __popc(ball);
    } else {
      found += __popc(ball & lane_range(c_lo - g0, c_hi - g0));
      group_found += __popc(ball);
    }
  }
  if (!kFill) {
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) drop += __shfl_xor_sync(kFull, drop, d);
    if (i < n && lane == first) {
      count[i] = (float)found;
      dropped[i] = drop;
    }
    if (lane == 0) group_pairs[group] = group_found;
  }
}

template <bool kFill>
int launch_query(const void* lo_c, const void* hi_c, const void* valid,
                 const void* vp_p, const void* r2, const void* start,
                 const void* p_sorted, int m, int n, void* count,
                 void* dropped, void* group_pairs, const void* group_end,
                 void* pair_point, void* pair_photon, cudaStream_t stream) {
  const long long groups = (n + kPts - 1) / kPts;
  const int grid = (int)((groups * 32 + kThreads - 1) / kThreads);
  query_kernel<kFill><<<grid, kThreads, 0, stream>>>(
      (const int*)lo_c, (const int*)hi_c, (const uint8_t*)valid,
      (const float*)vp_p, (const float*)r2, (const int*)start,
      (const float*)p_sorted, m, n, (float*)count, (int*)dropped,
      (long long*)group_pairs, (const long long*)group_end, (int*)pair_point,
      (int*)pair_photon);
  return (int)cudaGetLastError();
}

}  // namespace

// the points a group of the count and fill passes
extern "C" int photon_points_per_warp() { return kPts; }

// start (m + 1 ints) and the count pass: M (float), dropped and the pairs
// of each group of photon_points_per_warp() points (int64).  Two launches.
extern "C" int photon_count(const void* lo_c, const void* hi_c,
                            const void* valid, const void* vp_p,
                            const void* r2, const void* h_sorted,
                            const void* p_sorted, int n_photons, int m, int n,
                            void* start, void* count, void* dropped,
                            void* group_pairs, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  bucket_start_kernel<<<n_photons / kThreads + 1, kThreads, 0, st>>>(
      (const int*)h_sorted, n_photons, m, (int*)start);
  const int err = (int)cudaGetLastError();
  if (err != 0 || n <= 0) return err;
  return launch_query<false>(lo_c, hi_c, valid, vp_p, r2, start, p_sorted, m,
                             n, count, dropped, group_pairs, nullptr, nullptr,
                             nullptr, st);
}

// the fill pass: group g's pairs from group_end[g - 1], the inclusive
// prefix sum of the count pass's group_pairs.  One launch.
extern "C" int photon_fill(const void* lo_c, const void* hi_c,
                           const void* valid, const void* vp_p, const void* r2,
                           const void* start, const void* p_sorted, int m,
                           int n, const void* group_end, void* pair_point,
                           void* pair_photon, void* stream) {
  if (n <= 0) return 0;
  return launch_query<true>(lo_c, hi_c, valid, vp_p, r2, start, p_sorted, m,
                            n, nullptr, nullptr, nullptr, group_end,
                            pair_point, pair_photon, (cudaStream_t)stream);
}
