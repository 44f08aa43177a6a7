// The Sobol draws of the wavefront samplers, a whole draw in one launch.
//
// Replaces no TPU kernel: the reference computes the draw in XLA
// (pbrt_v3_iile_tpu/ops/samplers.py::ctx_uniform, ops/lds.py::sobol02_owen
// and sobol02), which fuses it.  The port's plain version
// (ops/samplers.py::owen_draw_plain and sobol_pixel_samples_plain) runs each
// uint32 step as an int64 PyTorch kernel, ~251 launches a draw, and the host's
// launch pace sets the path pass.  Both modes start from one (0,2)-sequence
// point (xb, yb) of the wave's index, computed on the host
// (lds.sobol02_bits_int), and a per-column word mix[c]; a lane's seed for
// column c is hash(pixel ^ mix[c]), the Wang hash of lds.hash_u32:
//   owen  column c of k (1 to 4) of ctx_uniform on a SampleCtx, with
//         mix[c] = (code_c * 0x9E3779B9) ^ salt, code_c = bounce*64 +
//         purpose*4 + c: the bits xb for even c and yb for odd c, bit
//         reversed, the Laine-Karras permutation (x += seed, then four
//         x ^= x * const), reversed back, float(x) * 2^-32 clamped to
//         float32(1 - 1e-7);
//   xor   pixel_samples' sobol kinds (k = 2, mix = (0, 0x85EBCA77)): the
//         bits XOR the seed, float(x) * 2^-32 unclamped.
// float(x) rounds to nearest, as the plain version's int64 -> float32
// conversion does, and the scale by 2^-32 is exact, so the two agree bit for
// bit.  Only the k columns written are computed (the plain version's odd
// column of k = 1 or 3 never reaches its output).
//
// Bound on the H100: bytes, 8 a lane in (the int64 pixel id) and 4k out:
// 2,073,600 lanes of a 2-column draw move 24.9 MB, 7.4 us at 3.35 TB/s; the
// ~25 integer operations a column a lane come to about as much at the SMs'
// 64 integer operations a clock.  Design: one thread a lane, its columns in
// registers, stored as one float2 / float4 a lane where k is 2 / 4, so a
// warp's stores are one contiguous run of 128k bytes.  It launches on the
// caller's stream, never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInv2Pow32 = 0x1p-32f;
constexpr float kOneMinus = (float)(1.0 - 1e-7);  // lds._ONE_MINUS

struct Mix {
  uint32_t w[4];
};

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x *= 9u;
  x ^= x >> 4;
  x *= 0x27D4EB2Du;
  return x ^ (x >> 15);
}

__device__ __forceinline__ uint32_t owen_scramble(uint32_t bits,
                                                  uint32_t seed) {
  uint32_t x = __brev(bits) + seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return __brev(x);
}

template <int K, bool kOwen>
__global__ void __launch_bounds__(kThreads)
    sobol_draw_kernel(const int64_t* __restrict__ pixel, Mix mix,
                      uint32_t xb, uint32_t yb, float* __restrict__ out,
                      int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t p = (uint32_t)pixel[i];
  float v[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const uint32_t seed = hash_u32(p ^ mix.w[c]);
    const uint32_t bits = (c & 1) ? yb : xb;
    const uint32_t x = kOwen ? owen_scramble(bits, seed) : bits ^ seed;
    const float f = __uint2float_rn(x) * kInv2Pow32;
    v[c] = kOwen ? fminf(f, kOneMinus) : f;
  }
  if constexpr (K == 2) {
    reinterpret_cast<float2*>(out)[i] = make_float2(v[0], v[1]);
  } else if constexpr (K == 4) {
    reinterpret_cast<float4*>(out)[i] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    float* o = out + (long long)i * K;
#pragma unroll
    for (int c = 0; c < K; ++c) o[c] = v[c];
  }
}

template <int K, bool kOwen>
void launch(const int64_t* pixel, const Mix& mix, uint32_t xb, uint32_t yb,
            float* out, int n, cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  sobol_draw_kernel<K, kOwen><<<grid, kThreads, 0, stream>>>(pixel, mix, xb,
                                                             yb, out, n);
}

}  // namespace

// Writes the (n, k) float32 draw `out` (row-major; (n,) for k = 1) for the
// int64 pixel ids `pixel` on `stream`; owen != 0 selects the Owen mode (k 1
// to 4), owen == 0 the XOR mode (k = 2).  mix0..mix3: the columns' words
// (those past k are ignored); xb, yb: the point's bits.  Returns the
// launch's CUDA error, or cudaErrorInvalidValue for a k the mode lacks.
extern "C" int sobol_draw(const void* pixel, int n, int k, int owen,
                          unsigned mix0, unsigned mix1, unsigned mix2,
                          unsigned mix3, unsigned xb, unsigned yb, void* out,
                          void* stream) {
  if (n <= 0) return 0;
  const Mix mix = {{mix0, mix1, mix2, mix3}};
  const int64_t* px = (const int64_t*)pixel;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (!owen) {
    if (k != 2) return (int)cudaErrorInvalidValue;
    launch<2, false>(px, mix, xb, yb, o, n, s);
  } else {
    switch (k) {
      case 1: launch<1, true>(px, mix, xb, yb, o, n, s); break;
      case 2: launch<2, true>(px, mix, xb, yb, o, n, s); break;
      case 3: launch<3, true>(px, mix, xb, yb, o, n, s); break;
      case 4: launch<4, true>(px, mix, xb, yb, o, n, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
