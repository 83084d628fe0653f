// JAX's threefry2x32 stream on Hopper: two kernels, no TPU kernel behind
// either.
//
// Why they exist. The JAX package draws every seeded fit from jax.random
// (the forest's Poisson bootstrap and feature masks, GBT's subsample,
// ALS's and the MLP's initial weights, KMeans' device init, CrossValidator's
// folds, the wrangling ops' samples and splits); XLA fuses the threefry
// rounds into one loop fusion, so no Pallas kernel maps to these. In plain
// PyTorch a draw is ~160 elementwise launches over int64 words (the plain
// version in ops/prng.py), and the forest's Poisson draw is Knuth's loop
// over the whole batch, one such draw an iteration until the slowest lane
// is done: ~13 iterations over T x N lanes.
//
//   threefry_bits  element i of a draw under key (k0, k1): the 20 rounds of
//                  threefry2x32 on the counter pair (hi(i), lo(i)), the two
//                  output words xor-ed (JAX's partitionable layout, so a
//                  draw of n elements is the prefix of any longer draw).
//                  uint32 adds and xors, rotates by funnel shift.
//   poisson_knuth  one lane (tree t, row i) runs its own Knuth loop: its
//                  j-th iteration draws the uniform of row i under the j-th
//                  subkey of tree t's split chain (rng, sub = split(rng)),
//                  and it stops once log_prod <= -lam. A lane's count does
//                  not depend on when the other lanes stop, so it equals
//                  JAX's whole-batch while_loop (which freezes a finished
//                  lane). The wrapper hands in the chain's first J0
//                  subkeys of every tree and the chain's state after them;
//                  a lane that runs past J0 goes on splitting in the thread.
//                  logf is the full-precision libm function (no
//                  --use_fast_math, never __logf), so the counts are
//                  bitwise those of the plain torch loop on the card.
//
// What bounds them: integer issue. A hash is 73 32-bit integer operations
// (2 initial key adds; 20 rounds of add, funnel shift, xor; 5 key
// injections of two adds; the final xor) against 4 bytes written a lane:
// at the H100's 128 issue lanes an SM a clock (33.5 T ops/s at 1980 MHz) a
// hash costs 2.2 ps of the card against 1.2 ps for its 4 bytes at
// 3.35 TB/s, so both kernels sit on the issue side. The design keeps every
// word in registers, unrolls the rounds with constant rotations, and writes
// each output once, coalesced. In poisson_knuth a warp runs until its
// slowest lane stops (about 5 iterations of 32 lanes against a mean of 2
// at lam 1), which no reordering of the lanes removes without moving them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;

// threefry2x32 with 20 rounds of (x0, x1) under (k0, k1), in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef TF_ROUND

// 32 random bits of element i under (k0, k1).
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, unsigned long long i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32), x1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

__global__ void __launch_bounds__(kThreads)
threefry_bits(uint32_t k0, uint32_t k1, long long n, uint32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride)
    out[i] = bits_at(k0, k1, static_cast<unsigned long long>(i));
}

// table: u32[T, J0, 2], the subkeys of the first J0 iterations of each
// tree's chain; rng: u32[T, 2], the chain's key after them. out: i32[T, N].
__global__ void __launch_bounds__(kThreads)
poisson_knuth(const uint32_t* __restrict__ table, const uint32_t* __restrict__ rng, int J0,
              long long T, long long N, float neg_lam, int* __restrict__ out) {
  const long long total = T * N;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; g < total;
       g += stride) {
    const long long t = g / N;
    const unsigned long long i = static_cast<unsigned long long>(g - t * N);
    const uint32_t* tab = table + t * J0 * 2;
    float log_prod = 0.0f;
    int k = 0;
    uint32_t r0 = 0, r1 = 0;
    for (int j = 0; log_prod > neg_lam; ++j) {
      ++k;
      uint32_t s0, s1;
      if (j < J0) {
        s0 = tab[2 * j];
        s1 = tab[2 * j + 1];
      } else {
        if (j == J0) {
          r0 = rng[2 * t];
          r1 = rng[2 * t + 1];
        }
        // rng, sub = split(rng): the hashes of the counters (0, 0) and (0, 1)
        uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
        threefry2x32(r0, r1, a0, a1);
        threefry2x32(r0, r1, b0, b1);
        r0 = a0;
        r1 = a1;
        s0 = b0;
        s1 = b1;
      }
      const uint32_t b = bits_at(s0, s1, i);
      const float u = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
      log_prod = __fadd_rn(log_prod, logf(u));
    }
    out[g] = k - 1;
  }
}

int grid_for(long long n, int sms) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 16;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" const char* prng_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Writes n words of the draw under (k0, k1) to out (u32, held in an int32
// tensor) on `stream`; returns a cudaError_t (0 on success). Allocates
// nothing and does not synchronise.
extern "C" int threefry_bits_launch(unsigned k0, unsigned k1, long long n, void* out, int sms,
                                    void* stream) {
  if (n < 1 || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  threefry_bits<<<grid_for(n, sms), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Writes the Poisson(lam) counts of T trees x N rows to out (i32[T, N]) on
// `stream`; table (u32[T, J0, 2]) and rng (u32[T, 2]) are device memory.
// lam > 0. Returns a cudaError_t. Allocates nothing and does not
// synchronise.
extern "C" int poisson_knuth_launch(const void* table, const void* rng, int J0, long long T,
                                    long long N, float lam, void* out, int sms, void* stream) {
  if (T < 1 || N < 1 || J0 < 1 || !(lam > 0.0f) || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  poisson_knuth<<<grid_for(T * N, sms), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const uint32_t*>(rng), J0, T, N, -lam,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
