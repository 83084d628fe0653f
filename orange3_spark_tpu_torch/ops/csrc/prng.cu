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
//   poisson_knuth  the Knuth loop of lane (tree t, row i): its j-th
//                  iteration draws the uniform of row i under the j-th
//                  subkey of tree t's split chain (rng, sub = split(rng)),
//                  and it stops once log_prod <= -lam. A lane's count does
//                  not depend on when the other lanes stop, so it equals
//                  JAX's whole-batch while_loop (which freezes a finished
//                  lane), whatever order the lanes run in. The wrapper
//                  hands in the chain's first J subkeys of every tree (J
//                  sized from lam) and the chain's state after them; a
//                  lane that runs past J goes on splitting in the thread.
//                  logf is the full-precision libm function (no
//                  --use_fast_math, never __logf), so the counts are
//                  bitwise those of the plain torch loop on the card.
//
// What bounds them: issue. A hash is 73 32-bit integer operations (2
// initial key adds; 20 rounds of add, funnel shift, xor; 5 key injections
// of two adds; the final xor) against 4 bytes written a lane: at the
// H100's 128 issue lanes an SM a clock (33.5 T ops/s at 1980 MHz) a hash
// costs 2.2 ps of the card against 1.2 ps for its 4 bytes at 3.35 TB/s, so
// both kernels sit on the issue side. threefry_bits keeps every word in
// registers, unrolls the rounds with constant rotations, and writes each
// output once, coalesced.
//
// poisson_knuth's iteration is the hash, logf, the uniform's conversion,
// the compare, the table read and the refill below. Its lanes need
// Poisson(lam) + 1 iterations each, 2 on average at lam 1, and the slowest
// of 32 about 5: a warp that ran one lane a thread to its end spent 44 % of
// its issued lane-slots on iterations at the forest's draw (lam 1). So a
// thread here holds one live lane at a time, not one row: a block owns a
// tile of one tree's rows, and after each iteration every thread whose lane
// stopped writes its count to the tile's staging array in shared memory and
// takes the tile's next unstarted row from a shared counter (the compiler
// makes the atomicAdd one a warp). A warp stays full until its tile runs
// out of rows (96 % of the lane-slots do an iteration at the forest's
// draw), and the counts leave in one coalesced pass. The tree and the tile
// come from blockIdx in 32-bit arithmetic (no 64-bit division a lane); the
// tree's table sits in shared memory, where lanes at different j read their
// own subkeys. The function needs 104 instructions an iteration (69 the
// hash, 28 logf with the uniform's conversion, 2 the table read, 2 the
// count, the add, compare and branch) and 12 a row, counted in the SASS of
// probes/knuth_work.cu, which runs a row's loop to its end on the hash and
// float steps below; a pass of this kernel's loop issues 145, its design's
// share the table's branch, the stage write, the refill and convergence
// barriers. 48 registers and 32 KB of staging a block leave 5 blocks of 8
// warps an SM to hide the hash's chain of dependent rounds. On an NVIDIA
// H100 80GB HBM3 at 700.00 W the forest's draw (20 x 10,737,856 lanes,
// 429.5M iterations) takes 2.458 ms against 5.132 ms for the
// one-lane-a-thread kernel, 1.74x the 1.412 ms its work takes at the issue
// rate; a tile of 2048 rows, not 8192, takes 2.782 ms there and 0.132 ms
// against 0.122 at GBT's subsampled round (probes/poisson_knuth_ab.py).

// categorical_gumbel (added beside them, no TPU kernel behind it either:
// XLA fuses the reference's jax.random.categorical(key, logits[None, :],
// shape=(P, negative)), Word2Vec's negative draw, into one loop fusion).
// Draw r of n is the argmax over v of -log(-log(u)) + logits[v], u JAX's
// uniform on [tiny, 1) of the word at flat index r * V + v (hi and lo
// counter words: the index passes 2^32 at real sizes), the logs XLA's CPU
// form (Cephes' logf as ops/prng._xla_log writes it out, each fused
// multiply-add one FFMA), the first index on a tie (jnp.argmax). Only the
// i32 result is written: the [n, V] gumbel array never exists.
//
// What bounds it: issue. A full evaluation costs an element the hash, two
// logs and the uniform (about 160 SASS instructions), but a draw's answer
// is one argmax over V elements, and the logs decide nothing for an
// element whose gumbel cannot lift it to the best value held. The gumbel
// depends only on the word's top 23 bits m, so a table of ~3,000 buckets
// of m (finer where the gumbel rises steeply, as u -> 1) holds each
// bucket's largest gumbel, as the kernel's own function gives it
// (ops/prng.gumbel_bucket_table; no monotonicity assumed). Rounded
// addition is monotone, so fl(gumbel + logit) <= fl(bucket max + logit):
// an element whose bound lies strictly below a value already reached in
// its draw can neither win nor tie, and skips both logs. What is left for
// every element is the hash, the bucket, a shared-memory read of its
// bound, the logit's read and a compare: the function's floor, counted in
// probes/categorical_work.cu's SASS.
//
// A warp takes one draw and walks its V elements 32 at a time. The
// survivors of a step (all of the first step's, a few later) go to the
// warp's queue in shared memory (__ballot_sync and popcount give each its
// slot) and are evaluated 32 at a time, a survivor a lane, so the logs run
// with the warp converged; a butterfly of first_max (the value, then the
// smaller v) folds them into the warp's best, whose value is the next
// threshold. An element's value depends only on itself, so moving it
// between lanes changes no bit. The threshold is never NaN and starts at
// -inf, so nothing is skipped before a value is held; a -inf logit is
// skipped once a finite value is held, a NaN logit never (torch.argmax's
// order puts NaN first, and first_max keeps it). A lane steps its 64-bit
// counter by 32 and keeps four steps' hashes in flight (41 registers, 6
// blocks of 8 warps an SM); the first step of a draw runs alone.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W, Word2Vec's draw (327,680 rows
// over 20,000 words) takes 22.64 ms against 85.58 ms for the block-a-draw
// kernel that evaluated every element (probes/categorical_gumbel_ab.py);
// 0.19 % of the elements take the logs, 1.86 evaluation passes a draw.
// The floor (78 instructions an element) takes 15.28 ms at the all-lane
// issue rate, so the kernel is at 1.48x; 55 of those 78 are integer-pipe
// instructions, which Hopper issues at half that rate.

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

// The next subkey past the table: rng, sub = split(rng), the hashes of the
// counters (0, 0) and (0, 1). Out of line: a lane gets here only past the
// table, which the wrapper sizes so that this is rare (chip_smoke.py counts
// the loop's SASS without this call's block).
__device__ __noinline__ uint4 split_chain(uint32_t r0, uint32_t r1) {
  uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
  threefry2x32(r0, r1, a0, a1);
  threefry2x32(r0, r1, b0, b1);
  return make_uint4(a0, a1, b0, b1);
}

constexpr int kKnuthThreads = 256;
constexpr int kKnuthTileMax = 8192;
constexpr int kKnuthTableMax = 64;

// table: u32[T, J, 2], the subkeys of the first J iterations of each tree's
// chain (J <= kKnuthTableMax); rng: u32[T, 2], the chain's key after them;
// out: i32[T, N]. Block b owns rows [tile * tile_rows, +tile_rows) of tree
// t (b = t * tiles_per_tree + tile). kCountSlots: also add the block's
// warp-iterations and lane-iterations to slots[0] and slots[1] (a
// measurement build).
template <bool kCountSlots>
__global__ void __launch_bounds__(kKnuthThreads, 4)
poisson_knuth(const uint32_t* __restrict__ table, const uint32_t* __restrict__ rng, int J,
              int tiles_per_tree, int tile_rows, long long N, float neg_lam,
              int* __restrict__ out, unsigned long long* __restrict__ slots) {
  __shared__ uint2 tab[kKnuthTableMax + 1];
  __shared__ int next_row;
  extern __shared__ int stage[];                            // [tile_rows]
  const int t = static_cast<int>(blockIdx.x) / tiles_per_tree;
  const int tile = static_cast<int>(blockIdx.x) - t * tiles_per_tree;
  const long long row0 = static_cast<long long>(tile) * tile_rows;
  const long long left = N - row0;
  const int rows = left < tile_rows ? static_cast<int>(left) : tile_rows;
  const uint2* tree_tab = reinterpret_cast<const uint2*>(table) + static_cast<long long>(t) * J;
  for (int k = threadIdx.x; k < J; k += kKnuthThreads) tab[k] = tree_tab[k];
  if (threadIdx.x == 0) {
    tab[J] = reinterpret_cast<const uint2*>(rng)[t];
    next_row = kKnuthThreads;
  }
  __syncthreads();

  // Every lane runs the iteration each pass (no branch around it): a warp
  // is full but in its tile's last passes, where a lane without a row
  // computes for nothing and keeps j at 0.
  int r = threadIdx.x;
  bool live = r < rows;
  int j = 0;
  float log_prod = 0.0f;
  unsigned long long i = static_cast<unsigned long long>(row0 + r);
  uint32_t c0 = static_cast<uint32_t>(i >> 32), c1 = static_cast<uint32_t>(i);
  uint32_t r0 = 0u, r1 = 0u;
  [[maybe_unused]] unsigned long long warp_iters = 0, lane_iters = 0;
  for (;;) {
    if constexpr (kCountSlots) {
      const unsigned on = __ballot_sync(0xFFFFFFFFu, live);
      warp_iters += on != 0u;
      lane_iters += __popc(on);
    }
    uint32_t s0, s1;
    if (j < J) {
      const uint2 s = tab[j];
      s0 = s.x;
      s1 = s.y;
    } else {
      if (j == J) {
        r0 = tab[J].x;
        r1 = tab[J].y;
      }
      const uint4 s = split_chain(r0, r1);
      r0 = s.x;
      r1 = s.y;
      s0 = s.z;
      s1 = s.w;
    }
    uint32_t x0 = c0, x1 = c1;
    threefry2x32(s0, s1, x0, x1);
    const uint32_t b = x0 ^ x1;
    const float u = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
    log_prod = __fadd_rn(log_prod, logf(u));
    ++j;
    const bool stop = !(log_prod > neg_lam);
    if (live && stop) stage[r] = j - 1;
    // a stopped lane, or one without a row, takes the tile's next row (the
    // compiler makes the atomic one a warp: ballot, popc, shfl)
    if (!live || stop) {
      r = atomicAdd(&next_row, 1);
      live = r < rows;
      j = 0;
      log_prod = 0.0f;
      i = static_cast<unsigned long long>(row0 + r);
      c0 = static_cast<uint32_t>(i >> 32);
      c1 = static_cast<uint32_t>(i);
    }
    if (!__any_sync(0xFFFFFFFFu, live)) break;
  }
  if constexpr (kCountSlots) {
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(slots, warp_iters);
      atomicAdd(slots + 1, lane_iters);
    }
  }
  __syncthreads();
  int* dst = out + static_cast<long long>(t) * N + row0;
  for (int k = threadIdx.x; k < rows; k += kKnuthThreads) dst[k] = stage[k];
}

constexpr int kCatThreads = 256;
constexpr int kCatWarps = kCatThreads / 32;
// 32-element steps of a warp whose hashes are in flight together
constexpr int kCatUnroll = 4;
constexpr float kTiny = 1.17549435e-38f;
// Buckets of the gumbel's upper bound: codes 0 .. 2944 of k = 2^23 - m
constexpr int kGumbelBuckets = 2945;

// float32 a * b + c rounded once (one FFMA). ops/prng._fma32, the plain
// version's form, takes the float64 product and sum rounded once instead:
// the two give the same gumbel for every uniform JAX draws
// (tests/test_torch_prng.py enumerates all 2^23).
__device__ __forceinline__ float fma32(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// XLA's float32 log on the CPU, step for step as ops/prng._xla_log.
__device__ __forceinline__ float xla_log(float x) {
  const float xi = fmaxf(x, kTiny);
  const int bits = __float_as_int(xi);
  float e = __fadd_rn(static_cast<float>((bits >> 23) - 0x7F), 1.0f);
  const float m = __int_as_float((bits & ~0x7F800000) | 0x3F000000);
  const bool low = m < 0.707106769f;
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  float t = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float x2 = __fmul_rn(t, t);
  const float x3 = __fmul_rn(x2, t);
  float y = fma32(fma32(t, 7.0376836292E-2f, -1.1514610310E-1f), t, 1.1676998740E-1f);
  const float y1 = fma32(fma32(t, -1.2420140846E-1f, 1.4249322787E-1f), t, -1.6668057665E-1f);
  const float y2 = fma32(fma32(t, 2.0000714765E-1f, -2.4999993993E-1f), t, 3.3333331174E-1f);
  y = fma32(fma32(fma32(y, x3, y1), x3, y2), x3, __fmul_rn(-2.12194440e-4f, e));
  t = __fadd_rn(__fsub_rn(t, __fmul_rn(0.5f, x2)), y);
  float out = fma32(0.693359375f, e, t);
  if (x >= 0.0f && x < kTiny) out = -__int_as_float(0x7F800000);
  if (x == __int_as_float(0x7F800000)) out = x;
  if (x < 0.0f || x != x) out = __int_as_float(0x7FC00000);
  return out;
}

// The gumbel of a word b: -log(-log(u)), u JAX's uniform on [tiny, 1)
// from b's top 23 bits m. JAX forms u = max(tiny, f * (1 - tiny) + tiny),
// f = m / 2^23, with 1 - tiny == 1 in float32; f is 0 or at least 2^-23,
// so that sum rounds to f, or to tiny at m = 0: u = max(f, tiny).
__device__ __forceinline__ float gumbel_of(uint32_t b) {
  const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  return -xla_log(-xla_log(fmaxf(f, kTiny)));
}

// The gumbel of element i (flat index r * V + v).
__device__ __forceinline__ float gumbel_at(uint32_t k0, uint32_t k1, unsigned long long i) {
  return gumbel_of(bits_at(k0, k1, i));
}

// The bucket of word b: k = 2^23 - m (1 .. 2^23) by its exponent and its
// 7 bits below the leading one, (exponent - 127) * 128 + those bits, in
// [0, kGumbelBuckets). The gumbel rises as -log(k / 2^23) near u = 1, so a
// bucket spans a relative step of 2^-7 in k and its gumbels lie within
// log(1 + 2^-7) of each other there; k < 128 is exact. Formed in float32
// without a conversion: 2 - (1 + m / 2^23) is k / 2^23 exactly (Sterbenz),
// whose bits carry k's exponent less 23. ops/prng.gumbel_bucket is the
// same map.
__device__ __forceinline__ int gumbel_bucket(uint32_t b) {
  const float k = __fsub_rn(2.0f, __uint_as_float((b >> 9) | 0x3F800000u));
  return static_cast<int>(__float_as_uint(k) >> 16) - 0x3400;
}

// (a, ia) becomes the first maximum of itself and (b, ib): the larger
// value, NaN above every number (torch.argmax's order), the smaller index
// on equal values or two NaNs.
__device__ __forceinline__ void first_max(float& a, int& ia, float b, int ib) {
  const bool an = a != a, bn = b != b;
  const bool take = bn ? (!an || ib < ia) : (!an && (b > a || (b == a && ib < ia)));
  if (take) {
    a = b;
    ia = ib;
  }
}

// A warp's queue of elements that survived the bound (v and their word),
// evaluated 32 at a time.
struct CatQueue {
  int v[64];
  uint32_t b[64];
};

// Evaluates the first cnt (<= 32) entries of the warp's queue, a lane an
// entry, and folds their first maximum into the warp's (best, arg).
__device__ __forceinline__ void cat_evaluate(const CatQueue& q, int cnt, int lane,
                                             const float* __restrict__ logits, int V,
                                             float& best, int& arg) {
  __syncwarp();
  float val = -__int_as_float(0x7F800000);
  int vi = V;
  if (lane < cnt) {
    vi = q.v[lane];
    val = __fadd_rn(gumbel_of(q.b[lane]), __ldg(logits + vi));
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, val, o);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, vi, o);
    first_max(val, vi, ov, oi);
  }
  first_max(best, arg, val, vi);
}

// gmax_table: f32[kGumbelBuckets], bucket c's largest gumbel_of over
// every word in it (ops/prng.gumbel_bucket_table). kCount: also add the
// elements evaluated and the evaluation passes to counts[0] and counts[1]
// (a measurement build).
template <bool kCount>
__global__ void __launch_bounds__(kCatThreads)
categorical_gumbel(uint32_t k0, uint32_t k1, const float* __restrict__ logits, int V,
                   long long n, long long first_row, const float* __restrict__ gmax_table,
                   int* __restrict__ out, unsigned long long* __restrict__ counts) {
  __shared__ float gmax[kGumbelBuckets];
  __shared__ CatQueue queues[kCatWarps];
  for (int c = threadIdx.x; c < kGumbelBuckets; c += kCatThreads) gmax[c] = gmax_table[c];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  CatQueue& q = queues[threadIdx.x >> 5];
  unsigned long long evaluated = 0, passes = 0;
  for (long long r = static_cast<long long>(blockIdx.x) * kCatWarps + (threadIdx.x >> 5); r < n;
       r += static_cast<long long>(gridDim.x) * kCatWarps) {
    // lane's counter: the flat index of its element, stepped 32 at a time
    unsigned long long i = static_cast<unsigned long long>(first_row + r) * V + lane;
    // warp-uniform: the first maximum over the evaluated elements, and the
    // skip threshold, a value some evaluated element reached (NaN never)
    float best = -__int_as_float(0x7F800000), thr = best;
    int arg = V, queued = 0;
    // The step's survivors into the queue; 32 queued are evaluated at once.
    auto offer = [&](bool keep, int v, uint32_t b) {
      const unsigned mask = __ballot_sync(0xFFFFFFFFu, keep);
      if (mask == 0u) return;
      if (keep) {
        const int slot = queued + __popc(mask & below);
        q.v[slot] = v;
        q.b[slot] = b;
      }
      queued += __popc(mask);
      if (queued >= 32) {
        cat_evaluate(q, 32, lane, logits, V, best, arg);
        thr = fmaxf(thr, best);
        queued -= 32;
        if constexpr (kCount) {
          evaluated += 32;
          passes += 1;
        }
        __syncwarp();
        if (lane < queued) {
          q.v[lane] = q.v[lane + 32];
          q.b[lane] = q.b[lane + 32];
        }
        __syncwarp();
      }
    };
    // fl(gumbel + logit) <= fl(bucket max + logit): rounding is monotone.
    // Below thr (strictly) the element can neither win nor tie.
    auto step = [&](int v0, unsigned long long at) {
      const int v = v0 + lane;
      uint32_t b = 0u;
      bool keep = false;
      if (v < V) {
        b = bits_at(k0, k1, at);
        keep = !(__fadd_rn(gmax[gumbel_bucket(b)], __ldg(logits + v)) < thr);
      }
      offer(keep, v, b);
    };
    // The first step alone (every element survives it: nothing is held),
    // then the steps whose 32 lanes all lie below V kCatUnroll at a time,
    // their hashes independent (a later step's test may use the earlier
    // thr, which only skips less), then the rest, the last ragged.
    step(0, i);
    const int full = V & ~31;
    int v0 = 32;
    for (i += 32; v0 + 32 * kCatUnroll <= full; v0 += 32 * kCatUnroll, i += 32 * kCatUnroll) {
      uint32_t b[kCatUnroll];
      bool keep[kCatUnroll];
#pragma unroll
      for (int u = 0; u < kCatUnroll; ++u) {
        b[u] = bits_at(k0, k1, i + 32 * u);
        keep[u] = !(__fadd_rn(gmax[gumbel_bucket(b[u])], __ldg(logits + v0 + 32 * u + lane))
                    < thr);
      }
#pragma unroll
      for (int u = 0; u < kCatUnroll; ++u) offer(keep[u], v0 + 32 * u + lane, b[u]);
    }
    for (; v0 < V; v0 += 32, i += 32) step(v0, i);
    if (queued > 0) {
      cat_evaluate(q, queued, lane, logits, V, best, arg);
      if constexpr (kCount) {
        evaluated += queued;
        passes += 1;
      }
    }
    __syncwarp();
    if (lane == 0) out[r] = arg;
  }
  if constexpr (kCount) {
    if (lane == 0) {
      atomicAdd(counts, evaluated);
      atomicAdd(counts + 1, passes);
    }
  }
}

// out[m] = gumbel_of(m << 9) for every m < 2^23: the kernel's own gumbel
// of each uniform, for the check that ops/prng.gumbel_bucket_table bounds
// it (not on any draw's path).
__global__ void __launch_bounds__(kThreads) gumbel_values(float* __restrict__ out) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m < (1 << 23)) out[m] = gumbel_of(static_cast<uint32_t>(m) << 9);
}

int grid_for(long long n, int sms) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 16;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

// threefry2x32 on the host, for the chains' tables (the same rounds as
// threefry2x32 above, with plain shifts for the rotations).
void threefry2x32_host(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  static const int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
  for (int i = 0; i < 5; ++i) {
    for (const int r : kRot[i % 2]) {
      x0 += x1;
      x1 = ((x1 << r) | (x1 >> (32 - r))) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

}  // namespace

// Host code, no launch: the first J subkeys of each key's chain rng, sub =
// split(rng) (out[t, j] = sub of step j, u32[T, J, 2]), then each chain's
// key after them (u32[T, 2], after the tables), from keys u32[T, 2]. What
// ops/prng._split_chains computes in numpy, in microseconds instead of
// milliseconds of numpy calls; the wrapper uploads it as poisson_knuth's
// table. Returns 0, or cudaErrorInvalidValue for T < 1 or J < 1.
extern "C" int knuth_chain_table(const unsigned* keys, long long T, int J, unsigned* out) {
  if (T < 1 || J < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (long long t = 0; t < T; ++t) {
    uint32_t r0 = keys[2 * t], r1 = keys[2 * t + 1];
    for (int j = 0; j < J; ++j) {
      uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
      threefry2x32_host(r0, r1, a0, a1);
      threefry2x32_host(r0, r1, b0, b1);
      out[(t * J + j) * 2] = b0;
      out[(t * J + j) * 2 + 1] = b1;
      r0 = a0;
      r1 = a1;
    }
    out[T * J * 2 + 2 * t] = r0;
    out[T * J * 2 + 2 * t + 1] = r1;
  }
  return 0;
}

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
// `stream`, a block a tile of tile_rows rows of one tree; table (u32[T, J,
// 2]) and rng (u32[T, 2]) are device memory. lam > 0; J in [1,
// kKnuthTableMax]; tile_rows a multiple of 32 in [kKnuthThreads,
// kKnuthTileMax]. slots: null, or u64[2] that the
// measurement build adds its warp-iterations and lane-iterations to.
// Returns a cudaError_t. Allocates nothing and does not synchronise.
extern "C" int poisson_knuth_launch(const void* table, const void* rng, int J, long long T,
                                    long long N, float lam, int tile_rows, void* out,
                                    void* slots, int sms, void* stream) {
  if (T < 1 || N < 1 || J < 1 || J > kKnuthTableMax || !(lam > 0.0f) || sms < 1 ||
      tile_rows < kKnuthThreads || tile_rows > kKnuthTileMax || tile_rows % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (N + tile_rows - 1) / tile_rows;
  if (T * tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = sizeof(int) * tile_rows;
  const dim3 grid(static_cast<unsigned>(T * tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto* key = static_cast<const uint32_t*>(rng);
  if (slots == nullptr)
    poisson_knuth<false><<<grid, kKnuthThreads, shared, s>>>(
        tab, key, J, static_cast<int>(tiles), tile_rows, N, -lam, static_cast<int*>(out),
        nullptr);
  else
    poisson_knuth<true><<<grid, kKnuthThreads, shared, s>>>(
        tab, key, J, static_cast<int>(tiles), tile_rows, N, -lam, static_cast<int*>(out),
        static_cast<unsigned long long*>(slots));
  return static_cast<int>(cudaGetLastError());
}

// Writes draws first_row .. first_row + n - 1 of JAX's categorical over the
// V float32 logits (device memory) under (k0, k1) to out (i32[n]) on
// `stream`, a warp a draw, kCatWarps draws a block (at most 16 blocks an
// SM, each striding over further draws). gmax: f32[kGumbelBuckets] on the
// device, ops/prng.gumbel_bucket_table. counts: null, or u64[2] that the
// measurement build adds the elements it evaluated and its evaluation
// passes to. Returns a cudaError_t. Allocates nothing and does not
// synchronise.
extern "C" int categorical_gumbel_launch(unsigned k0, unsigned k1, const void* logits,
                                         long long V, long long n, long long first_row,
                                         const void* gmax, void* out, void* counts, int sms,
                                         void* stream) {
  if (V < 1 || V > 0x7FFFFFFFLL - 32 || n < 1 || first_row < 0 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kCatWarps - 1) / kCatWarps;
  const long long cap = static_cast<long long>(sms) * 16;
  const unsigned grid = static_cast<unsigned>(blocks < cap ? blocks : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lg = static_cast<const float*>(logits);
  const auto* gm = static_cast<const float*>(gmax);
  if (counts == nullptr)
    categorical_gumbel<false><<<grid, kCatThreads, 0, s>>>(
        k0, k1, lg, static_cast<int>(V), n, first_row, gm, static_cast<int*>(out), nullptr);
  else
    categorical_gumbel<true><<<grid, kCatThreads, 0, s>>>(
        k0, k1, lg, static_cast<int>(V), n, first_row, gm, static_cast<int*>(out),
        static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Writes the kernel's own gumbel of every uniform (f32[2^23], m's at m) to
// out on `stream`: the check of ops/prng.gumbel_bucket_table. Returns a
// cudaError_t.
extern "C" int gumbel_values_launch(void* out, int sms, void* stream) {
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  gumbel_values<<<(1 << 23) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
