// Node x bin histograms of tree induction, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of orange3_spark_tpu/ops/histogram.py
// (_hist_pallas, kernel body _hist_kernel), which grow_tree in
// models/_tree.py calls once per tree level:
//
//   H[t, j, pos[t,i]*n_bins + B[i,j], c] += S[t, i, c]   for kept features j
//
//   B    u8 or i32[N, d]  binned features, shared by the T trees
//   S    f32[T, N, s]     per-row stats, zero on dead / padding rows
//   pos  i32[T, N]        node of each row within the current level
//   feat i32[T, d]        optional: each tree's kept features, ascending,
//                         the first n_feat[t] of a row valid
//   H    f32[T, d, nodes*n_bins, s]; features not kept stay zero
//
// What bounds it: shared-memory adds, then the loads. At HIGGS width
// (N = 10,737,856 rows, d = 28, 32 bins) a boosting launch (T=1, s=3, u8 B)
// reads 0.47 GB, 0.14 ms at 3.35 TB/s, and makes N*d*s = 902 M adds. On
// this card an fp32 atomicAdd to shared memory is a compare-and-swap loop
// (ATOMS.CAST.SPIN, ~420 G adds/s on an H100; 290 G/s on 96 hot cells), and
// so is a 64-bit one; a 32-bit integer add is one native instruction
// (ATOMS.ADD, ~1400 G/s, as fast on hot cells; probes/shared_add.py). The
// adds run at ~700 G/s, near what the probe gets from a native add whose
// old value is read back. A forest launch (T=20, s=2) reads each tree's S
// and pos (2.6 GB) and B once per tree, through L2.
//
// Design, cause by cause:
// * Fixed point. Stats are accumulated as 64-bit fixed-point integers,
//   each stat c on its own scale: q = round(v * 2^k_c) with k_c = 24 - e_c
//   where max|S[..., c]| < 2^e_c (frexp), so |q| <= 2^24. (One scale for
//   all stats would round a weight column of ones to zero beside a column
//   of squared targets in the thousands.) A column whose max is below
//   2^-103 keeps k_c = 127, so 2^k_c is a normal float and v * 2^k_c is
//   exact. A cell's low 32 bits live in shared memory and take q by
//   a native atomicAdd; the add returns the old word, and on a carry or
//   borrow (rare: |q| / 2^32 of adds at most) the +-2^32 goes straight to
//   the cell's 64-bit sum in global memory (acc). Low words start at 2^31,
//   so sums that wander around zero do not borrow on every add. The sums
//   are exact: the same on every run and in any order, integer stats
//   (class counts) bitwise, and a float sum of stat c is off the exact sum
//   by at most n * 2^(e_c-25) plus one rounding to fp32 (n = adds into the
//   cell).
//   node_hist_finalize turns acc into H.
// * One pass over S and pos. A block holds the histograms of all the
//   features it serves (up to 227 KB of dynamic shared memory); only when
//   they do not fit are features split into the fewest groups that do.
// * u8 bins. B may be uint8 (bins < 256), a quarter of the int32 bytes.
// * Staging. Each tile of B rows and of the tree's S and pos rows arrives
//   by three bulk (TMA) copies, issued by the first lanes of three warps,
//   into a ring of 2-4 shared-memory stages, each with its mbarrier: the
//   next tiles load while the block adds the current one.
// * No idle lanes. Each tile's live rows (a node in range, a non-zero
//   stat) are first compacted (warp ballot, per-warp counts, warp scan)
//   into 16-byte entries: the row and its non-zero fixed-point stats, first
//   slots first. Dead rows and padding drop out, and a one-hot row carries
//   one stat, so a warp makes one add per row, not one per class with lanes
//   masked off. Thread i then keeps kept feature i % F (index and slice in
//   registers) and adds every (blockDim / F)-th entry: all but
//   blockDim % F < F threads work. Several entries' adds are in flight
//   before their carries are looked at.
// * Banks. Within a feature's slice the layout is [stat][node*bin], with
//   an odd stat stride (the s stats of a bin fall in different banks for
//   s = 2 and 3) and an odd feature stride (one cell of neighbouring
//   features in neighbouring banks).
// * One copy of the histograms a block. The native add runs as fast on a
//   few hot cells as on random ones (probes/shared_add.py), and copies per
//   warp at the shallow levels bought nothing on the card.
// * Masks. A block maps its threads to the kept features of its tree only;
//   blocks of a feature group past a tree's kept count exit at once.
// * Grid. One wave of persistent blocks (two of 512 threads an SM, or one
//   of 1024 where the histograms need most of its shared memory): tree
//   fastest, then feature group, then a contiguous range of row tiles, so
//   the trees' blocks over one row range run together and share B's rows
//   through L2.
// * A bin or node index out of range is dropped rather than written outside
//   the shared histogram (the plain version raises on it instead). A
//   non-finite stat makes its column's max non-finite, and then every cell
//   of the launch is NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;  // a block: 512 threads, or 1024 alone on an SM
constexpr int kQBits = 24;     // |q| <= 2^kQBits
constexpr unsigned kBias = 0x80000000u;
constexpr int kRowShift = 21;  // entry key: row << kRowShift | node offset
static_assert(kMaxThreads <= (1 << (31 - kRowShift)), "a tile's row fits the key");
constexpr int kOffMask = (1 << kRowShift) - 1;
constexpr int kMaxStats = 4;   // stats per row the kernel is compiled for
constexpr int kMaxStages = 5;  // tiles in the ring at most

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~size_t(15); }

// ints of one entry: the row's key, then its s fixed-point stats, padded to
// whole int4 loads
__host__ __device__ constexpr int entry_ints(int s) { return s <= 3 ? 4 : 8; }

// The shared-memory layout of one block; ops/histogram.py (smem_bytes)
// computes the same total to plan the launch.
struct Layout {
  int cstride, fstride;  // words between stats of a bin, between features
  size_t hist, flist, counters, stage_b, stage_s, stage_p, stage, entries, total;
  __host__ __device__ Layout(int d, int s, int nodes, int n_bins, int b_bytes,
                             int group, int tile_rows, int stages) {
    cstride = (nodes * n_bins) | 1;
    fstride = (s * cstride) | 1;
    hist = round16((size_t)group * fstride * 4);
    flist = round16((size_t)group * 4);
    counters = round16(kMaxThreads / 32 * 4 + kMaxStages * 8);  // live rows a warp; mbarriers
    // a tile's S and pos may start anywhere in a 16-byte line: 32 bytes of
    // slack hold the whole lines the bulk copy moves
    stage_b = round16((size_t)tile_rows * d * b_bytes);
    stage_s = round16((size_t)tile_rows * s * 4) + 32;
    stage_p = round16((size_t)tile_rows * 4) + 32;
    stage = stage_b + stage_s + stage_p;
    entries = (size_t)tile_rows * entry_ints(s) * 4;
    total = hist + flist + counters + stages * stage + entries;
  }
};

struct Args {
  const unsigned char* B;
  const float* S;
  const int* pos;
  const int* feat;      // null: every feature kept
  const int* n_feat;
  const float* smax;    // max|S| of each stat
  unsigned long long* acc;
  long long N;
  int d, s, T, nodes, n_bins, b_bytes, group, tile_rows, stages, row_blocks;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

constexpr int kIssuers = 3;  // threads that load a tile: one bulk copy each

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(kIssuers)
               : "memory");
}

// An issuing thread arrives and announces the bytes its copy will deliver;
// the phase completes when all issuers have arrived and the bytes landed.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// One bulk (TMA) copy of `bytes` (a multiple of 16, 16-byte aligned ends)
// from global to shared memory, reported to `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Bytes [begin, end) of a 16-byte aligned allocation of `total` bytes, to
// be copied whole 16-byte lines at a time: the lines [a0, a1) go by bulk
// copy, a last part line at the end of the allocation (end > a1) by hand.
// The span's first byte lands at dst + (begin - a0).
struct Span {
  size_t a0, a1, end;
  __device__ Span(size_t begin, size_t end_, size_t total) : end(end_) {
    a0 = begin & ~size_t(15);
    a1 = (end + 15) & ~size_t(15);
    if (a1 > total) a1 = end & ~size_t(15);
    if (a1 < a0) a1 = a0;
  }
  __device__ unsigned bulk() const { return (unsigned)(a1 - a0); }
  __device__ void copy(unsigned char* dst, const unsigned char* src,
                       unsigned long long* bar) const {
    if (a1 > a0) bulk_copy(dst, src + a0, (unsigned)(a1 - a0), bar);
    for (size_t i = a1; i < end; ++i) dst[i - a0] = src[i];
  }
};

// Loads part `part` of tile `tile` of tree t into a slot of the ring by one
// bulk copy announced to the slot's mbarrier: 0 the B rows, 1 the tree's S
// rows, 2 its pos rows. Each part is issued by a thread of its own warp (a
// bulk copy holds its thread for hundreds of cycles); kept out of line so
// that its 64-bit offsets take no registers in the tile loop.
__device__ __noinline__ void load_tile(const Args& a, int t, long long tile, int part,
                                       unsigned char* slot, size_t stage_b,
                                       size_t stage_s, unsigned long long* bar) {
  const size_t r0 = (size_t)tile * a.tile_rows;
  const size_t r1 = r0 + a.tile_rows < (size_t)a.N ? r0 + a.tile_rows : (size_t)a.N;
  size_t row, lead;   // bytes a row, bytes before this tree's rows
  const unsigned char* src;
  if (part == 0) {
    row = (size_t)a.d * a.b_bytes, lead = 0, src = a.B;
  } else {
    row = part == 1 ? (size_t)a.s * 4 : 4;
    lead = (size_t)t * a.N * row;
    src = part == 1 ? reinterpret_cast<const unsigned char*>(a.S)
                    : reinterpret_cast<const unsigned char*>(a.pos);
    slot += part == 1 ? stage_b : stage_b + stage_s;
  }
  const size_t total = (size_t)(part == 0 ? 1 : a.T) * a.N * row;
  const Span sp(lead + r0 * row, lead + r1 * row, total);
  mbar_expect(bar, sp.bulk());
  sp.copy(slot, src, bar);
}

// Exponent shift k of a stat's fixed point: max|S[..., c]| < 2^e,
// k = kQBits - e, at most 127 (2^k stays a normal float).
__device__ __forceinline__ int fixed_shift(float smax) {
  int e;
  frexpf(smax, &e);
  return min(kQBits - e, 127);
}

// BT: the type of a bin; SC: the number of stats (compiled for 1-4, so a
// row's adds and their carries stay in registers). At most 64 registers a
// thread: 1024 threads, or two blocks of 512, fill an SM's registers.
template <typename BT, int SC>
__global__ void __launch_bounds__(kMaxThreads)
node_hist_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(a.d, a.s, a.nodes, a.n_bins, a.b_bytes, a.group, a.tile_rows,
                 a.stages);
  unsigned* hist = reinterpret_cast<unsigned*>(smem);
  int* flist = reinterpret_cast<int*>(smem + L.hist);
  int* warp_live = reinterpret_cast<int*>(smem + L.hist + L.flist);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + L.hist + L.flist + kMaxThreads / 32 * 4);
  unsigned char* stages = smem + L.hist + L.flist + L.counters;
  constexpr int E = entry_ints(SC);
  int* entries = reinterpret_cast<int*>(stages + a.stages * L.stage);

  const int lanes = a.T * ((a.d + a.group - 1) / a.group);
  const int t = blockIdx.x % a.T;
  const int g = (blockIdx.x % lanes) / a.T;
  const int rb = blockIdx.x / lanes;
  const int j0 = g * a.group;
  const int kept = a.feat ? a.n_feat[t] : a.d;
  const int F = min(a.group, kept - j0);
  if (F <= 0) return;
  // 2^k_c of each stat: -104 <= k_c <= 127, a normal float, so v * 2^k_c
  // is exact
  float scale[SC];
#pragma unroll
  for (int c = 0; c < SC; ++c) {
    const float m = a.smax[c];
    if (!isfinite(m)) return;   // finalize writes NaN
    scale[c] = ldexpf(1.f, fixed_shift(m));
  }

  constexpr int s = SC;
  static_assert(1 + SC <= entry_ints(SC), "an entry holds its key and stats");
  const int nb = a.nodes * a.n_bins;
  for (int i = threadIdx.x; i < F; i += blockDim.x)
    flist[i] = a.feat ? a.feat[(long long)t * a.d + j0 + i] : j0 + i;
  for (int i = threadIdx.x; i < F * L.fstride; i += blockDim.x) hist[i] = kBias;
  // this block's contiguous range of row tiles
  const long long n_tiles = (a.N + a.tile_rows - 1) / a.tile_rows;
  const long long tile0 = n_tiles * rb / a.row_blocks;
  const long long tile1 = n_tiles * (rb + 1) / a.row_blocks;

  // lane 0 of warps 0-2 each load their part of the block's i-th tile
  const int part = (threadIdx.x & 31) == 0 && threadIdx.x < 32 * kIssuers
                       ? (int)threadIdx.x / 32 : -1;
  auto load = [&](int i) {
    const int slot = i % a.stages;
    load_tile(a, t, tile0 + i, part, stages + slot * L.stage, L.stage_b, L.stage_s,
              bars + slot);
  };

  // (entry, feature) pairs: thread i keeps kept feature i % F and takes
  // every qs-th entry from i / F on; the blockDim.x % F < F threads past
  // qs·F sit the adds out
  const int qs = blockDim.x / F;
  const int f_me = threadIdx.x % F;
  const bool adder = (int)threadIdx.x < qs * F;
  const int e_first = threadIdx.x / F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int slice = f_me * L.fstride;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // flist and the barriers are set
  const int j_me = flist[f_me];

  // a ring of a.stages tiles: a.stages - 1 loads ahead of the adds
  const int n_mine = (int)(tile1 - tile0);
  if (part >= 0)
    for (int i = 0; i < a.stages - 1 && i < n_mine; ++i) load(i);
  for (int i = 0; i < n_mine; ++i) {
    const int slot = i % a.stages;
    mbar_wait(bars + slot, (unsigned)(i / a.stages) & 1u);
    __syncthreads();  // every thread is done with the previous tile
    if (part >= 0 && i + a.stages - 1 < n_mine) load(i + a.stages - 1);

    // the tile's rows in its slot; S and pos start where their first byte
    // sits in its 16-byte line (the low 4 bits of their offsets, which
    // 32-bit arithmetic keeps)
    const long long r0 = (tile0 + i) * a.tile_rows;
    const unsigned row_in_all = (unsigned)t * (unsigned)a.N + (unsigned)r0;
    const unsigned char* base = stages + slot * L.stage;
    const BT* Bs = reinterpret_cast<const BT*>(base);
    const float* Ss = reinterpret_cast<const float*>(
        base + L.stage_b + ((row_in_all * SC * 4u) & 15u));
    const int* Ps = reinterpret_cast<const int*>(
        base + L.stage_b + L.stage_s + ((row_in_all * 4u) & 15u));
    const int rows = (int)min((long long)a.tile_rows, a.N - r0);

    // ---- compact the tile's live rows (a node in range, a non-zero stat)
    // into entries: the row's key, then its non-zero fixed-point stats.
    // One row a thread (tile_rows <= blockDim.x); a warp's live rows go
    // after the earlier warps' (per-warp counts, then a warp scan)
    const int r = threadIdx.x;
    bool live = false;
    int key = 0;
    if (r < rows) {
      const int p = Ps[r];
      if ((unsigned)p < (unsigned)a.nodes) {
#pragma unroll
        for (int c = 0; c < SC; ++c) live |= Ss[r * SC + c] != 0.f;
        key = (r << kRowShift) | (p * a.n_bins);
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[warp] = __popc(mask);
    __syncthreads();
    int before = lane < n_warps ? warp_live[lane] : 0;   // inclusive scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, before, o);
      if (lane >= o) before += v;
    }
    const int M = __shfl_sync(0xffffffffu, before, n_warps - 1);
    const int at = __shfl_sync(0xffffffffu, before, warp) - __popc(mask) +
                   __popc(mask & ((1u << lane) - 1u));
    if (live) {  // the row's non-zero stats first, each as q << 2 | c
      int slot[4] = {0, 0, 0, 0};
#pragma unroll
      for (int c = SC - 1; c >= 0; --c) {
        const float v = Ss[r * SC + c];
        const int q = __float2int_rn(v * scale[c]);
        if (q != 0) {
#pragma unroll
          for (int i = 3; i > 0; --i) slot[i] = slot[i - 1];
          slot[0] = (q << 2) | c;
        }
      }
      int4* en = reinterpret_cast<int4*>(entries + at * E);
      en[0] = make_int4(key, slot[0], slot[1], slot[2]);
      if (E > 4) en[1] = make_int4(slot[3], 0, 0, 0);
    }
    __syncthreads();

    // ---- add the pairs: U entries per thread per step, all their
    // non-zero stats in flight before the carries are looked at. Slot c of
    // an entry is its c-th non-zero stat, so a warp of one-hot rows makes
    // one add each, not one per class with lanes masked off
    constexpr int U = SC <= 2 ? 4 : 2;
    for (int e0 = adder ? e_first : M; e0 < M; e0 += U * qs) {
      int word[U], q[U][SC];
      unsigned old[U][SC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * qs;
        int4 en = make_int4(0, 0, 0, 0), en2 = make_int4(0, 0, 0, 0);
        if (e < M) {
          en = reinterpret_cast<const int4*>(entries + e * E)[0];
          if (E > 4) en2 = reinterpret_cast<const int4*>(entries + e * E)[1];
        }
        const int rec[8] = {en.x, en.y, en.z, en.w, en2.x, en2.y, en2.z, en2.w};
        const int off = rec[0] & kOffMask;
        const int b = e < M ? (int)Bs[(rec[0] >> kRowShift) * a.d + j_me] : -1;
        const bool in = (unsigned)b < (unsigned)a.n_bins;
        word[u] = slice + off + b;
#pragma unroll
        for (int c = 0; c < SC; ++c) q[u][c] = in ? rec[1 + c] : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < SC; ++c)
          if (q[u][c] != 0)
            old[u][c] = atomicAdd(hist + word[u] + (q[u][c] & 3) * L.cstride,
                                  (unsigned)(q[u][c] >> 2));
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          if (q[u][c] == 0) continue;
          const int qv = q[u][c] >> 2;
          const unsigned now = old[u][c] + (unsigned)qv;
          const int hi = (now < old[u][c] ? 1 : 0) - (qv < 0 ? 1 : 0);
          if (hi != 0) {  // carry or borrow: +-2^32 into the cell's global sum
            const long long cell = ((long long)t * a.d + j_me) * nb + (word[u] - slice);
            atomicAdd(a.acc + cell * SC + (q[u][c] & 3),
                      (unsigned long long)((long long)hi << 32));
          }
        }
    }
  }
  __syncthreads();

  // ---- flush: the low words, less their bias, into acc
  const int per_feature = nb * s;
  for (int i = threadIdx.x; i < F * per_feature; i += blockDim.x) {
    const int fi = i / per_feature;
    const int rem = i - fi * per_feature;
    const int cnb = rem / s, c = rem - cnb * s;
    const int word = fi * L.fstride + c * L.cstride + cnb;
    const long long sum = (long long)hist[word] - (long long)kBias;
    if (sum != 0)
      atomicAdd(a.acc + ((long long)t * a.d + flist[fi]) * per_feature + rem,
                (unsigned long long)sum);
  }
}

__global__ void node_hist_finalize(const long long* __restrict__ acc,
                                   float* __restrict__ H, long long n, int s,
                                   const float* __restrict__ smax) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool finite = true;
  for (int c = 0; c < s; ++c) finite &= isfinite(smax[c]);
  if (!finite) {
    H[i] = __int_as_float(0x7fc00000);  // NaN
    return;
  }
  H[i] = ldexpf(__ll2float_rn(acc[i]), -fixed_shift(smax[i % s]));
}

}  // namespace

// Shared memory bytes of one block of the launch below.
extern "C" long long node_histograms_smem_bytes(int d, int s, int nodes, int n_bins,
                                                int b_bytes, int group, int tile_rows,
                                                int stages) {
  return (long long)Layout(d, s, nodes, n_bins, b_bytes, group, tile_rows, stages).total;
}

// Launches the accumulation and the finalize pass on `stream`; returns
// cudaGetLastError() (0 on success). smax holds max|S[..., c]| of each of the
// s stats. acc (int64[T, d, nodes*n_bins, s]) must be zeroed by the caller;
// H is written whole. B must be 16-byte aligned.
// Allocates nothing and does not synchronise.
extern "C" int node_histograms_launch(const void* B, int b_bytes, const float* S,
                                      const int* pos, const int* feat,
                                      const int* n_feat, const float* smax,
                                      long long* acc, float* H, long long N, int d,
                                      int s, int T, int nodes, int n_bins, int group,
                                      int tile_rows, int stages, int row_blocks,
                                      int threads, void* stream) {
  const cudaStream_t cs = (cudaStream_t)stream;
  if (stages < 2 || stages > 5 || tile_rows % 16 || tile_rows > threads ||
      threads % 32 || threads < 32 * kIssuers || threads > kMaxThreads || group > threads)
    return (int)cudaErrorInvalidValue;
  const Layout L(d, s, nodes, n_bins, b_bytes, group, tile_rows, stages);
  const Args a{static_cast<const unsigned char*>(B), S, pos, feat, n_feat, smax,
               reinterpret_cast<unsigned long long*>(acc), N, d, s, T, nodes,
               n_bins, b_bytes, group, tile_rows, stages, row_blocks};
  const int groups = (d + group - 1) / group;
  const long long blocks = (long long)T * groups * row_blocks;
  if (s < 1 || s > kMaxStats || (b_bytes != 1 && b_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const int bs = (b_bytes == 4) * kMaxStats + s - 1;
  void (*const kernels[])(Args) = {
      node_hist_kernel<uint8_t, 1>, node_hist_kernel<uint8_t, 2>,
      node_hist_kernel<uint8_t, 3>, node_hist_kernel<uint8_t, 4>,
      node_hist_kernel<int, 1>,     node_hist_kernel<int, 2>,
      node_hist_kernel<int, 3>,     node_hist_kernel<int, 4>};
  cudaError_t e = cudaFuncSetAttribute(
      kernels[bs], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  kernels[bs]<<<(unsigned)blocks, threads, L.total, cs>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)T * d * nodes * n_bins * s;
  node_hist_finalize<<<(unsigned)((n + 255) / 256), 256, 0, cs>>>(
      acc, H, n, s, smax);
  return (int)cudaGetLastError();
}

extern "C" const char* node_histograms_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
