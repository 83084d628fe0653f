// Deterministic segment sums of sorted rows, and the touched-row update of
// the hashed embedding built on them, for Hopper (sm_90a).
//
// No TPU kernel maps to these. They replace XLA code of the JAX package's
// orange3_spark_tpu/optim/sparse.py: the segment sum _segment_sums (a
// jax.ops.segment_sum, which PyTorch would run as an index_add_ adding with
// float atomics in an order that changes from run to run) and, after the
// sort, the rest of the 'sort' lowering of sparse_embedding_update
// (:477-511: gather, segment sum, lazy decay, rule, write-back).
//
// seg_sum_tiles (segment_sum_sorted):
//
//   out[j, c] = sum of g[i, c] over the rows i with seg[i] == j
//
//   g     f32[M, k]      per-occurrence gradients in stable-sorted order
//   seg   i32 or i64[M]  segment of each row, non-decreasing from 0
//   skip_last  u8[1]     optional: when nonzero the last segment (the dead
//                        sentinel's, which sorts last) is not summed; its
//                        slot holds +0.0 (nothing reads it)
//   out   f32[n_slots, k]; a slot with no row holds +0.0; segments at or
//         past n_slots are dropped
//
// seg_update_tiles (segment_update_sorted): for each segment of the sorted
// keys whose key r is a live table row (r < D; the dead sentinel D sorts
// last), its gradient sum G = sum of dl[order[i] / C] over its rows, then
// in place p = emb[r] * decay^(step + 1 - t[r]) (with use_decay), the rule
// (sgd, adagrad on acc, ftrl on z and n) and t[r] = step + 1. Each table
// row belongs to one segment, so each row is read and written by one
// thread and no two threads write one address. Untouched rows are not read.
//
// Order of the adds (both kernels, the same device code). No float
// atomics: every sum is taken in an order fixed by the data alone, so two
// launches on the same inputs give the same bits.
// * A segment of at most kWalkMax rows is summed by one thread, over its
//   rows in sorted order from +0.0. The sort is stable, so that is the
//   occurrence order, the order in which the plain version (index_add_ on
//   the CPU) adds: these sums are bitwise the CPU's.
// * A longer segment (a heavy hitter of a click log) goes on a list (an
//   integer atomic gives the list slot; the list's order does not matter),
//   and the last block of the grid to finish its tiles (a completion
//   counter says which) sums each listed segment with its kThreads
//   threads: thread t adds rows t, t + kThreads, ... in order from +0.0,
//   then a fixed tree in shared memory adds the kThreads partials
//   (block_sum). Deterministic, and the same in both kernels, but within
//   float32 rounding of the CPU's order. No second launch: the host cannot
//   know whether a long segment exists without waiting for the device,
//   and a captured graph may not wait.
//
// Layout. A persistent grid (as many blocks as fit on the SMs) walks tiles
// of T rows. A tile's ids (seg, or the sorted keys) and its payload (g, or
// the sort order) come into shared memory by cp.async, 16 bytes a thread
// where the source is 16-byte aligned, double-buffered: the next tile
// loads while this one is worked. The ids buffer holds kPre rows before
// the tile (the id of the row before its first row) and kHalo after it, the
// payload kWalkMax rows after it, so a segment that starts in the tile and
// crosses its end is summed by this tile, in shared memory: no dependent
// global loads. In a tile, each thread flags the segment heads among its
// contiguous rows, a block scan lists the heads in row order, and one
// warp finds the first head past the tile; a head's segment then ends at
// the next listed head. Consecutive threads take consecutive heads, so a
// warp's lanes all work, and their writes to out (or to the table rows,
// which the sort orders) fall in a few sectors.
//
// The epilogue of the update repeats the plain version's float32 ops one
// by one: each op rounds with __f*_rn (never contracted into an FMA), and
// powf / rsqrtf / sqrtf / fmaxf are the functions PyTorch's CUDA ops call
// (a tensor over a Python float divides by multiplying with the float
// reciprocal there, as inv_lr does here), so it gives the bits of the
// chain it replaces.
//
// What bounds them: the bytes. At the Criteo step (M = 6,815,744, k = 1):
// seg_sum_tiles, at the dense table gradient's inputs (i32 ids, 4,194,304
// slots), reads g (27.3 MB) and the ids (27.3 MB) and writes out (16.8 MB):
// 71.3 MB, 0.021 ms at 3.35 TB/s. seg_update_tiles reads the i32 keys
// (27.3 MB), the i64 order (54.5 MB) and dl (1.05 MB), and reads and writes
// emb, acc and t of the ~2.5M live rows (60 MB): ~143 MB, 0.043 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;        // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kWalkMax = 32;         // rows a thread sums alone
constexpr int kPre = 4;              // ids loaded before a tile (16-byte aligned start)
constexpr int kHalo = 36;            // ids after a tile: kWalkMax + 1, rounded up to 4
constexpr int kBufferBytes = 24 * 1024;   // shared bytes a tile buffer aims at (two a block)
constexpr int kMaxTile = 2048;            // rows a tile at most (its head list is u16)
constexpr int kBlocksPerSm = 4;           // blocks an SM holds (53 KB shared, <= 64 registers)
constexpr int kBatch = 2;                 // heads a thread of the update takes at once

enum Rule { kSgd = 0, kAdagrad = 1, kFtrl = 2 };

// ---------------------------------------------------------------- loading
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies nbytes (a multiple of 4) from global src to shared dst (16-byte
// aligned) with cp.async: 16 bytes a thread where src is 16-byte aligned
// (a ragged last chunk reads only its bytes and zero-fills the rest), else
// 4 bytes a thread.
__device__ __forceinline__ void copy_async(char* dst, const char* src, long long nbytes) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (long long o = threadIdx.x * 16LL; o < nbytes; o += kThreads * 16LL) {
      const int n = nbytes - o < 16 ? static_cast<int>(nbytes - o) : 16;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_u32(dst + o)), "l"(src + o), "r"(n) : "memory");
    }
  } else {
    for (long long o = threadIdx.x * 4LL; o < nbytes; o += kThreads * 4LL)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(smem_u32(dst + o)), "l"(src + o) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The tiles: ids (IdT) and a payload row (pay_bytes) per sorted row. A
// buffer holds ids of rows [r0 - kPre, r0 + T + kHalo) and payload rows
// [r0, r0 + T + kWalkMax), each a multiple of 16 bytes.
template <class IdT>
struct Tiles {
  const IdT* ids;
  const void* pay;
  int pay_bytes;
  long long M;
  int T;
  __device__ int ids_buffer_bytes() const { return (kPre + T + kHalo) * sizeof(IdT); }
  __device__ int buffer_bytes() const { return ids_buffer_bytes() + (T + kWalkMax) * pay_bytes; }
  __device__ long long count() const { return (M + T - 1) / T; }

  __device__ void load(long long tile, char* buf) const {
    const long long r0 = tile * T;
    const long long lo = r0 - kPre > 0 ? r0 - kPre : 0;
    const long long hi = r0 + T + kHalo < M ? r0 + T + kHalo : M;
    copy_async(buf + (lo - (r0 - kPre)) * sizeof(IdT),
               reinterpret_cast<const char*>(ids + lo), (hi - lo) * sizeof(IdT));
    const long long phi = r0 + T + kWalkMax < M ? r0 + T + kWalkMax : M;
    copy_async(buf + ids_buffer_bytes(), static_cast<const char*>(pay) + r0 * pay_bytes,
               (phi - r0) * pay_bytes);
  }
};

// The ids of a tile's buffer by tile-local row (-kPre .. T + kHalo - kPre - 1).
template <class IdT>
__device__ __forceinline__ const IdT* tile_ids(const char* buf) {
  return reinterpret_cast<const IdT*>(buf) + kPre;
}

// The segments that start in a tile, by their first rows: head h starts
// at tile-local row j(h) and has len(h) rows (1 .. kWalkMax, or kWalkMax + 1
// for a longer segment).
struct TileHeads {
  const char* buf;
  long long r0;                    // the tile's first row
  const unsigned short* list;      // tile-local rows of the heads, ascending
  int n;
  int end;                         // where the tile's last segment ends
  __device__ int j(int h) const { return list[h]; }
  __device__ int len(int h) const {
    const int l = (h + 1 < n ? list[h + 1] : end) - list[h];
    return l > kWalkMax ? kWalkMax + 1 : l;
  }
};

// Works the tiles, double-buffered: the block's first tile is its index,
// each next one comes from the tile counter *next (blocks that finish early
// take more). Calls prologue() once the first tile's copies are in flight,
// then work(TileHeads) once a tile, its buffer in shared memory until the
// call returns.
//
// A tile's heads are listed in row order: warp w flags rows w·32·R + 32·i
// + lane (i < R = T / kThreads; neighbouring lanes read neighbouring ids,
// no bank conflicts), a ballot a row band, and a scan of the warps' counts
// gives each warp its place in the list. One warp finds the first head in
// the kWalkMax rows past the tile, where the tile's last segment ends.
template <class IdT, class Prologue, class Work>
__device__ __forceinline__ void walk_tiles(const Tiles<IdT>& tl, char* smem, int* next,
                                           Prologue prologue, Work work) {
  constexpr int kBands = kMaxTile / kThreads;
  __shared__ unsigned short heads[kMaxTile];
  __shared__ int warp_base[kWarps + 1];
  __shared__ long long tiles[2];
  __shared__ int tile_end;
  const long long n_tiles = tl.count();
  const int bb = tl.buffer_bytes();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bands = (tl.T + kThreads - 1) / kThreads;
  if (threadIdx.x == 0) tiles[0] = blockIdx.x;
  __syncthreads();
  if (tiles[0] < n_tiles) tl.load(tiles[0], smem);
  cp_async_commit();
  prologue();
  for (int b = 0; tiles[b] < n_tiles; b ^= 1) {
    const long long tile = tiles[b];
    const char* buf = smem + b * bb;
    if (threadIdx.x == 0) tiles[b ^ 1] = gridDim.x + atomicAdd(next, 1);
    __syncthreads();
    if (tiles[b ^ 1] < n_tiles) tl.load(tiles[b ^ 1], smem + (b ^ 1) * bb);
    cp_async_commit();
    cp_async_wait<1>();          // this tile's copies (all but the newest group)
    __syncthreads();
    const long long r0 = tile * tl.T;
    const IdT* id = tile_ids<IdT>(buf);
    const int rows = tl.M - r0 < tl.T ? static_cast<int>(tl.M - r0) : tl.T;
    const int base = warp * 32 * bands;
    unsigned masks[kBands];
    int count = 0;
#pragma unroll
    for (int i = 0; i < kBands; ++i) {
      const int j = base + 32 * i + lane;
      const bool h = i < bands && j < rows && (r0 + j == 0 || id[j] != id[j - 1]);
      masks[i] = __ballot_sync(0xffffffffu, h);
      count += __popc(masks[i]);
    }
    if (warp == 0) {   // where the last segment ends: the first head past the tile
      const int j = tl.T + lane;
      const unsigned m = __ballot_sync(0xffffffffu, r0 + j >= tl.M || id[j] != id[j - 1]);
      if (lane == 0) tile_end = rows < tl.T ? rows : m ? tl.T + __ffs(m) - 1 : tl.T + kWalkMax;
    }
    if (lane == 0) warp_base[warp + 1] = count;
    __syncthreads();
    if (threadIdx.x == 0) {
      warp_base[0] = 0;
      for (int w = 1; w <= kWarps; ++w) warp_base[w] += warp_base[w - 1];
    }
    __syncthreads();
    int pos = warp_base[warp];
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int i = 0; i < kBands; ++i) {
      if (masks[i] >> lane & 1u)
        heads[pos + __popc(masks[i] & below)] = static_cast<unsigned short>(base + 32 * i + lane);
      pos += __popc(masks[i]);
    }
    __syncthreads();
    work(TileHeads{buf, r0, heads, warp_base[kWarps], tile_end});
    __syncthreads();             // the buffer and the list are refilled next iteration
  }
  cp_async_wait<0>();
}

// True in the last block of the grid to get here (every other block's
// writes, the long-segment list among them, are visible to it).
__device__ __forceinline__ bool last_block_done(int* done) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The sum of a long segment (first row `start`, id s) by the whole block:
// thread t adds rows start + t, start + t + kThreads, ... in order from
// +0.0, then a fixed tree adds the partials. val(i) is row i's value.
template <class IdT, class Val>
__device__ __forceinline__ float block_sum(const IdT* ids, long long M, long long start, IdT s,
                                           Val val, float* part) {
  float acc = 0.0f;
  // rows are sorted: the first row past the segment ends this thread's rows
  for (long long i = start + threadIdx.x; i < M; i += kThreads) {
    if (ids[i] != s) break;
    acc = __fadd_rn(acc, val(i));
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] = __fadd_rn(part[threadIdx.x], part[threadIdx.x + w]);
    __syncthreads();
  }
  const float total = part[0];
  __syncthreads();
  return total;
}

// In-order sum from +0.0 of n (<= kWalkMax) values val(0..n-1), loads
// issued four at a time ahead of their adds.
template <class Val>
__device__ __forceinline__ float walk_sum(int n, Val val) {
  float acc = 0.0f;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    const float v0 = val(i), v1 = val(i + 1), v2 = val(i + 2), v3 = val(i + 3);
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v0), v1), v2), v3);
  }
  for (; i < n; ++i) acc = __fadd_rn(acc, val(i));
  return acc;
}

// ------------------------------------------------------ seg_sum_tiles
template <class IdT>
struct SumArgs {
  Tiles<IdT> tl;                   // ids: seg; payload: g rows (k floats)
  const unsigned char* skip_last;  // null: every segment is summed
  int k;
  long long n_slots;
  float* out;
  long long* long_starts;          // first row of each long segment
  int* counters;                   // [entries of long_starts, blocks done, tiles taken]
};

// kK: the columns when 1, else 0 (a.k columns)
template <class IdT, int kK>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) seg_sum_tiles(SumArgs<IdT> a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float part[kThreads];
  const Tiles<IdT>& tl = a.tl;
  const int k = kK ? kK : a.k;
  const long long last = tl.ids[tl.M - 1];
  const bool skip = a.skip_last != nullptr && *a.skip_last != 0;

  walk_tiles(
      tl, smem, a.counters + 2,
      [&]() {   // the slots past the last segment: no head writes them
        for (long long e = (last + 1) * k + blockIdx.x * static_cast<long long>(kThreads) +
                           threadIdx.x;
             e < a.n_slots * k; e += static_cast<long long>(gridDim.x) * kThreads)
          a.out[e] = 0.0f;
      },
      [&](const TileHeads& th) {
        const IdT* id = tile_ids<IdT>(th.buf);
        const float* gs = reinterpret_cast<const float*>(th.buf + tl.ids_buffer_bytes());
        for (int h = threadIdx.x; h < th.n; h += kThreads) {
          const int j = th.j(h), len = th.len(h);
          const long long row = th.r0 + j;
          const IdT s = id[j];
          // the empty slots before it
          const long long prev = row == 0 ? -1 : static_cast<long long>(id[j - 1]);
          for (long long e = (prev + 1) * k; e < s * static_cast<long long>(k) &&
                                             e < a.n_slots * k; ++e)
            a.out[e] = 0.0f;
          if (s >= a.n_slots) continue;          // the caller's slots end before it
          const long long o = static_cast<long long>(s) * k;
          if (skip && s == last) {               // the dead segment: never read
            for (int c = 0; c < k; ++c) a.out[o + c] = 0.0f;
            continue;
          }
          if (len > kWalkMax) {
            a.long_starts[atomicAdd(a.counters, 1)] = row;
            continue;
          }
          for (int c = 0; c < k; ++c)
            a.out[o + c] = walk_sum(len, [&](int i) { return gs[(j + i) * k + c]; });
        }
      });

  if (!last_block_done(a.counters + 1)) return;
  const float* g = static_cast<const float*>(tl.pay);
  const int n_long = __ldcg(a.counters);
  for (int e = 0; e < n_long; ++e) {
    const long long start = __ldcg(a.long_starts + e);
    const IdT s = tl.ids[start];
    for (int c = 0; c < k; ++c) {
      const float total = block_sum(tl.ids, tl.M, start, s,
                                    [&](long long i) { return g[i * k + c]; }, part);
      if (threadIdx.x == 0) a.out[static_cast<long long>(s) * k + c] = total;
    }
  }
}

// --------------------------------------------------- seg_update_tiles
struct UpdateArgs {
  Tiles<int> tl;                   // ids: the sorted keys; payload: the order (i64)
  // order[i] / C, the row of dl of occurrence i (C occurrences a row), as
  // a multiply and a shift: exact for order[i] < 2^31 (Granlund and
  // Montgomery 1994: m = floor(2^(31 + l) / C) + 1, l = ceil(log2 C))
  unsigned div_m;
  int div_shift;
  const float* dl;                 // f32[N, k]
  int k;
  long long D;                     // table rows; the dead sentinel's key
  float* emb;                      // f32[D, k]
  float* s0;                       // acc (adagrad) or z (ftrl)
  float* s1;                       // n (ftrl)
  int* t;                          // i32[D] last-seen steps
  const int* step;                 // the step counter (device scalar)
  float lr, inv_lr, decay, eps, beta, l1, two_reg;
  long long* long_starts;
  int* counters;
};

// Row r's update, the plain version's float32 ops in its order
// (optim/sparse.py, _touched_rows_update and apply_rule), one column at a
// time: load() the table entry and the rule's slots, then apply() the
// decay factor and the rule to them with the column's gradient sum g.
// Templated on the rule and the decay so the loads of a row are issued
// together, ahead of the sum that the stores wait for.
template <int kKind, bool kDecay>
struct RowUpdate {
  float p, u, v;                   // emb, acc or z, n

  __device__ __forceinline__ void load(const UpdateArgs& a, long long e) {
    p = a.emb[e];
    if (kKind != kSgd) u = a.s0[e];
    if (kKind == kFtrl) v = a.s1[e];
  }

  __device__ __forceinline__ void apply(const UpdateArgs& a, long long e, float fac, float g) {
    float q = p;
    if (kDecay) q = __fmul_rn(q, fac);
    if (kKind == kSgd) {
      q = __fsub_rn(q, __fmul_rn(a.lr, g));
    } else if (kKind == kAdagrad) {
      const float acc = __fadd_rn(u, __fmul_rn(g, g));
      q = __fsub_rn(q, __fmul_rn(__fmul_rn(a.lr, g), rsqrtf(__fadd_rn(acc, a.eps))));
      a.s0[e] = acc;
    } else {
      const float n = v, z = u;
      const float n2 = __fadd_rn(n, __fmul_rn(g, g));
      const float sigma = __fmul_rn(__fsub_rn(sqrtf(n2), sqrtf(n)), a.inv_lr);
      const float z2 = __fsub_rn(__fadd_rn(z, g), __fmul_rn(sigma, q));
      const float sign = static_cast<float>((0.0f < z2) - (z2 < 0.0f));
      float mag = __fsub_rn(fabsf(z2), a.l1);
      mag = isnan(mag) ? mag : fmaxf(mag, 0.0f);
      const float shrunk = __fmul_rn(sign, mag);
      const float den = __fadd_rn(__fmul_rn(__fadd_rn(sqrtf(n2), a.beta), a.inv_lr), a.two_reg);
      q = __fdiv_rn(-shrunk, den);
      a.s1[e] = n2;
      a.s0[e] = z2;
    }
    a.emb[e] = q;
  }
};

// decay^(step + 1 - t[r]) from the t[r] loaded: int32, wrapping as torch's
// int32 ops do, then rounded to float32 as .to(float32) does
__device__ __forceinline__ float decay_factor(const UpdateArgs& a, int step1, int t_r) {
  const int dt = static_cast<int>(static_cast<unsigned>(step1) - static_cast<unsigned>(t_r));
  return powf(a.decay, static_cast<float>(dt));
}

// The row of dl of the occurrence at sorted position i: order / C.
__device__ __forceinline__ long long dl_row(const UpdateArgs& a, long long order) {
  return static_cast<long long>(
      static_cast<unsigned long long>(static_cast<unsigned>(order)) * a.div_m >> a.div_shift);
}

// Column c's gradient sum of a short segment: dl[order[i] / C] over its
// len rows (their sort order in shared memory), in order from +0.0.
__device__ __forceinline__ float column_sum(const UpdateArgs& a, const long long* order, int len,
                                            int c) {
  return walk_sum(len, [&](int i) { return __ldg(a.dl + dl_row(a, order[i]) * a.k + c); });
}

// Updates row r, whose column c has the gradient sum sums[c] (a long
// segment's): the decay, the rule, t[r] = step + 1.
template <int kKind, bool kDecay>
__device__ __forceinline__ void update_row(const UpdateArgs& a, long long r, int step1,
                                           const float* sums) {
  RowUpdate<kKind, kDecay> row;
  const float fac = kDecay ? decay_factor(a, step1, a.t[r]) : 1.0f;
  for (int c = 0; c < a.k; ++c) {
    row.load(a, r * a.k + c);
    row.apply(a, r * a.k + c, fac, sums[c]);
  }
  if (kDecay) a.t[r] = step1;
}

template <int kKind, bool kDecay>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) seg_update_tiles(UpdateArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float part[kThreads];
  const Tiles<int>& tl = a.tl;
  const int step1 = static_cast<int>(static_cast<unsigned>(*a.step) + 1u);

  walk_tiles(tl, smem, a.counters + 2, [] {}, [&](const TileHeads& th) {
    const int* id = tile_ids<int>(th.buf);
    const long long* order = reinterpret_cast<const long long*>(th.buf + tl.ids_buffer_bytes());
    // kBatch heads a thread at once: every row's loads are in flight before
    // the first of them is waited for
    for (int h0 = threadIdx.x; h0 < th.n; h0 += kBatch * kThreads) {
      RowUpdate<kKind, kDecay> row[kBatch];
      int j[kBatch], len[kBatch], s[kBatch], t_r[kBatch];
      bool live[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int h = h0 + b * kThreads;
        live[b] = false;
        if (h >= th.n) continue;
        j[b] = th.j(h);
        len[b] = th.len(h);
        s[b] = id[j[b]];
        if (s[b] >= a.D) continue;             // the dead sentinel: padding rows
        if (len[b] > kWalkMax) {
          a.long_starts[atomicAdd(a.counters, 1)] = th.r0 + j[b];   // the last block's
          continue;
        }
        live[b] = true;
        if (kDecay) t_r[b] = a.t[s[b]];
        row[b].load(a, static_cast<long long>(s[b]) * a.k);
      }
      float g0[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (live[b]) g0[b] = column_sum(a, order + j[b], len[b], 0);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (!live[b]) continue;
        const long long r = s[b];
        const float fac = kDecay ? decay_factor(a, step1, t_r[b]) : 1.0f;
        row[b].apply(a, r * a.k, fac, g0[b]);
        for (int c = 1; c < a.k; ++c) {
          row[b].load(a, r * a.k + c);
          row[b].apply(a, r * a.k + c, fac, column_sum(a, order + j[b], len[b], c));
        }
        if (kDecay) a.t[r] = step1;
      }
    }
  });

  if (!last_block_done(a.counters + 1)) return;
  float* sums = reinterpret_cast<float*>(smem);   // the tiles are done: k sums
  const long long* order = static_cast<const long long*>(tl.pay);
  const int n_long = __ldcg(a.counters);
  for (int e = 0; e < n_long; ++e) {
    const long long start = __ldcg(a.long_starts + e);
    const int s = tl.ids[start];
    for (int c = 0; c < a.k; ++c) {
      const float total = block_sum(tl.ids, tl.M, start, s, [&](long long i) {
        return a.dl[dl_row(a, order[i]) * a.k + c];
      }, part);
      if (threadIdx.x == 0) sums[c] = total;
    }
    if (threadIdx.x == 0) update_row<kKind, kDecay>(a, s, step1, sums);
    __syncthreads();
  }
}

// ------------------------------------------------------------- launching
// Rows a tile: as many as fit kBufferBytes (at most kMaxTile), a multiple
// of kThreads, else of 4; at least 4.
int tile_rows(int id_bytes, int pay_bytes) {
  const int fixed = (kPre + kHalo) * id_bytes + kWalkMax * pay_bytes;
  int t = (kBufferBytes - fixed) / (id_bytes + pay_bytes);
  if (t > kMaxTile) t = kMaxTile;
  if (t >= kThreads) return t / kThreads * kThreads;
  return t < 4 ? 4 : (t & ~3);
}

// Blocks of `kernel` an SM holds with `smem` dynamic shared bytes, on the
// current device, and the kernel's dynamic shared-memory limit raised to
// at least smem (beside the static head list a tile may need more than the
// default 48 KB). The limit only grows, so a launch planned before stays
// valid. Both are kept: the two runtime calls cost the host more than the
// launch. Past the tables' room a launch is planned anew each time.
int blocks_per_sm(const void* kernel, int smem, int* per_sm) {
  struct Limit { const void* kernel; int device, smem; };
  struct Plan { const void* kernel; int device, smem, per_sm; };
  constexpr int kRoom = 256;
  static Limit limits[kRoom];
  static Plan plans[kRoom];
  static int n_limits = 0, n_plans = 0;
  static std::mutex mu;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const std::lock_guard<std::mutex> hold(mu);
  for (int i = 0; i < n_plans; ++i)
    if (plans[i].kernel == kernel && plans[i].device == device && plans[i].smem == smem) {
      *per_sm = plans[i].per_sm;
      return 0;
    }
  Limit* limit = nullptr;
  for (int i = 0; i < n_limits && limit == nullptr; ++i)
    if (limits[i].kernel == kernel && limits[i].device == device) limit = &limits[i];
  if (limit == nullptr || limit->smem < smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (limit != nullptr) limit->smem = smem;
    else if (n_limits < kRoom) limits[n_limits++] = Limit{kernel, device, smem};
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_plans < kRoom) plans[n_plans++] = Plan{kernel, device, smem, *per_sm};
  return 0;
}

template <class Args>
int launch(void (*kernel)(Args), const Args& a, int id_bytes, int sms, int* counters,
           cudaStream_t cs) {
  const int T = a.tl.T;
  const int smem = 2 * ((kPre + T + kHalo) * id_bytes + (T + kWalkMax) * a.tl.pay_bytes);
  int per_sm = 0;
  const int err = blocks_per_sm(reinterpret_cast<const void*>(kernel), smem, &per_sm);
  if (err != 0) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (a.tl.M + T - 1) / T;
  const long long blocks = tiles < static_cast<long long>(per_sm) * sms
                               ? tiles : static_cast<long long>(per_sm) * sms;
  const cudaError_t e = cudaMemsetAsync(counters, 0, 3 * sizeof(int), cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, cs>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class IdT>
int launch_sum(const float* g, const void* seg, const unsigned char* skip_last, long long M,
               int k, long long n_slots, float* out, long long* long_starts, int* counters,
               int sms, cudaStream_t cs) {
  const int T = tile_rows(sizeof(IdT), 4 * k);
  const SumArgs<IdT> a{{static_cast<const IdT*>(seg), g, 4 * k, M, T}, skip_last, k,
                       n_slots, out, long_starts, counters};
  return launch(k == 1 ? seg_sum_tiles<IdT, 1> : seg_sum_tiles<IdT, 0>, a, sizeof(IdT), sms,
                counters, cs);
}

}  // namespace

// Rows past which a segment goes on the long list and is summed in the
// block order (the wrapper sizes the list from it: at most M / (kWalkMax +
// 1) entries).
extern "C" int segment_sum_walk_max() { return kWalkMax; }

// Launches seg_sum_tiles on `stream` (after zeroing the three counters);
// returns a cudaError_t (0 on success). long_starts holds at least
// M / (kWalkMax + 1) entries, counters three ints. out is written whole.
// Allocates nothing and does not synchronise.
extern "C" int segment_sum_sorted_launch(const float* g, const void* seg, int seg_bytes,
                                         const unsigned char* skip_last,
                                         long long M, int k, long long n_slots, float* out,
                                         long long* long_starts, int* counters, int sms,
                                         void* stream) {
  if (M < 1 || k < 1 || n_slots < 1 || (seg_bytes != 4 && seg_bytes != 8) || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return seg_bytes == 8
             ? launch_sum<long long>(g, seg, skip_last, M, k, n_slots, out, long_starts,
                                     counters, sms, cs)
             : launch_sum<int>(g, seg, skip_last, M, k, n_slots, out, long_starts, counters,
                               sms, cs);
}

// Launches seg_update_tiles on `stream`: the touched-row update of the
// sorted keys (i32[M], the dead sentinel D sorting last) and their sort
// order (i64[M]), in place on emb, the rule's slots and t. kind: 0 sgd, 1
// adagrad (s0 = acc), 2 ftrl (s0 = z, s1 = n). Allocates nothing and does
// not synchronise.
extern "C" int segment_update_sorted_launch(
    const int* keys, const long long* order, long long M, int C, const float* dl, int k,
    long long D, float* emb, float* s0, float* s1, int* t, const int* step, int kind,
    int use_decay, float lr, float inv_lr, float decay, float eps, float beta, float l1,
    float two_reg, long long* long_starts, int* counters, int sms, void* stream) {
  if (M < 1 || M > 0x7fffffffLL || C < 1 || k < 1 || D < 1 || kind < kSgd || kind > kFtrl ||
      sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = tile_rows(4, 8);
  int l = 0;
  while ((1LL << l) < C) ++l;
  const unsigned div_m = static_cast<unsigned>((1ULL << (31 + l)) / C + 1);   // < 2^32
  const UpdateArgs a{{keys, order, 8, M, T}, div_m, 31 + l, dl, k, D, emb, s0, s1, t, step, lr,
                     inv_lr, decay, eps, beta, l1, two_reg, long_starts, counters};
  void (*kernels[3][2])(UpdateArgs) = {
      {seg_update_tiles<kSgd, false>, seg_update_tiles<kSgd, true>},
      {seg_update_tiles<kAdagrad, false>, seg_update_tiles<kAdagrad, true>},
      {seg_update_tiles<kFtrl, false>, seg_update_tiles<kFtrl, true>}};
  return launch(kernels[kind][use_decay != 0], a, 4, sms, counters,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
