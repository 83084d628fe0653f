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
//   round_to   0, or 1 (bf16) / 2 (f16): each add's float32 result is
//         rounded to that type (to nearest even) before the next add, as a
//         sum held in that type adds (the table gradient of a fit whose
//         compute dtype is bf16 or f16); every segment, long ones too, is
//         then added by one thread in sorted order, so each sum is bitwise
//         the plain version's
//
// seg_update_tiles, then seg_update_ends (segment_update_sorted): for each
// segment of the sorted keys whose key r is a live table row (r < D; the
// dead sentinel D sorts last), its gradient sum G = sum of dl[order[i] /
// C] over its rows, then in place p = emb[r] * decay^(step + 1 - t[r])
// (with use_decay), the rule (sgd, adagrad on acc, ftrl on z and n) and
// t[r] = step + 1. With per-pair values (a value-weighted fit: vals f32[M]
// in the original occurrence order) each occurrence's gradient is
// dl[order[i] / C] * vals[order[i]], rounded once (__fmul_rn, as the plain
// version's multiply) before it joins the sum; the sum order is unchanged.
// Each table row belongs to one segment, so each row is read and written
// by one thread and no two threads write one address. Untouched rows are
// not read.
//
// Order of the adds (both, the same device code). No float atomics: every
// sum is taken in an order fixed by the data alone, so two launches on the
// same inputs give the same bits, in a captured graph too.
// * A segment of at most kWalkMax rows is summed by one thread, over its
//   rows in sorted order from +0.0. The sort is stable, so that is the
//   occurrence order, the order in which the plain version (index_add_ on
//   the CPU) adds: these sums are bitwise the CPU's.
// * A longer segment (a heavy hitter of a click log or a Zipf-law libsvm
//   draw) is spread over the whole card. The rows are cut into chunks of
//   32 at multiples of 32 of the row index (kChunk, a warp's lanes), so the
//   cut is the same whatever the tile: the two kernels' tiles differ (the
//   sum's shrinks with k), their bits must not. (1) The tile that holds a
//   chunk sums the chunk's rows of the segment with one warp: lane l holds
//   row 32c + l (+0.0 off the segment), then a fixed xor-shuffle tree
//   (warp_sum). A chunk holds at most two long segments, the one through
//   its first row (partial A) and one that starts past it and runs out of
//   the chunk (partial B). Then the tile publishes its word: 0 until then,
//   2 + the first row of its last segment when that starts in the tile,
//   else 1. (2) For each segment that ends in a tile, one warp finds its
//   first row (the tile's own, or by walking the words back to the tile
//   where it starts, 32 tiles a step) and adds its chunk partials: lane l
//   adds chunks c0 + l, c0 + l + 32, ... from +0.0 in order, and the same
//   tree adds the lanes. So the order depends on the segment's rows alone:
//   deterministic, within float32 summation's bound of a float64 sum, the
//   same in both kernels, but not the CPU's order. No host read: the host
//   cannot know whether a long segment exists without waiting for the
//   device, and a captured graph may not wait.
//   seg_sum_tiles takes step (2) in the tile where the segment ends,
//   waiting for the earlier tiles' words (always back to the head: no
//   prefix is picked by what happens to be published, which would make
//   the bits depend on timing). No deadlock: every tile, each block's first
//   included, is taken from an atomic counter, so a tile waits only on
//   tiles taken before it, by blocks that are running. The update lists
//   the segments (an integer atomic gives each its slot; the order decides
//   only which warp takes one) and seg_update_ends, a second launch issued
//   whatever the data, takes step (2) and the rule: compiled into
//   seg_update_tiles, that code alone slowed its short segments by a tenth
//   on the card (the whole kernel's registers and schedule), where the
//   launch costs about 2 microseconds.
//   The rounded sums (round_to) keep the serial order instead: long
//   segments go on a list, and the last block of the grid to finish its
//   tiles sums each listed one with one thread, in sorted order.
//
// Layout. A persistent grid (as many blocks as fit on the SMs) walks tiles
// of T rows (a multiple of kChunk). A tile's ids (seg, or the sorted keys)
// and its payload (g, or the sort order) come into shared memory by
// cp.async, 16 bytes a thread where the source is 16-byte aligned,
// double-buffered: the next tile loads while this one is worked. The ids
// buffer holds kPre rows before the tile (how far its first segment
// reaches back, up to kWalkMax + 1 rows) and kHalo after it, the payload
// kWalkMax rows after it, so a short segment that starts in the tile and
// crosses its end is summed by this tile, in shared memory: no dependent
// global loads. In a tile, each thread flags the segment heads among its
// contiguous rows, a block scan lists the heads in row order, and one warp
// finds the first head past the tile; a head's segment then ends at the
// next listed head. Consecutive threads take consecutive heads, so a
// warp's lanes all work, and their writes to out (or to the table rows,
// which the sort orders) fall in a few sectors. A tile's long segments
// are met on its short segments' pass (a head whose segment is longer) or
// from its first rows' segment; a tile with none skips steps (1) and (2)
// but its word. The scratch: the counters and a word a tile, then two
// partials a chunk and column (and the update's list), or the rounded
// sums' list.
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
// emb, acc and t of the ~2.5M live rows (60 MB): ~143 MB, 0.043 ms. With
// per-pair values it also reads one 4-byte value an occurrence, gathered
// through the order (27.3 MB more at that M). A long segment adds 8 bytes
// a chunk and column (a partial written and read back, from L2): 1/16 of
// its ids' and order's bytes at k = 1.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;        // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kWalkMax = 32;         // rows a thread sums alone
constexpr int kChunk = 32;           // rows of a long segment's partial (a warp's lanes)
constexpr int kPre = 36;             // ids loaded before a tile: kWalkMax + 1, rounded up to 4
constexpr int kHalo = 36;            // ids after a tile: kWalkMax + 1, rounded up to 4
constexpr int kBufferBytes = 24 * 1024;   // shared bytes a tile buffer aims at (two a block)
constexpr int kMaxTile = 2048;            // rows a tile at most (its head list is u16)
constexpr int kMaxChunks = kMaxTile / kChunk;
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

// What the long-segment path reads of a tile, in shared memory (read after
// the tile's short segments, so that none of it holds a register while
// their table rows load).
struct TileLong {
  long long tile, r0;              // the tile and its first row
  int rows;                        // its rows (T, or fewer in the last tile)
  int pre;                         // rows before the tile in its first row's segment
                                   // (capped at kWalkMax + 1)
  int long_heads;                  // 0 until a long segment's head in the tile is met
};

// A tile and the segments that start in it, by their first rows: head h
// starts at tile-local row j(h) and has len(h) rows (1 .. kWalkMax, or
// kWalkMax + 1 for a longer segment); chunk q (rows 32q .. 32q + 31) has
// the heads cmask[q] (bit l: row 32q + l), the first of them list[cpos[q]].
struct TileHeads {
  const char* buf;
  long long r0;                    // the tile's first row
  const unsigned short* list;      // tile-local rows of the heads, ascending
  int n;
  int end;                         // where the tile's last segment ends (capped at
                                   // T + kWalkMax when it runs further)
  const unsigned* cmask;
  const unsigned short* cpos;
  TileLong* lg;
  __device__ int j(int h) const { return list[h]; }
  __device__ int end_of(int h) const { return h + 1 < n ? list[h + 1] : end; }
  __device__ int len(int h) const {
    const int l = end_of(h) - list[h];
    return l > kWalkMax ? kWalkMax + 1 : l;
  }
  // the segment running in from before the tile (pre > 0): where it ends
  // in the tile, and whether it is longer than kWalkMax
  __device__ int in_end() const { return n > 0 ? list[0] : end; }
  __device__ bool in_long() const { return lg->pre > 0 && lg->pre + in_end() > kWalkMax; }
};

// Works the tiles, double-buffered: every tile, each block's first too,
// comes from the tile counter *next, so tiles are taken in order, by
// blocks that are running (blocks that finish early take more). Calls
// prologue() once the first tile's copies are in flight,
// then work(TileHeads) once a tile and, after a barrier, post(TileHeads),
// the tile's buffer in shared memory until that returns (the next barrier
// precedes its refill).
//
// A tile's heads are listed in row order: warp w flags rows w·32·R + 32·i
// + lane (i < R = T / kThreads; neighbouring lanes read neighbouring ids,
// no bank conflicts), a ballot a row band (chunk w·R + i), and a scan of
// the warps' counts gives each warp its place in the list. Warp 0 finds
// the first head in the kWalkMax rows past the tile, where the tile's last
// segment ends; warp 1 counts the rows before the tile in its first row's
// segment.
template <class IdT, class Prologue, class Work, class Post>
__device__ __forceinline__ void walk_tiles(const Tiles<IdT>& tl, char* smem, int* next,
                                           Prologue prologue, Work work, Post post) {
  constexpr int kBands = kMaxTile / kThreads;
  __shared__ unsigned short heads[kMaxTile];
  __shared__ unsigned chunk_mask[kMaxChunks];
  __shared__ unsigned short chunk_pos[kMaxChunks];
  __shared__ int warp_base[kWarps + 1];
  __shared__ long long tiles[2];
  __shared__ int tile_end;
  __shared__ TileLong tile_long;
  const long long n_tiles = tl.count();
  const int bb = tl.buffer_bytes();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bands = (tl.T + kThreads - 1) / kThreads;
  if (threadIdx.x == 0) tiles[0] = atomicAdd(next, 1);
  __syncthreads();
  if (tiles[0] < n_tiles) tl.load(tiles[0], smem);
  cp_async_commit();
  prologue();
  for (int b = 0; tiles[b] < n_tiles; b ^= 1) {
    const long long tile = tiles[b];
    const char* buf = smem + b * bb;
    if (threadIdx.x == 0) tiles[b ^ 1] = atomicAdd(next, 1);
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
    } else if (warp == 1) {   // rows -32 .. -1 that continue row 0's segment
      const int j = lane - 32;
      const unsigned m = __ballot_sync(0xffffffffu, r0 + j < 0 || id[j] != id[0]);
      if (lane == 0)
        tile_long.pre = m ? __clz(m) : r0 >= kWalkMax + 1 && id[-kWalkMax - 1] == id[0]
                                       ? kWalkMax + 1 : kWalkMax;
    }
    if (lane == 0) warp_base[warp + 1] = count;
    __syncthreads();
    if (threadIdx.x == 0) {
      warp_base[0] = 0;
      for (int w = 1; w <= kWarps; ++w) warp_base[w] += warp_base[w - 1];
      tile_long.tile = tile;
      tile_long.r0 = r0;
      tile_long.rows = rows;
      tile_long.long_heads = 0;
    }
    __syncthreads();
    int pos = warp_base[warp];
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int i = 0; i < kBands; ++i) {
      if (masks[i] >> lane & 1u)
        heads[pos + __popc(masks[i] & below)] = static_cast<unsigned short>(base + 32 * i + lane);
      if (lane == 0 && i < bands) {
        chunk_mask[warp * bands + i] = masks[i];
        chunk_pos[warp * bands + i] = static_cast<unsigned short>(pos);
      }
      pos += __popc(masks[i]);
    }
    __syncthreads();
    const TileHeads th{buf, r0, heads, warp_base[kWarps], tile_end, chunk_mask, chunk_pos,
                       &tile_long};
    work(th);
    __syncthreads();
    post(th);                    // the buffer and the list are refilled after the next barrier
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

// ------------------------------------------------------- long segments
// The sum of v over the warp's lanes, in a fixed tree (every lane gets the
// same bits: a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" :: "l"(p), "l"(v) : "memory");
}

// A long segment that ends in a tile: its first row when that tile holds
// it, else -1; one past its last row.
struct LongEnd {
  long long first, end;
};

// The scratch of the long segments: a word a tile (0 until the tile is
// published, then 2 + the first row of its last segment when that starts
// in the tile, else 1), partials [chunk][A, B][column], and the update's
// list of long segments by their ends (*n_ends of them).
struct LongPart {
  unsigned long long* words;
  float* part;
  LongEnd* ends;
  int* n_ends;
  __device__ float* at(long long chunk, int slot, int k, int c) const {
    return part + (chunk * 2 + slot) * k + c;
  }
};

// Step (1) in the tile th, once its short segments are done (they set
// th.lg->long_heads on meeting the head of a long segment that summed()
// admits) and the block has met at a barrier: when a long segment touches
// the tile, the partials of its chunks' rows of every such segment, warp
// w taking chunks w, w + kWarps, ... (val(j, c) is tile row j's value in
// column c), lane 0 calling on_end(first row or -1, one past the last) for
// each that ends in the tile (by the chunk of its head; the one running in
// from before the tile by chunk 0), then, once every thread of the block
// has written its partials, a fence; in every tile the word, last: the
// tile is published. A tile without a long segment meets at no barrier
// more, and its word is read for its value alone.
template <class IdT, class Summed, class Val, class OnEnd>
__device__ __forceinline__ void long_partials(const TileHeads& th, const IdT* id, int k,
                                              const LongPart& lp, Summed summed, Val val,
                                              OnEnd on_end) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = th.lg->r0;
  if (th.lg->long_heads || (th.in_long() && summed(id[0]))) {
    const int rows = th.lg->rows;
    const int n_chunks = (rows + kChunk - 1) / kChunk;
    for (int q = warp; q < n_chunks; q += kWarps) {
      const int j0 = q * kChunk;
      const int lim = rows - j0 < kChunk ? rows - j0 : kChunk;
      const unsigned m = th.cmask[q];
      const int pos = th.cpos[q];
      const unsigned later = m & ~1u;
      // the segment through the chunk's first row: its head here (m & 1),
      // in an earlier chunk of the tile, or before the tile
      const int f_end = later ? __ffs(later) - 1 : lim;
      bool f_long = (m & 1u) ? th.len(pos) > kWalkMax
                    : pos > 0 ? th.len(pos - 1) > kWalkMax : th.in_long();
      f_long = f_long && summed(id[j0]);
      // the segment of the chunk's last head, when that is past its first row
      const int hl = pos + __popc(m) - 1;
      const int l_start = later ? 31 - __clz(m) : kChunk;
      const bool l_long = later && th.len(hl) > kWalkMax && summed(id[j0 + l_start]);
      if (!f_long && !l_long) continue;
      const bool in_f = f_long && lane < f_end, in_l = l_long && lane >= l_start && lane < lim;
      const long long chunk = r0 / kChunk + q;
      for (int c = 0; c < k; ++c) {
        const float x = in_f || in_l ? val(j0 + lane, c) : 0.0f;
        const float pf = warp_sum(in_f ? x : 0.0f), pl = warp_sum(in_l ? x : 0.0f);
        if (lane == 0) {
          if (f_long) *lp.at(chunk, 0, k, c) = pf;
          if (l_long) *lp.at(chunk, 1, k, c) = pl;
        }
      }
      if (lane != 0) continue;
      if (f_long && ((m & 1u) || q == 0)) {
        const int e = (m & 1u) ? th.end_of(pos) : th.in_end();
        if (e <= rows) on_end((m & 1u) ? r0 + j0 : -1LL, r0 + e);
      }
      if (l_long && th.end_of(hl) <= rows) on_end(r0 + j0 + l_start, r0 + th.end_of(hl));
    }
    __syncthreads();
    if (threadIdx.x == 0) __threadfence();
  }
  if (threadIdx.x == 0)
    store_relaxed(lp.words + th.lg->tile,
                  th.n > 0 ? static_cast<unsigned long long>(r0 + th.j(th.n - 1) + 2) : 1ULL);
}

// The first row of the segment running into tile `tile` from before it,
// by the whole warp: lane l waits for the word of tile tile - 1 - l, 32
// tiles a step, back to the tile where the segment starts (tile 0 always
// holds a head); every tile between is published when it returns. In the
// sum's tile walk that waits on tiles taken before this one, by running
// blocks, so the lowest unpublished tile never waits; in the update's
// second launch every word is written already.
__device__ __forceinline__ long long segment_head(const LongPart& lp, long long tile) {
  const int lane = threadIdx.x & 31;
  for (long long t = tile - 1 - lane;; t -= 32) {
    long long head = -1;
    if (t >= 0) {
      unsigned long long w;
      while ((w = load_acquire(lp.words + t)) == 0) __nanosleep(64);
      head = static_cast<long long>(w) - 2;
    }
    __threadfence();
    const unsigned found = __ballot_sync(0xffffffffu, head >= 0);
    if (found) return __shfl_sync(0xffffffffu, head, __ffs(found) - 1);
  }
}

// Step (2): column c's sum of the segment of rows [s, e) from its chunk
// partials, by the whole warp (every lane gets it).
__device__ __forceinline__ float segment_total(const LongPart& lp, long long s, long long e, int k,
                                               int c) {
  const int lane = threadIdx.x & 31;
  const long long c0 = s / kChunk, c1 = (e - 1) / kChunk;
  float acc = 0.0f;
  long long q = c0 + lane;
  if (q == c0 && s % kChunk != 0) {   // the head's chunk: the rows past its first
    acc = __fadd_rn(acc, __ldcg(lp.at(q, 1, k, c)));
    q += 32;
  }
  for (; q + 96 <= c1; q += 128) {
    const float v0 = __ldcg(lp.at(q, 0, k, c)), v1 = __ldcg(lp.at(q + 32, 0, k, c)),
                v2 = __ldcg(lp.at(q + 64, 0, k, c)), v3 = __ldcg(lp.at(q + 96, 0, k, c));
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v0), v1), v2), v3);
  }
  for (; q <= c1; q += 32) acc = __fadd_rn(acc, __ldcg(lp.at(q, 0, k, c)));
  return warp_sum(acc);
}

// a + b in float32, then rounded to the sum's type: kRound 0 float32, 1
// bf16, 2 f16 (to nearest even; widening back is exact)
template <int kRound>
__device__ __forceinline__ float add_round(float a, float b) {
  const float s = __fadd_rn(a, b);
  if constexpr (kRound == 1) return __bfloat162float(__float2bfloat16_rn(s));
  if constexpr (kRound == 2) return __half2float(__float2half_rn(s));
  return s;
}

// In-order sum from +0.0 of n values val(0..n-1) (n <= kWalkMax in the
// tiles; an int there, a long long for a long segment's rounded sum),
// loads issued four at a time ahead of their adds.
template <int kRound = 0, class N, class Val>
__device__ __forceinline__ float walk_sum(N n, Val val) {
  float acc = 0.0f;
  N i = 0;
  for (; i + 4 <= n; i += 4) {
    const float v0 = val(i), v1 = val(i + 1), v2 = val(i + 2), v3 = val(i + 3);
    acc = add_round<kRound>(add_round<kRound>(add_round<kRound>(add_round<kRound>(acc, v0),
                                                                v1), v2), v3);
  }
  for (; i < n; ++i) acc = add_round<kRound>(acc, val(i));
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
  int* counters;                   // [list entries, blocks done, tiles taken]
  LongPart lp;                     // float sums
  long long* long_starts;          // rounded sums: first row of each long segment
};

// kK: the columns when 1, else 0 (a.k columns); kRound: add_round's
template <class IdT, int kK, int kRound>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) seg_sum_tiles(SumArgs<IdT> a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ LongEnd ends[kWarps][2 * kMaxChunks / kWarps];   // a warp's, a tile
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
          if (len > kWalkMax) {                  // spread over the card, or listed
            if constexpr (kRound != 0) a.long_starts[atomicAdd(a.counters, 1)] = row;
            else th.lg->long_heads = 1;
            continue;
          }
          for (int c = 0; c < k; ++c)
            a.out[o + c] = walk_sum<kRound>(len, [&](int i) { return gs[(j + i) * k + c]; });
        }
      },
      [&](const TileHeads& th) {   // the long segments (float sums): steps (1) and (2)
        if constexpr (kRound == 0) {
          const IdT* id = tile_ids<IdT>(th.buf);
          const float* gs = reinterpret_cast<const float*>(th.buf + tl.ids_buffer_bytes());
          const int warp = threadIdx.x >> 5;
          int n_ends = 0;
          long_partials(th, id, k, a.lp,
                        [&](IdT s) { return s < a.n_slots && !(skip && s == last); },
                        [&](int j, int c) { return gs[j * k + c]; },
                        [&](long long s, long long e) { ends[warp][n_ends++] = LongEnd{s, e}; });
          n_ends = __shfl_sync(0xffffffffu, n_ends, 0);
          for (int i = 0; i < n_ends; ++i) {   // those ending here: a warp each
            const LongEnd en = ends[warp][i];
            const long long s = en.first >= 0 ? en.first : segment_head(a.lp, th.lg->tile);
            const long long o = static_cast<long long>(id[en.end - 1 - th.lg->r0]) * k;
            for (int c = 0; c < k; ++c) {
              const float total = segment_total(a.lp, s, en.end, k, c);
              if ((threadIdx.x & 31) == 0) a.out[o + c] = total;
            }
          }
        }
      });

  if constexpr (kRound != 0) {
    // rounded sums: a thread a long segment, its rows in sorted order
    if (!last_block_done(a.counters + 1)) return;
    const float* g = static_cast<const float*>(tl.pay);
    const int n_long = __ldcg(a.counters);
    for (int e = threadIdx.x; e < n_long; e += kThreads) {
      const long long start = __ldcg(a.long_starts + e);
      const IdT s = tl.ids[start];
      long long end = start + kWalkMax;
      while (end < tl.M && tl.ids[end] == s) ++end;
      for (int c = 0; c < k; ++c)
        a.out[static_cast<long long>(s) * k + c] =
            walk_sum<kRound>(end - start, [&](long long i) { return g[(start + i) * k + c]; });
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
  const float* vals;               // f32[M] per-pair values, or null
  int k;
  long long D;                     // table rows; the dead sentinel's key
  float* emb;                      // f32[D, k]
  float* s0;                       // acc (adagrad) or z (ftrl)
  float* s1;                       // n (ftrl)
  int* t;                          // i32[D] last-seen steps
  const int* step;                 // the step counter (device scalar)
  float lr, inv_lr, decay, eps, beta, l1, two_reg;
  int* counters;                   // [list entries, unused, tiles taken]
  LongPart lp;
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

// The gradient of occurrence `order` (its index in the original order) in
// column c: dl[order / C], times vals[order] with per-pair values.
template <bool kVals>
__device__ __forceinline__ float occurrence_grad(const UpdateArgs& a, long long order, int c) {
  const float g = __ldg(a.dl + dl_row(a, order) * a.k + c);
  return kVals ? __fmul_rn(g, __ldg(a.vals + order)) : g;
}

// Column c's gradient sum of a short segment: the gradients of its len
// rows (their sort order in shared memory), in order from +0.0.
template <bool kVals>
__device__ __forceinline__ float column_sum(const UpdateArgs& a, const long long* order, int len,
                                            int c) {
  return walk_sum(len, [&](int i) { return occurrence_grad<kVals>(a, order[i], c); });
}

template <int kKind, bool kDecay, bool kVals>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) seg_update_tiles(UpdateArgs a) {
  extern __shared__ __align__(16) char smem[];
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
        if (len[b] > kWalkMax) {               // spread over the card
          th.lg->long_heads = 1;
          continue;
        }
        live[b] = true;
        if (kDecay) t_r[b] = a.t[s[b]];
        row[b].load(a, static_cast<long long>(s[b]) * a.k);
      }
      float g0[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (live[b]) g0[b] = column_sum<kVals>(a, order + j[b], len[b], 0);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (!live[b]) continue;
        const long long r = s[b];
        const float fac = kDecay ? decay_factor(a, step1, t_r[b]) : 1.0f;
        row[b].apply(a, r * a.k, fac, g0[b]);
        for (int c = 1; c < a.k; ++c) {
          row[b].load(a, r * a.k + c);
          row[b].apply(a, r * a.k + c, fac, column_sum<kVals>(a, order + j[b], len[b], c));
        }
        if (kDecay) a.t[r] = step1;
      }
    }
  }, [&](const TileHeads& th) {   // the long segments: step (1), and the list
    const long long* order = reinterpret_cast<const long long*>(th.buf + tl.ids_buffer_bytes());
    long_partials(th, tile_ids<int>(th.buf), a.k, a.lp, [&](int s) { return s < a.D; },
                  [&](int j, int c) { return occurrence_grad<kVals>(a, order[j], c); },
                  [&](long long s, long long e) {
                    a.lp.ends[atomicAdd(a.lp.n_ends, 1)] = LongEnd{s, e};
                  });
  });
}

// Step (2) of the update, a second launch issued whatever the data: the
// long segments seg_update_tiles listed (none on most data: the launch
// then reads the count and ends), a warp each, in any order (each is its
// own): its first row when not listed, its sums, then the decay and the
// rule on its row and t[r] = step + 1 by lane 0. Apart because compiled
// into seg_update_tiles this code alone slowed its short segments by a
// tenth on the card (the whole kernel's registers and schedule), where the
// launch costs about 2 microseconds.
template <int kKind, bool kDecay>
__global__ void __launch_bounds__(kThreads) seg_update_ends(UpdateArgs a) {
  const int step1 = static_cast<int>(static_cast<unsigned>(*a.step) + 1u);
  const int n = __ldcg(a.lp.n_ends);
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long i = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32; i < n;
       i += warps) {
    const LongEnd en = a.lp.ends[i];
    const long long e = en.end;
    const long long s = en.first >= 0 ? en.first : segment_head(a.lp, (e - 1) / a.tl.T);
    const long long r = a.tl.ids[e - 1];
    const float fac = kDecay ? decay_factor(a, step1, a.t[r]) : 1.0f;
    for (int c = 0; c < a.k; ++c) {
      const float g = segment_total(a.lp, s, e, a.k, c);
      if ((threadIdx.x & 31) == 0) {
        RowUpdate<kKind, kDecay> row;
        row.load(a, r * a.k + c);
        row.apply(a, r * a.k + c, fac, g);
      }
    }
    if (kDecay && (threadIdx.x & 31) == 0) a.t[r] = step1;
  }
}

// ------------------------------------------------------------- launching
// Rows a tile: as many as fit kBufferBytes (at most kMaxTile), a multiple
// of kThreads, else of kChunk; at least kChunk.
int tile_rows(int id_bytes, int pay_bytes) {
  const int fixed = (kPre + kHalo) * id_bytes + kWalkMax * pay_bytes;
  int t = (kBufferBytes - fixed) / (id_bytes + pay_bytes);
  if (t > kMaxTile) t = kMaxTile;
  if (t >= kThreads) return t / kThreads * kThreads;
  return t < kChunk ? kChunk : t / kChunk * kChunk;
}

// The scratch of a launch over M rows in tiles of T: the counters (16
// bytes) and a word a tile, which the launch zeroes, then two partials a
// chunk and column and, for the update, the list of long segments (float
// sums); or the counters and the long list (rounded sums). A list holds at
// most M / (kWalkMax + 1) + 1 entries.
struct Scratch {
  long long M;
  int T, k;
  bool rounded, listed;
  long long tiles() const { return (M + T - 1) / T; }
  long long list() const { return M / (kWalkMax + 1) + 1; }
  long long zero_bytes() const { return 16 + (rounded ? 0 : 8 * tiles()); }
  long long part_bytes() const { return 4LL * 2 * ((M + kChunk - 1) / kChunk) * k; }
  long long bytes() const {
    if (rounded) return 16 + 8 * list();
    return zero_bytes() + part_bytes() + (listed ? sizeof(LongEnd) * list() : 0);
  }
  int* counters(char* base) const { return reinterpret_cast<int*>(base); }
  LongPart long_part(char* base) const {
    if (rounded) return LongPart{nullptr, nullptr, nullptr, nullptr};
    char* part = base + zero_bytes();
    return LongPart{reinterpret_cast<unsigned long long*>(base + 16),
                    reinterpret_cast<float*>(part),
                    listed ? reinterpret_cast<LongEnd*>(part + part_bytes()) : nullptr,
                    counters(base)};
  }
  long long* long_starts(char* base) const {
    return rounded ? reinterpret_cast<long long*>(base + 16) : nullptr;
  }
};

Scratch sum_scratch(long long M, int k, int seg_bytes, int round_to) {
  return Scratch{M, tile_rows(seg_bytes, 4 * k), k, round_to != 0, false};
}

Scratch update_scratch(long long M, int k) {
  return Scratch{M, tile_rows(4, 8), k, false, true};
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

// The tile kernel, at most a block an SM's share of the tiles (a block
// spends its life taking tiles), after zeroing the counters and the tiles'
// words; then, when given, the second launch over the long segments the
// first listed, on a grid of its own size (its blocks end at once when the
// list is empty).
template <class Args>
int launch(void (*kernel)(Args), void (*ends)(Args), const Args& a, int id_bytes, int sms,
           const Scratch& sc, char* scratch, cudaStream_t cs) {
  const int T = a.tl.T;
  const int smem = 2 * ((kPre + T + kHalo) * id_bytes + (T + kWalkMax) * a.tl.pay_bytes);
  int per_sm = 0;
  const int err = blocks_per_sm(reinterpret_cast<const void*>(kernel), smem, &per_sm);
  if (err != 0) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = sc.tiles();
  const long long blocks = tiles < static_cast<long long>(per_sm) * sms
                               ? tiles : static_cast<long long>(per_sm) * sms;
  const cudaError_t e = cudaMemsetAsync(scratch, 0, sc.zero_bytes(), cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, cs>>>(a);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess || ends == nullptr) return static_cast<int>(e1);
  ends<<<static_cast<unsigned>(sms * kBlocksPerSm), kThreads, 0, cs>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class IdT>
int launch_sum(const float* g, const void* seg, const unsigned char* skip_last, long long M,
               int k, long long n_slots, int round_to, float* out, char* scratch, int sms,
               cudaStream_t cs) {
  const Scratch sc = sum_scratch(M, k, sizeof(IdT), round_to);
  const SumArgs<IdT> a{{static_cast<const IdT*>(seg), g, 4 * k, M, sc.T}, skip_last, k,
                       n_slots, out, sc.counters(scratch), sc.long_part(scratch),
                       sc.long_starts(scratch)};
  void (*kernels[3][2])(SumArgs<IdT>) = {
      {seg_sum_tiles<IdT, 0, 0>, seg_sum_tiles<IdT, 1, 0>},
      {seg_sum_tiles<IdT, 0, 1>, seg_sum_tiles<IdT, 1, 1>},
      {seg_sum_tiles<IdT, 0, 2>, seg_sum_tiles<IdT, 1, 2>}};
  void (*no_ends)(SumArgs<IdT>) = nullptr;   // the sum combines in its tile kernel
  return launch(kernels[round_to][k == 1], no_ends, a, sizeof(IdT), sms, sc, scratch, cs);
}

}  // namespace

// Rows past which a segment is summed in the kernels' long order, not the
// CPU's index order.
extern "C" int segment_sum_walk_max() { return kWalkMax; }

// Rows a tile of a kernel whose ids take id_bytes and whose payload row
// pay_bytes (the update: 4 and 8; the sum: its ids' width and 4k).
extern "C" int segment_tile_rows(int id_bytes, int pay_bytes) {
  return tile_rows(id_bytes, pay_bytes);
}

// Bytes of the scratch segment_sum_sorted_launch needs (the wrapper
// allocates it; the launch zeroes what it must).
extern "C" long long segment_sum_scratch_bytes(long long M, int k, int seg_bytes, int round_to) {
  return sum_scratch(M, k, seg_bytes, round_to).bytes();
}

// Bytes of the scratch segment_update_sorted_launch needs.
extern "C" long long segment_update_scratch_bytes(long long M, int k) {
  return update_scratch(M, k).bytes();
}

// Launches seg_sum_tiles on `stream` after zeroing the start of the
// scratch; returns a cudaError_t (0 on success). round_to: 0 float32 sums, 1 bf16, 2 f16 (each add
// rounded). scratch holds segment_sum_scratch_bytes(M, k, seg_bytes,
// round_to) bytes, 16-byte aligned. out is written whole. Allocates
// nothing and does not synchronise.
extern "C" int segment_sum_sorted_launch(const float* g, const void* seg, int seg_bytes,
                                         const unsigned char* skip_last,
                                         long long M, int k, long long n_slots, int round_to,
                                         float* out, void* scratch, int sms, void* stream) {
  if (M < 1 || k < 1 || n_slots < 1 || (seg_bytes != 4 && seg_bytes != 8) || sms < 1 ||
      round_to < 0 || round_to > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  return seg_bytes == 8
             ? launch_sum<long long>(g, seg, skip_last, M, k, n_slots, round_to, out, sc, sms, cs)
             : launch_sum<int>(g, seg, skip_last, M, k, n_slots, round_to, out, sc, sms, cs);
}

// Launches seg_update_tiles, then seg_update_ends, on `stream`: the
// touched-row update of the sorted keys (i32[M], the dead sentinel D
// sorting last) and their sort order (i64[M]), in place on emb, the rule's
// slots and t. kind: 0 sgd, 1 adagrad (s0 = acc), 2 ftrl (s0 = z, s1 = n).
// vals: f32[M] per-pair values in the original occurrence order, or null
// (the kernel without them). scratch holds segment_update_scratch_bytes(M,
// k) bytes, 16-byte aligned. Allocates nothing and does not synchronise.
extern "C" int segment_update_sorted_launch(
    const int* keys, const long long* order, long long M, int C, const float* dl,
    const float* vals, int k,
    long long D, float* emb, float* s0, float* s1, int* t, const int* step, int kind,
    int use_decay, float lr, float inv_lr, float decay, float eps, float beta, float l1,
    float two_reg, void* scratch, int sms, void* stream) {
  if (M < 1 || M > 0x7fffffffLL || C < 1 || k < 1 || D < 1 || kind < kSgd || kind > kFtrl ||
      sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc = update_scratch(M, k);
  char* base = static_cast<char*>(scratch);
  int l = 0;
  while ((1LL << l) < C) ++l;
  const unsigned div_m = static_cast<unsigned>((1ULL << (31 + l)) / C + 1);   // < 2^32
  const UpdateArgs a{{keys, order, 8, M, sc.T}, div_m, 31 + l, dl, vals, k, D, emb, s0, s1, t,
                     step, lr, inv_lr, decay, eps, beta, l1, two_reg, sc.counters(base),
                     sc.long_part(base)};
  void (*kernels[3][2][2])(UpdateArgs) = {
      {{seg_update_tiles<kSgd, false, false>, seg_update_tiles<kSgd, false, true>},
       {seg_update_tiles<kSgd, true, false>, seg_update_tiles<kSgd, true, true>}},
      {{seg_update_tiles<kAdagrad, false, false>, seg_update_tiles<kAdagrad, false, true>},
       {seg_update_tiles<kAdagrad, true, false>, seg_update_tiles<kAdagrad, true, true>}},
      {{seg_update_tiles<kFtrl, false, false>, seg_update_tiles<kFtrl, false, true>},
       {seg_update_tiles<kFtrl, true, false>, seg_update_tiles<kFtrl, true, true>}}};
  void (*ends[3][2])(UpdateArgs) = {
      {seg_update_ends<kSgd, false>, seg_update_ends<kSgd, true>},
      {seg_update_ends<kAdagrad, false>, seg_update_ends<kAdagrad, true>},
      {seg_update_ends<kFtrl, false>, seg_update_ends<kFtrl, true>}};
  return launch(kernels[kind][use_decay != 0][vals != nullptr], ends[kind][use_decay != 0], a, 4,
                sms, sc, base, static_cast<cudaStream_t>(stream));
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
