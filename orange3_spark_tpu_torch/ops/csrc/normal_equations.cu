// The per-entity normal equations of one ALS half-step, for Hopper (sm_90a).
//
// No TPU kernel maps to this one. It replaces XLA code of the JAX package:
// the chunked segment sums of orange3_spark_tpu/models/als.py:112-130
// (_solve_side), which form per-rating outer products [chunk, k, k] and
// jax.ops.segment_sum them into [n_entities, k*k], chunk after chunk.
// Ported literally, that is an index_add_ with float atomics on CUDA (two
// fits would not agree bitwise) that writes and reads back every outer
// product (at MovieLens-25M and rank 16, 25 GB a half-step).
//
// normal_eq_sorted (normal_equations_sorted): for every entity e of this
// side, over the ratings of its segment of the ratings stable-sorted by e,
//
//   A[e, i, j] = sum of (V[oid, i] * V[oid, j]) * aw
//   b[e, i]    = sum of V[oid, i] * bw
//   cnt[e]     = sum of cw
//
//   V        f32[n_other, k]  the other side's factors
//   key      i32[M]           the other side's id oid of each sorted
//                             rating; bit 31 set where its reference chunk
//                             differs from the previous rating's
//   aw, bw   f32[M]           its weights for A and b
//   cw       f32[M] or null   its weight for the count (null: aw's)
//   units    i32[U][6]        the work list (ops/normal_equations.py,
//                             SideLayout): first sorted rating, ratings,
//                             entity, split id, piece, aw == cw == 1.0 on
//                             every rating
//   A f32[E, k, k], b f32[E, k], cnt f32[E]; an entity with no rating
//   gets zeros
//
// Order of the adds. No float atomics: each output is one lane's sum in an
// order fixed by the data, so two launches give the same bits. The sort is
// stable, so a segment's order is the original rating order. The reference
// adds chunk by chunk (A = A + segment_sum(chunk c)): here a partial sum
// restarts from +0.0 where bit 31 is set and is then added to the running
// total, which is that order and the order of the plain version (index_add_
// per chunk on the CPU). Every product and add rounds with __fmul_rn /
// __fadd_rn: nvcc would otherwise contract them into FMAs, which round once
// where the CPU rounds twice. Zero-weight ratings are summed as the
// reference sums them.
//
// What bounds it. At MovieLens-25M (M = 24,737,856 ratings, rank 16) the
// user half-step needs 10.9 G float32 products and adds, which may not
// contract: 0.33 ms of issue at the card's 33.5 T non-FMA operations a
// second. Its bytes (12 a rating, the item factors, A, b and cnt of 162,541
// users) take 0.14 ms at 3.35 TB/s. So the instructions bound it, and the
// design keeps all but the float32 ones few:
//
// - A register tile. A lane owns a 4x4 tile of outputs that share rows:
//   block (I, J) of A's lower triangle. One float4 shared load of each of
//   the rating's two 4-blocks of V serves 16 terms, so a term costs its two
//   products and its add and little else. A diagonal tile's fourth column
//   holds b instead of the upper entries (its Y operand is V[4I..4I+2], 1.0
//   and its weight bw), and the lane's one extra sum holds the entry
//   (4I+3, 4I+3); one lane's extra sum is the count.
// - Lanes kept busy. Rank 16 has 10 tiles, so a warp holds 3 entities of
//   10 lanes each (an entity with more tiles than 32 lanes is cut into
//   slices, each its own warp, each reading the rows again). The work list
//   orders entities by falling segment length, so that a warp's entities
//   end together.
// - A cp.async ring. Each group's rows (the factor row V[oid] beside aw, bw,
//   cw and the key) come into shared memory through a ring of three stages
//   of R rows: the keys of a stage, then the rows they point at, are in
//   flight while the lanes sum the stage before. A warp needs no barrier
//   but __syncwarp.
// - The 12-byte layout: key, aw and bw; cw only for implicit feedback.
// - Long segments cut at chunk boundaries. A unit of the work list is a
//   whole segment or one chunk's piece of a long one. A piece's lanes write
//   its partial sums to scratch; the last piece of a segment to finish (an
//   integer counter per segment and slice) adds them in chunk order from
//   +0.0, the reference's order.
// - aw == 1.0 (every live rating of an unweighted table): when the work
//   list says so for every unit a warp holds (one vote a work item), the
//   products skip the multiply by aw, which changes no bit (x * 1.0 == x).
// - Each lane loads the key of one row of a stage a stage ahead; the
//   factor rows' 16-byte copies go round the group's lanes so that one
//   copy instruction touches few cache lines; the sums walk the ring rows
//   by pointer and load the next row's operands while they sum one; a row
//   past a unit's end is zeros, so no row is tested.
//
// Where it stands on an H100 SXM (700 W), config 4's user half-step: 1.07
// ms, 3.3x the issue bound. probes/ne_split.py times it with parts taken
// away: the sums alone (no factor-row copies) take ~0.75 ms with no chunk
// change, at about half the rate their instruction count allows; the copies
// and the work list without the sums ~0.5 ms (1.6 GB of factor rows come
// from L2 a half-step, 64 B a rating); the flush at chunk changes adds
// ~0.2 ms where half the ratings start a chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // warps a block
constexpr int kStages = 3;                // ring stages
constexpr int kRingBudget = 24 * 1024;    // bytes of ring a warp, where rows allow
constexpr int kMaxSmem = 232448;          // a block's opt-in shared memory on H100
constexpr int kMaxRank = 14336;           // four ring rows of it fit kMaxSmem
constexpr int kLaneFloats = 20;           // a lane's partials in scratch (17 used)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnitInts = 6;            // a work-list entry

// The launch plan of rank k.
struct Plan {
  int k, kp, nb;        // rank, padded to 4, 4-blocks
  int tiles, lanes;     // tiles of an entity; lanes (one more at k == 4: the count)
  int L, G, slices;     // lanes a group, groups a warp, warps an entity
  int R;                // rows a group a stage (at most L: a row a lane)
  int row;              // floats a ring row: kp factors, aw, bw, cw, key
  int warps;            // warps a block
  int nvec, vec;        // copies a factor row, bytes a copy
  int copies;           // copies a lane makes a stage: ceil(R * nvec / L)
  int dr, dc;           // a lane's next copy: dr rows and dc copies on
};

// Floats of a warp's ring: kStages stages of G groups of R rows, and one
// spare row at the end, which the sums read past a stage's last row.
__host__ __device__ inline long long ring_floats(const Plan& p) {
  return (static_cast<long long>(kStages) * p.G * p.R + 1) * p.row;
}

Plan make_plan(int k) {
  Plan p{};
  p.k = k;
  p.nb = (k + 3) / 4;
  p.kp = 4 * p.nb;
  p.tiles = p.nb * (p.nb + 1) / 2;
  p.lanes = p.tiles + (k == 4 ? 1 : 0);
  if (p.lanes <= 32) {
    p.slices = 1;
    p.L = p.lanes;
    p.G = 32 / p.L;
  } else {
    p.slices = (p.lanes + 31) / 32;
    p.L = (p.lanes + p.slices - 1) / p.slices;
    p.G = 1;
  }
  p.row = p.kp + 4;
  // a row a lane: each lane loads its row's key a stage ahead
  const int fit = (kRingBudget / (4 * p.row) - 1) / (kStages * p.G);
  p.R = p.L < fit ? p.L : (fit > 1 ? fit : 1);
  const long long warp_bytes = 4LL * ring_floats(p);
  const long long fit_warps = kMaxSmem / warp_bytes;
  p.warps = static_cast<int>(fit_warps < kWarps ? fit_warps : kWarps);
  p.vec = k % 4 == 0 ? 16 : k % 2 == 0 ? 8 : 4;
  p.nvec = 4 * k / p.vec;
  p.copies = (p.R * p.nvec + p.L - 1) / p.L;
  p.dr = p.L / p.nvec;
  p.dc = p.L - p.dr * p.nvec;
  return p;
}

size_t smem_bytes(const Plan& p) { return 4ull * p.warps * ring_floats(p); }

struct Args {
  const float* V;
  const int* key;
  const float* aw;
  const float* bw;
  const float* cw;
  const int* units;       // [n_units][kUnitInts]
  long long n_units;
  const int* split_first;
  int n_split;
  float* scratch;
  int* counters;
  float* A;
  float* b;
  float* cnt;
  long long n_work;     // warps of work: ceil(n_units / G) * slices
  Plan p;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(B));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A lane's tile: block (I, J) of A's lower triangle. Diagonal tiles come
// first (tau < nb), then the off-diagonal ones row by row.
struct Tile {
  int xo, yo;         // float offsets of the X and Y 4-blocks in a ring row
  bool on;            // the lane owns a tile (or the count)
  bool diag;          // a diagonal tile: column 3 is b, the extra sum A's corner
  bool count;         // the extra sum is cnt
  bool dummy;         // only the count (k == 4)
  int y3;             // aw == 1.0 path: column 3's operand (bw for a diagonal tile)
  int e1;             // aw == 1.0 path: the extra sum's operand (aw == 1.0 for the count)
};

__device__ Tile decode(int tau, const Plan& p) {
  Tile t{0, 0, false, false, false, false, 3, 3};
  if (tau >= p.lanes) return t;
  t.on = true;
  if (tau < p.nb) {
    t.xo = t.yo = 4 * tau;
    t.diag = true;
    // the corner of the last block of a rank that is not a multiple of 4
    // lies past the rank: that lane's extra sum is the count
    t.count = 4 * tau + 3 >= p.k;
  } else if (tau < p.tiles) {
    const int q = tau - p.nb;
    int I = static_cast<int>((1.0f + sqrtf(1.0f + 8.0f * q)) * 0.5f);
    while (I * (I - 1) / 2 > q) --I;
    while ((I + 1) * I / 2 <= q) ++I;
    const int J = q - I * (I - 1) / 2;
    t.xo = 4 * I;
    t.yo = 4 * J;
    t.count = p.k % 4 == 0 && tau == p.nb;
  } else {
    t.dummy = t.count = true;
  }
  t.y3 = t.diag ? p.kp + 1 : t.yo + 3;
  t.e1 = t.count ? p.kp : t.xo + 3;
  return t;
}

// Writes a lane's sums of entity e: v[a][c] its tile, ext its extra sum.
__device__ void write_tile(const Args& a, const Tile& t, long long e, const float (&v)[16],
                           float ext) {
  const int k = a.p.k;
  const size_t kk = static_cast<size_t>(k);
  float* Ae = a.A + static_cast<size_t>(e) * kk * kk;
  if (t.count) a.cnt[e] = ext;
  if (t.dummy) return;
  const int i0 = t.xo, j0 = t.yo;
  const bool vec = k % 4 == 0;
  if (t.diag) {
    // block entry (r, c): column c < 3 is v[r][c] (an upper one the same
    // bits as its mirror); (r, 3) for r < 3 mirrors (3, r); (3, 3) is ext
    float B[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) B[r][c] = v[r * 4 + c];
      B[r][3] = r < 3 ? v[3 * 4 + r] : ext;
    }
    if (vec) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(Ae + (i0 + r) * kk + i0) =
            make_float4(B[r][0], B[r][1], B[r][2], B[r][3]);
      *reinterpret_cast<float4*>(a.b + static_cast<size_t>(e) * kk + i0) =
          make_float4(v[3], v[7], v[11], v[15]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i0 + r >= k) break;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (i0 + c < k) Ae[(i0 + r) * kk + i0 + c] = B[r][c];
        a.b[static_cast<size_t>(e) * kk + i0 + r] = v[r * 4 + 3];
      }
    }
    return;
  }
  if (vec) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(Ae + (i0 + r) * kk + j0) =
          make_float4(v[r * 4], v[r * 4 + 1], v[r * 4 + 2], v[r * 4 + 3]);
      *reinterpret_cast<float4*>(Ae + (j0 + r) * kk + i0) =
          make_float4(v[r], v[4 + r], v[8 + r], v[12 + r]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (i0 + r < k && j0 + c < k) {
          Ae[(i0 + r) * kk + j0 + c] = v[r * 4 + c];
          Ae[(j0 + c) * kk + i0 + r] = v[r * 4 + c];
        }
      }
    }
  }
}

// The key of row t of stage st of the group's unit (0 past its end): a
// lane loads its row's key a stage before it puts the row in flight.
__device__ __forceinline__ int stage_key(const Args& a, int st, int t, int start, int len,
                                         bool loads) {
  const int idx = st * a.p.R + t;
  return loads && idx < len ? __ldg(a.key + start + idx) : 0;
}

// Puts the group's stage in flight. Lane t writes the key of the stage's
// row t (loaded a stage ahead) into its ring row and copies that rating's
// weights (cw: aw's when there is none); the factor rows' copies go
// round the group's lanes copy by copy, so that neighbouring lanes copy
// one row's neighbouring bytes (each lane takes its keys by shuffle). A
// row past the unit's end is zeros (key 0: no chunk change), so that it
// adds +0.0 or -0.0 to every sum, which changes no sum from +0.0 on (a sum
// of round-to-nearest adds from +0.0 is never -0.0). Every lane of the
// warp calls it (the shuffles).
template <int VEC>
__device__ __forceinline__ void issue(const Args& a, float* stage_g, int st, int t, int g,
                                      int start, int len, bool in_group, int key, int r0,
                                      int c0) {
  const Plan& p = a.p;
  const int idx0 = st * p.R;
  if (in_group && t < p.R) {
    float* row = stage_g + t * p.row;
    if (idx0 + t < len) {
      reinterpret_cast<int*>(row)[p.kp + 3] = key;
      const long long gi = start + idx0 + t;
      cp_async<4>(row + p.kp, a.aw + gi);
      cp_async<4>(row + p.kp + 1, a.bw + gi);
      cp_async<4>(row + p.kp + 2, (a.cw != nullptr ? a.cw : a.aw) + gi);
    } else {
      for (int q = 0; q < p.row; q += 4)
        *reinterpret_cast<float4*>(row + q) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  constexpr int per = VEC / 4;
  const int base = in_group ? g * p.L : (threadIdx.x & 31);
  int r = r0, c = c0;
  for (int i = 0; i < p.copies; ++i) {
    const int kk = __shfl_sync(kFull, key, base + (in_group && r < p.R ? r : 0));
    if (in_group && r < p.R && idx0 + r < len)
      cp_async<VEC>(stage_g + r * p.row + c * per,
                    a.V + static_cast<size_t>(kk & 0x7fffffff) * p.k + c * per);
    r += p.dr;
    c += p.dc;
    if (c >= p.nvec) {
      c -= p.nvec;
      ++r;
    }
  }
}

// Sums a stage's R rows into the lane's tile (a row past the unit's end is
// zeros and adds nothing). FAST: every row of the warp's units has aw ==
// cw == 1.0, so a product skips the multiply by aw (x * 1.0 == x), b's
// column takes bw in place of the 1.0 and the count's operand is aw. The
// next row's operands are loaded while a row is summed.
template <bool FAST>
__device__ __forceinline__ void sum_stage(const float* row, const Tile& tl, const Plan& p,
                                          float (&part)[16], float (&tot)[16], float& ep,
                                          float& et) {
  float4 x = *reinterpret_cast<const float4*>(row + tl.xo);
  float4 y = *reinterpret_cast<const float4*>(row + tl.yo);
  float4 wt = *reinterpret_cast<const float4*>(row + p.kp);   // aw bw cw key
  float y3 = row[tl.y3], e1 = row[tl.e1];
  for (int r = 0; r < p.R; ++r) {
    const float* nrow = row + p.row;
    const float4 nx = *reinterpret_cast<const float4*>(nrow + tl.xo);
    const float4 ny = *reinterpret_cast<const float4*>(nrow + tl.yo);
    const float4 nwt = *reinterpret_cast<const float4*>(nrow + p.kp);
    const float ny3 = FAST ? nrow[tl.y3] : 0.0f, ne1 = FAST ? nrow[tl.e1] : 0.0f;
    if (__float_as_int(wt.w) < 0) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        tot[q] = __fadd_rn(tot[q], part[q]);
        part[q] = 0.0f;
      }
      et = __fadd_rn(et, ep);
      ep = 0.0f;
    }
    const float xs[4] = {x.x, x.y, x.z, x.w};
    if (FAST) {
      const float ys[4] = {y.x, y.y, y.z, y3};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part[i * 4 + c] = __fadd_rn(part[i * 4 + c], __fmul_rn(xs[i], ys[c]));
      ep = __fadd_rn(ep, __fmul_rn(e1, e1));
    } else {
      const float ys[4] = {y.x, y.y, y.z, tl.diag ? 1.0f : y.w};
      const float w3 = tl.diag ? wt.y : wt.x;
      const float ex = tl.count ? 1.0f : x.w;
      const float we = tl.count ? wt.z : wt.x;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          part[i * 4 + c] =
              __fadd_rn(part[i * 4 + c], __fmul_rn(__fmul_rn(xs[i], ys[c]), wt.x));
        part[i * 4 + 3] = __fadd_rn(part[i * 4 + 3], __fmul_rn(__fmul_rn(xs[i], ys[3]), w3));
      }
      ep = __fadd_rn(ep, __fmul_rn(__fmul_rn(ex, ex), we));
    }
    x = nx;
    y = ny;
    wt = nwt;
    y3 = ny3;
    e1 = ne1;
    row = nrow;
  }
}

// One work item of a warp: each group's unit through the ring, a stage of
// R rows at a time (stage st + kStages - 1 put in flight and the keys of
// the stage after it loaded while st is summed).
template <int VEC, bool FAST>
__device__ __forceinline__ void run_units(const Args& a, float* ring_g, int t, int g,
                                          int start, int len, bool in_group, int r0, int c0,
                                          const Tile& tl, float (&part)[16],
                                          float (&tot)[16], float& ep, float& et) {
  const Plan& p = a.p;
  const bool loads = in_group && t < p.R;
  const size_t stage_floats = static_cast<size_t>(p.G) * p.R * p.row;
  const int n_st = (__reduce_max_sync(kFull, static_cast<unsigned>(len)) + p.R - 1) / p.R;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    issue<VEC>(a, ring_g + s * stage_floats, s, t, g, start, len, in_group,
               stage_key(a, s, t, start, len, loads), r0, c0);
    cp_async_commit();
  }
  int next = stage_key(a, kStages - 1, t, start, len, loads);
  for (int st = 0; st < n_st; ++st) {
    const int ahead = st + kStages - 1;
    issue<VEC>(a, ring_g + (ahead % kStages) * stage_floats, ahead, t, g, start, len,
               in_group, next, r0, c0);
    cp_async_commit();
    next = stage_key(a, ahead + 1, t, start, len, loads);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    sum_stage<FAST>(ring_g + (st % kStages) * stage_floats, tl, p, part, tot, ep, et);
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncwarp();
}

template <int VEC>
__global__ void __launch_bounds__(kWarps * 32) normal_eq_sorted(Args a) {
  extern __shared__ __align__(16) float smem[];
  const Plan& p = a.p;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t warp_floats = static_cast<size_t>(ring_floats(p));
  float* ring = smem + warp * warp_floats;
  // the factor rows' padding (columns k..kp-1) and the spare row stay
  // zero: copies never write them
  for (size_t i = lane; i < warp_floats; i += 32) ring[i] = 0.0f;
  __syncwarp();
  const int g = lane / p.L;          // the lane's group (>= G: an idle lane)
  const int t = lane - g * p.L;      // its lane in the group
  const bool in_group = g < p.G;
  // the lane's first factor-row copy of a stage: row r0, copy c0
  const int r0 = t / p.nvec, c0 = t - (t / p.nvec) * p.nvec;
  // the group's rows: ring row (stage s, row r) at ring_g + (s * G * R + r) * row
  float* ring_g = ring + static_cast<size_t>(in_group ? g : 0) * p.R * p.row;
  const long long stride = static_cast<long long>(gridDim.x) * p.warps;
  for (long long w = static_cast<long long>(blockIdx.x) * p.warps + warp; w < a.n_work;
       w += stride) {
    const long long uw = w / p.slices;
    const int slice = static_cast<int>(w - uw * p.slices);
    const long long u = uw * p.G + g;
    int start = 0, len = 0, ent = 0, sid = -1, piece = -1, ones = 1;
    bool active = false;
    if (in_group && u < a.n_units) {
      const int* d = a.units + u * kUnitInts;
      start = __ldg(d);
      len = __ldg(d + 1);
      ent = __ldg(d + 2);
      sid = __ldg(d + 3);
      piece = __ldg(d + 4);
      ones = __ldg(d + 5);
      // a cut segment's whole unit runs only when its pieces do not
      active = piece < 0 ? !(sid >= 0 && sid < a.n_split) : sid < a.n_split;
    }
    if (!active) len = 0;
    const Tile tl = active ? decode(slice * p.L + t, p)
                           : Tile{0, 0, false, false, false, false, 3, 3};
    float part[16], tot[16], ep = 0.0f, et = 0.0f;
#pragma unroll
    for (int q = 0; q < 16; ++q) part[q] = tot[q] = 0.0f;
    if (__all_sync(kFull, !active || ones != 0))
      run_units<VEC, true>(a, ring_g, t, g, start, len, in_group, r0, c0, tl, part, tot, ep,
                           et);
    else
      run_units<VEC, false>(a, ring_g, t, g, start, len, in_group, r0, c0, tl, part, tot, ep,
                            et);
    float v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = __fadd_rn(tot[q], part[q]);
    const float ext = __fadd_rn(et, ep);
    const bool mine = active && tl.on;
    if (mine && piece < 0) write_tile(a, tl, ent, v, ext);
    // a piece: its partials to scratch; the segment's last piece adds them
    const bool is_piece = active && piece >= 0;
    if (__any_sync(kFull, is_piece)) {
      const int first = is_piece ? __ldg(a.split_first + sid) : 0;
      const int n_pieces = is_piece ? __ldg(a.split_first + sid + 1) - first : 0;
      const size_t piece_floats = static_cast<size_t>(p.slices) * p.L * kLaneFloats;
      const size_t at = static_cast<size_t>(slice) * p.L * kLaneFloats + t * kLaneFloats;
      if (is_piece && tl.on) {
        float4* s = reinterpret_cast<float4*>(a.scratch + (first + piece) * piece_floats + at);
#pragma unroll
        for (int q = 0; q < 4; ++q) s[q] = make_float4(v[q * 4], v[q * 4 + 1], v[q * 4 + 2],
                                                       v[q * 4 + 3]);
        s[4] = make_float4(ext, 0.0f, 0.0f, 0.0f);
      }
      __threadfence();
      __syncwarp();
      int done = 0;
      if (is_piece && t == 0) done = atomicAdd(a.counters + sid * p.slices + slice, 1);
      done = __shfl_sync(kFull, done, in_group ? g * p.L : 0);
      if (is_piece && done == n_pieces - 1) {
        __threadfence();
        if (tl.on) {
          float s[16], se = 0.0f;
#pragma unroll
          for (int q = 0; q < 16; ++q) s[q] = 0.0f;
          for (int j = 0; j < n_pieces; ++j) {
            const float4* src =
                reinterpret_cast<const float4*>(a.scratch + (first + j) * piece_floats + at);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 f = __ldcg(src + q);
              s[q * 4] = __fadd_rn(s[q * 4], f.x);
              s[q * 4 + 1] = __fadd_rn(s[q * 4 + 1], f.y);
              s[q * 4 + 2] = __fadd_rn(s[q * 4 + 2], f.z);
              s[q * 4 + 3] = __fadd_rn(s[q * 4 + 3], f.w);
            }
            se = __fadd_rn(se, __ldcg(src + 4).x);
          }
          write_tile(a, tl, ent, s, se);
        }
      }
    }
  }
}

}  // namespace

// Largest rank the kernel takes (a warp's ring of one row a stage and the
// spare row must fit a block's shared memory).
extern "C" int normal_equations_max_rank() { return kMaxRank; }

// Warps an entity's tiles take at rank k (each re-reads the rows).
extern "C" int normal_equations_slices(int k) {
  return k >= 1 && k <= kMaxRank ? make_plan(k).slices : 0;
}

// Blocks of the kernel an SM holds at rank k (registers and shared memory
// allowing), or a negative cudaError_t.
extern "C" int normal_equations_blocks_per_sm(int k) {
  if (k < 1 || k > kMaxRank) return -static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(k);
  void (*kernel)(Args) = p.vec == 16 ? normal_eq_sorted<16>
                         : p.vec == 8 ? normal_eq_sorted<8>
                                      : normal_eq_sorted<4>;
  const size_t smem = smem_bytes(p);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, p.warps * 32, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Floats of scratch a piece of a cut segment takes at rank k.
extern "C" long long normal_equations_piece_floats(int k) {
  if (k < 1 || k > kMaxRank) return 0;
  const Plan p = make_plan(k);
  return static_cast<long long>(p.slices) * p.L * kLaneFloats;
}

// Launches normal_eq_sorted on `stream` (after zeroing the n_split * slices
// counters); returns a cudaError_t (0 on success). scratch holds
// normal_equations_piece_floats(k) floats for each piece of the first
// n_split cut segments. A, b and cnt are written whole. Allocates nothing
// and does not synchronise.
extern "C" int normal_equations_sorted_launch(const float* V, int k, const int* key,
                                              const float* aw, const float* bw,
                                              const float* cw, const int* units,
                                              long long n_units, const int* split_first,
                                              int n_split, float* scratch, int* counters,
                                              float* A, float* b, float* cnt, void* stream) {
  if (k < 1 || k > kMaxRank || n_units < 1 || n_units > 0x7fffffffLL || n_split < 0 ||
      reinterpret_cast<uintptr_t>(V) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(k);
  if (p.warps < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (n_split > 0) {
    const cudaError_t e = cudaMemsetAsync(counters, 0, sizeof(int) * n_split * p.slices, cs);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long n_work = (n_units + p.G - 1) / p.G * p.slices;
  const Args a{V, key, aw, bw, cw, units, n_units, split_first, n_split, scratch, counters,
               A, b, cnt, n_work, p};
  const size_t smem = smem_bytes(p);
  const long long want = (n_work + p.warps - 1) / p.warps;
  const unsigned blocks = static_cast<unsigned>(want < (1LL << 20) ? want : (1LL << 20));
  void (*kernel)(Args) = p.vec == 16 ? normal_eq_sorted<16>
                         : p.vec == 8 ? normal_eq_sorted<8>
                                      : normal_eq_sorted<4>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, p.warps * 32, smem, cs>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* normal_equations_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
