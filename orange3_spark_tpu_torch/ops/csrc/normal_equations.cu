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
// side, over the ratings of its segment [offsets[e], offsets[e+1]) of the
// ratings stable-sorted by e,
//
//   A[e, i, j] = sum of (V[oid, i] * V[oid, j]) * aw      (i >= j, mirrored)
//   b[e, i]    = sum of V[oid, i] * bw
//   cnt[e]     = sum of cw
//
//   V        f32[n_other, k]  the other side's factors
//   oid      i32[M]           the other side's id of each sorted rating
//   pos      i32[M]           its position in the original rating order
//   aw, bw, cw  f32[M]        its weights for A, b and the count
//   offsets  i64[E + 1]       segment starts; sorted ratings past
//                             offsets[E] belong to no entity
//   A f32[E, k, k], b f32[E, k], cnt f32[E]; an entity with no rating
//   gets zeros
//
// Order of the adds. No float atomics: each output is one thread's sum in
// an order fixed by the data, so two launches give the same bits. The sort
// is stable, so a segment's order is the original rating order. The
// reference adds chunk by chunk (A = A + segment_sum(chunk c), a rating in
// chunk pos / chunk): here a partial sum restarts from +0.0 where the
// chunk changes and is then added to the running total, which is that
// order and the order of the plain version (index_add_ per chunk on the
// CPU). Every product and add rounds with __fmul_rn / __fadd_rn: nvcc
// would otherwise contract them into FMAs, which round once where the CPU
// rounds twice. Zero-weight ratings are summed as the reference sums them.
//
// Layout. One block per entity. Thread t owns outputs t, t + threads, ...
// (OPT of them in registers; more passes over the segment when the rank
// needs more): the lower triangle of A, then b, then cnt. The segment's
// rows come into shared memory a tile at a time, each as its k factor
// values followed by 1.0, aw, bw and cw, so that every output is one
// expression, (row[i] * row[j]) * row[w]: an entry of b multiplies by the
// 1.0 (exact) and cnt is (1 * 1) * cw. A flag per row marks a chunk change.
//
// What bounds it: the bytes. At MovieLens-25M (M = 24,737,856 ratings,
// rank 16), the user half-step reads oid, pos, aw, bw, cw (20 B a rating,
// 495 MB), the offsets and the item factors (3.8 MB), and writes A, b and
// cnt of 162,541 users (177 MB): ~0.68 GB, 0.20 ms at 3.35 TB/s. Its
// 10.9 GFLOP of float32 products and adds take 0.16 ms at 67 TFLOP/s. The
// layout carries more than the sums need: cw equals aw for explicit
// feedback, and pos only marks where the chunk changes. With oid holding a
// chunk-change bit, aw and bw (12 B a rating) the bytes take 0.14 ms, and
// the operations bound it. The gathered factor rows stay in the 50 MB L2.
// This simple design spends its time on shared-memory loads (three a
// term); a register tile of outputs sharing a row would cut them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxTile = 256;
constexpr int kSmemBudget = 48 * 1024;   // no opt-in attribute below this

struct Args {
  const float* V;
  int k;
  const int* oid;
  const int* pos;
  const float* aw;
  const float* bw;
  const float* cw;
  const long long* offsets;
  int chunk;
  int tile;
  float* A;
  float* b;
  float* cnt;
};

// Output o of an entity as the three row slots of its term
// (row[i] * row[j]) * row[w]; slots past the outputs give (1 * 1) * 1.
__device__ __forceinline__ void decode(int o, int k, int& i, int& j, int& w) {
  const int n_tri = k * (k + 1) / 2;
  if (o < n_tri) {
    int r = static_cast<int>((sqrtf(8.0f * o + 1.0f) - 1.0f) * 0.5f);
    while (r * (r + 1) / 2 > o) --r;
    while ((r + 1) * (r + 2) / 2 <= o) ++r;
    i = r;
    j = o - r * (r + 1) / 2;
    w = k + 1;
  } else if (o < n_tri + k) {
    i = o - n_tri;
    j = k;
    w = k + 2;
  } else if (o == n_tri + k) {
    i = k;
    j = k;
    w = k + 3;
  } else {
    i = k;
    j = k;
    w = k;
  }
}

template <int OPT>
__global__ void normal_eq_sorted(Args a) {
  extern __shared__ float smem[];
  const int k = a.k;
  const int stride = k + 4;
  const int n_tri = k * (k + 1) / 2;
  const int n_out = n_tri + k + 1;
  float* rows = smem;                                            // [tile][stride]
  int* chunk_start = reinterpret_cast<int*>(smem + static_cast<size_t>(a.tile) * stride);
  const long long e = blockIdx.x;
  const long long s0 = a.offsets[e];
  const long long s1 = a.offsets[e + 1];
  const int nt = blockDim.x;

  for (int base = 0; base < n_out; base += OPT * nt) {
    int ci[OPT], cj[OPT], cw[OPT];
    float part[OPT], total[OPT];
#pragma unroll
    for (int q = 0; q < OPT; ++q) {
      decode(base + q * nt + threadIdx.x, k, ci[q], cj[q], cw[q]);
      part[q] = 0.0f;
      total[q] = 0.0f;
    }
    for (long long t0 = s0; t0 < s1; t0 += a.tile) {
      const int n = static_cast<int>(s1 - t0 < a.tile ? s1 - t0 : a.tile);
      __syncthreads();   // the previous tile has been read
      for (int x = threadIdx.x; x < n * k; x += nt) {
        const int r = x / k;
        const int c = x - r * k;
        rows[r * stride + c] = a.V[static_cast<long long>(a.oid[t0 + r]) * k + c];
      }
      for (int r = threadIdx.x; r < n; r += nt) {
        const long long g = t0 + r;
        float* row = rows + r * stride;
        row[k] = 1.0f;
        row[k + 1] = a.aw[g];
        row[k + 2] = a.bw[g];
        row[k + 3] = a.cw[g];
        chunk_start[r] = g > s0 && a.pos[g] / a.chunk != a.pos[g - 1] / a.chunk;
      }
      __syncthreads();
      for (int r = 0; r < n; ++r) {
        const float* row = rows + r * stride;
        if (chunk_start[r]) {
#pragma unroll
          for (int q = 0; q < OPT; ++q) {
            total[q] = __fadd_rn(total[q], part[q]);
            part[q] = 0.0f;
          }
        }
#pragma unroll
        for (int q = 0; q < OPT; ++q)
          part[q] = __fadd_rn(part[q], __fmul_rn(__fmul_rn(row[ci[q]], row[cj[q]]), row[cw[q]]));
      }
    }
#pragma unroll
    for (int q = 0; q < OPT; ++q) {
      const int o = base + q * nt + threadIdx.x;
      if (o >= n_out) continue;
      const float v = __fadd_rn(total[q], part[q]);
      if (o < n_tri) {
        const size_t kk = static_cast<size_t>(k);
        a.A[(static_cast<size_t>(e) * kk + ci[q]) * kk + cj[q]] = v;
        if (ci[q] != cj[q]) a.A[(static_cast<size_t>(e) * kk + cj[q]) * kk + ci[q]] = v;
      } else if (o < n_tri + k) {
        a.b[static_cast<size_t>(e) * k + ci[q]] = v;
      } else {
        a.cnt[e] = v;
      }
    }
  }
}

// The launch plan of rank k: threads a block, outputs a thread (OPT) and
// rows a tile.
void plan(int k, int* threads, int* opt, int* tile) {
  const long long n_out = static_cast<long long>(k) * (k + 1) / 2 + k + 1;
  long long t = (n_out + 31) / 32 * 32;
  *threads = static_cast<int>(t < kMaxThreads ? t : kMaxThreads);
  const long long per = (n_out + *threads - 1) / *threads;
  *opt = per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : 8;
  const int row_bytes = 4 * (k + 4) + 4;
  const int rows = kSmemBudget / row_bytes;
  *tile = rows < kMaxTile ? rows : kMaxTile;
}

}  // namespace

// Largest rank the kernel takes (one tile row must fit the shared memory).
extern "C" int normal_equations_max_rank() { return kSmemBudget / 4 - 5; }

// Launches normal_eq_sorted on `stream`, one block per entity; returns a
// cudaError_t (0 on success). A, b and cnt are written whole. Allocates
// nothing and does not synchronise.
extern "C" int normal_equations_sorted_launch(const float* V, int k, const int* oid,
                                              const int* pos, const float* aw,
                                              const float* bw, const float* cw,
                                              const long long* offsets, long long E,
                                              long long M, int chunk, float* A, float* b,
                                              float* cnt, void* stream) {
  if (k < 1 || k > normal_equations_max_rank() || E < 1 || E > 0x7fffffffLL || M < 0 ||
      M > 0x7fffffffLL || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = 0, opt = 0, tile = 0;
  plan(k, &threads, &opt, &tile);
  const Args a{V, k, oid, pos, aw, bw, cw, offsets, chunk, tile, A, b, cnt};
  const size_t smem = static_cast<size_t>(tile) * (4 * (k + 4) + 4);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(E));
  switch (opt) {
    case 1: normal_eq_sorted<1><<<grid, threads, smem, cs>>>(a); break;
    case 2: normal_eq_sorted<2><<<grid, threads, smem, cs>>>(a); break;
    case 4: normal_eq_sorted<4><<<grid, threads, smem, cs>>>(a); break;
    default: normal_eq_sorted<8><<<grid, threads, smem, cs>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* normal_equations_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
