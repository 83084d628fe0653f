// Deterministic segment sums of sorted rows, for Hopper (sm_90a).
//
// No TPU kernel maps to this one: it replaces the XLA segment sum of the
// touched-row update, _segment_sums in orange3_spark_tpu/optim/sparse.py
// (a jax.ops.segment_sum), which PyTorch would run as an index_add_ that
// adds with float atomics in an order that changes from run to run:
//
//   out[j, c] = sum of g[i, c] over the rows i with seg[i] == j
//
//   g     f32[M, k]      per-occurrence gradients in stable-sorted order
//   seg   i32 or i64[M]  segment of each row, non-decreasing from 0
//   skip_last  u8[1]     optional: when nonzero the last segment (the dead
//                        sentinel's, which sorts last, in a chunk with
//                        padding rows) is not summed; its slot holds +0.0
//                        (nothing reads it)
//   out   f32[n_slots, k]; a slot with no row holds +0.0
//
// Order of the adds. No float atomics: every sum is taken by one thread,
// or one block, in an order fixed by the data alone, so two launches on
// the same inputs give the same bits.
// * A segment of at most kWalkMax rows is summed by the thread of its
//   first row, walking its rows in sorted order from +0.0. The sort is
//   stable, so that is the occurrence order, the order in which the plain
//   version (index_add_ on the CPU) adds: these sums are bitwise the CPU's.
// * A longer segment (a heavy hitter of a click log) would make that one
//   thread walk it alone. Its first thread appends it to a list instead
//   (an integer atomic gives the list slot; the list's order does not
//   matter), and seg_sum_long sums it with one block: thread t adds rows
//   t, t + 1024, ... in order, then a fixed tree in shared memory adds the
//   1024 partials. Deterministic, but not the CPU's order: within float32
//   rounding of it.
//
// What bounds it: the bytes. At the Criteo fit's step (M = 2^18 * 26 =
// 6,815,744 occurrences, k = 1, i64 seg, n_slots = 4,194,305) a launch
// must read g (27.3 MB) and seg (54.5 MB) once and write out (16.8 MB):
// 98.6 MB, 0.029 ms at 3.35 TB/s. The walk reads seg[i - 1] and seg[i],
// which neighbouring threads share through L1, and a head thread's walk
// reads the rows right after its own, which its warp has just loaded.
// Every slot is written once: by its segment's head, by a head that passes
// over empty slots before its own, or, past the last segment, by the
// thread of that slot's index.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // threads of a walk block
constexpr int kLongThreads = 1024;   // threads of a long-segment block
constexpr int kWalkMax = 32;         // rows a head thread sums alone

struct Args {
  const float* g;
  const void* seg;
  int seg_bytes;
  const unsigned char* skip_last;   // null: every segment is summed
  long long M;
  int k;
  long long n_slots;
  float* out;
  long long* long_starts;   // first row of each long segment
  int* n_long;              // entries of long_starts
};

__device__ __forceinline__ long long load_index(const void* p, int bytes, long long i) {
  return bytes == 8 ? static_cast<const long long*>(p)[i]
                    : static_cast<long long>(static_cast<const int*>(p)[i]);
}

__device__ __forceinline__ void zero_slot(const Args& a, long long j) {
  for (int c = 0; c < a.k; ++c) a.out[j * a.k + c] = 0.0f;
}

__global__ void __launch_bounds__(kThreads) seg_sum_walk(Args a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long last = load_index(a.seg, a.seg_bytes, a.M - 1);
  if (t < a.n_slots && t > last) zero_slot(a, t);
  if (t >= a.M) return;
  const long long s = load_index(a.seg, a.seg_bytes, t);
  const long long prev = t == 0 ? -1 : load_index(a.seg, a.seg_bytes, t - 1);
  if (s == prev) return;                       // not the first row of its segment
  for (long long j = prev + 1; j < s && j < a.n_slots; ++j) zero_slot(a, j);
  if (s >= a.n_slots) return;                  // the caller's slots end before it
  if (s == last && a.skip_last != nullptr && *a.skip_last != 0) {
    zero_slot(a, s);                           // the dead segment: never read
    return;
  }
  long long e = t + 1;
  while (e < a.M && e - t < kWalkMax && load_index(a.seg, a.seg_bytes, e) == s) ++e;
  if (e < a.M && e - t == kWalkMax && load_index(a.seg, a.seg_bytes, e) == s) {
    a.long_starts[atomicAdd(a.n_long, 1)] = t;   // longer than a walk: one block's
    return;
  }
  for (int c = 0; c < a.k; ++c) {
    float acc = 0.0f;
    for (long long i = t; i < e; ++i) acc += a.g[i * a.k + c];
    a.out[s * a.k + c] = acc;
  }
}

__global__ void __launch_bounds__(kLongThreads) seg_sum_long(Args a) {
  __shared__ float part[kLongThreads];
  const int n = *a.n_long;
  for (int e = blockIdx.x; e < n; e += gridDim.x) {
    const long long start = a.long_starts[e];
    const long long s = load_index(a.seg, a.seg_bytes, start);
    for (int c = 0; c < a.k; ++c) {
      float acc = 0.0f;
      // rows are sorted: the first row past the segment ends this thread's rows
      for (long long i = start + threadIdx.x; i < a.M; i += kLongThreads) {
        if (load_index(a.seg, a.seg_bytes, i) != s) break;
        acc += a.g[i * a.k + c];
      }
      part[threadIdx.x] = acc;
      __syncthreads();
      for (int w = kLongThreads / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
        __syncthreads();
      }
      if (threadIdx.x == 0) a.out[s * a.k + c] = part[0];
      __syncthreads();
    }
  }
}

}  // namespace

// Rows past which a segment goes to seg_sum_long (the wrapper sizes the
// long-segment list from it: at most M / (kWalkMax + 1) entries).
extern "C" int segment_sum_walk_max() { return kWalkMax; }

// Launches the walk and, if long_blocks > 0, the long-segment pass on
// `stream`; returns cudaGetLastError() (0 on success). long_starts holds at
// least M / (kWalkMax + 1) entries; n_long is one int, zeroed here. out is
// written whole. Allocates nothing and does not synchronise.
extern "C" int segment_sum_sorted_launch(const float* g, const void* seg, int seg_bytes,
                                         const unsigned char* skip_last,
                                         long long M, int k, long long n_slots, float* out,
                                         long long* long_starts, int* n_long,
                                         int long_blocks, void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (M < 1 || k < 1 || n_slots < 1 || (seg_bytes != 4 && seg_bytes != 8) ||
      long_blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{g, seg, seg_bytes, skip_last, M, k, n_slots, out, long_starts, n_long};
  cudaError_t e = cudaMemsetAsync(n_long, 0, sizeof(int), cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long threads = M > n_slots ? M : n_slots;
  seg_sum_walk<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0,
                 cs>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (long_blocks > 0) {
    seg_sum_long<<<long_blocks, kLongThreads, 0, cs>>>(a);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
