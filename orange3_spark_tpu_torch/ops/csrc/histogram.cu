// Node x bin histograms of tree induction, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of orange3_spark_tpu/ops/histogram.py
// (_hist_pallas, kernel body _hist_kernel), which grow_tree in
// models/_tree.py calls once per tree level:
//
//   H[t, j, pos[t,i]*n_bins + B[i,j], c] += S[t, i, c]
//
//   B   i32[N, d]     binned features, shared by the T trees
//   S   f32[T, N, s]  per-row stats, zero on dead / padding rows
//   pos i32[T, N]     node of each row within the current level
//   H   f32[T, d, nodes*n_bins, s], zeroed by the caller
//
// What bounds it: memory. Each cell of B is read once and the adds are few
// (s per cell), far below what the card computes per byte. At HIGGS width
// (N = 10,737,856 training rows, d = 28) B alone is N*d*4 = 1.203 GB; with
// S and pos one launch moves 1.375 GB for GBT (T=1, s=3: 16 B/row) and
// 3.78 GB for the random forest (T=20, s=2: 240 B/row).
//
// Design:
// * Accumulator. The TPU kernel keeps one accumulator in VMEM across a
//   sequential grid. Hopper runs blocks in parallel and in no order, so each
//   block keeps a private fp32 histogram of one group of features in shared
//   memory, adds its rows into it with shared-memory atomics, and flushes it
//   once into global memory with atomicAdd. One global atomic per
//   (row, feature) would serialise: at level 0 a feature has only
//   n_bins * s addresses. The group is sized by the caller so that its
//   histogram stays within 48 KB.
// * Key layout. The TPU path folds pos*n_bins+B and transposes it to [d, N]
//   outside the kernel, a 1.2 GB copy at HIGGS size. Here the kernel reads
//   row-major B and pos directly and folds the key in registers.
// * Precision. Full fp32 adds, no TF32 or bf16: the reference contracts at
//   Precision.HIGHEST because rounded stats perturb the gain argmax. The
//   order of the atomic adds varies from run to run; integer-valued stats
//   (random-forest class counts) below 2^24 still sum exactly.
// * Zero stats (dead rows, the unset slots of a class one-hot) are skipped:
//   adding 0.0 to an fp32 sum that starts at +0.0 never changes it.
// * Threads of a block form [rows_per_pass][group]: neighbouring threads
//   read neighbouring features of one row of B.
// * The grid is (tree, feature group, row tile) with the tree fastest, so
//   the blocks of all trees over one row tile are scheduled together and
//   read B's rows through L2 rather than once per tree from memory.
// * Each feature's slice of the shared histogram is padded by one word, so
//   the same bin of neighbouring features falls in different banks.
// * A bin or node index out of range is dropped rather than written outside
//   the shared histogram (the plain version raises on it instead).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // ops/histogram.py sizes groups to this

__global__ void __launch_bounds__(kThreads)
node_hist_kernel(const int* __restrict__ B, const float* __restrict__ S,
                 const int* __restrict__ pos, float* __restrict__ H,
                 long long N, int d, int s, int nodes, int n_bins, int group,
                 long long rows_per_tile) {
  extern __shared__ float hist[];
  const int width = nodes * n_bins * s;  // one feature's histogram
  const int stride = width + 1;          // padded slice in shared memory
  const int t = blockIdx.x;
  const int j0 = blockIdx.y * group;
  const int g = min(group, d - j0);

  for (int i = threadIdx.x; i < g * stride; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();

  const int rows_per_pass = blockDim.x / g;
  const int row_lane = threadIdx.x / g;
  const int jl = threadIdx.x - row_lane * g;
  if (row_lane < rows_per_pass) {
    const long long r0 = (long long)blockIdx.z * rows_per_tile;
    const long long r1 = min(N, r0 + rows_per_tile);
    const float* St = S + (long long)t * N * s;
    const int* Pt = pos + (long long)t * N;
    const int* Bj = B + j0 + jl;
    float* hj = hist + jl * stride;
    for (long long r = r0 + row_lane; r < r1; r += rows_per_pass) {
      const int b = Bj[r * d];
      const int p = Pt[r];
      if ((unsigned)b >= (unsigned)n_bins || (unsigned)p >= (unsigned)nodes)
        continue;
      float* h = hj + (p * n_bins + b) * s;
      const float* sr = St + r * s;
      for (int c = 0; c < s; ++c) {
        const float v = sr[c];
        if (v != 0.f) atomicAdd(h + c, v);
      }
    }
  }
  __syncthreads();

  float* Ht = H + ((long long)t * d + j0) * width;
  for (int i = threadIdx.x; i < g * width; i += blockDim.x) {
    const int f = i / width;
    const float v = hist[i + f];  // = hist[f * stride + (i - f * width)]
    if (v != 0.f) atomicAdd(Ht + i, v);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). The
// kernel allocates nothing and does not synchronise.
extern "C" int node_histograms_launch(const int* B, const float* S,
                                      const int* pos, float* H, long long N,
                                      int d, int s, int T, int nodes,
                                      int n_bins, int group, int row_tiles,
                                      void* stream) {
  const size_t smem =
      (size_t)group * ((size_t)nodes * n_bins * s + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        node_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long rows_per_tile = (N + row_tiles - 1) / row_tiles;
  const dim3 grid(T, (d + group - 1) / group, row_tiles);
  node_hist_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      B, S, pos, H, N, d, s, nodes, n_bins, group, rows_per_tile);
  return (int)cudaGetLastError();
}

extern "C" const char* node_histograms_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
