// The work poisson_knuth's function needs, and none of its design: a
// thread walks rows, each row's Knuth loop run to its end. An iteration is
// the table read, the hash, the uniform's conversion, logf, the add, the
// compare and the count; a row is its counter, the loop's start, the store
// of its count and the step to the next row. Never launched: chip_smoke.py
// compiles it (nvcc -cubin, the package's code-generation flags) and counts
// the instructions of the inner loop's pass (an iteration) and of the outer
// loop's pass less the inner loop (a row) in its SASS, to bound
// poisson_knuth from the operations its function needs. The hash, logf and
// the float steps are prng.cu's own (included), so the count moves only
// when they do.

#include "../orange3_spark_tpu_torch/ops/csrc/prng.cu"

extern "C" __global__ void knuth_work(const uint2* __restrict__ table, int rows,
                                      uint32_t c0, uint32_t row0, float neg_lam,
                                      int* __restrict__ out) {
#pragma unroll 1
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const uint32_t c1 = row0 + static_cast<uint32_t>(r);
    int j = 0;
    float log_prod = 0.0f;
#pragma unroll 1
    do {
      const uint2 s = table[j];
      uint32_t x0 = c0, x1 = c1;
      threefry2x32(s.x, s.y, x0, x1);
      const uint32_t b = x0 ^ x1;
      const float u = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
      log_prod = __fadd_rn(log_prod, logf(u));
      ++j;
    } while (log_prod > neg_lam);
    out[r] = j - 1;
  }
}
