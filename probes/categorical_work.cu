// The work categorical_gumbel's function needs, and none of its design.
// Never launched: chip_smoke.py compiles it (nvcc -cubin, the package's
// code-generation flags) and counts the instructions of each loop's pass
// in its SASS. The hash, the uniform and the logs are prng.cu's own
// (included), so the counts move only when they do.
//
//   categorical_work   a full evaluation of each element: the hash of its
//                      word, the uniform, XLA's log twice (each
//                      multiply-add one FFMA), the add of the logit and the
//                      compare that keeps the first maximum. An element's
//                      pass times the draw's elements bounds a kernel that
//                      evaluates every element.
//   categorical_floor  what every element needs whatever the design: the
//                      hash of its word, the uniform's 23 bits and the read
//                      of its logit (folded into one word, so that nothing
//                      is dropped). An element's pass times the draw's
//                      elements is the function's floor, the bound of
//                      categorical_gumbel, which skips the logs of most
//                      elements.

#include "../orange3_spark_tpu_torch/ops/csrc/prng.cu"

extern "C" __global__ void categorical_work(uint32_t k0, uint32_t k1,
                                            const float* __restrict__ logits, int V,
                                            unsigned long long base, int* __restrict__ out) {
  float best = -__int_as_float(0x7F800000);
  int arg = 0;
#pragma unroll 1
  for (int v = 0; v < V; ++v) {
    const float val = __fadd_rn(gumbel_at(k0, k1, base + v), __ldg(logits + v));
    if (val > best) {
      best = val;
      arg = v;
    }
  }
  out[threadIdx.x] = arg;
}

extern "C" __global__ void categorical_floor(uint32_t k0, uint32_t k1,
                                             const float* __restrict__ logits, int V,
                                             unsigned long long base, int* __restrict__ out) {
  uint32_t acc = 0u;
#pragma unroll 1
  for (int v = 0; v < V; ++v)
    acc += (bits_at(k0, k1, base + v) >> 9) ^ __float_as_uint(__ldg(logits + v));
  out[threadIdx.x] = static_cast<int>(acc);
}
