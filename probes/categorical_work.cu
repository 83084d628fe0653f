// The work categorical_gumbel's function needs, and none of its design: a
// thread walks the V elements of one draw, each the hash of its word, the
// uniform, XLA's log twice, the add of the logit and the compare that keeps
// the first maximum. Never launched: chip_smoke.py compiles it (nvcc -cubin,
// the package's code-generation flags) and counts the instructions of the
// loop's pass in its SASS, to bound categorical_gumbel from the operations
// its function needs (an element's pass times the draw's elements). The
// hash, the uniform and the logs are prng.cu's own (included), so the count
// moves only when they do. Built with -DPRNG_FMA32_SINGLE, each of the
// logs' multiply-adds is one FFMA: that is the count of the bound (it gives
// the same bits as the kernel's float64 form for every uniform JAX draws);
// built without, it counts the kernel's float64 form, printed beside it.

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
