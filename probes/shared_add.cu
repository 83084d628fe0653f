// Throughput of shared-memory atomic adds on the card, by type and by how
// many addresses the adds contend for. Not part of the package: it measures
// what the node x bin histogram kernel is built from (probes/shared_add.py
// builds and runs it).
//
// Every thread draws its addresses from a xorshift stream, so the loop reads
// no device memory: the time is the adds' own.

#include <cuda_runtime.h>

namespace {

enum Kind {
  kF32 = 0,       // atomicAdd(float*)
  kF32Red = 1,    // red.shared.add.f32
  kU32 = 2,       // atomicAdd(unsigned*), a constant 1 (the compiler may
                  // aggregate it across the warp)
  kU64 = 3,       // atomicAdd(unsigned long long*)
  kU32Var = 4,    // atomicAdd(unsigned*) of a value that varies by lane
  kFix64 = 5,     // 64-bit fixed point from two 32-bit words: the low word
                  // by atomicAdd, the high word only on a carry or borrow
  kF32x2Cas = 6,  // two floats added by one 64-bit compare-and-swap
  kF32x4Cas = 7,  // four floats added by one 128-bit compare-and-swap
};

// Adds the signed 64-bit v to the fixed-point cell (lo, hi = lo + 1): the
// low word takes v's low 32 bits with a native add; the high word takes
// v's high word plus the carry, which is zero for most adds of small |v|.
__device__ __forceinline__ void fix64_add(unsigned* cell, long long v) {
  const unsigned vlo = (unsigned)v;
  const unsigned old = atomicAdd(cell, vlo);
  const unsigned carry = (old + vlo) < old;
  const unsigned hi = (unsigned)((unsigned long long)v >> 32) + carry;
  if (hi != 0u) atomicAdd(cell + 1, hi);
}

__device__ __forceinline__ void f32x2_cas_add(float* p, float a, float b) {
  unsigned long long* q = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *q, assumed;
  do {
    assumed = old;
    float2 f = *reinterpret_cast<float2*>(&assumed);
    f.x += a;
    f.y += b;
    old = atomicCAS(q, assumed, *reinterpret_cast<unsigned long long*>(&f));
  } while (old != assumed);
}

__device__ __forceinline__ void f32x4_cas_add(float* p, float a, float b, float c) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  const volatile float* vp = p;
  float4 cur = make_float4(vp[0], vp[1], vp[2], vp[3]);
  while (true) {
    float4 nxt = make_float4(cur.x + a, cur.y + b, cur.z + c, cur.w);
    unsigned long long clo, chi, nlo, nhi, olo, ohi;
    clo = (unsigned long long)__float_as_uint(cur.x) | ((unsigned long long)__float_as_uint(cur.y) << 32);
    chi = (unsigned long long)__float_as_uint(cur.z) | ((unsigned long long)__float_as_uint(cur.w) << 32);
    nlo = (unsigned long long)__float_as_uint(nxt.x) | ((unsigned long long)__float_as_uint(nxt.y) << 32);
    nhi = (unsigned long long)__float_as_uint(nxt.z) | ((unsigned long long)__float_as_uint(nxt.w) << 32);
    asm volatile(
        "{\n\t.reg .b128 dd, bb, cc;\n\t"
        "mov.b128 bb, {%2, %3};\n\t"
        "mov.b128 cc, {%4, %5};\n\t"
        "atom.shared.cas.b128 dd, [%6], bb, cc;\n\t"
        "mov.b128 {%0, %1}, dd;\n\t}"
        : "=l"(olo), "=l"(ohi)
        : "l"(clo), "l"(chi), "l"(nlo), "l"(nhi), "r"(addr)
        : "memory");
    if (olo == clo && ohi == chi) break;
    cur.x = __uint_as_float((unsigned)olo);
    cur.y = __uint_as_float((unsigned)(olo >> 32));
    cur.z = __uint_as_float((unsigned)ohi);
    cur.w = __uint_as_float((unsigned)(ohi >> 32));
  }
}

template <int KIND>
__global__ void __launch_bounds__(512)
probe_kernel(unsigned long long* out, int n_addr, int iters, unsigned seed,
             int bank_free) {
  extern __shared__ unsigned long long smem64[];
  float* f = reinterpret_cast<float*>(smem64);
  unsigned* u = reinterpret_cast<unsigned*>(smem64);
  unsigned long long* q = smem64;
  // every kind fits 16 bytes a cell: n_addr * 16 <= 64 KB
  for (int i = threadIdx.x; i < 4 * n_addr; i += blockDim.x) u[i] = 0u;
  __syncthreads();
  unsigned x = seed ^ ((blockIdx.x * blockDim.x + threadIdx.x + 1) * 2654435761u);
  for (int i = 0; i < iters; ++i) {
    x ^= x << 13; x ^= x >> 17; x ^= x << 5;
    // bank_free: lane l of a warp takes a random line and word l of it, so
    // the warp's 32 cells fall in 32 different banks
    const unsigned a = bank_free ? __umulhi(x, (unsigned)n_addr / 32u) * 32u + (threadIdx.x & 31u)
                                 : __umulhi(x, (unsigned)n_addr);
    if (KIND == kF32) {
      atomicAdd(f + a, 1.0f);
    } else if (KIND == kF32Red) {
      const unsigned addr = (unsigned)__cvta_generic_to_shared(f + a);
      asm volatile("red.shared.add.f32 [%0], %1;" ::"r"(addr), "f"(1.0f) : "memory");
    } else if (KIND == kU32) {
      atomicAdd(u + a, 1u);
    } else if (KIND == kU64) {
      atomicAdd(q + a, 1ull);
    } else if (KIND == kU32Var) {
      atomicAdd(u + a, (x & 6u) + 1u);
    } else if (KIND == kFix64) {
      // a signed value of up to 2^24 in magnitude, as the scaled stats are
      fix64_add(u + 2 * a, (long long)(int)(x & 0x1ffffffu) - (1 << 24));
    } else if (KIND == kF32x2Cas) {
      f32x2_cas_add(f + 2 * a, 1.0f, 2.0f);
    } else {
      f32x4_cas_add(f + 4 * a, 1.0f, 2.0f, 3.0f);
    }
  }
  __syncthreads();
  unsigned long long total = 0;
  for (int i = threadIdx.x; i < n_addr; i += blockDim.x) {
    if (KIND == kF32 || KIND == kF32Red) total += (unsigned long long)f[i];
    else if (KIND == kU32 || KIND == kU32Var) total += u[i];
    else if (KIND == kU64) total += q[i];
    else if (KIND == kFix64) total += u[2 * i] + u[2 * i + 1];
    else if (KIND == kF32x2Cas) total += (unsigned long long)f[2 * i];
    else total += (unsigned long long)f[4 * i];
  }
  atomicAdd(out, total);
}

template <int KIND>
int run(unsigned long long* out, int blocks, int n_addr, int iters, int reps,
        int bank_free, float* ms) {
  const int smem = 64 * 1024;
  cudaError_t e = cudaFuncSetAttribute(
      probe_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  probe_kernel<KIND><<<blocks, 512, smem>>>(out, n_addr, iters, 1u, bank_free);  // warm
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int r = 0; r < reps; ++r)
    probe_kernel<KIND><<<blocks, 512, smem>>>(out, n_addr, iters, 7u + r, bank_free);
  cudaEventRecord(b);
  e = cudaEventSynchronize(b);
  if (e != cudaSuccess) return (int)e;
  cudaEventElapsedTime(ms, a, b);
  *ms /= reps;
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: a Kind above. Writes the mean ms of one launch and the number of adds
// it counted (for a check that every add landed). Returns a cudaError_t.
extern "C" int shared_add_probe(int kind, int blocks, int n_addr, int iters,
                                int reps, int bank_free, float* ms,
                                unsigned long long* counted) {
  unsigned long long* out = nullptr;
  cudaError_t e = cudaMalloc(&out, sizeof(unsigned long long));
  if (e != cudaSuccess) return (int)e;
  cudaMemset(out, 0, sizeof(unsigned long long));
  int rc;
  switch (kind) {
    case kF32: rc = run<kF32>(out, blocks, n_addr, iters, reps, bank_free, ms); break;
    case kF32Red: rc = run<kF32Red>(out, blocks, n_addr, iters, reps, bank_free, ms); break;
    case kU32: rc = run<kU32>(out, blocks, n_addr, iters, reps, bank_free, ms); break;
    case kU64: rc = run<kU64>(out, blocks, n_addr, iters, reps, bank_free, ms); break;
    case kU32Var: rc = run<kU32Var>(out, blocks, n_addr, iters, reps, bank_free, ms); break;
    case kFix64: rc = run<kFix64>(out, blocks, n_addr, iters, reps, bank_free, ms); break;
    case kF32x2Cas: rc = run<kF32x2Cas>(out, blocks, n_addr, iters, reps, bank_free, ms); break;
    default: rc = run<kF32x4Cas>(out, blocks, n_addr, iters, reps, bank_free, ms); break;
  }
  cudaMemcpy(counted, out, sizeof(unsigned long long), cudaMemcpyDeviceToHost);
  cudaFree(out);
  return rc;
}
