// The card's sustained rate of ex2.approx.ftz.f32, the exponential of the
// attention kernel (csrc/attention.cu), for tools/ex2_rate.py:
//
//   sgc_ex2_rate(out, blocks, iters, stream)
//
// launches `blocks` blocks of 256 threads; each thread runs 16 independent
// chains of `iters` (ex2, then a subtraction so the chain is not folded)
// and writes one float to out[blocks * 256].  Exponentials launched:
// blocks * 256 * 16 * iters.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__global__ void ex2_chains(float* out, int iters) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    v[i] = -0.001f * static_cast<float>(threadIdx.x + i);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[i] = ex2(v[i]) - 1.0f;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    s += v[i];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int sgc_ex2_rate(void* out, int blocks, int iters, void* stream) {
  ex2_chains<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
