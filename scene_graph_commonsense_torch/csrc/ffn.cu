// Fused transformer FFN + residual + LayerNorm of the DETR encoder.  One
// kernel with a plain C entry point for ctypes:
//
//   sgc_ffn_ln   out = LayerNorm(x + relu(x W1 + b1) W2 + b2)
//
// x, out: contiguous (N, 256) float32 (the post-norm residual stream);
// w1: (256, F) and w2: (F, 256) in the compute dtype (float32 or bfloat16,
// the flax (in, out) layout); b1 (F), b2, gamma, beta (256): float32.
//
// Replaces the TPU kernel `_ffn_kernel` of
// scene_graph_commonsense_tpu/ops/pallas/ffn.py (reached through
// `fused_ffn_ln`), with its rounding points:
//   * x is rounded to the compute dtype for the first product, which
//     accumulates in float32;
//   * b1 and the ReLU in float32, then h is rounded to the compute dtype;
//   * the second product accumulates in float32; b2 and the UNROUNDED
//     float32 x are added;
//   * LayerNorm with two-pass statistics (the mean, then the mean of the
//     squared deviations), eps, gamma and beta in float32; float32 out.
// As on the TPU, only x goes in and y comes out: the (N, F) intermediate
// never leaves the block.
//
// Bound at the DETR shape (N = 12 * 1024, D = 256, F = 2048): 25.8 GFLOP of
// products (26 us at the 989 TFLOP/s bf16 tensor-core peak) against 27 MB
// moved (8 us): the products set the bound.  Two kernels, one per compute
// dtype; both keep the rounding points above:
//
// bfloat16 (the production path), ffn_ln_tc_kernel: the products on the
// tensor cores through WMMA (16x16x16 bf16 tiles, float32 accumulators:
// the products are exact and summed in float32, as on the TPU's MXU).
//   * one block of 8 warps per tile of 64 tokens; x rounded to bf16 in
//     shared memory;
//   * a loop over F in chunks of 64: the chunk's W1 columns and W2 rows are
//     staged in shared memory with 16-byte loads (rows padded by 16 bytes
//     against bank conflicts); each warp computes two 16x16 tiles of
//     h = x W1 into shared memory; b1, ReLU and the rounding to bf16 are
//     one pass over the (64 x 64) chunk; then each warp adds h W2 into its
//     eight 16x16 tiles of the (64 x 256) y, which stay in registers as
//     WMMA accumulators for the whole loop;
//   * the epilogue stores y to shared memory, adds b2 and x, and one warp
//     per 8 rows takes the row statistics with shuffles.
//   The staging is synchronous (no cp.async double buffering, no wgmma):
//   each block reads both weight matrices (2 MB) from L2 once per tile.
//
// float32 (the card-vs-CPU parity runs), ffn_ln_kernel: float32 FMAs, since
// the tensor cores would round float32 operands to TF32.
//   * one block of 256 threads per tile of 32 tokens; x in shared memory;
//   * a loop over F in chunks of 32: the chunk's W1 columns and W2 rows are
//     staged in shared memory as float32; each thread computes 4 tokens x 1
//     column of h = relu(x W1 + b1) into shared memory; then each
//     thread adds h W2 into its column of the (32 x 256) float32 y
//     accumulator, which stays in registers (thread t owns column t);
//   * the epilogue adds b2 and x, and one warp per 4 rows takes the row
//     statistics with shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kD = 256;         // model width (DETR d_model), one column per
                                // thread
constexpr int kT = 32;          // tokens per block
constexpr int kF = 32;          // dim_ff chunk
constexpr int kThreads = kD;
constexpr int kRowsPerThread = kT * kF / kThreads;      // stage 1: 4
constexpr size_t kSmemFloats = kT * kD + kD * kF + kF * kD + kF * kT;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
ffn_ln_kernel(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ out, int n,
              int f, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                     // [kT][kD]  x
  float* w1s = xs + kT * kD;            // [kD][kF]  W1[:, f0:f0+kF]
  float* w2s = w1s + kD * kF;           // [kF][kD]  W2[f0:f0+kF, :]
  float* hs = w2s + kF * kD;            // [kF][kT]  h chunk, k-major
  const int t = threadIdx.x;
  const int tok0 = blockIdx.x * kT;

  for (int i = t; i < kT * kD; i += kThreads) {
    const int tok = tok0 + i / kD;
    xs[i] = tok < n ? x[static_cast<size_t>(tok0) * kD + i]
                    : 0.f;
  }

  float acc[kT];
#pragma unroll
  for (int r = 0; r < kT; ++r) {
    acc[r] = 0.f;
  }
  const int c1 = t % kF;                        // stage 1: h column
  const int r1 = (t / kF) * kRowsPerThread;     // ... and first token

  for (int f0 = 0; f0 < f; f0 += kF) {
    __syncthreads();                    // the last chunk's reads are done
    for (int i = t; i < kD * kF; i += kThreads) {
      const int k = i / kF;
      w1s[i] = w1[static_cast<size_t>(k) * f + f0 + (i - k * kF)];
    }
    for (int i = t; i < kF * kD; i += kThreads) {
      w2s[i] = w2[static_cast<size_t>(f0) * kD + i];
    }
    __syncthreads();

    // stage 1: h[r1 .. r1+3][c1] = relu(x W1 + b1)
    float h[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      h[r] = 0.f;
    }
    for (int k = 0; k < kD; k += 4) {
      const float wa = w1s[k * kF + c1];
      const float wb = w1s[(k + 1) * kF + c1];
      const float wc = w1s[(k + 2) * kF + c1];
      const float wd = w1s[(k + 3) * kF + c1];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float4 xv =
            *reinterpret_cast<const float4*>(&xs[(r1 + r) * kD + k]);
        h[r] = fmaf(xv.x, wa, h[r]);
        h[r] = fmaf(xv.y, wb, h[r]);
        h[r] = fmaf(xv.z, wc, h[r]);
        h[r] = fmaf(xv.w, wd, h[r]);
      }
    }
    const float bias1 = b1[f0 + c1];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      hs[c1 * kT + r1 + r] = fmaxf(h[r] + bias1, 0.f);
    }
    __syncthreads();

    // stage 2: y[:, t] += h W2[:, t]
    for (int k = 0; k < kF; ++k) {
      const float w = w2s[k * kD + t];
#pragma unroll
      for (int r4 = 0; r4 < kT; r4 += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(&hs[k * kT + r4]);
        acc[r4] = fmaf(hv.x, w, acc[r4]);
        acc[r4 + 1] = fmaf(hv.y, w, acc[r4 + 1]);
        acc[r4 + 2] = fmaf(hv.z, w, acc[r4 + 2]);
        acc[r4 + 3] = fmaf(hv.w, w, acc[r4 + 3]);
      }
    }
  }

  // epilogue: y = acc + b2 + x, then the row LayerNorm
  __syncthreads();
  float* ys = smem;                     // reuses xs: [kT][kD]
  const float bias2 = b2[t];
#pragma unroll
  for (int r = 0; r < kT; ++r) {
    const int tok = tok0 + r;
    const float xv = tok < n ? x[static_cast<size_t>(tok) * kD + t] : 0.f;
    ys[r * kD + t] = (acc[r] + bias2) + xv;
  }
  __syncthreads();
  const int warp = t / 32;
  const int lane = t % 32;
  constexpr int kPerLane = kD / 32;
  constexpr int kRowsPerWarp = kT / (kThreads / 32);
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int tok = tok0 + r;
    float vals[kPerLane];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      vals[i] = ys[r * kD + lane + 32 * i];
      s += vals[i];
    }
    const float mu = warp_sum(s) / kD;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const float d = vals[i] - mu;
      sq += d * d;
    }
    const float var = warp_sum(sq) / kD;
    const float inv = 1.0f / sqrtf(var + eps);
    if (tok < n) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int c = lane + 32 * i;
        const float y = (vals[i] - mu) * inv;
        out[static_cast<size_t>(tok) * kD + c] =
            __fadd_rn(__fmul_rn(y, gamma[c]), beta[c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through WMMA
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kT = 64;          // tokens per block
constexpr int kF = 64;          // dim_ff chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// shared-memory row strides in elements, padded by 16 bytes (8 bf16 or 4
// float) so that the rows of a 16x16 tile fall on different banks
constexpr int kXs = kD + 8;
constexpr int kW1s = kF + 8;
constexpr int kW2s = kD + 8;
constexpr int kHfs = kF + 4;
constexpr int kHbs = kF + 8;
constexpr int kYs = kD + 4;
constexpr size_t kXsBytes = size_t(kT) * kXs * 2;
constexpr size_t kW1Bytes = size_t(kD) * kW1s * 2;
constexpr size_t kW2Bytes = size_t(kF) * kW2s * 2;
constexpr size_t kHfBytes = size_t(kT) * kHfs * 4;
constexpr size_t kHbBytes = size_t(kT) * kHbs * 2;
constexpr size_t kW1Off = kXsBytes;
constexpr size_t kW2Off = kW1Off + kW1Bytes;
constexpr size_t kHfOff = kW2Off + kW2Bytes;
constexpr size_t kHbOff = kHfOff + kHfBytes;
constexpr size_t kSmemBytes = kHbOff + kHbBytes;
// the epilogue's float32 y reuses the weight staging area
static_assert(size_t(kT) * kYs * 4 <= kW1Bytes + kW2Bytes, "y tile");
static_assert(kXsBytes % 32 == 0 && kW1Bytes % 32 == 0 &&
                  kW2Bytes % 32 == 0 && kHfBytes % 32 == 0,
              "WMMA needs 32-byte aligned tiles");

using namespace nvcuda;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(kThreads)
ffn_ln_tc_kernel(const float* __restrict__ x, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, float* __restrict__ out,
                 int n, int f, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* w1s = reinterpret_cast<bf16*>(smem + kW1Off);
  bf16* w2s = reinterpret_cast<bf16*>(smem + kW2Off);
  float* hf = reinterpret_cast<float*>(smem + kHfOff);
  bf16* hb = reinterpret_cast<bf16*>(smem + kHbOff);
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int tok0 = blockIdx.x * kT;

  for (int i = t; i < kT * kD / 4; i += kThreads) {
    const int r = i / (kD / 4);
    const int c = (i - r * (kD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tok0 + r < n) {
      v = *reinterpret_cast<const float4*>(
          &x[static_cast<size_t>(tok0 + r) * kD + c]);
    }
    bf16* dst = &xs[r * kXs + c];
    dst[0] = __float2bfloat16_rn(v.x);
    dst[1] = __float2bfloat16_rn(v.y);
    dst[2] = __float2bfloat16_rn(v.z);
    dst[3] = __float2bfloat16_rn(v.w);
  }

  // this warp's y tiles: tile row warp / 2, tile columns (warp % 2) * 8 + j
  const int yr = warp / 2;
  const int yc0 = (warp % 2) * 8;
  FragC y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wmma::fill_fragment(y[j], 0.f);
  }

  for (int f0 = 0; f0 < f; f0 += kF) {
    __syncthreads();                    // the last chunk's reads are done
    for (int i = t; i < kD * kF / 8; i += kThreads) {
      const int k = i / (kF / 8);
      const int v = i - k * (kF / 8);
      *reinterpret_cast<uint4*>(&w1s[k * kW1s + v * 8]) =
          *reinterpret_cast<const uint4*>(
              &w1[static_cast<size_t>(k) * f + f0 + v * 8]);
    }
    for (int i = t; i < kF * kD / 8; i += kThreads) {
      const int k = i / (kD / 8);
      const int v = i - k * (kD / 8);
      *reinterpret_cast<uint4*>(&w2s[k * kW2s + v * 8]) =
          *reinterpret_cast<const uint4*>(
              &w2[static_cast<size_t>(f0 + k) * kD + v * 8]);
    }
    __syncthreads();

    // h = x W1[:, chunk]: 16 tiles of 16x16, two per warp
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tile = warp * 2 + j;
      const int hr = tile / (kF / 16);
      const int hc = tile % (kF / 16);
      FragC h;
      wmma::fill_fragment(h, 0.f);
#pragma unroll 4
      for (int k = 0; k < kD; k += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, &xs[hr * 16 * kXs + k], kXs);
        wmma::load_matrix_sync(b, &w1s[k * kW1s + hc * 16], kW1s);
        wmma::mma_sync(h, a, b, h);
      }
      wmma::store_matrix_sync(&hf[hr * 16 * kHfs + hc * 16], h, kHfs,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // b1, ReLU in float32, then h rounded to bf16
    for (int i = t; i < kT * kF; i += kThreads) {
      const int r = i / kF;
      const int c = i - r * kF;
      hb[r * kHbs + c] =
          __float2bfloat16_rn(fmaxf(hf[r * kHfs + c] + b1[f0 + c], 0.f));
    }
    __syncthreads();
    // y += h W2[chunk, :]
#pragma unroll
    for (int k = 0; k < kF; k += 16) {
      FragA a;
      wmma::load_matrix_sync(a, &hb[yr * 16 * kHbs + k], kHbs);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, &w2s[k * kW2s + (yc0 + j) * 16], kW2s);
        wmma::mma_sync(y[j], a, b, y[j]);
      }
    }
  }

  // epilogue: y to shared memory, + b2 + x (unrounded), row LayerNorm
  __syncthreads();
  float* ys = reinterpret_cast<float*>(smem + kW1Off);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wmma::store_matrix_sync(&ys[yr * 16 * kYs + (yc0 + j) * 16], y[j], kYs,
                            wmma::mem_row_major);
  }
  __syncthreads();
  constexpr int kPerLane = kD / 32;
  constexpr int kRowsPerWarp = kT / kWarps;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int tok = tok0 + r;
    if (tok >= n) {
      break;                            // warp-uniform
    }
    float vals[kPerLane];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = lane + 32 * i;
      vals[i] = (ys[r * kYs + c] + b2[c]) +
                x[static_cast<size_t>(tok) * kD + c];
      s += vals[i];
    }
    const float mu = warp_sum(s) / kD;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const float d = vals[i] - mu;
      sq += d * d;
    }
    const float var = warp_sum(sq) / kD;
    const float inv = 1.0f / sqrtf(var + eps);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = lane + 32 * i;
      const float yv = (vals[i] - mu) * inv;
      out[static_cast<size_t>(tok) * kD + c] =
          __fadd_rn(__fmul_rn(yv, gamma[c]), beta[c]);
    }
  }
}

cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* gamma,
                   const void* beta, void* out, int n, int f, float eps,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ffn_ln_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) {
    return err;
  }
  const int blocks = (n + kT - 1) / kT;
  ffn_ln_tc_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(out), n, f, eps);
  return cudaGetLastError();
}

}  // namespace tc

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) {
    err = cudaSetDevice(device);
  }
  return err;
}

cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* gamma,
                   const void* beta, void* out, int n, int f, float eps,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ffn_ln_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) {
    return err;
  }
  const int blocks = (n + kT - 1) / kT;
  ffn_ln_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(out), n, f, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  dtype (of w1 and w2): 0 = float32,
// 1 = bfloat16.  The caller guarantees contiguous, 16-byte aligned tensors
// of the shapes above with D = 256, F a positive multiple of 64 and
// n >= 1.  Returns the
// cudaError_t of the launch.
extern "C" int sgc_ffn_ln(const void* x, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* gamma,
                          const void* beta, void* out, int n, int f,
                          float eps, int dtype, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch(x, w1, b1, w2, b2, gamma, beta,
                                            out, n, f, eps, st));
    case 1:
      return static_cast<int>(
          tc::launch(x, w1, b1, w2, b2, gamma, beta, out, n, f, eps, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
