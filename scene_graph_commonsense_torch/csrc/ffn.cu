// Fused transformer FFN + residual + LayerNorm of the DETR encoder.  Two
// kernels behind one plain C entry point for ctypes:
//
//   sgc_ffn_ln   out = LayerNorm(x + relu(x W1 + b1) W2 + b2)
//
// x, out: contiguous (N, 256) float32 (the post-norm residual stream);
// b1 (F), b2, gamma, beta (256): float32; the weights in the compute dtype:
// float32 w1 (256, F) and w2 (F, 256), the flax (in, out) layout; bfloat16
// their transposes W1^T (F, 256) and W2^T (256, F), nn.Linear's (out, in)
// layout (ops/ffn.py kernel_weights).
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
// Bound at the DETR shape (N = 12 * 1024, D = 256, F = 2048; H100 SXM, 989
// TFLOP/s bf16, 3.35 TB/s): 25.8 GFLOP of products (26 us) against 27 MB
// moved (8 us): the products set the bound.  A 128-token tile is 268 MFLOP,
// 36 us at one SM's share of the peak, so the 96 tiles at N = 12288 take
// one round on 132 SMs (0.036 ms) and the 192 at N = 24576 two (0.072 ms).
//
// bfloat16 (the production path), ffn_ln_hopper, on the warp-specialised
// pipeline of csrc/hopper_pipe.cuh (K3's):
//   * a block owns 128 tokens: two consumer warpgroups of 64 rows each
//     stage their rows of x rounded to bf16 in shared memory, K-major in
//     TMA's 128-byte swizzle (TMA cannot round float32 to bf16);
//   * F is walked in chunks of 64.  One producer thread issues TMA copies
//     of each chunk's W1^T rows (64 x 256) and W2^T columns (256 x 64),
//     32 KB each, into a ring of 5 slots; both are K-major, so the kernel
//     reads nn.Linear's weights as they are.  Clusters of 2 blocks share
//     every chunk: each block loads half its rows and multicasts them to
//     both.  Every cluster reads the 2 MB of weights from L2 once: 0.10 GB
//     a launch at N = 12288 (0.018 ms at 5.5 TB/s; read once per 64-token
//     tile, as the WMMA kernel did, it was 0.40 GB, 0.073 ms);
//   * per chunk and warpgroup: h = x W1[:, chunk] on wgmma m64n64k16 (16
//     k-steps, both operands in shared memory); b1, ReLU and the rounding
//     to bf16 in registers, where the m64n64 accumulators already lie as
//     the m16n8k16 A fragments of the second product; y += h W2[chunk, :]
//     on wgmma m64n256k16 with A from registers (4 k-steps), y's 128
//     accumulators a thread in registers for the whole F loop.  h never
//     touches shared memory.  The second product is left in flight under
//     the next chunk's first; the two warpgroups run the same loop, so
//     one's bias/ReLU/rounding runs under the other's products;
//   * the epilogue adds b2 and x (re-read in float32 from L2), takes each
//     row's two-pass statistics over the quad of lanes holding it
//     (shuffles) and stores 16-byte vectors, lane pairs trading halves.
//   Any N (partial tiles and clusters are masked) and any F that is a
//   multiple of 64.
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
#include <stdint.h>

#include "hopper_pipe.cuh"

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
// bfloat16: ffn_ln_hopper (see the design note)
// ---------------------------------------------------------------------------

namespace hopper {

using sgc::hop::align_smem;
using sgc::hop::kConsumerRegs;
using sgc::hop::kProducerRegs;
using sgc::hop::kSmemMax;
using sgc::hop::kThreads;
using sgc::hop::make_rings;
using sgc::hop::pack2;
using sgc::hop::Rings;

constexpr int kRows = 128;              // tokens a block: 64 a consumer WG
constexpr int kChunk = 64;              // F columns a chunk
constexpr int kAtom = 64 * 128;         // 64 rows x 64 K values of bf16

// The ring: SW slots of one weight chunk each (the chunk's W1 rows, or its
// W2 columns: 64 x 256 bf16, 32 KB) beside the block's x tile (128 x 256
// bf16, 64 KB); no box ring.
struct Cfg {
  static constexpr int SX = 0, XB = 0;
  static constexpr int WB = kChunk * kD * 2;
  static constexpr int XS = kRows * kD * 2;
  static constexpr int SW = sgc::hop::cmin(
      (kSmemMax - 1024 - XS - 16 * 8) / WB, 8);
  static constexpr int SMEM = 1024 + SW * WB + XS + 16 * SW;
  static_assert(SW >= 3, "a chunk (two slots) in flight beside one in use");
};

// The producer: W1 and W2 of chunk after chunk, each slot multicast to
// both blocks of the cluster, this block loading half of its rows.  w1m
// views W1^T (F, D) in boxes of 64 K values x 32 rows, w2m W2^T (D, F) in
// boxes of 64 K values x 128 rows; a slot holds its chunk in the K-major
// layout wgmma reads (atoms of 64 K values, rows 128 bytes apart).
__device__ void produce(Rings<Cfg>& ring, const CUtensorMap* w1m,
                        const CUtensorMap* w2m, int f, unsigned rank) {
  for (int f0 = 0; f0 < f; f0 += kChunk) {
    int s = ring.w.acquire(Cfg::WB);
    for (int q = 0; q < kD / 64; ++q) {
      sgc::tma_load_2d_multicast(ring.w.slot(s) + q * kAtom + rank * 32 * 128,
                                 w1m, ring.w.full(s), 64 * q, f0 + 32 * rank,
                                 0x3);
    }
    s = ring.w.acquire(Cfg::WB);
    sgc::tma_load_2d_multicast(ring.w.slot(s) + rank * 128 * 128, w2m,
                               ring.w.full(s), f0, 128 * rank, 0x3);
  }
}

// A K-major operand in TMA's 128-byte swizzle: k16 step kk of rows from
// `base` (atoms of 64 K values, 8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int kk) {
  return sgc::wgmma_desc(base + (kk / 4) * kAtom + (kk % 4) * 32, 16, 1024,
                         true);
}

struct Args {
  const float* x;
  const float* b1;
  const float* b2;
  const float* gamma;
  const float* beta;
  float* out;
  int n, f;
  float eps;
};

// One consumer warpgroup: rows r0 .. r0 + 63 of the tile, xs its 32 KB of
// the staged x.
__device__ void consume(Rings<Cfg>& ring, unsigned char* xs, const Args& p,
                        int r0, int wg) {
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int c0 = 2 * (lane % 4);        // the thread's first column of an
                                        // 8-column block
  const int rw = 16 * (t / 32) + lane / 4;  // its rows rw and rw + 8

  // x rounded to bf16 in the swizzled K-major layout: row r's 16-byte
  // chunk c of atom q at q kAtom + r 128 + (c ^ r % 8) 16; zero past n
  for (int i = t; i < 64 * kD / 8; i += 128) {
    const int r = i / (kD / 8);
    const int c8 = i % (kD / 8);
    float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
    if (r0 + r < p.n) {
      const float4* src = reinterpret_cast<const float4*>(
          p.x + static_cast<size_t>(r0 + r) * kD + c8 * 8);
      v0 = src[0];
      v1 = src[1];
    }
    *reinterpret_cast<uint4*>(xs + (c8 / 8) * kAtom + r * 128 +
                              ((c8 % 8) ^ (r % 8)) * 16) =
        make_uint4(pack2(v0.x, v0.y), pack2(v0.z, v0.w), pack2(v1.x, v1.y),
                   pack2(v1.z, v1.w));
  }
  sgc::fence_proxy_async();             // wgmma reads xs through the async
  sgc::named_sync(2 + wg, 128);         // proxy
  const uint32_t xs_s = sgc::smem_addr(xs);

  float y[128];                         // (64 x 256) accumulators
  float h[32];                          // the chunk's (64 x 64) h
  unsigned a[4][4];                     // h in bf16, 4 A fragments of k16
  int prev = -1;                        // the last chunk's W2 slot
  for (int j = 0; j < p.f / kChunk; ++j) {
    // h = x W1[:, chunk]
    const int s1 = ring.w.take();
    sgc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      sgc::wgmma_ss_kk_m64n64k16(h, kdesc(xs_s, kk),
                                 kdesc(ring.w.slot(s1), kk), kk > 0);
    }
    sgc::wgmma_commit();
    sgc::wgmma_wait<0>();               // also the last chunk's h W2
    sgc::fence_acc(h);
    ring.w.release(s1);
    if (prev >= 0) {
      ring.w.release(prev);
    }
    // b1 and ReLU in float32, h rounded to bf16: the accumulators of
    // 8-column blocks 2 kk and 2 kk + 1 are A fragment kk
    const float* bias = p.b1 + j * kChunk + c0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int jb = 2 * kk + hf;
        const float2 bb =
            __ldg(reinterpret_cast<const float2*>(bias + 8 * jb));
        a[kk][2 * hf] = pack2(fmaxf(h[4 * jb] + bb.x, 0.f),
                              fmaxf(h[4 * jb + 1] + bb.y, 0.f));
        a[kk][2 * hf + 1] = pack2(fmaxf(h[4 * jb + 2] + bb.x, 0.f),
                                  fmaxf(h[4 * jb + 3] + bb.y, 0.f));
      }
    }
    // y += h W2[chunk, :], left in flight under the next chunk's h
    const int s2 = ring.w.take();
    sgc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      sgc::wgmma_m64n256k16(y, a[kk], kdesc(ring.w.slot(s2), kk),
                            j > 0 || kk > 0);
    }
    sgc::wgmma_commit();
    prev = s2;
  }
  sgc::wgmma_wait<0>();
  sgc::fence_acc(y);
  ring.w.release(prev);

  // epilogue: (y + b2) + x, the row LayerNorm over each row's quad of
  // lanes (64 values a lane), float32 out
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + rw + 8 * hf;
    const bool live = row < p.n;
    const float* xr = p.x + static_cast<size_t>(row) * kD + c0;
    float s = 0.f;
#pragma unroll
    for (int jb = 0; jb < kD / 8; ++jb) {
      const float2 bb =
          __ldg(reinterpret_cast<const float2*>(p.b2 + 8 * jb + c0));
      const float2 xv = live ? __ldg(reinterpret_cast<const float2*>(
                                   xr + 8 * jb))
                             : make_float2(0.f, 0.f);
      float& v0 = y[4 * jb + 2 * hf];
      float& v1 = y[4 * jb + 2 * hf + 1];
      v0 = (v0 + bb.x) + xv.x;
      v1 = (v1 + bb.y) + xv.y;
      s += v0 + v1;
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mu = s / kD;
    float sq = 0.f;
#pragma unroll
    for (int jb = 0; jb < kD / 8; ++jb) {
      const float d0 = y[4 * jb + 2 * hf] - mu;
      const float d1 = y[4 * jb + 2 * hf + 1] - mu;
      sq += d0 * d0 + d1 * d1;
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    const float inv = 1.0f / sqrtf(sq / kD + p.eps);
#pragma unroll
    for (int jb = 0; jb < kD / 8; ++jb) {
      const float2 g =
          __ldg(reinterpret_cast<const float2*>(p.gamma + 8 * jb + c0));
      const float2 be =
          __ldg(reinterpret_cast<const float2*>(p.beta + 8 * jb + c0));
      float& v0 = y[4 * jb + 2 * hf];
      float& v1 = y[4 * jb + 2 * hf + 1];
      v0 = __fadd_rn(__fmul_rn((v0 - mu) * inv, g.x), be.x);
      v1 = __fadd_rn(__fmul_rn((v1 - mu) * inv, g.y), be.y);
    }
  }
  // 16-byte stores: lane pairs (2u, 2u + 1) trade halves, the even lane
  // storing row rw's 4 columns from its c0, the odd one row rw + 8's 4
  // columns from its c0 - 2
  const bool odd = lane & 1;
#pragma unroll
  for (int jb = 0; jb < kD / 8; ++jb) {
    const float v0 = y[4 * jb], v1 = y[4 * jb + 1];
    const float v2 = y[4 * jb + 2], v3 = y[4 * jb + 3];
    const float g0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
    const float g1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
    const int row = r0 + rw + (odd ? 8 : 0);
    if (row < p.n) {
      *reinterpret_cast<float4*>(p.out + static_cast<size_t>(row) * kD +
                                 8 * jb + c0 - (odd ? 2 : 0)) =
          odd ? make_float4(g0, g1, v2, v3) : make_float4(v0, v1, g0, g1);
    }
  }
}

// Warpgroup 0 produces (one thread), warpgroups 1-2 consume.  A block past
// the last tile (the partner of an odd tile count) takes part in every
// multicast and slot release of its cluster and stores nothing; the
// closing cluster barrier keeps either block from leaving while its
// partner may still multicast into it or arrive on its barriers.
__global__ void __launch_bounds__(kThreads, 1)
ffn_ln_hopper(const __grid_constant__ CUtensorMap w1m,
              const __grid_constant__ CUtensorMap w2m, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  Rings<Cfg> ring = make_rings<Cfg>(smem, Cfg::XS);
  unsigned char* xs = smem + Cfg::SW * Cfg::WB;
  if (threadIdx.x < 128) {
    sgc::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      produce(ring, &w1m, &w2m, p.f, sgc::cluster_rank());
    }
  } else {
    sgc::regs_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;
    consume(ring, xs + wg * (Cfg::XS / 2), p, blockIdx.x * kRows + 64 * wg,
            wg);
  }
  sgc::cluster_sync();
}

// w1t: W1^T (F, D), w2t: W2^T (D, F), bf16.
cudaError_t launch(const void* x, const void* w1t, const void* b1,
                   const void* w2t, const void* b2, const void* gamma,
                   const void* beta, void* out, int n, int f, float eps,
                   cudaStream_t stream) {
  CUtensorMap w1m, w2m;
  if (sgc::hop::matrix_map(&w1m, w1t, f, kD, 32) != CUDA_SUCCESS ||
      sgc::hop::matrix_map(&w2m, w2t, kD, f, 128) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const Args p{static_cast<const float*>(x),
               static_cast<const float*>(b1),
               static_cast<const float*>(b2),
               static_cast<const float*>(gamma),
               static_cast<const float*>(beta),
               static_cast<float*>(out),
               n,
               f,
               eps};
  return sgc::hop::launch_clusters(ffn_ln_hopper, Cfg::SMEM,
                                   (n + kRows - 1) / kRows, 1, stream, w1m,
                                   w2m, p);
}

}  // namespace hopper

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

// Plain C entry point for ctypes.  dtype (of w1 and w2): 0 = float32 (w1
// (D, F), w2 (F, D)), 1 = bfloat16 (w1 = W1^T (F, D), w2 = W2^T (D, F)).
// The caller guarantees contiguous, 16-byte aligned tensors of the shapes
// above with D = 256, F a positive multiple of 64 and n >= 1.  Returns the
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
          hopper::launch(x, w1, b1, w2, b2, gamma, beta, out, n, f, eps,
                         st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan of the bfloat16 kernel: out = {tokens a block, consumer
// warpgroups, cluster size, weight-chunk slots, shared-memory bytes}.
extern "C" int sgc_ffn_ln_plan(int* out) {
  const int plan[5] = {hopper::kRows, sgc::hop::kConsumerThreads / 128,
                       sgc::hop::kCluster, hopper::Cfg::SW,
                       hopper::Cfg::SMEM};
  for (int i = 0; i < 5; ++i) {
    out[i] = plan[i];
  }
  return 0;
}
