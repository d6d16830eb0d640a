// Fused DETR-encoder self-attention: softmax(q k^T * scale) v with key-only
// padding masks.  One kernel with a plain C entry point for ctypes:
//
//   sgc_attention   out[b, i, h, :] = sum_j p[b, h, i, j] * v[b, j, h, :]
//
// q, k, v, out: contiguous (B, L, H, 32), the layout the q/k/v projections
// produce, so no transpose is made; valid: optional (B, L) uint8, nonzero =
// a real key (the torch key_padding_mask inverted).  float32 or bfloat16.
//
// Replaces the TPU kernel `_attn_kernel` of
// scene_graph_commonsense_tpu/ops/pallas/attention.py (reached through
// `fused_attention`).  It keeps that kernel's rounding points, not its
// blocking:
//   * s = (q . k) accumulated in float32, THEN multiplied by `scale` in
//     float32;
//   * masked keys are filled with -3e38 (not -inf), so a row whose keys are
//     all masked gets the uniform softmax;
//   * s - rowmax, exp, divided by the row sum, all in float32;
//   * p is rounded to v's dtype before the p.v product, which accumulates in
//     float32; the output is rounded once to q's dtype.
// The TPU kernel holds a whole (1024 x 1024) float32 score tile in VMEM and
// takes a one-shot softmax.  A Hopper block cannot hold that, and an online
// softmax (rescaling the output as the max grows) would round p elsewhere.
// So each block makes two passes over the keys of its (b, h):
//   pass 1: the row max and the row sum of exp(s - max) (the sum rescaled
//           once per 32 keys when the max grows: a summation-order change
//           only, the max and every p are exact as on the TPU);
//   pass 2: s again, p = exp(s - max) / sum rounded to v's dtype, o += p v.
//
// Bound at the DETR shape (B = 12, H = 8, L = 1024, d = 32): 12.9 GFLOP of
// products (13 us at the 989 TFLOP/s bf16 tensor-core peak), 25 MB moved
// (7.5 us) and 100.7 M exponentials, which at 16 per clock per SM on 132
// SMs take ~24 us: the exponentials set the bound.  Both kernels below
// compute every score twice (once per pass) and take two exponentials and
// a division per score.  Two kernels, one per dtype:
//
// bfloat16 (the production path), attention_tc_kernel: the products on the
// tensor cores through WMMA (16x16x16 bf16 tiles, float32 accumulators:
// exact products summed in float32, as on the TPU's MXU).
//   * one block of 4 warps per (b, h, 64 query rows), each warp owning 16
//     rows; its q fragments are loaded once;
//   * keys and values are staged 64 at a time in shared memory (16-byte
//     loads, rows padded against bank conflicts); per chunk each warp
//     computes its (16 x 64) float32 score tile, which goes through shared
//     memory to the softmax arithmetic: two lanes per row, 32 scores each;
//   * pass 2 writes the rounded bf16 p tile to shared memory and adds
//     p v into two (16 x 16) float32 accumulators per warp.
//   L must be a multiple of 64.
//
// float32 (the card-vs-CPU parity runs), attention_kernel: float32 FMAs,
// since the tensor cores would round float32 operands to TF32.
//   * one block of 128 threads per (b, h, 128 query rows); each thread owns
//     one query row: q in registers as float32, the output accumulator in
//     registers;
//   * keys and values are staged 64 at a time in shared memory as float32;
//     every thread of a warp reads the same key row, so the shared-memory
//     reads are broadcasts;
//   * any L.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kDh = 32;         // head width (DETR: 256 / 8)
constexpr int kRows = 128;      // query rows per block, one per thread
constexpr int kChunk = 64;      // keys staged in shared memory at a time
constexpr int kSub = 32;        // scores a thread holds at once in pass 1
constexpr float kMaskFill = -3.0e38f;

struct Stage {
  float4 k[kChunk][kDh / 4];
  float4 v[kChunk][kDh / 4];
  uint8_t live[kChunk];         // a key of this chunk inside [0, L)
  uint8_t valid[kChunk];        // ... and not masked
};

// Stages keys [j0, j0 + kChunk) of one (b, h) (and their values if
// with_v).  base: the element offset of (b, token 0, h, 0).
__device__ __forceinline__ void stage(Stage& st, const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const uint8_t* __restrict__ valid,
                                      size_t base, size_t tok, int j0, int l,
                                      int b, bool with_v) {
  float* ks = reinterpret_cast<float*>(st.k);
  float* vs = reinterpret_cast<float*>(st.v);
  for (int i = threadIdx.x; i < kChunk * kDh; i += kRows) {
    const int j = i / kDh;
    const int d = i - j * kDh;
    const bool in = j0 + j < l;
    const size_t off = base + static_cast<size_t>(j0 + j) * tok + d;
    ks[i] = in ? k[off] : 0.f;
    if (with_v) {
      vs[i] = in ? v[off] : 0.f;
    }
  }
  if (threadIdx.x < kChunk) {
    const int j = j0 + threadIdx.x;
    const bool in = j < l;
    st.live[threadIdx.x] = in;
    st.valid[threadIdx.x] =
        in && (valid == nullptr ||
               valid[static_cast<size_t>(b) * l + j] != 0);
  }
}

// The score of key j of the staged chunk: the float32 dot, then the scale,
// then the mask fill; -inf for a key beyond L (it takes no part).
__device__ __forceinline__ float score(const Stage& st, const float* qr,
                                       int j, float scale) {
  if (!st.live[j]) {
    return -INFINITY;
  }
  float s = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < kDh / 4; ++d4) {
    const float4 kv = st.k[j][d4];
    s = fmaf(qr[4 * d4], kv.x, s);
    s = fmaf(qr[4 * d4 + 1], kv.y, s);
    s = fmaf(qr[4 * d4 + 2], kv.z, s);
    s = fmaf(qr[4 * d4 + 3], kv.w, s);
  }
  s = s * scale;
  return st.valid[j] ? s : kMaskFill;
}

__global__ void __launch_bounds__(kRows)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ valid, float* __restrict__ out,
                 int l, int h, float scale) {
  __shared__ Stage st;
  const int b = blockIdx.z;
  const int hh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < l;
  const size_t tok = static_cast<size_t>(h) * kDh;
  const size_t base = static_cast<size_t>(b) * l * tok +
                      static_cast<size_t>(hh) * kDh;

  float qr[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    qr[d] = live ? q[base + static_cast<size_t>(row) * tok + d] : 0.f;
  }

  // pass 1: row max and sum of exponentials
  float m = -INFINITY;
  float sum = 0.f;
  for (int j0 = 0; j0 < l; j0 += kChunk) {
    __syncthreads();
    stage(st, k, v, valid, base, tok, j0, l, b, false);
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < kChunk; c0 += kSub) {
      float s[kSub];
      float cm = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        s[j] = score(st, qr, c0 + j, scale);
        cm = fmaxf(cm, s[j]);
      }
      if (cm == -INFINITY) {
        continue;                       // keys beyond L only
      }
      const float mn = fmaxf(m, cm);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        part += expf(s[j] - mn);
      }
      sum = (m == mn ? sum : sum * expf(m - mn)) + part;
      m = mn;
    }
  }

  // pass 2: normalised p times v
  float o[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    o[d] = 0.f;
  }
  for (int j0 = 0; j0 < l; j0 += kChunk) {
    __syncthreads();
    stage(st, k, v, valid, base, tok, j0, l, b, true);
    __syncthreads();
    for (int j = 0; j < kChunk; ++j) {
      const float s = score(st, qr, j, scale);
      const float p = expf(s - m) / sum;
#pragma unroll
      for (int d4 = 0; d4 < kDh / 4; ++d4) {
        const float4 vv = st.v[j][d4];
        o[4 * d4] = fmaf(p, vv.x, o[4 * d4]);
        o[4 * d4 + 1] = fmaf(p, vv.y, o[4 * d4 + 1]);
        o[4 * d4 + 2] = fmaf(p, vv.z, o[4 * d4 + 2]);
        o[4 * d4 + 3] = fmaf(p, vv.w, o[4 * d4 + 3]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < kDh; ++d) {
      out[base + static_cast<size_t>(row) * tok + d] = o[d];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through WMMA
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace nvcuda;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;     // query rows per block
// row strides in elements, padded by 16 bytes against bank conflicts
constexpr int kKVs = kDh + 8;          // staged keys / values (bf16)
constexpr int kSs = kChunk + 4;        // a warp's float32 score tile
constexpr int kPs = kChunk + 8;        // a warp's bf16 p tile
constexpr int kOs = kDh + 4;           // a warp's float32 output tile

// every WMMA tile pointer below is 32-byte aligned: the members are, and
// each row stride times 16 rows is a multiple of 32 bytes
struct Smem {
  alignas(32) bf16 k[kChunk * kKVs];
  alignas(32) bf16 v[kChunk * kKVs];
  alignas(32) float s[kWarps][16 * kSs];   // reused for the output
  alignas(32) bf16 p[kWarps][16 * kPs];
  uint8_t valid[kChunk];
};
static_assert(16 * kOs <= 16 * kSs, "output tile");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragKt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                              wmma::col_major>;
using FragV = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Stages keys [j0, j0 + kChunk) (and their values if with_v) of one (b, h)
// and their mask bytes.
__device__ __forceinline__ void stage(Smem& sm, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v,
                                      const uint8_t* __restrict__ valid,
                                      size_t base, size_t tok, int j0, int l,
                                      int b, bool with_v) {
  constexpr int kVecs = kDh / 8;                     // 16-byte vectors a row
  for (int i = threadIdx.x; i < kChunk * kVecs; i += kThreads) {
    const int j = i / kVecs;
    const int c = (i - j * kVecs) * 8;
    const size_t off = base + static_cast<size_t>(j0 + j) * tok + c;
    *reinterpret_cast<uint4*>(&sm.k[j * kKVs + c]) =
        *reinterpret_cast<const uint4*>(&k[off]);
    if (with_v) {
      *reinterpret_cast<uint4*>(&sm.v[j * kKVs + c]) =
          *reinterpret_cast<const uint4*>(&v[off]);
    }
  }
  if (threadIdx.x < kChunk) {
    sm.valid[threadIdx.x] =
        valid == nullptr ||
        valid[static_cast<size_t>(b) * l + j0 + threadIdx.x] != 0;
  }
}

// The warp's (16 x kChunk) float32 products q.k of the staged chunk into
// its score tile.
__device__ __forceinline__ void scores(Smem& sm, const FragA* qa, int warp) {
#pragma unroll
  for (int n = 0; n < kChunk / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      FragKt kt;
      wmma::load_matrix_sync(kt, &sm.k[n * 16 * kKVs + kk * 16], kKVs);
      wmma::mma_sync(acc, qa[kk], kt, acc);
    }
    wmma::store_matrix_sync(&sm.s[warp][n * 16], acc, kSs,
                            wmma::mem_row_major);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const uint8_t* __restrict__ valid, bf16* __restrict__ out,
                    int l, int h, float scale) {
  __shared__ Smem sm;
  const int b = blockIdx.z;
  const int hh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t tok = static_cast<size_t>(h) * kDh;
  const size_t base = static_cast<size_t>(b) * l * tok +
                      static_cast<size_t>(hh) * kDh;
  const int row0 = blockIdx.x * kRows + warp * 16;    // the warp's rows

  FragA qa[kDh / 16];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    wmma::load_matrix_sync(
        qa[kk], &q[base + static_cast<size_t>(row0) * tok + kk * 16],
        static_cast<unsigned>(tok));
  }
  // two lanes per row, 32 scores of each chunk each
  const int r = lane / 2;
  const int c0 = (lane % 2) * 32;
  const float* srow = &sm.s[warp][r * kSs + c0];

  // pass 1: row max and sum of exponentials
  float m = -INFINITY;
  float sum = 0.f;
  for (int j0 = 0; j0 < l; j0 += kChunk) {
    __syncthreads();
    stage(sm, k, v, valid, base, tok, j0, l, b, false);
    __syncthreads();
    scores(sm, qa, warp);
    float sv[32];
    float cm = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float sc = srow[j] * scale;
      sv[j] = sm.valid[c0 + j] ? sc : kMaskFill;
      cm = fmaxf(cm, sv[j]);
    }
    const float mn = fmaxf(m, cm);
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      part += expf(sv[j] - mn);
    }
    sum = (m == mn ? sum : sum * expf(m - mn)) + part;
    m = mn;
    __syncwarp();
  }
  {
    // join the two halves of each row
    const float om = __shfl_xor_sync(0xffffffffu, m, 1);
    const float os = __shfl_xor_sync(0xffffffffu, sum, 1);
    const float mn = fmaxf(m, om);
    const float a = m == mn ? sum : sum * expf(m - mn);
    const float o = om == mn ? os : os * expf(om - mn);
    sum = (lane % 2 == 0) ? a + o : o + a;
    m = mn;
  }

  // pass 2: normalised p, rounded to bf16, times v
  FragC acc[kDh / 16];
#pragma unroll
  for (int n = 0; n < kDh / 16; ++n) {
    wmma::fill_fragment(acc[n], 0.f);
  }
  bf16* prow = &sm.p[warp][r * kPs + c0];
  for (int j0 = 0; j0 < l; j0 += kChunk) {
    __syncthreads();
    stage(sm, k, v, valid, base, tok, j0, l, b, true);
    __syncthreads();
    scores(sm, qa, warp);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float sc = srow[j] * scale;
      const float s = sm.valid[c0 + j] ? sc : kMaskFill;
      prow[j] = __float2bfloat16_rn(expf(s - m) / sum);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      FragA pa;
      wmma::load_matrix_sync(pa, &sm.p[warp][kk * 16], kPs);
#pragma unroll
      for (int n = 0; n < kDh / 16; ++n) {
        FragV vb;
        wmma::load_matrix_sync(vb, &sm.v[kk * 16 * kKVs + n * 16], kKVs);
        wmma::mma_sync(acc[n], pa, vb, acc[n]);
      }
    }
    __syncwarp();
  }

  // the warp's (16 x 32) output, rounded once to bf16
  float* ot = sm.s[warp];
#pragma unroll
  for (int n = 0; n < kDh / 16; ++n) {
    wmma::store_matrix_sync(&ot[n * 16], acc[n], kOs, wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kDh; i += 32) {
    const int rr = i / kDh;
    const int d = i - rr * kDh;
    out[base + static_cast<size_t>(row0 + rr) * tok + d] =
        __float2bfloat16_rn(ot[rr * kOs + d]);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* out, int b, int l, int h,
                   float scale, cudaStream_t stream) {
  const dim3 grid(l / kRows, h, b);
  attention_tc_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(valid),
      static_cast<bf16*>(out), l, h, scale);
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

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* out, int b, int l, int h,
                   float scale, cudaStream_t stream) {
  const dim3 grid((l + kRows - 1) / kRows, h, b);
  attention_kernel<<<grid, kRows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), l, h, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.  The
// caller guarantees contiguous, 16-byte aligned (b, l, h, 32) q, k, v and
// out of one dtype, b, l, h >= 1 (l a multiple of 64 for bfloat16), and
// valid either null or a contiguous (b, l) uint8 array.
// Returns the cudaError_t of the launch.
extern "C" int sgc_attention(const void* q, const void* k, const void* v,
                             const void* valid, void* out, int b, int l,
                             int h, float scale, int dtype, int device,
                             void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch(q, k, v, valid, out, b, l, h, scale, st));
    case 1:
      return static_cast<int>(
          tc::launch(q, k, v, valid, out, b, l, h, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
