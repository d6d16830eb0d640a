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
//   * s - rowmax, exp, normalised by the row sum, all in float32;
//   * p is rounded to v's dtype before the p.v product, which accumulates in
//     float32; the output is rounded once to q's dtype.
// The TPU kernel holds a whole (1024 x 1024) float32 score tile in VMEM and
// takes a one-shot softmax.  A Hopper block cannot hold that, and an online
// softmax (rescaling the output as the max grows) would round p elsewhere.
// So each block makes two passes over the keys of its (b, h):
//   pass 1: the row max and the row sum of exp(s - max) (the sum rescaled
//           when the max grows: a summation-order change only, the max and
//           every p are exact as on the TPU);
//   pass 2: s again, p = exp(s - max) / sum rounded to v's dtype, o += p v.
//
// Bound at the DETR shape (B = 12, H = 8, L = 1024, d = 32): 12.9 GFLOP of
// products (13 us at the 989 TFLOP/s bf16 tensor-core peak), 25 MB moved
// (7.5 us) and 100.7 M exponentials, which at 16 per clock per SM on 132
// SMs take ~24 us: the exponentials set the bound.  The two passes take two
// exponentials per score, a floor of ~48 us.  Two kernels, one per dtype:
//
// bfloat16 (the production path), attention_tc_kernel.  Every score costs
// an exponential on the special function units (16 per clock per SM, which
// tools/ex2_rate.cu measures) and ~6 float32 instructions around it in each
// pass; the design keeps everything else off the score's path:
//   * one block of 4 warps (one warpgroup) per (b, h, 128 query rows); each
//     warp owns two 16-row tiles, one in each of two 64-row warpgroup tiles,
//     whose q fragments are loaded once into registers;
//   * the products run on the Hopper warpgroup instruction wgmma (bf16
//     operands, float32 accumulators: exact products summed in float32, as
//     on the TPU's MXU): q from registers, K and V from shared memory
//     through matrix descriptors, so no fragment is loaded by hand.  The
//     (16 x 64) scores of a key chunk stay in the accumulator registers; a
//     row's max and sum join across the 4 lanes that own it with two
//     shuffles, once after pass 1.  In pass 2 the normalised p, rounded to
//     bf16 and packed in pairs, is the register A operand of p v (the
//     accumulator layout of a 16-row slice is the A layout): neither the
//     scores nor p touch shared memory;
//   * the two tiles take turns: the tensor cores work on one tile's
//     products while the other's exponentials run;
//   * exp(s - m) is ex2.approx((s - m) log2 e), log2 e applied after the
//     subtraction (-3e38 log2 e would overflow to -inf, and -inf - -inf is
//     NaN in a fully masked row), and the normalisation one reciprocal per
//     row times a multiply;
//   * keys and values are staged 64 at a time in a ring of kStages slots in
//     shared memory by cp.async (each thread's 16-byte pieces fixed once),
//     kStages - 1 chunks ahead, so the next chunks are in flight while the
//     current one is used; one barrier per chunk.  The staged layout is
//     wgmma's core matrices (8 keys x 8 head dims, 128 contiguous bytes),
//     K-major for q k^T and MN-major for p v from the same tile;
//   * the image's key mask is staged once per block; a block whose keys are
//     all real (the encoder's main path) skips the mask selects.
//   L must be a multiple of 64; a ragged last query tile is masked.
// On the H100 it runs at about half the measured exponential rate: 3
// blocks (12 warps) per SM fit in the registers, too few to hide the
// latency of a softmax stream of ~12 instructions per score (PERF.md).
//
// float32 (the card-vs-CPU parity runs), attention_kernel: float32 FMAs,
// since the tensor cores would round float32 operands to TF32.
//   * one block of 128 threads per (b, h, 128 query rows); each thread owns
//     one query row: q in registers as float32, the output accumulator in
//     registers;
//   * keys and values are staged 64 at a time in shared memory as float32;
//     every thread of a warp reads the same key row, so the shared-memory
//     reads are broadcasts;
//   * any L.  It takes two accurate expf and a division per score.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

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
// bfloat16: Hopper wgmma tensor cores, scores and p in registers
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;                     // one warpgroup per block
constexpr int kTiles = 2;                     // 16-row tiles per warp
constexpr int kStages = 3;                    // ring slots of (K, V) chunks
constexpr int kMinBlocks = 3;                 // blocks per SM (registers)
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kTiles * kWarps;   // query rows per block
// Staged K and V chunks are wgmma core matrices: 8 keys x 8 head dims, 128
// contiguous bytes each, 4 along the head dims, then the next 8 keys.
constexpr int kKeys = 64;              // keys per staged chunk
constexpr int kTile = kKeys * kDh;     // one staged K or V chunk (bf16)
constexpr int kNb = kKeys / 8;         // 8-key column blocks of a chunk
constexpr size_t kRingBytes = size_t(kStages) * 2 * kTile * sizeof(bf16);
constexpr float kLog2e = 1.4426950408889634f;

// A warp's state for one 16-row tile (the 16 rows of a 64-row warpgroup
// tile that the warp owns): the q fragments, the scores of the current
// chunk, the rows' running max and sum (then 1 / sum), the output.
struct RowTile {
  unsigned qa[2][4];        // A fragments of head dims 0-15 and 16-31
  float s[kNb][4];          // s[j]: keys 8 j + 2 t, 8 j + 2 t + 1 (t =
                            // lane % 4) of rows g (s[j][0], s[j][1]) and
                            // g + 8 (s[j][2], s[j][3]), g = lane / 4
  float m[2];               // rows g, g + 8
  float sum[2];
  float o[kDh / 8][4];      // o[n]: head dims 8 n + 2 t, + 1 of rows g, g + 8
};

// 2^x on the special function unit (subnormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16, packed with lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// Keeps the compiler from moving accesses of wgmma accumulators across the
// wait for them (the registers are written asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      asm volatile("" : "+f"(r[j][e])::"memory");
    }
  }
}

// The element offset of key r, head dims 8 c .. 8 c + 7 in a staged chunk.
__device__ __forceinline__ int tile_off(int r, int c) {
  return (r / 8) * 8 * kDh + c * 64 + (r % 8) * 8;
}

// This thread's 16-byte pieces of a staged chunk: the element offsets in
// k (or v) from the chunk's first key, and in the staged tile.
constexpr int kPieces = kKeys * (kDh / 8) / kThreads;
static_assert(kPieces * kThreads == kKeys * (kDh / 8), "whole pieces");
struct Pieces {
  int src[kPieces];
  int dst[kPieces];
};

__device__ __forceinline__ Pieces pieces(size_t tok) {
  Pieces p;
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int piece = threadIdx.x + i * kThreads;
    const int r = piece / (kDh / 8);
    const int c = piece % (kDh / 8);
    p.src[i] = r * static_cast<int>(tok) + c * 8;
    p.dst[i] = tile_off(r, c);
  }
  return p;
}

// Issues this thread's copies of one chunk into `tile`: the keys (or
// values) from `from`, the chunk's first key in k (or v).
__device__ __forceinline__ void copy_chunk(bf16* tile, const bf16* from,
                                           const Pieces& p) {
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    sgc::cp_async16_full(tile + p.dst[i], from + p.src[i]);
  }
}

// The key chunks of a block's walk x = 0 .. 2 n - 1 (x < n: pass 1 over
// the n chunks; n <= x: pass 2 over them again) in a ring of kStages slots
// of shared memory; chunk x is in slot x % kStages.
struct Ring {
  bf16* ring;
  const bf16* k;            // token 0 of this (b, h) in k and v
  const bf16* v;
  size_t chunk;             // elements from one chunk's first key to the next
  int n;
  Pieces p;

  __device__ const bf16* keys(int x) const {
    return ring + (x % kStages) * 2 * kTile;
  }
  __device__ const bf16* values(int x) const { return keys(x) + kTile; }
  // issues chunk x: its keys, and in pass 2 its values; one commit group
  // per x, empty past the end
  __device__ void issue(int x) const {
    if (x < 2 * n) {
      bf16* tile = ring + (x % kStages) * 2 * kTile;
      const size_t at = (x < n ? x : x - n) * chunk;
      copy_chunk(tile, k + at, p);
      if (x >= n) {
        copy_chunk(tile + kTile, v + at, p);
      }
    }
    sgc::cp_async_commit();
  }
  // before step x: chunk x has landed for every thread (and is visible to
  // wgmma, which reads through the async proxy), and the slot of chunk
  // x - 1 is free for chunk x + kStages - 1
  __device__ void before(int x) const {
    sgc::cp_async_wait<kStages - 2>();
    sgc::fence_proxy_async();
    __syncthreads();
    issue(x + kStages - 1);
  }
};

// The warp's q rows [row0, row0 + 16) as A fragments; rows at or past L
// read as zero.
__device__ __forceinline__ void load_q(unsigned (&qa)[2][4],
                                       const bf16* __restrict__ q,
                                       size_t base, size_t tok, int row0,
                                       int l, int lane) {
  const int g = lane / 4;
  const int t2 = 2 * (lane % 4);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + 8 * (e % 2);
      const int d = 16 * kk + 8 * (e / 2) + t2;
      qa[kk][e] = r < l ? *reinterpret_cast<const unsigned*>(
                              &q[base + static_cast<size_t>(r) * tok + d])
                        : 0u;
    }
  }
}

// Issues the products q.k of a staged key chunk for each tile, one wgmma
// group per tile: B = K^T, K-major, core matrices 128 bytes apart along
// the head dims and 8 kDh * 2 bytes along the keys; one m64n64k16 per 16
// head dims, summing in float32.
__device__ __forceinline__ void issue_products(RowTile (&rt)[kTiles],
                                               const bf16* ks) {
  sgc::wgmma_fence();
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      sgc::wgmma_m64n64k16(
          rt[i].s, rt[i].qa[kk],
          sgc::wgmma_desc(sgc::smem_addr(ks + kk * 128), 128, 16 * kDh), kk);
    }
    sgc::wgmma_commit();
  }
}

// Products -> scores, once the tile's group has landed: times scale, then
// masked keys (vm[j] == 0) set to kMaskFill.
template <bool kMasked>
__device__ __forceinline__ void scores(RowTile& t, const uint8_t* vm,
                                       float scale, int lane) {
  fence_regs(t.s);
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t.s[j][e] = __fmul_rn(t.s[j][e], scale);   // rounded, never fused
    }
    if constexpr (kMasked) {
      const uchar2 ok =
          *reinterpret_cast<const uchar2*>(vm + 8 * j + 2 * (lane % 4));
      if (!ok.x) {
        t.s[j][0] = t.s[j][2] = kMaskFill;
      }
      if (!ok.y) {
        t.s[j][1] = t.s[j][3] = kMaskFill;
      }
    }
  }
}

// Pass 1 over one chunk: the running max and sum of exp(s - max) of the
// tile's rows g (index 0) and g + 8 (index 1) over this lane's keys.
__device__ __forceinline__ void max_sum(RowTile& t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float cm = t.s[0][2 * r];
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      cm = fmaxf(cm, fmaxf(t.s[j][2 * r], t.s[j][2 * r + 1]));
    }
    const float mn = fmaxf(t.m[r], cm);
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      a += ex2((t.s[j][2 * r] - mn) * kLog2e) +
           ex2((t.s[j][2 * r + 1] - mn) * kLog2e);
    }
    t.sum[r] = (t.m[r] == mn ? t.sum[r]
                             : t.sum[r] * ex2((t.m[r] - mn) * kLog2e)) + a;
    t.m[r] = mn;
  }
}

// After pass 1: joins the 4 lanes of a quad, which own the same two rows,
// so that each holds the rows' max and sum, equal bit for bit in all four
// (unfused products and sums of the same terms, in either order); then
// replaces the sum by its reciprocal.
__device__ __forceinline__ void join_quad(RowTile& t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int x = 1; x < 4; x *= 2) {
      const float om = __shfl_xor_sync(0xffffffffu, t.m[r], x);
      const float ol = __shfl_xor_sync(0xffffffffu, t.sum[r], x);
      const float mn = fmaxf(t.m[r], om);
      t.sum[r] = __fadd_rn(__fmul_rn(t.sum[r], ex2((t.m[r] - mn) * kLog2e)),
                           __fmul_rn(ol, ex2((om - mn) * kLog2e)));
      t.m[r] = mn;
    }
    t.sum[r] = __frcp_rn(t.sum[r]);
  }
}

// Pass 2 over one chunk: p = exp(s - max) / sum rounded to bf16 and packed
// in pairs is the A fragment of p v (the C layout of s[2 i], s[2 i + 1] is
// the A layout of keys 16 i .. 16 i + 15); issues o += p v as one wgmma
// group: B = V, MN-major, core matrices 128 bytes apart along the head
// dims (N) and 8 kDh * 2 bytes along the keys (K); one m64n32k16 per 16
// keys.  pa must stay untouched until the group has landed.
__device__ __forceinline__ void issue_pv(RowTile& t,
                                         unsigned (&pa)[kKeys / 16][4],
                                         const bf16* vs) {
#pragma unroll
  for (int i = 0; i < kKeys / 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* sj = t.s[2 * i + e / 2];
      const int r = e % 2;
      pa[i][e] = pack_bf16(ex2((sj[2 * r] - t.m[r]) * kLog2e) * t.sum[r],
                           ex2((sj[2 * r + 1] - t.m[r]) * kLog2e) * t.sum[r]);
    }
  }
  sgc::wgmma_fence();
#pragma unroll
  for (int i = 0; i < kKeys / 16; ++i) {
    sgc::wgmma_m64n32k16(
        t.o, pa[i],
        sgc::wgmma_desc(sgc::smem_addr(vs + i * 16 * kDh), 16 * kDh, 128), 1);
  }
  sgc::wgmma_commit();
}

// The tile's (16 x 32) output, rounded once to bf16; rows at or past L are
// not written.
__device__ __forceinline__ void store_out(bf16* __restrict__ out,
                                          const RowTile& t, size_t base,
                                          size_t tok, int row0, int l,
                                          int lane) {
  const int t2 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row < l) {
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        *reinterpret_cast<unsigned*>(
            &out[base + static_cast<size_t>(row) * tok + 8 * n + t2]) =
            pack_bf16(t.o[n][2 * r], t.o[n][2 * r + 1]);
      }
    }
  }
}

// Both passes over the n key chunks of the ring for the warp's two tiles,
// whose q fragments are loaded: pass 1 the rows' max and sum, pass 2
// o += p v.  Within a chunk the tiles take turns, so that the tensor cores
// work on one tile's products while the other's exponentials run.
static_assert(kTiles == 2, "walk() pairs two tiles");
template <bool kMasked>
__device__ __forceinline__ void walk(const Ring& ring, const uint8_t* vm,
                                     RowTile (&rt)[kTiles], float scale,
                                     int lane) {
  const int n = ring.n;
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    rt[i].m[0] = rt[i].m[1] = -INFINITY;
    rt[i].sum[0] = rt[i].sum[1] = 0.f;
  }
  for (int x = 0; x < n; ++x) {
    ring.before(x);
    issue_products(rt, ring.keys(x));
    sgc::wgmma_wait<1>();     // tile 0's products; tile 1's in flight
    scores<kMasked>(rt[0], vm + x * kKeys, scale, lane);
    max_sum(rt[0]);
    sgc::wgmma_wait<0>();
    scores<kMasked>(rt[1], vm + x * kKeys, scale, lane);
    max_sum(rt[1]);
  }
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    join_quad(rt[i]);
#pragma unroll
    for (int d = 0; d < kDh / 8; ++d) {
      rt[i].o[d][0] = rt[i].o[d][1] = rt[i].o[d][2] = rt[i].o[d][3] = 0.f;
    }
  }
  for (int x = n; x < 2 * n; ++x) {
    ring.before(x);
    issue_products(rt, ring.keys(x));
    unsigned pa[kTiles][kKeys / 16][4];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      // tile i's products have landed once one group is left in flight:
      // tile 1's products (i = 0) or tile 0's p v (i = 1)
      sgc::wgmma_wait<1>();
      scores<kMasked>(rt[i], vm + (x - n) * kKeys, scale, lane);
      issue_pv(rt[i], pa[i], ring.values(x));
    }
    sgc::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      fence_regs(rt[i].o);
    }
  }
}

// Shared memory: the ring, then the image's L mask bytes.
inline size_t smem_bytes(int l) {
  return kRingBytes + (static_cast<size_t>(l) + 15) / 16 * 16;
}

// Stages the image's key mask in shared memory (1 = a real key) and
// returns, for the whole block, whether every key is real.
__device__ __forceinline__ bool stage_mask(uint8_t* vm,
                                           const uint8_t* __restrict__ valid,
                                           int b, int l) {
  int all = 1;
  for (int j = threadIdx.x; j < l; j += kThreads) {
    const uint8_t ok =
        valid == nullptr || valid[static_cast<size_t>(b) * l + j] != 0;
    vm[j] = ok;
    all &= ok;
  }
  return __syncthreads_and(all) != 0;
}

// One block per (b, h, kRows query rows): the first chunks in flight, the
// key mask, the q fragments, both passes, the output.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const uint8_t* __restrict__ valid, bf16* __restrict__ out,
                    int l, int h, float scale) {
  extern __shared__ uint4 smem[];
  const size_t tok = static_cast<size_t>(h) * kDh;
  const size_t base = static_cast<size_t>(blockIdx.z) * l * tok +
                      static_cast<size_t>(blockIdx.y) * kDh;
  const Ring ring{reinterpret_cast<bf16*>(smem), k + base, v + base,
                  kKeys * tok, l / kKeys, pieces(tok)};
  for (int x = 0; x < kStages - 1; ++x) {
    ring.issue(x);
  }
  uint8_t* vm = reinterpret_cast<uint8_t*>(smem) + kRingBytes;
  const int lane = threadIdx.x % 32;
  // the warp's tiles: rows row0 + 16 i
  const int row0 = blockIdx.x * kRows + (threadIdx.x / 32) * 16 * kTiles;
  const bool all = stage_mask(vm, valid, blockIdx.z, l);
  RowTile rt[kTiles];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    load_q(rt[i].qa, q, base, tok, row0 + 16 * i, l, lane);
  }
  if (all) {
    walk<false>(ring, vm, rt, scale, lane);
  } else {
    walk<true>(ring, vm, rt, scale, lane);
  }
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    store_out(out, rt[i], base, tok, row0 + 16 * i, l, lane);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* out, int b, int l, int h,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(l);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      return err;
    }
  }
  const dim3 grid((l + kRows - 1) / kRows, h, b);
  attention_tc_kernel<<<grid, kThreads, smem, stream>>>(
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
