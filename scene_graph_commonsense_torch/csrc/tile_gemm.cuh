// The block-level matrix product shared by the fused trunk kernels
// (csrc/stem.cu, csrc/bottleneck.cu).
//
// One block of 256 threads computes a (ROWS x NC) tile of A W, where row r
// of A is whatever the caller's loader puts there (a haloed pixel's input
// channels, a conv2 tap's shifted activation, an im2col patch) and W is a
// (K, N) row-major weight matrix in device memory.  K is walked in chunks
// of kc (64 bf16, 32 float32): the loader stages the A chunk and the block
// stages the W chunk in shared memory, then
//   * bfloat16: the products run on the tensor cores (mma.sync m16n8k16
//     bf16 tiles fed by ldmatrix, float32 accumulators: each product is
//     exact and the sums are float32, as on the TPU's MXU).  Two stages:
//     the next chunk is in flight (cp.async from device memory) while the
//     current one is multiplied; one barrier per chunk.  Each warp owns 32
//     or 64 columns, so that each A fragment it loads feeds 4 or 8
//     products.
//   * float32: float32 FMAs (the tensor cores would round float32 operands
//     to TF32), one stage, for the card-vs-CPU parity runs.
// Finished elements go to the caller's epilogue epi(row, col, v), where v
// is a float array of 8 consecutive columns (bfloat16) or 1 (float32), so
// that the epilogue can store 16-byte vectors.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace sgc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}
// Pipeline stages of the staging buffers, and the K chunk.
template <typename T>
__host__ __device__ constexpr int stages() { return is_f32<T>() ? 1 : 2; }
template <typename T>
__host__ __device__ constexpr int kc() { return is_f32<T>() ? 32 : 64; }
// Shared-memory row strides in elements, padded by 16 bytes: rows of a
// WMMA tile then fall on different banks, and 16-byte vectors stay aligned.
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int lda() { return kc<T>() + pad<T>(); }
template <typename T, int NC>
__host__ __device__ constexpr int ldw() { return NC + pad<T>(); }
constexpr int kScratchLd = 20;  // per-warp float32 16x16 tile, padded

// Bytes of shared memory tile_gemm<T, ROWS, NC> needs.
template <typename T, int NC>
__host__ __device__ constexpr size_t gemm_smem_bytes(int rows) {
  return stages<T>() * (size_t(rows) * lda<T>() + size_t(kc<T>()) *
                        ldw<T, NC>())
         * sizeof(T) + (is_f32<T>() ? 0 : size_t(kWarps) * 16 * kScratchLd
                                          * 4);
}

template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ float to_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 to_t<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// v * scale + shift with both roundings (no FMA contraction), as the plain
// version computes it.
__device__ __forceinline__ float affine(float v, float scale, float shift) {
  return __fadd_rn(__fmul_rn(v, scale), shift);
}

// V consecutive values between T memory and float registers; V * sizeof(T)
// is 16 (one vector) or V is 1.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* dst, const float (&v)[V]) {
  if constexpr (V == 1) {
    dst[0] = to_t<T>(v[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "one 16-byte vector");
    alignas(16) T out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[j] = to_t<T>(v[j]);
    }
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
  }
}
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* src, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f(src[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "one 16-byte vector");
    alignas(16) T in[V];
    *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j] = to_f(in[j]);
    }
  }
}

// A device-memory address for the zero-filling copies below to name.
__device__ uint4 zero_source;

// 16 bytes from device memory to shared memory without a register round
// trip; src == nullptr writes zeros (cp.async with a source size of 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = src != nullptr ? 16 : 0;
  const void* from = src != nullptr ? src : &zero_source;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(from), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory (row addresses from lanes
// 8 i .. 8 i + 7 for matrix i), plain or transposed.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
// d += a b for one 16x8x16 bf16 tile, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stages rows [0, ROWS) x columns [col0, col0 + kc) of A from device
// memory (cp.async): row_ptr(r) is the start of row r or nullptr for a
// zero row.  The caller guarantees 16-byte aligned rows with at least
// col0 + kc elements.
template <typename T, int ROWS, class RowPtr>
__device__ __forceinline__ void load_rows_async(T* sa, int col0,
                                                RowPtr row_ptr) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kc<T>() / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int v = i - r * kPerRow;
    const T* p = row_ptr(r);
    cp_async16(sa + r * lda<T>() + v * kVec,
               p != nullptr ? p + col0 + v * kVec : nullptr);
  }
}

// The same from shared memory (plain 16-byte copies).
template <typename T, int ROWS, class RowPtr>
__device__ __forceinline__ void load_rows(T* sa, int col0, RowPtr row_ptr) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kc<T>() / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int v = i - r * kPerRow;
    *reinterpret_cast<uint4*>(sa + r * lda<T>() + v * kVec) =
        *reinterpret_cast<const uint4*>(row_ptr(r) + col0 + v * kVec);
  }
}

// Stages W[k0 : k0 + kc, n0 : n0 + NC] (rows past K read as zero).
template <typename T, int NC>
__device__ __forceinline__ void load_w(T* sw, const T* __restrict__ w, int k,
                                       int n, int k0, int n0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = NC / kVec;
  for (int i = threadIdx.x; i < kc<T>() * kPerRow; i += kThreads) {
    const int kk = i / kPerRow;
    const int v = i - kk * kPerRow;
    cp_async16(sw + kk * ldw<T, NC>() + v * kVec,
               k0 + kk < k
                   ? w + static_cast<size_t>(k0 + kk) * n + n0 + v * kVec
                   : nullptr);
  }
}

// acc[r][c] = sum_k A[r][k] W[k][n0 + c] for r < ROWS, c < NC, then
// epi(r, n0 + c, v) over runs of consecutive columns.  A comes from `a`:
//   * A_SMEM false: a(k0, sa) stages A's columns [k0, k0 + kc) for all
//     ROWS rows (zero past K) with load_rows_async or plain stores;
//   * A_SMEM true: A already lies in shared memory and a(r, k0) is the
//     address of A[r][k0] (16-byte aligned, kc elements from there); the
//     bfloat16 path feeds ldmatrix straight from it.
// `smem` holds gemm_smem_bytes<T, NC>(ROWS) bytes.  Starts with
// __syncthreads(), so the caller's earlier shared-memory writes are visible
// to `a`; the caller syncs before reading what epi wrote.  Blocks walk K
// from different chunks (the sums' order differs by tile, not by run), so
// that the weight stream of all the SMs does not hit the same L2 lines at
// once.
template <typename T, int ROWS, int NC, bool A_SMEM, class ASrc, class Epi>
__device__ void tile_gemm(unsigned char* smem, const T* __restrict__ w,
                          int k, int n, int n0, ASrc a, Epi epi) {
  static_assert(ROWS % 16 == 0, "ROWS is a multiple of 16");
  static_assert(NC == 64 || NC == 128 || NC == 256, "64 to 256 columns");
  constexpr int kKC = kc<T>();
  constexpr int kSt = stages<T>();
  constexpr int kStageA = ROWS * lda<T>();
  constexpr int kStageW = kKC * ldw<T, NC>();
  T* sa = reinterpret_cast<T*>(smem);
  T* sw = sa + kSt * kStageA;
  const int tid = threadIdx.x;
  const int nk = (k + kKC - 1) / kKC;
  const int rot = static_cast<int>((blockIdx.x + blockIdx.y * 37u) % nk);
  // the first K column of chunk ic of this block's walk
  auto chunk_k0 = [&](int ic) {
    return (ic + rot < nk ? ic + rot : ic + rot - nk) * kKC;
  };
  // stages chunk ic into buffer ic % kSt (A only where it is not in
  // shared memory already, or for the float32 path, which reads it staged)
  auto stage = [&](int ic) {
    if (ic < nk) {
      const int buf = ic % kSt;
      const int k0 = chunk_k0(ic);
      if constexpr (!A_SMEM) {
        a(k0, sa + buf * kStageA);
      } else if constexpr (is_f32<T>()) {
        load_rows<T, ROWS>(sa + buf * kStageA, 0,
                           [&](int r) { return a(r, k0); });
      }
      load_w<T, NC>(sw + buf * kStageW, w, k, n, k0, n0);
    }
    cp_async_commit();                  // one group per chunk, even empty
  };
  if constexpr (is_f32<T>()) {
    // thread t: column t % NC, rows t / NC + (256 / NC) i
    constexpr int kStep = kThreads / NC;
    constexpr int kR = ROWS / kStep;
    const int c = tid % NC;
    const int rg = tid / NC;
    float acc[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      acc[i] = 0.f;
    }
    for (int ic = 0; ic < nk; ++ic) {
      __syncthreads();
      stage(ic);
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKC; ++kk) {
        const float wv = sw[kk * ldw<T, NC>() + c];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          acc[i] = fmaf(sa[(rg + kStep * i) * lda<T>() + kk], wv, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float v[1] = {acc[i]};
      epi(rg + kStep * i, n0 + c, v);
    }
  } else {
    // warp w: WC columns from WC (w % CG) (WC / 8 blocks of
    // mma.m16n8k16), and the 16-row tiles w / CG + RG i, so that each A
    // fragment it loads feeds WC / 8 products; with fewer row tiles than
    // row groups, more and narrower column groups keep every warp busy
    constexpr int kRT = ROWS / 16;
    constexpr int kCG0 = NC > 128 ? 4 : NC / 32;
    constexpr int kRG = kWarps / kCG0 < kRT ? kWarps / kCG0 : kRT;
    constexpr int kCG = kWarps / kRG;           // column groups
    constexpr int kWC = NC / kCG;               // columns a warp: 16 to 64
    constexpr int kNB = kWC / 8;                // its 8-column blocks
    static_assert(kWC % 16 == 0, "whole 16-column tiles per warp");
    constexpr int kFR = (kRT + kRG - 1) / kRG;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int c0 = kWC * (warp % kCG);          // the warp's first column
    const int r0 = warp / kCG;
    float* scratch = reinterpret_cast<float*>(sw + kSt * kStageW) +
                     warp * 16 * kScratchLd;
    float acc[kFR][kNB][4];
#pragma unroll
    for (int i = 0; i < kFR; ++i) {
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] = 0.f;
        }
      }
    }
    // ldmatrix row addresses: A rows lane % 16 at column (lane / 16) * 8;
    // W (transposed) rows k = lane % 16 at column (lane / 16) * 8
    const int lrow = lane % 16;
    const int lcol = (lane / 16) * 8;
    // the caller's shared-memory writes (and the last call's reads of the
    // staging buffers) are done before the first chunks are staged
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSt - 1; ++s) {
      stage(s);
    }
    for (int ic = 0; ic < nk; ++ic) {
      cp_async_wait<kSt - 2>();         // chunk ic has landed
      __syncthreads();                  // ... for every thread, and chunk
                                        // ic - 1's buffer is free
      stage(ic + kSt - 1);
      const T* a_cur = sa + (ic % kSt) * kStageA;
      const T* w_cur = sw + (ic % kSt) * kStageW;
      // each lane's A row (lrow of each of its row tiles) in this chunk
      const T* arow[kFR];
#pragma unroll
      for (int i = 0; i < kFR; ++i) {
        const int r = (r0 + kRG * i) * 16 + lrow;
        if constexpr (A_SMEM) {
          arow[i] = r < ROWS ? a(r, chunk_k0(ic)) : a_cur;
        } else {
          arow[i] = a_cur + r * lda<T>();
        }
      }
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        unsigned b[kNB / 2][4];
#pragma unroll
        for (int j = 0; j < kNB / 2; ++j) {
          ldmatrix_x4_trans(b[j], w_cur + (kk + lrow) * ldw<T, NC>() + c0 +
                                      16 * j + lcol);
        }
#pragma unroll
        for (int i = 0; i < kFR; ++i) {
          const int rt = r0 + kRG * i;
          if (rt < kRT) {
            unsigned af[4];
            ldmatrix_x4(af, arow[i] + kk + lcol);
#pragma unroll
            for (int j = 0; j < kNB / 2; ++j) {
              mma_bf16(acc[i][2 * j], af, b[j][0], b[j][1]);
              mma_bf16(acc[i][2 * j + 1], af, b[j][2], b[j][3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    // epilogue: each 16 x 16 tile through the warp's scratch (the mma
    // layout: lane holds rows g, g + 8, columns 2 t, 2 t + 1 of each
    // 8-column block), then lane -> row lane / 2, columns (lane % 2) * 8
    const int g = lane / 4;
    const int t2 = 2 * (lane % 4);
    const int er = lane / 2;
    const int ec = (lane % 2) * 8;
#pragma unroll
    for (int i = 0; i < kFR; ++i) {
      const int rt = r0 + kRG * i;
      if (rt < kRT) {
#pragma unroll
        for (int j = 0; j < kNB / 2; ++j) {
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            float* row = scratch + g * kScratchLd + 8 * nb + t2;
            row[0] = acc[i][2 * j + nb][0];
            row[1] = acc[i][2 * j + nb][1];
            row[8 * kScratchLd] = acc[i][2 * j + nb][2];
            row[8 * kScratchLd + 1] = acc[i][2 * j + nb][3];
          }
          __syncwarp();
          float v[8];
          const float4 lo = *reinterpret_cast<const float4*>(
              scratch + er * kScratchLd + ec);
          const float4 hi = *reinterpret_cast<const float4*>(
              scratch + er * kScratchLd + ec + 4);
          v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
          v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
          epi(rt * 16 + er, n0 + c0 + 16 * j + ec, v);
          __syncwarp();
        }
      }
    }
  }
}

inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) {
    err = cudaSetDevice(device);
  }
  return err;
}

}  // namespace sgc
