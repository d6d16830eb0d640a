// PTX helpers of the bf16 tensor-core kernels: cp.async copies from device
// memory to shared memory (csrc/tile_gemm.cuh and csrc/attention.cu);
// ldmatrix fragment loads and the mma.sync m16n8k16 bf16 product
// (csrc/tile_gemm.cuh); the Hopper wgmma products (csrc/attention.cu).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of 2 bf16: (row g, cols 2t, 2t+1),
//     (row g+8, cols 2t, 2t+1), (row g, cols 2t+8, 2t+9), (row g+8, ...);
//   B (16 x 8), 2 registers: (rows 2t, 2t+1, col g), (rows 2t+8, 2t+9,
//     col g);
//   C/D (16 x 8) float32, 4 registers: (row g, cols 2t, 2t+1), (row g+8,
//     cols 2t, 2t+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sgc {

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
// The same for a source that is never null.
__device__ __forceinline__ void cp_async16_full(void* dst, const void* src) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
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

// ---------------------------------------------------------------------------
// Hopper warpgroup products (sm_90a): wgmma with A from registers (each
// warp's 16 rows of the 64-row tile in the m16n8k16 A layout above) and B
// from shared memory through a matrix descriptor; D in registers, each
// warp's 16 rows in the m16n8 C layout, one 8-column block after another.
// ---------------------------------------------------------------------------

// Descriptor of a B operand in shared memory without swizzling: core
// matrices of 8 rows x 16 bytes stored contiguously (128 bytes), lbo the
// byte distance between core matrices along K, sbo along N.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, unsigned lbo,
                                               unsigned sbo) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3fff) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32;
}
// Orders this thread's register writes before the next wgmma's reads of
// them (accumulators and A fragments).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's shared-memory writes (plain stores, cp.async) visible
// to the async proxy that wgmma reads shared memory through; a barrier
// after it makes every thread's visible.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= a b for a 64 x 64 x 16 bf16 tile, float32 accumulators; B K-major
// (column n's 16 K values in 2 core matrices along K).  accumulate 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4],
                                                const unsigned (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= a b for a 64 x 32 x 16 bf16 tile, float32 accumulators; B
// MN-major (row k's 32 N values in 4 core matrices along N).  accumulate 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[4][4],
                                                const unsigned (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

}  // namespace sgc
