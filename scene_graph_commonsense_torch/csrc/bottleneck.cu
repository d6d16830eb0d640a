// Fused frozen ResNet bottleneck blocks of the DETR-101 trunk.  Kernel
// templates behind one plain C entry point for ctypes:
//
//   sgc_bottleneck   y = relu(BN3(W3 . relu(BN2(conv3x3/s(relu(BN1(W1 . x))))))
//                         + idn(x))
//
// x: contiguous (B, H, W, C) NHWC in the compute dtype (float32 or
// bfloat16); w1 (C, M), w2 (3, 3, M, M) = (9 M, M), w3 (M, CO) and the
// optional projection wd (C, CO) in the compute dtype, the flax (in, out)
// layout; s1, s2 (2, M) and s3, sd (2, CO): float32 folded frozen BNs
// [scale, shift]; y: (B, H/s, W/s, CO) in the compute dtype; a: the
// bfloat16 stride-2 path's scratch (B, H, W, M) for conv1's output.
//
// Replaces two TPU kernels of scene_graph_commonsense_tpu/ops/pallas/
// bottleneck.py, with their rounding points:
//   * stride 1 (`_kernel`, through `fused_bottleneck`; 30 of ResNet-101's
//     33 blocks): a = cd(relu(f32(x W1) s1[0] + s1[1])), zero a (not zero
//     x) at every image border for conv2's padding; b = cd(relu(sum over
//     the 9 taps of f32(a W2[dy, dx]) s2[0] + s2[1])); c = f32(b W3) s3[0]
//     + s3[1]; idn = f32(x Wd) sd[0] + sd[1] (layer1_0) or f32(x);
//     y = cd(relu(c + idn)).  Any H and W.
//   * stride 2 (`_kernel_s2`, through `fused_bottleneck_s2`; the three
//     stage transitions): conv1 on every input pixel; output pixel (u, v)
//     takes a at rows 2u-1..2u+1 and columns 2v-1..2v+1, the top row and
//     left column being zero a; idn = f32(x[2u, 2v] Wd) sd[0] + sd[1].
//     H and W even.
// BN is applied as a multiply then an add, each rounded (no FMA), as the
// plain version computes it.
//
// Bound (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s) at the production shape,
// batch 12 of 1024^2 images: layer1 blocks move 0.5-0.8 GB for 40-50 GFLOP
// (bytes: 0.15-0.24 ms); layer2 0.4 GB (0.12 ms); layer3 and layer4 blocks
// 109.5 GFLOP each (products: 0.111 ms); each transition ~187 GFLOP
// (0.19 ms).  chip_smoke.py computes each case's bound from its inputs.
//
// Design.  The TPU kernel keeps a block's weights resident in VMEM (w1 +
// 9 w2 + w3 is 8.9 MB at layer4), far beyond the 227 KB of shared memory a
// Hopper block has.  So a block owns an output tile of one image and
// streams the weights through shared memory in K chunks from L2 (a block's
// weights fit the 50 MB L2, so the tiles of a launch reread them from
// there, not from device memory).  Each block computes, for its tile:
//   1. conv1 over the tile's haloed input pixels (the conv2 halo), a kept
//      in shared memory in the compute dtype, zero outside the image;
//   2. conv2 as one product with K = 9 M, each K chunk one tap's shifted
//      rows of a, read in place;
//   3. conv3 (and the projection), the epilogue adding the identity and
//      writing y once.
// x is read once per tile plus the halo and y written once: the
// activations make one round trip instead of the unfused trunk's ~8
// passes.  The bfloat16 stride-2 path splits step 1 off (below).  The
// kernels:
//
// bottleneck_hopper: bfloat16 at stride 1 (K3, 30 launches an encode).
// Bounds: the products (layer3 109.5 GFLOP, 0.111 ms at 989 TFLOP/s; 0.124
// ms with conv1 on the haloed rows) and the weight stream from L2: every
// tile reads all of the block's weights, 2.23 MB at layer1-3 and 8.9 MB at
// layer4.  Read once per 64-pixel tile, as the mma.sync template did, that
// is 1.71 GB per layer3 launch, ~0.3 ms at an L2 rate of the order of
// 5-6 TB/s (not measured): above the products.  The design:
//   * 128-pixel tiles (16 x 8 output pixels; 16 x 16 at M = 64, whose a is
//     small; 8 x 8 at M = 512, whose a is not) and clusters of 2 blocks on
//     neighbouring tiles of one image: each weight chunk is loaded once per
//     cluster by TMA and multicast to both blocks, each block loading half
//     its rows.  The weight stream per launch falls to weight bytes x
//     tiles / 2 (the floor: 0.43 GB at layer3, ~0.08 ms at 5.5 TB/s; 0.21
//     GB at layer1, 0.43 at layer2, 0.85 at layer4);
//   * the copies are TMA tensor copies in TMA's 128-byte swizzle: the
//     (K, N) row-major weights as they are (so the wrapper, the entry point
//     and the plain path keep the flax layout; cuTensorMapEncodeTiled is
//     reached through the runtime's driver entry-point query) and x's 4D
//     box, zero outside the image.  One producer thread issues them into
//     two rings guarded by mbarriers: 2 slots of x boxes and 5-8 slots of
//     16 KB weight chunks, so that several chunks' L2 latency is in
//     flight.  Two consumer warpgroups wait on a slot's "full" barrier and
//     free it by arriving on its "empty" barrier in both blocks (either
//     producer writes into both).  The barriers order at CTA scope: TMA
//     completion carries the data (cluster scope, which orders the
//     thread's global traffic too, made the kernel far slower).
//     setmaxnreg gives the consumers 232 registers a thread and the
//     producer warpgroup 40.  No block-wide barrier in the main loops;
//   * the products are wgmma m64nNk16 (N 64-256) with float32 accumulators
//     in registers and both operands in shared memory: B MN-major in the
//     swizzled layout; A K-major, either x's swizzled box (conv1, the
//     projection) or a and b, which the epilogues store channel-planar (8
//     channels x 16 bytes a pixel, one plane per 8 channels), so that a
//     conv2 tap's shifted rows of a are a plain descriptor: 8-pixel core
//     matrices of one tile row, rows HW pixels apart.  A 64-row block is
//     8 tile rows x 8 columns;
//   * with an even number of 64-row blocks each warpgroup takes half of
//     them at the pass's full width, otherwise all of them at half the
//     width, so that a pass's accumulators stay within 128 registers a
//     thread.  conv2's stay in registers for the whole K = 9 M loop, one
//     pass of M columns; then a is dead and b goes over a's room: shared
//     memory holds the haloed a plus the rings (at M = 256: 90 KB + 2 x 24
//     KB + 5 x 16 KB).  conv1 runs on the 180 haloed rows of a 128-pixel
//     tile (3 row blocks, 50% over the output pixels; 100% at a 64-pixel
//     tile), in passes of 128 columns, x's box reloaded each pass;
//   * conv3's output goes through shared memory: each pass of 128 columns
//     takes two x slots, which the producer fills with the identity's x
//     (TMA, the output tile's box), the epilogue overwrites with y in the
//     same swizzled layout, and one thread stores with TMA (which drops
//     what lies outside the image); written straight from the accumulator
//     layout, y took 4-byte stores 2 KB apart and the conv3 epilogue took
//     most of a block's time.
// The epilogues apply BN from the accumulator layout (affine: rounded
// multiply, rounded add).  What bounds it now (H100 SXM, 700 W; PERF.md
// has the times): layer3 runs at ~3x the products bound; one block per
// SM with both warpgroups in the same stage leaves the tensor cores idle
// in every epilogue and pass drain, and conv1's n64 products read shared
// memory near its rate.
//
// conv1_s2_hopper + bottleneck_s2_hopper: bfloat16 at stride 2 (K4, 3
// calls an encode, two launches a call), on bottleneck_hopper's producer,
// rings, cluster multicast, wgmma main loop and TMA-store epilogue.  The
// one-block design does not fit at stride 2: an 8 x 8 output tile (the
// least a 64-row wgmma takes) needs 17 x 17 haloed pixels of a, 74 KB at
// M = 128, 148 KB at M = 256 and 296 KB at M = 512, beside the x and
// weight rings in 227 KB.  So a makes one trip through device memory,
// 0.40 / 0.20 / 0.10 GB at layer2_0 / layer3_0 / layer4_0 (~0.12 / 0.06 /
// 0.03 ms at 3.35 TB/s; the wrapper allocates it):
//   1. conv1_s2_hopper: a = cd(relu(BN1(x W1))) on every input pixel, a
//      plain (B H W, C) x (C, M) product: 128-row tiles of x's 2D view,
//      passes of min(M, 256) columns, a stored by TMA through the x
//      ring's slots as y is.  Its bound is bytes at layer2_0 (x read, a
//      written: 0.18 ms) and products at layer4_0 (51.5 GFLOP, 0.05 ms).
//   2. bottleneck_s2_hopper: conv2 at stride 2, conv3 and the projection
//      per tile of 16 x 8 output pixels (8 x 8 at M = 512, where b and
//      conv2's 64 x 512 accumulators fill shared memory and registers).
//      a and x are read through a view as (B, H/2, 2, W/2, 2 C): row
//      pairs, row parity, column pairs, the two columns' channels side by
//      side (a reshape of NHWC: the TPU kernel's own row split and
//      column-pair lane packing).  Tap (dy, dx) of output (u, v) lies at
//      row pair u - (dy == 0), parity (dy + 1) % 2, column pair
//      v - (dx == 0), channels from M ((dx + 1) % 2), so each tap's 64
//      channels over the tile are one 5D TMA box in the swizzled K-major
//      layout wgmma reads, and TMA's zero fill at pair -1 is conv2's zero
//      a.  x[2u, 2v] for the projection is parity 0, offset 0 of x's view.
//      Each box of a serves the 64 / KC2 weight chunks (16 KB) of its K
//      rows; 4 box slots.  b stays in shared memory, channel-planar, for
//      conv3; y goes out by TMA through the staging slots.
// Products ~187 GFLOP a transition (0.189 ms), the bound at all three
// shapes.  The taps reread a from L2 (9 boxes of a per output pixel, 2.25x
// a's bytes); the weights stream from L2 once per cluster of tiles.
//
// bottleneck_kernel: float32 at both strides (the card-vs-CPU parity runs),
// through tile_gemm (csrc/tile_gemm.cuh): float32 FMAs (wgmma has no
// float32 operands, and TF32 would not hold the float32 parity), 4 x 4
// output tiles, K chunks of 64 in two cp.async stages.  At stride 2 the
// shifted tap rows lie two pixels apart, so each chunk is copied out of a
// before the products read it.

#include <cuda.h>
#include <string.h>

#include "hopper_pipe.cuh"
#include "tile_gemm.cuh"

namespace {

using sgc::kThreads;

template <typename T, int TH, int TW, int S>
struct Tile {
  static constexpr int kHH = (TH - 1) * S + 3;  // haloed input rows
  static constexpr int kHW = (TW - 1) * S + 3;  // haloed input columns
  static constexpr int kNH = kHH * kHW;
  static constexpr int kRA = sgc::round16(kNH);
  static constexpr int kRO = TH * TW;
  static constexpr int kNC = 64;                // output columns a pass
  static constexpr int kLdc = kNC + 4;          // float32 conv3 chunk
  static_assert(kRO % 16 == 0, "output tile rows are whole WMMA tiles");

  __host__ __device__ static constexpr size_t gemm_bytes() {
    return sgc::align128(
        sgc::gemm_smem_bytes<T, kNC>(kRA));
  }
  // a (conv1 out), dead after conv2, then the float32 conv3 chunk of the
  // projection's epilogue
  __host__ __device__ static size_t a1_bytes(int m, bool has_d) {
    const size_t a = size_t(kNH) * (m + sgc::pad<T>()) * sizeof(T);
    const size_t c = has_d ? size_t(kRO) * kLdc * 4 : 0;
    return sgc::align128(a > c ? a : c);
  }
  static size_t smem_bytes(int m, bool has_d) {
    return gemm_bytes() + a1_bytes(m, has_d) +
           size_t(kRO) * (m + sgc::pad<T>()) * sizeof(T);
  }
};

template <typename T, int TH, int TW, int S, bool HAS_D>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ s1, const T* __restrict__ w2,
                  const float* __restrict__ s2, const T* __restrict__ w3,
                  const float* __restrict__ s3, const T* __restrict__ wd,
                  const float* __restrict__ sd, T* __restrict__ y, int h,
                  int w, int c, int m, int co, int tiles_x) {
  using Tl = Tile<T, TH, TW, S>;
  constexpr int kHW = Tl::kHW;
  constexpr int kNH = Tl::kNH;
  constexpr int kRA = Tl::kRA;
  constexpr int kRO = Tl::kRO;
  constexpr int kNC = Tl::kNC;
  constexpr int kLdc = Tl::kLdc;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = m + sgc::pad<T>();
  T* a1 = reinterpret_cast<T*>(smem + Tl::gemm_bytes());
  float* c3 = reinterpret_cast<float*>(a1);      // a1's room, after conv2
  T* b2 = reinterpret_cast<T*>(smem + Tl::gemm_bytes() +
                               Tl::a1_bytes(m, HAS_D));

  const int ho = h / S;
  const int wo = w / S;
  const int bi = blockIdx.y;
  const int ty = blockIdx.x / tiles_x;
  const int oy0 = ty * TH;
  const int ox0 = (blockIdx.x - ty * tiles_x) * TW;
  const int iy0 = oy0 * S - 1;                  // haloed tile origin
  const int ix0 = ox0 * S - 1;
  const T* xb = x + static_cast<size_t>(bi) * h * w * c;
  T* yb = y + static_cast<size_t>(bi) * ho * wo * co;

  auto x_at = [&](int iy, int ix) -> const T* {
    return (iy >= 0 && iy < h && ix >= 0 && ix < w)
               ? xb + (static_cast<size_t>(iy) * w + ix) * c
               : nullptr;
  };
  auto halo_x = [&](int r) -> const T* {
    return r < kNH ? x_at(iy0 + r / kHW, ix0 + r % kHW) : nullptr;
  };
  // the output pixel of tile row r, or -1 outside the output
  auto out_pix = [&](int r) -> long long {
    const int oy = oy0 + r / TW;
    const int ox = ox0 + r % TW;
    return (oy < ho && ox < wo) ? static_cast<long long>(oy) * wo + ox : -1;
  };

  // 1. conv1 over the haloed pixels; zero a outside the image
  for (int n0 = 0; n0 < m; n0 += kNC) {
    sgc::tile_gemm<T, kRA, kNC, false>(
        smem, w1, c, m, n0,
        [&](int k0, T* sa) { sgc::load_rows_async<T, kRA>(sa, k0, halo_x); },
        [&](int r, int n, const auto& v) {
          constexpr int kV = sizeof(v) / sizeof(v[0]);
          if (r < kNH) {
            const bool inside = halo_x(r) != nullptr;
            float a[kV];
#pragma unroll
            for (int j = 0; j < kV; ++j) {
              a[j] = inside ? fmaxf(sgc::affine(v[j], s1[n + j],
                                                s1[m + n + j]), 0.f)
                            : 0.f;
            }
            sgc::store_vec<T>(a1 + r * ld + n, a);
          }
        });
  }

  // 2. conv2: K = 9 M, tap-major; every K chunk lies in one tap.  Output
  // pixel (i, j) of the tile, tap (dy, dx) reads haloed pixel
  // (i s + dy, j s + dx) of a, channels from k0 - tap M.  At stride 1
  // the products read a in place; at stride 2 its rows lie two pixels
  // apart, so the chunk is copied out first.
  auto a_at = [&](int r, int k0) -> const T* {
    const int tap = k0 / m;
    const int dy = tap / 3;
    const int i = r / TW;
    return a1 + ((i * S + dy) * kHW + (r - i * TW) * S + tap - 3 * dy) * ld +
           k0 - tap * m;
  };
  auto conv2_epi = [&](int r, int n, const auto& v) {
    constexpr int kV = sizeof(v) / sizeof(v[0]);
    float b[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      b[j] = fmaxf(sgc::affine(v[j], s2[n + j], s2[m + n + j]), 0.f);
    }
    sgc::store_vec<T>(b2 + r * ld + n, b);
  };
  for (int n0 = 0; n0 < m; n0 += kNC) {
    if constexpr (S == 1) {
      sgc::tile_gemm<T, kRO, kNC, true>(smem, w2, 9 * m, m, n0, a_at,
                                         conv2_epi);
    } else {
      sgc::tile_gemm<T, kRO, kNC, false>(
          smem, w2, 9 * m, m, n0,
          [&](int k0, T* sa) {
            sgc::load_rows<T, kRO>(sa, 0,
                                   [&](int r) { return a_at(r, k0); });
          },
          conv2_epi);
    }
  }

  // 3. conv3 + identity, written once
  auto b2_at = [&](int r, int k0) -> const T* { return b2 + r * ld + k0; };
  for (int n0 = 0; n0 < co; n0 += kNC) {
    if constexpr (HAS_D) {
      sgc::tile_gemm<T, kRO, kNC, true>(
          smem, w3, m, co, n0, b2_at,
          [&](int r, int n, const auto& v) {
            constexpr int kV = sizeof(v) / sizeof(v[0]);
#pragma unroll
            for (int j = 0; j < kV; ++j) {
              c3[r * kLdc + n - n0 + j] =
                  sgc::affine(v[j], s3[n + j], s3[co + n + j]);
            }
          });
      sgc::tile_gemm<T, kRO, kNC, false>(
          smem, wd, c, co, n0,
          [&](int k0, T* sa) {
            sgc::load_rows_async<T, kRO>(sa, k0, [&](int r) -> const T* {
              return x_at((oy0 + r / TW) * S, (ox0 + r % TW) * S);
            });
          },
          [&](int r, int n, const auto& v) {
            constexpr int kV = sizeof(v) / sizeof(v[0]);
            const long long p = out_pix(r);
            if (p >= 0) {
              float o[kV];
#pragma unroll
              for (int j = 0; j < kV; ++j) {
                const float idn = sgc::affine(v[j], sd[n + j], sd[co + n + j]);
                o[j] = fmaxf(c3[r * kLdc + n - n0 + j] + idn, 0.f);
              }
              sgc::store_vec<T>(yb + p * co + n, o);
            }
          });
    } else {
      sgc::tile_gemm<T, kRO, kNC, true>(
          smem, w3, m, co, n0, b2_at,
          [&](int r, int n, const auto& v) {
            constexpr int kV = sizeof(v) / sizeof(v[0]);
            const long long p = out_pix(r);
            if (p >= 0) {
              float idn[kV];
              sgc::load_vec<T>(xb + p * c + n, idn);
              float o[kV];
#pragma unroll
              for (int j = 0; j < kV; ++j) {
                o[j] = fmaxf(sgc::affine(v[j], s3[n + j], s3[co + n + j]) +
                             idn[j], 0.f);
              }
              sgc::store_vec<T>(yb + p * co + n, o);
            }
          });
    }
  }
}

template <typename T, int TH, int TW, int S, bool HAS_D>
cudaError_t launch(const void* x, const void* w1, const void* s1,
                   const void* w2, const void* s2, const void* w3,
                   const void* s3, const void* wd, const void* sd, void* y,
                   int b, int h, int w, int c, int m, int co,
                   cudaStream_t stream) {
  using Tl = Tile<T, TH, TW, S>;
  const size_t smem = Tl::smem_bytes(m, HAS_D);
  auto kern = bottleneck_kernel<T, TH, TW, S, HAS_D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return err;
  }
  const int ho = h / S;
  const int wo = w / S;
  const int tiles_x = (wo + TW - 1) / TW;
  const int tiles_y = (ho + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(s1), static_cast<const T*>(w2),
      static_cast<const float*>(s2), static_cast<const T*>(w3),
      static_cast<const float*>(s3), static_cast<const T*>(wd),
      static_cast<const float*>(sd), static_cast<T*>(y), h, w, c, m, co,
      tiles_x);
  return cudaGetLastError();
}

#define SGC_BOTTLENECK_ARGS                                              \
  x, w1, s1, w2, s2, w3, s3, wd, sd, y, b, h, w, c, m, co, st
// ---------------------------------------------------------------------------
// bottleneck_hopper (bfloat16, stride 1) and conv1_s2_hopper +
// bottleneck_s2_hopper (bfloat16, stride 2): see the design note
// ---------------------------------------------------------------------------

namespace hop {

// the shared pipeline (csrc/hopper_pipe.cuh)
using sgc::hop::align1k;
using sgc::hop::align_smem;
using sgc::hop::cmax;
using sgc::hop::cmin;
using sgc::hop::kCluster;
using sgc::hop::kConsumerBar;
using sgc::hop::kConsumerRegs;
using sgc::hop::kConsumerThreads;
using sgc::hop::kEmptyArrivals;
using sgc::hop::kFirstConsumer;
using sgc::hop::kProducerRegs;
using sgc::hop::kSmemMax;
using sgc::hop::kThreads;
using sgc::hop::launch_clusters;
using sgc::hop::make_rings;
using sgc::hop::matrix_map;
using sgc::hop::pack2;
using sgc::hop::Pipe;
using sgc::hop::Rings;
using sgc::hop::tensor_map;

// The tile and pipeline of one M: TH x TW output pixels; conv1 in passes
// of NP1 columns; conv2 in K chunks of KC2 rows (one pass of M columns);
// conv3 (and the projection) in passes of NP3 columns.  Two rings: SX
// slots of x boxes (XB bytes) and as many weight-chunk slots (WB bytes) as
// the shared memory left beside them and a holds, at most 8.
template <int M_, int TH_, int TW_, int NP1_, int KC2_, int NP3_>
struct Cfg {
  static constexpr int M = M_, TH = TH_, TW = TW_, NP1 = NP1_, KC2 = KC2_,
                       NP3 = NP3_;
  static constexpr int HH = TH + 2, HW = TW + 2;
  static constexpr int NH = HH * HW;          // haloed pixels
  static constexpr int OUT = TH * TW;         // output pixels
  static constexpr int RB1 = (NH + 63) / 64;  // conv1's 64-row blocks
  static constexpr int RB2 = OUT / 64;        // conv2's and conv3's
  static constexpr int XB = align1k(cmax(RB1 * 64, OUT) * 128);
  static constexpr int WB =
      align1k(cmax(cmax(64 * NP1, KC2 * M), 64 * NP3) * 2);
  static constexpr int ACT = align1k(cmax(NH, OUT) * M * 2);  // a, then b
  static constexpr int SX = 2;
  static constexpr int kFree = kSmemMax - 1024 - SX * XB - ACT - 16 * 16;
  static constexpr int SW = cmin(kFree / WB, 8);
  static constexpr int SMEM = 1024 + SX * XB + SW * WB + ACT + 16 * (SX + SW);
  static_assert(TW % 8 == 0 && OUT % 64 == 0, "8 x 8 pixel row blocks");
  static_assert(M % NP1 == 0 && M % KC2 == 0, "whole passes and taps");
  static_assert(SW >= 2, "a weight chunk in flight beside the one in use");
};

// Weight chunks of 16 KB (K rows x N columns of bf16: 64 x 128, or 32 x
// 256 and 16 x 512 in conv2), so that 5-8 are in flight: the L2 latency of
// a chunk (~1 us) is several chunks' products.
template <int M, bool HAS_D>
struct CfgOf;
template <bool D>
struct CfgOf<64, D> { using T = Cfg<64, 16, 16, 64, 64, D ? 64 : 128>; };
template <bool D>
struct CfgOf<128, D> { using T = Cfg<128, 16, 8, 128, 64, 128>; };
template <bool D>
struct CfgOf<256, D> { using T = Cfg<256, 16, 8, 128, 32, 128>; };
template <bool D>
struct CfgOf<512, D> { using T = Cfg<512, 8, 8, 128, 16, 128>; };

// bottleneck_s2_hopper at one M: TH x 8 output pixels (a 64-row block is
// 8 tile rows); conv2 in K chunks of KC2 rows (16 KB, as in CfgOf), each
// 64-channel box of a serving XR of them; conv3 and the projection in
// passes of NP3 columns.  SX = 4 slots of boxes (a's taps, the
// projection's x, y's staging), then as many weight slots as fit beside
// them and b, at most 8.
template <int M_, int TH_, int KC2_>
struct CfgS2 {
  static constexpr int M = M_, TH = TH_, TW = 8, KC2 = KC2_, NP3 = 128;
  static constexpr int OUT = TH * TW;         // output pixels
  static constexpr int RB2 = OUT / 64;        // 64-row blocks
  static constexpr int XR = 64 / KC2;         // weight chunks a box serves
  static constexpr int XB = OUT * 128;        // a box: 64 channels a pixel
  static constexpr int WB = align1k(cmax(KC2 * M, 64 * NP3) * 2);
  static constexpr int ACT = OUT * M * 2;     // b
  static constexpr int SX = 4;
  static constexpr int kFree = kSmemMax - 1024 - SX * XB - ACT - 16 * 16;
  static constexpr int SW = cmin(kFree / WB, 8);
  static constexpr int SMEM = 1024 + SX * XB + SW * WB + ACT + 16 * (SX + SW);
  static_assert(OUT % 64 == 0 && 64 % KC2 == 0, "whole row blocks, boxes");
  static_assert(SW >= 2, "a weight chunk in flight beside the one in use");
};
template <int M>
struct CfgS2Of;
template <>
struct CfgS2Of<128> { using T = CfgS2<128, 16, 64>; };
template <>
struct CfgS2Of<256> { using T = CfgS2<256, 16, 32>; };
template <>
struct CfgS2Of<512> { using T = CfgS2<512, 8, 16>; };

// conv1_s2_hopper: tiles of 128 rows of x viewed as (B H W, C), passes of
// NP columns (K chunks of 64 rows: 16 or 32 KB); SX = 6 slots of x boxes
// and a's staging (NP / 64 slots a pass), then as many weight slots as
// fit, at most 8.
template <int NP_>
struct CfgC1 {
  static constexpr int NP = NP_, OUT = 128;
  static constexpr int XB = OUT * 128;
  static constexpr int WB = 64 * NP * 2;
  static constexpr int SX = 6;
  static constexpr int kFree = kSmemMax - 1024 - SX * XB - 16 * 16;
  static constexpr int SW = cmin(kFree / WB, 8);
  static constexpr int SMEM = 1024 + SX * XB + SW * WB + 16 * (SX + SW);
  static_assert(SX >= NP / 64, "a pass's staging slots at once");
  static_assert(SW >= 2, "a weight chunk in flight beside the one in use");
};
template <int M>
using CfgC1Of = CfgC1<cmin(M, 256)>;

// The two consumer warpgroups' share of a pass over RB row blocks and NP
// columns: an even RB splits the row blocks (warpgroup w takes w, w + 2,
// ...) at the full width; an odd RB splits the columns.
template <int RB, int NP>
struct Split {
  static constexpr bool kRows = RB % 2 == 0;
  static constexpr int RBW = kRows ? RB / 2 : RB;   // row blocks a WG
  static constexpr int NW = kRows ? NP : NP / 2;    // columns a WG
  static_assert(NW == 64 || NW == 128 || NW == 256, "a wgmma width");
  static_assert(RBW * NW <= 256, "at most 128 accumulators a thread");
  __device__ static int rb(int wg, int r) { return kRows ? wg + 2 * r : r; }
  __device__ static int col0(int wg) { return kRows ? 0 : wg * NW; }
};

struct Params {
  const float* s1;
  const float* s2;
  const float* s3;
  const float* sd;
  int h, w, c, co, tiles_x;
};

// Two consecutive floats of a BN fold, through the read-only path (the
// folds and x are never written during the kernel, so these loads may be
// issued ahead of the epilogues' stores).
__device__ __forceinline__ float2 fold2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// The byte offset of (pixel r, channel n) in channel-planar activations of
// `rows` pixels (8 channels x 16 bytes a pixel, one plane per 8 channels).
__device__ __forceinline__ int planar(int rows, int r, int n) {
  return ((n >> 3) * rows + r) * 16 + (n & 7) * 2;
}

// ---- producer: one thread issues every copy, in the consumers' order ----

// This block's half (by K rows) of W[k0 : k0 + kc, n0 : n0 + np] into the
// next weight slot, multicast: 64-column boxes of kc rows x 128 bytes, one
// after another.
template <class C>
__device__ void load_w(Rings<C>& ring, const CUtensorMap* map, int k0,
                       int n0, int np, int kc, unsigned rank) {
  const int s = ring.w.acquire(kc * np * 2);
  for (int nb = 0; nb < np / 64; ++nb) {
    sgc::tma_load_2d_multicast(
        ring.w.slot(s) + (nb * kc + rank * (kc / 2)) * 128, map,
        ring.w.full(s), n0 + 64 * nb, k0 + rank * (kc / 2), 0x3);
  }
}

// conv3 and, with HAS_D, the projection in passes of NP3 columns, each
// followed by the pass's output staging, one x slot per 64 channels:
// filled with the identity's x (C == CO), or empty beside the projection.
// tile_x(c0) loads the output tile's box of x from channel c0 into the
// next x slot.
template <class C, bool HAS_D, class TileX>
__device__ void produce_out(Rings<C>& ring, const CUtensorMap* w3m,
                            const CUtensorMap* wdm, int c, int co,
                            unsigned rank, TileX tile_x) {
  for (int n0 = 0; n0 < co; n0 += C::NP3) {
    for (int k0 = 0; k0 < C::M; k0 += 64) {
      load_w(ring, w3m, k0, n0, C::NP3, 64, rank);
    }
    if constexpr (HAS_D) {
      for (int k0 = 0; k0 < c; k0 += 64) {
        tile_x(k0);
        load_w(ring, wdm, k0, n0, C::NP3, 64, rank);
      }
    }
    for (int c0 = n0; c0 < n0 + C::NP3; c0 += 64) {
      if constexpr (HAS_D) {
        ring.x.acquire(0);
      } else {
        tile_x(c0);
      }
    }
  }
}

template <class C, bool HAS_D>
__device__ void produce(Rings<C>& ring, const CUtensorMap* xh,
                        const CUtensorMap* xc, const CUtensorMap* w1m,
                        const CUtensorMap* w2m, const CUtensorMap* w3m,
                        const CUtensorMap* wdm, const Params& p, int bi,
                        int oy0, int ox0, unsigned rank) {
  // x's box of 64 channels from channel c0 at (x0, y0) into the next x slot
  auto load_x = [&](const CUtensorMap* map, int c0, int x0, int y0,
                    int pixels) {
    const int s = ring.x.acquire(pixels * 128);
    sgc::tma_load_4d(ring.x.slot(s), map, ring.x.full(s), c0, x0, y0, bi);
  };
  for (int n0 = 0; n0 < C::M; n0 += C::NP1) {
    for (int k0 = 0; k0 < p.c; k0 += 64) {
      load_x(xh, k0, ox0 - 1, oy0 - 1, C::NH);
      load_w(ring, w1m, k0, n0, C::NP1, 64, rank);
    }
  }
  for (int k0 = 0; k0 < 9 * C::M; k0 += C::KC2) {
    load_w(ring, w2m, k0, 0, C::M, C::KC2, rank);
  }
  produce_out<C, HAS_D>(ring, w3m, wdm, p.c, p.co, rank, [&](int c0) {
    load_x(xc, c0, ox0, oy0, C::OUT);
  });
}

// a and x through their pair views (B, H/2, 2, W/2, 2 C): the box of 64
// channels from c0, column pairs from cp, row parity `parity`, row pairs
// from rp, of image bi.
template <class C>
__device__ void produce_s2(Rings<C>& ring, const CUtensorMap* a5,
                           const CUtensorMap* x5, const CUtensorMap* w2m,
                           const CUtensorMap* w3m, const CUtensorMap* wdm,
                           const Params& p, int bi, int oy0, int ox0,
                           unsigned rank) {
  auto load_pair = [&](const CUtensorMap* map, int c0, int cp, int parity,
                       int rp) {
    const int s = ring.x.acquire(C::XB);
    sgc::tma_load_5d(ring.x.slot(s), map, ring.x.full(s), c0, cp, parity,
                     rp, bi);
  };
  // conv2: tap (dy, dx) of output (u, v) reads a at row 2u - 1 + dy and
  // column 2v - 1 + dx: row pair u - (dy == 0), parity (dy + 1) % 2,
  // column pair v - (dx == 0), channels from M ((dx + 1) % 2); pair -1 is
  // zero fill.  Each box is followed by the XR weight chunks of its rows.
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap % 3;
    for (int k0 = 0; k0 < C::M; k0 += 64) {
      load_pair(a5, C::M * ((dx + 1) % 2) + k0, ox0 - (dx == 0),
                (dy + 1) % 2, oy0 - (dy == 0));
      for (int r = 0; r < C::XR; ++r) {
        load_w(ring, w2m, tap * C::M + k0 + r * C::KC2, 0, C::M, C::KC2,
               rank);
      }
    }
  }
  // the projection reads x[2u, 2v]: parity 0, the even column's channels
  produce_out<C, true>(ring, w3m, wdm, p.c, p.co, rank, [&](int c0) {
    load_pair(x5, c0, ox0, 0, oy0);
  });
}

// ---- consumers ----

// n weight chunks (and, with X, an x box for every XR of them) into acc
// (RBW row blocks x NW columns a warpgroup): for chunk j and its 16-deep
// step kk, a_desc(sx, j, kk, r) is A's descriptor for row block r (sx: the
// chunk's x slot), and B is the chunk's weights from column `col0` on
// (MN-major, 64-column atoms of KC rows).  Each slot is released once the
// products that read it have completed.
template <int RBW, int NW, int KC, bool X, int XR = 1, class C, class ADesc>
__device__ __forceinline__ void mainloop(float (&acc)[RBW][NW / 2],
                                         Rings<C>& ring, int n, int col0,
                                         ADesc a_desc) {
  int sx = 0, prev_w = -1, prev_x = -1;
  for (int j = 0; j < n; ++j) {
    if (X && j % XR == 0) {
      sx = ring.x.take();
    }
    const int sw = ring.w.take();
    sgc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      const uint64_t b = sgc::wgmma_desc(
          ring.w.slot(sw) + (col0 / 64) * KC * 128 + kk * 2048, KC * 128,
          1024, true);
#pragma unroll
      for (int r = 0; r < RBW; ++r) {
        sgc::wgmma_ss<NW>(acc[r], a_desc(sx, j, kk, r), b, j > 0 || kk > 0);
      }
    }
    sgc::wgmma_commit();
    if (j > 0) {
      sgc::wgmma_wait<1>();
      ring.w.release(prev_w);
      if (X && j % XR == 0) {     // chunk j - 1 was the box's last reader
        ring.x.release(prev_x);
      }
    }
    prev_w = sw;
    prev_x = sx;
  }
  sgc::wgmma_wait<0>();
  ring.w.release(prev_w);
  if (X) {
    ring.x.release(prev_x);
  }
#pragma unroll
  for (int r = 0; r < RBW; ++r) {
    sgc::fence_acc(acc[r]);
  }
}

// Calls f(r, row, col, k) for each accumulator pair of this thread: the
// pair acc[r][k], acc[r][k + 1] is row `row` (0..63) of row block r,
// columns col and col + 1 from the warpgroup's first column (the wgmma D
// layout: warp q of the warpgroup holds rows 16 q + g and 16 q + g + 8,
// g = lane / 4, columns 8 j + 2 (lane % 4) and + 1 of each 8-column block
// j, at k = 4 j and 4 j + 2).
template <int RBW, int NW, class F>
__device__ __forceinline__ void each_pair(F f) {
  const int lane = threadIdx.x % 32;
  const int row0 = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < RBW; ++r) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        f(r, row0 + 8 * hf, 8 * j + c0, 4 * j + 2 * hf);
      }
    }
  }
}

// A pass of NP columns out through NP / 64 staging slots of the x ring, in
// TMA's swizzled box layout: the pair of columns (nl, nl + 1) of the pass
// at accumulator row (r, row) goes to box row box_row(r, row) as the
// packed val(r, k, nl, at), where `at` holds what the producer left there
// (the identity's x, or nothing); then one thread stores the boxes with
// store(h, slot), and once the stores have read them every consumer warp
// frees the slots with one arrival each, as every other release of the
// ring does.  (One arrival of the whole block's count from the storing
// thread could land on the partner's barrier while the slot's previous
// phase there still waits for fewer arrivals than that count: the blocks
// of a cluster drift apart when another process's work preempts the
// kernel, and the overflowed barrier faults the launch.)
template <int RBW, int NW, int NP, class C, class Row, class Val,
          class Store>
__device__ __forceinline__ void store_staged(Rings<C>& ring,
                                             unsigned char* smem_base,
                                             int col0, Row box_row, Val val,
                                             Store store) {
  const uint32_t smem_s = sgc::smem_addr(smem_base);
  int stage[NP / 64];
#pragma unroll
  for (int h = 0; h < NP / 64; ++h) {
    stage[h] = ring.x.take();
  }
  each_pair<RBW, NW>([&](int r, int row, int col, int k) {
    const int br = box_row(r, row);
    const int nl = col0 + col;           // the pass's column
    const int ch = nl % 64;
    unsigned char* at =
        smem_base + (ring.x.slot(stage[nl / 64]) - smem_s) + br * 128 +
        (((ch / 8) ^ (br % 8)) * 16) + (ch % 8) * 2;
    *reinterpret_cast<unsigned*>(at) = val(r, k, nl, at);
  });
  sgc::fence_proxy_async();     // the TMA store reads what was written
  sgc::named_sync(kConsumerBar, kConsumerThreads);
  if (threadIdx.x == kFirstConsumer) {
#pragma unroll
    for (int h = 0; h < NP / 64; ++h) {
      store(h, ring.x.slot(stage[h]));
    }
    sgc::tma_store_wait_read();
  }
  sgc::named_sync(kConsumerBar, kConsumerThreads);
#pragma unroll
  for (int h = 0; h < NP / 64; ++h) {
    ring.x.release(stage[h]);
  }
}

// conv2's epilogue: b = cd(relu(BN2(acc))) into act, channel-planar over
// the tile's OUT pixels.
template <class C, class Sp>
__device__ __forceinline__ void store_b(float (&acc)[Sp::RBW][Sp::NW / 2],
                                        unsigned char* act, const Params& p,
                                        int wg) {
  const int col0 = Sp::col0(wg);
  each_pair<Sp::RBW, Sp::NW>([&](int r, int row, int col, int k) {
    const int n = col0 + col;
    const float2 sc = fold2(p.s2 + n);
    const float2 sh = fold2(p.s2 + C::M + n);
    *reinterpret_cast<unsigned*>(
        act + planar(C::OUT, Sp::rb(wg, r) * 64 + row, n)) =
        pack2(fmaxf(sgc::affine(acc[r][k], sc.x, sh.x), 0.f),
              fmaxf(sgc::affine(acc[r][k + 1], sc.y, sh.y), 0.f));
  });
}

// conv3 (+ projection, its A the tile's x box in the x slots) and the
// identity, y written once through the staging slots, where the identity's
// x already lies (tile row i TW + j of the box, 64 channels).
template <class C, bool HAS_D>
__device__ void consume_out(Rings<C>& ring, unsigned char* smem_base,
                            unsigned char* act, const CUtensorMap* ym,
                            const Params& p, int bi, int oy0, int ox0,
                            int wg) {
  using Sp = Split<C::RB2, C::NP3>;
  const uint32_t act_s = sgc::smem_addr(act);
  const int col0 = Sp::col0(wg);
  // the box row of row block rb's first pixel (8 tile rows x 8 columns)
  auto box_row0 = [](int rb) {
    return 8 * (rb / (C::TW / 8)) * C::TW + 8 * (rb % (C::TW / 8));
  };
  for (int n0 = 0; n0 < p.co; n0 += C::NP3) {
    float acc[Sp::RBW][Sp::NW / 2];
    mainloop<Sp::RBW, Sp::NW, 64, false>(
        acc, ring, C::M / 64, col0, [&](int, int j, int kk, int r) {
          return sgc::wgmma_desc(
              act_s + planar(C::OUT, Sp::rb(wg, r) * 64, 64 * j + 16 * kk),
              C::OUT * 16, 128, false);
        });
    float accd[HAS_D ? Sp::RBW : 1][HAS_D ? Sp::NW / 2 : 1];
    if constexpr (HAS_D) {
      mainloop<Sp::RBW, Sp::NW, 64, true>(
          accd, ring, p.c / 64, col0, [&](int sx, int, int kk, int r) {
            return sgc::wgmma_desc(ring.x.slot(sx) +
                                       box_row0(Sp::rb(wg, r)) * 128 +
                                       kk * 32,
                                   16, C::TW * 128, true);
          });
    }
    store_staged<Sp::RBW, Sp::NW, C::NP3>(
        ring, smem_base, col0,
        [&](int r, int row) {
          return box_row0(Sp::rb(wg, r)) + (row / 8) * C::TW + row % 8;
        },
        [&](int r, int k, int nl, const unsigned char* at) {
          const int n = n0 + nl;
          const float2 sc = fold2(p.s3 + n);
          const float2 sh = fold2(p.s3 + p.co + n);
          float i0, i1;
          if constexpr (HAS_D) {
            const float2 dc = fold2(p.sd + n);
            const float2 dh = fold2(p.sd + p.co + n);
            i0 = sgc::affine(accd[r][k], dc.x, dh.x);
            i1 = sgc::affine(accd[r][k + 1], dc.y, dh.y);
          } else {
            const unsigned xv = *reinterpret_cast<const unsigned*>(at);
            i0 = __uint_as_float(xv << 16);          // bf16 -> float32
            i1 = __uint_as_float(xv & 0xffff0000u);
          }
          return pack2(fmaxf(sgc::affine(acc[r][k], sc.x, sh.x) + i0, 0.f),
                       fmaxf(sgc::affine(acc[r][k + 1], sc.y, sh.y) + i1,
                             0.f));
        },
        [&](int h, uint32_t slot) {
          sgc::tma_store_4d(ym, slot, n0 + 64 * h, ox0, oy0, bi);
        });
  }
  if (threadIdx.x == kFirstConsumer) {
    sgc::tma_store_wait();
  }
}

template <class C, bool HAS_D>
__device__ void consume(Rings<C>& ring, unsigned char* smem_base,
                        unsigned char* act, const CUtensorMap* ym,
                        const Params& p, int bi, int oy0, int ox0, int wg) {
  const uint32_t act_s = sgc::smem_addr(act);

  // 1. conv1 over the haloed pixels, A = x's box (swizzled, K-major)
  {
    using Sp = Split<C::RB1, C::NP1>;
    const int col0 = Sp::col0(wg);
    for (int n0 = 0; n0 < C::M; n0 += C::NP1) {
      float acc[Sp::RBW][Sp::NW / 2];
      mainloop<Sp::RBW, Sp::NW, 64, true>(
          acc, ring, p.c / 64, col0, [&](int sx, int, int kk, int r) {
            return sgc::wgmma_desc(
                ring.x.slot(sx) + Sp::rb(wg, r) * 8192 + kk * 32, 16, 1024,
                true);
          });
      each_pair<Sp::RBW, Sp::NW>([&](int r, int row, int col, int k) {
            const int hr = Sp::rb(wg, r) * 64 + row;   // haloed pixel
            if (hr < C::NH) {
              const int iy = oy0 - 1 + hr / C::HW;
              const int ix = ox0 - 1 + hr % C::HW;
              const int n = n0 + col0 + col;
              float a0 = 0.f, a1 = 0.f;
              if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w) {
                const float2 sc = fold2(p.s1 + n);
                const float2 sh =
                    fold2(p.s1 + C::M + n);
                a0 = fmaxf(sgc::affine(acc[r][k], sc.x, sh.x), 0.f);
                a1 = fmaxf(sgc::affine(acc[r][k + 1], sc.y, sh.y), 0.f);
              }
              *reinterpret_cast<unsigned*>(act + planar(C::NH, hr, n)) =
                  pack2(a0, a1);
            }
          });
    }
  }
  sgc::fence_proxy_async();        // a, written here, is read by wgmma
  sgc::named_sync(kConsumerBar, kConsumerThreads);

  // 2. conv2: K = 9 M tap-major in chunks of KC2 (each within one tap);
  // tap (dy, dx) of row block rb reads, for tile row i, the 8 haloed
  // pixels from (8 rb_y + i + dy) HW + 8 rb_x + dx on
  {
    using Sp = Split<C::RB2, C::M>;
    float acc[Sp::RBW][Sp::NW / 2];
    mainloop<Sp::RBW, Sp::NW, C::KC2, false>(
        acc, ring, 9 * C::M / C::KC2, Sp::col0(wg),
        [&](int, int j, int kk, int r) {
          const int k0 = j * C::KC2 + kk * 16;
          const int tap = k0 / C::M;
          const int rb = Sp::rb(wg, r);
          const int pix = (8 * (rb / (C::TW / 8)) + tap / 3) * C::HW +
                          8 * (rb % (C::TW / 8)) + tap % 3;
          return sgc::wgmma_desc(
              act_s + planar(C::NH, pix, k0 - tap * C::M), C::NH * 16,
              C::HW * 16, false);
        });
    // every consumer is done reading a: b goes over it
    sgc::named_sync(kConsumerBar, kConsumerThreads);
    store_b<C, Sp>(acc, act, p, wg);
  }
  sgc::fence_proxy_async();
  sgc::named_sync(kConsumerBar, kConsumerThreads);

  // 3. conv3 (+ projection) and the identity, y written once
  consume_out<C, HAS_D>(ring, smem_base, act, ym, p, bi, oy0, ox0, wg);
}

template <class C>
__device__ void consume_s2(Rings<C>& ring, unsigned char* smem_base,
                           unsigned char* act, const CUtensorMap* ym,
                           const Params& p, int bi, int oy0, int ox0,
                           int wg) {
  // conv2: K = 9 M tap-major in chunks of KC2; chunk j takes its 16-deep
  // steps from the box of a loaded for its tap and 64 channels (the
  // output tile's pixels in order, so row block rb is box rows 64 rb on)
  {
    using Sp = Split<C::RB2, C::M>;
    float acc[Sp::RBW][Sp::NW / 2];
    mainloop<Sp::RBW, Sp::NW, C::KC2, true, C::XR>(
        acc, ring, 9 * C::M / C::KC2, Sp::col0(wg),
        [&](int sx, int j, int kk, int r) {
          return sgc::wgmma_desc(
              ring.x.slot(sx) + Sp::rb(wg, r) * 8192 +
                  ((j % C::XR) * (C::KC2 / 16) + kk) * 32,
              16, 1024, true);
        });
    store_b<C, Sp>(acc, act, p, wg);
  }
  sgc::fence_proxy_async();        // b, written here, is read by wgmma
  sgc::named_sync(kConsumerBar, kConsumerThreads);
  consume_out<C, true>(ring, smem_base, act, ym, p, bi, oy0, ox0, wg);
}

// conv1_s2_hopper's consumers: a = cd(relu(BN1(x W1))) for the tile's 128
// rows (one 64-row block a warpgroup), pass by pass, out by TMA.
template <class C>
__device__ void consume_c1(Rings<C>& ring, unsigned char* smem_base,
                           const CUtensorMap* am, const float* s1, int m,
                           int c, int p0, int wg) {
  using Sp = Split<2, C::NP>;
  for (int n0 = 0; n0 < m; n0 += C::NP) {
    float acc[Sp::RBW][Sp::NW / 2];
    mainloop<Sp::RBW, Sp::NW, 64, true>(
        acc, ring, c / 64, 0, [&](int sx, int, int kk, int r) {
          return sgc::wgmma_desc(
              ring.x.slot(sx) + Sp::rb(wg, r) * 8192 + kk * 32, 16, 1024,
              true);
        });
    store_staged<Sp::RBW, Sp::NW, C::NP>(
        ring, smem_base, 0,
        [&](int r, int row) { return Sp::rb(wg, r) * 64 + row; },
        [&](int r, int k, int nl, const unsigned char*) {
          const int n = n0 + nl;
          const float2 sc = fold2(s1 + n);
          const float2 sh = fold2(s1 + m + n);
          return pack2(fmaxf(sgc::affine(acc[r][k], sc.x, sh.x), 0.f),
                       fmaxf(sgc::affine(acc[r][k + 1], sc.y, sh.y), 0.f));
        },
        [&](int h, uint32_t slot) {
          sgc::tma_store_2d(am, slot, n0 + 64 * h, p0);
        });
  }
  if (threadIdx.x == kFirstConsumer) {
    sgc::tma_store_wait();
  }
}

// ---- kernels: warpgroup 0 produces (one thread), warpgroups 1-2 consume.
// A block past the last tile (the partner of an odd tile count) runs on
// TMA's zero fill and stores nothing, so that it takes part in every
// multicast and slot release of its cluster; the closing cluster barrier
// keeps either block from leaving while its partner may still multicast
// into it or arrive on its barriers. ----

template <class C, bool HAS_D>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_hopper(const __grid_constant__ CUtensorMap xh,
                  const __grid_constant__ CUtensorMap xc,
                  const __grid_constant__ CUtensorMap w1m,
                  const __grid_constant__ CUtensorMap w2m,
                  const __grid_constant__ CUtensorMap w3m,
                  const __grid_constant__ CUtensorMap wdm,
                  const __grid_constant__ CUtensorMap ym, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  Rings<C> ring = make_rings<C>(smem, C::ACT);
  unsigned char* act = smem + C::SX * C::XB + C::SW * C::WB;
  const int bi = blockIdx.y;
  const int oy0 = (blockIdx.x / p.tiles_x) * C::TH;
  const int ox0 = (blockIdx.x % p.tiles_x) * C::TW;
  if (threadIdx.x < 128) {
    sgc::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      produce<C, HAS_D>(ring, &xh, &xc, &w1m, &w2m, &w3m, &wdm, p, bi, oy0,
                        ox0, sgc::cluster_rank());
    }
  } else {
    sgc::regs_inc<kConsumerRegs>();
    consume<C, HAS_D>(ring, smem, act, &ym, p, bi, oy0, ox0,
                      threadIdx.x / 128 - 1);
  }
  sgc::cluster_sync();
}

// a5 and x5: a and x as (B, H/2, 2, W/2, 2 C) in boxes of the output tile;
// ym: y (B, H/2, W/2, CO) in boxes of the tile.
template <class C>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_s2_hopper(const __grid_constant__ CUtensorMap a5,
                     const __grid_constant__ CUtensorMap x5,
                     const __grid_constant__ CUtensorMap w2m,
                     const __grid_constant__ CUtensorMap w3m,
                     const __grid_constant__ CUtensorMap wdm,
                     const __grid_constant__ CUtensorMap ym,
                     const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  Rings<C> ring = make_rings<C>(smem, C::ACT);
  unsigned char* act = smem + C::SX * C::XB + C::SW * C::WB;
  const int bi = blockIdx.y;
  const int oy0 = (blockIdx.x / p.tiles_x) * C::TH;
  const int ox0 = (blockIdx.x % p.tiles_x) * C::TW;
  if (threadIdx.x < 128) {
    sgc::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      produce_s2<C>(ring, &a5, &x5, &w2m, &w3m, &wdm, p, bi, oy0, ox0,
                    sgc::cluster_rank());
    }
  } else {
    sgc::regs_inc<kConsumerRegs>();
    consume_s2<C>(ring, smem, act, &ym, p, bi, oy0, ox0,
                  threadIdx.x / 128 - 1);
  }
  sgc::cluster_sync();
}

// xm and am: x (B H W, C) and a (B H W, M) in boxes of 64 channels x 128
// rows; s1 the (2, M) fold.
template <class C>
__global__ void __launch_bounds__(kThreads, 1)
conv1_s2_hopper(const __grid_constant__ CUtensorMap xm,
                const __grid_constant__ CUtensorMap w1m,
                const __grid_constant__ CUtensorMap am,
                const float* __restrict__ s1, int m, int c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  Rings<C> ring = make_rings<C>(smem, 0);
  const int p0 = blockIdx.x * C::OUT;      // the tile's first row
  if (threadIdx.x < 128) {
    sgc::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const unsigned rank = sgc::cluster_rank();
      for (int n0 = 0; n0 < m; n0 += C::NP) {
        for (int k0 = 0; k0 < c; k0 += 64) {
          const int s = ring.x.acquire(C::XB);
          sgc::tma_load_2d(ring.x.slot(s), &xm, ring.x.full(s), k0, p0);
          load_w(ring, &w1m, k0, n0, C::NP, 64, rank);
        }
        for (int h = 0; h < C::NP / 64; ++h) {
          ring.x.acquire(0);                 // a's staging
        }
      }
    }
  } else {
    sgc::regs_inc<kConsumerRegs>();
    consume_c1<C>(ring, smem, &am, s1, m, c, p0, threadIdx.x / 128 - 1);
  }
  sgc::cluster_sync();
}

// A (K, N) weight matrix in boxes of kc / 2 rows (each block of the
// cluster loads half of a chunk's rows).
CUresult weight_map(CUtensorMap* map, const void* w, int k, int n, int kc) {
  return matrix_map(map, w, k, n, kc / 2);
}

// x (B, H, W, C) (or y) in boxes of 64 channels x bw x bh pixels of one
// image.
CUresult x_map(CUtensorMap* map, const void* x, int b, int h, int w, int c,
               int bh, int bw) {
  const cuuint64_t dims[4] = {cuuint64_t(c), cuuint64_t(w), cuuint64_t(h),
                              cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(c) * 2, cuuint64_t(w) * c * 2,
                                 cuuint64_t(h) * w * c * 2};
  const cuuint32_t box[4] = {64, cuuint32_t(bw), cuuint32_t(bh), 1};
  return tensor_map(map, x, 4, dims, strides, box);
}

// x (B, H, W, C), H and W even, as (B, H/2, 2, W/2, 2 C) (a reshape: each
// stride is the packed one) in boxes of 64 channels x bw column pairs x 1
// row parity x bh row pairs of one image.
CUresult pair_map(CUtensorMap* map, const void* x, int b, int h, int w,
                  int c, int bh, int bw) {
  const cuuint64_t dims[5] = {cuuint64_t(2) * c, cuuint64_t(w / 2), 2,
                              cuuint64_t(h / 2), cuuint64_t(b)};
  const cuuint64_t strides[4] = {
      cuuint64_t(c) * 4, cuuint64_t(w) * c * 2, cuuint64_t(w) * c * 4,
      cuuint64_t(h) * w * c * 2};
  const cuuint32_t box[5] = {64, cuuint32_t(bw), 1, cuuint32_t(bh), 1};
  return tensor_map(map, x, 5, dims, strides, box);
}

template <int M, bool HAS_D>
cudaError_t launch(const void* x, const void* w1, const void* s1,
                   const void* w2, const void* s2, const void* w3,
                   const void* s3, const void* wd, const void* sd, void* y,
                   int b, int h, int w, int c, int co, cudaStream_t stream) {
  using C = typename CfgOf<M, HAS_D>::T;
  CUtensorMap xh, xc, w1m, w2m, w3m, wdm, ym;
  memset(&wdm, 0, sizeof(wdm));
  if (x_map(&xh, x, b, h, w, c, C::HH, C::HW) != CUDA_SUCCESS ||
      x_map(&xc, x, b, h, w, c, C::TH, C::TW) != CUDA_SUCCESS ||
      x_map(&ym, y, b, h, w, co, C::TH, C::TW) != CUDA_SUCCESS ||
      weight_map(&w1m, w1, c, M, 64) != CUDA_SUCCESS ||
      weight_map(&w2m, w2, 9 * M, M, C::KC2) != CUDA_SUCCESS ||
      weight_map(&w3m, w3, M, co, 64) != CUDA_SUCCESS ||
      (HAS_D && weight_map(&wdm, wd, c, co, 64) != CUDA_SUCCESS)) {
    return cudaErrorInvalidValue;
  }
  const int tiles_x = (w + C::TW - 1) / C::TW;
  const Params p{static_cast<const float*>(s1), static_cast<const float*>(s2),
                 static_cast<const float*>(s3), static_cast<const float*>(sd),
                 h, w, c, co, tiles_x};
  return launch_clusters(bottleneck_hopper<C, HAS_D>, C::SMEM,
                         tiles_x * ((h + C::TH - 1) / C::TH), b, stream, xh,
                         xc, w1m, w2m, w3m, wdm, ym, p);
}

// Stride 2: conv1_s2_hopper into the scratch a, then bottleneck_s2_hopper,
// both on `stream`.
template <int M>
cudaError_t launch_s2(const void* x, const void* w1, const void* s1,
                      const void* w2, const void* s2, const void* w3,
                      const void* s3, const void* wd, const void* sd,
                      void* y, void* a, int b, int h, int w, int c, int co,
                      cudaStream_t stream) {
  using C = typename CfgS2Of<M>::T;
  using C1 = CfgC1Of<M>;
  const long long rows = static_cast<long long>(b) * h * w;
  CUtensorMap xm, w1m, am, a5, x5, w2m, w3m, wdm, ym;
  if (matrix_map(&xm, x, rows, c, C1::OUT) != CUDA_SUCCESS ||
      matrix_map(&am, a, rows, M, C1::OUT) != CUDA_SUCCESS ||
      weight_map(&w1m, w1, c, M, 64) != CUDA_SUCCESS ||
      pair_map(&a5, a, b, h, w, M, C::TH, C::TW) != CUDA_SUCCESS ||
      pair_map(&x5, x, b, h, w, c, C::TH, C::TW) != CUDA_SUCCESS ||
      weight_map(&w2m, w2, 9 * M, M, C::KC2) != CUDA_SUCCESS ||
      weight_map(&w3m, w3, M, co, 64) != CUDA_SUCCESS ||
      weight_map(&wdm, wd, c, co, 64) != CUDA_SUCCESS ||
      x_map(&ym, y, b, h / 2, w / 2, co, C::TH, C::TW) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = launch_clusters(
      conv1_s2_hopper<C1>, C1::SMEM,
      static_cast<int>((rows + C1::OUT - 1) / C1::OUT), 1, stream, xm, w1m,
      am, static_cast<const float*>(s1), M, c);
  if (err != cudaSuccess) {
    return err;
  }
  const int tiles_x = (w / 2 + C::TW - 1) / C::TW;
  const Params p{static_cast<const float*>(s1), static_cast<const float*>(s2),
                 static_cast<const float*>(s3), static_cast<const float*>(sd),
                 h, w, c, co, tiles_x};
  return launch_clusters(bottleneck_s2_hopper<C>, C::SMEM,
                         tiles_x * ((h / 2 + C::TH - 1) / C::TH), b, stream,
                         a5, x5, w2m, w3m, wdm, ym, p);
}

// The plan of an M: {tile rows, tile columns, cluster size, weight-chunk
// slots, shared-memory bytes, rows of conv1_s2_hopper's tile (0: conv1
// runs inside the block)}.
template <int M, bool HAS_D>
void plan_of(int* out) {
  using C = typename CfgOf<M, HAS_D>::T;
  const int plan[6] = {C::TH, C::TW, kCluster, C::SW, C::SMEM, 0};
  memcpy(out, plan, sizeof(plan));
}
template <int M>
void plan_s2_of(int* out) {
  using C = typename CfgS2Of<M>::T;
  const int plan[6] = {C::TH, C::TW, kCluster, C::SW, C::SMEM,
                       CfgC1Of<M>::OUT};
  memcpy(out, plan, sizeof(plan));
}

cudaError_t dispatch(const void* x, const void* w1, const void* s1,
                     const void* w2, const void* s2, const void* w3,
                     const void* s3, const void* wd, const void* sd, void* y,
                     int b, int h, int w, int c, int m, int co,
                     cudaStream_t st) {
#define SGC_HOPPER(M)                                                        \
  case M:                                                                    \
    return wd != nullptr                                                     \
               ? launch<M, true>(x, w1, s1, w2, s2, w3, s3, wd, sd, y, b, h, \
                                 w, c, co, st)                               \
               : launch<M, false>(x, w1, s1, w2, s2, w3, s3, wd, sd, y, b,  \
                                  h, w, c, co, st);
  switch (m) {
    SGC_HOPPER(64)
    SGC_HOPPER(128)
    SGC_HOPPER(256)
    SGC_HOPPER(512)
    default:
      return cudaErrorInvalidValue;
  }
#undef SGC_HOPPER
}

cudaError_t dispatch_s2(const void* x, const void* w1, const void* s1,
                        const void* w2, const void* s2, const void* w3,
                        const void* s3, const void* wd, const void* sd,
                        void* y, void* a, int b, int h, int w, int c, int m,
                        int co, cudaStream_t st) {
#define SGC_HOPPER_S2(M)                                                    \
  case M:                                                                   \
    return launch_s2<M>(x, w1, s1, w2, s2, w3, s3, wd, sd, y, a, b, h, w, \
                        c, co, st);
  switch (m) {
    SGC_HOPPER_S2(128)
    SGC_HOPPER_S2(256)
    SGC_HOPPER_S2(512)
    default:
      return cudaErrorInvalidValue;
  }
#undef SGC_HOPPER_S2
}

}  // namespace hop

// float32 runs the mma.sync template on 4 x 4 output tiles (64 columns a
// pass); bfloat16 goes to the Hopper kernels.
cudaError_t dispatch(const void* x, const void* w1, const void* s1,
                     const void* w2, const void* s2, const void* w3,
                     const void* s3, const void* wd, const void* sd, void* y,
                     void* a, int b, int h, int w, int c, int m, int co,
                     int stride, int dtype, cudaStream_t st) {
  const bool has_d = wd != nullptr;
  if (dtype == 0) {
    if (stride == 2) {
      return launch<float, 4, 4, 2, true>(SGC_BOTTLENECK_ARGS);
    }
    return has_d ? launch<float, 4, 4, 1, true>(SGC_BOTTLENECK_ARGS)
                 : launch<float, 4, 4, 1, false>(SGC_BOTTLENECK_ARGS);
  }
  if (stride == 2) {
    return a == nullptr ? cudaErrorInvalidValue
                        : hop::dispatch_s2(x, w1, s1, w2, s2, w3, s3, wd, sd,
                                           y, a, b, h, w, c, m, co, st);
  }
  return hop::dispatch(x, w1, s1, w2, s2, w3, s3, wd, sd, y, b, h, w, c, m,
                       co, st);
}

#undef SGC_BOTTLENECK_ARGS

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// stride 1 or 2 (stride 2 needs wd/sd and even H and W); wd = sd = NULL
// for the identity (then C == CO).  a: bfloat16 at stride 2 only, a
// (B, H, W, M) scratch for conv1's output (NULL otherwise).  The caller
// guarantees contiguous, 16-byte aligned tensors of the shapes above with
// C, M and CO multiples of 64 and B, H, W >= 1; bfloat16 takes M = 64,
// 128, 256 or 512 at stride 1 and 128, 256 or 512 at stride 2
// (cudaErrorInvalidValue otherwise).  Returns the cudaError_t of the
// launches.
extern "C" int sgc_bottleneck(const void* x, const void* w1, const void* s1,
                              const void* w2, const void* s2, const void* w3,
                              const void* s3, const void* wd, const void* sd,
                              void* y, void* a, int b, int h, int w, int c,
                              int m, int co, int stride, int dtype,
                              int device, void* stream) {
  cudaError_t err = sgc::use_device(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((stride != 1 && stride != 2) || (stride == 2 && wd == nullptr) ||
      (stride == 2 && (h % 2 || w % 2)) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch(x, w1, s1, w2, s2, w3, s3, wd, sd, y, a,
                                   b, h, w, c, m, co, stride, dtype,
                                   static_cast<cudaStream_t>(stream)));
}

// The plan of the bfloat16 kernel at M and stride (with the projection
// when has_d is not 0; stride 2 always has it): out = {tile rows, tile
// columns, cluster size, weight-chunk slots, shared-memory bytes, rows of
// the stride-2 conv1 kernel's tile (0 at stride 1)}.  Returns
// cudaErrorInvalidValue for an M or stride it does not take.
extern "C" int sgc_bottleneck_plan(int m, int has_d, int stride, int* out) {
#define SGC_PLAN(M)                                                   \
  case M:                                                             \
    has_d ? hop::plan_of<M, true>(out) : hop::plan_of<M, false>(out); \
    return 0;
#define SGC_PLAN_S2(M)         \
  case M:                      \
    hop::plan_s2_of<M>(out);   \
    return 0;
  if (stride == 2) {
    switch (m) {
      SGC_PLAN_S2(128)
      SGC_PLAN_S2(256)
      SGC_PLAN_S2(512)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (stride != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (m) {
    SGC_PLAN(64)
    SGC_PLAN(128)
    SGC_PLAN(256)
    SGC_PLAN(512)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SGC_PLAN
#undef SGC_PLAN_S2
}
