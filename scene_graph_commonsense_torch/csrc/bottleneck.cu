// Fused frozen ResNet bottleneck blocks of the DETR-101 trunk.  Two kernel
// templates behind one plain C entry point for ctypes:
//
//   sgc_bottleneck   y = relu(BN3(W3 . relu(BN2(conv3x3/s(relu(BN1(W1 . x))))))
//                         + idn(x))
//
// x: contiguous (B, H, W, C) NHWC in the compute dtype (float32 or
// bfloat16); w1 (C, M), w2 (3, 3, M, M) = (9 M, M), w3 (M, CO) and the
// optional projection wd (C, CO) in the compute dtype, the flax (in, out)
// layout; s1, s2 (2, M) and s3, sd (2, CO): float32 folded frozen BNs
// [scale, shift]; y: (B, H/s, W/s, CO) in the compute dtype.
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
//     H and W even.  NHWC is read directly (the TPU kernel's column-pair
//     lane packing is a Mosaic workaround).
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
// passes.  Two kernels do this:
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
// bottleneck_kernel: float32 (the card-vs-CPU parity runs) and stride 2
// (K4), through tile_gemm (csrc/tile_gemm.cuh): mma.sync on the tensor
// cores for bfloat16 (K chunks of 64, two cp.async stages, up to 256
// output columns a pass), float32 FMAs for float32 (wgmma has no float32
// operands, and TF32 would not hold the float32 parity).  Tiles: bfloat16
// 4 x 8 at stride 2 (153 haloed pixels, 222 KB at M = 256), 2 x 8 at
// M = 512 (85, 211 KB); float32 4 x 4.  At stride 2 the shifted tap rows
// lie two pixels apart, so each chunk is copied out of a before ldmatrix
// reads it.  Shared-memory traffic (fragment loads and the cp.async weight
// stream) sets its pace; it is the stride-2 path's next redesign, reusing
// the producer, ring and cluster of bottleneck_hopper for conv1 and conv3.

#include <cuda.h>
#include <string.h>

#include "tile_gemm.cuh"

namespace {

using sgc::bf16;
using sgc::kThreads;

template <typename T, int TH, int TW, int S, int NC12>
struct Tile {
  static constexpr int kHH = (TH - 1) * S + 3;  // haloed input rows
  static constexpr int kHW = (TW - 1) * S + 3;  // haloed input columns
  static constexpr int kNH = kHH * kHW;
  static constexpr int kRA = sgc::round16(kNH);
  static constexpr int kRO = TH * TW;
  static constexpr int kNC3 = sgc::is_f32<T>() ? 64 : 256;  // conv3 columns
  static constexpr int kLdc = kNC3 + 4;         // float32 conv3 chunk
  static_assert(kRO % 16 == 0, "output tile rows are whole WMMA tiles");

  __host__ __device__ static constexpr size_t gemm_bytes() {
    return sgc::align128(
        sgc::gemm_smem_bytes<T, (NC12 > kNC3 ? NC12 : kNC3)>(kRA));
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

template <typename T, int TH, int TW, int S, bool HAS_D, int NC12>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ s1, const T* __restrict__ w2,
                  const float* __restrict__ s2, const T* __restrict__ w3,
                  const float* __restrict__ s3, const T* __restrict__ wd,
                  const float* __restrict__ sd, T* __restrict__ y, int h,
                  int w, int c, int m, int co, int tiles_x) {
  using Tl = Tile<T, TH, TW, S, NC12>;
  constexpr int kHW = Tl::kHW;
  constexpr int kNH = Tl::kNH;
  constexpr int kRA = Tl::kRA;
  constexpr int kRO = Tl::kRO;
  constexpr int kNC3 = Tl::kNC3;
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
  for (int n0 = 0; n0 < m; n0 += NC12) {
    sgc::tile_gemm<T, kRA, NC12, false>(
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
  // ldmatrix reads a in place; at stride 2 its rows lie two pixels apart
  // (bank conflicts), so the chunk is copied out first.
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
  for (int n0 = 0; n0 < m; n0 += NC12) {
    if constexpr (S == 1) {
      sgc::tile_gemm<T, kRO, NC12, true>(smem, w2, 9 * m, m, n0, a_at,
                                         conv2_epi);
    } else {
      sgc::tile_gemm<T, kRO, NC12, false>(
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
  for (int n0 = 0; n0 < co; n0 += kNC3) {
    if constexpr (HAS_D) {
      sgc::tile_gemm<T, kRO, kNC3, true>(
          smem, w3, m, co, n0, b2_at,
          [&](int r, int n, const auto& v) {
            constexpr int kV = sizeof(v) / sizeof(v[0]);
#pragma unroll
            for (int j = 0; j < kV; ++j) {
              c3[r * kLdc + n - n0 + j] =
                  sgc::affine(v[j], s3[n + j], s3[co + n + j]);
            }
          });
      sgc::tile_gemm<T, kRO, kNC3, false>(
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
      sgc::tile_gemm<T, kRO, kNC3, true>(
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

template <typename T, int TH, int TW, int S, bool HAS_D, int NC12>
cudaError_t launch(const void* x, const void* w1, const void* s1,
                   const void* w2, const void* s2, const void* w3,
                   const void* s3, const void* wd, const void* sd, void* y,
                   int b, int h, int w, int c, int m, int co,
                   cudaStream_t stream) {
  using Tl = Tile<T, TH, TW, S, NC12>;
  const size_t smem = Tl::smem_bytes(m, HAS_D);
  auto kern = bottleneck_kernel<T, TH, TW, S, HAS_D, NC12>;
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
// bottleneck_hopper: bfloat16, stride 1 (see the design note)
// ---------------------------------------------------------------------------

namespace hop {

constexpr int kThreads = 384;       // producer warpgroup + 2 consumer WGs
constexpr int kConsumerThreads = 256;
constexpr int kCluster = 2;         // blocks sharing each weight chunk
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// arrivals that free a ring slot: every consumer warp of both blocks
constexpr unsigned kEmptyArrivals = kCluster * kConsumerThreads / 32;
constexpr int kConsumerBar = 1;     // named barrier of the consumers
constexpr int kFirstConsumer = 128; // the thread that issues y's stores

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int align1k(int n) {
  return (n + 1023) / 1024 * 1024;
}

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
  static constexpr int kFree = 232448 - 1024 - SX * XB - ACT - 16 * 16;
  static constexpr int SW = kFree / WB < 8 ? kFree / WB : 8;
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
  const bf16* x;
  const float* s1;
  const float* s2;
  const float* s3;
  const float* sd;
  bf16* y;
  int h, w, c, co, tiles_x;
};

// A ring of N slots of `bytes` bytes in shared memory, each with a "full"
// and an "empty" mbarrier; i counts the slots walked so far (the producer
// and the consumers walk the same sequence).
template <int N>
struct Pipe {
  uint32_t slot0;
  uint32_t bytes;
  uint32_t bars;     // full[0..N), then empty[0..N)
  int i = 0;
  __device__ uint32_t slot(int s) const { return slot0 + s * bytes; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (N + s); }
  // producer: waits for the next slot to be free in both blocks of the
  // cluster, then expects `tx` bytes of copies into it
  __device__ int acquire(unsigned tx) {
    const int s = i % N;
    if (i >= N) {
      sgc::mbar_wait(empty(s), ((i / N) - 1) & 1);
    }
    sgc::mbar_expect_tx(full(s), tx);
    ++i;
    return s;
  }
  // consumers: waits for the next slot's copies to land
  __device__ int take() {
    const int s = i % N;
    sgc::mbar_wait(full(s), (i / N) & 1);
    ++i;
    return s;
  }
  // consumers, each warp once its reads of slot s are done: frees it for
  // both producers (either one writes into both blocks)
  __device__ void release(int s) const {
    if (threadIdx.x % 32 == 0) {
      sgc::mbar_arrive_cluster(empty(s), 0);
      sgc::mbar_arrive_cluster(empty(s), 1);
    }
  }
};

template <class C>
struct Rings {
  Pipe<C::SX> x;     // x's boxes
  Pipe<C::SW> w;     // weight chunks
};

// Two consecutive floats of a BN fold, through the read-only path (the
// folds and x are never written during the kernel, so these loads may be
// issued ahead of the epilogues' stores).
__device__ __forceinline__ float2 fold2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// ---- producer: one thread issues every copy, in the consumers' order ----

template <class C, bool HAS_D>
__device__ void produce(Rings<C> ring, const CUtensorMap* xh,
                        const CUtensorMap* xc, const CUtensorMap* w1m,
                        const CUtensorMap* w2m, const CUtensorMap* w3m,
                        const CUtensorMap* wdm, const Params& p, int bi,
                        int oy0, int ox0, unsigned rank) {
  // this block's half (by K rows) of W[k0 : k0 + KC, n0 : n0 + NP] into
  // the next weight slot, multicast: 64-column boxes of KC rows x 128
  // bytes, one after another
  auto load_w = [&](const CUtensorMap* map, int k0, int n0, int np,
                    int kc) {
    const int s = ring.w.acquire(kc * np * 2);
    for (int nb = 0; nb < np / 64; ++nb) {
      sgc::tma_load_2d_multicast(
          ring.w.slot(s) + (nb * kc + rank * (kc / 2)) * 128, map,
          ring.w.full(s), n0 + 64 * nb, k0 + rank * (kc / 2), 0x3);
    }
  };
  // x's box of 64 channels from channel c0 at (x0, y0) into the next x slot
  auto load_x = [&](const CUtensorMap* map, int c0, int x0, int y0,
                    int pixels) {
    const int s = ring.x.acquire(pixels * 128);
    sgc::tma_load_4d(ring.x.slot(s), map, ring.x.full(s), c0, x0, y0, bi);
  };
  const int nc = p.c / 64;
  for (int n0 = 0; n0 < C::M; n0 += C::NP1) {
    for (int k = 0; k < nc; ++k) {
      load_x(xh, 64 * k, ox0 - 1, oy0 - 1, C::NH);
      load_w(w1m, 64 * k, n0, C::NP1, 64);
    }
  }
  for (int k0 = 0; k0 < 9 * C::M; k0 += C::KC2) {
    load_w(w2m, k0, 0, C::M, C::KC2);
  }
  for (int n0 = 0; n0 < p.co; n0 += C::NP3) {
    for (int k0 = 0; k0 < C::M; k0 += 64) {
      load_w(w3m, k0, n0, C::NP3, 64);
    }
    if constexpr (HAS_D) {
      for (int k = 0; k < nc; ++k) {
        load_x(xc, 64 * k, ox0, oy0, C::OUT);
        load_w(wdm, 64 * k, n0, C::NP3, 64);
      }
    }
    // the pass's output staging, one x slot per 64 channels: filled with
    // the identity's x (C == CO), or empty beside the projection
    for (int c0 = n0; c0 < n0 + C::NP3; c0 += 64) {
      if constexpr (HAS_D) {
        ring.x.acquire(0);
      } else {
        load_x(xc, c0, ox0, oy0, C::OUT);
      }
    }
  }
}

// ---- consumers ----

// n weight chunks (and, with X, as many x boxes) into acc (RBW row blocks
// x NW columns a warpgroup): for chunk j and its 16-deep step kk,
// a_desc(sx, j, kk, r) is A's descriptor for row block r (sx: the chunk's
// x slot), and B is the chunk's weights from column `col0` on (MN-major,
// 64-column atoms of KC rows).  Each slot is released once the products
// that read it have completed.
template <int RBW, int NW, int KC, bool X, class C, class ADesc>
__device__ __forceinline__ void mainloop(float (&acc)[RBW][NW / 2],
                                         Rings<C>& ring, int n, int col0,
                                         ADesc a_desc) {
  int prev_w = -1, prev_x = -1;
  for (int j = 0; j < n; ++j) {
    const int sx = X ? ring.x.take() : 0;
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
      if (X) {
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

template <class C, bool HAS_D>
__device__ void consume(Rings<C>& ring, unsigned char* smem_base,
                        unsigned char* act, const CUtensorMap* ym,
                        const Params& p, int bi, int oy0, int ox0, int wg) {
  const uint32_t smem_s = sgc::smem_addr(smem_base);
  const uint32_t act_s = sgc::smem_addr(act);
  const int nc = p.c / 64;
  // the byte offset of (pixel r, channel n) in channel-planar act of
  // `rows` pixels
  auto planar = [](int rows, int r, int n) {
    return ((n >> 3) * rows + r) * 16 + (n & 7) * 2;
  };

  // 1. conv1 over the haloed pixels, A = x's box (swizzled, K-major)
  {
    using Sp = Split<C::RB1, C::NP1>;
    const int col0 = Sp::col0(wg);
    for (int n0 = 0; n0 < C::M; n0 += C::NP1) {
      float acc[Sp::RBW][Sp::NW / 2];
      mainloop<Sp::RBW, Sp::NW, 64, true>(
          acc, ring, nc, col0, [&](int sx, int, int kk, int r) {
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
  sgc::fence_proxy_async();
  sgc::named_sync(kConsumerBar, kConsumerThreads);

  // 3. conv3 (+ projection) and the identity, y written once
  {
    using Sp = Split<C::RB2, C::NP3>;
    const int col0 = Sp::col0(wg);
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
            accd, ring, nc, col0, [&](int sx, int, int kk, int r) {
              const int rb = Sp::rb(wg, r);
              const int row0 =     // the row block's first box row
                  8 * (rb / (C::TW / 8)) * C::TW + 8 * (rb % (C::TW / 8));
              return sgc::wgmma_desc(ring.x.slot(sx) + row0 * 128 + kk * 32,
                                     16, C::TW * 128, true);
            });
      }
      // y through the staging slots (TMA's swizzled box layout: pixel row
      // i TW + j of the tile, 64 channels), where the identity's x already
      // lies; then one thread stores the boxes with TMA (which drops what
      // lies outside the image) and frees the slots once they are read
      int stage[C::NP3 / 64];
#pragma unroll
      for (int h = 0; h < C::NP3 / 64; ++h) {
        stage[h] = ring.x.take();
      }
      each_pair<Sp::RBW, Sp::NW>([&](int r, int row, int col, int k) {
        const int rb = Sp::rb(wg, r);
        const int br = (8 * (rb / (C::TW / 8)) + row / 8) * C::TW +
                       8 * (rb % (C::TW / 8)) + row % 8;
        const int nl = col0 + col;           // the pass's channel
        const int ch = nl % 64;
        unsigned char* at =
            smem_base + (ring.x.slot(stage[nl / 64]) - smem_s) + br * 128 +
            (((ch / 8) ^ (br % 8)) * 16) + (ch % 8) * 2;
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
        *reinterpret_cast<unsigned*>(at) =
            pack2(fmaxf(sgc::affine(acc[r][k], sc.x, sh.x) + i0, 0.f),
                  fmaxf(sgc::affine(acc[r][k + 1], sc.y, sh.y) + i1, 0.f));
      });
      sgc::fence_proxy_async();     // the TMA store reads what was written
      sgc::named_sync(kConsumerBar, kConsumerThreads);
      if (threadIdx.x == kFirstConsumer) {
#pragma unroll
        for (int h = 0; h < C::NP3 / 64; ++h) {
          sgc::tma_store_4d(ym, ring.x.slot(stage[h]), n0 + 64 * h, ox0,
                            oy0, bi);
        }
        sgc::tma_store_wait_read();
#pragma unroll
        for (int h = 0; h < C::NP3 / 64; ++h) {
          for (unsigned rank = 0; rank < kCluster; ++rank) {
            sgc::mbar_arrive_cluster(ring.x.empty(stage[h]), rank,
                                     kConsumerThreads / 32);
          }
        }
      }
    }
  }
  if (threadIdx.x == kFirstConsumer) {
    sgc::tma_store_wait();
  }
}

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
  // 1024-byte alignment for the swizzled TMA boxes (the same offset in
  // both blocks of the cluster, as multicast needs)
  unsigned char* smem =
      smem_raw + (1024 - sgc::smem_addr(smem_raw) % 1024) % 1024;
  // x slots, weight slots, a (then b), the barriers
  const uint32_t base = sgc::smem_addr(smem);
  const uint32_t bars = base + C::SX * C::XB + C::SW * C::WB + C::ACT;
  Rings<C> ring;
  ring.x.slot0 = base;
  ring.x.bytes = C::XB;
  ring.x.bars = bars;
  ring.w.slot0 = base + C::SX * C::XB;
  ring.w.bytes = C::WB;
  ring.w.bars = bars + 16 * C::SX;
  unsigned char* act = smem + C::SX * C::XB + C::SW * C::WB;
  const unsigned rank = sgc::cluster_rank();
  const int bi = blockIdx.y;
  // tile t of the image; a block past the last tile (the partner of an
  // odd tile count) runs on zeros and stores nothing, so that it takes
  // part in every multicast and slot release of its cluster
  const int t = blockIdx.x;
  const int oy0 = (t / p.tiles_x) * C::TH;
  const int ox0 = (t % p.tiles_x) * C::TW;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::SX; ++s) {
      sgc::mbar_init(ring.x.full(s), 1);
      sgc::mbar_init(ring.x.empty(s), kEmptyArrivals);
    }
    for (int s = 0; s < C::SW; ++s) {
      sgc::mbar_init(ring.w.full(s), 1);
      sgc::mbar_init(ring.w.empty(s), kEmptyArrivals);
    }
    sgc::mbar_init_fence();
  }
  sgc::cluster_sync();
  if (threadIdx.x < 128) {
    sgc::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      produce<C, HAS_D>(ring, &xh, &xc, &w1m, &w2m, &w3m, &wdm, p, bi, oy0,
                        ox0, rank);
    }
  } else {
    sgc::regs_inc<kConsumerRegs>();
    consume<C, HAS_D>(ring, smem, act, &ym, p, bi, oy0, ox0,
                      threadIdx.x / 128 - 1);
  }
  // neither block leaves while its partner may still multicast into it or
  // arrive on its barriers
  sgc::cluster_sync();
}

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// entry-point query (so that the library needs no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A bfloat16 tensor map with TMA's 128-byte swizzle: dims innermost first,
// strides (bytes) of dims 1.., box extents.
CUresult tensor_map(CUtensorMap* map, const void* base, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    const cuuint32_t* box) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    return CUDA_ERROR_NOT_FOUND;
  }
  return encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A (K, N) row-major weight matrix in boxes of 64 columns x kc / 2 rows
// (each block of the cluster loads half of a chunk's rows).
CUresult weight_map(CUtensorMap* map, const void* w, int k, int n, int kc) {
  const cuuint64_t dims[2] = {cuuint64_t(n), cuuint64_t(k)};
  const cuuint64_t strides[1] = {cuuint64_t(n) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(kc / 2)};
  return tensor_map(map, w, 2, dims, strides, box);
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
  auto kern = bottleneck_hopper<C, HAS_D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) {
    return err;
  }
  const int tiles_x = (w + C::TW - 1) / C::TW;
  const int tiles = tiles_x * ((h + C::TH - 1) / C::TH);
  const Params p{static_cast<const bf16*>(x), static_cast<const float*>(s1),
                 static_cast<const float*>(s2), static_cast<const float*>(s3),
                 static_cast<const float*>(sd), static_cast<bf16*>(y),
                 h, w, c, co, tiles_x};
  cudaLaunchConfig_t cfg = {};
  // a whole number of clusters: an odd tile count gets a partner past it
  cfg.gridDim = dim3((tiles + kCluster - 1) / kCluster * kCluster, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, xh, xc, w1m, w2m, w3m, wdm, ym, p);
  if (err != cudaSuccess) {
    return err;
  }
  return cudaGetLastError();
}

// The plan of an M: {tile rows, tile columns, cluster size, weight-chunk
// slots, shared-memory bytes}.
template <int M, bool HAS_D>
void plan_of(int* out) {
  using C = typename CfgOf<M, HAS_D>::T;
  out[0] = C::TH;
  out[1] = C::TW;
  out[2] = kCluster;
  out[3] = C::SW;
  out[4] = C::SMEM;
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

}  // namespace hop

// The mma.sync template's tile of each case (see the design note):
// float32 4 x 4 (64 columns a pass); bfloat16 stride 2 4 x 8, 2 x 8 at
// M = 512, where a larger haloed a does not fit beside the two staging
// stages; conv1 and conv2 in passes of 256 columns at M = 512 and 128
// below (the 160-row conv1 would otherwise need 160 accumulators a
// thread), conv3 in passes of 256.  bfloat16 stride 1 goes to
// bottleneck_hopper.
cudaError_t dispatch(const void* x, const void* w1, const void* s1,
                     const void* w2, const void* s2, const void* w3,
                     const void* s3, const void* wd, const void* sd, void* y,
                     int b, int h, int w, int c, int m, int co, int stride,
                     int dtype, cudaStream_t st) {
  const bool has_d = wd != nullptr;
  if (dtype == 0) {
    if (stride == 2) {
      return launch<float, 4, 4, 2, true, 64>(SGC_BOTTLENECK_ARGS);
    }
    return has_d ? launch<float, 4, 4, 1, true, 64>(SGC_BOTTLENECK_ARGS)
                 : launch<float, 4, 4, 1, false, 64>(SGC_BOTTLENECK_ARGS);
  }
  if (stride == 2) {
    if (m > 256) {
      return launch<bf16, 2, 8, 2, true, 256>(SGC_BOTTLENECK_ARGS);
    }
    return launch<bf16, 4, 8, 2, true, 128>(SGC_BOTTLENECK_ARGS);
  }
  return hop::dispatch(x, w1, s1, w2, s2, w3, s3, wd, sd, y, b, h, w, c, m,
                       co, st);
}

#undef SGC_BOTTLENECK_ARGS

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// stride 1 or 2 (stride 2 needs wd/sd and even H and W); wd = sd = NULL
// for the identity (then C == CO).  The caller guarantees contiguous,
// 16-byte aligned tensors of the shapes above with C, M and CO multiples
// of 64 and B, H, W >= 1; bfloat16 at stride 1 takes M = 64, 128, 256 or
// 512 (cudaErrorInvalidValue otherwise).  Returns the cudaError_t of the
// launch.
extern "C" int sgc_bottleneck(const void* x, const void* w1, const void* s1,
                              const void* w2, const void* s2, const void* w3,
                              const void* s3, const void* wd, const void* sd,
                              void* y, int b, int h, int w, int c, int m,
                              int co, int stride, int dtype, int device,
                              void* stream) {
  cudaError_t err = sgc::use_device(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((stride != 1 && stride != 2) || (stride == 2 && wd == nullptr) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch(x, w1, s1, w2, s2, w3, s3, wd, sd, y, b,
                                   h, w, c, m, co, stride, dtype,
                                   static_cast<cudaStream_t>(stream)));
}

// The plan of the bfloat16 stride-1 kernel at M (with the projection when
// has_d is not 0): out = {tile rows, tile columns, cluster size, ring
// slots, shared-memory bytes}.  Returns cudaErrorInvalidValue for an M it
// does not take.
extern "C" int sgc_bottleneck_plan(int m, int has_d, int* out) {
#define SGC_PLAN(M)                                                  \
  case M:                                                            \
    has_d ? hop::plan_of<M, true>(out) : hop::plan_of<M, false>(out); \
    return 0;
  switch (m) {
    SGC_PLAN(64)
    SGC_PLAN(128)
    SGC_PLAN(256)
    SGC_PLAN(512)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SGC_PLAN
}
