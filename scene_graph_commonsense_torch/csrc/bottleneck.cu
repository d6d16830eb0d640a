// Fused frozen ResNet bottleneck blocks of the DETR-101 trunk.  One kernel
// template with a plain C entry point for ctypes:
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
// Hopper block has.  So a block owns an output tile of TH x TW pixels of
// one image and streams the weights through shared memory in K chunks
// from L2 (a block's weights fit the 50 MB L2, so every tile of a launch
// rereads them from there, not from device memory):
//   1. conv1 over the tile's haloed input pixels ((TH-1)s+3 x (TW-1)s+3:
//      the conv2 halo), x read straight from device memory, a kept in
//      shared memory in the compute dtype, zero outside the image;
//   2. conv2 as one product with K = 9 M, each K chunk a tap's shifted
//      rows of a, which ldmatrix reads in place (stride 1) or from a copy
//      (stride 2, whose rows two pixels apart would clash on the banks);
//      b kept in shared memory too;
//   3. conv3 (and the projection) in column passes, b read in place, the
//      epilogue adding the identity read from x and writing y once
//      (16-byte vectors).
// x is read once per tile plus the halo (56% extra conv1 work at 8 x 8 and
// stride 1, 13% of a layer3 block's products), y written once: the
// activations make one round trip instead of the unfused trunk's ~8
// passes.  The products go through tile_gemm (csrc/tile_gemm.cuh):
// mma.sync on the tensor cores for bfloat16 (K chunks of 64, two cp.async
// stages, up to 256 output columns a pass so that each fragment loaded
// from shared memory feeds more products), float32 FMAs for float32.
// Tiles, the largest whose haloed a, b and staging fit one block's shared
// memory: bfloat16 8 x 8 at stride 1 (100 haloed pixels; 197 KB at
// M = 256), 4 x 8 at M = 512 (60 haloed pixels, 192 KB); 4 x 8 at stride 2
// (153 haloed pixels, 222 KB at M = 256), 2 x 8 at M = 512 (85, 211 KB);
// float32 4 x 4 (a in float32 takes twice the room).  One block per SM
// (a 4 x 8 layer3 tile that fits two was slower: twice the weight traffic
// per product).  This version runs at 7-16x its bound; shared-memory
// traffic (fragment loads and the cp.async stream of the weight chunks)
// rather than the tensor cores sets its pace, and wgmma with TMA-fed,
// cluster-shared weight chunks is the next step.

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

// The tile of each case (see the design note): float32 4 x 4 (64 columns a
// pass); bfloat16 8 x 8 at stride 1 and 4 x 8 at stride 2, halved at
// M = 512 (4 x 8 and 2 x 8), where a larger haloed a does not fit beside
// the two staging stages; conv1 and conv2 in passes of min(M, 256)
// columns (128 for the stride-2 M = 256 tile, whose 160-row conv1 would
// otherwise need 160 accumulators a thread), conv3 in passes of 256.
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
  if (m % 128) {
    return has_d ? launch<bf16, 8, 8, 1, true, 64>(SGC_BOTTLENECK_ARGS)
                 : launch<bf16, 8, 8, 1, false, 64>(SGC_BOTTLENECK_ARGS);
  }
  if (m > 256) {
    return has_d ? launch<bf16, 4, 8, 1, true, 256>(SGC_BOTTLENECK_ARGS)
                 : launch<bf16, 4, 8, 1, false, 256>(SGC_BOTTLENECK_ARGS);
  }
  if (m == 256) {
    return has_d ? launch<bf16, 8, 8, 1, true, 256>(SGC_BOTTLENECK_ARGS)
                 : launch<bf16, 8, 8, 1, false, 256>(SGC_BOTTLENECK_ARGS);
  }
  return has_d ? launch<bf16, 8, 8, 1, true, 128>(SGC_BOTTLENECK_ARGS)
               : launch<bf16, 8, 8, 1, false, 128>(SGC_BOTTLENECK_ARGS);
}

#undef SGC_BOTTLENECK_ARGS

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// stride 1 or 2 (stride 2 needs wd/sd and even H and W); wd = sd = NULL
// for the identity (then C == CO).  The caller guarantees contiguous,
// 16-byte aligned tensors of the shapes above with C, M and CO multiples
// of 64 and B, H, W >= 1.  Returns the cudaError_t of the launch.
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
