// The ResNet stem of the DETR-101 trunk.  Two kernels with plain C entry
// points for ctypes:
//
//   sgc_stem_conv_pool   out = cd(maxpool3x3/2(relu(BN(conv7x7/2(cd(img))))))
//   sgc_stem_pool        out = cd(maxpool3x3/2(relu(BN(f32(conv_out)))))
//
// sgc_stem_conv_pool replaces `_conv_pool_kernel` of
// scene_graph_commonsense_tpu/ops/pallas/stem.py (through
// `stem_conv_pool`): img (B, H, W, 3) float32 NHWC with H and W divisible
// by 8; w (147, 64) = the (7, 7, 3, 64) kernel's real taps, in the compute
// dtype (float32 or bfloat16); s (2, 64) float32 folded BN; out
// (B, H/4, W/4, 64) in the compute dtype.  The 7x7 stride-2 conv (pad 3)
// sums the products in float32; BN, ReLU and the 3x3 stride-2 max pool
// (pad 1, -inf) run in float32 on those sums, rounded once at the end.
// Each pixel is rounded to the compute dtype as it is read: the JAX caller
// casts the images in a pass of its own; the numbers are the same and the
// pass is saved.  The TPU kernel's (288, 128) permuted weight matrix is a
// lane trick of its matrix unit; this kernel takes the 147 taps (K padded
// to 160 with zeros inside the block only).
//
// Bound at the production shape (12 images at 1024^2, bf16 compute): 59.2
// GFLOP of products (0.060 ms at 989 TFLOP/s) against 252 MB moved (the
// float32 images read once, the (12, 256, 256, 64) output written once:
// 0.075 ms at 3.35 TB/s): bytes bound it.  Design: a block owns a tile of
// pool outputs (2 x 8 in bfloat16, 4 x 8 in float32) and computes the conv
// pixels its windows need (5 x 17 or 9 x 17): it stages the input patch
// they read in shared memory once (each pixel rounded there), builds the
// im2col rows from it, multiplies through tile_gemm (WMMA for bfloat16,
// FMAs for float32), keeps the float32 post-ReLU conv tile in shared
// memory and pools it there: the (B, H/2, W/2, 64) conv output never
// reaches device memory.  Neighbouring tiles recompute the conv row and
// column they share (85 conv pixels per 64 needed in bfloat16, where the
// smaller tile lets two blocks share an SM).
//
// sgc_stem_pool replaces the TPU `_kernel` of the same file (through
// `stem_pool`), used where the image is even but not divisible by 8:
// conv_out (B, H, W, C) with H and W even, in the compute dtype; s (2, C);
// out (B, H/2, W/2, C).  BN is a multiply then an add, each rounded
// (__fmul_rn / __fadd_rn: no FMA contraction), so the kernel equals the
// plain version exactly.  Bound: bytes (read conv_out once, write out
// once: 0.149 ms at (12, 510, 510, 64) bf16).  One thread per output
// element; the 2.25x re-reads of overlapping windows hit L1/L2.

#include "tile_gemm.cuh"

namespace {

using sgc::bf16;
using sgc::kThreads;

constexpr int kTaps = 147;      // 7 x 7 x 3
constexpr int kOut = 64;        // stem channels

template <typename T, int PH, int PW>
struct StemTile {
  static constexpr int kCH = 2 * PH + 1;        // conv rows a tile pools
  static constexpr int kCW = 2 * PW + 1;
  static constexpr int kNC = kCH * kCW;
  static constexpr int kRA = sgc::round16(kNC);
  static constexpr int kLdc = kOut + 4;
  // the input pixels the tile's conv pixels read: rows 2 cy - 3 .. 2 cy + 3
  static constexpr int kPH = 2 * kCH + 5;
  static constexpr int kPW = 2 * kCW + 5;
  static constexpr size_t kConvOff =
      sgc::align128(sgc::gemm_smem_bytes<T, kOut>(kRA));
  static constexpr size_t kPatchOff =
      kConvOff + sgc::align128(size_t(kNC) * kLdc * 4);
  static constexpr size_t kSmem = kPatchOff + size_t(kPH) * kPW * 3 *
                                  sizeof(T);
};

template <typename T, int PH, int PW>
__global__ void __launch_bounds__(kThreads, 1)
stem_conv_pool_kernel(const float* __restrict__ img, const T* __restrict__ w,
                      const float* __restrict__ s, T* __restrict__ out,
                      int h, int wi, int tiles_x) {
  using Tl = StemTile<T, PH, PW>;
  constexpr int kCW = Tl::kCW;
  constexpr int kNC = Tl::kNC;
  constexpr int kRA = Tl::kRA;
  constexpr int kLdc = Tl::kLdc;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kPH = Tl::kPH;
  constexpr int kPW = Tl::kPW;
  float* conv = reinterpret_cast<float*>(smem + Tl::kConvOff);
  T* patch = reinterpret_cast<T*>(smem + Tl::kPatchOff);
  const int hc = h / 2;
  const int wc = wi / 2;
  const int hp = h / 4;
  const int wp = wi / 4;
  const int bi = blockIdx.y;
  const int ty = blockIdx.x / tiles_x;
  const int py0 = ty * PH;
  const int px0 = (blockIdx.x - ty * tiles_x) * PW;
  const int cy0 = 2 * py0 - 1;                  // conv tile origin
  const int cx0 = 2 * px0 - 1;
  const float* ib = img + static_cast<size_t>(bi) * h * wi * 3;
  auto in_conv = [&](int r) {
    const int cy = cy0 + r / kCW;
    const int cx = cx0 + r % kCW;
    return r < kNC && cy >= 0 && cy < hc && cx >= 0 && cx < wc;
  };
  // the input patch, each pixel rounded to the compute dtype once; zero
  // outside the image (the conv's padding)
  const int py_in = 2 * cy0 - 3;
  const int px_in = 2 * cx0 - 3;
  for (int i = threadIdx.x; i < kPH * kPW * 3; i += kThreads) {
    const int row = i / (kPW * 3);
    const int col = i - row * (kPW * 3);
    const int iy = py_in + row;
    const int ix = px_in + col / 3;
    float v = 0.f;
    if (iy >= 0 && iy < h && ix >= 0 && ix < wi) {
      v = ib[(static_cast<size_t>(iy) * wi + px_in) * 3 + col];
    }
    patch[i] = sgc::to_t<T>(v);
  }
  // tile_gemm's first barrier publishes the patch to the im2col loader

  sgc::tile_gemm<T, kRA, kOut, false>(
      smem, w, kTaps, kOut, 0,
      [&](int k0, T* sa) {
        // im2col from the patch: row r = conv pixel (i, j) of the tile,
        // column k = (ky * 7 + kx) * 3 + c = patch pixel (2 i + ky,
        // 2 j + kx), channel c; zero past the 147 taps and for conv
        // pixels outside the conv output
        for (int e = threadIdx.x; e < kRA * sgc::kc<T>(); e += kThreads) {
          const int r = e / sgc::kc<T>();
          const int kk = e - r * sgc::kc<T>();
          const int k = k0 + kk;
          T v = sgc::to_t<T>(0.f);
          if (k < kTaps && in_conv(r)) {
            const int tap = k / 3;
            const int ky = tap / 7;
            const int i = r / kCW;
            v = patch[((2 * i + ky) * kPW + 2 * (r - i * kCW) + tap - 7 * ky)
                      * 3 + k - 3 * tap];
          }
          sa[r * sgc::lda<T>() + kk] = v;
        }
      },
      [&](int r, int n, const auto& v) {
        constexpr int kV = sizeof(v) / sizeof(v[0]);
        if (r < kNC) {
          const bool inside = in_conv(r);
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            conv[r * kLdc + n + j] =
                inside ? fmaxf(sgc::affine(v[j], s[n + j], s[kOut + n + j]),
                               0.f)
                       : -INFINITY;             // the pool's padding
          }
        }
      });
  __syncthreads();

  for (int i = threadIdx.x; i < PH * PW * kOut; i += kThreads) {
    const int p = i / kOut;
    const int ch = i - p * kOut;
    const int pi = p / PW;
    const int pj = p - pi * PW;
    const int py = py0 + pi;
    const int px = px0 + pj;
    if (py < hp && px < wp) {
      float mx = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          mx = fmaxf(mx, conv[((2 * pi + dy) * kCW + 2 * pj + dx) * kLdc +
                              ch]);
        }
      }
      out[((static_cast<size_t>(bi) * hp + py) * wp + px) * kOut + ch] =
          sgc::to_t<T>(mx);
    }
  }
}

template <typename T, int PH, int PW>
cudaError_t launch_conv_pool(const void* img, const void* w, const void* s,
                             void* out, int b, int h, int wi,
                             cudaStream_t stream) {
  using Tl = StemTile<T, PH, PW>;
  auto kern = stem_conv_pool_kernel<T, PH, PW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tl::kSmem));
  if (err != cudaSuccess) {
    return err;
  }
  const int tiles_x = (wi / 4 + PW - 1) / PW;
  const int tiles_y = (h / 4 + PH - 1) / PH;
  dim3 grid(tiles_x * tiles_y, b);
  kern<<<grid, kThreads, Tl::kSmem, stream>>>(
      static_cast<const float*>(img), static_cast<const T*>(w),
      static_cast<const float*>(s), static_cast<T*>(out), h, wi, tiles_x);
  return cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_pool_kernel(const T* __restrict__ x, const float* __restrict__ s,
                 T* __restrict__ out, int b, int h, int w, int c) {
  const int ho = h / 2;
  const int wo = w / 2;
  const size_t total = static_cast<size_t>(b) * ho * wo * c;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(i % c);
    size_t rest = i / c;
    const int v = static_cast<int>(rest % wo);
    rest /= wo;
    const int u = static_cast<int>(rest % ho);
    const size_t bi = rest / ho;
    const float scale = s[ch];
    const float shift = s[c + ch];
    float mx = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int iy = 2 * u - 1 + dy;
      if (iy < 0 || iy >= h) {
        continue;
      }
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ix = 2 * v - 1 + dx;
        if (ix < 0 || ix >= w) {
          continue;
        }
        const float xv =
            sgc::to_f(x[((bi * h + iy) * w + ix) * c + ch]);
        mx = fmaxf(mx, fmaxf(sgc::affine(xv, scale, shift), 0.f));
      }
    }
    out[i] = sgc::to_t<T>(mx);
  }
}

template <typename T>
cudaError_t launch_pool(const void* x, const void* s, void* out, int b,
                        int h, int w, int c, cudaStream_t stream) {
  const size_t total = static_cast<size_t>(b) * (h / 2) * (w / 2) * c;
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  stem_pool_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<T*>(out), b, h, w, c);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  dtype (the compute dtype of w, x and
// out): 0 = float32, 1 = bfloat16.  The caller guarantees contiguous,
// 16-byte aligned tensors of the shapes above (stem_conv_pool: H, W
// divisible by 8; stem_pool: H, W even, C >= 1) and B >= 1.  Each returns
// the cudaError_t of its launch.
extern "C" int sgc_stem_conv_pool(const void* img, const void* w,
                                  const void* s, void* out, int b, int h,
                                  int wi, int dtype, int device,
                                  void* stream) {
  cudaError_t err = sgc::use_device(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_conv_pool<float, 4, 8>(img, w, s, out, b, h, wi, st));
    case 1:
      return static_cast<int>(
          launch_conv_pool<bf16, 2, 8>(img, w, s, out, b, h, wi, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int sgc_stem_pool(const void* x, const void* s, void* out, int b,
                             int h, int w, int c, int dtype, int device,
                             void* stream) {
  cudaError_t err = sgc::use_device(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_pool<float>(x, s, out, b, h, w, c, st));
    case 1:
      return static_cast<int>(launch_pool<bf16>(x, s, out, b, h, w, c, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
