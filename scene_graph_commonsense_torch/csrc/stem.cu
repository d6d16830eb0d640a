// The ResNet stem of the DETR-101 trunk.  Four kernels behind two plain C
// entry points for ctypes:
//
//   sgc_stem_conv_pool   out = cd(maxpool3x3/2(relu(BN(conv7x7/2(cd(img))))))
//                        bfloat16: stem_conv_pool_hopper; float32:
//                        stem_conv_pool_kernel<float>
//   sgc_stem_pool        out = cd(maxpool3x3/2(relu(BN(f32(conv_out)))))
//                        stem_pool_hopper<T>, or stem_pool_kernel<T> where
//                        TMA cannot read conv_out
//
// sgc_stem_conv_pool replaces `_conv_pool_kernel` of
// scene_graph_commonsense_tpu/ops/pallas/stem.py (through
// `stem_conv_pool`): img (B, H, W, 3) float32 NHWC with H and W divisible
// by 8; s (2, 64) float32 folded BN; out (B, H/4, W/4, 64) in the compute
// dtype.  The 7x7 stride-2 conv (pad 3) sums the products in float32; BN,
// ReLU and the 3x3 stride-2 max pool (pad 1, -inf) run in float32 on those
// sums, rounded once at the end.  Each pixel is rounded to the compute
// dtype as it is read: the JAX caller casts the images in a pass of its
// own; the numbers are the same and the pass is saved.
//
// Bound at the production shape (12 images at 1024^2, bf16 compute): 59.2
// GFLOP of useful products (0.060 ms at 989 TFLOP/s) against 252 MB moved
// (the float32 images read once, the (12, 256, 256, 64) output written
// once: 0.075 ms at 3.35 TB/s): bytes bound it.
//
// stem_conv_pool_hopper (bfloat16; w = ops/stem.py stem_kernel_weights) is
// the TPU kernel's own product on Hopper's wgmma.  The image is read as
// space-to-depth rows: s2d row u holds raw rows 2u and 2u + 1, cut into
// cells of 4 pixels, a cell's 24 values ordered (row a, pixel m, channel
// c).  Conv row cy at cell t (its columns 2t and 2t + 1) is then one
// (1 x 288) x (288 x 128) product: K = the 12 tap groups (du, cs), s2d row
// cy - 2 + du and cell t - 1 + cs, each of 24 values; N = 2 column parities
// x 64 channels (half the matrix is zero: 2x the useful products, 0.12 ms
// at peak).  The design:
//   * a warpgroup owns a band of kR pool rows of one image and walks it in
//     chunks of 64 cells (= 64 pool columns, the wgmma's M), left to right.
//     Per chunk it stages the 2 kR + 4 s2d rows x 66 cells (the halo cells
//     t - 1 and t + 64) in shared memory, from 16-byte loads of the float32
//     rows, each pixel rounded to bf16 once, zero outside the image (the
//     conv's padding).  A cell's 24 values go as three 8-value (16-byte)
//     chunks into three planes, cells 16 bytes apart: 8 consecutive cells
//     of a plane are one wgmma core matrix (K-major, no swizzle);
//   * a tap group (du, cs) is then a descriptor start du rows and cs cells
//     into a plane: a 16-byte aligned start, as bottleneck_hopper's conv2
//     taps shift theirs.  One k16 step pairs chunk j of group (d2, cs)
//     with that of (d2 + 2, cs), two rows further on (the descriptor's
//     K stride): 18 m64n128k16 steps per conv row of the chunk, no im2col;
//   * B, the 288 x 128 matrix regrouped by those steps (MN-major core
//     matrices), is loaded once per block and stays in shared memory
//     (72 KB), shared by the block's kWG warpgroups (a persistent grid of
//     one block per SM; bands dealt out round-robin);
//   * the epilogue pools in registers: each thread holds the same (cell,
//     channel) pairs in every conv row, and both column parities of a cell
//     (columns n and n + 64).  BN and ReLU per conv row, then the vertical
//     max over conv rows 2py - 1 .. 2py + 1 and the horizontal max over a
//     cell's two parities and the previous cell's odd parity (a lane
//     shuffle; across warps and chunks through shared memory).  Maxima are
//     kept in bf16: rounding is monotone, so it commutes with max and the
//     result is bit for bit that of a float32 max rounded once.  Conv row
//     -1 and the cell before column 0 are the pool's -inf padding.
// Partial bands, partial chunks and images smaller than one tile are
// masked (the stores check the pool row and column); every shape the
// wrapper takes runs here.
//
// stem_conv_pool_kernel<float> (float32, for the card-vs-CPU parity runs;
// w (147, 64) = the (7, 7, 3, 64) kernel's real taps): a block owns a 4 x 8
// tile of pool outputs and computes the 9 x 17 conv pixels its windows
// need: it stages the input patch they read in shared memory once, builds
// the im2col rows from it, multiplies through tile_gemm (float32 FMAs),
// keeps the post-ReLU conv tile in shared memory and pools it there.
//
// sgc_stem_pool replaces the TPU `_kernel` of the same file (through
// `stem_pool`), used where the image is even but not divisible by 8 (a
// model.image_size of 1020 or 900): conv_out (B, H, W, C) with H and W
// even, in the compute dtype; s (2, C); out (B, H/2, W/2, C).  BN is a
// multiply then an add, each rounded (__fmul_rn / __fadd_rn: no FMA
// contraction), so both kernels below equal the plain version exactly.
// Bound: bytes (read conv_out once, write out once: 0.149 ms at (12, 510,
// 510, 64) bf16, 0.298 ms in float32); the arithmetic, 3 operations an
// input element and 8 an output one, is far below the card's rate.
//
// stem_pool_hopper (where a pixel's channel row is a multiple of 16 bytes,
// TMA's stride rule, and both tensors are 16-byte aligned): a persistent
// grid (the blocks that fit on every SM) walks tiles of kPoolRows x
// kPoolCols pool outputs x one chunk of up to 128 bytes of channels of one
// image.  The tile's conv patch, (2 kPoolRows + 1) x (2 kPoolCols + 1)
// pixels x the chunk (9 x 33 x 128 bytes), comes into shared memory as one
// TMA box of a 4-D tensor map over (C, W, H, B), in a ring of kPoolStages
// slots on mbarriers: the next tile loads while this one is pooled, and the
// one-pixel halo a tile shares with its neighbours comes from L2.  The box
// starts one conv row and column before the tile (the pool's padding);
// TMA fills what lies outside the image with zeros, which the kernel sets
// to 0 after BN + ReLU: every window holds an element of the image and
// every ReLU output is >= 0, so a 0 there gives the max of the -inf
// padding.  Each thread owns one 16-byte vector of channels (8 in bf16, 4
// in float32) of a patch column, applies BN + ReLU once to each staged
// element, takes the 3-row max down the column and writes it back in place
// (pool row i into patch row i); then, after a block barrier, the 3-column
// max of those rows goes out in 16-byte stores.  Maxima are kept in the
// compute dtype: rounding is monotone, so it commutes with max.  All index
// arithmetic is 32-bit, from the tile number, with no division per element.
// stem_pool_kernel (the other shapes: a channel row that is not a multiple
// of 16 bytes, or a misaligned tensor): one thread per output element in a
// grid-stride loop, the 2.25x re-reads of overlapping windows from L1/L2.
// sgc_stem_pool chooses between them by that rule and reports its choice.

#include <cuda.h>

#include "hopper_pipe.cuh"
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

// ---------------------------------------------------------------------------
// stem_conv_pool_hopper (bfloat16)
// ---------------------------------------------------------------------------

constexpr int kR = 4;                        // pool rows per band
constexpr int kCells = 64;                   // cells per chunk (wgmma M)
constexpr int kWG = 3;                       // warpgroups per block
constexpr int kHopperThreads = 128 * kWG;
constexpr int kSteps = 18;                   // k16 steps per conv row
constexpr int kS2dRows = 2 * kR + 4;         // s2d rows they read
constexpr int kPatchCells = kCells + 2;      // + cells t - 1 and t + 64
constexpr int kRowBytes = kPatchCells * 16;  // one plane row
constexpr int kPlaneBytes = kS2dRows * kRowBytes;
constexpr int kPatchBytes = 3 * kPlaneBytes;
// the previous cell's odd parity across warps and chunks: [chunk parity]
// [warp][pool row][64 channels] in bf16
constexpr int kEdgeBytes = 2 * 4 * kR * kOut * 2;
constexpr int kWBytes = kSteps * 16 * 128 * 2;   // B, per step 16 x 128
constexpr int kFoldOff = kWBytes;
constexpr int kWGOff = kFoldOff + 2 * kOut * 4;
constexpr int kWGBytes = kPatchBytes + kEdgeBytes;
constexpr size_t kHopperSmem = size_t(kWGOff) + size_t(kWG) * kWGBytes;
// float4s of one raw row of a chunk's patch: 66 cells x 12 floats
constexpr int kRowF4 = kPatchCells * 3;
constexpr int kStageF4 = 2 * kS2dRows * kRowF4;
constexpr int kStageBatch = 8;               // loads in flight a thread
constexpr unsigned kNegInf2 = 0xff80ff80u;   // two bf16 -inf

static_assert(kWGOff % 128 == 0 && kWGBytes % 128 == 0, "alignment");
static_assert(kHopperSmem <= 232448, "shared memory of one block");

__device__ __forceinline__ unsigned max_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Stages chunk c0 of the band at pool row py0: s2d rows 2 py0 - 3 + sr
// (sr < kS2dRows), cells c0 - 1 + cc (cc < kPatchCells).  Float4 p (< 3)
// of raw row a of a cell holds values a * 12 + 4 p .. + 3, which land in
// plane (a * 12 + 4 p) / 8 at byte 2 ((a * 12 + 4 p) % 8) of the cell's
// 16 bytes.
__device__ __forceinline__ void stage_patch(unsigned char* patch,
                                            const float* __restrict__ ib,
                                            int h, int wi, int py0, int c0,
                                            int tid) {
  const int wp = wi / 4;
  for (int i0 = 0; i0 < kStageF4; i0 += 128 * kStageBatch) {
    float4 v[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int i = i0 + k * 128 + tid;
      const int rr = i / kRowF4;               // raw row of the patch
      const int f = i - rr * kRowF4;
      const int iy = 4 * py0 - 6 + rr;
      const int t = c0 - 1 + f / 3;
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < kStageF4 && iy >= 0 && iy < h && t >= 0 && t < wp) {
        v[k] = __ldg(reinterpret_cast<const float4*>(
            ib + (static_cast<size_t>(iy) * wi + 4 * t) * 3 + 4 * (f % 3)));
      }
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int i = i0 + k * 128 + tid;
      if (i < kStageF4) {
        const int rr = i / kRowF4;
        const int f = i - rr * kRowF4;
        const int val = (rr % 2) * 12 + 4 * (f % 3);
        *reinterpret_cast<uint2*>(patch + (val / 8) * kPlaneBytes +
                                  (rr / 2) * kRowBytes + (f / 3) * 16 +
                                  (val % 8) * 2) =
            make_uint2(pack_bf16x2(v[k].x, v[k].y),
                       pack_bf16x2(v[k].z, v[k].w));
      }
    }
  }
}

// One conv row of a chunk: acc = the 64 cells x 128 (parity, channel)
// products of patch row r (the conv row's s2d rows r .. r + 3).
__device__ __forceinline__ void conv_row(float (&acc)[64], uint32_t patch_s,
                                         uint32_t w_s, int r) {
  sgc::wgmma_fence();
#pragma unroll
  for (int d2 = 0; d2 < 2; ++d2) {
#pragma unroll
    for (int cs = 0; cs < 3; ++cs) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int s = (d2 * 3 + cs) * 3 + j;
        const uint64_t a = sgc::wgmma_desc(
            patch_s + j * kPlaneBytes + (r + d2) * kRowBytes + cs * 16,
            2 * kRowBytes, 128);
        const uint64_t b = sgc::wgmma_desc(w_s + s * 4096, 128, 256);
        sgc::wgmma_ss_m64n128k16(acc, a, b, s > 0);
      }
    }
  }
  sgc::wgmma_commit();
  sgc::wgmma_wait<0>();
  sgc::fence_acc(acc);
}

// A persistent grid: each warpgroup walks bands kWG * gridDim.x apart.
// Thread (warp w, lane = 4 g + t) holds cells 16 w + g and 16 w + g + 8
// of a chunk (hh = 0, 1), channels 8 j + 2 t and + 1 (j < 8) of both
// parities: acc[4 j + 2 hh + e] even, acc[4 (j + 8) + 2 hh + e] odd.
__global__ void __launch_bounds__(kHopperThreads, 1)
stem_conv_pool_hopper(const float* __restrict__ img,
                      const bf16* __restrict__ w,
                      const float* __restrict__ fold,
                      bf16* __restrict__ out, int b, int h, int wi) {
  extern __shared__ __align__(128) unsigned char smem[];
  {
    const uint4* src = reinterpret_cast<const uint4*>(w);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < kWBytes / 16; i += kHopperThreads) {
      dst[i] = src[i];
    }
    if (threadIdx.x < 2 * kOut) {
      reinterpret_cast<float*>(smem + kFoldOff)[threadIdx.x] =
          fold[threadIdx.x];
    }
  }
  sgc::fence_proxy_async();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bar = 1 + wg;                      // this warpgroup's barrier
  unsigned char* patch = smem + kWGOff + wg * kWGBytes;
  unsigned* edge = reinterpret_cast<unsigned*>(patch + kPatchBytes);
  const uint32_t patch_s = sgc::smem_addr(patch);
  const uint32_t w_s = sgc::smem_addr(smem);
  const float* fs = reinterpret_cast<const float*>(smem + kFoldOff);
  const int hp = h / 4;
  const int wp = wi / 4;
  const int bands_y = (hp + kR - 1) / kR;
  const int chunks = (wp + kCells - 1) / kCells;
  // edge word of (chunk parity, warp, pool row, channel pair)
  auto edge_at = [&](int par, int wr, int i, int j) -> unsigned& {
    return edge[((par * 4 + wr) * kR + i) * (kOut / 2) + 4 * j + t];
  };

  for (int band = blockIdx.x * kWG + wg; band < b * bands_y;
       band += gridDim.x * kWG) {
    const int bi = band / bands_y;
    const int py0 = (band - bi * bands_y) * kR;
    const int rows = min(kR, hp - py0);
    const float* ib = img + static_cast<size_t>(bi) * h * wi * 3;
    for (int c = 0; c < chunks; ++c) {
      const int c0 = c * kCells;
      // the previous chunk's products and edge reads are done
      sgc::named_sync(bar, 128);
      stage_patch(patch, ib, h, wi, py0, c0, tid);
      sgc::fence_proxy_async();
      sgc::named_sync(bar, 128);

      unsigned run[2][16];                     // vertical maxima, bf16x2
      for (int r = 0; r < 2 * rows + 1; ++r) {
        float acc[64];
        conv_row(acc, patch_s, w_s, r);
        unsigned cur[2][16];
        if (2 * py0 - 1 + r < 0) {             // conv row -1: -inf
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              cur[hh][j] = kNegInf2;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int ch = 8 * (j % 8) + 2 * t;
            const float2 sc = *reinterpret_cast<const float2*>(fs + ch);
            const float2 sh =
                *reinterpret_cast<const float2*>(fs + kOut + ch);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float* a = acc + 4 * j + 2 * hh;
              cur[hh][j] =
                  pack_bf16x2(fmaxf(sgc::affine(a[0], sc.x, sh.x), 0.f),
                              fmaxf(sgc::affine(a[1], sc.y, sh.y), 0.f));
            }
          }
        }
        if (r == 0) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              run[hh][j] = cur[hh][j];
            }
          }
          continue;
        }
        if (r % 2 == 1) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              run[hh][j] = max_bf16x2(run[hh][j], cur[hh][j]);
            }
          }
          continue;
        }
        // r = 2 i + 2 closes pool row i (conv rows 2 i .. 2 i + 2) and
        // opens row i + 1
        const int i = r / 2 - 1;
        unsigned pool[2][8];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const unsigned m = max_bf16x2(run[hh][j], cur[hh][j]);
            run[hh][j] = cur[hh][j];
            cur[hh][j] = m;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            pool[hh][j] = max_bf16x2(cur[hh][j], cur[hh][j + 8]);
          }
        }
        // the odd parity of cell 16 w + 15 for warp w + 1 (warp 3's for
        // the next chunk)
        if (g == 7) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            edge_at(c % 2, warp, i, j) = cur[1][j + 8];
          }
        }
        sgc::named_sync(bar, 128);
        const int src = (lane + 28) % 32;        // lane (g - 1) mod 8, t
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned x0 = __shfl_sync(0xffffffffu, cur[0][j + 8], src);
          const unsigned x1 = __shfl_sync(0xffffffffu, cur[1][j + 8], src);
          // cell 16 w + g + 8 follows 16 w + g + 7: lane g - 1's second
          // cell, or for g = 0 lane 7's first
          const unsigned prev1 = g > 0 ? x1 : x0;
          unsigned prev0 = x0;
          if (g == 0) {
            prev0 = warp > 0    ? edge_at(c % 2, warp - 1, i, j)
                    : c > 0     ? edge_at((c + 1) % 2, 3, i, j)
                                : kNegInf2;   // the pool's left padding
          }
          pool[0][j] = max_bf16x2(pool[0][j], prev0);
          pool[1][j] = max_bf16x2(pool[1][j], prev1);
        }
        const size_t orow = static_cast<size_t>(bi) * hp + py0 + i;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int px = c0 + 16 * warp + g + 8 * hh;
          if (px < wp) {
            unsigned* o = reinterpret_cast<unsigned*>(
                out + (orow * wp + px) * kOut + 2 * t);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              o[4 * j] = pool[hh][j];
            }
          }
        }
      }
    }
  }
}

cudaError_t launch_conv_pool_hopper(const void* img, const void* w,
                                    const void* s, void* out, int b, int h,
                                    int wi, int device, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_pool_hopper, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kHopperSmem));
  if (err != cudaSuccess) {
    return err;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) {
    return err;
  }
  const int bands = b * ((h / 4 + kR - 1) / kR);
  const int want = (bands + kWG - 1) / kWG;
  const int blocks = want < sms ? want : sms;
  stem_conv_pool_hopper<<<blocks, kHopperThreads, kHopperSmem, stream>>>(
      static_cast<const float*>(img), static_cast<const bf16*>(w),
      static_cast<const float*>(s), static_cast<bf16*>(out), b, h, wi);
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

// ---------------------------------------------------------------------------
// stem_pool_hopper
// ---------------------------------------------------------------------------

constexpr int kPoolRows = 4;                       // pool rows of a tile
constexpr int kPoolCols = 16;                      // pool columns of a tile
constexpr int kPoolStages = 2;                     // slots of the TMA ring
constexpr int kPoolThreads = 256;
constexpr int kPatchRows = 2 * kPoolRows + 1;      // conv rows a tile reads
constexpr int kPatchCols = 2 * kPoolCols + 1;
constexpr int kChunkBytes = 128;                   // channels of a tile
constexpr int kSlotBytes = kPatchRows * kPatchCols * kChunkBytes;
// the slots, 128-byte aligned, then their mbarriers
constexpr size_t kPoolSmem = size_t(kPoolStages) * kSlotBytes +
                             8 * kPoolStages + 128;

static_assert(kSlotBytes % 128 == 0, "TMA destinations 128-byte aligned");

// 16 bytes of channels in registers: unpacked to float32, packed back with
// one rounding, and the elementwise max in the compute dtype.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(uint4 v, float (&f)[kN]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static uint4 max(uint4 a, uint4 b) {
    return make_uint4(
        __float_as_uint(fmaxf(__uint_as_float(a.x), __uint_as_float(b.x))),
        __float_as_uint(fmaxf(__uint_as_float(a.y), __uint_as_float(b.y))),
        __float_as_uint(fmaxf(__uint_as_float(a.z), __uint_as_float(b.z))),
        __float_as_uint(fmaxf(__uint_as_float(a.w), __uint_as_float(b.w))));
  }
};

template <>
struct Vec16<bf16> {
  static constexpr int kN = 8;
  __device__ static void unpack(uint4 v, float (&f)[kN]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                      pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
  __device__ static uint4 max(uint4 a, uint4 b) {
    return make_uint4(max_bf16x2(a.x, b.x), max_bf16x2(a.y, b.y),
                      max_bf16x2(a.z, b.z), max_bf16x2(a.w, b.w));
  }
};

// The launch's shapes: conv_out (B, h, w, c), out (B, ho, wo, c); cc
// channels a tile (its box), vp 16-byte vectors of them, chunks of them a
// pixel; tiles in the order (image, tile row, tile column, chunk), the
// chunk fastest, so that the tiles in flight at once are neighbours.
struct PoolGeom {
  int h, w, c, ho, wo, cc, vp, chunks, tiles_x, tiles_y, tiles;
};

struct PoolTile {
  int bi, py0, px0, chunk;
};

__device__ __forceinline__ PoolTile pool_tile(int tile, const PoolGeom& g) {
  PoolTile t;
  t.chunk = tile % g.chunks;
  int rest = tile / g.chunks;
  const int tx = rest % g.tiles_x;
  rest /= g.tiles_x;
  const int ty = rest % g.tiles_y;
  t.bi = rest / g.tiles_y;
  t.py0 = ty * kPoolRows;
  t.px0 = tx * kPoolCols;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
stem_pool_hopper(const __grid_constant__ CUtensorMap xm,
                 const float* __restrict__ s, T* __restrict__ out,
                 const PoolGeom g) {
  using V = Vec16<T>;
  constexpr int kE = V::kN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (128 - sgc::smem_addr(smem_raw) % 128) % 128;
  const uint32_t slot0 = sgc::smem_addr(smem);
  const uint32_t bars = slot0 + kPoolStages * kSlotBytes;
  const unsigned tx_bytes = kPatchRows * kPatchCols * g.vp * 16;
  // one thread loads a tile's patch: its box starts a conv row and column
  // before the tile's windows (negative coordinates read as zeros)
  auto issue = [&](int tile, int st) {
    const PoolTile t = pool_tile(tile, g);
    sgc::mbar_expect_tx(bars + 8 * st, tx_bytes);
    sgc::tma_load_4d(slot0 + st * kSlotBytes, &xm, bars + 8 * st,
                     t.chunk * g.cc, 2 * t.px0 - 1, 2 * t.py0 - 1, t.bi);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kPoolStages; ++st) {
      sgc::mbar_init(bars + 8 * st, 1);
    }
    sgc::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int st = 0; st < kPoolStages; ++st) {
      const int tile = blockIdx.x + st * gridDim.x;
      if (tile < g.tiles) {
        issue(tile, st);
      }
    }
  }

  // thread = (pixel p0, vector v); `per` pixels a pass at once, the threads
  // past per * vp idle
  const int per = kPoolThreads / g.vp;
  const int v = threadIdx.x % g.vp;
  const int p0 = threadIdx.x / g.vp;
  const bool active = p0 < per;
  const int rs = kPatchCols * g.vp;                 // vectors a patch row
  float sc[kE], sh[kE];
  int chunk_loaded = -1;
  int k = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x, ++k) {
    const int st = k % kPoolStages;
    const PoolTile t = pool_tile(tile, g);
    const int ch = t.chunk * g.cc + v * kE;         // this thread's channels
    if (t.chunk != chunk_loaded) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        sc[e] = ch + e < g.c ? __ldg(s + ch + e) : 0.f;
        sh[e] = ch + e < g.c ? __ldg(s + g.c + ch + e) : 0.f;
      }
      chunk_loaded = t.chunk;
    }
    const int rows = min(kPoolRows, g.ho - t.py0);
    const int cols = min(kPoolCols, g.wo - t.px0);
    uint4* slot = reinterpret_cast<uint4*>(smem + st * kSlotBytes);
    sgc::mbar_wait(bars + 8 * st, (k / kPoolStages) & 1);

    // BN + ReLU once per staged element, 0 outside the image, and the
    // 3-row max down each patch column, written over patch row i
    if (active) {
      for (int x = p0; x < 2 * cols + 1; x += per) {
        const int gx = 2 * t.px0 - 1 + x;
        const bool col_in = static_cast<unsigned>(gx) <
                            static_cast<unsigned>(g.w);
        uint4* col = slot + x * g.vp + v;
        uint4 run = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int r = 0; r < kPatchRows; ++r) {
          if (r > 2 * rows) {
            break;
          }
          const int gy = 2 * t.py0 - 1 + r;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (col_in && static_cast<unsigned>(gy) <
                            static_cast<unsigned>(g.h)) {
            float f[kE];
            V::unpack(col[r * rs], f);
#pragma unroll
            for (int e = 0; e < kE; ++e) {
              f[e] = fmaxf(sgc::affine(f[e], sc[e], sh[e]), 0.f);
            }
            val = V::pack(f);
          }
          if (r == 0) {
            run = val;
          } else if (r % 2 == 1) {
            run = V::max(run, val);
          } else {                          // r = 2 i + 2 closes pool row i
            col[(r / 2 - 1) * rs] = V::max(run, val);
            run = val;
          }
        }
      }
    }
    __syncthreads();
    // the 3-column max of the row maxima, 16 bytes a store
    if (active && ch < g.c) {
      for (int p = p0; p < rows * kPoolCols; p += per) {
        const int i = p / kPoolCols;
        const int j = p % kPoolCols;
        if (j < cols) {
          const uint4* m = slot + (i * kPatchCols + 2 * j) * g.vp + v;
          const size_t o = (static_cast<size_t>(t.bi) * g.ho + t.py0 + i) *
                               g.wo + t.px0 + j;
          *reinterpret_cast<uint4*>(out + o * g.c + ch) =
              V::max(V::max(m[0], m[g.vp]), m[2 * g.vp]);
        }
      }
    }
    // the slot's reads and writes come before the TMA that refills it
    sgc::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int next = tile + kPoolStages * gridDim.x;
      if (next < g.tiles) {
        issue(next, st);
      }
    }
  }
}

template <typename T>
cudaError_t launch_pool_hopper(const void* x, const void* s, void* out,
                               int b, int h, int w, int c, int device,
                               cudaStream_t stream) {
  constexpr int es = sizeof(T);
  PoolGeom g;
  g.h = h;
  g.w = w;
  g.c = c;
  g.ho = h / 2;
  g.wo = w / 2;
  g.cc = c < kChunkBytes / es ? c : kChunkBytes / es;
  g.vp = g.cc * es / 16;
  g.chunks = (c + g.cc - 1) / g.cc;
  g.tiles_x = (g.wo + kPoolCols - 1) / kPoolCols;
  g.tiles_y = (g.ho + kPoolRows - 1) / kPoolRows;
  const long long tiles =
      static_cast<long long>(b) * g.tiles_y * g.tiles_x * g.chunks;
  if (tiles > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  g.tiles = static_cast<int>(tiles);
  CUtensorMap xm;
  const cuuint64_t dims[4] = {cuuint64_t(c), cuuint64_t(w), cuuint64_t(h),
                              cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(c) * es,
                                 cuuint64_t(w) * c * es,
                                 cuuint64_t(h) * w * c * es};
  const cuuint32_t box[4] = {cuuint32_t(g.cc), kPatchCols, kPatchRows, 1};
  if (sgc::hop::tensor_map(&xm, x, 4, dims, strides, box,
                           es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                           CU_TENSOR_MAP_SWIZZLE_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  auto kern = stem_pool_hopper<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kPoolSmem));
  if (err != cudaSuccess) {
    return err;
  }
  int sms = 0;
  int per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kPoolThreads, kPoolSmem);
  }
  if (err != cudaSuccess) {
    return err;
  }
  const int want = sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = g.tiles < want ? g.tiles : want;
  kern<<<blocks, kPoolThreads, kPoolSmem, stream>>>(
      xm, static_cast<const float*>(s), static_cast<T*>(out), g);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  dtype (the compute dtype of w, x and
// out): 0 = float32, 1 = bfloat16.  The caller guarantees contiguous,
// 16-byte aligned tensors of the shapes above (stem_conv_pool: H, W
// divisible by 8, w (147, 64) in float32 or stem_kernel_weights' 73,728
// bytes in bfloat16; stem_pool: H, W even, C >= 1) and B >= 1.  Each
// returns the cudaError_t of its launch; sgc_stem_pool writes the kernel it
// chose into *kernel (host memory).
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
          launch_conv_pool_hopper(img, w, s, out, b, h, wi, device, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int sgc_stem_pool(const void* x, const void* s, void* out, int b,
                             int h, int w, int c, int dtype, int device,
                             void* stream, int* kernel) {
  cudaError_t err = sgc::use_device(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (dtype != 0 && dtype != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // stem_pool_hopper where TMA can read the tensor (a pixel's channels a
  // multiple of 16 bytes, 16-byte aligned tensors), else stem_pool_kernel;
  // *kernel = 1 for the first, 0 for the second
  const int es = dtype == 0 ? 4 : 2;
  const bool tma = (c * es) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  *kernel = tma ? 1 : 0;
  if (tma) {
    return static_cast<int>(
        dtype == 0
            ? launch_pool_hopper<float>(x, s, out, b, h, w, c, device, st)
            : launch_pool_hopper<bf16>(x, s, out, b, h, w, c, device, st));
  }
  return static_cast<int>(
      dtype == 0 ? launch_pool<float>(x, s, out, b, h, w, c, st)
                 : launch_pool<bf16>(x, s, out, b, h, w, c, st));
}
