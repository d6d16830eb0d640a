// Fused pair assembly for the relation trunk:
//
//   out[p, y, x, c] = relu(max_{dy,dx in {0,1}} (a[si[p], 2y+dy, 2x+dx, c]
//                                               + b[oj[p], 2y+dy, 2x+dx, c]))
//
// a, b: contiguous NHWC (M, S, S, C) subject / object streams; si, oj: (P,)
// int32 object indices; out: (P, S/2, S/2, C) in the input dtype.
//
// Replaces the TPU kernel `_kernel` of
// scene_graph_commonsense_tpu/ops/pallas/pair_pool.py (reached through
// `fused_pair_pool(..., with_idx=False)`).  That kernel reads the streams in a
// (M, 4, S/2, S/2, C) pool-group layout only because Mosaic cannot stride the
// sublane axis; here each thread reads NHWC directly.
//
// Bound: device-memory bytes.  It does 8 operations per output element
// (4 adds, 3 maxes, 1 relu) against 2 bytes written (bf16), far below the
// card's operations-per-byte balance.  The least traffic is one write of the
// output plus one read of the stream rows the pairs touch.  The design gets
// close to that by its access pattern:
//   * one block per (pair, tile of output vectors), where a tile is one
//     output row at the production shape (S=32, C=512, bf16);
//   * each thread moves 16-byte channel vectors (8 bf16 / 4 f32), and
//     neighbouring threads take neighbouring vectors along C, so every warp
//     load of a window position is 512 contiguous bytes;
//   * pairs are packed image-major and subject-major, so a[si] repeats over
//     the N-1 consecutive pairs of one subject and one image's b rows
//     (20 objects x 1 MB in bf16 at production) stay in the 50 MB L2: most
//     stream reads hit L2, and device memory sees mostly the output write.
// The sum, max and relu run in float32 and the result is rounded once to the
// output dtype.  Rounding is monotone, so this equals rounding each sum
// first and taking the max in the output dtype, as the plain PyTorch version
// and the TPU kernel do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kLanes = 4;
  __device__ static void to_float(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 from_float(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kLanes = 8;
  __device__ static void to_float(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static uint4 from_float(const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    }
    return v;
  }
};

// grid.x = pair, grid.y = tile of kThreads * kVecsPerThread output vectors
// of that pair.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pair_pool_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const int* __restrict__ si, const int* __restrict__ oj,
                 T* __restrict__ out, int m, int s, int c) {
  using V = Vec16<T>;
  constexpr int L = V::kLanes;
  const int p = blockIdx.x;
  const int sub = si[p];
  const int obj = oj[p];
  // the wrapper checks shapes; an index outside [0, m) would read another
  // allocation, so stop the kernel as PyTorch's own index kernels do
  if (sub < 0 || sub >= m || obj < 0 || obj >= m) {
    __trap();
  }
  const int h = s / 2;
  const int cv = c / L;                       // 16-byte vectors per pixel
  const int per_pair = h * h * cv;
  const size_t stream = static_cast<size_t>(s) * s * c;
  const size_t row = static_cast<size_t>(s) * c;
  const uint4* a_base = reinterpret_cast<const uint4*>(a + sub * stream);
  const uint4* b_base = reinterpret_cast<const uint4*>(b + obj * stream);
  uint4* o_base = reinterpret_cast<uint4*>(
      out + static_cast<size_t>(p) * h * h * c);
  const size_t row_v = row / L;               // input row, in vectors

  const int tile0 = blockIdx.y * (kThreads * kVecsPerThread);
#pragma unroll
  for (int k = 0; k < kVecsPerThread; ++k) {
    const int t = tile0 + k * kThreads + threadIdx.x;
    if (t >= per_pair) {
      return;
    }
    const int y = t / (h * cv);
    const int rem = t - y * (h * cv);
    const int x = rem / cv;
    const int v = rem - x * cv;
    // window top-left (2y, 2x), in vectors
    const size_t base = (2 * y) * row_v + static_cast<size_t>(2 * x) * cv + v;
    const size_t off[4] = {base, base + cv, base + row_v, base + row_v + cv};
    float best[L];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      float fa[L], fb[L];
      V::to_float(__ldg(a_base + off[w]), fa);
      V::to_float(__ldg(b_base + off[w]), fb);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const float sum = fa[i] + fb[i];
        best[i] = w == 0 ? sum : fmaxf(best[i], sum);
      }
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
      best[i] = fmaxf(best[i], 0.0f);
    }
    o_base[t] = V::from_float(best);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const int* si, const int* oj,
                   void* out, int m, int s, int c, int p,
                   cudaStream_t stream) {
  const int h = s / 2;
  const int per_pair = h * h * (c / Vec16<T>::kLanes);
  const int per_block = kThreads * kVecsPerThread;
  dim3 grid(p, (per_pair + per_block - 1) / per_block);
  pair_pool_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), si, oj,
      static_cast<T*>(out), m, s, c);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// The caller guarantees contiguous NHWC inputs, even s, c a multiple of the
// 16-byte vector, and p >= 1.  Returns the cudaError_t of the launch.
extern "C" int sgc_pair_pool(const void* a, const void* b, const void* si,
                             const void* oj, void* out, int m, int s, int c,
                             int p, int dtype, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const int* si_i = static_cast<const int*>(si);
  const int* oj_i = static_cast<const int*>(oj);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<float>(a, b, si_i, oj_i, out, m, s, c, p, st));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(a, b, si_i, oj_i, out, m, s, c, p, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
