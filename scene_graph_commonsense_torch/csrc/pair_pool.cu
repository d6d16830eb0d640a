// Fused pair assembly for the relation trunk, and its training forward and
// backward.  Three kernels, each with a plain C entry point for ctypes:
//
//   sgc_pair_pool       forward (eval, serving, and training without grad)
//   sgc_pair_pool_idx   forward that also writes the winning window slot
//   sgc_pair_pool_bwd   backward: the gradient goes to the winner, then
//                       pairs -> objects
//
// sgc_pair_pool:
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
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kLanes = 4;
  using Slots = uint32_t;                     // kLanes int8 winner slots
  __device__ static float round(float x) { return x; }
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
  using Slots = uint2;
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
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

// ---------------------------------------------------------------------------
// sgc_pair_pool_idx: replaces `_kernel_idx` of
// scene_graph_commonsense_tpu/ops/pallas/pair_pool.py (reached through
// `fused_pair_pool(..., with_idx=True)` in the custom VJP's forward).
//
//   out[p, y, x, c] as sgc_pair_pool;
//   idx[p, y, x, c] = the slot 2*dy + dx of the window's maximum (int8), the
//                     first one on ties, -1 where that maximum is <= 0.
//
// The argmax is taken over each window sum ROUNDED TO THE STREAM DTYPE, as
// the TPU kernel and the plain version add in the stream dtype before they
// compare: two float32 sums that differ can round to one bf16 value, and the
// first slot must then win.  (sgc_pair_pool may compare unrounded sums: the
// value of the maximum is the same, its position need not be.)  Layout, grid
// and the bound are those of sgc_pair_pool, plus the int8 write: one byte
// per output element, a quarter (f32) or half (bf16) of the out write.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
pair_pool_idx_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const int* __restrict__ si, const int* __restrict__ oj,
                     T* __restrict__ out, int8_t* __restrict__ idx, int m,
                     int s, int c) {
  using V = Vec16<T>;
  constexpr int L = V::kLanes;
  const int p = blockIdx.x;
  const int sub = si[p];
  const int obj = oj[p];
  if (sub < 0 || sub >= m || obj < 0 || obj >= m) {
    __trap();
  }
  const int h = s / 2;
  const int cv = c / L;
  const int per_pair = h * h * cv;
  const size_t stream = static_cast<size_t>(s) * s * c;
  const uint4* a_base = reinterpret_cast<const uint4*>(a + sub * stream);
  const uint4* b_base = reinterpret_cast<const uint4*>(b + obj * stream);
  const size_t out_off = static_cast<size_t>(p) * h * h * c;
  uint4* o_base = reinterpret_cast<uint4*>(out + out_off);
  typename V::Slots* i_base =
      reinterpret_cast<typename V::Slots*>(idx + out_off);
  const size_t row_v = static_cast<size_t>(s) * c / L;

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
    const size_t base = (2 * y) * row_v + static_cast<size_t>(2 * x) * cv + v;
    const size_t off[4] = {base, base + cv, base + row_v, base + row_v + cv};
    float best[L];
    int8_t win[L];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      float fa[L], fb[L];
      V::to_float(__ldg(a_base + off[w]), fa);
      V::to_float(__ldg(b_base + off[w]), fb);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const float sum = V::round(fa[i] + fb[i]);
        if (w == 0 || sum > best[i]) {      // strict: ties keep the first
          best[i] = sum;
          win[i] = static_cast<int8_t>(w);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (!(best[i] > 0.0f)) {
        best[i] = 0.0f;
        win[i] = -1;
      }
    }
    o_base[t] = V::from_float(best);
    typename V::Slots packed;
    memcpy(&packed, win, sizeof(packed));
    i_base[t] = packed;
  }
}

// ---------------------------------------------------------------------------
// sgc_pair_pool_bwd: replaces `_pair_pool_bwd` of the same file.
//
//   ga[m, 2y+dy, 2x+dx, c] = sum over pairs q with si[q] = m, in ascending q,
//                            of g[q, y, x, c] where idx[q, y, x, c] = 2dy+dx;
//   gb                     = the same over oj.
//
// The TPU version is a dense (2M, P) x (P, K) incidence matmul because the
// MXU makes dense work cheap.  Here the scatter is a gather instead, and
// deterministic: the wrapper sorts the 2P (object, pair) incidences once
// (`lists`: pair numbers grouped by object, ascending within each object;
// `offsets`: 2M + 1 bounds, objects [0, M) for ga, [M, 2M) for gb), and each
// thread owns one (object, pooled position, 16-byte channel vector), walks
// that object's pairs in order, routes each g vector to one of its four
// float32 window accumulators by idx, and writes the four full-resolution
// vectors once, rounded to g's dtype.  No atomics: the bits are the same on
// every run, and the float32 sums are taken in the same order as a
// sequential index_add_.
//
// Bound: device-memory bytes (about 2 operations per g element).  The least
// traffic is one read of g and idx and one write of ga and gb; this design
// reads g and idx twice (once for the subject lists, once for the object
// lists) and writes every stream row once, zeros included.  An object's
// list is as long as its pairs: 2 to 2(N-1) for live objects, but every
// padding slot of the pack is parked on objects 0 and 1, so at a capacity
// far above the live pairs those two objects' blocks walk long lists.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
pair_pool_bwd_kernel(const T* __restrict__ g, const int8_t* __restrict__ idx,
                     const int* __restrict__ si, const int* __restrict__ oj,
                     const int* __restrict__ offsets,
                     const int* __restrict__ lists, T* __restrict__ ga,
                     T* __restrict__ gb, int m, int s, int c, int p) {
  using V = Vec16<T>;
  constexpr int L = V::kLanes;
  const int o = blockIdx.x;                   // [0, m): ga; [m, 2m): gb
  const bool is_sub = o < m;
  const int obj = is_sub ? o : o - m;
  const int* owner = is_sub ? si : oj;
  const int begin = offsets[o];
  const int end = offsets[o + 1];
  // the lists partition [0, 2p) exactly when every index lies in [0, m)
  if (offsets[0] != 0 || offsets[2 * m] != 2 * p || begin > end) {
    __trap();
  }
  const int h = s / 2;
  const int cv = c / L;
  const int per_obj = h * h * cv;
  const int t = blockIdx.y * kThreads + threadIdx.x;
  if (t >= per_obj) {
    return;
  }
  const int y = t / (h * cv);
  const int rem = t - y * (h * cv);
  const int x = rem / cv;
  const int v = rem - x * cv;

  float acc[4][L];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      acc[w][i] = 0.0f;
    }
  }
  const size_t pair_v = static_cast<size_t>(per_obj);   // vectors per pair
  const uint4* g_v = reinterpret_cast<const uint4*>(g);
  const typename V::Slots* i_v =
      reinterpret_cast<const typename V::Slots*>(idx);
#pragma unroll 4
  for (int k = begin; k < end; ++k) {
    const int q = lists[k];
    if (q < 0 || q >= p || owner[q] != obj) {
      __trap();
    }
    const size_t at = static_cast<size_t>(q) * pair_v + t;
    float gf[L];
    V::to_float(__ldg(g_v + at), gf);
    const typename V::Slots packed = __ldg(i_v + at);
    int8_t win[L];
    memcpy(win, &packed, sizeof(packed));
#pragma unroll
    for (int i = 0; i < L; ++i) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        acc[w][i] += win[i] == w ? gf[i] : 0.0f;
      }
    }
  }
  T* dst = (is_sub ? ga : gb) + static_cast<size_t>(obj) * s * s * c;
  uint4* d_v = reinterpret_cast<uint4*>(dst);
  const size_t row_v = static_cast<size_t>(s) * cv;
  const size_t base = (2 * y) * row_v + static_cast<size_t>(2 * x) * cv + v;
  d_v[base] = V::from_float(acc[0]);
  d_v[base + cv] = V::from_float(acc[1]);
  d_v[base + row_v] = V::from_float(acc[2]);
  d_v[base + row_v + cv] = V::from_float(acc[3]);
}

template <typename T>
cudaError_t launch_idx(const void* a, const void* b, const int* si,
                       const int* oj, void* out, void* idx, int m, int s,
                       int c, int p, cudaStream_t stream) {
  const int h = s / 2;
  const int per_pair = h * h * (c / Vec16<T>::kLanes);
  const int per_block = kThreads * kVecsPerThread;
  dim3 grid(p, (per_pair + per_block - 1) / per_block);
  pair_pool_idx_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), si, oj,
      static_cast<T*>(out), static_cast<int8_t*>(idx), m, s, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* idx, const int* si,
                       const int* oj, const int* offsets, const int* lists,
                       void* ga, void* gb, int m, int s, int c, int p,
                       cudaStream_t stream) {
  const int h = s / 2;
  const int per_obj = h * h * (c / Vec16<T>::kLanes);
  dim3 grid(2 * m, (per_obj + kThreads - 1) / kThreads);
  pair_pool_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int8_t*>(idx), si, oj,
      offsets, lists, static_cast<T*>(ga), static_cast<T*>(gb), m, s, c, p);
  return cudaGetLastError();
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) {
    err = cudaSetDevice(device);
  }
  return err;
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

// dtype: 0 = float32, 1 = bfloat16.  Same contract as sgc_pair_pool; idx is
// a (p, s/2, s/2, c) int8 buffer.
extern "C" int sgc_pair_pool_idx(const void* a, const void* b, const void* si,
                                 const void* oj, void* out, void* idx, int m,
                                 int s, int c, int p, int dtype, int device,
                                 void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int* si_i = static_cast<const int*>(si);
  const int* oj_i = static_cast<const int*>(oj);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_idx<float>(a, b, si_i, oj_i, out, idx, m, s, c, p, st));
    case 1:
      return static_cast<int>(launch_idx<__nv_bfloat16>(
          a, b, si_i, oj_i, out, idx, m, s, c, p, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// g: (p, s/2, s/2, c) in the stream dtype; idx: its int8 winner slots;
// offsets: 2m + 1 int32 list bounds; lists: 2p int32 pair numbers (see
// pair_pool_bwd_kernel); ga, gb: (m, s, s, c) outputs, every element
// written.  p >= 1.
extern "C" int sgc_pair_pool_bwd(const void* g, const void* idx,
                                 const void* si, const void* oj,
                                 const void* offsets, const void* lists,
                                 void* ga, void* gb, int m, int s, int c,
                                 int p, int dtype, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int* si_i = static_cast<const int*>(si);
  const int* oj_i = static_cast<const int*>(oj);
  const int* off_i = static_cast<const int*>(offsets);
  const int* lst_i = static_cast<const int*>(lists);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_bwd<float>(
          g, idx, si_i, oj_i, off_i, lst_i, ga, gb, m, s, c, p, st));
    case 1:
      return static_cast<int>(launch_bwd<__nv_bfloat16>(
          g, idx, si_i, oj_i, off_i, lst_i, ga, gb, m, s, c, p, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
