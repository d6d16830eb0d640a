// The optimizer update of the train step, as one multi-tensor pass over
// every parameter.  Two kernels, each with a plain C entry point for ctypes:
//
//   sgc_sgd_norm     the clip's norm pass: each gradient's sum of squares
//                    and, unsharded, the global norm
//   sgc_sgd_update   clip, weight decay, momentum and the step, element by
//                    element
//
// Per element, in float32, in this order (ops/sgd.py's sgd_plain does the
// same, one PyTorch operation at a time):
//
//   g  <- g / div * mul            div, mul = 1, 1 if norm < clip (or no
//                                  clip), else norm, clip
//   g  <- g + wd * p
//   t' <- g + m * t                m * t rounded to the trace's dtype
//   p  <- p + (-lr) * t' [* scale]
//
// with t' stored in the trace's dtype (float32 or bfloat16).  Each step is
// one __fdiv_rn / __fmul_rn / __fadd_rn, never contracted into an FMA, so
// that given the same norm the result is bit-equal to the plain version.
//
// Replaces no TPU kernel: the JAX package's optimizer is optax's chain
// (clip_by_global_norm, add_decayed_weights, sgd), which XLA fuses into the
// jitted step.  Written as one PyTorch operation at a time, the update makes
// ~10 launches a parameter, ~80 bytes of float32 traffic per element and a
// host synchronisation a parameter (the momentum constant's copy).  These
// kernels take every constant by value or from device memory, so the update
// makes no host synchronisation and no copy, in two launches for a table of
// up to kMaxTensors tensors.
//
// Bound: device-memory bytes, 24 per element with a float32 trace (the norm
// pass reads g; the update reads g, p, t and writes p, t'), 20 with the clip
// off, at a handful of float32 operations per element: 6.64 GB, 1.98 ms at
// 3.35 TB/s for vg-hiercom's 27 tensors of 276.7 M elements.  The design
// streams at that rate:
//   * the tensors' pointers and sizes travel in the launch's parameter
//     space (a Table, read through __grid_constant__), so nothing is copied
//     to the card before a launch; a longer list is split into several
//     launches, as apex's multi_tensor_apply does;
//   * each tensor is cut into tiles of kTile elements; a persistent grid
//     sized to the card's SMs walks the tiles of all tensors;
//   * each thread loads kVecs 16-byte vectors of each input before it
//     computes, so a block keeps 48 KB of loads in flight; streaming loads
//     and stores (ld/st.global.cs), since no element is read twice;
//   * a tile whose tensor is not 16-byte aligned everywhere, or the last
//     partial tile of a tensor (sizes 1 and 11, say), takes a scalar path;
//     the norm pass's takes the vector path's elements in its order, so a
//     norm does not depend on where the gradients lie (a mesh's are views
//     of one flat buffer).
// The norm pass writes one float32 sum of squares per tile into a scratch
// buffer, in a fixed order inside the block (a shuffle tree); the last block
// to finish, elected by an integer ticket, sums the tiles of each tensor in
// tile order (in float64) into its square, and the squares in tensor order
// into the norm.  No value is added by an atomic, so the result is the same
// from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                          // 16-byte loads a thread
constexpr int kTile = kThreads * kVecs * 4;       // elements
constexpr int kMaxTensors = 48;                   // the Table fits in 4 KB

struct Entry {
  float* g;            // nullptr: a missing gradient, read as zeros
  float* p;
  const void* t;       // the old trace, float32 or bfloat16
  void* nt;            // the new trace, same dtype; may be g's buffer
  long long n;
  long long tile0;     // first tile of this tensor in the launch
  int vec;             // every pointer 16-byte aligned
};

struct Table {
  Entry e[kMaxTensors];
  int count;
  long long tiles;
};

template <typename T>
struct Trace;

template <>
struct Trace<float> {
  static constexpr size_t kAlign = 16;
  __device__ static float4 load4(const void* base, long long v) {
    return __ldcs(reinterpret_cast<const float4*>(base) + v);
  }
  __device__ static void store4(void* base, long long v, float4 x) {
    __stcs(reinterpret_cast<float4*>(base) + v, x);
  }
  __device__ static float load1(const void* base, long long i) {
    return __ldcs(reinterpret_cast<const float*>(base) + i);
  }
  __device__ static void store1(void* base, long long i, float x) {
    __stcs(reinterpret_cast<float*>(base) + i, x);
  }
  // the momentum term in the trace's dtype
  __device__ static float momentum(float m, float t) {
    return __fmul_rn(m, t);
  }
};

template <>
struct Trace<__nv_bfloat16> {
  static constexpr size_t kAlign = 8;
  __device__ static float4 load4(const void* base, long long v) {
    uint2 raw = __ldcs(reinterpret_cast<const uint2*>(base) + v);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float2 a = __bfloat1622float2(h[0]);
    float2 b = __bfloat1622float2(h[1]);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static void store4(void* base, long long v, float4 x) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(x.x, x.y);
    h[1] = __floats2bfloat162_rn(x.z, x.w);
    __stcs(reinterpret_cast<uint2*>(base) + v, raw);
  }
  __device__ static float load1(const void* base, long long i) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(base)[i]);
  }
  __device__ static void store1(void* base, long long i, float x) {
    reinterpret_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  }
  __device__ static float momentum(float m, float t) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(m, t)));
  }
};

// The constants of one update, as the block reads them.
struct Coeff {
  bool clip, scaled;
  float div, mul, wd, m, step, scale;
};

template <typename T>
__device__ __forceinline__ float update1(float g, float& p, float t,
                                         const Coeff& c) {
  if (c.clip) {
    g = __fmul_rn(__fdiv_rn(g, c.div), c.mul);
  }
  g = __fadd_rn(g, __fmul_rn(c.wd, p));
  const float nt = __fadd_rn(g, Trace<T>::momentum(c.m, t));
  float u = __fmul_rn(c.step, nt);
  if (c.scaled) {
    u = __fmul_rn(u, c.scale);
  }
  p = __fadd_rn(p, u);
  return nt;
}

// The tensor of `tile`: entries are in tile order; `i` only moves forward
// along a block's grid-stride walk.  Empty tensors own no tile.
__device__ __forceinline__ int entry_of(const Table& table, long long tile,
                                        int i) {
  while (i + 1 < table.count && tile >= table.e[i + 1].tile0) {
    ++i;
  }
  return i;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgd_update_kernel(const __grid_constant__ Table table, const float* norm,
                  float clip, const float* scale, float wd, float m,
                  float step) {
  Coeff c;
  c.clip = norm != nullptr;
  c.div = 1.f;
  c.mul = 1.f;
  if (c.clip) {
    const float nv = *norm;
    const bool keep = nv < clip;    // false for a NaN norm, as in PyTorch
    c.div = keep ? 1.f : nv;
    c.mul = keep ? 1.f : clip;
  }
  c.scaled = scale != nullptr;
  c.scale = c.scaled ? *scale : 1.f;
  c.wd = wd;
  c.m = m;
  c.step = step;
  int i = 0;
  for (long long tile = blockIdx.x; tile < table.tiles; tile += gridDim.x) {
    i = entry_of(table, tile, i);
    const Entry& e = table.e[i];
    const long long start = (tile - e.tile0) * kTile;
    const long long end = min(start + static_cast<long long>(kTile), e.n);
    if (e.vec && end - start == kTile) {
      const long long v0 = start / 4 + threadIdx.x;
      float4 g[kVecs], p[kVecs], t[kVecs];
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const long long v = v0 + k * kThreads;
        g[k] = e.g ? __ldcs(reinterpret_cast<const float4*>(e.g) + v)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        p[k] = __ldcs(reinterpret_cast<const float4*>(e.p) + v);
        t[k] = Trace<T>::load4(e.t, v);
      }
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        float4 nt;
        nt.x = update1<T>(g[k].x, p[k].x, t[k].x, c);
        nt.y = update1<T>(g[k].y, p[k].y, t[k].y, c);
        nt.z = update1<T>(g[k].z, p[k].z, t[k].z, c);
        nt.w = update1<T>(g[k].w, p[k].w, t[k].w, c);
        const long long v = v0 + k * kThreads;
        __stcs(reinterpret_cast<float4*>(e.p) + v, p[k]);
        Trace<T>::store4(e.nt, v, nt);
      }
    } else {
      // kVecs elements a thread in flight, kThreads apart
      for (long long j0 = start + threadIdx.x; j0 < end;
           j0 += kThreads * kVecs) {
        float g[kVecs], p[kVecs], t[kVecs];
#pragma unroll
        for (int k = 0; k < kVecs; ++k) {
          const long long j = j0 + k * kThreads;
          if (j < end) {
            g[k] = e.g ? __ldcs(e.g + j) : 0.f;
            p[k] = __ldcs(e.p + j);
            t[k] = Trace<T>::load1(e.t, j);
          }
        }
#pragma unroll
        for (int k = 0; k < kVecs; ++k) {
          const long long j = j0 + k * kThreads;
          if (j < end) {
            const float nt = update1<T>(g[k], p[k], t[k], c);
            __stcs(e.p + j, p[k]);
            Trace<T>::store1(e.nt, j, nt);
          }
        }
      }
    }
  }
}

// The block's sum of v, the same tree every time; the result in thread 0.
template <typename A>
__device__ A block_sum(A v, A* shared) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                 // shared is free from the last call
  if (lane == 0) {
    shared[warp] = v;
  }
  __syncthreads();
  A s = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) {
      s += shared[w];
    }
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
sgd_norm_kernel(const __grid_constant__ Table table, float* partials,
                float* squares, int base, int total, unsigned* ticket,
                float* norm) {
  __shared__ float sf[kThreads / 32];
  __shared__ double sd[kThreads / 32];
  __shared__ bool last;
  int i = 0;
  for (long long tile = blockIdx.x; tile < table.tiles; tile += gridDim.x) {
    i = entry_of(table, tile, i);
    const Entry& e = table.e[i];
    const long long start = (tile - e.tile0) * kTile;
    const long long end = min(start + static_cast<long long>(kTile), e.n);
    float acc = 0.f;
    if (e.g != nullptr) {
      if (e.vec && end - start == kTile) {
        const long long v0 = start / 4 + threadIdx.x;
        float4 g[kVecs];
#pragma unroll
        for (int k = 0; k < kVecs; ++k) {
          g[k] = __ldcs(reinterpret_cast<const float4*>(e.g) + v0
                        + k * kThreads);
        }
#pragma unroll
        for (int k = 0; k < kVecs; ++k) {
          acc = fmaf(g[k].x, g[k].x, acc);
          acc = fmaf(g[k].y, g[k].y, acc);
          acc = fmaf(g[k].z, g[k].z, acc);
          acc = fmaf(g[k].w, g[k].w, acc);
        }
      } else {
        // the vector path's elements and order, so that a tensor's squares
        // do not depend on its alignment
#pragma unroll
        for (int k = 0; k < kVecs; ++k) {
          const long long j0 = start + (threadIdx.x + k * kThreads) * 4LL;
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            if (j0 + l < end) {
              const float x = __ldcs(e.g + j0 + l);
              acc = fmaf(x, x, acc);
            }
          }
        }
      }
    }
    acc = block_sum(acc, sf);
    if (threadIdx.x == 0) {
      partials[tile] = acc;
    }
  }
  // the last block to arrive sums the partials; the fence orders thread
  // 0's partials before its ticket
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) {
    return;
  }
  __threadfence();
  for (int k = 0; k < table.count; ++k) {
    const long long hi = k + 1 < table.count ? table.e[k + 1].tile0
                                             : table.tiles;
    double acc = 0.0;
    for (long long j = table.e[k].tile0 + threadIdx.x; j < hi;
         j += kThreads) {
      acc += static_cast<double>(__ldcg(partials + j));
    }
    acc = block_sum(acc, sd);
    if (threadIdx.x == 0) {
      squares[base + k] = static_cast<float>(acc);
    }
  }
  if (threadIdx.x == 0) {
    if (norm != nullptr) {
      // every launch before this one finished before it started
      double s = 0.0;
      for (int k = 0; k < total; ++k) {
        s += static_cast<double>(__ldcg(squares + k));
      }
      *norm = static_cast<float>(sqrt(s));
    }
    *ticket = 0u;                  // ready for the next launch
  }
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) {
    err = cudaSetDevice(device);
  }
  return err;
}

// The persistent grid: as many resident blocks as the card holds, at most
// one a tile.
template <typename K>
cudaError_t grid_for(K kernel, int device, long long tiles, int* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) {
    return err;
  }
  const long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm
                                                                    : 1);
  *grid = static_cast<int>(tiles < most ? (tiles > 0 ? tiles : 1) : most);
  return cudaSuccess;
}

bool aligned(const void* ptr, size_t bytes) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// The table of tensors [first, first + count): tiles numbered from 0.
Table make_table(void* const* g, void* const* p, const void* const* t,
                 void* const* nt, const long long* n, int first, int count,
                 size_t trace_align) {
  Table table;
  long long tiles = 0;
  for (int k = 0; k < count; ++k) {
    const int src = first + k;
    Entry& e = table.e[k];
    e.g = static_cast<float*>(g[src]);
    e.p = p != nullptr ? static_cast<float*>(p[src]) : nullptr;
    e.t = t != nullptr ? t[src] : nullptr;
    e.nt = nt != nullptr ? nt[src] : nullptr;
    e.n = n[src];
    e.tile0 = tiles;
    e.vec = aligned(e.g, 16) && aligned(e.p, 16) && aligned(e.t, trace_align)
            && aligned(e.nt, trace_align);
    tiles += (n[src] + kTile - 1) / kTile;
  }
  table.count = count;
  table.tiles = tiles;
  return table;
}

template <typename T>
cudaError_t launch_update(void* const* g, void* const* p,
                          const void* const* t, void* const* nt,
                          const long long* n, int count, const float* norm,
                          float clip, const float* scale, float wd, float m,
                          float step, int device, cudaStream_t stream) {
  for (int first = 0; first < count; first += kMaxTensors) {
    const int k = count - first < kMaxTensors ? count - first : kMaxTensors;
    const Table table = make_table(g, p, t, nt, n, first, k,
                                   Trace<T>::kAlign);
    int grid = 0;
    cudaError_t err = grid_for(sgd_update_kernel<T>, device, table.tiles,
                               &grid);
    if (err != cudaSuccess) {
      return err;
    }
    sgd_update_kernel<T><<<grid, kThreads, 0, stream>>>(table, norm, clip,
                                                        scale, wd, m, step);
    err = cudaGetLastError();
    if (err != cudaSuccess) {
      return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// Elements a tile: the norm pass writes one partial sum a tile.
extern "C" int sgc_sgd_tile() { return kTile; }

// Tensors a launch: a longer list takes several launches of each kernel.
extern "C" int sgc_sgd_max_tensors() { return kMaxTensors; }

// The norm pass over `count` float32 gradients g[k] of n[k] elements
// (nullptr: a missing gradient, summed as zeros).  partials: sum over k of
// ceil(n[k] / tile) floats of scratch; squares: count floats, square k
// written; ticket: one unsigned, 0 before the call and left 0; norm:
// nullptr, or one float written with the square root of the squares' sum.
// One launch per kMaxTensors tensors.
extern "C" int sgc_sgd_norm(void* const* g, const long long* n, int count,
                            void* partials, void* squares, void* ticket,
                            void* norm, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  for (int first = 0; first < count; first += kMaxTensors) {
    const int k = count - first < kMaxTensors ? count - first : kMaxTensors;
    const Table table = make_table(g, nullptr, nullptr, nullptr, n, first, k,
                                   16);
    int grid = 0;
    err = grid_for(sgd_norm_kernel, device, table.tiles, &grid);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    const bool final_launch = first + k == count;
    sgd_norm_kernel<<<grid, kThreads, 0, st>>>(
        table, part, static_cast<float*>(squares), first, count,
        static_cast<unsigned*>(ticket),
        final_launch ? static_cast<float*>(norm) : nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    part += table.tiles;
  }
  return static_cast<int>(cudaSuccess);
}

// The update of `count` float32 parameters p[k] of n[k] elements in place,
// from gradients g[k] (nullptr: zeros) and old traces t[k], the new traces
// written to nt[k] (which may be g[k]'s buffer).  trace_dtype: 0 = float32,
// 1 = bfloat16, for t and nt.  norm: nullptr (no clip) or one float on the
// card; scale: nullptr or one float on the card.  step is -lr.  One launch
// per kMaxTensors tensors.
extern "C" int sgc_sgd_update(void* const* g, void* const* p,
                              const void* const* t, void* const* nt,
                              const long long* n, int count, int trace_dtype,
                              const void* norm, float clip, const void* scale,
                              float weight_decay, float momentum, float step,
                              int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nv = static_cast<const float*>(norm);
  const float* sv = static_cast<const float*>(scale);
  switch (trace_dtype) {
    case 0:
      return static_cast<int>(launch_update<float>(
          g, p, t, nt, n, count, nv, clip, sv, weight_decay, momentum, step,
          device, st));
    case 1:
      return static_cast<int>(launch_update<__nv_bfloat16>(
          g, p, t, nt, n, count, nv, clip, sv, weight_decay, momentum, step,
          device, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
