// The warp-specialised Hopper pipeline shared by the bf16 kernels that
// stream weight chunks from L2 (csrc/bottleneck.cu's bottleneck_hopper,
// conv1_s2_hopper and bottleneck_s2_hopper; csrc/ffn.cu's ffn_ln_hopper):
//   * a block of 3 warpgroups: warpgroup 0 produces (one thread issues every
//     TMA copy, 40 registers a thread after setmaxnreg), warpgroups 1-2
//     consume (232 registers);
//   * rings of slots in shared memory, each guarded by a "full" mbarrier
//     (TMA completion) and an "empty" one (every consumer warp of both
//     blocks of a 2-block cluster arrives once it is done with the slot, so
//     that either block's producer may multicast into both);
//   * the host side: tensor maps in TMA's 128-byte swizzle (the driver's
//     cuTensorMapEncodeTiled through the runtime's entry-point query, so
//     that a library needs no link to libcuda) and the cluster launch.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace sgc {
namespace hop {

constexpr int kThreads = 384;       // producer warpgroup + 2 consumer WGs
constexpr int kConsumerThreads = 256;
constexpr int kCluster = 2;         // blocks sharing each weight chunk
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// arrivals that free a ring slot: every consumer warp of both blocks
constexpr unsigned kEmptyArrivals = kCluster * kConsumerThreads / 32;
constexpr int kConsumerBar = 1;     // named barrier of the consumers
constexpr int kFirstConsumer = 128; // the thread that issues TMA stores
constexpr int kSmemMax = 232448;    // dynamic shared memory a block can use

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int align1k(int n) {
  return (n + 1023) / 1024 * 1024;
}

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

// Two rings of a configuration C: C::SX slots of C::XB bytes (boxes of
// activations, and the output's staging) and C::SW slots of C::WB bytes
// (weight chunks).  SX may be 0.
template <class C>
struct Rings {
  Pipe<C::SX> x;
  Pipe<C::SW> w;
};

// The rings of a block whose shared memory (from `smem`, 1024-aligned)
// holds the SX box slots, the SW weight slots, `act` bytes of activations
// and then the barriers, which thread 0 initialises for the whole cluster.
template <class C>
__device__ Rings<C> make_rings(unsigned char* smem, int act) {
  const uint32_t base = sgc::smem_addr(smem);
  const uint32_t bars = base + C::SX * C::XB + C::SW * C::WB + act;
  Rings<C> ring;
  ring.x.slot0 = base;
  ring.x.bytes = C::XB;
  ring.x.bars = bars;
  ring.w.slot0 = base + C::SX * C::XB;
  ring.w.bytes = C::WB;
  ring.w.bars = bars + 16 * C::SX;
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
  return ring;
}

// Two floats rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// 1024-byte alignment for the swizzled TMA boxes (the same offset in both
// blocks of the cluster, as multicast needs).
__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  return raw + (1024 - sgc::smem_addr(raw) % 1024) % 1024;
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
inline EncodeTiled encode_tiled() {
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

// A tensor map of element type `type` and TMA swizzle `swizzle`: dims
// innermost first, strides (bytes) of dims 1.., box extents.  Elements
// outside the tensor load as zeros.
inline CUresult tensor_map(CUtensorMap* map, const void* base, int rank,
                           const cuuint64_t* dims, const cuuint64_t* strides,
                           const cuuint32_t* box, CUtensorMapDataType type,
                           CUtensorMapSwizzle swizzle) {
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    return CUDA_ERROR_NOT_FOUND;
  }
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A bfloat16 tensor map with TMA's 128-byte swizzle.
inline CUresult tensor_map(CUtensorMap* map, const void* base, int rank,
                           const cuuint64_t* dims, const cuuint64_t* strides,
                           const cuuint32_t* box) {
  return tensor_map(map, base, rank, dims, strides, box,
                    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// A (rows, cols) row-major matrix in boxes of 64 columns x box_rows rows.
inline CUresult matrix_map(CUtensorMap* map, const void* base,
                           long long rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows)};
  return tensor_map(map, base, 2, dims, strides, box);
}

// Launches kern in clusters of kCluster blocks (gx rounded up to a whole
// number of clusters) x gy, kThreads threads and `smem` bytes of dynamic
// shared memory a block.
template <class K, class... Args>
cudaError_t launch_clusters(K kern, int smem, int gx, int gy,
                            cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((gx + kCluster - 1) / kCluster * kCluster, gy);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) {
    return err;
  }
  return cudaGetLastError();
}

}  // namespace hop
}  // namespace sgc
