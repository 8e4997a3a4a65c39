// Shared pieces of the toolchain probes (ncnet_tpu_torch/tools/mosaic_probes.py).
//
// Every probe is one source in this directory, built by itself into a
// plain-C shared library for sm_90a, with one entry:
//
//   int probe_run(const void* in0, const void* in1, void* out, void* stream);
//
// It launches the probe's kernel on `stream` with the inputs the Python
// side made (in1 may be null) and the zero-filled output, synchronises the
// stream, and returns 0, a cudaError_t, or one of the probe codes below.
// probe_error_string(rc) names any of them.

#pragma once

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace probe {

// codes above every cudaError_t
constexpr int kWaitTimedOut = 10001;      // an mbarrier wait spun out
constexpr int kNoEncodeEntry = 10002;     // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = 10003;      // a tensor map was refused
constexpr int kEncodeAccepted = 10004;    // a map that must be refused was not

// a kernel's own verdict (0 or a code above), read back by finish()
__device__ int g_flag;

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase differs from `parity`, for a bounded
// number of polls: a probe whose barrier never completes reports
// kWaitTimedOut through g_flag instead of hanging the card.
__device__ __forceinline__ bool mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int i = 0; i < (1 << 20); ++i) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
    if (done) return true;
  }
  atomicExch(&g_flag, kWaitTimedOut);
  return false;
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory matrix descriptor: the start address and the
// leading and stride byte offsets in 16-byte units, and the layout (0: no
// swizzle, core matrices of 8 rows x 16 bytes; 1: the 128-byte swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((smem(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Write a warpgroup's m64nN f32 accumulators to d (64 x n, row-major):
// thread t (warp w = t / 32, lane l) holds in acc[4 i + q] the element
// (16 w + l / 4 + 8 (q / 2), 8 i + 2 (l % 4) + q % 2).
template <int N>
__device__ __forceinline__ void store_accumulators(const float* acc, float* d) {
  const int w = threadIdx.x / 32 % 4, l = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      d[(16 * w + l / 4 + 8 * (q / 2)) * N + 8 * i + 2 * (l % 4) + q % 2] =
          acc[4 * i + q];
    }
  }
}

// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so that
// nothing links libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A bf16 tiled map of `rank` dims (innermost first), strides in bytes for
// dims 1.., no swizzle, zero fill out of bounds.  Returns 0 or a code.
inline int encode_bf16(CUtensorMap* map, int rank, void* base,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                              &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess || fn == nullptr) {
    return kNoEncodeEntry;
  }
  cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult rc = reinterpret_cast<EncodeTiled>(fn)(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, base, dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

// Clear the kernel's flag before its launch.
inline int start(cudaStream_t stream) {
  const int zero = 0;
  return static_cast<int>(cudaMemcpyToSymbolAsync(
      g_flag, &zero, sizeof(int), 0, cudaMemcpyHostToDevice, stream));
}

// The launch's error, else the run's, else the kernel's own flag.
inline int finish(cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamSynchronize(stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int flag = 0;
  err = cudaMemcpyFromSymbol(&flag, g_flag, sizeof(int));
  return err != cudaSuccess ? static_cast<int>(err) : flag;
}

}  // namespace probe

extern "C" const char* probe_error_string(int rc) {
  switch (rc) {
    case probe::kWaitTimedOut:
      return "an mbarrier wait timed out";
    case probe::kNoEncodeEntry:
      return "cudaGetDriverEntryPoint found no cuTensorMapEncodeTiled";
    case probe::kEncodeFailed:
      return "cuTensorMapEncodeTiled refused the tensor map";
    case probe::kEncodeAccepted:
      return "cuTensorMapEncodeTiled accepted a 1682-byte row stride";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(rc));
  }
}
