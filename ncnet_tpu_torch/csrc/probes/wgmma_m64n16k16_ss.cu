// wgmma m64n16k16, bf16 in, f32 out, A and B from shared memory (no
// swizzle): D (64, 16) = A (64, 16) @ Bt (16, 16)^T, one warpgroup.  N = 16
// is the NC stack's 16 -> 16 layer's C_out.  Both operands are K-major and
// stored as core matrices of 8 rows x 8 bf16 (16 bytes a row, 128 bytes a
// matrix): element (r, k) at (r % 8) * 8 + k % 8 + (k / 8) * 64 +
// (r / 8) * 128, so the leading byte offset (the next core matrix along K)
// is 128 bytes and the stride byte offset (the next 8 rows) 256.
#include "probe.cuh"

namespace {

constexpr int kM = 64, kN = 16, kK = 16;

__device__ __forceinline__ int core_offset(int r, int k) {
  return (r % 8) * 8 + k % 8 + (k / 8) * 64 + (r / 8) * 128;
}

__global__ void kernel(const __nv_bfloat16* a, const __nv_bfloat16* bt,
                       float* d) {
  __shared__ __align__(128) __nv_bfloat16 sa[kM * kK];
  __shared__ __align__(128) __nv_bfloat16 sb[kN * kK];
  for (int e = threadIdx.x; e < kM * kK; e += blockDim.x) {
    sa[core_offset(e / kK, e % kK)] = a[e];
  }
  for (int e = threadIdx.x; e < kN * kK; e += blockDim.x) {
    sb[core_offset(e / kK, e % kK)] = bt[e];
  }
  probe::fence_proxy_async();
  __syncthreads();
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const uint64_t da = probe::wgmma_desc(sa, 128, 256, 0);
  const uint64_t db = probe::wgmma_desc(sb, 128, 256, 0);
  probe::wgmma_fence();
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]), "+f"(acc[4]),
        "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7])
      : "l"(da), "l"(db), "r"(0));
  probe::wgmma_commit();
  probe::wgmma_wait_all();
  probe::store_accumulators<kN>(acc, d);
}

}  // namespace

extern "C" int probe_run(const void* in0, const void* in1, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  kernel<<<1, 128, 0, s>>>(static_cast<const __nv_bfloat16*>(in0),
                           static_cast<const __nv_bfloat16*>(in1),
                           static_cast<float*>(out));
  return probe::finish(s);
}
