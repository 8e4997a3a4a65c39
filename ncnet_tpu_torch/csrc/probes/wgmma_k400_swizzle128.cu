// wgmma m64n16k16 over the L2 layer's (p, q, c) = 400 contraction: D (64,
// 16) = A (64, 400) @ Bt (16, 400)^T as 25 k-steps of 16, accumulated in
// registers (scale-d off on the first step, on after), both operands K-major
// with the 128-byte swizzle.  K is cut in panels of 64 (128 bytes a row;
// 400 -> 7 panels, the last one zero-padded), each panel 1024-byte aligned
// with rows 128 bytes apart; element (r, k) of panel k / 64 lies at row r,
// 16-byte chunk (k % 64 / 8) ^ (r % 8), the 128-byte swizzle.  Descriptor
// of k-step s: the panel's base + 32 bytes x (s % 4), stride byte offset
// 1024 (8 rows), layout 1.  wgmma.fence before the steps, one
// commit_group, wait_group 0.  Dynamic shared memory, 71,680 bytes.
#include "probe.cuh"

namespace {

constexpr int kM = 64, kN = 16, kK = 400, kSteps = kK / 16;
constexpr int kPanelK = 64, kPanels = (kK + kPanelK - 1) / kPanelK;  // 7
constexpr int kPanelA = kM * 128, kPanelB = kN * 128;  // bytes per panel
constexpr int kSmem = kPanels * (kPanelA + kPanelB) + 1024;

__device__ __forceinline__ int swizzled(int r, int k) {  // byte offset
  const int kc = k % kPanelK;
  return r * 128 + (((kc / 8) ^ (r % 8)) * 16) + (kc % 8) * 2;
}

__global__ void kernel(const __nv_bfloat16* a, const __nv_bfloat16* bt,
                       float* d) {
  extern __shared__ unsigned char raw[];
  const uint32_t shift = (1024 - (probe::smem(raw) & 1023)) & 1023;
  unsigned char* sa = raw + shift;  // 1024-byte aligned panels of A, then B
  unsigned char* sb = sa + kPanels * kPanelA;
  for (int e = threadIdx.x; e < kM * kPanels * kPanelK; e += blockDim.x) {
    const int r = e / (kPanels * kPanelK), k = e % (kPanels * kPanelK);
    *reinterpret_cast<__nv_bfloat16*>(sa + (k / kPanelK) * kPanelA +
                                      swizzled(r, k)) =
        k < kK ? a[r * kK + k] : __float2bfloat16_rn(0.f);
  }
  for (int e = threadIdx.x; e < kN * kPanels * kPanelK; e += blockDim.x) {
    const int r = e / (kPanels * kPanelK), k = e % (kPanels * kPanelK);
    *reinterpret_cast<__nv_bfloat16*>(sb + (k / kPanelK) * kPanelB +
                                      swizzled(r, k)) =
        k < kK ? bt[r * kK + k] : __float2bfloat16_rn(0.f);
  }
  probe::fence_proxy_async();
  __syncthreads();
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  probe::wgmma_fence();
  for (int s = 0; s < kSteps; ++s) {
    const int off = (s % 4) * 32;
    const uint64_t da =
        probe::wgmma_desc(sa + (s / 4) * kPanelA + off, 16, 1024, 1);
    const uint64_t db =
        probe::wgmma_desc(sb + (s / 4) * kPanelB + off, 16, 1024, 1);
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
          "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7])
        : "l"(da), "l"(db), "r"(s > 0 ? 1 : 0));
  }
  probe::wgmma_commit();
  probe::wgmma_wait_all();
  probe::store_accumulators<kN>(acc, d);
}

}  // namespace

extern "C" int probe_run(const void* in0, const void* in1, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, 128, kSmem, s>>>(static_cast<const __nv_bfloat16*>(in0),
                               static_cast<const __nv_bfloat16*>(in1),
                               static_cast<float*>(out));
  return probe::finish(s);
}
