// wgmma m64n16k16, bf16 in, f32 out, A from registers and B from shared
// memory (no swizzle): D (64, 16) = A (64, 16) @ Bt (16, 16)^T, one
// warpgroup.  Warp w holds rows 16 w .. 16 w + 15 of A; with g = lane / 4
// and t = lane % 4, a0 = A[16w + g][2t .. +1], a1 = A[16w + g + 8][2t ..],
// a2 = A[16w + g][2t + 8 ..], a3 = A[16w + g + 8][2t + 8 ..], loaded
// straight from global memory.  B in core matrices as in
// wgmma_m64n16k16_ss.
#include "probe.cuh"

namespace {

constexpr int kN = 16, kK = 16;

__device__ __forceinline__ int core_offset(int r, int k) {
  return (r % 8) * 8 + k % 8 + (k / 8) * 64 + (r / 8) * 128;
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__global__ void kernel(const __nv_bfloat16* a, const __nv_bfloat16* bt,
                       float* d) {
  __shared__ __align__(128) __nv_bfloat16 sb[kN * kK];
  for (int e = threadIdx.x; e < kN * kK; e += blockDim.x) {
    sb[core_offset(e / kK, e % kK)] = bt[e];
  }
  probe::fence_proxy_async();
  __syncthreads();
  const int w = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const __nv_bfloat16* r0 = a + (16 * w + g) * kK + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * kK;
  const uint32_t ra[4] = {pack(r0[0], r0[1]), pack(r1[0], r1[1]),
                          pack(r0[8], r0[9]), pack(r1[8], r1[9])};
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const uint64_t db = probe::wgmma_desc(sb, 128, 256, 0);
  probe::wgmma_fence();
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n"
      "}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]), "+f"(acc[4]),
        "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7])
      : "r"(ra[0]), "r"(ra[1]), "r"(ra[2]), "r"(ra[3]), "l"(db), "r"(0));
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
