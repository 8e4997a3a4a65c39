// cp.async.cg 16-byte copies with commit_group / wait_group, from a
// channels-last volume at an odd wB offset.  The volume is (4, 25, 25, 16)
// bf16 ((hA wA), hB, wB, C: 32 bytes a cell, so any cell starts on 16
// bytes); the tile is plane 2's rows hB 2..9 and cells wB 3..15, all 16
// channels, copied as two groups of 4 rows.  After wait_group 1 the first
// group is complete and is written out; after wait_group 0, the second.
// out (8, 13, 16) bf16.
#include "probe.cuh"

namespace {

constexpr int kHB = 25, kWB = 25, kC = 16;
constexpr int kPlane = 2, kRow0 = 2, kCell0 = 3, kRows = 8, kCells = 13;
constexpr int kChunks = kCells * kC * 2 / 16;  // 16-byte chunks per tile row

__global__ void kernel(const __nv_bfloat16* x, __nv_bfloat16* out) {
  __shared__ __align__(16) __nv_bfloat16 tile[kRows * kCells * kC];
  const int tid = threadIdx.x;
  for (int half = 0; half < 2; ++half) {
    for (int e = tid; e < (kRows / 2) * kChunks; e += blockDim.x) {
      const int row = half * (kRows / 2) + e / kChunks, chunk = e % kChunks;
      const __nv_bfloat16* src =
          x + ((static_cast<size_t>(kPlane) * kHB + kRow0 + row) * kWB +
               kCell0) * kC + chunk * 8;
      __nv_bfloat16* dst = tile + row * kCells * kC + chunk * 8;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       probe::smem(dst)),
                   "l"(src)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  constexpr int kHalf = (kRows / 2) * kCells * kC;
  for (int e = tid; e < kHalf; e += blockDim.x) out[e] = tile[e];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int e = tid; e < kHalf; e += blockDim.x) {
    out[kHalf + e] = tile[kHalf + e];
  }
}

}  // namespace

extern "C" int probe_run(const void* in0, const void*, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  kernel<<<1, 64, 0, s>>>(static_cast<const __nv_bfloat16*>(in0),
                          static_cast<__nv_bfloat16*>(out));
  return probe::finish(s);
}
