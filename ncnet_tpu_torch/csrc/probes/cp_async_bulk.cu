// A 1-D bulk copy (cp.async.bulk, global -> shared) completing on an
// mbarrier with expect_tx: row 2 of a (4, 29, 16) bf16 volume, one padded
// row of 29 cells x 32 bytes = 928 bytes (a multiple of 16, at a 16-byte
// aligned offset).  Thread 0 arms the barrier with the byte count and issues
// the copy; every thread waits on phase 0, then writes the row out.
// out (29, 16) bf16.
#include "probe.cuh"

namespace {

constexpr int kCells = 29, kC = 16, kRow = 2;
constexpr uint32_t kBytes = kCells * kC * 2;

__global__ void kernel(const __nv_bfloat16* x, __nv_bfloat16* out) {
  __shared__ __align__(128) __nv_bfloat16 row[kCells * kC];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) {
    probe::mbar_init(&bar, 1);
    probe::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    probe::mbar_expect_tx(&bar, kBytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(probe::smem(row)),
        "l"(x + kRow * kCells * kC), "r"(kBytes), "r"(probe::smem(&bar))
        : "memory");
  }
  if (!probe::mbar_wait(&bar, 0)) return;
  for (int e = threadIdx.x; e < kCells * kC; e += blockDim.x) out[e] = row[e];
}

}  // namespace

extern "C" int probe_run(const void* in0, const void*, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (const int rc = probe::start(s)) return rc;
  kernel<<<1, 128, 0, s>>>(static_cast<const __nv_bfloat16*>(in0),
                           static_cast<__nv_bfloat16*>(out));
  return probe::finish(s);
}
