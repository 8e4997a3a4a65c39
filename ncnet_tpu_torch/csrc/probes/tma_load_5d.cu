// TMA loads (cp.async.bulk.tensor.5d, global -> shared, completing on an
// mbarrier) over the channels-last NC volume (B hA, wA, hB, wB, C) = (4, 5,
// 25, 25, 16) bf16: the 6-D (B, hA, wA, hB, wB, C) volume with B and hA
// folded, to fit TMA's 5 dims.  The map is made on the host with
// cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, so
// nothing links -lcuda) and passed as a __grid_constant__ parameter.  The
// box is one (hB, wB) plane with its conv halo, 29 x 29 cells x 16
// channels.  Load 0 starts at (c, wB, hB, wA, B hA) = (0, -2, -2, 1, 2): TMA
// fills the out-of-bounds cells with zeros, so the box is the plane's
// zero-padded frame.  Load 1 starts at (0, 1, 0, 4, 3) and runs past the
// far edges.  The two loads reuse one buffer and one barrier (phases 0 and
// 1).  out (2, 29, 29, 16) bf16 = [load][hB][wB][C].
#include "probe.cuh"

namespace {

constexpr int kBox = 29, kC = 16;
constexpr uint32_t kBytes = kBox * kBox * kC * 2;

__global__ void kernel(const __grid_constant__ CUtensorMap map,
                       __nv_bfloat16* out) {
  __shared__ __align__(128) __nv_bfloat16 box[kBox * kBox * kC];
  __shared__ __align__(8) uint64_t bar;
  const int coords[2][5] = {{0, -2, -2, 1, 2}, {0, 1, 0, 4, 3}};
  if (threadIdx.x == 0) {
    probe::mbar_init(&bar, 1);
    probe::fence_barrier_init();
  }
  __syncthreads();
  for (int n = 0; n < 2; ++n) {
    if (threadIdx.x == 0) {
      probe::mbar_expect_tx(&bar, kBytes);
      asm volatile(
          "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
          "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
              probe::smem(box)),
          "l"(reinterpret_cast<uint64_t>(&map)), "r"(coords[n][0]),
          "r"(coords[n][1]), "r"(coords[n][2]), "r"(coords[n][3]),
          "r"(coords[n][4]), "r"(probe::smem(&bar))
          : "memory");
    }
    if (!probe::mbar_wait(&bar, n & 1)) return;
    for (int e = threadIdx.x; e < kBox * kBox * kC; e += blockDim.x) {
      out[n * kBox * kBox * kC + e] = box[e];
    }
    __syncthreads();  // every read of the box is done before the next load
    probe::fence_proxy_async();
  }
}

}  // namespace

extern "C" int probe_run(const void* in0, const void*, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const cuuint64_t dims[5] = {16, 25, 25, 5, 4};
  const cuuint64_t strides[4] = {32, 25 * 32, 25 * 25 * 32, 5 * 25 * 25 * 32};
  const cuuint32_t box[5] = {16, 29, 29, 1, 1};
  CUtensorMap map;
  if (const int rc = probe::encode_bf16(&map, 5, const_cast<void*>(in0), dims,
                                        strides, box)) {
    return rc;
  }
  if (const int rc = probe::start(s)) return rc;
  kernel<<<1, 128, 0, s>>>(map, static_cast<__nv_bfloat16*>(out));
  return probe::finish(s);
}
