// TMA over the fused-lane frame of the L2 layer probe (T1).  Its 841-lane
// rows are 1682 bytes, and a TMA stride must be a multiple of 16 bytes: the
// probe first asks cuTensorMapEncodeTiled for the (29 hA, 29 wA, 16, 841)
// map and requires a refusal, then maps the frame padded to 848 lanes
// (1696-byte rows), (B hA, wA, C, lanes) = (29, 29, 16, 848) bf16, and
// loads two boxes of (j + q) 5 rows x 16 channels x 136 lanes, the window
// a T1 stage reads: at (lane, c, wA, B hA) = (712, 0, 3, 7), inside, and at
// (760, 0, 22, 28), past the last lane (zeros there).
// out (2, 5, 16, 136) bf16 = [load][wA][C][lane].
#include "probe.cuh"

namespace {

constexpr int kLanes = 136, kC = 16, kRows = 5;
constexpr uint32_t kBytes = kLanes * kC * kRows * 2;

__global__ void kernel(const __grid_constant__ CUtensorMap map,
                       __nv_bfloat16* out) {
  __shared__ __align__(128) __nv_bfloat16 box[kRows * kC * kLanes];
  __shared__ __align__(8) uint64_t bar;
  const int coords[2][4] = {{712, 0, 3, 7}, {760, 0, 22, 28}};
  if (threadIdx.x == 0) {
    probe::mbar_init(&bar, 1);
    probe::fence_barrier_init();
  }
  __syncthreads();
  for (int n = 0; n < 2; ++n) {
    if (threadIdx.x == 0) {
      probe::mbar_expect_tx(&bar, kBytes);
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
          "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
              probe::smem(box)),
          "l"(reinterpret_cast<uint64_t>(&map)), "r"(coords[n][0]),
          "r"(coords[n][1]), "r"(coords[n][2]), "r"(coords[n][3]),
          "r"(probe::smem(&bar))
          : "memory");
    }
    if (!probe::mbar_wait(&bar, n & 1)) return;
    for (int e = threadIdx.x; e < kRows * kC * kLanes; e += blockDim.x) {
      out[n * kRows * kC * kLanes + e] = box[e];
    }
    __syncthreads();
    probe::fence_proxy_async();
  }
}

}  // namespace

extern "C" int probe_run(const void* in0, const void*, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const cuuint32_t box[4] = {kLanes, kC, kRows, 1};
  CUtensorMap map;
  {  // the unpadded frame: 1682-byte rows must be refused
    const cuuint64_t dims[4] = {841, 16, 29, 29};
    const cuuint64_t strides[3] = {841 * 2, 16 * 841 * 2, 29 * 16 * 841 * 2};
    const int rc = probe::encode_bf16(&map, 4, const_cast<void*>(in0), dims,
                                      strides, box);
    if (rc == 0) return probe::kEncodeAccepted;
    if (rc != probe::kEncodeFailed) return rc;
  }
  const cuuint64_t dims[4] = {848, 16, 29, 29};
  const cuuint64_t strides[3] = {848 * 2, 16 * 848 * 2, 29 * 16 * 848 * 2};
  if (const int rc = probe::encode_bf16(&map, 4, const_cast<void*>(in0), dims,
                                        strides, box)) {
    return rc;
  }
  if (const int rc = probe::start(s)) return rc;
  kernel<<<1, 128, 0, s>>>(map, static_cast<__nv_bfloat16*>(out));
  return probe::finish(s);
}
