// TMA stores (cp.async.bulk.tensor.5d, shared -> global, bulk_group) into
// the channels-last NC volume (B hA, wA, hB, wB, C) = (4, 5, 25, 25, 16)
// bf16, zero-filled beforehand.  A 29 x 29 x 16 box (a plane with its conv
// halo) is staged in shared memory with plain stores, made visible to the
// async proxy (fence.proxy.async), and stored twice, each time running past
// the volume's far edges, where TMA drops the writes: at (c, wB, hB, wA,
// B hA) = (0, 0, 0, 1, 2), where the box's first 25 rows and cells land,
// and at (0, 10, 12, 0, 0), where its first 13 rows and 15 cells land.  A
// store must start inside the volume: on this card a box stored from (0,
// -2, -2, 1, 2) stops the kernel with an illegal instruction (the zero
// fill at negative coordinates is the loads' alone).  out = the volume.
#include "probe.cuh"

namespace {

constexpr int kBox = 29, kC = 16;

__global__ void kernel(const __grid_constant__ CUtensorMap map,
                       const __nv_bfloat16* tile) {
  __shared__ __align__(128) __nv_bfloat16 box[kBox * kBox * kC];
  for (int e = threadIdx.x; e < kBox * kBox * kC; e += blockDim.x) {
    box[e] = tile[e];
  }
  probe::fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int coords[2][5] = {{0, 0, 0, 1, 2}, {0, 10, 12, 0, 0}};
    for (int n = 0; n < 2; ++n) {
      asm volatile(
          "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group "
          "[%0, {%1, %2, %3, %4, %5}], [%6];\n" ::"l"(
              reinterpret_cast<uint64_t>(&map)),
          "r"(coords[n][0]), "r"(coords[n][1]), "r"(coords[n][2]),
          "r"(coords[n][3]), "r"(coords[n][4]), "r"(probe::smem(box))
          : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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
  if (const int rc = probe::encode_bf16(&map, 5, out, dims, strides, box)) {
    return rc;
  }
  kernel<<<1, 128, 0, s>>>(map, static_cast<const __nv_bfloat16*>(in0));
  return probe::finish(s);
}
