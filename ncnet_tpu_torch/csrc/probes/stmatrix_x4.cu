// stmatrix.x4 to 32-byte channel rows at a padded pitch, the inverse of the
// ldmatrix_x4 probe: lane l holds in register m the pair in[l][m] of matrix
// m's row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1, and gives the address
// of row l % 8 of matrix l / 8 (matrix m = cells 3 + 8 (m / 2) .., channels
// 8 (m % 2) .. of a (29, 16) bf16 row staged at a pitch of 24 bf16).  The
// staged row starts zeroed and is written out whole: out (29, 16) bf16.
#include "probe.cuh"

namespace {

constexpr int kCells = 29, kC = 16, kPitch = 24, kCell0 = 3;

__global__ void kernel(const uint32_t* in, __nv_bfloat16* out) {
  __shared__ __align__(16) __nv_bfloat16 tile[kCells * kPitch];
  const int lane = threadIdx.x;
  for (int e = lane; e < kCells * kPitch; e += 32) {
    tile[e] = __float2bfloat16_rn(0.f);
  }
  __syncwarp();
  const int m = lane / 8;
  const __nv_bfloat16* row =
      tile + (kCell0 + 8 * (m / 2) + lane % 8) * kPitch + 8 * (m % 2);
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
          probe::smem(row)),
      "r"(in[lane * 4]), "r"(in[lane * 4 + 1]), "r"(in[lane * 4 + 2]),
      "r"(in[lane * 4 + 3])
      : "memory");
  __syncwarp();
  for (int e = lane; e < kCells * kC; e += 32) {
    out[e] = tile[(e / kC) * kPitch + e % kC];
  }
}

}  // namespace

extern "C" int probe_run(const void* in0, const void*, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  kernel<<<1, 32, 0, s>>>(static_cast<const uint32_t*>(in0),
                          static_cast<__nv_bfloat16*>(out));
  return probe::finish(s);
}
