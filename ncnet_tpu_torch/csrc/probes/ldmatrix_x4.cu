// ldmatrix.x4 from 32-byte channel rows at a padded pitch: a (29, 16) bf16
// row of cells (29 padded cells of C = 16 channels) is staged in shared
// memory with a pitch of 24 bf16 (48 bytes); the four 8 x 8 matrices are
// cells 3..10 and 11..18 (an odd offset) by channels 0..7 and 8..15:
// matrix m = cells 3 + 8 (m / 2) .., channels 8 (m % 2) ...  Lane l gives
// the address of row l % 8 of matrix l / 8 and receives, in register m,
// matrix m's row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1.
// out (32, 4, 2) bf16 = [lane][matrix][pair].
#include "probe.cuh"

namespace {

constexpr int kCells = 29, kC = 16, kPitch = 24, kCell0 = 3;

__global__ void kernel(const __nv_bfloat16* x, uint32_t* out) {
  __shared__ __align__(16) __nv_bfloat16 tile[kCells * kPitch];
  const int lane = threadIdx.x;
  for (int e = lane; e < kCells * kC; e += 32) {
    tile[(e / kC) * kPitch + e % kC] = x[e];
  }
  __syncwarp();
  const int m = lane / 8;
  const __nv_bfloat16* row =
      tile + (kCell0 + 8 * (m / 2) + lane % 8) * kPitch + 8 * (m % 2);
  uint32_t r[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(probe::smem(row)));
  for (int k = 0; k < 4; ++k) out[lane * 4 + k] = r[k];
}

}  // namespace

extern "C" int probe_run(const void* in0, const void*, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  kernel<<<1, 32, 0, s>>>(static_cast<const __nv_bfloat16*>(in0),
                          static_cast<uint32_t*>(out));
  return probe::finish(s);
}
