// mbarrier phases through a ring of 2 stages: warp 0 produces, warp 1
// consumes, 16 rounds of 32 floats.  Stage k has a "full" and an "empty"
// barrier (32 arrivals each, one per lane).  Round n uses stage n % 2; the
// producer waits "empty" with parity ((n / 2) & 1) ^ 1 (its first wait on
// each stage passes at once), writes the stage, arrives "full"; the consumer
// waits "full" with parity (n / 2) & 1, writes out[n][lane] = 2 * stage
// value, arrives "empty".  A wrong parity reads a stale or unwritten stage
// (a wrong output) or waits forever (the bounded wait's timeout code).
// in and out (16, 32) f32.
#include "probe.cuh"

namespace {

constexpr int kRounds = 16, kStages = 2;

__global__ void kernel(const float* in, float* out) {
  __shared__ float ring[kStages][32];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) {
      probe::mbar_init(&full[k], 32);
      probe::mbar_init(&empty[k], 32);
    }
    probe::fence_barrier_init();
  }
  __syncthreads();
  for (int n = 0; n < kRounds; ++n) {
    const int k = n % kStages;
    const uint32_t parity = (n / kStages) & 1;
    if (warp == 0) {
      if (!probe::mbar_wait(&empty[k], parity ^ 1)) return;
      ring[k][lane] = in[n * 32 + lane];
      probe::mbar_arrive(&full[k]);
    } else {
      if (!probe::mbar_wait(&full[k], parity)) return;
      out[n * 32 + lane] = 2.f * ring[k][lane];
      probe::mbar_arrive(&empty[k]);
    }
  }
}

}  // namespace

extern "C" int probe_run(const void* in0, const void*, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (const int rc = probe::start(s)) return rc;
  kernel<<<1, 64, 0, s>>>(static_cast<const float*>(in0),
                          static_cast<float*>(out));
  return probe::finish(s);
}
