// setmaxnreg: a block of 3 warpgroups (384 threads).  Warpgroup 0, the
// producer, gives registers up (setmaxnreg.dec to 40) and stages the input
// (32, 64) f32 in shared memory, then arrives on an mbarrier (128
// arrivals); warpgroups 1 and 2, the consumers, take registers
// (setmaxnreg.inc to 232), wait on the barrier, and each of their 256
// threads ct keeps 64 sums in registers: out[ct][j] = sum over i of
// in[i][j] * (i + ct).  One if/else splits the roles and they never meet
// again, as setmaxnreg needs; the build log must not say that ptxas ignored
// it.  out (256, 64) f32.
#include "probe.cuh"

namespace {

constexpr int kRows = 32, kCols = 64;

__global__ void __launch_bounds__(384, 1)
kernel(const float* in, float* out) {
  __shared__ float data[kRows * kCols];
  __shared__ __align__(8) uint64_t ready;
  if (threadIdx.x == 0) {
    probe::mbar_init(&ready, 128);
    probe::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    for (int e = threadIdx.x; e < kRows * kCols; e += 128) data[e] = in[e];
    probe::mbar_arrive(&ready);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = threadIdx.x - 128;
    if (!probe::mbar_wait(&ready, 0)) return;
    float acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
    for (int i = 0; i < kRows; ++i) {
      const float weight = static_cast<float>(i + ct);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        acc[j] = fmaf(data[i * kCols + j], weight, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) out[ct * kCols + j] = acc[j];
  }
}

}  // namespace

extern "C" int probe_run(const void* in0, const void*, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (const int rc = probe::start(s)) return rc;
  kernel<<<1, 384, 0, s>>>(static_cast<const float*>(in0),
                           static_cast<float*>(out));
  return probe::finish(s);
}
