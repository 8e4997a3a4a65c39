// The largest dynamic shared memory a block can opt into on the H100:
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) to 232,448 bytes (227
// KB, the limit B5 chunks its channels to), then one block fills all of it
// from the input and writes it out reversed, so every byte of the opt-in
// was written and read.  in and out (58112,) int32.
#include "probe.cuh"

namespace {

constexpr int kBytes = 232448, kWords = kBytes / 4;

__global__ void kernel(const uint32_t* in, uint32_t* out) {
  extern __shared__ uint32_t buf[];
  for (int e = threadIdx.x; e < kWords; e += blockDim.x) buf[e] = in[e];
  __syncthreads();
  for (int e = threadIdx.x; e < kWords; e += blockDim.x) {
    out[e] = buf[kWords - 1 - e];
  }
}

}  // namespace

extern "C" int probe_run(const void* in0, const void*, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, 1024, kBytes, s>>>(static_cast<const uint32_t*>(in0),
                                 static_cast<uint32_t*>(out));
  return probe::finish(s);
}
