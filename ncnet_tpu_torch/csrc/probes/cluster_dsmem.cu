// Distributed shared memory in a cluster of 2 blocks: each block stages its
// half of the input (128 f32) in shared memory, the cluster synchronises
// (barrier.cluster arrive + wait), each block reads the other's buffer
// through cluster.map_shared_rank (mapa) and writes it to its half of the
// output, and the cluster synchronises again so that no block leaves while
// its buffer is being read.  out (256,) f32 = the input's halves swapped.
#include <cooperative_groups.h>

#include "probe.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __cluster_dims__(2, 1, 1) kernel(const float* in, float* out) {
  __shared__ float buf[128];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  buf[threadIdx.x] = in[rank * 128 + threadIdx.x];
  cluster.sync();
  const float* peer = cluster.map_shared_rank(buf, rank ^ 1);
  out[rank * 128 + threadIdx.x] = peer[threadIdx.x];
  cluster.sync();
}

}  // namespace

extern "C" int probe_run(const void* in0, const void*, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  kernel<<<2, 128, 0, s>>>(static_cast<const float*>(in0),
                           static_cast<float*>(out));
  return probe::finish(s);
}
