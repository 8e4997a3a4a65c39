// mma.sync m16n8k16, bf16 in, f32 accumulators: D (16, 8) = A (16, 400) @
// B (400, 8), one warp, 25 k-steps of 16 (the NC layer's (p, q, c) = 400
// contraction).  Fragments are loaded straight from global memory in the
// PTX fragment layout: with g = lane / 4 and t = lane % 4,
//   a0 = A[g][k0 + 2t .. +1],  a1 = A[g + 8][k0 + 2t ..],
//   a2 = A[g][k0 + 2t + 8 ..], a3 = A[g + 8][k0 + 2t + 8 ..],
//   b0 = B[k0 + 2t .. +1][g],  b1 = B[k0 + 2t + 8 .. +1][g],
//   d0, d1 = D[g][2t .. +1],   d2, d3 = D[g + 8][2t .. +1].
#include "probe.cuh"

namespace {

constexpr int kN = 8, kKTotal = 400;

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__global__ void kernel(const __nv_bfloat16* a, const __nv_bfloat16* b,
                       float* d) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < kKTotal; k0 += 16) {
    const __nv_bfloat16* a0 = a + g * kKTotal + k0 + 2 * t;
    const __nv_bfloat16* a1 = a0 + 8 * kKTotal;
    const uint32_t ra[4] = {pack(a0[0], a0[1]), pack(a1[0], a1[1]),
                            pack(a0[8], a0[9]), pack(a1[8], a1[9])};
    const __nv_bfloat16* bk = b + (k0 + 2 * t) * kN + g;
    const uint32_t rb[2] = {pack(bk[0], bk[kN]), pack(bk[8 * kN], bk[9 * kN])};
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(ra[0]), "r"(ra[1]), "r"(ra[2]), "r"(ra[3]), "r"(rb[0]),
          "r"(rb[1]));
  }
  d[g * kN + 2 * t] = c[0];
  d[g * kN + 2 * t + 1] = c[1];
  d[(g + 8) * kN + 2 * t] = c[2];
  d[(g + 8) * kN + 2 * t + 1] = c[3];
}

}  // namespace

extern "C" int probe_run(const void* in0, const void* in1, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  kernel<<<1, 32, 0, s>>>(static_cast<const __nv_bfloat16*>(in0),
                          static_cast<const __nv_bfloat16*>(in1),
                          static_cast<float*>(out));
  return probe::finish(s);
}
