// One neighbourhood-consensus layer on the H100 (sm_90a):
//
//   out = bf16(relu(sum over taps and C_in of f32(x) * f32(w) + f32(b)))
//
// a same-padded 4D cross-correlation of a bf16 channels-last volume
// x (B, hA, wA, hB, wB, C_in) with bf16 weights w (k, k, k, k, C_in, C_out)
// and bias b (C_out), written to a bf16 volume out (B, hA, wA, hB, wB, C_out).
// Zero "same" padding on all four spatial dims for an odd cubic k: taps that
// fall outside the volume are skipped, no padded copy is made.
//
// Replaces the TPU kernels ncnet_tpu/ops/nc_fused_lane.py::nc_stack_resident
// (the whole NC stack in one Pallas program) and ::_conv_fused_lane (one
// layer per Pallas program): the stack wrappers in
// ncnet_tpu_torch/ops/nc_fused_lane.py launch this kernel once per layer.
//
// Its transposed variant (nc_conv4d_transpose_bf16: no bias, no ReLU) is the
// input gradient of the backward, the Γ lane of the TPU kernel
// ncnet_tpu/ops/nc_fused_lane_vjp.py::_vjp_stage: conv4d_same of the masked
// cotangent with the layer's weights flipped in all four tap dims and C_in,
// C_out swapped (ncnet_tpu_torch/ops/nc_fused_lane_vjp.py flips them).
//
// Bound: operations.  The PF-Pascal stack, kernels (5, 5, 5) and channels
// (16, 16, 1) on a 25^4 volume, counts 1.406e11 FLOP per volume at the full
// k^4 tap count (1->16: 7.8e9, 16->16: 1.25e11, 16->1: 7.8e9), so 2.81e11 FLOP
// for the two volumes of a symmetric pair, against ~25 MB of bf16 volumes
// moved: thousands of FLOP per byte, far above the card's ~295 FLOP/byte
// ridge.
//
// Design (simple first): one thread per output cell keeps its C_out sums in
// f32 registers.  The TPU kernel keeps k-row rings of every intermediate layer
// in ~13 MiB of VMEM; nothing like that fits an SM (227 KB of shared memory),
// and the 16->16 k=5 weights alone are 320 KB.  So each block stages one
// (kA, kWA) tap slab of the weights at a time in shared memory as f32
// (k^2 * C_in * C_out values: 25.6 KB for 16->16 at k=5), every thread of a
// warp reads the same weight (a broadcast), and the input channels of a tap
// come in as one or two 16-byte loads.  The FMAs run on the CUDA cores in
// f32.  The tensor-core tiled design (wgmma over a (tap, C_in) contraction,
// intermediates kept on chip across layers) is later work.  Unlike the TPU
// kernel, the per-tap partial sums are not rounded to bf16: only the layer's
// output is.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void unpack2(unsigned int u, float* v) {
  // two bf16 values, the lower address in the low half
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ unsigned int pack2(float a, float b) {
  return static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

// C_in channels of one cell as f32 (the wrapper guarantees 16-byte alignment
// of the volume, so a cell's channels are aligned to 2 * C_in bytes)
template <int CIN>
__device__ __forceinline__ void load_cin(const __nv_bfloat16* p, float* v) {
  if constexpr (CIN % 8 == 0) {
#pragma unroll
    for (int c = 0; c < CIN; c += 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + c));
      unpack2(u.x, v + c);
      unpack2(u.y, v + c + 2);
      unpack2(u.z, v + c + 4);
      unpack2(u.w, v + c + 6);
    }
  } else if constexpr (CIN % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CIN; c += 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + c));
      unpack2(u.x, v + c);
      unpack2(u.y, v + c + 2);
    }
  } else if constexpr (CIN % 2 == 0) {
#pragma unroll
    for (int c = 0; c < CIN; c += 2)
      unpack2(__ldg(reinterpret_cast<const unsigned int*>(p + c)), v + c);
  } else {
#pragma unroll
    for (int c = 0; c < CIN; ++c) v[c] = __bfloat162float(p[c]);
  }
}

template <int COUT>
__device__ __forceinline__ void store_cout(__nv_bfloat16* o, const float* v) {
  if constexpr (COUT % 8 == 0) {
#pragma unroll
    for (int c = 0; c < COUT; c += 8)
      *reinterpret_cast<uint4*>(o + c) =
          make_uint4(pack2(v[c], v[c + 1]), pack2(v[c + 2], v[c + 3]),
                     pack2(v[c + 4], v[c + 5]), pack2(v[c + 6], v[c + 7]));
  } else if constexpr (COUT % 2 == 0) {
#pragma unroll
    for (int c = 0; c < COUT; c += 2)
      *reinterpret_cast<unsigned int*>(o + c) = pack2(v[c], v[c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < COUT; ++c) o[c] = __float2bfloat16_rn(v[c]);
  }
}

template <int K, int CIN, int COUT, bool BIAS_RELU>
__global__ void __launch_bounds__(kThreads)
nc_conv4d_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int B, int hA, int wA,
                 int hB, int wB) {
  constexpr int D = K / 2;
  constexpr int SLAB = K * K * CIN * COUT;  // one (p, q) slab: (r, s, ci, co)
  __shared__ __align__(16) float wsm[SLAB];

  const int64_t n_cells = static_cast<int64_t>(B) * hA * wA * hB * wB;
  const int64_t cell =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = cell < n_cells;

  int64_t t = active ? cell : 0;
  const int l = static_cast<int>(t % wB);
  t /= wB;
  const int kk = static_cast<int>(t % hB);
  t /= hB;
  const int j = static_cast<int>(t % wA);
  t /= wA;
  const int i = static_cast<int>(t % hA);
  const int64_t b = t / hA;

  // element strides of the channels-last input volume
  const int64_t s_l = CIN;
  const int64_t s_k = static_cast<int64_t>(wB) * s_l;
  const int64_t s_j = static_cast<int64_t>(hB) * s_k;
  const int64_t s_i = static_cast<int64_t>(wA) * s_j;
  const int64_t s_b = static_cast<int64_t>(hA) * s_i;

  float acc[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) acc[co] = 0.f;

  // the (p, q) loops run the same trip count in every thread of the block,
  // so every thread reaches every barrier; only the work inside is masked
  for (int p = 0; p < K; ++p) {
    for (int q = 0; q < K; ++q) {
      __syncthreads();  // the previous slab is no longer read
      const __nv_bfloat16* wslab =
          w + static_cast<int64_t>(p * K + q) * SLAB;
      for (int e = threadIdx.x; e < SLAB; e += kThreads)
        wsm[e] = __bfloat162float(wslab[e]);
      __syncthreads();

      const int ii = i + p - D;
      const int jj = j + q - D;
      if (!active || ii < 0 || ii >= hA || jj < 0 || jj >= wA) continue;
      const __nv_bfloat16* xrow = x + b * s_b + ii * s_i + jj * s_j;
      for (int r = 0; r < K; ++r) {
        const int k2 = kk + r - D;
        if (k2 < 0 || k2 >= hB) continue;
        for (int s = 0; s < K; ++s) {
          const int l2 = l + s - D;
          if (l2 < 0 || l2 >= wB) continue;
          float xv[CIN];
          load_cin<CIN>(xrow + k2 * s_k + l2 * s_l, xv);
          const float* wt = wsm + (r * K + s) * (CIN * COUT);
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci) {
#pragma unroll
            for (int co = 0; co < COUT; ++co)
              acc[co] = fmaf(xv[ci], wt[ci * COUT + co], acc[co]);
          }
        }
      }
    }
  }
  if (!active) return;
  if constexpr (BIAS_RELU) {
#pragma unroll
    for (int co = 0; co < COUT; ++co)
      acc[co] = fmaxf(acc[co] + __bfloat162float(bias[co]), 0.f);
  }
  store_cout<COUT>(out + cell * COUT, acc);
}

template <int K, int CIN, int COUT, bool BIAS_RELU>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int B, int hA, int wA, int hB, int wB,
                   cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(B) * hA * wA * hB * wB;
  if (n <= 0) return cudaSuccess;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  nc_conv4d_kernel<K, CIN, COUT, BIAS_RELU>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out),
      B, hA, wA, hB, wB);
  return cudaGetLastError();
}

}  // namespace

// The (k, C_in, C_out) layer shapes compiled in: the PF-Pascal stack
// (5: 1->16, 16->16, 16->1), the IVD/InLoc stack (3: 1->16, 16->1), the
// default ModelConfig stack (3: 1->10, 10->10, 10->1), and the thin test
// stacks (channels 1, 2 and 4 at k = 3 and 5).  The transposed variant is
// compiled for the transpose (k, C_out, C_in) of each, and
// csrc/nc_conv4d_vjp.cu repeats this list.
#define NC_CONV4D_SHAPES(X)                                                  \
  X(5, 1, 16) X(5, 16, 16) X(5, 16, 1)                                       \
  X(3, 1, 16) X(3, 16, 16) X(3, 16, 1)                                       \
  X(3, 1, 10) X(3, 10, 10) X(3, 10, 1)                                       \
  X(3, 1, 1) X(3, 1, 2) X(3, 1, 4) X(3, 2, 1) X(3, 2, 2) X(3, 4, 1)          \
  X(3, 4, 2) X(3, 4, 4)                                                      \
  X(5, 1, 1) X(5, 1, 2) X(5, 1, 4) X(5, 2, 1) X(5, 2, 2) X(5, 4, 1)          \
  X(5, 4, 2) X(5, 4, 4)

extern "C" {

// 1 when the layer shape is compiled in, else 0
int nc_conv4d_supported(int k, int c_in, int c_out) {
#define NC_SUPPORTED(K, CI, CO) \
  if (k == K && c_in == CI && c_out == CO) return 1;
  NC_CONV4D_SHAPES(NC_SUPPORTED)
#undef NC_SUPPORTED
  return 0;
}

// Enqueues one layer on `stream`; returns the cudaError_t of the launch
// (0 on success), or -1 for a shape that is not compiled in.
int nc_conv4d_bf16(const void* x, const void* w, const void* b, void* out,
                   int B, int hA, int wA, int hB, int wB, int k, int c_in,
                   int c_out, void* stream) {
#define NC_LAUNCH(K, CI, CO)                                              \
  if (k == K && c_in == CI && c_out == CO)                                \
    return static_cast<int>(launch<K, CI, CO, true>(                      \
        x, w, b, out, B, hA, wA, hB, wB, static_cast<cudaStream_t>(stream)));
  NC_CONV4D_SHAPES(NC_LAUNCH)
#undef NC_LAUNCH
  return -1;
}

// The input gradient of a forward layer (k, c_in, c_out): enqueues
// out = bf16(conv4d_same(gz, wt)) with no bias and no ReLU, gz (B, hA, wA,
// hB, wB, c_out) bf16, wt (k, k, k, k, c_out, c_in) the flipped, channel-
// swapped weights, out (B, hA, wA, hB, wB, c_in).  Returns the cudaError_t
// of the launch, or -1 for a shape that is not compiled in (the forward
// shape (k, c_in, c_out) is, exactly when nc_conv4d_supported says so).
int nc_conv4d_transpose_bf16(const void* gz, const void* wt, void* out, int B,
                             int hA, int wA, int hB, int wB, int k, int c_in,
                             int c_out, void* stream) {
#define NC_LAUNCH_T(K, CI, CO)                                            \
  if (k == K && c_in == CI && c_out == CO)                                \
    return static_cast<int>(launch<K, CO, CI, false>(                     \
        gz, wt, nullptr, out, B, hA, wA, hB, wB,                          \
        static_cast<cudaStream_t>(stream)));
  NC_CONV4D_SHAPES(NC_LAUNCH_T)
#undef NC_LAUNCH_T
  return -1;
}

const char* nc_conv4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
