// The L2 layer probe's conv (16 -> 16 channels, k = 5, a 25^4 volume) in the
// padded fused-lane frame, on the H100 (sm_90a):
//
//   out[b, i, j, o, t] = bf16(mask[t] * relu(bias[o] + sum over (r, s),
//       r-major, of YDT(Y[(r, s, o), t - 60 + 29 r + s])))           t in [60, 781)
//   Y[(r, s, o), l]    = sum over (p, q, c) of w2[(p, q, c), (r, s, o)]
//                                              * xp[b, i + p, j + q, c, l]   (f32)
//
// xp (B, 29, 29, 16, 841) bf16: the volume zero-padded by 2 on every spatial
// dim, (hB, wB) fused into 841 = 29 * 29 lanes; w2 (400, 400) bf16 =
// w[(p, q, c), (r, s, o)]; out (B, 25, 25, 16, 841) bf16, lanes outside
// [60, 781) zero.  YDT is bf16 (ROUND_Y) or f32: the rounding of each Y term
// is part of the function.  The (p, q, c) sum is f32, the (r, s) sum f32 in
// the JAX loop's order.
//
// Replaces the TPU kernel tools/pallas_l2_probe.py::conv_l2_pallas (its
// pallas_call), the probe from which the TPU's fused-lane NC layer was
// designed: the (p, q, c) = 400 contraction against N = (r, s, o) = 400 for
// each 841-lane row, then the B-side taps (r, s) as lane-offset shift-adds.
//
// Bound: operations.  At B = 8 the layer's own work, counting only taps
// inside the volume, is 2 * 8 * 119^4 * 16 * 16 = 8.21e11 FLOP: 0.830 ms at
// 989 TFLOP/s bf16, while its 181 MB in and 135 MB out take 0.094 ms at
// 3.35 TB/s.
//
// Design.  A CUDA core has no MXU rows to fill, so this kernel computes only
// the Y terms an output uses (each Y element feeds exactly one output: the
// GEMM's other 14 % of N x lanes fall on the halo and are never formed).  A
// block owns one (b, i, j) row's tile of T = 128 output lanes and all 16
// output channels; a thread owns 4 channels x 4 consecutive lanes.  For each
// r (the Y rounding needs the whole (p, q, c) sum of a term before the (r,
// s) sum), the thread keeps the 5 s-terms of its 16 outputs in 80 f32
// registers; the (p, q, c) sum runs over p in 5 stages.  A stage puts in
// shared memory the 80 (q, c) input rows' window of T + 4 lanes that this r
// reads (bf16, 21.8 KB) and the 80 x 80 weights w2[(p, q, c), (r, s, o)] as
// f32 (25.6 KB, from the wrapper's re-laid copy), so three blocks fit an
// SM.  Per (q, c) row a thread reads 8 staged lanes once and uses each for
// up to 4 (s, lane) pairs: 80 FMAs per 2 8-byte and 5 16-byte shared loads.
// After the 5 stages each s-term is rounded to YDT and added to the output
// sums, s ascending, r ascending.  The epilogue adds the bias, applies
// ReLU and the mask, and rounds once to bf16; the lanes outside [60, 781)
// are written as zeros.  Every output sums its terms in one fixed order, so
// two launches are bit-identical.  A later kernel (ROADMAP B6) takes the
// tensor cores: this one measures what the GEMM formulation costs on CUDA
// cores.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kS = 25;            // output cells per spatial dim
constexpr int kK = 5;             // kernel size
constexpr int kC = 16;            // channels in and out
constexpr int kSP = kS + kK - 1;  // 29 padded cells per spatial dim
constexpr int kKL = kSP * kSP;    // 841 fused (hB, wB) lanes
constexpr int kLo = 2 * kSP + 2;  // 60: the first interior lane
constexpr int kHi = kLo + (kS - 1) * kSP + kS;  // 781: one past the last
constexpr int kT = 128;           // output lanes per block
constexpr int kTiles = (kHi - kLo + kT - 1) / kT;  // 6
constexpr int kTW = kT + kK - 1;  // 132 staged lanes per row (s = 0..4)
constexpr int kXP = 136;          // staged row pitch, bf16 (16-byte rows)
constexpr int kRows = kK * kC;    // 80 (q, c) rows per stage
constexpr int kWS = kRows * kK * kC;  // 6400 staged weights: [(q, c)][s][o]
constexpr int kThreads = 128;

__device__ __forceinline__ float lo_bf16(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

template <bool ROUND_Y>
__device__ __forceinline__ float round_y(float v) {
  if constexpr (ROUND_Y) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// wr: the weights re-laid by the wrapper as f32 [r][p][(q, c)][s][o], so a
// stage's 6400 weights are one contiguous run.
template <bool ROUND_Y>
__global__ void __launch_bounds__(kThreads, 3)
conv_l2_kernel(const __nv_bfloat16* __restrict__ xp,
               const float* __restrict__ wr, const float* __restrict__ bias,
               const float* __restrict__ mask,
               __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 xs[kRows * kXP];
  __shared__ __align__(16) float ws[kWS];

  const int tile = blockIdx.x;
  const int i = blockIdx.y / kS, j = blockIdx.y % kS;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp holds 16 lane groups x 2 channel groups, so its shared loads of
  // a row are 16 distinct 8-byte words (one wavefront), each read by 2
  const int og = 2 * (warp & 1) + (lane >> 4);     // channels 4og .. 4og+3
  const int tg = (lane & 15) + 16 * (warp >> 1);   // lanes t0 + 4tg .. +3
  const int t0 = kLo + tile * kT;

  float sum[4][4];  // [o][m]: the output sums, r-major over (r, s)
#pragma unroll
  for (int o = 0; o < 4; ++o)
#pragma unroll
    for (int m = 0; m < 4; ++m) sum[o][m] = 0.f;

  for (int r = 0; r < kK; ++r) {
    float acc[kK][4][4];  // [s][o][m]: the Y terms of this r
#pragma unroll
    for (int s = 0; s < kK; ++s)
#pragma unroll
      for (int o = 0; o < 4; ++o)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[s][o][m] = 0.f;

    // staged lane x holds fused lane l0 + x; output lane t0 + 4tg + m at
    // tap s reads staged lane 4tg + m + s
    const int l0 = t0 - kLo + r * kSP;
    for (int p = 0; p < kK; ++p) {
      __syncthreads();  // the previous stage's reads are done
      // rows (q, c) of xp[b, i + p, j + q, c, :] are consecutive
      const __nv_bfloat16* src =
          xp + ((static_cast<size_t>(b) * kSP + i + p) * kSP + j) * kC * kKL;
      for (int e = tid; e < kRows * kTW; e += kThreads) {
        const int row = e / kTW, x = e - row * kTW;
        const int l = l0 + x;
        xs[row * kXP + x] = l < kKL ? src[static_cast<size_t>(row) * kKL + l]
                                    : __float2bfloat16_rn(0.f);
      }
      const float4* wsrc =
          reinterpret_cast<const float4*>(wr + (r * kK + p) * kWS);
      for (int e = tid; e < kWS / 4; e += kThreads) {
        reinterpret_cast<float4*>(ws)[e] = __ldg(wsrc + e);
      }
      __syncthreads();

#pragma unroll 2
      for (int k = 0; k < kRows; ++k) {
        const uint2* xr = reinterpret_cast<const uint2*>(xs + k * kXP + 4 * tg);
        const uint2 u0 = xr[0], u1 = xr[1];
        const float xv[8] = {lo_bf16(u0.x), hi_bf16(u0.x), lo_bf16(u0.y),
                             hi_bf16(u0.y), lo_bf16(u1.x), hi_bf16(u1.x),
                             lo_bf16(u1.y), hi_bf16(u1.y)};
#pragma unroll
        for (int s = 0; s < kK; ++s) {
          const float4 wv = *reinterpret_cast<const float4*>(
              ws + (k * kK + s) * kC + 4 * og);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            acc[s][0][m] = fmaf(wv.x, xv[s + m], acc[s][0][m]);
            acc[s][1][m] = fmaf(wv.y, xv[s + m], acc[s][1][m]);
            acc[s][2][m] = fmaf(wv.z, xv[s + m], acc[s][2][m]);
            acc[s][3][m] = fmaf(wv.w, xv[s + m], acc[s][3][m]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kK; ++s)
#pragma unroll
      for (int o = 0; o < 4; ++o)
#pragma unroll
        for (int m = 0; m < 4; ++m) sum[o][m] += round_y<ROUND_Y>(acc[s][o][m]);
  }

  __nv_bfloat16* dst =
      out + ((static_cast<size_t>(b) * kS + i) * kS + j) * kC * kKL;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int ch = 4 * og + o;
    const float bo = bias[ch];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int t = t0 + 4 * tg + m;
      if (t < kHi) {
        dst[ch * kKL + t] =
            __float2bfloat16_rn(fmaxf(sum[o][m] + bo, 0.f) * mask[t]);
      } else if (t < kKL) {
        dst[ch * kKL + t] = zero;
      }
    }
  }
  // the halo lanes no tile covers: [0, 60) and [60 + 6 * 128, 841)
  if (tile == 0) {
    for (int e = tid; e < kC * kLo; e += kThreads) {
      dst[(e / kLo) * kKL + e % kLo] = zero;
    }
  }
  constexpr int kTail = kKL - (kLo + kTiles * kT);
  if (kTail > 0 && tile == kTiles - 1) {
    for (int e = tid; e < kC * kTail; e += kThreads) {
      dst[(e / kTail) * kKL + kKL - kTail + e % kTail] = zero;
    }
  }
}

}  // namespace

extern "C" {

// One launch on `stream`; returns cudaGetLastError() (0 on success).
int conv_l2_fused_lane(const void* xp, const void* wr, const void* bias,
                       const void* mask, void* out, int batch, int round_y,
                       void* stream) {
  const dim3 grid(kTiles, kS * kS, batch);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(xp);
  const auto* w = static_cast<const float*>(wr);
  const auto* bi = static_cast<const float*>(bias);
  const auto* mk = static_cast<const float*>(mask);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (round_y) {
    conv_l2_kernel<true><<<grid, kThreads, 0, s>>>(x, w, bi, mk, o);
  } else {
    conv_l2_kernel<false><<<grid, kThreads, 0, s>>>(x, w, bi, mk, o);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* conv_l2_fused_lane_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
