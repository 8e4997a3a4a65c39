// Backward of one neighbourhood-consensus layer on the H100 (sm_90a): the
// ReLU mask, the weight and bias gradients.  For the layer
//
//   y = bf16(relu(conv4d_same(x, w) + b))
//
// with bf16 input x (B, hA, wA, hB, wB, C_in), its saved bf16 output y and
// the bf16 cotangent g of y (both (B, hA, wA, hB, wB, C_out)):
//
//   gz = g where y > 0, else 0                        (bf16, written out)
//   dW[p, q, r, s, ci, co] = sum over cells of
//        x[cell + (p, q, r, s) - k/2, ci] * gz[cell, co]   (f32 sums)
//   db[co] = sum over cells of gz[cell, co]                 (f32 sums)
//
// The input gradient, conv4d_same(gz, w flipped in all four tap dims with
// C_in and C_out swapped) with no bias and no ReLU, is the forward kernel
// of csrc/nc_conv4d.cu in its transposed variant (nc_conv4d_transpose_bf16).
//
// Replaces the TPU kernel ncnet_tpu/ops/nc_fused_lane_vjp.py::_vjp_stage
// (its _vjp_stage_kernel: mask, dW/db accumulation and the Γ lane, one
// pallas_call per layer), driven by nc_stack_fused_vjp.  The wrappers are in
// ncnet_tpu_torch/ops/nc_fused_lane_vjp.py.
//
// Bound: operations.  For the PF-Pascal stack (k = 5, channels 16, 16, 1)
// on the 8 volumes of 25^4 of one training chunk, dW of all layers counts
// 9.24e11 FLOP and the input gradients of layers 2 and 1 8.73e11, so the
// backward is ~1.80e12 FLOP against ~1.3e7 bytes of bf16 volumes: ~1e5
// FLOP per byte, far above the card's ~295 FLOP/byte ridge.
//
// Design (simple first).  The TPU kernel replays the forward in VMEM rings
// and carries dW in one resident accumulator across its sequential grid.
// Neither carries over: the port's autograd Function saves the forward's
// bf16 layer outputs (the mask is y > 0, the same cells as the TPU's
// bf16(z) > 0), and blocks on Hopper run in no order.  So:
//
//   * nc_vjp_dw_kernel: grid (P, k*k).  Block (part, (p, q)) walks the
//     (b, i, j) planes part, part + P, ...; for each it stages the masked
//     cotangent plane gz[b, i, j] (hB x wB x C_out) and the input plane
//     x[b, i + p - k/2, j + q - k/2] with a zero halo of k/2 cells in
//     shared memory as f32, and each thread keeps a C_in-tile x C_out-tile
//     register block of dW for one (r, s) tap: per cell one vector load of
//     x, one of gz, then TCI * TCO FMAs on the CUDA cores in f32.  Planes
//     whose shifted input plane lies outside the volume are skipped (their
//     taps add nothing).  The centre-tap block of each part also writes gz
//     to device memory (for the input gradient) and sums db.  Each block
//     writes its f32 partial dW slab (and db) to partial row `part`.
//   * nc_vjp_reduce_kernel: out[e] = sum over part = 0..P-1 of partial[part][e]
//     in that fixed order.
//
// No float atomics: every sum has one order, so two runs give bit-identical
// gradients.  The partial buffer is P * (k^4 * C_in * C_out + C_out) f32:
// 41 MB for the 16->16 layer at P = 64.  The tensor-core design (wgmma with
// the cells as the contraction) is later work.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// the largest dynamic shared memory a block may ask for on Hopper
constexpr int kMaxSmemBytes = 232448;

template <int C>
struct TileOf {
  static constexpr int value = (C % 4 == 0) ? 4 : (C % 2 == 0) ? 2 : 1;
};

// N consecutive f32 values of shared memory (16- or 8-byte aligned for N = 4, 2)
template <int N>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else if constexpr (N == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  } else {
    v[0] = p[0];
  }
}

template <int K, int CIN, int COUT>
struct DwShape {
  static constexpr int D = K / 2;
  static constexpr int TCI = TileOf<CIN>::value;
  static constexpr int TCO = TileOf<COUT>::value;
  static constexpr int NCI = CIN / TCI;
  static constexpr int NCO = COUT / TCO;
  static constexpr int ITEMS = K * K * NCI * NCO;  // (r, s, ci tile, co tile)
  static constexpr int THREADS = (ITEMS + 31) / 32 * 32;
  static constexpr int NW = K * K * K * K * CIN * COUT;
};

__host__ __device__ inline int xs_floats(int k, int c_in, int hB, int wB) {
  // the padded input plane, rounded up to 4 floats so the cotangent plane
  // after it stays 16-byte aligned
  return ((hB + k - 1) * (wB + k - 1) * c_in + 3) / 4 * 4;
}

template <int K, int CIN, int COUT>
__global__ void __launch_bounds__(DwShape<K, CIN, COUT>::THREADS)
nc_vjp_dw_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ y,
                 const __nv_bfloat16* __restrict__ g,
                 __nv_bfloat16* __restrict__ gz,
                 float* __restrict__ partial, int B, int hA, int wA, int hB,
                 int wB) {
  using S = DwShape<K, CIN, COUT>;
  constexpr int D = S::D, TCI = S::TCI, TCO = S::TCO;
  extern __shared__ __align__(16) float smem[];
  const int wp = wB + 2 * D;
  const int n_cells = hB * wB;
  float* xs = smem;                                // (hB + 2D, wB + 2D, CIN)
  float* gs = smem + xs_floats(K, CIN, hB, wB);    // (hB, wB, COUT)

  const int part = blockIdx.x;
  const int n_parts = gridDim.x;
  const int p = blockIdx.y / K, q = blockIdx.y % K;
  const bool centre = p == D && q == D;
  const int tid = threadIdx.x;

  // the halo stays zero: plane staging below writes only the interior
  for (int e = tid; e < (hB + 2 * D) * wp * CIN; e += blockDim.x) xs[e] = 0.f;

  const bool worker = tid < S::ITEMS;
  int item = worker ? tid : 0;
  const int cot = item % S::NCO;
  item /= S::NCO;
  const int cit = item % S::NCI;
  item /= S::NCI;
  const int s = item % K;
  const int r = item / K;
  const bool db_thread = centre && worker && r == 0 && s == 0 && cit == 0;

  float acc[TCI][TCO];
#pragma unroll
  for (int a = 0; a < TCI; ++a)
#pragma unroll
    for (int c = 0; c < TCO; ++c) acc[a][c] = 0.f;
  float dbacc[TCO];
#pragma unroll
  for (int c = 0; c < TCO; ++c) dbacc[c] = 0.f;

  const int64_t n_planes = static_cast<int64_t>(B) * hA * wA;
  for (int64_t plane = part; plane < n_planes; plane += n_parts) {
    const int j = static_cast<int>(plane % wA);
    const int i = static_cast<int>((plane / wA) % hA);
    const int64_t b = plane / (static_cast<int64_t>(hA) * wA);
    const int ii = i + p - D, jj = j + q - D;
    // the same test in every thread of the block: all skip, or none does
    if (ii < 0 || ii >= hA || jj < 0 || jj >= wA) continue;
    __syncthreads();  // the previous plane is no longer read

    const int64_t gbase = plane * n_cells * COUT;
    for (int e = tid; e < n_cells * COUT; e += blockDim.x) {
      const float v = __bfloat162float(y[gbase + e]) > 0.f
                          ? __bfloat162float(g[gbase + e])
                          : 0.f;
      gs[e] = v;
      if (centre) gz[gbase + e] = __float2bfloat16_rn(v);
    }
    const int64_t xbase =
        ((b * hA + ii) * static_cast<int64_t>(wA) + jj) * n_cells * CIN;
    for (int e = tid; e < n_cells * CIN; e += blockDim.x) {
      const int c = e % CIN;
      const int cell = e / CIN;
      xs[((cell / wB + D) * wp + cell % wB + D) * CIN + c] =
          __bfloat162float(x[xbase + e]);
    }
    __syncthreads();

    if (worker) {
      for (int kk = 0; kk < hB; ++kk) {
        const float* xrow = xs + ((kk + r) * wp + s) * CIN + cit * TCI;
        const float* grow = gs + kk * wB * COUT + cot * TCO;
        for (int l = 0; l < wB; ++l) {
          float xv[TCI], gv[TCO];
          lds<TCI>(xrow + l * CIN, xv);
          lds<TCO>(grow + l * COUT, gv);
#pragma unroll
          for (int a = 0; a < TCI; ++a)
#pragma unroll
            for (int c = 0; c < TCO; ++c)
              acc[a][c] = fmaf(xv[a], gv[c], acc[a][c]);
        }
      }
      if (db_thread) {
        for (int cell = 0; cell < n_cells; ++cell) {
          float gv[TCO];
          lds<TCO>(gs + cell * COUT + cot * TCO, gv);
#pragma unroll
          for (int c = 0; c < TCO; ++c) dbacc[c] += gv[c];
        }
      }
    }
  }

  if (!worker) return;
  float* out = partial + static_cast<int64_t>(part) * (S::NW + COUT);
#pragma unroll
  for (int a = 0; a < TCI; ++a)
#pragma unroll
    for (int c = 0; c < TCO; ++c) {
      const int ci = cit * TCI + a, co = cot * TCO + c;
      out[((((p * K + q) * K + r) * K + s) * CIN + ci) * COUT + co] = acc[a][c];
    }
  if (db_thread) {
#pragma unroll
    for (int c = 0; c < TCO; ++c) out[S::NW + cot * TCO + c] = dbacc[c];
  }
}

__global__ void nc_vjp_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int n,
                                     int n_parts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int part = 0; part < n_parts; ++part)
    sum += partial[static_cast<int64_t>(part) * n + e];
  out[e] = sum;
}

template <int K, int CIN, int COUT>
cudaError_t launch_dw(const void* x, const void* y, const void* g, void* gz,
                      void* partial, int B, int hA, int wA, int hB, int wB,
                      int n_parts, cudaStream_t stream) {
  using S = DwShape<K, CIN, COUT>;
  if (static_cast<int64_t>(B) * hA * wA * hB * wB <= 0 || n_parts <= 0)
    return cudaErrorInvalidValue;
  const int64_t smem =
      4 * (static_cast<int64_t>(xs_floats(K, CIN, hB, wB)) + hB * wB * COUT);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = nc_vjp_dw_kernel<K, CIN, COUT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(n_parts, K * K), S::THREADS, static_cast<size_t>(smem),
           stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(gz),
      static_cast<float*>(partial), B, hA, wA, hB, wB);
  return cudaGetLastError();
}

}  // namespace

// The (k, C_in, C_out) layer shapes compiled in: the forward's list in
// csrc/nc_conv4d.cu (NC_CONV4D_SHAPES), kept the same by hand.
#define NC_VJP_SHAPES(X)                                                     \
  X(5, 1, 16) X(5, 16, 16) X(5, 16, 1)                                       \
  X(3, 1, 16) X(3, 16, 16) X(3, 16, 1)                                       \
  X(3, 1, 10) X(3, 10, 10) X(3, 10, 1)                                       \
  X(3, 1, 1) X(3, 1, 2) X(3, 1, 4) X(3, 2, 1) X(3, 2, 2) X(3, 4, 1)          \
  X(3, 4, 2) X(3, 4, 4)                                                      \
  X(5, 1, 1) X(5, 1, 2) X(5, 1, 4) X(5, 2, 1) X(5, 2, 2) X(5, 4, 1)          \
  X(5, 4, 2) X(5, 4, 4)

extern "C" {

// 1 when the layer shape is compiled in, else 0
int nc_vjp_supported(int k, int c_in, int c_out) {
#define NC_SUPPORTED(K, CI, CO) \
  if (k == K && c_in == CI && c_out == CO) return 1;
  NC_VJP_SHAPES(NC_SUPPORTED)
#undef NC_SUPPORTED
  return 0;
}

// Shared memory one dW block needs, in bytes (the launch refuses more than
// 232448)
long long nc_vjp_dw_smem_bytes(int k, int c_in, int c_out, int hB, int wB) {
  return 4LL * (xs_floats(k, c_in, hB, wB) + static_cast<long long>(hB) * wB * c_out);
}

// Enqueues the mask + dW/db partials of one layer on `stream`: writes gz
// (B, hA, wA, hB, wB, C_out) bf16 and partial (n_parts, k^4*C_in*C_out +
// C_out) f32.  Returns the launch's cudaError_t (0 on success), or -1 for a
// shape that is not compiled in.
int nc_vjp_dw_bf16(const void* x, const void* y, const void* g, void* gz,
                   void* partial, int B, int hA, int wA, int hB, int wB, int k,
                   int c_in, int c_out, int n_parts, void* stream) {
#define NC_LAUNCH(K, CI, CO)                                                  \
  if (k == K && c_in == CI && c_out == CO)                                    \
    return static_cast<int>(launch_dw<K, CI, CO>(                             \
        x, y, g, gz, partial, B, hA, wA, hB, wB, n_parts,                     \
        static_cast<cudaStream_t>(stream)));
  NC_VJP_SHAPES(NC_LAUNCH)
#undef NC_LAUNCH
  return -1;
}

// Enqueues out[e] = sum over part of partial[part][e], e < n, in part order.
int nc_vjp_reduce_f32(const void* partial, void* out, int n, int n_parts,
                      void* stream) {
  if (n <= 0 || n_parts <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int threads = 256;
  nc_vjp_reduce_kernel<<<(n + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n,
      n_parts);
  return static_cast<int>(cudaGetLastError());
}

const char* nc_vjp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
