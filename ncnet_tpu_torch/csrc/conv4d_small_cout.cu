// A same-padded 4D convolution with few output channels on the H100 (sm_90a):
//
//   out = T(sum over taps and C_in of f32(x) * f32(w))
//
// x (B, hA, wA, hB, wB, C_in) channels-last in T (float or bf16), w (k, k, k,
// k, C_in, C_out) already cast to T by the wrapper, out (B, hA, wA, hB, wB,
// C_out) in T.  Zero "same" padding on all four spatial dims for an odd cubic
// k: taps outside the volume read zeros, no padded copy is made.  No bias.
//
// Replaces the TPU kernel ncnet_tpu/ops/conv4d_pallas.py::_fwd_impl (the
// pallas_call behind conv4d_small_cout), which conv4d(variant="auto") picks
// for every same-padded, cubic, odd layer with C_out <= 4: the NC stack's
// 16->1 layer whenever the stack runs per layer (fp32 stacks the arithmetic
// tiers do not take, e.g. the PF-Pascal model at 50^4).
//
// Bound: operations.  On the path, (4, 50^4, 16) -> 1 in f32 at k = 5 needs
// 2 * 4 * 244^4 * 16 = 4.54e11 FLOP for the taps inside the volume against
// 1.7e9 bytes moved: 267 FLOP per byte, above the f32 CUDA-core ridge of
// 67e12 / 3.35e12 = 20, so 6.77 ms at 67 TFLOP/s.
//
// Design.  The TPU kernel folds the (kA, kB, kWB) taps into the matmul's N
// dimension and resolves the shifts in a VMEM epilogue, so that the 128-lane
// MXU is full at C_out = 1.  A CUDA core has no lanes to fill, so this kernel
// keeps the direct form and spends its effort on reuse.  A block owns one
// (b, i, j) output plane's tile of KT rows along hB by LT strips of R = 4
// cells along wB; a thread owns one strip, R x COC f32 sums (COC <= 4 output
// channels; a larger C_out runs in chunks of 4 over blockIdx.y).  For each
// in-volume (p, q) tap pair, uniform over the block, the block stages the
// input slab the tile reads, (KT + k - 1) rows by (LT * R + k - 1) cells by
// a chunk of C_in, into shared memory as f32 (zeros outside the volume),
// and the (p, q) slab of the weights for that chunk beside it; every
// thread then runs its (r, s, channel) taps from shared memory, loading the
// R + k - 1 cells of a row and channel group once and reusing each for the
// k taps s that touch it, so each input byte crosses from L2 once per
// (p, q) and block instead of once per thread and tap.  The chunk is as
// many groups of 4 channels as fit the card's 227 KB of shared memory
// beside the weights (all of them for the NC stack's 16 channels; C_in =
// 64 at wB = 50 and k = 5 runs two chunks), and the accumulators persist
// across chunks.  Rows of the staged slab are padded to 16 bytes past a
// multiple of 128, and neighbouring threads own neighbouring rows, so a
// warp's 16-byte loads hit distinct banks.  A plane narrower than 256
// cells leaves threads idle (a 6^4 volume runs blocks of 12 threads).
// k = 1, 3, 5, 7 are compiled with the strip's cells held in registers;
// any other odd k up to kMaxK runs the same loop reading the cells from
// shared memory.  At k = kMaxK one group of 4 channels still fits at every
// tile shape; a larger k is refused (the chooser in ops/conv4d.py never
// sends one).  Every output sums its terms in one fixed order (p, q, the
// chunk, r, the channel group, s, the channel in the group), so two
// launches are bit-identical.  The sums are f32 and are rounded to T once.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 4;      // R: output cells along wB per thread
constexpr int kMaxStrips = 64;  // LT cap: strips along wB per block
constexpr int kMaxK = 27;       // the largest kernel size a launch takes
constexpr int kSmemLimit = 232448;  // shared memory one block may use

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// channels c0 .. c0 + 3 of one cell as f32; VEC: all four exist and are
// aligned (C_in % 4 == 0), else the missing ones read 0
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int c0, int cin) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const float4*>(p + c0));
  } else {
    float4 v;
    v.x = c0 < cin ? __ldg(p + c0) : 0.f;
    v.y = c0 + 1 < cin ? __ldg(p + c0 + 1) : 0.f;
    v.z = c0 + 2 < cin ? __ldg(p + c0 + 2) : 0.f;
    v.w = c0 + 3 < cin ? __ldg(p + c0 + 3) : 0.f;
    return v;
  }
}

template <bool VEC>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int c0,
                                        int cin) {
  if constexpr (VEC) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + c0));
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  } else {
    float4 v;
    v.x = c0 < cin ? __bfloat162float(p[c0]) : 0.f;
    v.y = c0 + 1 < cin ? __bfloat162float(p[c0 + 1]) : 0.f;
    v.z = c0 + 2 < cin ? __bfloat162float(p[c0 + 2]) : 0.f;
    v.w = c0 + 3 < cin ? __bfloat162float(p[c0 + 3]) : 0.f;
    return v;
  }
}

// The block tile and shared-memory plan of one launch shape, the same on
// the host (launch size) and the device (indexing).
struct Plan {
  int lt, kt;       // strips per block along wB, rows per block along hB
  int n_lt, n_kt;   // tiles along wB and hB
  int cgn;          // channel groups of 4 (C_in rounded up)
  int cgc;          // channel groups staged at once (a chunk)
  int n_cc;         // chunks: cgn / cgc rounded up
  int cells;        // staged cells per row: lt * R + k - 1
  int cgs;          // channel-group stride in float4 units, = 2 (mod 8)
  int rs;           // row stride in float4 units, = 1 (mod 8)
  int x_f4;         // staged slab size in float4 units
  int w_floats;     // weight slab size in floats (one chunk)
};

__host__ __device__ inline Plan make_plan(int k, int hB, int wB, int cin,
                                          int coc) {
  Plan pl;
  const int n_strips = (wB + kStrip - 1) / kStrip;
  pl.lt = n_strips < kMaxStrips ? n_strips : kMaxStrips;
  pl.kt = kThreads / pl.lt;
  if (pl.kt > hB) pl.kt = hB;
  pl.n_lt = (n_strips + pl.lt - 1) / pl.lt;
  pl.n_kt = (hB + pl.kt - 1) / pl.kt;
  pl.cgn = (cin + 3) / 4;
  pl.cells = pl.lt * kStrip + k - 1;
  pl.cgs = pl.cells + ((2 - pl.cells) % 8 + 8) % 8;
  // as many channel groups as fit beside their weights, counting the row
  // padding at its most (7 float4s a row)
  const int rows = pl.kt + k - 1;
  const int per_group = (rows * pl.cgs + k * k * coc) * 16;
  const int fit = (kSmemLimit - rows * 7 * 16) / per_group;
  pl.cgc = fit < pl.cgn ? (fit > 1 ? fit : 1) : pl.cgn;
  pl.n_cc = (pl.cgn + pl.cgc - 1) / pl.cgc;
  pl.rs = pl.cgc * pl.cgs;
  pl.rs += ((1 - pl.rs) % 8 + 8) % 8;
  pl.x_f4 = rows * pl.rs;
  pl.w_floats = k * k * pl.cgc * 4 * coc;
  return pl;
}

// acc[o][co] += the 4 x COC weights of one (r, s, channel group) at `wg`
// times the 4 channels of the strip's cell xv(o), channels in order
template <int COC, typename XV>
__device__ __forceinline__ void fma_group(float (&acc)[kStrip][COC],
                                          const float* wg, XV xv) {
  float wv[4 * COC];
#pragma unroll
  for (int f = 0; f < COC; ++f) {
    // 16-byte aligned: COC broadcast loads
    const float4 u = reinterpret_cast<const float4*>(wg)[f];
    wv[4 * f] = u.x;
    wv[4 * f + 1] = u.y;
    wv[4 * f + 2] = u.z;
    wv[4 * f + 3] = u.w;
  }
#pragma unroll
  for (int o = 0; o < kStrip; ++o) {
    const float4 v = xv(o);
#pragma unroll
    for (int co = 0; co < COC; ++co) {
      float a = acc[o][co];
      a = fmaf(v.x, wv[co], a);
      a = fmaf(v.y, wv[COC + co], a);
      a = fmaf(v.z, wv[2 * COC + co], a);
      a = fmaf(v.w, wv[3 * COC + co], a);
      acc[o][co] = a;
    }
  }
}

// KC > 0: the kernel size, compiled in (the strip's cells in registers);
// KC = 0: the size is the argument k (the cells read from shared memory)
template <typename T, int KC, int COC, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv4d_small_cout_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         T* __restrict__ out, int B, int hA, int wA, int hB,
                         int wB, int k, int cin, int cout) {
  const int K = KC > 0 ? KC : k;
  const int D = K / 2;
  const Plan pl = make_plan(K, hB, wB, cin, COC);
  extern __shared__ __align__(16) float4 smem[];
  float4* xs = smem;                                      // (row, cg, cell)
  float* ws = reinterpret_cast<float*>(smem + pl.x_f4);   // (r, s, c, co)
  const int cinp = pl.cgc * 4;  // channels of one chunk, padded to groups
  const int chunk = blockIdx.y;
  const int nthreads = pl.kt * pl.lt;

  int64_t t = blockIdx.x;
  const int lt = static_cast<int>(t % pl.n_lt);
  t /= pl.n_lt;
  const int kt = static_cast<int>(t % pl.n_kt);
  t /= pl.n_kt;
  const int j = static_cast<int>(t % wA);
  t /= wA;
  const int i = static_cast<int>(t % hA);
  const int64_t b = t / hA;
  const int k0 = kt * pl.kt;
  const int l0 = lt * pl.lt * kStrip;

  const int tx = threadIdx.x;
  const int row_t = tx % pl.kt;
  const int strip_t = tx / pl.kt;
  const bool active = tx < nthreads;

  // element strides of the channels-last volume
  const int64_t s_k = static_cast<int64_t>(wB) * cin;
  const int64_t s_j = static_cast<int64_t>(hB) * s_k;
  const int64_t s_i = static_cast<int64_t>(wA) * s_j;
  const int64_t s_b = static_cast<int64_t>(hA) * s_i;

  float acc[kStrip][COC];
#pragma unroll
  for (int o = 0; o < kStrip; ++o)
#pragma unroll
    for (int co = 0; co < COC; ++co) acc[o][co] = 0.f;

  // (b, i, j) are the block's, so the (p, q) skips are uniform and every
  // thread reaches every barrier
  for (int p = 0; p < K; ++p) {
    const int ii = i + p - D;
    if (ii < 0 || ii >= hA) continue;
    for (int q = 0; q < K; ++q) {
      const int jj = j + q - D;
      if (jj < 0 || jj >= wA) continue;
      const T* plane = x + b * s_b + ii * s_i + jj * s_j;
      const T* wpq = w + static_cast<int64_t>(p * K + q) * K * K * cin * cout;
      for (int cc = 0; cc < pl.n_cc; ++cc) {
        const int g0 = cc * pl.cgc;  // the chunk's first channel group
        const int ng = min(pl.cgc, pl.cgn - g0);
        __syncthreads();  // the previous slab is no longer read
        // channel groups fastest: neighbouring threads read neighbouring
        // bytes of the volume
        const int n_x = (pl.kt + K - 1) * pl.cells * ng;
        for (int e = tx; e < n_x; e += kThreads) {
          const int cg = e % ng;
          const int cell = (e / ng) % pl.cells;
          const int row = e / (ng * pl.cells);
          const int k2 = k0 - D + row;
          const int l2 = l0 - D + cell;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k2 >= 0 && k2 < hB && l2 >= 0 && l2 < wB)
            v = load4<VEC>(plane + k2 * s_k + static_cast<int64_t>(l2) * cin,
                           (g0 + cg) * 4, cin);
          xs[row * pl.rs + cg * pl.cgs + cell] = v;
        }
        for (int e = tx; e < pl.w_floats; e += kThreads) {
          const int co = e % COC;
          const int c = (e / COC) % cinp + g0 * 4;
          const int rs = e / (COC * cinp);
          const int gco = chunk * COC + co;
          ws[e] = (c < cin && gco < cout)
                      ? to_f32(wpq[(static_cast<int64_t>(rs) * cin + c) *
                                       cout + gco])
                      : 0.f;
        }
        __syncthreads();
        if (!active) continue;

        for (int r = 0; r < K; ++r) {
          const float4* xrow = xs + (row_t + r) * pl.rs + strip_t * kStrip;
          const float* wr = ws + r * K * cinp * COC;
          for (int cg = 0; cg < ng; ++cg) {
            const float4* xg = xrow + cg * pl.cgs;
            if constexpr (KC > 0) {
              constexpr int M = kStrip + KC - 1;  // cells a strip reads
              float4 xv[M];
#pragma unroll
              for (int m = 0; m < M; ++m) xv[m] = xg[m];
#pragma unroll
              for (int s = 0; s < KC; ++s)
                fma_group(acc, wr + (s * cinp + cg * 4) * COC,
                          [&](int o) { return xv[o + s]; });
            } else {
              for (int s = 0; s < K; ++s)
                fma_group(acc, wr + (s * cinp + cg * 4) * COC,
                          [&](int o) { return xg[o + s]; });
            }
          }
        }
      }
    }
  }

  const int kk = k0 + row_t;
  const int l = l0 + strip_t * kStrip;
  if (!active || kk >= hB) return;
  const int64_t cell0 =
      (((b * hA + i) * wA + j) * hB + kk) * static_cast<int64_t>(wB) + l;
#pragma unroll
  for (int o = 0; o < kStrip; ++o) {
    if (l + o >= wB) break;
#pragma unroll
    for (int co = 0; co < COC; ++co) {
      const int gco = chunk * COC + co;
      if (gco < cout) store(out + (cell0 + o) * cout + gco, acc[o][co]);
    }
  }
}

int coc_of(int cout) { return cout == 1 ? 1 : (cout == 2 ? 2 : 4); }

size_t smem_bytes(int k, int hB, int wB, int cin, int cout) {
  const Plan pl = make_plan(k, hB, wB, cin, coc_of(cout));
  return static_cast<size_t>(pl.x_f4) * sizeof(float4) +
         static_cast<size_t>(pl.w_floats) * sizeof(float);
}

template <typename T, int KC, int COC, bool VEC>
cudaError_t launch(const void* x, const void* w, void* out, int B, int hA,
                   int wA, int hB, int wB, int k, int cin, int cout,
                   cudaStream_t stream) {
  const Plan pl = make_plan(k, hB, wB, cin, COC);
  const int64_t blocks =
      static_cast<int64_t>(B) * hA * wA * pl.n_kt * pl.n_lt;
  if (blocks <= 0) return cudaSuccess;
  const int chunks = (cout + COC - 1) / COC;
  if (blocks > INT_MAX || chunks > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k, hB, wB, cin, cout);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  auto kernel = conv4d_small_cout_kernel<T, KC, COC, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(static_cast<unsigned>(blocks), chunks), kThreads, smem,
           stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                     static_cast<T*>(out), B, hA, wA, hB, wB, k, cin, cout);
  return cudaGetLastError();
}

template <typename T, int KC>
cudaError_t launch_k(const void* x, const void* w, void* out, int B, int hA,
                     int wA, int hB, int wB, int k, int cin, int cout,
                     cudaStream_t stream) {
  const bool vec = cin % 4 == 0;
#define SC_LAUNCH(COC)                                                      \
  return vec ? launch<T, KC, COC, true>(x, w, out, B, hA, wA, hB, wB, k,    \
                                        cin, cout, stream)                  \
             : launch<T, KC, COC, false>(x, w, out, B, hA, wA, hB, wB, k,   \
                                         cin, cout, stream);
  if (cout == 1) { SC_LAUNCH(1) }
  if (cout == 2) { SC_LAUNCH(2) }
  SC_LAUNCH(4)
#undef SC_LAUNCH
}

template <typename T>
int launch_t(const void* x, const void* w, void* out, int B, int hA, int wA,
             int hB, int wB, int k, int cin, int cout, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k % 2 == 0 || k > kMaxK) return -1;
#define SC_K(KC) \
  return launch_k<T, KC>(x, w, out, B, hA, wA, hB, wB, k, cin, cout, s);
  switch (k) {
    case 1: SC_K(1)
    case 3: SC_K(3)
    case 5: SC_K(5)
    case 7: SC_K(7)
    default: SC_K(0)
  }
#undef SC_K
}

}  // namespace

extern "C" {

// Shared memory bytes one launch of this shape needs (at most the card's
// 227 KB for every k up to conv4d_small_cout_max_k()).
long long conv4d_small_cout_smem_bytes(int k, int hB, int wB, int cin,
                                       int cout) {
  return static_cast<long long>(smem_bytes(k, hB, wB, cin, cout));
}

// Enqueue out = conv4d_same(x, w) on `stream`, f32 (`bf16` = 0) or bf16
// (`bf16` = 1) tensors; returns the cudaError_t of the launch (0 on
// success), or -1 for a kernel size that is even or above
// conv4d_small_cout_max_k().
int conv4d_small_cout(const void* x, const void* w, void* out, int B, int hA,
                      int wA, int hB, int wB, int k, int cin, int cout,
                      int bf16, void* stream) {
  return bf16 ? launch_t<__nv_bfloat16>(x, w, out, B, hA, wA, hB, wB, k, cin,
                                        cout, stream)
              : launch_t<float>(x, w, out, B, hA, wA, hB, wB, k, cin, cout,
                                stream);
}

int conv4d_small_cout_max_k() { return kMaxK; }

const char* conv4d_small_cout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
