// A same-padded 4D convolution with few output channels on the H100 (sm_90a):
//
//   out = T(sum over taps and C_in of x * w)
//
// x (B, hA, wA, hB, wB, C_in) channels-last in T (float or bf16), w (k, k, k,
// k, C_in, C_out) already cast to T by the wrapper, out (B, hA, wA, hB, wB,
// C_out) in T.  Zero "same" padding on all four spatial dims for an odd cubic
// k: taps outside the volume read zeros, no padded copy is made.  No bias.
//
// Replaces the TPU kernel ncnet_tpu/ops/conv4d_pallas.py:146 _fwd_impl (the
// pallas_call behind conv4d_small_cout), which conv4d(variant="auto") picks
// for every same-padded, cubic, odd layer with C_out <= 4: the NC stack's
// 16->1 layer whenever the stack runs per layer (fp32 stacks the arithmetic
// tiers do not take, e.g. the PF-Pascal model at 50^4).
//
// Two kernels; the wrapper (ops/conv4d_pallas.py) picks one by the kernel
// size alone: k = 3 and 5 (every model configuration's) take the tensor-core
// kernel, conv4d_small_cout_tc(); any other odd k up to kMaxK takes the
// direct CUDA-core kernel, conv4d_small_cout().
//
// Bound: operations.  On the path, (4, 50^4, 16) -> 1 in f32 at k = 5 needs
// 2 * 4 * 244^4 * 16 = 4.54e11 FLOP for the taps inside the volume against
// 1.7e9 bytes moved.  The tensor-core kernel computes an f32 volume as three
// bf16 products, 1.36e12 FLOP at the bf16 peak of 989e12: 1.376 ms (the
// bytes take 0.507 ms at 3.35e12 B/s).  On the CUDA cores the same work
// takes 6.77 ms at the f32 peak of 67e12.
//
// Tensor-core design (mma.sync m16n8k16, bf16 operands, f32 sums), an
// implicit GEMM, in three launches on the caller's stream:
//  1. the split pass writes x once into scratch, chunk-major (16-channel
//     chunks of C_in, zero-padded): per cell, f32: x_hi = bf16_rn(x), then
//     x_lo = bf16_rn(x - x_hi), then 16 bytes of padding (80 bytes); bf16:
//     the values and 16 bytes of padding (48 bytes).  80 and 48 bytes
//     apart, the 8 rows an ldmatrix reads fall on distinct banks.
//  2. the weight pass writes, per (C_out, chunk, p, jj - j0 + d), the B
//     operand of a step in the layout the products read, hi and lo rows.
//  3. the product kernel.  A block owns J = 16 / k output planes (i, j0 ..
//     j0 + J - 1) (3 at k = 5, 5 at k = 3) over G volumes, R rows and Wc
//     columns of the (hB, wB) plane: 17 rows of a 50-wide plane, or 13
//     whole 6x6 planes.  A step is one input plane (i + p - d, jj) that
//     some of those output planes read, and one chunk: warp 0 copies its
//     zero-haloed box, G x (R + 2d) x (Wc + 2d) split cells (the rows in
//     the volume, each a run of cells in scratch, one cp.async.bulk each;
//     the halo is zeroed once) and its weight tile into one of two shared-
//     memory stages, completing on the stage's mbarrier, a step ahead.
//     No thread spends a load or a register on staging.  The GEMM's rows
//     are the box's columns: row (g, kr, m) is box cell (g, kr, m) for every
//     box column m, and at tap row r the A operand is the box at a constant
//     offset of r rows.  Its columns are n = (jo, s), N = J k = 15 of 16:
//     output plane j0 + jo takes w[p, q = jj - j0 - jo + d, r, s] (zero where
//     q is outside the kernel), so one staged input plane serves up to J
//     output planes and a block stages (J + k - 1) / J planes a tap row
//     where one output plane alone would stage k.  Each step's products go
//     into fresh accumulators that are then added to f32 totals, so that no
//     sum inside the tensor cores grows past one (p, q) pair's share of an
//     output (the cores' own rounding is then far under the f32 bound).
//     Once per block the totals go to shared memory and out (g, kr, l) of
//     plane j0 + jo = sum over s ascending of Z (g, kr, l + s; jo, s),
//     rounded once to T; one output channel a block (blockIdx.y).
// f32: x = x_hi + x_lo and w = w_hi + w_lo; each k-step runs x_hi w_hi,
// x_hi w_lo and x_lo w_hi (the dropped x_lo w_lo is under 2^-16 of a term,
// the lo roundings ~2^-18).  bf16: one product, the same template with the
// lo parts compiled out.  Every output is summed in one fixed order in one
// block (steps, r, the three products, then s), with no atomics: two
// launches are bit-identical.  What set this design: a block that loads
// and splits its box itself, once per step, spends most of a step on that,
// and its loads hold its products back (PERF.md, PR 8).
//
// CUDA-core design (the first one; k other than 3 and 5).  The TPU kernel
// folds the (kA, kB, kWB) taps into the matmul's N dimension and resolves
// the shifts in a VMEM epilogue, so that the 128-lane MXU is full at C_out
// = 1.  This kernel keeps the direct form and spends its effort on reuse.
// A block owns one (b, i, j) output plane's tile of KT rows along hB by LT
// strips of R = 4 cells along wB; a thread owns one strip, R x COC f32 sums
// (COC <= 4 output channels; a larger C_out runs in chunks of 4 over
// blockIdx.y).  For each in-volume (p, q) tap pair, uniform over the block,
// the block stages the input slab the tile reads, (KT + k - 1) rows by
// (LT * R + k - 1) cells by a chunk of C_in, into shared memory as f32
// (zeros outside the volume), and the (p, q) slab of the weights for that
// chunk beside it; every thread then runs its (r, s, channel) taps from
// shared memory, loading the R + k - 1 cells of a row and channel group
// once and reusing each for the k taps s that touch it.  The chunk is as
// many groups of 4 channels as fit the card's 227 KB of shared memory
// beside the weights, and the accumulators persist across chunks.  Rows of
// the staged slab are padded to 16 bytes past a multiple of 128, and
// neighbouring threads own neighbouring rows, so a warp's 16-byte loads hit
// distinct banks.  k = 1, 3, 5, 7 are compiled with the strip's cells held
// in registers; any other odd k up to kMaxK runs the same loop reading the
// cells from shared memory.  At k = kMaxK one group of 4 channels still
// fits at every tile shape; a larger k is refused (the chooser in
// ops/conv4d.py never sends one).  Every output sums its terms in one fixed
// order (p, q, the chunk, r, the channel group, s, the channel in the
// group), so two launches are bit-identical.  The sums are f32 and are
// rounded to T once.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

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


// ---------------------------------------------------------------------------
// The tensor-core kernel (k = 3 and 5)
// ---------------------------------------------------------------------------

namespace tcore {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kPitch = 24;   // bf16 a staged weight row: 16 + 8
constexpr int kMT = 4;       // m-tiles a warp holds
constexpr int kMaxM = kWarps * kMT * 16;  // GEMM rows a block

// Bytes of one split cell, a 16-channel chunk of one cell of x as the
// split pass writes it and a block stages it: f32, hi (16 bf16) then lo
// (16 bf16) then 16 bytes of padding; bf16, the values then 16 bytes of
// padding.  80 and 48 bytes apart, the 8 rows an ldmatrix reads fall on
// distinct banks.
template <typename T>
__host__ __device__ constexpr int cell_bytes() {
  return std::is_same<T, float>::value ? 80 : 48;
}

template <int K>
struct Shape {
  static constexpr int D = K / 2;
  static constexpr int J = 16 / K;  // output planes along wA a block
  static constexpr int N = J * K;   // the GEMM's columns (jo, s), of 16
  static constexpr int DJ = J + 2 * D;  // input planes jj - j0 + d a block
  static constexpr int W_BYTES = K * 16 * kPitch * 2;  // a tile's hi rows
};

// the block tiling of one launch (host-chosen, uniform in the grid)
struct Geo {
  int B, hA, wA, hB, wB, cin, cout;
  int G, R, Wc;          // a block: G volumes x R rows x Wc columns of J
                         // output planes (i, j0 .. j0 + J - 1)
  int Hp, Wp, box, M;    // the box, R + 2d rows of Wc + 2d cells a volume;
                         // M = G R Wp GEMM rows
  int n_jg, n_rb, n_cb;  // groups of J planes, row and column bands
  int nch;               // 16-channel chunks of C_in
  int box_bytes, stage_bytes;  // a stage: the split cells, a weight tile
  int p_pitch;                 // Z's column pitch (floats)
  long long wt_offset;         // the weight tiles' byte offset in scratch
};

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// hi = bf16_rn(v), lo = bf16_rn(v - hi) of two values, each pair packed
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = tc::pack_bf16(h.x, h.y);
  lo = tc::pack_bf16(l.x, l.y);
}

// The split pass: x (cells, C_in) -> xs (chunk, cells, cell_bytes), 4
// channels a thread, channels past C_in zero.  Each value of x is split
// once here, not once per block that stages it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv4d_split_kernel(const T* __restrict__ x, unsigned char* __restrict__ xs,
                    int64_t cells, int cin, int nch) {
  const int64_t units = cells * nch * 4;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       e < units; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int q = static_cast<int>(e & 3);
    const int64_t rest = e >> 2;
    const int64_t cell = rest % cells;
    const int cc = static_cast<int>(rest / cells);
    const int c0 = cc * 16 + q * 4;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      v[c] = c0 + c < cin ? to_f32(x[cell * cin + c0 + c]) : 0.f;
    unsigned char* dst = xs + rest * cell_bytes<T>() + q * 8;
    uint2 h, l;
    split2(v[0], v[1], h.x, l.x);
    split2(v[2], v[3], h.y, l.y);
    *reinterpret_cast<uint2*>(dst) = h;
    if (std::is_same<T, float>::value)
      *reinterpret_cast<uint2*>(dst + 32) = l;
  }
}

// The weight tiles: for each output channel co, chunk cc, tap p and
// input plane offset dj = jj - j0 + d, the B operand of every tap row r,
// rows (r, n = (jo, s)) of 16 ci at kPitch, w[p, dj - jo, r, s, ci, co]
// (zero where dj - jo is outside the kernel, past N or past C_in), hi
// rows then (f32) lo rows.  A block copies one tile a step.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
conv4d_weight_tiles_kernel(const T* __restrict__ w,
                           __nv_bfloat16* __restrict__ wt, int cin,
                           int cout, int nch) {
  using S = Shape<K>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kRows = K * 16 * kPitch;  // bf16 of a tile's hi rows
  const int64_t tiles = static_cast<int64_t>(cout) * nch * K * S::DJ;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       e < tiles * kRows; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int at = static_cast<int>(e % kRows);
    int64_t tile = e / kRows;
    const int dj = static_cast<int>(tile % S::DJ);
    const int p = static_cast<int>((tile / S::DJ) % K);
    const int cc = static_cast<int>((tile / (S::DJ * K)) % nch);
    const int co = static_cast<int>(tile / (S::DJ * K * nch));
    const int row = at / kPitch, c = at % kPitch;
    const int r = row / 16, n = row % 16, jo = n / K, s = n % K;
    const int q = dj - jo, ci = cc * 16 + c;
    float v = 0.f;
    if (c < 16 && n < S::N && q >= 0 && q < K && ci < cin)
      v = to_f32(w[((((static_cast<int64_t>(p) * K + q) * K + r) * K + s) *
                        cin + ci) * cout + co]);
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    __nv_bfloat16* dst = wt + tile * (kSplit ? 2 : 1) * kRows + at;
    dst[0] = h;
    if (kSplit) dst[kRows] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

// Z (g, kr, m; jo, s) over the whole contraction in registers, then out
// (g, kr, l) of output plane j0 + jo = sum over s of Z (g, kr, l + s; jo,
// s); one output channel a block (blockIdx.y).  See the header.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 1)
conv4d_small_cout_tc_kernel(const unsigned char* __restrict__ xs,
                            T* __restrict__ out, const Geo g) {
  using S = Shape<K>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kParts = kSplit ? 2 : 1;  // hi (and lo) products
  constexpr int CB = cell_bytes<T>();
  constexpr int D = S::D, J = S::J;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // one a stage
  unsigned char* stages = smem + 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t4 = lane % 4;

  // block decode: column band fastest, then row band, the group of planes
  // along wA, i, the group of volumes, so neighbouring blocks share their
  // input planes in L2
  int64_t t = blockIdx.x;
  const int l0 = static_cast<int>(t % g.n_cb) * g.Wc;
  t /= g.n_cb;
  const int k0 = static_cast<int>(t % g.n_rb) * g.R;
  t /= g.n_rb;
  const int j0 = static_cast<int>(t % g.n_jg) * J;
  t /= g.n_jg;
  const int i = static_cast<int>(t % g.hA);
  const int b0 = static_cast<int>(t / g.hA) * g.G;
  const int co = blockIdx.y;
  // the steps: the input planes (i + p - d, jj) some output plane of the
  // block reads, each a 16-channel chunk at a time (chunk fastest, then jj)
  const int p_lo = max(0, D - i), n_p = min(K, g.hA - i + D) - p_lo;
  const int jj_lo = max(0, j0 - D);
  const int n_jj = min(g.wA, j0 + J + D) - jj_lo;
  const int n_steps = n_p * n_jj * g.nch;
  const int64_t plane_cells = static_cast<int64_t>(g.hB) * g.wB;
  const int64_t all_cells = static_cast<int64_t>(g.B) * g.hA * g.wA * plane_cells;

  // the box's columns inside the volume (the same in every row) and its
  // rows (volume gg, y) inside it
  const int x_lo = max(0, D - l0), x_hi = min(g.Wp, g.wB - l0 + D);
  const int n_rows = g.G * g.Hp;
  auto row_ok = [&](int gg, int y) {
    const int kk = k0 - D + y;
    return b0 + gg < g.B && kk >= 0 && kk < g.hB;
  };
  // both stages: zeros outside the volume, where no copy writes
  for (int e = threadIdx.x; e < 2 * g.box; e += kThreads) {
    const int cell = e % g.box, xw = cell % g.Wp, row = cell / g.Wp;
    if (!row_ok(row / g.Hp, row % g.Hp) || xw < x_lo || xw >= x_hi) {
      uint4* c = reinterpret_cast<uint4*>(stages + (e / g.box) * g.stage_bytes +
                                          cell * CB);
#pragma unroll
      for (int v = 0; v < CB / 16; ++v) c[v] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (threadIdx.x == 0) {
    tc::mbar_init(bars);
    tc::mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the box rows inside the volume: its volumes' rows inside the plane
  const int ok_rows = min(g.G, g.B - b0) *
                      (min(g.Hp, g.hB - k0 + D) - max(0, D - k0));
  __syncthreads();

  // Warp 0 copies step `step`'s in-volume box rows into stage `slot`, a
  // row a lane, and lane 0 its weight tile, first arming the stage's
  // mbarrier with their bytes.
  const int tile_bytes = kParts * S::W_BYTES;
  auto issue = [&](int step, int slot) {
    if (warp != 0) return;
    const int cc = step % g.nch, jj = jj_lo + (step / g.nch) % n_jj;
    const int p = p_lo + step / (g.nch * n_jj);
    const int64_t base =
        cc * all_cells +
        (static_cast<int64_t>(i + p - D) * g.wA + jj) * plane_cells;
    unsigned char* dst = stages + slot * g.stage_bytes;
    // the stage was last read by the generic proxy (ldmatrix)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) {
      tc::mbar_expect(bars + slot, ok_rows * (x_hi - x_lo) * CB + tile_bytes);
      const int64_t tile =
          ((static_cast<int64_t>(co) * g.nch + cc) * K + p) * S::DJ + jj - j0 + D;
      tc::bulk_copy(dst + g.box_bytes, xs + g.wt_offset + tile * tile_bytes,
                tile_bytes, bars + slot);
    }
    __syncwarp();
    for (int row = lane; row < n_rows; row += 32) {
      const int gg = row / g.Hp, y = row % g.Hp;
      if (!row_ok(gg, y)) continue;
      const int64_t cell =
          base + static_cast<int64_t>(b0 + gg) * g.hA * g.wA * plane_cells +
          static_cast<int64_t>(k0 - D + y) * g.wB + l0 - D + x_lo;
      tc::bulk_copy(dst + (row * g.Wp + x_lo) * CB, xs + cell * CB,
                (x_hi - x_lo) * CB, bars + slot);
    }
  };

  // this lane's ldmatrix row of each of its m-tiles: the box cell of GEMM
  // row m = (g, kr, m') at tap row 0, in bytes
  const int n_mt = (g.M + 15) / 16;
  int a_at[kMT];
#pragma unroll
  for (int u = 0; u < kMT; ++u) {
    int m = (warp + kWarps * u) * 16 + (lane & 15);
    m = m < g.M ? m : 0;
    const int mm = m % g.Wp, rest = m / g.Wp;
    a_at[u] = (((rest / g.R) * g.Hp + rest % g.R) * g.Wp + mm) * CB +
              (lane >> 4) * 16;
  }
  // its row of a weight n-tile: matrices 0, 1 the hi rows' two halves of
  // ci, 2, 3 the lo rows'
  const int b_at = ((lane & 7) * kPitch + ((lane >> 3) & 1) * 8) * 2 +
                   (kSplit ? (lane >> 4) * S::W_BYTES : 0);

  // acc: a step's products (the tensor cores' sums); tot: the steps'
  // sums, added in f32, so that no accumulator of the tensor cores grows
  // past one (p, q) tap pair's share of an output
  float acc[kMT][2][4], tot[kMT][2][4];
#pragma unroll
  for (int u = 0; u < kMT; ++u)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) tot[u][nt][v] = 0.f;

  // One step's products: for each tap row r, its B fragments (the two
  // n-tiles), then the m-tiles two at a time, A read at a constant offset
  // of r box rows; the mma of a pair run product by product, so that
  // consecutive mma write different accumulators.
  auto compute = [&](int slot) {
#pragma unroll
    for (int u = 0; u < kMT; ++u)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][nt][v] = 0.f;
    const unsigned char* hi = stages + slot * g.stage_bytes;
    const unsigned char* lo = hi + 32;
    const unsigned char* wb = hi + g.box_bytes;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      uint32_t bw[2][4];  // hi b0, b1, then lo b0, b1
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const unsigned char* at = wb + b_at + (r * 16 + nt * 8) * kPitch * 2;
        if constexpr (kSplit)
          tc::ldmatrix_x4(bw[nt], at);
        else
          tc::ldmatrix_x2(bw[nt], at);
      }
      const int shift = r * g.Wp * CB;
#pragma unroll
      for (int u = 0; u < kMT; u += 2) {
        if (warp + kWarps * u >= n_mt) break;
        const bool two = warp + kWarps * (u + 1) < n_mt;
        uint32_t a[2][4], al[2][4];
        tc::ldmatrix_x4(a[0], hi + a_at[u] + shift);
        if (two) tc::ldmatrix_x4(a[1], hi + a_at[u + 1] + shift);
        if constexpr (kSplit) {
          tc::ldmatrix_x4(al[0], lo + a_at[u] + shift);
          if (two) tc::ldmatrix_x4(al[1], lo + a_at[u + 1] + shift);
        }
#pragma unroll
        for (int v = 0; v < 2; ++v)
          if (v == 0 || two)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              tc::mma_bf16(acc[u + v][nt], a[v], bw[nt]);  // x_hi w_hi
        if constexpr (kSplit) {
#pragma unroll
          for (int v = 0; v < 2; ++v)
            if (v == 0 || two)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
                tc::mma_bf16(acc[u + v][nt], a[v], bw[nt] + 2);  // x_hi w_lo
#pragma unroll
          for (int v = 0; v < 2; ++v)
            if (v == 0 || two)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
                tc::mma_bf16(acc[u + v][nt], al[v], bw[nt]);  // x_lo w_hi
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMT; ++u)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) tot[u][nt][v] += acc[u][nt][v];
  };

  // stage step & 1 holds the step from its copies' landing to the end of
  // its products: the copies run a step ahead
  issue(0, 0);
  if (n_steps > 1) issue(1, 1);
  for (int step = 0; step < n_steps; ++step) {
    const int slot = step & 1;
    tc::mbar_wait(bars + slot, (step >> 1) & 1);  // the step is staged
    compute(slot);
    __syncthreads();  // the stage is no longer read
    if (step + 2 < n_steps) issue(step + 2, slot);
  }

  // Z (n, m) at p_pitch, f32, past the mbarriers
  float* Z = reinterpret_cast<float*>(stages);
#pragma unroll
  for (int u = 0; u < kMT; ++u) {
    const int mt = warp + kWarps * u;
    if (mt >= n_mt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * 16 + gq + 8 * h;
      if (m >= g.M) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = nt * 8 + 2 * t4 + c;
          if (n < S::N) Z[n * g.p_pitch + m] = tot[u][nt][2 * h + c];
        }
    }
  }
  __syncthreads();

  const int n_out = g.G * J * g.R * g.Wc;
  for (int o = threadIdx.x; o < n_out; o += kThreads) {
    const int l = o % g.Wc, kr = (o / g.Wc) % g.R;
    const int jo = (o / (g.Wc * g.R)) % J, gg = o / (g.Wc * g.R * J);
    const int b = b0 + gg, j = j0 + jo, kk = k0 + kr, ll = l0 + l;
    if (b >= g.B || j >= g.wA || kk >= g.hB || ll >= g.wB) continue;
    const float* z = Z + jo * K * g.p_pitch + (gg * g.R + kr) * g.Wp + l;
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < K; ++s) v += z[s * g.p_pitch + s];
    const int64_t cell =
        (((static_cast<int64_t>(b) * g.hA + i) * g.wA + j) * g.hB + kk) *
            g.wB + ll;
    store(out + cell * g.cout + co, v);
  }
}

// The tiling of a launch shape: column bands only past what one row of a
// block holds, then as many rows as the GEMM rows and two stages allow,
// then whole planes of several volumes; bands balanced.  Fills in the
// shared-memory layout and returns the bytes it needs.
template <typename T, int K>
size_t plan(Geo& g) {
  using S = Shape<K>;
  constexpr int D = S::D, CB = cell_bytes<T>();
  constexpr int parts = std::is_same<T, float>::value ? 2 : 1;
  auto cdiv = [](int a, int b) { return (a + b - 1) / b; };
  const int max_box = (kSmemLimit - 32 - 2 * parts * S::W_BYTES) / (2 * CB);
  g.n_jg = cdiv(g.wA, S::J);
  g.n_cb = cdiv(g.wB, std::min(kMaxM, max_box / (1 + 2 * D)) - 2 * D);
  g.Wc = cdiv(g.wB, g.n_cb);
  g.Wp = g.Wc + 2 * D;
  g.n_rb = cdiv(g.hB, std::min(g.hB, std::min(kMaxM / g.Wp,
                                              max_box / g.Wp - 2 * D)));
  g.R = cdiv(g.hB, g.n_rb);
  g.Hp = g.R + 2 * D;
  g.G = 1;
  if (g.n_rb == 1 && g.n_cb == 1) {
    const int fit = std::min(kMaxM / (g.R * g.Wp), max_box / (g.Hp * g.Wp));
    g.G = cdiv(g.B, cdiv(g.B, std::max(1, std::min(g.B, fit))));
  }
  g.box = g.G * g.Hp * g.Wp;
  g.M = g.G * g.R * g.Wp;
  g.nch = cdiv(g.cin, 16);
  g.box_bytes = round16(g.box * CB);
  g.stage_bytes = g.box_bytes + parts * S::W_BYTES;
  // the smallest pitch >= M that is 4 mod 32 words, so the fragment
  // stores of 8 rows x 4 columns fall on distinct banks
  g.p_pitch = (g.M + 27) / 32 * 32 + 4;
  const size_t z = static_cast<size_t>(S::N) * g.p_pitch * 4;
  const size_t st = 2 * static_cast<size_t>(g.stage_bytes);
  return 16 + (z > st ? z : st);
}

// scratch: the split cells, then the weight tiles
int64_t split_bytes(int64_t cells, int cin, int bf16) {
  return cells * ((cin + 15) / 16) * (bf16 ? 48 : 80);
}

template <int K>
int64_t tile_bytes(int cin, int cout, int bf16) {
  using S = Shape<K>;
  return static_cast<int64_t>(cout) * ((cin + 15) / 16) * K * S::DJ *
         (bf16 ? 1 : 2) * S::W_BYTES;
}

int64_t scratch_bytes(int64_t cells, int k, int cin, int cout, int bf16) {
  const int64_t tiles = k == 3   ? tile_bytes<3>(cin, cout, bf16)
                        : k == 5 ? tile_bytes<5>(cin, cout, bf16)
                                 : 0;
  return (split_bytes(cells, cin, bf16) + 15) / 16 * 16 + tiles;
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* w, void* out, void* scratch,
                   int B, int hA, int wA, int hB, int wB, int cin, int cout,
                   cudaStream_t stream) {
  Geo g{B, hA, wA, hB, wB, cin, cout};
  const size_t smem = plan<T, K>(g);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  const int64_t blocks = static_cast<int64_t>((B + g.G - 1) / g.G) * hA *
                         g.n_jg * g.n_rb * g.n_cb;
  if (blocks > INT_MAX || cout > 65535) return cudaErrorInvalidValue;
  const int64_t cells = static_cast<int64_t>(B) * hA * wA * hB * wB;
  constexpr int bf16 = std::is_same<T, float>::value ? 0 : 1;
  g.wt_offset = (split_bytes(cells, cin, bf16) + 15) / 16 * 16;
  auto* xs = static_cast<unsigned char*>(scratch);
  // the prologue kernels, grid-stride: the split cells, the weight tiles
  const int64_t units = cells * g.nch * 4;
  conv4d_split_kernel<T><<<static_cast<unsigned>(std::min<int64_t>(
                               (units + kThreads - 1) / kThreads, 132 * 8)),
                           kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                  xs, cells, cin, g.nch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t tile_values = tile_bytes<K>(cin, cout, bf16) / 2;
  conv4d_weight_tiles_kernel<T, K>
      <<<static_cast<unsigned>(std::min<int64_t>(
             (tile_values + kThreads - 1) / kThreads, 132 * 8)),
         kThreads, 0, stream>>>(
          static_cast<const T*>(w),
          reinterpret_cast<__nv_bfloat16*>(xs + g.wt_offset), cin, cout,
          g.nch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kernel = conv4d_small_cout_tc_kernel<T, K>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<dim3(static_cast<unsigned>(blocks), cout), kThreads, smem,
           stream>>>(xs, static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <typename T>
int launch_t(const void* x, const void* w, void* out, void* scratch, int B,
             int hA, int wA, int hB, int wB, int k, int cin, int cout,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<int64_t>(B) * hA * wA * hB * wB <= 0 || cout <= 0) return 0;
  if (k == 3)
    return launch<T, 3>(x, w, out, scratch, B, hA, wA, hB, wB, cin, cout, s);
  if (k == 5)
    return launch<T, 5>(x, w, out, scratch, B, hA, wA, hB, wB, cin, cout, s);
  return -1;
}

}  // namespace tcore

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

// Bytes of the split copy of x that conv4d_small_cout_tc needs as scratch.
long long conv4d_small_cout_tc_scratch_bytes(int B, int hA, int wA, int hB,
                                             int wB, int k, int cin, int cout,
                                             int bf16) {
  return tcore::scratch_bytes(static_cast<int64_t>(B) * hA * wA * hB * wB, k,
                              cin, cout, bf16);
}

// The tensor-core kernel, k = 3 or 5 (else -1): the split pass writes x into
// `scratch` (conv4d_small_cout_tc_scratch_bytes of it, 16-byte aligned),
// then the products read it.  x must start on 16 bytes.
int conv4d_small_cout_tc(const void* x, const void* w, void* out,
                         void* scratch, int B, int hA, int wA, int hB, int wB,
                         int k, int cin, int cout, int bf16, void* stream) {
  return bf16 ? tcore::launch_t<__nv_bfloat16>(x, w, out, scratch, B, hA, wA,
                                               hB, wB, k, cin, cout, stream)
              : tcore::launch_t<float>(x, w, out, scratch, B, hA, wA, hB, wB,
                                       k, cin, cout, stream);
}

int conv4d_small_cout_max_k() { return kMaxK; }

const char* conv4d_small_cout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
