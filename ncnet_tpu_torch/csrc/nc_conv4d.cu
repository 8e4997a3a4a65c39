// One neighbourhood-consensus layer on the H100 (sm_90a):
//
//   out = bf16(relu(sum over taps and C_in of f32(x) * f32(w) + f32(b)))
//
// a same-padded 4D cross-correlation of a bf16 channels-last volume
// x (B, hA, wA, hB, wB, C_in) with bf16 weights w (k, k, k, k, C_in, C_out)
// and bias b (C_out), written to a bf16 volume out (B, hA, wA, hB, wB, C_out).
// Zero "same" padding on all four spatial dims for an odd cubic k.
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
// C_out swapped (ncnet_tpu_torch/ops/nc_fused_lane_vjp.py flips them).  It
// runs through the same kernels with the bias and ReLU compiled out.
//
// Bound: operations.  The PF-Pascal stack, kernels (5, 5, 5) and channels
// (16, 16, 1), counts at its in-volume taps 3.82e12 FLOP on the coarse-to-
// fine tiles (20000, 6^4) against ~0.2 GB of bf16 volumes moved: thousands
// of FLOP per byte, far above the card's ~295 FLOP/byte ridge.
//
// Design (tensor cores, mma.sync m16n8k16, bf16 operands, f32 sums): the
// layer is an implicit GEMM over a (tap, C_in) contraction.  A block owns
// the output cells of G volumes (consecutive b) that share one (i, j) plane,
// over R rows and Wc columns of that (hB, wB) plane: 7 whole planes at 6^4,
// 5 rows of a plane at 50^4, at most 256 cells.  It loops over the (p, q)
// taps whose input plane (i + p - d, j + q - d) lies inside the volume (a
// test uniform in the block: the others are skipped whole).  For each it
// stages, double-buffered with cp.async, the input box (G x (R + 2d) x
// (Wc + 2d) cells, zero-filled outside the volume, so no tap is ever
// tested) and the (p, q) weight slab as bf16.  In the padded box the
// (r, s) tap of every output cell is the same constant offset, so each
// lane computes its rows' addresses once.  Three ways to fill the tensor
// cores, by layer shape:
//   - channels (C_in > 1, C_out > 4; the 16->16 layer): each (r, s) tap is
//     one k-step of the 16 channels (C_in below 16 is zero-padded), A is
//     ldmatrix of 16 shifted cells (48-byte pitch: the 8 rows of a matrix
//     fall on distinct banks), B the tap's (C_in, C_out) weights through
//     ldmatrix.trans; 8 warps x 2 m-tiles x C_out / 8 n-tiles;
//   - taps in K (C_in = 1; the 1->16 layer, and the tap-swap chain's
//     1->32): the (r, s) taps are the
//     contraction, not C_in padded to 16 (16x its FLOP): an expanded box
//     holds each cell's 8 horizontal shifts (s, zeros past k) as one
//     16-byte row, so a k-step is two tap rows r and one ldmatrix; a
//     thread loads its row segment into registers before a (p, q) is
//     computed and stores it after, hiding the loads behind the product;
//     C_out = 32 is 4 n-tiles, its weight rows at an 80-byte pitch;
//   - taps in N (C_out <= 4; the 16->1 layer, and the chain's block-
//     diagonal 32->2): per (p, q) one product of
//     every box cell's 16 channels with the (C_in, k^2 C_out) tap weights
//     gives each cell's partial for every (r, s) tap; the partials stay f32
//     in shared memory, and each output cell sums its k^2 shifted partials.
//     Padding N = C_out to 8 would cost 8x its FLOP.  C_in = 32 is two
//     k-steps of 16 channels, its cells staged at an 80-byte pitch (the 8
//     rows of a matrix still fall on distinct banks).
// Every output is summed in a fixed order in one block, with no atomics and
// no split of the contraction across blocks, so two launches give bit-
// identical results.  Like the plain twin, and unlike the TPU kernel, the
// per-tap partial sums are not rounded to bf16: only the layer's output is.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTW = 2;                       // m-tiles a warp holds
constexpr int kMaxOut = kWarps * kMTW * 16;   // output cells a block
constexpr int kOutPerThread = 4;              // taps in N: kMaxOut * 4 / kThreads
constexpr size_t kSmemBudget = 112 * 1024;    // two blocks an SM
constexpr int kShifts = 8;                    // taps in K: s slots a cell

enum Mode { kChannels, kTapsK, kTapsN };

template <int K, int CIN, int COUT>
struct Layer {
  static constexpr int D = K / 2;
  static constexpr Mode kMode =
      CIN == 1 ? kTapsK : (COUT <= 4 ? kTapsN : kChannels);
  static_assert(kMode != kChannels || (CIN <= 16 && COUT <= 16),
                "the channels mode stages 16 channels a cell");
  static_assert(kMode != kTapsK || COUT <= 32, "taps in K: C_out <= 32");
  static_assert(kMode != kTapsN || CIN <= 32, "taps in N: C_in <= 32");
  static constexpr int NT = (COUT + 7) / 8;     // n-tiles of C_out (rows modes)
  // bf16 a staged row holds: a cell's channels (channels, taps in N) or a
  // weight row's C_out columns (taps in K), padded to 16 or 32
  static constexpr int kWidth =
      (kMode == kTapsK ? COUT : CIN) > 16 ? 32 : 16;
  // the row pitch: 8 bf16 past the width (48 or 80 bytes), so the 8 rows of
  // an ldmatrix fall on distinct banks
  static constexpr int kPitch = kWidth + 8;
  static constexpr int KSTEPS = kWidth / 16;    // taps in N: k-steps of C_in
  // taps in K: a k-step is two tap rows r of 8 columns s (s >= K zero)
  static constexpr int KS = (K + 1) / 2;
  // weight rows staged a (p, q), kPitch bf16 each: (r, s, ci) with ci
  // padded to 16, or (k-step, r % 2, s) for the taps in K
  static constexpr int kWRows = kMode == kTapsK ? 16 * KS : K * K * 16;
  // taps in N: the columns n = (r, s, co), padded to 8; weights staged as
  // rows n of kWidth ci at kPitch
  static constexpr int NPAD = (K * K * COUT + 7) / 8 * 8;
  static constexpr int NTN = NPAD / 8;
  static constexpr int kPRows = K * K * COUT;  // the columns P keeps
  // box m-tiles a warp loads ahead (taps in N): 2 while its B fragments
  // are few enough to stay in registers beside them
  static constexpr int kBoxMTW = NTN > 4 ? 1 : 2;
  // blocks an SM: the taps in K need little shared memory, and three
  // blocks while their C_out sums fit the registers
  static constexpr int kMinBlocks = kMode == kTapsK && NT <= 2 ? 3 : 2;
};

// the block tiling of one launch (host-chosen, uniform in the grid)
struct Geo {
  int B, hA, wA, hB, wB;
  int G, R, Wc;    // a block: G volumes x R rows x Wc columns of one plane
  int n_rb, n_cb;  // row and column bands of a plane
  int Hp, Wp;      // the staged box: R + 2d rows of Wc + 2d cells
  int box;         // G * Hp * Wp cells
  int in_bytes, stage_bytes, p_pitch;
};

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// log2 of a power of two: the staging loops split an index by shifts
__host__ __device__ constexpr int log2_of(int n) {
  return n > 1 ? 1 + log2_of(n / 2) : 0;
}

// block decode: band fastest, then j, i, then the group of volumes, so
// neighbouring blocks share their input planes in L2
struct Block {
  int b0, i, j, k0, l0;
};

__device__ __forceinline__ Block decode(const Geo& g) {
  int64_t t = blockIdx.x;
  Block blk;
  blk.l0 = static_cast<int>(t % g.n_cb) * g.Wc;
  t /= g.n_cb;
  blk.k0 = static_cast<int>(t % g.n_rb) * g.R;
  t /= g.n_rb;
  blk.j = static_cast<int>(t % g.wA);
  t /= g.wA;
  blk.i = static_cast<int>(t % g.hA);
  blk.b0 = static_cast<int>(t / g.hA) * g.G;
  return blk;
}

// box cell of output row m (g, kr, lc) at tap (0, 0)
__device__ __forceinline__ int box_cell(const Geo& g, int m) {
  const int lc = m % g.Wc, rest = m / g.Wc;
  return ((rest / g.R) * g.Hp + rest % g.R) * g.Wp + lc;
}

// the global element offset of output row m's cell, or -1 past the volume
__device__ __forceinline__ int64_t out_cell(const Geo& g, const Block& blk,
                                            int m) {
  const int lc = m % g.Wc, rest = m / g.Wc;
  const int b = blk.b0 + rest / g.R, kk = blk.k0 + rest % g.R,
            ll = blk.l0 + lc;
  if (b >= g.B || kk >= g.hB || ll >= g.wB) return -1;
  return (((static_cast<int64_t>(b) * g.hA + blk.i) * g.wA + blk.j) * g.hB +
          kk) * g.wB + ll;
}

// Each box cell's element offset in x without its plane term (-1 outside
// the volume), written once per block: staging a (p, q) adds the plane's.
template <int D>
__device__ __forceinline__ void box_offsets(long long* boff, const Geo& g,
                                            const Block& blk) {
  for (int cell = threadIdx.x; cell < g.box; cell += kThreads) {
    const int xw = cell % g.Wp, rest = cell / g.Wp;
    const int y = rest % g.Hp, b = blk.b0 + rest / g.Hp;
    const int kk = blk.k0 - D + y, ll = blk.l0 - D + xw;
    boff[cell] = (b >= g.B || kk < 0 || kk >= g.hB || ll < 0 || ll >= g.wB)
                     ? -1
                     : static_cast<long long>(b) * g.hA * g.wA * g.hB * g.wB +
                           static_cast<long long>(kk) * g.wB + ll;
  }
}

// Stage the input box of plane (ii, jj) into `sin`: CIN channels a cell at
// PITCH (zeros to WIDTH; 16-byte cp.async copies when CIN = WIDTH); zeros
// outside the volume.
template <int CIN, int WIDTH, int PITCH>
__device__ __forceinline__ void stage_box(const __nv_bfloat16* __restrict__ x,
                                          __nv_bfloat16* sin,
                                          const long long* boff, const Geo& g,
                                          int ii, int jj) {
  const long long po =
      (static_cast<long long>(ii) * g.wA + jj) * g.hB * g.wB;
  if constexpr (CIN == WIDTH) {
    constexpr int kChunks = CIN / 8, kShift = log2_of(kChunks);
    for (int e = threadIdx.x; e < kChunks * g.box; e += kThreads) {
      const int cell = e >> kShift, h = e & (kChunks - 1);
      const long long o = boff[cell];
      tc::cp_async16(sin + cell * PITCH + 8 * h,
                     o >= 0 ? x + (o + po) * CIN + 8 * h : x, o >= 0 ? 16 : 0);
    }
  } else {
    constexpr int kShift = log2_of(WIDTH);
    for (int e = threadIdx.x; e < WIDTH * g.box; e += kThreads) {
      const int cell = e >> kShift, c = e & (WIDTH - 1);
      const long long o = boff[cell];
      sin[cell * PITCH + c] = (c < CIN && o >= 0)
                                  ? x[(o + po) * CIN + c]
                                  : __float2bfloat16_rn(0.f);
    }
  }
}

// The taps in K: this thread's row segment of the expanded box, whose
// cell (g, y, x) holds the kShifts box cells (g, y, x .. x + kShifts - 1)
// (zeros from column K on), one 16-byte row an ldmatrix reads.  Loaded into
// registers before a (p, q) is computed and stored after it, so the loads'
// latency hides behind the product.
template <int K>
struct Segment {
  static_assert(K <= kShifts, "a cell's shifts hold one tap row");
  static constexpr int kSeg = 8;                 // expanded cells a segment
  static constexpr int kRaw = kSeg + K - 1;      // box cells it reads
  int cell0 = -1;   // box cell of its first column, -1: no segment
  int ecell0 = 0;   // its first expanded cell
  int n = 0;        // expanded cells in it
  int left = 0;     // box cells from cell0 to the end of its box row
  __nv_bfloat16 raw[kRaw];

  __device__ explicit Segment(const Geo& g) {
    const int per_row = (g.Wc + kSeg - 1) / kSeg;
    const int seg = threadIdx.x;
    if (seg >= g.G * g.Hp * per_row) return;
    const int row = seg / per_row, x0 = (seg % per_row) * kSeg;
    cell0 = row * g.Wp + x0;
    ecell0 = row * g.Wc + x0;
    n = min(kSeg, g.Wc - x0);
    left = g.Wp - x0;
  }
  // the segment's box cells of the plane at element offset po
  __device__ void load(const __nv_bfloat16* __restrict__ x,
                       const long long* boff, long long po) {
#pragma unroll
    for (int u = 0; u < kRaw; ++u) {
      raw[u] = __float2bfloat16_rn(0.f);
      if (cell0 >= 0 && u < left) {
        const long long o = boff[cell0 + u];
        if (o >= 0) raw[u] = x[o + po];
      }
    }
  }
  __device__ void store(__nv_bfloat16* expanded) const {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int v = 0; v < kSeg; ++v) {
      if (v >= n) break;
      uint32_t q[kShifts / 2];
#pragma unroll
      for (int c = 0; c < kShifts / 2; ++c)
        q[c] = tc::pack_bf16(2 * c < K ? raw[v + 2 * c] : zero,
                             2 * c + 1 < K ? raw[v + 2 * c + 1] : zero);
      *reinterpret_cast<uint4*>(expanded + (ecell0 + v) * kShifts) =
          make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
};

// Stage `rows` weight rows of WIDTH bf16 at PITCH from a (rows_in, COLS)
// matrix: row n, column c is src[n * COLS + c] for n < rows_in and c <
// cols_used, else 0.  16-byte copies when a row is exactly WIDTH bf16.
template <int COLS, int WIDTH, int PITCH>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int rows,
                                           int rows_in, int cols_used) {
  if constexpr (COLS == WIDTH) {
    constexpr int kChunks = COLS / 8, kShift = log2_of(kChunks);
    for (int e = threadIdx.x; e < kChunks * rows; e += kThreads) {
      const int n = e >> kShift, h = e & (kChunks - 1);
      const bool ok = n < rows_in;
      tc::cp_async16(dst + n * PITCH + 8 * h,
                     ok ? src + n * COLS + 8 * h : src, ok ? 16 : 0);
    }
  } else {
    constexpr int kShift = log2_of(WIDTH);
    for (int e = threadIdx.x; e < WIDTH * rows; e += kThreads) {
      const int n = e >> kShift, c = e & (WIDTH - 1);
      dst[n * PITCH + c] = (n < rows_in && c < cols_used)
                               ? src[n * COLS + c]
                               : __float2bfloat16_rn(0.f);
    }
  }
}

// The valid (p, q) taps of a block, whose input plane lies in the volume
struct Taps {
  int p_lo, q_lo, nq, n;
  __device__ Taps(int K, int D, const Geo& g, const Block& blk) {
    p_lo = max(0, D - blk.i);
    q_lo = max(0, D - blk.j);
    nq = min(K, g.wA - blk.j + D) - q_lo;
    n = (min(K, g.hA - blk.i + D) - p_lo) * nq;
  }
  __device__ int p(int t) const { return p_lo + t / nq; }
  __device__ int q(int t) const { return q_lo + t % nq; }
};

// The channels and taps-in-K modes: each warp holds kMTW m-tiles of output
// cells x NT n-tiles of C_out in f32 registers across every (p, q), staged
// one (p, q) at a time, double-buffered (the taps in K build their expanded
// box from registers loaded a (p, q) ahead).
template <int K, int CIN, int COUT, bool BIAS_RELU>
__global__ void __launch_bounds__(kThreads, (Layer<K, CIN, COUT>::kMinBlocks))
nc_conv4d_rows_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, const Geo g) {
  using L = Layer<K, CIN, COUT>;
  constexpr int D = L::D, NT = L::NT, P = L::kPitch;
  constexpr bool kTaps = L::kMode == kTapsK;
  static_assert(NT == 1 || NT % 2 == 0, "B fragments load n-tiles in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  long long* boff = reinterpret_cast<long long*>(smem);
  unsigned char* stages = smem + round16(g.box * 8);
  const Block blk = decode(g);
  const Taps taps(K, D, g, blk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int n_out = g.G * g.R * g.Wc;
  box_offsets<D>(boff, g, blk);
  __syncthreads();

  // stage (p, q) number t into slot `slot` (taps in K: its weights; the
  // expanded box comes from the Segment)
  auto stage = [&](int t, int slot) {
    const int p = taps.p(t), q = taps.q(t);
    unsigned char* base = stages + slot * g.stage_bytes;
    auto* sin = reinterpret_cast<__nv_bfloat16*>(base);
    auto* sw = reinterpret_cast<__nv_bfloat16*>(base + g.in_bytes);
    if constexpr (!kTaps)
      stage_box<CIN, L::kWidth, P>(x, sin, boff, g, blk.i + p - D,
                                   blk.j + q - D);
    const __nv_bfloat16* slab =
        w + static_cast<int64_t>(p * K + q) * (K * K * CIN * COUT);
    if constexpr (kTaps) {
      // rows (k-step j, half h, s): tap (2 j + h, s), columns C_out
      auto tap = [](int row) {
        const int r = 2 * (row >> 4) + ((row >> 3) & 1), sc = row & 7;
        return r < K && sc < K ? r * K + sc : -1;
      };
      if constexpr (COUT == L::kWidth) {
        constexpr int kChunks = COUT / 8, kShift = log2_of(kChunks);
        for (int e = threadIdx.x; e < L::kWRows * kChunks; e += kThreads) {
          const int row = e >> kShift, h = e & (kChunks - 1), rs = tap(row);
          tc::cp_async16(sw + row * P + 8 * h,
                         rs >= 0 ? slab + rs * COUT + 8 * h : slab,
                         rs >= 0 ? 16 : 0);
        }
      } else {
        for (int e = threadIdx.x; e < L::kWRows * L::kWidth; e += kThreads) {
          const int row = e / L::kWidth, co = e % L::kWidth, rs = tap(row);
          sw[row * P + co] = (rs >= 0 && co < COUT)
                                 ? slab[rs * COUT + co]
                                 : __float2bfloat16_rn(0.f);
        }
      }
    } else if constexpr (CIN == 16 && COUT == 16) {
      // rows (r, s, ci), columns C_out
      stage_rows<16, 16, P>(sw, slab, L::kWRows, L::kWRows, 16);
    } else {
      for (int e = threadIdx.x; e < L::kWRows * 16; e += kThreads) {
        const int row = e / 16, co = e % 16;
        const int rs = row / 16, ci = row % 16;
        sw[row * P + co] = (ci < CIN && co < COUT)
                               ? slab[(rs * CIN + ci) * COUT + co]
                               : __float2bfloat16_rn(0.f);
      }
    }
  };

  // this lane's ldmatrix row of each of its m-tiles: its box cell at tap
  // (0, 0) (channels), or its expanded cell at tap row 0 (taps in K)
  bool active[kMTW];
  int a_at[kMTW];
#pragma unroll
  for (int u = 0; u < kMTW; ++u) {
    const int mt = warp + kWarps * u;
    active[u] = mt * 16 < n_out;
    int m = mt * 16 + (lane & 15);
    m = m < n_out ? m : 0;
    if constexpr (kTaps) {
      const int lc = m % g.Wc, rest = m / g.Wc;
      a_at[u] = ((rest / g.R) * g.Hp + rest % g.R) * g.Wc + lc;
    } else {
      a_at[u] = box_cell(g, m) * P + (lane >> 4) * 8;
    }
  }

  float acc[kMTW][NT][4];
#pragma unroll
  for (int u = 0; u < kMTW; ++u)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][nt][v] = 0.f;

  // B fragments of weight rows row0..row0+15 (ldmatrix.trans), n-tiles in
  // pairs of 16 columns
  auto load_b = [&](const __nv_bfloat16* sw, int row0, uint32_t* bw) {
    const __nv_bfloat16* at =
        sw + (row0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * P;
    if constexpr (NT == 1) {
      tc::ldmatrix_x2_trans(bw, at);
    } else {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        tc::ldmatrix_x4_trans(bw + 4 * np, at + 16 * np + (lane >> 4) * 8);
    }
  };

  auto compute = [&](int slot) {
    const unsigned char* base = stages + slot * g.stage_bytes;
    const auto* sin = reinterpret_cast<const __nv_bfloat16*>(base);
    const auto* sw = reinterpret_cast<const __nv_bfloat16*>(base + g.in_bytes);
    if constexpr (kTaps) {
      // k-step j: matrices 0, 1 the tap row 2 j of the 16 rows' expanded
      // cells, 2, 3 the row 2 j + 1 (clamped to a real row past K - 1:
      // its weights are zero)
#pragma unroll
      for (int j = 0; j < L::KS; ++j) {
        uint32_t bw[2 * NT];
        load_b(sw, 16 * j, bw);
        const int r = min(2 * j + (lane >> 4), K - 1);
#pragma unroll
        for (int u = 0; u < kMTW; ++u) {
          if (!active[u]) continue;
          uint32_t a[4];
          tc::ldmatrix_x4(a, sin + (a_at[u] + r * g.Wc) * kShifts);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) tc::mma_bf16(acc[u][nt], a, bw + 2 * nt);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < K; ++r) {
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const int tap = (r * g.Wp + s) * P;
          uint32_t bw[2 * NT];
          load_b(sw, (r * K + s) * 16, bw);
#pragma unroll
          for (int u = 0; u < kMTW; ++u) {
            if (!active[u]) continue;
            uint32_t a[4];
            tc::ldmatrix_x4(a, sin + a_at[u] + tap);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) tc::mma_bf16(acc[u][nt], a, bw + 2 * nt);
          }
        }
      }
    }
  };

  if constexpr (kTaps) {
    Segment<K> seg(g);
    auto plane = [&](int t) {
      return (static_cast<long long>(blk.i + taps.p(t) - D) * g.wA + blk.j +
              taps.q(t) - D) * g.hB * g.wB;
    };
    auto expanded = [&](int slot) {
      return reinterpret_cast<__nv_bfloat16*>(stages + slot * g.stage_bytes);
    };
    stage(0, 0);
    tc::cp_async_commit();
    seg.load(x, boff, plane(0));
    seg.store(expanded(0));
    for (int t = 0; t < taps.n; ++t) {
      tc::cp_async_wait_all();
      __syncthreads();  // (p, q) landed; the previous one is no longer read
      const bool next = t + 1 < taps.n;
      if (next) {
        stage(t + 1, (t + 1) & 1);
        seg.load(x, boff, plane(t + 1));
      }
      tc::cp_async_commit();
      compute(t & 1);
      if (next) seg.store(expanded((t + 1) & 1));
    }
  } else {
    stage(0, 0);
    tc::cp_async_commit();
    for (int t = 0; t < taps.n; ++t) {
      tc::cp_async_wait_all();
      __syncthreads();  // (p, q) landed; the previous one is no longer read
      if (t + 1 < taps.n) stage(t + 1, (t + 1) & 1);
      tc::cp_async_commit();
      compute(t & 1);
    }
  }

#pragma unroll
  for (int u = 0; u < kMTW; ++u) {
    if (!active[u]) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (warp + kWarps * u) * 16 + gq + 8 * h;
      if (m >= n_out) continue;
      const int64_t cell = out_cell(g, blk, m);
      if (cell < 0) continue;
      __nv_bfloat16* o = out + cell * COUT;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = nt * 8 + 2 * t4;
        float v[2] = {acc[u][nt][2 * h], acc[u][nt][2 * h + 1]};
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (BIAS_RELU && co + c < COUT)
            v[c] = fmaxf(v[c] + __bfloat162float(bias[co + c]), 0.f);
        if (COUT % 2 == 0 && co + 1 < COUT) {
          *reinterpret_cast<uint32_t*>(o + co) = tc::pack_f32(v[0], v[1]);
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (co + c < COUT) o[co + c] = __float2bfloat16_rn(v[c]);
        }
      }
    }
  }
}

// The taps-in-N mode (C_out <= 4): per (p, q), P (n, cell) = the box cells'
// channels times the (n = (r, s, co), ci) weights, f32 in shared memory;
// then every output (cell, co) adds P ((r, s, co), cell + (r, s)) over the
// k^2 taps into its f32 register.
template <int K, int CIN, int COUT, bool BIAS_RELU>
__global__ void __launch_bounds__(kThreads, 2)
nc_conv4d_taps_n_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, const Geo g) {
  using L = Layer<K, CIN, COUT>;
  constexpr int D = L::D, PITCH = L::kPitch, KST = L::KSTEPS;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* boff = reinterpret_cast<long long*>(smem);
  unsigned char* stages = smem + round16(g.box * 8);
  float* P = reinterpret_cast<float*>(stages + 2 * g.stage_bytes);
  const Block blk = decode(g);
  const Taps taps(K, D, g, blk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int n_out = g.G * g.R * g.Wc;
  const int box_mt = (g.box + 15) / 16;
  box_offsets<D>(boff, g, blk);
  __syncthreads();

  auto stage = [&](int t) {
    const int p = taps.p(t), q = taps.q(t);
    unsigned char* base = stages + (t & 1) * g.stage_bytes;
    auto* sin = reinterpret_cast<__nv_bfloat16*>(base);
    auto* sw = reinterpret_cast<__nv_bfloat16*>(base + g.in_bytes);
    stage_box<CIN, L::kWidth, PITCH>(x, sin, boff, g, blk.i + p - D,
                                     blk.j + q - D);
    const __nv_bfloat16* slab =
        w + static_cast<int64_t>(p * K + q) * (K * K * CIN * COUT);
    if constexpr (COUT == 1) {
      // the slab (r, s, ci) is already (n, ci)
      stage_rows<CIN, L::kWidth, PITCH>(sw, slab, L::NPAD, K * K, CIN);
    } else {
      constexpr int kShift = log2_of(L::kWidth);
      for (int e = threadIdx.x; e < L::kWidth * L::NPAD; e += kThreads) {
        const int n = e >> kShift, ci = e & (L::kWidth - 1);
        const int rs = n / COUT, co = n % COUT;
        sw[n * PITCH + ci] = (ci < CIN && n < K * K * COUT)
                                 ? slab[(rs * CIN + ci) * COUT + co]
                                 : __float2bfloat16_rn(0.f);
      }
    }
  };

  // this thread's outputs (cell, co) and their box cells at tap (0, 0)
  float acc[kOutPerThread];
  int at[kOutPerThread];
#pragma unroll
  for (int u = 0; u < kOutPerThread; ++u) {
    acc[u] = 0.f;
    const int o = threadIdx.x + kThreads * u;
    at[u] = o < n_out * COUT
                ? (o % COUT) * g.p_pitch + box_cell(g, o / COUT)
                : -1;
  }

  stage(0);
  tc::cp_async_commit();
  for (int t = 0; t < taps.n; ++t) {
    tc::cp_async_wait_all();
    __syncthreads();  // (p, q) landed; P and the previous stage are free
    if (t + 1 < taps.n) stage(t + 1);
    tc::cp_async_commit();
    const unsigned char* base = stages + (t & 1) * g.stage_bytes;
    const auto* sin = reinterpret_cast<const __nv_bfloat16*>(base);
    const auto* sw = reinterpret_cast<const __nv_bfloat16*>(base + g.in_bytes);
    // B fragments per k-step of 16 channels and n-tile
    uint32_t bw[KST][L::NTN][2];
#pragma unroll
    for (int ks = 0; ks < KST; ++ks)
#pragma unroll
      for (int nt = 0; nt < L::NTN; ++nt)
        tc::ldmatrix_x2(bw[ks][nt], sw + (nt * 8 + (lane & 7)) * PITCH +
                                        16 * ks + ((lane >> 3) & 1) * 8);
    // the warp's box m-tiles, kBoxMTW at a time: their A fragments first,
    // then the products
    for (int mt0 = warp; mt0 < box_mt; mt0 += kWarps * L::kBoxMTW) {
      uint32_t a[L::kBoxMTW][KST][4];
#pragma unroll
      for (int u = 0; u < L::kBoxMTW; ++u) {
        const int row = min((mt0 + kWarps * u) * 16 + (lane & 15), g.box - 1);
        if (mt0 + kWarps * u < box_mt) {
#pragma unroll
          for (int ks = 0; ks < KST; ++ks)
            tc::ldmatrix_x4(a[u][ks],
                            sin + row * PITCH + 16 * ks + (lane >> 4) * 8);
        }
      }
#pragma unroll
      for (int u = 0; u < L::kBoxMTW; ++u) {
        const int mt = mt0 + kWarps * u;
        if (mt >= box_mt) break;
        const int r0 = mt * 16 + gq, r1 = r0 + 8;
#pragma unroll
        for (int nt = 0; nt < L::NTN; ++nt) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < KST; ++ks) tc::mma_bf16(d, a[u][ks], bw[ks][nt]);
          const int n = nt * 8 + 2 * t4;
          float* col = P + n * g.p_pitch;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (n + c >= L::kPRows) continue;
            if (r0 < g.box) col[c * g.p_pitch + r0] = d[c];
            if (r1 < g.box) col[c * g.p_pitch + r1] = d[2 + c];
          }
        }
      }
    }
    __syncthreads();  // P is complete
#pragma unroll
    for (int u = 0; u < kOutPerThread; ++u) {
      if (at[u] < 0) continue;
#pragma unroll
      for (int r = 0; r < K; ++r)
#pragma unroll
        for (int s = 0; s < K; ++s)
          acc[u] += P[(r * K + s) * COUT * g.p_pitch + at[u] + r * g.Wp + s];
    }
  }

#pragma unroll
  for (int u = 0; u < kOutPerThread; ++u) {
    const int o = threadIdx.x + kThreads * u;
    if (o >= n_out * COUT) continue;
    const int co = o % COUT;
    const int64_t cell = out_cell(g, blk, o / COUT);
    if (cell < 0) continue;
    float v = acc[u];
    if (BIAS_RELU) v = fmaxf(v + __bfloat162float(bias[co]), 0.f);
    out[cell * COUT + co] = __float2bfloat16_rn(v);
  }
}

// Shared memory of a tiling (filling in its box and stage sizes): the box
// offsets, then two stages (P after them for the taps in N); SIZE_MAX for
// a tiling the mode's per-thread arrays cannot cover.
template <int K, int CIN, int COUT>
size_t smem_bytes(Geo& g) {
  using L = Layer<K, CIN, COUT>;
  g.Hp = g.R + 2 * L::D;
  g.Wp = g.Wc + 2 * L::D;
  g.box = g.G * g.Hp * g.Wp;
  const size_t offsets = round16(g.box * 8);
  g.p_pitch = 0;
  if (L::kMode == kTapsN) {
    g.in_bytes = round16(g.box * L::kPitch * 2);
    g.stage_bytes = g.in_bytes + L::NPAD * L::kPitch * 2;
    // the smallest pitch >= box that is 4 mod 32 words, so the fragment
    // stores of 8 rows x 4 columns fall on distinct banks
    g.p_pitch = (g.box + 27) / 32 * 32 + 4;
    return offsets + 2 * static_cast<size_t>(g.stage_bytes) +
           static_cast<size_t>(L::kPRows) * g.p_pitch * sizeof(float);
  }
  if (L::kMode == kTapsK) {
    // one row segment of the expanded box a thread
    if (g.G * g.Hp * ((g.Wc + 7) / 8) > kThreads) return SIZE_MAX;
    g.in_bytes = round16(g.G * g.Hp * g.Wc * kShifts * 2);
  } else {
    g.in_bytes = round16(g.box * L::kPitch * 2);
  }
  g.stage_bytes = g.in_bytes + L::kWRows * L::kPitch * 2;
  return offsets + 2 * static_cast<size_t>(g.stage_bytes);
}

// the kernel of a layer shape (only that one is instantiated)
template <int K, int CIN, int COUT, bool BIAS_RELU>
auto kernel_of() {
  if constexpr (Layer<K, CIN, COUT>::kMode == kTapsN)
    return nc_conv4d_taps_n_kernel<K, CIN, COUT, BIAS_RELU>;
  else
    return nc_conv4d_rows_kernel<K, CIN, COUT, BIAS_RELU>;
}

template <int K, int CIN, int COUT, bool BIAS_RELU>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int B, int hA, int wA, int hB, int wB,
                   cudaStream_t stream) {
  if (static_cast<int64_t>(B) * hA * wA * hB * wB <= 0) return cudaSuccess;
  // the block: whole planes of as many volumes as kMaxOut cells hold, else
  // bands of rows, else of columns; shrunk until two blocks fit an SM
  Geo g{B, hA, wA, hB, wB};
  g.Wc = wB < kMaxOut ? wB : kMaxOut;
  g.R = hB < kMaxOut / g.Wc ? hB : (kMaxOut / g.Wc > 0 ? kMaxOut / g.Wc : 1);
  g.G = 1;
  if (g.R == hB && g.Wc == wB) {
    const int fit = kMaxOut / (hB * wB);
    g.G = B < fit ? B : (fit > 0 ? fit : 1);
  }
  size_t smem;
  while ((smem = smem_bytes<K, CIN, COUT>(g)) > kSmemBudget) {
    if (g.G > 1)
      --g.G;
    else if (g.R > 1)
      --g.R;
    else if (g.Wc > 1)
      g.Wc = (g.Wc + 1) / 2;
    else
      return cudaErrorInvalidValue;
  }
  g.n_rb = (hB + g.R - 1) / g.R;
  g.n_cb = (wB + g.Wc - 1) / g.Wc;
  const int64_t blocks = static_cast<int64_t>((B + g.G - 1) / g.G) * hA * wA *
                         g.n_rb * g.n_cb;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = kernel_of<K, CIN, COUT, BIAS_RELU>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out),
      g);
  return cudaGetLastError();
}

}  // namespace

// The (k, C_in, C_out) layer shapes whose forward and transposed variant
// (the backward's input gradient, of the transpose (k, C_out, C_in)) are
// compiled in: the PF-Pascal stack (5: 1->16, 16->16, 16->1), the
// IVD/InLoc stack (3: 1->16, 16->1), the default ModelConfig stack
// (3: 1->10, 10->10, 10->1) and the thin test stacks (channels 1, 2 and 4
// at k = 3 and 5); csrc/nc_conv4d_vjp.cu repeats the list.
#define NC_CONV4D_TRANSPOSE_SHAPES(X)                                        \
  X(5, 1, 16) X(5, 16, 16) X(5, 16, 1)                                       \
  X(3, 1, 16) X(3, 16, 16) X(3, 16, 1)                                       \
  X(3, 1, 10) X(3, 10, 10) X(3, 10, 1)                                       \
  X(3, 1, 1) X(3, 1, 2) X(3, 1, 4) X(3, 2, 1) X(3, 2, 2) X(3, 4, 1)          \
  X(3, 4, 2) X(3, 4, 4)                                                      \
  X(5, 1, 1) X(5, 1, 2) X(5, 1, 4) X(5, 2, 1) X(5, 2, 2) X(5, 4, 1)          \
  X(5, 4, 2) X(5, 4, 4)

// The layer shapes the forward is compiled for: those above and, forward
// only, the IVD stack's tap-swap chain (3: 1->32, 32->2; ncnet_tpu_torch/
// models/ncnet.py::tap_swap_chain) that filters a rectangular symmetric
// volume.
#define NC_CONV4D_SHAPES(X)                                                  \
  NC_CONV4D_TRANSPOSE_SHAPES(X) X(3, 1, 32) X(3, 32, 2)

extern "C" {

// 1 when the forward layer shape is compiled in, else 0
int nc_conv4d_supported(int k, int c_in, int c_out) {
#define NC_SUPPORTED(K, CI, CO) \
  if (k == K && c_in == CI && c_out == CO) return 1;
  NC_CONV4D_SHAPES(NC_SUPPORTED)
#undef NC_SUPPORTED
  return 0;
}

// Enqueues one layer on `stream`; returns the cudaError_t of the launch
// (0 on success), or -1 for a shape that is not compiled in.  x and w must
// start on 16 bytes.
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
// of the launch, or -1 for a shape that is not compiled in.
int nc_conv4d_transpose_bf16(const void* gz, const void* wt, void* out, int B,
                             int hA, int wA, int hB, int wB, int k, int c_in,
                             int c_out, void* stream) {
#define NC_LAUNCH_T(K, CI, CO)                                            \
  if (k == K && c_in == CI && c_out == CO)                                \
    return static_cast<int>(launch<K, CO, CI, false>(                     \
        gz, wt, nullptr, out, B, hA, wA, hB, wB,                          \
        static_cast<cudaStream_t>(stream)));
  NC_CONV4D_TRANSPOSE_SHAPES(NC_LAUNCH_T)
#undef NC_LAUNCH_T
  return -1;
}

const char* nc_conv4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
