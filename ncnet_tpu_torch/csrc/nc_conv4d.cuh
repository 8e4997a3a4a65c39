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
// runs through the same kernels with a null bias: no bias, no ReLU.
//
// The layer shapes served are the TPU kernels' whole shape class: any odd
// k <= kMaxK and any widths 1 <= C_in, C_out <= kMaxWidth, in both
// directions.  The kernels are templated on k and on a padded channel class
// and take the true widths at run time: the staging zero-fills a cell or a
// weight row past them, loads and stores use them.  One translation unit a
// k (nc_conv4d_k<k>.cu defines NC_K and includes this file), so the builds
// run in parallel.
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
// tested) and the (p, q) weight slab as bf16; where a slab would not fit
// twice beside the boxes (wide layers at k >= 5), it is staged RC tap rows
// r at a time, each chunk a step of the pipeline, the box once a (p, q).
// In the padded box the (r, s) tap of every output cell is the same
// constant offset, so each lane computes its rows' addresses once.  Three
// ways to fill the tensor cores, by layer shape:
//   - channels (C_in > 1, C_out > 4; the 16->16 layer): each (r, s) tap is
//     one k-step of 16 channels, two for C_in > 16 (C_in is zero-padded to
//     16 or 32), A is ldmatrix of 16 shifted cells (a 48- or 80-byte pitch:
//     the 8 rows of a matrix fall on distinct banks), B the tap's (C_in,
//     C_out) weights through ldmatrix.trans; 8 warps x 2 m-tiles x C_out / 8
//     n-tiles (C_out padded to 8, 16 or 32);
//   - taps in K (C_in = 1; the 1->16 layer, and the tap-swap chain's
//     1->32): the (r, s) taps are the
//     contraction, not C_in padded to 16 (16x its FLOP): an expanded box
//     holds each cell's 8 horizontal shifts (s, zeros past k) as one
//     16-byte row, so a k-step is two tap rows r and one ldmatrix; a
//     thread loads its row segment into registers before a (p, q) is
//     computed and stores it after, hiding the loads behind the product;
//     C_out = 32 is 4 n-tiles, its weight rows at an 80-byte pitch.  Eight
//     shift slots hold a tap row of k <= 7: k = 9 would need a second row;
//   - taps in N (C_out <= 4; the 16->1 layer, and the chain's block-
//     diagonal 32->2): per (p, q) one product of
//     every box cell's 16 channels with the (C_in, k^2 C_out) tap weights
//     gives each cell's partial for every (r, s) tap; the partials stay f32
//     in shared memory, and each output cell sums its k^2 shifted partials.
//     Padding N = C_out to 8 would cost 8x its FLOP.  C_in > 16 is two
//     k-steps of 16 channels, its cells staged at an 80-byte pitch (the 8
//     rows of a matrix still fall on distinct banks).  Where k^2 C_out
//     passes 100 columns (k = 7, C_out >= 3) the partials of RC tap rows
//     are formed and summed a chunk at a time, so their B fragments stay in
//     registers and their slab in shared memory.
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

#ifndef NC_K
#error "define NC_K, the kernel size of this translation unit"
#endif

namespace {

// The limits of the design; ncnet_tpu_torch/ops/nc_fused_lane.py's gate
// (kernels_hold) repeats them.
constexpr int kMaxK = 7;       // taps in K: a tap row's k shifts fill 8 slots
constexpr int kMaxWidth = 32;  // two 16-channel k-steps a cell; 4 n-tiles
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTW = 2;                       // m-tiles a warp holds
constexpr int kMaxOut = kWarps * kMTW * 16;   // output cells a block
constexpr int kOutPerThread = 4;              // taps in N: kMaxOut * 4 / kThreads
constexpr size_t kSmemBudget = 112 * 1024;    // two blocks an SM
constexpr int kShifts = 8;                    // taps in K: s slots a cell
constexpr int kSlabBudget = 24 * 1024;        // channels: a weight stage
constexpr int kMaxPartials = 100;             // taps in N: columns a chunk

static_assert(NC_K % 2 == 1 && NC_K <= kMaxK, "an odd k of the shape class");

enum Mode { kChannels, kTapsK, kTapsN };

__host__ __device__ constexpr Mode mode_of(int c_in, int c_out) {
  return c_in == 1 ? kTapsK : (c_out <= 4 ? kTapsN : kChannels);
}

// The class of a layer shape: CW, the staged input cell's channels (C_in
// padded to 16 or 32; 16 for the taps in K); OW, C_out padded to 8, 16 or
// 32 (channels, taps in K) or C_out itself (taps in N, 1..4).
__host__ __device__ constexpr int cw_of(int c_in) { return c_in > 16 ? 32 : 16; }
__host__ __device__ constexpr int ow_of(Mode m, int c_out) {
  return m == kTapsN ? c_out : (c_out > 16 ? 32 : (c_out > 8 ? 16 : 8));
}

template <int K, Mode MODE, int CW, int OW>
struct Layer {
  static constexpr int D = K / 2;
  static constexpr Mode kMode = MODE;
  static_assert(K % 2 == 1 && K <= kMaxK, "taps in K: a tap row fills 8 slots");
  static_assert(CW == 16 || CW == 32, "a staged cell is 16 or 32 channels");
  static constexpr int NT = (OW + 7) / 8;      // n-tiles of C_out (rows modes)
  static constexpr int KSTEPS = CW / 16;        // k-steps of C_in a tap
  // the input cell's pitch, 8 bf16 past its width (48 or 80 bytes), so the
  // 8 rows of an ldmatrix fall on distinct banks
  static constexpr int kInPitch = CW + 8;
  // a weight row: C_out columns padded to 16 or 32 (rows modes), C_in
  // padded to CW (taps in N); its pitch 8 bf16 past that
  static constexpr int kWWidth = MODE == kTapsN ? CW : (OW > 16 ? 32 : 16);
  static constexpr int kWPitch = kWWidth + 8;
  // taps in K: a k-step is two tap rows r of 8 columns s (s >= K zero)
  static constexpr int KS = (K + 1) / 2;
  // RC tap rows r a weight stage holds, NRC stages a (p, q)
  static constexpr int kRowBytes = K * CW * kWPitch * 2;  // channels
  static constexpr int RC =
      MODE == kTapsK ? K
      : MODE == kChannels
          ? (K * kRowBytes <= kSlabBudget
                 ? K
                 : (kSlabBudget / kRowBytes > 0 ? kSlabBudget / kRowBytes : 1))
          : (K * K * OW <= kMaxPartials ? K : kMaxPartials / (K * OW));
  static constexpr int NRC = (K + RC - 1) / RC;
  // taps in N: the partial columns n = (r of the chunk, s, co), padded to
  // 8; weights staged as rows n of CW ci at kInPitch
  static constexpr int kPRows = RC * K * OW;
  static constexpr int NPAD = (kPRows + 7) / 8 * 8;
  static constexpr int NTN = NPAD / 8;
  // weight rows staged a step, kWPitch bf16 each: (r, s, ci) with ci padded
  // to CW, (k-step, r % 2, s) for the taps in K, n for the taps in N
  static constexpr int kWRows =
      MODE == kTapsK ? 16 * KS : (MODE == kChannels ? RC * K * CW : NPAD);
  // box m-tiles a warp loads ahead (taps in N): 2 while its B fragments
  // are few enough to stay in registers beside them
  static constexpr int kBoxMTW = NTN > 4 ? 1 : 2;
  // blocks an SM: the taps in K need little shared memory, and three
  // blocks while their C_out sums fit the registers
  static constexpr int kMinBlocks = MODE == kTapsK && NT <= 2 ? 3 : 2;
};

// the block tiling of one launch (host-chosen, uniform in the grid)
struct Geo {
  int B, hA, wA, hB, wB;
  int cin, cout;   // the true widths
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

// Stage the input box of plane (ii, jj) into `sin`: cin channels a cell
// at PITCH (zeros to WIDTH; 16-byte cp.async copies of 8-channel chunks
// when cin is a multiple of 8); zeros outside the volume.
template <int WIDTH, int PITCH>
__device__ __forceinline__ void stage_box(const __nv_bfloat16* __restrict__ x,
                                          __nv_bfloat16* sin,
                                          const long long* boff, const Geo& g,
                                          int ii, int jj, int cin) {
  const long long po =
      (static_cast<long long>(ii) * g.wA + jj) * g.hB * g.wB;
  if (cin % 8 == 0) {
    constexpr int kChunks = WIDTH / 8, kShift = log2_of(kChunks);
    for (int e = threadIdx.x; e < kChunks * g.box; e += kThreads) {
      const int cell = e >> kShift, h = e & (kChunks - 1);
      const long long o = boff[cell];
      const bool ok = o >= 0 && 8 * h < cin;
      tc::cp_async16(sin + cell * PITCH + 8 * h,
                     ok ? x + (o + po) * cin + 8 * h : x, ok ? 16 : 0);
    }
  } else {
    constexpr int kShift = log2_of(WIDTH);
    for (int e = threadIdx.x; e < WIDTH * g.box; e += kThreads) {
      const int cell = e >> kShift, c = e & (WIDTH - 1);
      const long long o = boff[cell];
      sin[cell * PITCH + c] = (c < cin && o >= 0)
                                  ? x[(o + po) * cin + c]
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

// Stage `rows` weight rows of WIDTH bf16 at PITCH from a (rows_in, cols)
// matrix: row n, column c is src[n * cols + c] for n < rows_in and c <
// cols, else 0.  16-byte copies of 8-column chunks when cols is a multiple
// of 8.
template <int WIDTH, int PITCH>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int rows,
                                           int rows_in, int cols) {
  if (cols % 8 == 0) {
    constexpr int kChunks = WIDTH / 8, kShift = log2_of(kChunks);
    for (int e = threadIdx.x; e < kChunks * rows; e += kThreads) {
      const int n = e >> kShift, h = e & (kChunks - 1);
      const bool ok = n < rows_in && 8 * h < cols;
      tc::cp_async16(dst + n * PITCH + 8 * h,
                     ok ? src + n * cols + 8 * h : src, ok ? 16 : 0);
    }
  } else {
    constexpr int kShift = log2_of(WIDTH);
    for (int e = threadIdx.x; e < WIDTH * rows; e += kThreads) {
      const int n = e >> kShift, c = e & (WIDTH - 1);
      dst[n * PITCH + c] = (n < rows_in && c < cols)
                               ? src[n * cols + c]
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
// one (p, q) (or one chunk of its tap rows) at a time, double-buffered (the
// taps in K build their expanded box from registers loaded a (p, q) ahead).
// FULL: the widths are the class's own (C_in = CW, or 1 for the taps in K;
// C_out = OW), compiled in as constants; otherwise they are read from g.
// A null bias is the transposed launch: no bias, no ReLU.
template <int K, Mode MODE, int CW, int OW, bool FULL>
__global__ void __launch_bounds__(kThreads,
                                  (Layer<K, MODE, CW, OW>::kMinBlocks))
nc_conv4d_rows_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, const Geo g) {
  using L = Layer<K, MODE, CW, OW>;
  constexpr int D = L::D, NT = L::NT, P = L::kInPitch, WP = L::kWPitch;
  constexpr int RC = L::RC, NRC = L::NRC;
  constexpr bool kTaps = MODE == kTapsK;
  static_assert(NT == 1 || NT % 2 == 0, "B fragments load n-tiles in pairs");
  static_assert(!kTaps || NRC == 1, "taps in K: one weight stage a (p, q)");
  extern __shared__ __align__(16) unsigned char smem[];
  long long* boff = reinterpret_cast<long long*>(smem);
  unsigned char* stages = smem + round16(g.box * 8);
  const Block blk = decode(g);
  const Taps taps(K, D, g, blk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int n_out = g.G * g.R * g.Wc;
  const int cin = FULL ? (kTaps ? 1 : CW) : g.cin;
  const int cout = FULL ? OW : g.cout;
  box_offsets<D>(boff, g, blk);
  __syncthreads();

  auto box_at = [&](int slot) {
    return reinterpret_cast<__nv_bfloat16*>(stages + slot * g.stage_bytes);
  };
  auto w_at = [&](int slot) {
    return reinterpret_cast<__nv_bfloat16*>(stages + slot * g.stage_bytes +
                                            g.in_bytes);
  };
  // the input box of (p, q) number t into box slot `slot` (not the taps
  // in K: their expanded box comes from the Segment)
  auto stage_in = [&](int t, int slot) {
    stage_box<CW, P>(x, box_at(slot), boff, g, blk.i + taps.p(t) - D,
                     blk.j + taps.q(t) - D, cin);
  };
  // the weights of (p, q) number t, tap-row chunk c, into weight slot `slot`
  auto stage_w = [&](int t, int c, int slot) {
    const int p = taps.p(t), q = taps.q(t);
    __nv_bfloat16* sw = w_at(slot);
    const __nv_bfloat16* slab =
        w + static_cast<int64_t>(p * K + q) * (K * K * cin * cout);
    if constexpr (kTaps) {
      // rows (k-step j, half h, s): tap (2 j + h, s), columns C_out
      auto tap = [](int row) {
        const int r = 2 * (row >> 4) + ((row >> 3) & 1), sc = row & 7;
        return r < K && sc < K ? r * K + sc : -1;
      };
      if (cout % 8 == 0) {
        constexpr int kChunks = L::kWWidth / 8, kShift = log2_of(kChunks);
        for (int e = threadIdx.x; e < L::kWRows * kChunks; e += kThreads) {
          const int row = e >> kShift, h = e & (kChunks - 1), rs = tap(row);
          const bool ok = rs >= 0 && 8 * h < cout;
          tc::cp_async16(sw + row * WP + 8 * h,
                         ok ? slab + rs * cout + 8 * h : slab, ok ? 16 : 0);
        }
      } else {
        constexpr int kShift = log2_of(L::kWWidth);
        for (int e = threadIdx.x; e < L::kWRows * L::kWWidth; e += kThreads) {
          const int row = e >> kShift, co = e & (L::kWWidth - 1), rs = tap(row);
          sw[row * WP + co] = (rs >= 0 && co < cout)
                                  ? slab[rs * cout + co]
                                  : __float2bfloat16_rn(0.f);
        }
      }
    } else {
      // rows (r of the chunk, s, ci), ci padded to CW; columns C_out
      const int r0 = c * RC;
      const int rows_in = (K - r0 < RC ? K - r0 : RC) * K;
      const __nv_bfloat16* src = slab + static_cast<int64_t>(r0) * K * cin * cout;
      if (cin == CW) {
        stage_rows<L::kWWidth, WP>(sw, src, L::kWRows, rows_in * CW, cout);
      } else if (cin % 8 == 0 && cout % 8 == 0) {
        // rows (r, s, ci) of cin ci: each 8-channel chunk of C_out a copy,
        // the rows past cin zeros
        constexpr int kChunks = L::kWWidth / 8, kShift = log2_of(kChunks);
        for (int e = threadIdx.x; e < L::kWRows * kChunks; e += kThreads) {
          const int row = e >> kShift, h = e & (kChunks - 1);
          const int rs = row / CW, ci = row % CW;
          const bool ok = rs < rows_in && ci < cin && 8 * h < cout;
          tc::cp_async16(sw + row * WP + 8 * h,
                         ok ? src + (rs * cin + ci) * cout + 8 * h : src,
                         ok ? 16 : 0);
        }
      } else {
        constexpr int kShift = log2_of(L::kWWidth);
        for (int e = threadIdx.x; e < L::kWRows * L::kWWidth; e += kThreads) {
          const int row = e >> kShift, co = e & (L::kWWidth - 1);
          const int rs = row / CW, ci = row % CW;
          sw[row * WP + co] = (rs < rows_in && ci < cin && co < cout)
                                  ? src[(rs * cin + ci) * cout + co]
                                  : __float2bfloat16_rn(0.f);
        }
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
        sw + (row0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * WP;
    if constexpr (NT == 1) {
      tc::ldmatrix_x2_trans(bw, at);
    } else {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        tc::ldmatrix_x4_trans(bw + 4 * np, at + 16 * np + (lane >> 4) * 8);
    }
  };

  auto compute = [&](const __nv_bfloat16* sin, const __nv_bfloat16* sw,
                     int c) {
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
      for (int rr = 0; rr < RC; ++rr) {
        const int r = c * RC + rr;
        if (NRC > 1 && r >= K) break;
#pragma unroll
        for (int s = 0; s < K; ++s) {
#pragma unroll
          for (int ks = 0; ks < L::KSTEPS; ++ks) {
            const int tap = (r * g.Wp + s) * P + 16 * ks;
            uint32_t bw[2 * NT];
            load_b(sw, (rr * K + s) * CW + 16 * ks, bw);
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
    }
  };

  if constexpr (kTaps) {
    Segment<K> seg(g);
    auto plane = [&](int t) {
      return (static_cast<long long>(blk.i + taps.p(t) - D) * g.wA + blk.j +
              taps.q(t) - D) * g.hB * g.wB;
    };
    stage_w(0, 0, 0);
    tc::cp_async_commit();
    seg.load(x, boff, plane(0));
    seg.store(box_at(0));
    for (int t = 0; t < taps.n; ++t) {
      tc::cp_async_wait_all();
      __syncthreads();  // (p, q) landed; the previous one is no longer read
      const bool next = t + 1 < taps.n;
      if (next) {
        stage_w(t + 1, 0, (t + 1) & 1);
        seg.load(x, boff, plane(t + 1));
      }
      tc::cp_async_commit();
      compute(box_at(t & 1), w_at(t & 1), 0);
      if (next) seg.store(box_at((t + 1) & 1));
    }
  } else {
    // step st = (p, q) number t, tap-row chunk c: the box lives in slot
    // t % 2 for the NRC steps of t, the weights in slot st % 2
    const int n_steps = taps.n * NRC;
    stage_in(0, 0);
    stage_w(0, 0, 0);
    tc::cp_async_commit();
    for (int st = 0; st < n_steps; ++st) {
      const int t = st / NRC, c = st % NRC;
      tc::cp_async_wait_all();
      __syncthreads();  // step landed; the previous one is no longer read
      if (st + 1 < n_steps) {
        const int t1 = (st + 1) / NRC, c1 = (st + 1) % NRC;
        stage_w(t1, c1, (st + 1) & 1);
        if (c == 0 && t + 1 < taps.n) stage_in(t + 1, (t + 1) & 1);
      }
      tc::cp_async_commit();
      compute(box_at(t & 1), w_at(st & 1), c);
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
      __nv_bfloat16* o = out + cell * cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = nt * 8 + 2 * t4;
        float v[2] = {acc[u][nt][2 * h], acc[u][nt][2 * h + 1]};
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (bias != nullptr && co + c < cout)
            v[c] = fmaxf(v[c] + __bfloat162float(bias[co + c]), 0.f);
        if (cout % 2 == 0 && co + 1 < cout) {
          *reinterpret_cast<uint32_t*>(o + co) = tc::pack_f32(v[0], v[1]);
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (co + c < cout) o[co + c] = __float2bfloat16_rn(v[c]);
        }
      }
    }
  }
}

// The taps-in-N mode (C_out <= 4): per (p, q) and tap-row chunk, P (n,
// cell) = the box cells' channels times the (n = (r, s, co), ci) weights,
// f32 in shared memory; then every output (cell, co) adds P ((r, s, co),
// cell + (r, s)) over the chunk's taps into its f32 register.
// BIAS: the forward (bias + ReLU); without, the transposed launch.  A
// compile-time flag here: as a run-time test it cost the 32 -> 2 layer 5 %.
template <int K, Mode MODE, int CW, int OW, bool FULL, bool BIAS>
__global__ void __launch_bounds__(kThreads, 2)
nc_conv4d_taps_n_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, const Geo g) {
  using L = Layer<K, MODE, CW, OW>;
  constexpr int D = L::D, PITCH = L::kInPitch, KST = L::KSTEPS;
  constexpr int RC = L::RC, NRC = L::NRC, COUT = OW;
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
  const int cin = FULL ? CW : g.cin;
  box_offsets<D>(boff, g, blk);
  __syncthreads();

  auto box_at = [&](int slot) {
    return reinterpret_cast<__nv_bfloat16*>(stages + slot * g.stage_bytes);
  };
  auto w_at = [&](int slot) {
    return reinterpret_cast<__nv_bfloat16*>(stages + slot * g.stage_bytes +
                                            g.in_bytes);
  };
  auto stage_in = [&](int t, int slot) {
    stage_box<CW, PITCH>(x, box_at(slot), boff, g, blk.i + taps.p(t) - D,
                         blk.j + taps.q(t) - D, cin);
  };
  // rows n = (r of chunk c, s, co) of (p, q) number t, C_in columns
  auto stage_w = [&](int t, int c, int slot) {
    const int p = taps.p(t), q = taps.q(t);
    __nv_bfloat16* sw = w_at(slot);
    const int r0 = c * RC;
    const int n_in = (K - r0 < RC ? K - r0 : RC) * K * COUT;
    const __nv_bfloat16* slab =
        w + (static_cast<int64_t>(p * K + q) * K + r0) * K * cin * COUT;
    if constexpr (COUT == 1) {
      // the slab (r, s, ci) is already (n, ci)
      stage_rows<CW, PITCH>(sw, slab, L::NPAD, n_in, cin);
    } else {
      constexpr int kShift = log2_of(CW);
      for (int e = threadIdx.x; e < CW * L::NPAD; e += kThreads) {
        const int n = e >> kShift, ci = e & (CW - 1);
        const int rs = n / COUT, co = n % COUT;
        sw[n * PITCH + ci] = (ci < cin && n < n_in)
                                 ? slab[(rs * cin + ci) * COUT + co]
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

  const int n_steps = taps.n * NRC;
  stage_in(0, 0);
  stage_w(0, 0, 0);
  tc::cp_async_commit();
  for (int st = 0; st < n_steps; ++st) {
    const int t = st / NRC, c = st % NRC;
    tc::cp_async_wait_all();
    __syncthreads();  // step landed; P and the previous step are free
    if (st + 1 < n_steps) {
      stage_w((st + 1) / NRC, (st + 1) % NRC, (st + 1) & 1);
      if (c == 0 && t + 1 < taps.n) stage_in(t + 1, (t + 1) & 1);
    }
    tc::cp_async_commit();
    const __nv_bfloat16* sin = box_at(t & 1);
    const __nv_bfloat16* sw = w_at(st & 1);
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
          for (int c2 = 0; c2 < 2; ++c2) {
            if (n + c2 >= L::kPRows) continue;
            if (r0 < g.box) col[c2 * g.p_pitch + r0] = d[c2];
            if (r1 < g.box) col[c2 * g.p_pitch + r1] = d[2 + c2];
          }
        }
      }
    }
    __syncthreads();  // P is complete
#pragma unroll
    for (int u = 0; u < kOutPerThread; ++u) {
      if (at[u] < 0) continue;
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) {
        const int r = c * RC + rr;
        if (NRC > 1 && r >= K) break;
#pragma unroll
        for (int s = 0; s < K; ++s)
          acc[u] += P[(rr * K + s) * COUT * g.p_pitch + at[u] + r * g.Wp + s];
      }
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
    if (BIAS) v = fmaxf(v + __bfloat162float(bias[co]), 0.f);
    out[cell * COUT + co] = __float2bfloat16_rn(v);
  }
}

// Shared memory of a tiling (filling in its box and stage sizes): the box
// offsets, then two stages (P after them for the taps in N); SIZE_MAX for
// a tiling the mode's per-thread arrays cannot cover.
template <int K, Mode MODE, int CW, int OW>
size_t smem_bytes(Geo& g) {
  using L = Layer<K, MODE, CW, OW>;
  g.Hp = g.R + 2 * L::D;
  g.Wp = g.Wc + 2 * L::D;
  g.box = g.G * g.Hp * g.Wp;
  const size_t offsets = round16(g.box * 8);
  g.p_pitch = 0;
  if (MODE == kTapsN) {
    g.in_bytes = round16(g.box * L::kInPitch * 2);
    g.stage_bytes = g.in_bytes + L::NPAD * L::kInPitch * 2;
    // the smallest pitch >= box that is 4 mod 32 words, so the fragment
    // stores of 8 rows x 4 columns fall on distinct banks
    g.p_pitch = (g.box + 27) / 32 * 32 + 4;
    return offsets + 2 * static_cast<size_t>(g.stage_bytes) +
           static_cast<size_t>(L::kPRows) * g.p_pitch * sizeof(float);
  }
  if (MODE == kTapsK) {
    // one row segment of the expanded box a thread
    if (g.G * g.Hp * ((g.Wc + 7) / 8) > kThreads) return SIZE_MAX;
    g.in_bytes = round16(g.G * g.Hp * g.Wc * kShifts * 2);
  } else {
    g.in_bytes = round16(g.box * L::kInPitch * 2);
  }
  g.stage_bytes = g.in_bytes + L::kWRows * L::kWPitch * 2;
  return offsets + 2 * static_cast<size_t>(g.stage_bytes);
}

// the kernel of a layer class (only that one is instantiated)
template <int K, Mode MODE, int CW, int OW, bool FULL>
auto kernel_of(bool bias) {
  if constexpr (MODE == kTapsN)
    return bias ? nc_conv4d_taps_n_kernel<K, MODE, CW, OW, FULL, true>
                : nc_conv4d_taps_n_kernel<K, MODE, CW, OW, FULL, false>;
  else
    return nc_conv4d_rows_kernel<K, MODE, CW, OW, FULL>;
}

// The tiling of a launch: whole planes of as many volumes as kMaxOut
// cells hold, else bands of rows, else of columns; shrunk until two blocks
// fit an SM.  Returns the shared memory, or 0 when no tiling fits.
template <int K, Mode MODE, int CW, int OW>
size_t tile(Geo& g) {
  const int hB = g.hB, wB = g.wB, B = g.B;
  g.Wc = wB < kMaxOut ? wB : kMaxOut;
  g.R = hB < kMaxOut / g.Wc ? hB : (kMaxOut / g.Wc > 0 ? kMaxOut / g.Wc : 1);
  g.G = 1;
  if (g.R == hB && g.Wc == wB) {
    const int fit = kMaxOut / (hB * wB);
    g.G = B < fit ? B : (fit > 0 ? fit : 1);
  }
  size_t smem;
  while ((smem = smem_bytes<K, MODE, CW, OW>(g)) > kSmemBudget) {
    if (g.G > 1)
      --g.G;
    else if (g.R > 1)
      --g.R;
    else if (g.Wc > 1)
      g.Wc = (g.Wc + 1) / 2;
    else
      return 0;
  }
  return smem;
}

template <int K, Mode MODE, int CW, int OW, bool FULL>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   Geo g, cudaStream_t stream) {
  const size_t smem = tile<K, MODE, CW, OW>(g);
  if (smem == 0) return cudaErrorInvalidValue;
  g.n_rb = (g.hB + g.R - 1) / g.R;
  g.n_cb = (g.wB + g.Wc - 1) / g.Wc;
  const int64_t blocks = static_cast<int64_t>((g.B + g.G - 1) / g.G) * g.hA *
                         g.wA * g.n_rb * g.n_cb;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = kernel_of<K, MODE, CW, OW, FULL>(b != nullptr);
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

// Calls f.template run<MODE, CW, OW>() for the class of a layer shape
// (c_in, c_out) within the limits: the one dispatch of the launches and of
// the shared-memory check.
template <typename F>
auto with_class(int c_in, int c_out, const F& f) {
  const Mode m = mode_of(c_in, c_out);
  const int cw = cw_of(c_in), ow = ow_of(m, c_out);
  if (m == kTapsK) {
    if (ow == 8) return f.template run<kTapsK, 16, 8>();
    if (ow == 16) return f.template run<kTapsK, 16, 16>();
    return f.template run<kTapsK, 16, 32>();
  }
  if (m == kTapsN) {
    if (cw == 16) {
      if (ow == 1) return f.template run<kTapsN, 16, 1>();
      if (ow == 2) return f.template run<kTapsN, 16, 2>();
      if (ow == 3) return f.template run<kTapsN, 16, 3>();
      return f.template run<kTapsN, 16, 4>();
    }
    if (ow == 1) return f.template run<kTapsN, 32, 1>();
    if (ow == 2) return f.template run<kTapsN, 32, 2>();
    if (ow == 3) return f.template run<kTapsN, 32, 3>();
    return f.template run<kTapsN, 32, 4>();
  }
  if (cw == 16) {
    if (ow == 8) return f.template run<kChannels, 16, 8>();
    if (ow == 16) return f.template run<kChannels, 16, 16>();
    return f.template run<kChannels, 16, 32>();
  }
  if (ow == 8) return f.template run<kChannels, 32, 8>();
  if (ow == 16) return f.template run<kChannels, 32, 16>();
  return f.template run<kChannels, 32, 32>();
}

bool in_limits(int k, int c_in, int c_out) {
  return k == NC_K && c_in >= 1 && c_in <= kMaxWidth && c_out >= 1 &&
         c_out <= kMaxWidth;
}

// the shared memory of the smallest block (one cell of one volume) of a
// launch whose input has c_in channels and output c_out
struct MinSmem {
  template <Mode MODE, int CW, int OW>
  size_t run() const {
    Geo g{};
    g.G = g.R = g.Wc = 1;
    return smem_bytes<NC_K, MODE, CW, OW>(g);
  }
};

size_t min_smem(int c_in, int c_out) {
  return with_class(c_in, c_out, MinSmem{});
}

struct LaunchLayer {
  const void *x, *w, *b;
  void* out;
  Geo g;
  cudaStream_t stream;
  template <Mode MODE, int CW, int OW>
  cudaError_t run() const {
    // the class's own widths take the build with them compiled in
    if ((MODE == kTapsK || g.cin == CW) && g.cout == OW)
      return launch<NC_K, MODE, CW, OW, true>(x, w, b, out, g, stream);
    return launch<NC_K, MODE, CW, OW, false>(x, w, b, out, g, stream);
  }
};

// b null: the transposed launch (no bias, no ReLU)
cudaError_t launch_layer(const void* x, const void* w, const void* b,
                         void* out, int B, int hA, int wA, int hB, int wB,
                         int c_in, int c_out, cudaStream_t stream) {
  if (static_cast<int64_t>(B) * hA * wA * hB * wB <= 0) return cudaSuccess;
  Geo g{};
  g.B = B;
  g.hA = hA;
  g.wA = wA;
  g.hB = hB;
  g.wB = wB;
  g.cin = c_in;
  g.cout = c_out;
  return with_class(c_in, c_out, LaunchLayer{x, w, b, out, g, stream});
}

}  // namespace

extern "C" {

// 1 when this library serves the forward layer (k, c_in, c_out) and its
// transposed launch: k is this library's, both widths within the limits,
// and the smallest block of either launch within the shared-memory budget
int nc_conv4d_supported(int k, int c_in, int c_out) {
  return in_limits(k, c_in, c_out) && min_smem(c_in, c_out) <= kSmemBudget &&
         min_smem(c_out, c_in) <= kSmemBudget;
}

// Enqueues one layer on `stream`; returns the cudaError_t of the launch
// (0 on success), or -1 for a shape this library does not serve.  x and w
// must start on 16 bytes.
int nc_conv4d_bf16(const void* x, const void* w, const void* b, void* out,
                   int B, int hA, int wA, int hB, int wB, int k, int c_in,
                   int c_out, void* stream) {
  if (!nc_conv4d_supported(k, c_in, c_out)) return -1;
  if (b == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_layer(x, w, b, out, B, hA, wA, hB, wB, c_in,
                                       c_out,
                                       static_cast<cudaStream_t>(stream)));
}

// The input gradient of a forward layer (k, c_in, c_out): enqueues
// out = bf16(conv4d_same(gz, wt)) with no bias and no ReLU, gz (B, hA, wA,
// hB, wB, c_out) bf16, wt (k, k, k, k, c_out, c_in) the flipped, channel-
// swapped weights, out (B, hA, wA, hB, wB, c_in).  Returns the cudaError_t
// of the launch, or -1 for a shape this library does not serve.
int nc_conv4d_transpose_bf16(const void* gz, const void* wt, void* out, int B,
                             int hA, int wA, int hB, int wB, int k, int c_in,
                             int c_out, void* stream) {
  if (!nc_conv4d_supported(k, c_in, c_out)) return -1;
  return static_cast<int>(launch_layer(gz, wt, nullptr, out, B, hA, wA, hB,
                                       wB, c_out, c_in,
                                       static_cast<cudaStream_t>(stream)));
}

const char* nc_conv4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
