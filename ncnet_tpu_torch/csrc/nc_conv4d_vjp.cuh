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
// Bound: operations.  dW is a product whose contraction is the cells and
// whose output is small: for the PF-Pascal stack (k = 5, channels 16, 16,
// 1) on the 8 volumes of 25^4 of one training chunk (3.1e6 cells), the
// 16->16 layer's dW counts 8.21e11 FLOP at in-volume taps (0.830 ms at 989
// TFLOP/s) for 160,000 outputs, the 1->16 and 16->1 layers' 5.13e10 each
// (0.052 ms), against ~1e8 bytes of bf16 volumes a layer.
//
// Design (tensor cores: mma.sync m16n8k16, bf16 operands, f32 sums, fed by
// ldmatrix.trans from shared memory).  Grid (k^2, P): block ((p, q), part)
// walks the items part, part + P, ... of the (b, i, j, row band, column
// band) list, the bands of R rows and Wc columns tiling the (hB, wB) plane
// (at 25^4 whole planes for the thin layers, two bands for 16->16; any
// plane size fits, 50 x 50 included).  The k^2 blocks of one part run
// together, so they read an item's cotangent and input from L2.  Items
// whose shifted input plane (i + p - d, j + q - d) lies outside the volume
// are skipped whole (a test uniform in the block).  An item's operands are
// staged as bf16, double-buffered: 16-channel cells of 32 bytes (the two
// 8-channel halves swapped in every other group of 4 cells, so ldmatrix
// rows of consecutive cells hit distinct banks) with cp.async, zero-filled
// outside the volume; thinner ones with plain loads; the expanded boxes
// below from registers loaded before the previous item's product and
// stored after it.  Where y and g are staged, one pass masks g in place
// once an item (a second barrier), not once a warp and k-step.  Three
// layer shapes, as the forward's three modes (padding C_in or C_out to 16
// would multiply a thin layer's FLOP by 16):
//   - channels (C_in > 1, C_out > 4; the 16->16 layer): per (r, s) tap,
//     dW_rs (ci x co) = x at the tap's constant offset in the zero-haloed
//     box (cells x ci, ldmatrix.trans at lane-computed rows, so a k-step's
//     16 cells may cross a row) times gz (cells x co), loaded once a
//     k-step and reused for the warp's k taps (one tap row r a warp; two
//     warps a row split the k-steps);
//   - taps in M (C_in = 1; the 1->16 layer): dW[(r, s), co] = sum_c
//     x[c + (r, s)] gz[c, co]; an expanded box holds each cell's 8
//     horizontal shifts as one 16-byte row, so a 16-row M tile (two tap
//     rows of 8 s slots) is one ldmatrix.trans;
//   - taps in N (C_out <= 4; the 16->1 layer): with c' = c + (r, s),
//     dW[(r, s), ci] = sum_c' x[c', ci] gz[c' - (r, s)]: A is the unshifted
//     x, B an expanded box of gz with its 8 horizontal shifts (one n-tile
//     of 8 a tap row r).
// Any widths 1 <= C_in, C_out <= kMaxWidth take the same modes: a block
// stages one 16-channel tile of C_in and one of C_out (the grid's third
// dimension runs over the tile pairs; thinner tiles zero-padded by the
// staging), or for the taps in N CB output channels (two at k = 7 with
// C_out > 2, where k C_out sums would not fit the registers).  The kernels
// are templated on k and on that class and take the true widths at run
// time; one translation unit a k (nc_conv4d_vjp_k<k>.cu defines NC_K and
// includes this file), so the builds run in parallel.  The centre (p, q)
// block of the first C_in tile of each part also writes gz (for the input
// gradient) and sums db.
//
// No float atomics: each block sums its items in a fixed order, combines
// its warps in a fixed order and writes its f32 partial slab (and db) to
// partial row `part`; nc_vjp_reduce_kernel sums the rows in part order.
// So two runs give bit-identical gradients.

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
constexpr int kMaxK = 7;       // an expanded cell's 8 shift slots: k <= 8
constexpr int kMaxWidth = 32;  // two 16-channel tiles of C_in and of C_out
constexpr int kCell = 16;                   // bf16 a staged cell: 16 channels
constexpr int kShifts = 8;                  // s slots of an expanded cell
constexpr size_t kSmemBudget = 113 * 1024;  // two blocks an SM

static_assert(NC_K % 2 == 1 && NC_K <= kMaxK, "an odd k of the shape class");

enum Mode { kChannels, kTapsM, kTapsN };

__host__ __device__ constexpr Mode mode_of(int c_in, int c_out) {
  return c_in == 1 ? kTapsM : (c_out <= 4 ? kTapsN : kChannels);
}

// W: the n-tiles of a block's 16-channel C_out tile (channels, taps in M:
// 1 for C_out <= 8, else 2), or CB, its output channels (taps in N)
template <int K, Mode MODE, int W>
struct Layer {
  static constexpr int D = K / 2;
  static constexpr Mode kMode = MODE;
  static_assert(K % 2 == 1 && K <= kMaxK, "a tap row fills 8 shift slots");
  static constexpr int NT = MODE == kTapsN ? 1 : W;  // n-tiles of C_out
  static constexpr int CB = MODE == kTapsN ? W : 16;  // C_out a block
  static constexpr int KS = (K + 1) / 2;       // pairs of tap rows r
  static constexpr int kWarps = kMode == kChannels ? 2 * K : 8;
  static constexpr int kThreads = 32 * kWarps;
  // f32 accumulators a lane: channels, the k taps (r, s) of its row x NT;
  // taps in M, KS m-tiles x NT; taps in N, CB x k n-tiles
  static constexpr int kAcc =
      4 * (kMode == kChannels ? K * NT : kMode == kTapsM ? KS * NT : CB * K);
  // warps whose accumulators the combine stages in shared memory
  static constexpr int kCombineWarps = kMode == kChannels ? K : kWarps;
  // row segments of an expanded box a thread
  static constexpr int kSegs = (kMode == kTapsN && CB > 1) ? 1 : 2;
  // blocks an SM: one where the accumulators need the registers
  static constexpr int kMinBlocks =
      (kMode == kTapsN && CB > 1) || (kMode == kChannels && kAcc > 40) ? 1 : 2;
  static constexpr int kWin = K + kShifts - 1;  // raw values a segment
};

// the tiling of one launch (host-chosen, uniform in the grid)
struct Geo {
  int B, hA, wA, hB, wB;
  int cin, cout;          // the true widths
  int n_ci_t;             // C_in tiles: blockIdx.z = co tile * n_ci_t + ci tile
  int R, Wc, n_rb, n_cb;  // bands of R rows x Wc columns
  int n_items;            // B * hA * wA * n_rb * n_cb
  int yoff, xoff;         // the x box's halo rows and columns (d, or 0 for
                          // the taps in N where the band spans the plane)
  int Hx, Wb;             // the x box: R + 2 yoff rows, Wc + 2 xoff columns
  int n_band, n_box;      // cells of a band, of the x box
  int n_k;                // contraction cells an item, padded to 16
  int spr, n_segs;        // expanded-box row segments a row, an item
  int eg_plane;           // taps in N: bf16 of one channel's expanded gz
  // byte offsets into dynamic shared memory, and within a stage
  int tbl_box, dbs, stages, x_bytes, y_off, g_off, stage_bytes;
};

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// The element offset of the 8-channel half h of staged cell c: the halves
// swap in every other group of 4 cells, so the same half of any 8
// consecutive cells falls on 8 distinct groups of 4 banks (conflict-free
// ldmatrix rows at a 32-byte pitch).
__device__ __forceinline__ int cell_at(int c, int h) {
  return c * kCell + 8 * (h ^ ((c >> 2) & 1));
}

// One item for the block of tap pair (p, q): the first cells of its
// cotangent plane (b, i, j) and input plane (b, i + p - d, j + q - d), and
// its band's first row and column.
struct Item {
  long long gcell, xcell;
  int k0, c0;
};

// false when the item's input plane lies outside the volume
__device__ __forceinline__ bool item_of(const Geo& g, int it, int p, int q,
                                        int d, Item& o) {
  const int cb = it % g.n_cb;
  it /= g.n_cb;
  const int rb = it % g.n_rb;
  it /= g.n_rb;
  const int j = it % g.wA;
  it /= g.wA;
  const int i = it % g.hA;
  const int b = it / g.hA;
  const int ii = i + p - d, jj = j + q - d;
  if (ii < 0 || ii >= g.hA || jj < 0 || jj >= g.wA) return false;
  const long long plane = static_cast<long long>(g.hB) * g.wB;
  o.gcell = ((static_cast<long long>(b) * g.hA + i) * g.wA + j) * plane;
  o.xcell = ((static_cast<long long>(b) * g.hA + ii) * g.wA + jj) * plane;
  o.k0 = rb * g.R;
  o.c0 = cb * g.Wc;
  return true;
}

// g where y > 0 (not NaN), else +0, on two bf16 values a word
__device__ __forceinline__ uint32_t relu_mask2(uint32_t y, uint32_t g) {
  return g & __vcmpgts2(y, 0u) & __vcmplts2(y, 0x7F817F81u);
}

__device__ __forceinline__ __nv_bfloat16 relu_mask1(__nv_bfloat16 y,
                                                    __nv_bfloat16 g) {
  const short v = static_cast<short>(__bfloat16_as_ushort(y));
  return (v > 0 && v < 0x7F81) ? g : __float2bfloat16_rn(0.f);
}

// Stage n cells of the 16 channels c0 .. c0 + 15 of a C-channel volume
// (channels past C zero): cell c is the cell cell_of(c) of the plane at
// src, or zeros where cell_of gives -1.  16-byte cp.async copies of
// 8-channel halves where a cell starts on 16 bytes (C a multiple of 8),
// plain loads otherwise.
template <int T, typename F>
__device__ __forceinline__ void stage_cells(__nv_bfloat16* dst,
                                            const __nv_bfloat16* __restrict__ src,
                                            int n, int C, int c0, F cell_of) {
  if (C % 8 == 0) {
    for (int e = threadIdx.x; e < 2 * n; e += T) {
      const int c = e >> 1, h = e & 1;
      const int o = c0 + 8 * h < C ? cell_of(c) : -1;
      tc::cp_async16(dst + cell_at(c, h),
                     o >= 0 ? src + static_cast<long long>(o) * C + c0 + 8 * h
                            : src,
                     o >= 0 ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < 16 * n; e += T) {
      const int c = e >> 4, ch = e & 15;
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if (c0 + ch < C) {
        const int o = cell_of(c);
        if (o >= 0) v = src[static_cast<long long>(o) * C + c0 + ch];
      }
      dst[cell_at(c, ch >> 3) + (ch & 7)] = v;
    }
  }
}

// FULL: one tile of the class's own widths (C_in = 16, or 1 for the taps
// in M; C_out = 8 NT, or CB for the taps in N), compiled in as constants;
// otherwise the widths and tiles are read from g.
template <int K, Mode MODE, int W, bool FULL>
__global__ void __launch_bounds__(Layer<K, MODE, W>::kThreads,
                                  Layer<K, MODE, W>::kMinBlocks)
nc_vjp_dw_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ y,
                 const __nv_bfloat16* __restrict__ gr,
                 __nv_bfloat16* __restrict__ gz, float* __restrict__ partial,
                 const Geo g) {
  using L = Layer<K, MODE, W>;
  constexpr int D = L::D, T = L::kThreads, NT = L::NT, KS = L::KS;
  constexpr int CB = L::CB;
  constexpr Mode kMode = L::kMode;
  constexpr bool kSegMode = kMode != kChannels;
  constexpr int kSegCh = kMode == kTapsN ? CB : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl_band = reinterpret_cast<int*>(smem);  // band cell -> (row, col)
  int* tbl_box = reinterpret_cast<int*>(smem + g.tbl_box);  // x box cell
  float* dbs = reinterpret_cast<float*>(smem + g.dbs);
  unsigned char* stages = smem + g.stages;

  const int pq = blockIdx.x, part = blockIdx.y, n_parts = gridDim.y;
  const int p = pq / K, q = pq % K;
  const int cin = FULL ? (kMode == kTapsM ? 1 : 16) : g.cin;
  const int cout = FULL ? (kMode == kTapsN ? CB : 8 * NT) : g.cout;
  // this block's tiles: C_in channels ci0 .. ci0 + 15, C_out co0 .. co0 +
  // CB - 1; the first C_in tile's centre block writes gz and db
  const int ci0 = FULL ? 0 : 16 * (static_cast<int>(blockIdx.z) % g.n_ci_t);
  const int co0 = FULL ? 0 : CB * (static_cast<int>(blockIdx.z) / g.n_ci_t);
  const bool centre = p == D && q == D && ci0 == 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, t4 = lane & 3;

  for (int m = tid; m < g.n_band; m += T)
    tbl_band[m] = ((m / g.Wc) << 16) | (m % g.Wc);
  if constexpr (kMode != kTapsM)
    for (int c = tid; c < g.n_box; c += T)
      tbl_box[c] = ((c / g.Wb) << 16) | (c % g.Wb);
  // both stages start zero: the padding cells past a band or box and the
  // expanded gz rows outside the band are never written
  for (int e = tid; e < 2 * g.stage_bytes / 16; e += T)
    reinterpret_cast<uint4*>(stages)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto slot_base = [&](int slot) { return stages + slot * g.stage_bytes; };
  auto bf = [](unsigned char* ptr) {
    return reinterpret_cast<__nv_bfloat16*>(ptr);
  };
  // the cell in its plane of band cell m, or -1 past the volume
  auto band_cell = [&](const Item& it, int m) {
    const int v = tbl_band[m];
    const int kk = it.k0 + (v >> 16), ll = it.c0 + (v & 0xFFFF);
    return (kk < g.hB && ll < g.wB) ? kk * g.wB + ll : -1;
  };
  // the cell in its plane of x box cell c, or -1 outside the volume
  auto box_cell = [&](const Item& it, int c) {
    const int v = tbl_box[c];
    const int kk = it.k0 - g.yoff + (v >> 16), ll = it.c0 - g.xoff + (v & 0xFFFF);
    return (kk >= 0 && kk < g.hB && ll >= 0 && ll < g.wB) ? kk * g.wB + ll : -1;
  };

  // the copies of an item into stage `slot` (the expanded boxes come from
  // the segments)
  auto stage_async = [&](const Item& it, int slot) {
    unsigned char* base = slot_base(slot);
    if constexpr (kMode != kTapsM)
      stage_cells<T>(bf(base), x + it.xcell * cin, g.n_box, cin, ci0,
                     [&](int c) { return box_cell(it, c); });
    if constexpr (kMode != kTapsN) {
      auto cell = [&](int m) { return band_cell(it, m); };
      stage_cells<T>(bf(base + g.y_off), y + it.gcell * cout, g.n_band, cout,
                     co0, cell);
      stage_cells<T>(bf(base + g.g_off), gr + it.gcell * cout, g.n_band, cout,
                     co0, cell);
    }
  };

  // Expanded-box row segments, 8 expanded cells each: taps in M, row y of
  // the x box (E[(y, c)][s] = x box (y, c + s)); taps in N, band row kr
  // (EG[(kr + d + yoff, c)][s] = gz band (kr, c - s + d - xoff), c a
  // column of the x box).
  __nv_bfloat16 raw[L::kSegs][kSegCh][L::kWin];
  float dbacc[kMode == kTapsN ? CB : 1];
#pragma unroll
  for (int c = 0; c < (kMode == kTapsN ? CB : 1); ++c) dbacc[c] = 0.f;

  auto seg_load = [&](const Item& it) {
#pragma unroll
    for (int z = 0; z < L::kSegs; ++z) {
      const int sg = tid + T * z;
      if (sg >= g.n_segs) continue;
      const int row = sg / g.spr, c8 = (sg % g.spr) * kShifts;
      if constexpr (kMode == kTapsM) {
        const int kk = it.k0 - D + row;
        const bool rok = kk >= 0 && kk < g.hB;
#pragma unroll
        for (int u = 0; u < L::kWin; ++u) {
          const int ll = it.c0 - D + c8 + u;
          raw[z][0][u] = (rok && ll >= 0 && ll < g.wB)
                             ? x[it.xcell + static_cast<long long>(kk) * g.wB + ll]
                             : __float2bfloat16_rn(0.f);
        }
      } else if constexpr (kMode == kTapsN) {
        const int kk = it.k0 + row;
#pragma unroll
        for (int u = 0; u < L::kWin; ++u) {
          const int bc = c8 - D - g.xoff + u, ll = it.c0 + bc;
          const bool ok = kk < g.hB && bc >= 0 && bc < g.Wc && ll < g.wB;
          const long long o =
              (it.gcell + static_cast<long long>(kk) * g.wB + ll) * cout + co0;
#pragma unroll
          for (int co = 0; co < CB; ++co)
            raw[z][co][u] = ok && co0 + co < cout
                                ? relu_mask1(y[o + co], gr[o + co])
                                : __float2bfloat16_rn(0.f);
        }
      }
    }
  };
  auto seg_store = [&](const Item& it, int slot) {
    unsigned char* base = slot_base(slot);
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int z = 0; z < L::kSegs; ++z) {
      const int sg = tid + T * z;
      if (sg >= g.n_segs) continue;
      const int row = sg / g.spr, c8 = (sg % g.spr) * kShifts;
      if constexpr (kMode == kTapsM) {
        __nv_bfloat16* e = bf(base) + (row * g.Wc + c8) * kShifts;
#pragma unroll
        for (int v = 0; v < kShifts; ++v) {
          if (c8 + v >= g.Wc) break;
          uint32_t w4[kShifts / 2];
#pragma unroll
          for (int c = 0; c < kShifts / 2; ++c)
            w4[c] = tc::pack_bf16(2 * c < K ? raw[z][0][v + 2 * c] : zero,
                                  2 * c + 1 < K ? raw[z][0][v + 2 * c + 1] : zero);
          *reinterpret_cast<uint4*>(e + v * kShifts) =
              make_uint4(w4[0], w4[1], w4[2], w4[3]);
        }
      } else if constexpr (kMode == kTapsN) {
#pragma unroll
        for (int co = 0; co < CB; ++co) {
          __nv_bfloat16* e = bf(base + g.x_bytes) + co * g.eg_plane +
                             ((row + D + g.yoff) * g.Wb + c8) * kShifts;
#pragma unroll
          for (int v = 0; v < kShifts; ++v) {
            if (c8 + v >= g.Wb) break;
            uint32_t w4[kShifts / 2];
#pragma unroll
            for (int c = 0; c < kShifts / 2; ++c) {
              const int s0 = 2 * c, s1 = 2 * c + 1;
              w4[c] = tc::pack_bf16(s0 < K ? raw[z][co][v + 2 * D - s0] : zero,
                                    s1 < K ? raw[z][co][v + 2 * D - s1] : zero);
            }
            *reinterpret_cast<uint4*>(e + v * kShifts) =
                make_uint4(w4[0], w4[1], w4[2], w4[3]);
          }
        }
        if (centre) {
          // this segment's own band cells: gz out, db summed
          const int kk = it.k0 + row;
#pragma unroll
          for (int v = 0; v < kShifts; ++v) {
            const int bc = c8 + v, ll = it.c0 + bc;
            if (bc >= g.Wc || kk >= g.hB || ll >= g.wB) continue;
            const long long o =
                (it.gcell + static_cast<long long>(kk) * g.wB + ll) * cout + co0;
#pragma unroll
            for (int co = 0; co < CB; ++co) {
              if (co0 + co >= cout) continue;
              // raw[z][co][u] is band column c8 - d - xoff + u
              const __nv_bfloat16 val =
                  g.xoff == 0 ? raw[z][co][v + D] : raw[z][co][v + 2 * D];
              gz[o + co] = val;
              dbacc[co] += __bfloat162float(val);
            }
          }
        }
      }
    }
  };

  // channels and taps in M: the staged g becomes gz in place, 16 bytes a
  // thread, once an item (not once a warp and k-step)
  auto mask_pass = [&](int slot) {
    unsigned char* base = slot_base(slot);
    const uint4* ys = reinterpret_cast<const uint4*>(base + g.y_off);
    uint4* gs = reinterpret_cast<uint4*>(base + g.g_off);
    for (int e = tid; e < 2 * g.n_band; e += T) {
      const uint4 yv = ys[e];
      uint4 gv = gs[e];
      gv.x = relu_mask2(yv.x, gv.x);
      gv.y = relu_mask2(yv.y, gv.y);
      gv.z = relu_mask2(yv.z, gv.z);
      gv.w = relu_mask2(yv.w, gv.w);
      gs[e] = gv;
    }
  };
  // ... and the centre block writes it out and sums db (thread t always
  // holds channel t % 16)
  auto gz_pass = [&](const Item& it, int slot) {
    const auto* gs =
        reinterpret_cast<const __nv_bfloat16*>(slot_base(slot) + g.g_off);
    for (int e = tid; e < 16 * g.n_band; e += T) {
      const int m = e >> 4, co = e & 15;
      if (co0 + co >= cout) continue;
      const int o = band_cell(it, m);
      if (o < 0) continue;
      const __nv_bfloat16 val = gs[cell_at(m, co >> 3) + (co & 7)];
      gz[(it.gcell + o) * cout + co0 + co] = val;
      dbacc[0] += __bfloat162float(val);
    }
  };

  float acc[L::kAcc];
#pragma unroll
  for (int v = 0; v < L::kAcc; ++v) acc[v] = 0.f;

  // B fragments of gz, cells ks * 16 .. + 15 x C_out (channels and taps
  // in M)
  auto load_gz = [&](const __nv_bfloat16* gs, int ks, uint32_t* gb) {
    const int cell = ks * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    if constexpr (NT == 2)
      tc::ldmatrix_x4_trans(gb, gs + cell_at(cell, lane >> 4));
    else
      tc::ldmatrix_x2_trans(gb, gs + cell_at(cell, 0));
  };

  auto compute = [&](int slot) {
    const unsigned char* base = slot_base(slot);
    const auto* xs = reinterpret_cast<const __nv_bfloat16*>(base);
    const int n_ks = g.n_k / 16;
    if constexpr (kMode == kChannels) {
      // warp: tap row r, k-steps of parity `half`
      const int r = warp % K, half = warp / K;
      const auto* gs = reinterpret_cast<const __nv_bfloat16*>(base + g.g_off);
      for (int ks = half; ks < n_ks; ks += 2) {
        uint32_t gb[2 * NT];
        load_gz(gs, ks, gb);
        const int m = min(ks * 16 + (lane & 7) + 8 * (lane >> 4), g.n_band - 1);
        const int v = tbl_band[m];
        const int at = ((v >> 16) + r) * g.Wb + (v & 0xFFFF), h = (lane >> 3) & 1;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          uint32_t a[4];
          tc::ldmatrix_x4_trans(a, xs + cell_at(at + s, h));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            tc::mma_bf16(acc + (s * NT + nt) * 4, a, gb + 2 * nt);
        }
      }
    } else if constexpr (kMode == kTapsM) {
      const auto* gs = reinterpret_cast<const __nv_bfloat16*>(base + g.g_off);
      const int rr = (lane >> 3) & 1;
      for (int ks = warp; ks < n_ks; ks += L::kWarps) {
        uint32_t gb[2 * NT];
        load_gz(gs, ks, gb);
        const int m = min(ks * 16 + (lane & 7) + 8 * (lane >> 4), g.n_band - 1);
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          const int r = min(2 * j + rr, K - 1);
          uint32_t a[4];
          tc::ldmatrix_x4_trans(a, xs + (m + r * g.Wc) * kShifts);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            tc::mma_bf16(acc + (j * NT + nt) * 4, a, gb + 2 * nt);
        }
      }
    } else {
      const auto* eg = reinterpret_cast<const __nv_bfloat16*>(base + g.x_bytes);
      const int roff = lane >> 4;
      for (int ks = warp; ks < n_ks; ks += L::kWarps) {
        uint32_t a[4];
        tc::ldmatrix_x4_trans(
            a, xs + cell_at(ks * 16 + (lane & 7) + 8 * (lane >> 4), (lane >> 3) & 1));
        const int cell = ks * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int co = 0; co < CB; ++co) {
#pragma unroll
          for (int j = 0; j < KS; ++j) {
            const int r = min(2 * j + roff, K - 1);
            uint32_t b[4];
            tc::ldmatrix_x4_trans(
                b, eg + co * g.eg_plane + (cell + (2 * D - r) * g.Wb) * kShifts);
            tc::mma_bf16(acc + (co * K + 2 * j) * 4, a, b);
            if (2 * j + 1 < K) tc::mma_bf16(acc + (co * K + 2 * j + 1) * 4, a, b + 2);
          }
        }
      }
    }
  };

  // the items, software-pipelined: item t + 1's copies (and segment loads)
  // are in flight while item t is masked and multiplied
  int it = part;
  Item cur, nxt;
  auto next_valid = [&](Item& o) {
    for (; it < g.n_items; it += n_parts)
      if (item_of(g, it, p, q, D, o)) return true;
    return false;
  };
  bool have = next_valid(cur);
  if (have) {
    stage_async(cur, 0);
    tc::cp_async_commit();
    if constexpr (kSegMode) {
      seg_load(cur);
      seg_store(cur, 0);
    }
  }
  int slot = 0;
  while (have) {
    tc::cp_async_wait_all();
    __syncthreads();  // item landed; the other stage is no longer read
    it += n_parts;
    const bool more = next_valid(nxt);
    if (more) {
      stage_async(nxt, slot ^ 1);
      if constexpr (kSegMode) seg_load(nxt);
    }
    tc::cp_async_commit();
    if constexpr (kMode != kTapsN) {
      mask_pass(slot);
      __syncthreads();  // gz staged
      if (centre) gz_pass(cur, slot);
    }
    compute(slot);
    if constexpr (kSegMode)
      if (more) seg_store(nxt, slot ^ 1);
    cur = nxt;
    have = more;
    slot ^= 1;
  }
  __syncthreads();  // the stages are free for the combine

  // the warps' sums combined in a fixed order, then this block's partial row
  const long long nw = static_cast<long long>(K * K * K * K) * cin * cout;
  float* out = partial + static_cast<long long>(part) * (nw + cout);
  float* red = reinterpret_cast<float*>(stages);
  // dW's element (r, s, ci0 + ci, co0 + co) of this block's (p, q)
  auto w_at = [&](int r, int s, int ci, int co) {
    return ((((p * K + q) * K + r) * K + s) * static_cast<long long>(cin) +
            ci0 + ci) * cout + co0 + co;
  };
  if constexpr (kMode == kChannels) {
    const int r = warp % K, half = warp / K;
    if (half == 1) {
#pragma unroll
      for (int v = 0; v < L::kAcc; ++v) red[(r * L::kAcc + v) * 32 + lane] = acc[v];
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int s = 0; s < K; ++s)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const int v = (s * NT + nt) * 4 + c4;
            const int ci = gq + 8 * (c4 >> 1), co = nt * 8 + 2 * t4 + (c4 & 1);
            if (ci0 + ci < cin && co0 + co < cout)
              out[w_at(r, s, ci, co)] = acc[v] + red[(r * L::kAcc + v) * 32 + lane];
          }
    }
  } else {
#pragma unroll
    for (int v = 0; v < L::kAcc; ++v) red[(warp * L::kAcc + v) * 32 + lane] = acc[v];
    __syncthreads();
    for (int e = tid; e < L::kAcc * 32; e += T) {
      const int v = e >> 5, ln = e & 31;
      float sum = 0.f;
      for (int w = 0; w < L::kWarps; ++w) sum += red[(w * L::kAcc + v) * 32 + ln];
      const int c4 = v & 3, tile = v >> 2, lg = ln >> 2, lt = ln & 3;
      if constexpr (kMode == kTapsM) {
        // m = (r % 2, s), n = co
        const int nt = tile % NT, r = 2 * (tile / NT) + (c4 >> 1), s = lg;
        const int co = nt * 8 + 2 * lt + (c4 & 1);
        if (r < K && s < K && co0 + co < cout) out[w_at(r, s, 0, co)] = sum;
      } else {
        // m = ci, n = s of tap row r, channel co
        const int r = tile % K, co = tile / K;
        const int ci = lg + 8 * (c4 >> 1), s = 2 * lt + (c4 & 1);
        if (ci0 + ci < cin && s < K && co0 + co < cout)
          out[w_at(r, s, ci, co)] = sum;
      }
    }
  }
  if (centre) {
    if constexpr (kMode == kTapsN) {
#pragma unroll
      for (int co = 0; co < CB; ++co) dbs[tid * CB + co] = dbacc[co];
    } else {
      dbs[tid] = dbacc[0];
    }
    __syncthreads();
    if (tid < CB && co0 + tid < cout) {
      float sum = 0.f;
      if constexpr (kMode == kTapsN) {
        for (int t = 0; t < T; ++t) sum += dbs[t * CB + tid];
      } else {
        for (int u = 0; u < T / 16; ++u) sum += dbs[tid + 16 * u];
      }
      out[nw + co0 + tid] = sum;
    }
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

// Shared memory of a tiling (filling in its sizes and offsets): the band
// and box tables, the db partials, then two stages (the combine reuses
// them); SIZE_MAX where the segments would not cover the expanded box.
template <int K, Mode MODE, int W>
size_t smem_bytes(Geo& g) {
  using L = Layer<K, MODE, W>;
  constexpr int d = L::D;
  // the taps in N read the unshifted x: a band that spans the plane's
  // rows (columns) needs no halo there, the volume's zeros add nothing
  const bool n_mode = L::kMode == kTapsN;
  g.yoff = n_mode && g.R >= g.hB ? 0 : d;
  g.xoff = n_mode && g.Wc >= g.wB ? 0 : d;
  g.Hx = g.R + 2 * g.yoff;
  g.Wb = g.Wc + 2 * g.xoff;
  g.n_band = g.R * g.Wc;
  g.n_box = L::kMode == kTapsM ? 0 : g.Hx * g.Wb;
  size_t off = round16(4 * g.n_band);
  g.tbl_box = static_cast<int>(off);
  off += round16(4 * g.n_box);
  g.dbs = static_cast<int>(off);
  off += round16(4 * L::kThreads * (n_mode ? L::CB : 1));
  g.stages = static_cast<int>(off);
  g.n_segs = 0;
  g.spr = 1;
  g.eg_plane = 0;
  if (L::kMode == kTapsN) {
    g.n_k = round16(g.n_box);
    g.x_bytes = g.n_k * kCell * 2;
    g.spr = (g.Wb + kShifts - 1) / kShifts;
    g.n_segs = g.R * g.spr;
    // rows d + yoff .. d + yoff + R - 1 hold the band; the rest (and 16
    // cells past the end, read by the padding cells of the last k-step)
    // stay zero
    g.eg_plane = ((g.Hx + 2 * d) * g.Wb + 16) * kShifts;
    g.y_off = g.g_off = 0;
    g.stage_bytes = g.x_bytes + L::CB * g.eg_plane * 2;
  } else {
    g.n_k = round16(g.n_band);
    if (L::kMode == kTapsM) {
      g.x_bytes = round16(g.Hx * g.Wc * kShifts * 2);
      g.spr = (g.Wc + kShifts - 1) / kShifts;
      g.n_segs = g.Hx * g.spr;
    } else {
      g.x_bytes = round16(g.n_box * kCell * 2);
    }
    g.y_off = g.x_bytes;
    g.g_off = g.y_off + g.n_k * kCell * 2;
    g.stage_bytes = g.g_off + g.n_k * kCell * 2;
  }
  if (g.n_segs > L::kThreads * L::kSegs) return SIZE_MAX;
  const size_t red = static_cast<size_t>(L::kCombineWarps) * L::kAcc * 32 * 4;
  const size_t stages = 2 * static_cast<size_t>(g.stage_bytes);
  return off + (stages > red ? stages : red);
}

template <int K, Mode MODE, int W, bool FULL>
cudaError_t launch_dw(const void* x, const void* y, const void* g, void* gz,
                      void* partial, Geo geo, int n_parts,
                      cudaStream_t stream) {
  using L = Layer<K, MODE, W>;
  const int hB = geo.hB, wB = geo.wB;
  if (static_cast<int64_t>(geo.B) * geo.hA * geo.wA * hB * wB <= 0 ||
      n_parts <= 0 || n_parts > 65535)
    return cudaErrorInvalidValue;
  // the band: whole planes where they fit, else fewer rows, else fewer
  // columns; then the bands evened out
  geo.R = hB;
  geo.Wc = wB;
  while (smem_bytes<K, MODE, W>(geo) > kSmemBudget) {
    if (geo.R > 1)
      --geo.R;
    else if (geo.Wc > 1)
      geo.Wc = (geo.Wc + 1) / 2;
    else
      return cudaErrorInvalidValue;
  }
  geo.n_rb = (hB + geo.R - 1) / geo.R;
  geo.R = (hB + geo.n_rb - 1) / geo.n_rb;
  geo.n_cb = (wB + geo.Wc - 1) / geo.Wc;
  geo.Wc = (wB + geo.n_cb - 1) / geo.n_cb;
  const size_t smem = smem_bytes<K, MODE, W>(geo);
  const long long n_items =
      static_cast<long long>(geo.B) * geo.hA * geo.wA * geo.n_rb * geo.n_cb;
  if (n_items > INT_MAX || static_cast<long long>(hB) * wB > INT_MAX)
    return cudaErrorInvalidValue;
  geo.n_items = static_cast<int>(n_items);
  geo.n_ci_t = MODE == kTapsM ? 1 : (geo.cin + 15) / 16;
  const int n_co_t = (geo.cout + L::CB - 1) / L::CB;
  auto kernel = nc_vjp_dw_kernel<K, MODE, W, FULL>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(K * K, n_parts, geo.n_ci_t * n_co_t), L::kThreads, smem,
           stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(gz),
      static_cast<float*>(partial), geo);
  return cudaGetLastError();
}

// Calls f.template run<MODE, W>() for the class of a layer shape (c_in,
// c_out) within the limits: the one dispatch of the launch and of the
// shared-memory check
template <typename F>
auto with_class(int c_in, int c_out, const F& f) {
  const Mode m = mode_of(c_in, c_out);
  if (m == kTapsN) {
    // C_out a block: all of them while k C_out sums fit the registers
    const int cb = NC_K * c_out <= 20 ? c_out : 2;
    if (cb == 1) return f.template run<kTapsN, 1>();
    if (cb == 2) return f.template run<kTapsN, 2>();
    if (cb == 3) return f.template run<kTapsN, 3>();
    return f.template run<kTapsN, 4>();
  }
  if (m == kTapsM) {
    if (c_out <= 8) return f.template run<kTapsM, 1>();
    return f.template run<kTapsM, 2>();
  }
  if (c_out <= 8) return f.template run<kChannels, 1>();
  return f.template run<kChannels, 2>();
}

bool in_limits(int k, int c_in, int c_out) {
  return k == NC_K && c_in >= 1 && c_in <= kMaxWidth && c_out >= 1 &&
         c_out <= kMaxWidth;
}

// the shared memory of the smallest band (one cell, haloed on both sides)
struct MinSmem {
  template <Mode MODE, int W>
  size_t run() const {
    Geo g{};
    g.hB = g.wB = 2;
    g.R = g.Wc = 1;
    return smem_bytes<NC_K, MODE, W>(g);
  }
};

struct LaunchDw {
  const void *x, *y, *g;
  void *gz, *partial;
  Geo geo;
  int n_parts;
  cudaStream_t stream;
  template <Mode MODE, int W>
  cudaError_t run() const {
    // one tile of the class's own widths takes the build with them
    // compiled in
    using L = Layer<NC_K, MODE, W>;
    const bool full = (MODE == kTapsM || geo.cin == 16) &&
                      geo.cout == (MODE == kTapsN ? L::CB : 8 * L::NT);
    if (full)
      return launch_dw<NC_K, MODE, W, true>(x, y, g, gz, partial, geo,
                                            n_parts, stream);
    return launch_dw<NC_K, MODE, W, false>(x, y, g, gz, partial, geo, n_parts,
                                           stream);
  }
};

}  // namespace

extern "C" {

// 1 when this library serves the layer (k, c_in, c_out): k is this
// library's, both widths within the limits, and the smallest band within
// the shared-memory budget
int nc_vjp_supported(int k, int c_in, int c_out) {
  return in_limits(k, c_in, c_out) &&
         with_class(c_in, c_out, MinSmem{}) <= kSmemBudget;
}

// Enqueues the mask + dW/db partials of one layer on `stream`: writes gz
// (B, hA, wA, hB, wB, C_out) bf16 and partial (n_parts, k^4*C_in*C_out +
// C_out) f32.  x, y and g must start on 16 bytes.  Returns the launch's
// cudaError_t (0 on success), or -1 for a shape this library does not
// serve.
int nc_vjp_dw_bf16(const void* x, const void* y, const void* g, void* gz,
                   void* partial, int B, int hA, int wA, int hB, int wB, int k,
                   int c_in, int c_out, int n_parts, void* stream) {
  if (!nc_vjp_supported(k, c_in, c_out)) return -1;
  Geo geo{};
  geo.B = B;
  geo.hA = hA;
  geo.wA = wA;
  geo.hB = hB;
  geo.wB = wB;
  geo.cin = c_in;
  geo.cout = c_out;
  return static_cast<int>(with_class(
      c_in, c_out,
      LaunchDw{x, y, g, gz, partial, geo, n_parts,
               static_cast<cudaStream_t>(stream)}));
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
