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
// w[(p, q, c), (r, s, o)]; out (B, 25, 25, 16, 841) bf16, lanes outside the
// 625 interior cells zero (the mask is 0 there).  YDT is bf16 (ROUND_Y) or
// f32: the rounding of each Y term is part of the function.  The (p, q, c)
// sum is f32, the (r, s) sum f32 in the JAX loop's order.
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
// Design (tensor cores, mma.sync m16n8k16, bf16 operands, f32 sums): an
// implicit GEMM whose rows are the 625 interior output cells of a (b, i, j)
// plane, contraction (p, q, c), N = (r, s, o).  Each Y term needs its own
// f32 sum over the whole (p, q, c) contraction before it is rounded, so the
// (r, s) taps cannot share an accumulator as in nc_conv4d.cu.  Instead a
// tap is a shift of the A rows: the row of output cell (kk, ll) at tap
// (r, s) is the input cell (kk + r, ll + s), so Y[(r, s, o), t - 60 + 29 r +
// s] lands in the same accumulator position as output t.
//   - A pre-pass copies every interior plane of xp into a cell-major scratch
//     (B, 25, 25, 29 rows, 33 cells, 24 bf16): a cell is its 16 channels
//     and 8 zeros (48 bytes, so the 8 rows of an ldmatrix fall on distinct
//     banks) and a row of the 29-lane frame is padded to 33 cells (so 8
//     output cells that straddle the end of a row do too).  A tap is then a
//     constant offset, and any band of rows one contiguous run.
//   - A block owns 96 output cells of one (b, i, j) plane (the last of its
//     7 chunks 49) and all 16 channels: 15 warps, warp w holding tap row
//     r = w % 5 for 32 cells (2 m-tiles) x 16 channels (2 n-tiles) x 5
//     taps s, 80 f32 sums.  So all 25 (r, s) sums of a cell stay in
//     registers over the (p, q) loop, and each (p, q) is staged once, its
//     12.8 KB of weight tiles for 96 cells.  One block an SM (at most 136
//     registers a thread): two blocks of 64 cells ran ~8 % faster but
//     need more than the 96 registers a thread they leave, and spill
//     (PERF.md §6; tools/l2_variants.py times both).
//   - The (p, q) steps whose input plane lies in the zero padding are
//     skipped (a test uniform in the block).  Per step, one thread copies
//     the band of input rows the block's cells read (at most 9 rows of 33
//     cells) and the step's 25 weight tiles into a stage with two
//     cp.async.bulk copies completing on its mbarrier, three stages deep.
//     It reads each step's offsets from a table the block writes once.
//     The weights come as bf16 B tiles in the wrapper's order: per tap the
//     four 8 x 8 matrices of an ldmatrix.trans one after the other, so lane
//     l reads the 16 bytes at 16 l and no two lanes share a bank.
//   - Per step a warp issues, for each s, one ldmatrix.trans of the tap's
//     16 x 16 weights and one ldmatrix of 16 shifted cells per m-tile, then
//     4 mma.sync: 384 bytes of shared memory read per mma.
//   - After the last step every warp stores its sums in shared memory (over
//     the stages); then each thread takes an output, rounds its 25 terms
//     to YDT and adds them in order r = 0 .. 4, s ascending, adds the
//     bias, applies ReLU and the mask and rounds once to bf16 into the
//     block's output tile, which the block writes as its lanes of every
//     channel row, halo lanes zero.
// Every output is summed in one fixed order in one block, with no atomics
// and no split of the contraction across blocks, so two launches give bit-
// identical results.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kS = 25;            // output cells per spatial dim
constexpr int kK = 5;             // kernel size
constexpr int kC = 16;            // channels in and out
constexpr int kSP = kS + kK - 1;  // 29 padded cells per spatial dim
constexpr int kKL = kSP * kSP;    // 841 fused (hB, wB) lanes
constexpr int kLo = 2 * kSP + 2;  // 60: the first interior lane
constexpr int kCells = kS * kS;   // 625 interior cells of a plane

// the scratch: a cell is 16 channels + 8 zeros, a row 33 cells
constexpr int kCellPitch = 24;                    // bf16
constexpr int kCellBytes = 2 * kCellPitch;        // 48
constexpr int kRP = 33;                           // cells a row
constexpr int kPlaneBytes = kSP * kRP * kCellBytes;

// the product kernel's block
constexpr int kNL = 3;                    // 32-cell groups a block
constexpr int kBM = 32 * kNL;             // output cells a block
constexpr int kWarps = kK * kNL;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 1;             // blocks an SM
constexpr int kChunks = (kCells + kBM - 1) / kBM;
constexpr int kStages = 3;
// input rows a block reads: the rows its cells span, plus 4 (the taps r)
constexpr int kWinRows = (kBM - 1 + kS - 1) / kS + 1 + kK - 1;
constexpr int kWinBytes = kWinRows * kRP * kCellBytes;
constexpr int kTapBytes = kC * kC * 2;           // a tap's B tile
constexpr int kWBytes = kK * kK * kTapBytes;      // a (p, q)'s 25 tiles
constexpr int kStageBytes = kWinBytes + kWBytes;
constexpr int kBarBytes = 64;
// thread 0's copies, written once a block: each step's byte offsets into
// the scratch and the weight tiles, and the band's bytes
struct Head {
  long long band[kK * kK];
  int weights[kK * kK];
  uint32_t band_bytes;
};
constexpr int kHeadBytes =
    (kBarBytes + static_cast<int>(sizeof(Head)) + 127) / 128 * 128;
static_assert(kStageBytes % 16 == 0, "bulk copies move multiples of 16");
// the band holds every row a tile reads, the last chunk's past cell 624 too
static_assert(((kChunks - 1) * kBM + kBM - 1) / kS - (kChunks - 1) * kBM / kS +
                  kK <= kWinRows,
              "a tile reads past its stage");

// the lane of interior cell m
__host__ __device__ constexpr int lane_of(int m) {
  return kLo + (m / kS) * kSP + m % kS;
}
// the lanes [first, last) a chunk writes: its cells' lanes and the halo
// lanes up to the next chunk's first cell (the first and last chunks also
// the frame's ends)
__host__ __device__ constexpr int first_lane(int chunk) {
  return chunk == 0 ? 0 : lane_of(chunk * kBM);
}
__host__ __device__ constexpr int end_lane(int chunk) {
  return chunk == kChunks - 1 ? kKL : lane_of((chunk + 1) * kBM);
}
constexpr int tile_width() {
  int w = 0;
  for (int c = 0; c < kChunks; ++c)
    w = end_lane(c) - first_lane(c) > w ? end_lane(c) - first_lane(c) : w;
  return w;
}
constexpr int kTileW = tile_width();
// the epilogue, over the stages: every warp's f32 sums, [(r, s)][o][cell]
// at a pitch that puts the 32 lanes of a store on distinct banks, then the
// block's bf16 output tile [o][lane]
constexpr int kTermPitch = kBM + 4;
constexpr int kTermBytes = kK * kK * kC * kTermPitch * 4;
constexpr int kEpilogueBytes = kTermBytes + kC * kTileW * 2;
constexpr int kSmemBytes =
    kHeadBytes + (kEpilogueBytes > kStages * kStageBytes
                      ? kEpilogueBytes
                      : kStages * kStageBytes);

template <bool ROUND_Y>
__device__ __forceinline__ float round_y(float v) {
  if constexpr (ROUND_Y) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// The pre-pass: interior plane (b, ii, jj) of xp, channel-major, into the
// cell-major scratch (zeros in the pads).
__global__ void __launch_bounds__(256)
to_cells_kernel(const __nv_bfloat16* __restrict__ xp,
                __nv_bfloat16* __restrict__ xs) {
  __shared__ __align__(16) __nv_bfloat16 slab[kC * kKL];
  const int plane = blockIdx.x, b = blockIdx.y;
  const int ii = plane / kS + 2, jj = plane % kS + 2;
  const uint4* src = reinterpret_cast<const uint4*>(
      xp + ((static_cast<size_t>(b) * kSP + ii) * kSP + jj) * kC * kKL);
  for (int e = threadIdx.x; e < kC * kKL / 8; e += blockDim.x)
    reinterpret_cast<uint4*>(slab)[e] = src[e];
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(
      reinterpret_cast<unsigned char*>(xs) +
      (static_cast<size_t>(b) * kCells + plane) * kPlaneBytes);
  for (int e = threadIdx.x; e < kSP * kRP * 3; e += blockDim.x) {
    const int cell = e / 3, part = e % 3;
    const int y = cell / kRP, x = cell % kRP;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (part < 2 && x < kSP) {
      const __nv_bfloat16* at = slab + 8 * part * kKL + y * kSP + x;
#pragma unroll
      for (int h = 0; h < 4; ++h)
        v[h] = tc::pack_bf16(at[2 * h * kKL], at[(2 * h + 1) * kKL]);
    }
    dst[e] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// The products: one block per (96 cells, plane (i, j), volume b).
template <bool ROUND_Y>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
conv_l2_tc_kernel(const unsigned char* __restrict__ xs,
                  const unsigned char* __restrict__ wt,
                  const float* __restrict__ bias,
                  const float* __restrict__ mask,
                  __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  Head* head = reinterpret_cast<Head*>(smem + kBarBytes);
  unsigned char* stages = smem + kHeadBytes;
  const uint32_t bar0 = tc::smem_addr(bars), stage0 = tc::smem_addr(stages);

  // The (p, q) whose input plane (i + p - 2, j + q - 2) lies inside the
  // volume, in order: the block's steps.  Thread 0's copy for each is
  // written to `head` once, so that it keeps no registers for them across
  // the loop.
  int n_steps;
  {
    const int i = blockIdx.y / kS, j = blockIdx.y % kS;
    const int m0 = blockIdx.x * kBM, kk0 = m0 / kS;
    const int p_lo = max(0, 2 - i), q_lo = max(0, 2 - j);
    const int nq = min(kK, kS + 2 - j) - q_lo;
    n_steps = (min(kK, kS + 2 - i) - p_lo) * nq;
    const int t = threadIdx.x;
    if (t < n_steps) {
      const int p = p_lo + t / nq, q = q_lo + t % nq;
      head->band[t] = ((static_cast<long long>(blockIdx.z) * kS + i + p - 2) *
                           kS + j + q - 2) * kPlaneBytes +
                      static_cast<long long>(kk0) * kRP * kCellBytes;
      head->weights[t] = (p * kK + q) * kWBytes;
    }
    if (t == 0) {
      head->band_bytes =
          ((min(m0 + kBM, kCells) - 1) / kS - kk0 + kK) * kRP * kCellBytes;
      for (int st = 0; st < kStages; ++st) tc::mbar_init(bars + st);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();

  // thread 0: stage step `step`'s band of input rows and weight tiles into
  // stage `slot` (= step % kStages, a constant where the loop calls it)
  auto issue = [&](int step, int slot) {
    const uint32_t bar = bar0 + 8 * slot;
    const uint32_t dst = stage0 + slot * kStageBytes;
    const uint32_t band_bytes = head->band_bytes;
    // the stage was last read by the generic proxy (ldmatrix)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    tc::mbar_expect(bar, band_bytes + kWBytes);
    tc::bulk_copy(dst, xs + head->band[step], band_bytes, bar);
    tc::bulk_copy(dst + kWinBytes, wt + head->weights[step], kWBytes, bar);
  };
  if (threadIdx.x == 0)
    for (int step = 0; step < min(kStages, n_steps); ++step) issue(step, step);

  // This lane's ldmatrix rows at tap (r, 0) in stage 0, as shared
  // addresses.  Its row of m-tile 1 is the cell 16 after its row of m-tile
  // 0: 16 cells on in the band, or 16 + kRP - kS where the two lie in
  // different rows, which bit 0 of `a_at` records.  (In the last chunk the
  // rows past cell 624 read whatever the stage holds there, inside it; their
  // sums are never written.)  Its row of the tap's B tile is 16 bytes a
  // lane: the wrapper lays the four 8 x 8 matrices of an ldmatrix.trans
  // one after the other.
  uint32_t a_at, w_at;
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r = warp % kK, grp = warp / kK;
    const int m0 = blockIdx.x * kBM;
    const int m = m0 + 2 * grp * 16 + (lane & 15);
    a_at = stage0 + (((m / kS - m0 / kS + r) * kRP + m % kS) * kCellPitch +
                     (lane >> 4) * 8) * 2;
    a_at |= (m + 16) / kS != m / kS ? 1u : 0u;
    w_at = stage0 + kWinBytes + r * kK * kTapBytes + lane * 16;
  }

  float acc[kK][2][2][4];
#pragma unroll
  for (int s = 0; s < kK; ++s)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[s][u][nt][v] = 0.f;

  // a round of kStages steps, one a stage, so that each stage's offset is
  // a constant of the code
  for (int round = 0; round * kStages < n_steps; ++round) {
#pragma unroll
    for (int slot = 0; slot < kStages; ++slot) {
      const int step = round * kStages + slot;
      if (step >= n_steps) break;
      tc::mbar_wait(bar0 + 8 * slot, round & 1);  // the step is staged
#pragma unroll
      for (int s = 0; s < kK; ++s) {
        uint32_t bw[4];
        tc::ldmatrix_x4_trans(bw, w_at + slot * kStageBytes + s * kTapBytes);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint32_t row =
              u == 0 ? a_at & ~1u
                     : (a_at & ~1u) +
                           (a_at & 1u ? 16 + kRP - kS : 16) * kCellBytes;
          uint32_t a[4];
          tc::ldmatrix_x4(a, row + slot * kStageBytes + s * kCellBytes);
          tc::mma_bf16(acc[s][u][0], a, bw);
          tc::mma_bf16(acc[s][u][1], a, bw + 2);
        }
      }
      __syncthreads();  // the stage is no longer read
      if (threadIdx.x == 0 && step + kStages < n_steps)
        issue(step + kStages, slot);
    }
  }

  // Every warp leaves its sums in `terms` [(r, s)][o][cell]; then each
  // thread rounds the 25 terms of an output to YDT and adds them in order
  // (r, s) = (0, 0), (0, 1), ..., (4, 4), and writes bias, ReLU, mask and
  // one rounding to bf16 into the block's output tile.
  float* terms = reinterpret_cast<float*>(stages);
  __nv_bfloat16* tile =
      reinterpret_cast<__nv_bfloat16*>(stages + kTermBytes);
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r = warp % kK, grp = warp / kK;
    float* mine = terms + r * kK * kC * kTermPitch + (2 * grp) * 16 + lane / 4;
#pragma unroll
    for (int s = 0; s < kK; ++s)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            mine[(s * kC + nt * 8 + 2 * (lane % 4) + (v & 1)) * kTermPitch +
                 u * 16 + 8 * (v >> 1)] = acc[s][u][nt][v];
  }
  for (int e = threadIdx.x; e < kC * kTileW; e += kThreads)
    tile[e] = __float2bfloat16_rn(0.f);
  __syncthreads();
  const int la = first_lane(blockIdx.x), width = end_lane(blockIdx.x) - la;
  for (int e = threadIdx.x; e < kC * kBM; e += kThreads) {
    const int o = e / kBM, ml = e % kBM, m = blockIdx.x * kBM + ml;
    if (m >= kCells) continue;
    float sum = 0.f;
#pragma unroll
    for (int rs = 0; rs < kK * kK; ++rs)
      sum += round_y<ROUND_Y>(terms[(rs * kC + o) * kTermPitch + ml]);
    const int t = lane_of(m);
    tile[o * kTileW + t - la] =
        __float2bfloat16_rn(fmaxf(sum + bias[o], 0.f) * mask[t]);
  }
  __syncthreads();
  __nv_bfloat16* dst =
      out + (static_cast<size_t>(blockIdx.z) * kCells + blockIdx.y) * kC * kKL +
      la;
  for (int e = threadIdx.x; e < kC * width; e += kThreads) {
    const int o = e / width, x = e - o * width;
    dst[o * kKL + x] = tile[o * kTileW + x];
  }
}

template <bool ROUND_Y>
int launch(const __nv_bfloat16* xp, const unsigned char* wt, const float* bias,
           const float* mask, unsigned char* scratch, __nv_bfloat16* out,
           int batch, cudaStream_t stream) {
  to_cells_kernel<<<dim3(kCells, batch), 256, 0, stream>>>(
      xp, reinterpret_cast<__nv_bfloat16*>(scratch));
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const auto kernel = conv_l2_tc_kernel<ROUND_Y>;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kSmemBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<dim3(kChunks, kCells, batch), kThreads, kSmemBytes, stream>>>(
      scratch, wt, bias, mask, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of the cell-major copy of xp that conv_l2_fused_lane needs as
// scratch for `batch` volumes.
long long conv_l2_fused_lane_scratch_bytes(int batch) {
  return static_cast<long long>(batch) * kCells * kPlaneBytes;
}

// One call on `stream`: the pre-pass writes xp's interior planes into
// `scratch` (conv_l2_fused_lane_scratch_bytes of it, 16-byte aligned), then
// the products read it and `wt`, w2 as bf16 B tiles (25 (p, q) x 25 (r, s)
// x 4 matrices x 8 c x 8 o, pallas_l2_probe.pack_b_tiles).  Returns
// cudaGetLastError() (0 on success).
int conv_l2_fused_lane(const void* xp, const void* wt, const void* bias,
                       const void* mask, void* scratch, void* out, int batch,
                       int round_y, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(xp);
  const auto* w = static_cast<const unsigned char*>(wt);
  const auto* bi = static_cast<const float*>(bias);
  const auto* mk = static_cast<const float*>(mask);
  auto* xs = static_cast<unsigned char*>(scratch);
  auto* o = static_cast<__nv_bfloat16*>(out);
  return round_y ? launch<true>(x, w, bi, mk, xs, o, batch, s)
                 : launch<false>(x, w, bi, mk, xs, o, batch, s);
}

const char* conv_l2_fused_lane_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
