// Gathered tile correlation of the coarse-to-fine pipeline on the H100
// (sm_90a):
//
//   out[b, n, c, i, j] = bf16( sum over ch of f32(fa_p2[b, n, i, ch])
//                                          * f32(fb[b, y0 + j / p, x0 + j % p, ch]) )
//
// with y0 = row_blocks[b, n, c] * factor and x0 = col_starts[b, n, c]: for
// every (batch b, coarse source cell n, candidate c) the source patch
// fa_p2 (p*p rows of C bf16 channels, pre-gathered) against the candidate's
// p x p window of the full target feature map fb (B, hB, wB, C), read
// straight from fb: no gathered copy of the target patches is made.  Output
// (B, N, K, p*p, p*p) bf16, f32 sums.
//
// Replaces the TPU kernel ncnet_tpu/ops/sparse_corr.py::
// gather_tile_corr_pallas (kernel _gather_corr_kernel), whose grid
// (B, N, K) DMAs the candidate's factor-row bands of fb into VMEM.  Unlike
// it, this kernel takes any origin: the band alignment (halo a multiple of
// factor) and the VMEM budget of sparse_gather_feasible do not apply.
//
// Bound: bytes.  At the PF-Pascal coarse-to-fine shape (800^2 images, a
// 50^2 grid of C = 1024 channels, 625 coarse cells, k = 4, patch 6, B = 4)
// one launch makes 10,000 tiles of 36 x 36: 2.65e10 FLOP against 184 MB of
// fa_p2, 20 MB of fb and 26 MB of output; ~115 FLOP per byte, below the
// card's ~295 bf16 FLOP/byte ridge.
//
// Design (tensor cores): one block per (b, n) computes the whole
// (p^2, C) x (C, K p^2) product of its source patch against all K candidate
// windows, so fa_p2 is read from device memory once; fb (20 MB at the
// serving shape) stays in L2.  Channels stream through shared memory in
// chunks of 64, double-buffered with 16-byte cp.async copies, one barrier a
// chunk; rows are staged at a 144-byte pitch so the 8 rows of an ldmatrix
// fall on distinct banks.  The product runs as mma.sync m16n8k16 (bf16 in,
// f32 sums) with operands from ldmatrix: M = p^2 padded to 16 (48 for 36),
// N = K p^2 padded to 8, the warps split N.  Padded rows, columns and the
// channels past C are zero-filled by the copies and never stored.  A C that
// is not a multiple of 8 (or an unaligned tensor) takes a scalar staging
// path instead.  Wider tiles than one block holds (p^2 > 64 or K p^2 > 192)
// split over more blocks along M and N, never along C: every output's
// channels are summed in the same order in one block, with no atomics, so
// two launches give bit-identical results.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 6;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;          // channels a stage holds
constexpr int kPitch = kChunk + 8;  // bf16 per staged row (144 bytes)
constexpr int kMaxMT = 4;           // 16-row m-tiles a block: 64 source rows
constexpr int kMaxNTW = 4;          // 8-column n-tiles a warp

template <int MT, int NTW>
struct Tile {
  static constexpr int kRowsA = 16 * MT;             // source rows
  static constexpr int kColsB = 8 * NTW * kWarps;    // candidate cells
  static constexpr int kRows = kRowsA + kColsB;      // staged rows a stage
  static constexpr int kStageElems = kRows * kPitch;
  static constexpr size_t kSmem =
      kRows * sizeof(long long) + 2 * kStageElems * sizeof(__nv_bfloat16);
};

template <int MT, int NTW>
__global__ void __launch_bounds__(kThreads)
gather_tile_corr_kernel(const __nv_bfloat16* __restrict__ fa,
                        const __nv_bfloat16* __restrict__ fb,
                        const int* __restrict__ row_blocks,
                        const int* __restrict__ col_starts,
                        __nv_bfloat16* __restrict__ out, int N, int K, int C,
                        int hB, int wB, int patch, int factor, bool vec) {
  using T = Tile<MT, NTW>;
  extern __shared__ __align__(16) unsigned char smem[];
  // element offset of each staged row's channel 0 in fa or fb, -1 for a
  // padding row; then the two stages of (kRowsA + kColsB) x kPitch bf16
  long long* off = reinterpret_cast<long long*>(smem);
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(off + T::kRows);

  const int p2 = patch * patch;
  const int n_cols = K * p2;
  const int64_t bn = blockIdx.x;  // b * N + n
  const int64_t b = bn / N;
  const int n0 = blockIdx.y * T::kColsB;
  const int m0 = blockIdx.z * T::kRowsA;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int r = threadIdx.x; r < T::kRows; r += kThreads) {
    long long o = -1;
    if (r < T::kRowsA) {
      const int i = m0 + r;
      if (i < p2) o = (bn * p2 + i) * static_cast<long long>(C);
    } else {
      const int n = n0 + r - T::kRowsA;
      if (n < n_cols) {
        const int cand = n / p2, j = n - cand * p2;
        const int y0 = row_blocks[bn * K + cand] * factor;
        const int x0 = col_starts[bn * K + cand];
        // the caller's origins keep the window inside fb; a window that is
        // not is a caller's bug, and faults the launch
        if (y0 < 0 || y0 + patch > hB || x0 < 0 || x0 + patch > wB) __trap();
        o = ((b * hB + y0 + j / patch) * wB + x0 + j % patch) *
            static_cast<long long>(C);
      }
    }
    off[r] = o;
  }
  __syncthreads();

  // stage channels [c0, c0 + kChunk) of every row; zeros past C and in the
  // padding rows
  auto stage = [&](int c0, __nv_bfloat16* s) {
    const int cw = min(kChunk, C - c0);
    if (vec) {
      for (int e = threadIdx.x; e < T::kRows * (kChunk / 8);
           e += kThreads) {
        const int r = e / (kChunk / 8), ch = 8 * (e % (kChunk / 8));
        const long long o = off[r];
        const __nv_bfloat16* base = r < T::kRowsA ? fa : fb;
        const bool ok = o >= 0 && ch < cw;
        tc::cp_async16(s + r * kPitch + ch, ok ? base + o + c0 + ch : base,
                       ok ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < T::kRows * kChunk; e += kThreads) {
        const int r = e / kChunk, ch = e % kChunk;
        const long long o = off[r];
        const __nv_bfloat16* base = r < T::kRowsA ? fa : fb;
        s[r * kPitch + ch] = (o >= 0 && ch < cw) ? base[o + c0 + ch]
                                                 : __float2bfloat16_rn(0.f);
      }
    }
  };

  // a warp whose columns all lie past the tile's still stages and syncs
  const bool busy = n0 + warp * NTW * 8 < n_cols;
  float acc[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  const int n_chunks = (C + kChunk - 1) / kChunk;
  stage(0, buf);
  tc::cp_async_commit();
  for (int t = 0; t < n_chunks; ++t) {
    tc::cp_async_wait_all();
    __syncthreads();  // chunk t landed; chunk t - 1 is no longer read
    if (t + 1 < n_chunks)
      stage((t + 1) * kChunk, buf + ((t + 1) & 1) * T::kStageElems);
    tc::cp_async_commit();
    if (!busy) continue;
    const __nv_bfloat16* sa = buf + (t & 1) * T::kStageElems;
    const __nv_bfloat16* sb = sa + T::kRowsA * kPitch + warp * NTW * 8 * kPitch;
    const int ksteps = (min(kChunk, C - t * kChunk) + 15) / 16;
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      if (ks >= ksteps) break;
      uint32_t a[MT][4], bf[NTW][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tc::ldmatrix_x4(a[mt], sa + (mt * 16 + (lane & 15)) * kPitch +
                                   ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        tc::ldmatrix_x2(bf[nt], sb + (nt * 8 + (lane & 7)) * kPitch +
                                    ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) tc::mma_bf16(acc[mt][nt], a[mt], bf[nt]);
    }
  }
  if (!busy) return;

  const int g = lane / 4, t4 = lane % 4;
  const bool pairs = p2 % 2 == 0;  // two neighbouring columns share a tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = m0 + mt * 16 + g + 8 * h;
      if (i >= p2) continue;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int n = n0 + (warp * NTW + nt) * 8 + 2 * t4;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (pairs) {
          if (n >= n_cols) continue;
          const int cand = n / p2, j = n - cand * p2;
          *reinterpret_cast<uint32_t*>(
              out + ((bn * K + cand) * p2 + i) * p2 + j) = tc::pack_f32(v0, v1);
        } else {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int nq = n + q;
            if (nq >= n_cols) continue;
            const int cand = nq / p2, j = nq - cand * p2;
            out[((bn * K + cand) * p2 + i) * p2 + j] =
                __float2bfloat16_rn(q ? v1 : v0);
          }
        }
      }
    }
  }
}

template <int MT, int NTW>
cudaError_t launch(const void* fa, const void* fb, const void* rows,
                   const void* cols, void* out, int B, int N, int K, int C,
                   int hB, int wB, int patch, int factor, bool vec,
                   cudaStream_t stream) {
  using T = Tile<MT, NTW>;
  auto kernel = gather_tile_corr_kernel<MT, NTW>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const int p2 = patch * patch;
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(B) * N),
                  (K * p2 + T::kColsB - 1) / T::kColsB,
                  (p2 + T::kRowsA - 1) / T::kRowsA);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(fa),
      static_cast<const __nv_bfloat16*>(fb), static_cast<const int*>(rows),
      static_cast<const int*>(cols), static_cast<__nv_bfloat16*>(out), N, K,
      C, hB, wB, patch, factor, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream`: fa_p2 (B, N, p*p, C), fb (B, hB, wB, C)
// bf16; row_blocks, col_starts (B, N, K) int32; out (B, N, K, p*p, p*p)
// bf16; all contiguous.  Returns the cudaError_t of the launch (0 on
// success).
int gather_tile_corr_bf16(const void* fa_p2, const void* fb,
                          const void* row_blocks, const void* col_starts,
                          void* out, int B, int N, int K, int C, int hB,
                          int wB, int patch, int factor, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return 0;
  if (C <= 0 || patch <= 0 || factor <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int p2 = patch * patch;
  const int64_t blocks = static_cast<int64_t>(B) * N;
  if (blocks > INT_MAX || static_cast<int64_t>(K) * p2 > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies need every row to start on 16 bytes
  const bool vec = C % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(fa_p2) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(fb) % 16 == 0;
  const int mt = min(kMaxMT, (p2 + 15) / 16);
  const int nt_total = (K * p2 + 7) / 8;
  const int ntw = min(kMaxNTW, (nt_total + kWarps - 1) / kWarps);
  auto s = static_cast<cudaStream_t>(stream);
#define GATHER_LAUNCH(MT, NTW)                                             \
  if (mt == MT && ntw == NTW)                                              \
    return static_cast<int>(launch<MT, NTW>(fa_p2, fb, row_blocks,         \
                                            col_starts, out, B, N, K, C,   \
                                            hB, wB, patch, factor, vec, s));
#define GATHER_ROW(MT) \
  GATHER_LAUNCH(MT, 1) GATHER_LAUNCH(MT, 2) GATHER_LAUNCH(MT, 3) GATHER_LAUNCH(MT, 4)
  GATHER_ROW(1) GATHER_ROW(2) GATHER_ROW(3) GATHER_ROW(4)
#undef GATHER_ROW
#undef GATHER_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* gather_tile_corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
