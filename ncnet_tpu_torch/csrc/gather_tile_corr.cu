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
// Design (simple first): one block per (b, n) walks its K candidates.  The
// channels come in chunks of up to 32: each chunk of the source patch and
// of the candidate's window is staged in shared memory as f32, channel-
// major, and every thread accumulates 2 x 2 micro tiles of the p^2 x p^2
// output in f32 registers (float2 shared-memory loads, CUDA-core FMAs).
// Channels are summed in ascending order in every output, so two launches
// give bit-identical results.  A tensor-core (mma / wgmma) design that
// reuses the source patch across the K candidates is later work.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTilesPerThread = 8;  // 2 x 2 micro tiles a thread holds
constexpr int kPass = kThreads * kTilesPerThread;  // micro tiles per pass
constexpr int kMaxChunk = 32;       // channels staged at a time
constexpr int kSmemBytes = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
gather_tile_corr_kernel(const __nv_bfloat16* __restrict__ fa,
                        const __nv_bfloat16* __restrict__ fb,
                        const int* __restrict__ row_blocks,
                        const int* __restrict__ col_starts,
                        __nv_bfloat16* __restrict__ out, int N, int K, int C,
                        int hB, int wB, int patch, int factor, int ck,
                        int p2pad) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;               // (ck, p2pad): the source chunk
  float* sb = smem + ck * p2pad;  // (ck, p2pad): the candidate's chunk

  const int p2 = patch * patch;
  const int mt = (p2 + 1) / 2;  // micro tiles along either side
  const int n_mt = mt * mt;
  const int64_t bn = blockIdx.x;  // b * N + n
  const int64_t b = bn / N;

  // the padding rows are read by the last micro tile when p2 is odd and
  // are never staged: zero the whole buffer once
  for (int e = threadIdx.x; e < 2 * ck * p2pad; e += kThreads) smem[e] = 0.f;

  const __nv_bfloat16* src = fa + bn * p2 * C;
  const __nv_bfloat16* tgt = fb + b * hB * wB * C;
  for (int k = 0; k < K; ++k) {
    const int64_t bnk = bn * K + k;
    const int y0 = row_blocks[bnk] * factor;
    const int x0 = col_starts[bnk];
    // the caller's origins keep the window inside fb; a window that is not
    // is a caller's bug, and faults the launch (a test uniform in the block)
    if (y0 < 0 || y0 + patch > hB || x0 < 0 || x0 + patch > wB) __trap();
    __nv_bfloat16* o = out + bnk * p2 * p2;
    for (int pass = 0; pass < n_mt; pass += kPass) {
      float acc[kTilesPerThread][4];
#pragma unroll
      for (int s = 0; s < kTilesPerThread; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[s][q] = 0.f;

      for (int ch0 = 0; ch0 < C; ch0 += ck) {
        const int cw = min(ck, C - ch0);
        __syncthreads();  // the previous chunk (or the zeroing) is done
        for (int e = threadIdx.x; e < p2 * cw; e += kThreads) {
          const int row = e / cw;
          const int c = e - row * cw;
          sa[c * p2pad + row] =
              __bfloat162float(src[static_cast<int64_t>(row) * C + ch0 + c]);
          const int y = y0 + row / patch;
          const int x = x0 + row % patch;
          sb[c * p2pad + row] = __bfloat162float(
              tgt[(static_cast<int64_t>(y) * wB + x) * C + ch0 + c]);
        }
        __syncthreads();
#pragma unroll
        for (int s = 0; s < kTilesPerThread; ++s) {
          const int m = pass + s * kThreads + static_cast<int>(threadIdx.x);
          if (m < n_mt) {
            const int i = 2 * (m / mt);
            const int j = 2 * (m % mt);
            float a00 = acc[s][0], a01 = acc[s][1];
            float a10 = acc[s][2], a11 = acc[s][3];
#pragma unroll 4
            for (int c = 0; c < cw; ++c) {
              const float2 av = *reinterpret_cast<const float2*>(sa + c * p2pad + i);
              const float2 bv = *reinterpret_cast<const float2*>(sb + c * p2pad + j);
              a00 = fmaf(av.x, bv.x, a00);
              a01 = fmaf(av.x, bv.y, a01);
              a10 = fmaf(av.y, bv.x, a10);
              a11 = fmaf(av.y, bv.y, a11);
            }
            acc[s][0] = a00;
            acc[s][1] = a01;
            acc[s][2] = a10;
            acc[s][3] = a11;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kTilesPerThread; ++s) {
        const int m = pass + s * kThreads + static_cast<int>(threadIdx.x);
        if (m < n_mt) {
          const int i = 2 * (m / mt);
          const int j = 2 * (m % mt);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int ii = i + q / 2;
            const int jj = j + q % 2;
            if (ii < p2 && jj < p2)
              o[static_cast<int64_t>(ii) * p2 + jj] = __float2bfloat16_rn(acc[s][q]);
          }
        }
      }
    }
  }
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
  // even (aligned float2 loads), and not a multiple of 4, which keeps the
  // transposed staging stores to two-way bank conflicts
  int p2pad = p2 + (p2 & 1);
  if (p2pad % 4 == 0) p2pad += 2;
  int ck = kMaxChunk;
  while (ck > 1 && 2L * ck * p2pad * sizeof(float) > kSmemBytes) ck /= 2;
  const size_t smem = 2UL * ck * p2pad * sizeof(float);
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = static_cast<int64_t>(B) * N;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  gather_tile_corr_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(fa_p2),
      static_cast<const __nv_bfloat16*>(fb),
      static_cast<const int*>(row_blocks), static_cast<const int*>(col_starts),
      static_cast<__nv_bfloat16*>(out), N, K, C, hB, wB, patch, factor, ck,
      p2pad);
  return static_cast<int>(cudaGetLastError());
}

const char* gather_tile_corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
