// Warp-level tensor-core and async-copy primitives shared by the port's
// mma.sync kernels (gather_tile_corr.cu, nc_conv4d.cu, nc_conv4d_vjp.cu,
// conv4d_small_cout.cu, conv_l2_fused_lane.cu), for sm_90a.
//
// Each is one PTX instruction that the toolchain probes of csrc/probes/
// checked on the H100 at these kernels' shapes (mma_sync_m16n8k16_bf16,
// ldmatrix_x4, ldmatrix_x4_trans, cp_async_16).  Fragment layouts of
// mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major):  a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..],
//                            a2 = A[g][2t+8..],     a3 = A[g+8][2t+8..]
//   B (16 x 8, "col"):       b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C, D (16 x 8, f32):      d0, d1 = D[g][2t..2t+1], d2, d3 = D[g+8][2t..]
// ldmatrix: lane l gives the address of row l % 8 of matrix l / 8 (16
// bytes); register m receives matrix m's row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 (with .trans: column l / 4, rows 2 (l % 4) and + 1).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `bytes` < 16 zero-fills the
// rest (0: the whole 16, and nothing is read from `src`)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// at a shared-state-space address (smem_addr), or at a generic pointer
// into shared memory
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  ldmatrix_x4(r, smem_addr(p));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  ldmatrix_x4_trans(r, smem_addr(p));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += A (16 x 16) B (16 x 8), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 values, `lo` at the lower address
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// 1-D bulk copies (cp.async.bulk) completing on an mbarrier (probes
// cp_async_bulk, mbarrier_parity): one thread arms the barrier with the
// bytes of a stage and issues its copies; every thread waits on the phase.
// Barriers and destinations at shared-state-space addresses (smem_addr) or
// generic pointers into shared memory.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state)
               : "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  mbar_expect(smem_addr(bar), bytes);
}

// wait for phase `parity` of `bar`; a phase that has not completed after
// two seconds (copies that never land, a wait that never gets its phase)
// ends the kernel with an error instead of hanging it.  A try_wait may
// suspend the thread for a time of the hardware's choosing, so the bound
// is on the clock, not on the number of tries.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (start == 0) {
      start = now;
    } else if (now - start > 2000000000ull) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_addr(bar), parity);
}

// `bytes` (a multiple of 16) global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  bulk_copy(smem_addr(dst), src, bytes, smem_addr(bar));
}

}  // namespace tc
