// Tensor-core building blocks shared by the training kernels
// (flash_attention_bwd.cu, fused_ln_mlp.cu): ldmatrix loads from shared
// memory and the mma.sync m16n8k16 bf16 product with f32 accumulation.
// fp8_matmul.cu loads its e4m3 A rows with ldsm_x4 too.
//
// Fragment layout of the accumulator c[0..3] for lane (g = lane / 4,
// t = lane % 4): c0 (row g, col 2t), c1 (g, 2t+1), c2 (g+8, 2t),
// c3 (g+8, 2t+1) of the 16x8 tile.
//
// Addressing of a 16x16 A tile at (m0, k0), for mat = lane / 8 and
// mrow = lane % 8:
//   stored [m][k] (k contiguous): ldsm_x4(a, base + (m0 + lane % 16) * ld
//                                          + k0 + (lane / 16) * 8)
//   stored [k][m] (m contiguous): ldsm_x4_t(a, base + (k0 + (mat / 2) * 8
//                                          + mrow) * ld + m0 + (mat % 2) * 8)
// and of two 16x8 B tiles at (k0, n0) and (k0, n0 + 8), giving b[0], b[1]
// for the first and b[2], b[3] for the second:
//   stored [n][k] (k contiguous): ldsm_x4(b, base + (n0 + (mat / 2) * 8
//                                          + mrow) * ld + k0 + (mat % 2) * 8)
//   stored [k][n] (n contiguous): ldsm_x4_t(b, base + (k0 + (mat % 2) * 8
//                                          + mrow) * ld + n0 + (mat / 2) * 8)
#pragma once

#include "common.cuh"

namespace ptt {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (4 floats) += a (16x16, row) · b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float* c, const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float lo,
                                             float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// 16-byte asynchronous copy device -> shared memory; src_bytes 0
// zero-fills the destination without reading the source
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace ptt
