// Shared-memory building blocks of the kernels that do not go through
// hopper.cuh's TMA: 16-byte cp.async copies from device memory into
// shared memory with their commit/wait groups (the f32 FMA mainloop of
// fused_ln_mlp.cu, the weight ring of int8_matmul.cu), and the ldmatrix
// load fp8_matmul.cu takes its e4m3 A rows with.
#pragma once

#include "common.cuh"

namespace ptt {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices from shared memory, one row address a lane
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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
