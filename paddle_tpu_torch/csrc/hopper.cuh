// Hopper (sm_90a) building blocks shared by the warp-specialised kernels
// (fp8_matmul.cu, flash_attention_fwd.cu, flash_attention_bwd.cu,
// fused_ln_mlp.cu through gemm_sm90.cuh) and the paged decode
// (paged_attention.cu): mbarriers, TMA tile loads and reduce-adds into
// device memory, 1D bulk loads without a tensor map,
// named barriers, wgmma shared-memory descriptors and products (bf16
// with A from shared memory or registers, either operand K-major or
// MN-major; f16 with A from registers), register rebalancing, and the
// host-side encoding of TMA tensor maps.
//
// Shared-memory layout every descriptor here assumes: a tile of R rows
// whose rows are exactly 128 bytes (64 bf16 or 128 e4m3 values), written
// by a TMA load with CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned
// buffer. Eight rows (1024 bytes) form one swizzle atom; the 16-byte
// chunk c of row r lands at chunk c ^ (r % 8).
//
// - K-major operand (the reduction dimension along the 128-byte row, as
//   x (M, K) or w stored (N, K)): SBO = 1024 bytes between 8-row groups,
//   LBO unused. The k-th 32-byte step of a row is the descriptor of the
//   tile's base plus 32·k bytes (the hardware applies the swizzle to the
//   address it computes, which is why the base must be 1024-aligned).
// - MN-major operand (the output dimension along the row, as v (S, D)
//   used as the B of P·V, or dS stored transposed as the A of dS·K): SBO =
//   1024 bytes between 8-row groups along the reduction dimension, LBO =
//   the byte distance between two 64-value column blocks (two TMA boxes
//   stored one after the other); the k-th 16-deep step is the base plus
//   16 rows (2048 bytes). The wgmma takes it through its transpose bit
//   (tnspA / tnspB = 1); an A operand spans 64 rows, one column block.
//
// Accumulator layout of wgmma m64nN (f32): thread t of the warpgroup,
// w = t / 32, g = (t % 32) / 4, c = t % 4, holds for n8 block j
//   d[4j + 0], d[4j + 1] = (row 16w + g,     cols 8j + 2c, 8j + 2c + 1)
//   d[4j + 2], d[4j + 3] = (row 16w + g + 8, cols 8j + 2c, 8j + 2c + 1)
// and the register A operand of m64k16 (bf16) is the same as mma.sync's
// m16n8k16 A fragment of the warp's 16 rows, so two neighbouring n8
// blocks of an f32 accumulator, packed to bf16x2, are one k16 A step.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace ptt {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// wait until the barrier's phase with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// -- TMA tile loads ----------------------------------------------------

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// -- bulk copies without a tensor map ---------------------------------

// an L2 policy that marks the lines a load brings in as the first to go:
// for data read once, so that it displaces no line that is read again
// (and, behind a write-heavy kernel, writes back few dirty ones)
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// `bytes` contiguous bytes from device to shared memory by the bulk-copy
// engine under an L2 cache `policy` (l2_evict_first): one instruction
// from one thread, no registers held while they fly and no tensor map
// to encode on the host. Both addresses must be 16-byte aligned and
// `bytes` a multiple of 16: a caller whose spans break that takes a
// plain path of its own kernel. Completes on `bar`'s transaction count,
// so announce the bytes first with mbar_arrive_expect_tx (a barrier
// phase may take several such loads).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
         "l"(policy)
      : "memory");
}

// -- TMA reduce-adds into device memory, bulk groups, proxy fences ------

// make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operands, bulk copies) that reads them next
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the box of `map` at (c0, c1, c2) += the f32 tile at src (laid out as
// the box, 128-byte aligned), asynchronously, in this thread's bulk group;
// elements past the array's edges are left alone
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk groups but the newest N have read their sources
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// ... and completed
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `count` threads, a
// multiple of 32
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// -- register rebalancing between warpgroups ---------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// -- wgmma -------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand at `p` (see the header note)
__device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;                              // layout: 128-byte swizzle
  return d;
}

// the same descriptor `bytes` further on (bytes a multiple of 16)
__device__ __forceinline__ uint64_t desc_advance(uint64_t d, uint32_t bytes) {
  return d + static_cast<uint64_t>(bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator
// registers across an asynchronous wgmma or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define PTT_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PTT_R32(i) PTT_R8(i), PTT_R8(i + 8), PTT_R8(i + 16), PTT_R8(i + 24)

#define PTT_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define PTT_D96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
#define PTT_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128 f32) (+)= a (64 x 16 bf16) · b (16 x 128 bf16), both from
// shared memory; TA / TB = 1: that operand is MN-major (transpose bit)
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_m64n128k16_bf16_ss(float (&d)[64],
                                                         uint64_t da,
                                                         uint64_t db,
                                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PTT_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : PTT_R32(0), PTT_R32(32)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// the same at N = 192
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_m64n192k16_bf16_ss(float (&d)[96],
                                                         uint64_t da,
                                                         uint64_t db,
                                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " PTT_D96
      ", %96, %97, p, 1, 1, %99, %100;\n}\n"
      : PTT_R32(0), PTT_R32(32), PTT_R32(64)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// the same at N = 64
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_m64n64k16_bf16_ss(float (&d)[32],
                                                        uint64_t da,
                                                        uint64_t db,
                                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : PTT_R32(0)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x N f32) += a (64 x 16 bf16, registers) · b (16 x N bf16,
// MN-major in shared memory: the transpose bit), N = 128 or 64
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PTT_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : PTT_R32(0), PTT_R32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) (+)= a (64 x 16 f16, registers) · b (16 x 128 f16,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n128k16_f16_rs(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " PTT_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : PTT_R32(0), PTT_R32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PTT_R32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef PTT_R8
#undef PTT_R32
#undef PTT_D32
#undef PTT_D64
#undef PTT_D96

// -- host: TMA tensor maps ---------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda; null when the driver has none
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a tiled map of a `rank`-dimensional array (dims and box innermost
// first, strides in bytes of dims 1..rank-1), 128-byte swizzle unless
// told otherwise, zero fill past every edge; returns a CUDA runtime error
// code (0 on success)
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                    const void* base, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = enc(map, type, static_cast<cuuint32_t>(rank),
                         const_cast<void*>(base), dims, strides, box, ones,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

inline int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

}  // namespace hopper
}  // namespace ptt
