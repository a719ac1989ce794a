// fp8 (e4m3) matmul with the dequant epilogue, for Hopper (sm_90a):
//   out[m, n] = (sum_k xq[m, k] * wq[k, n]) * (sx * sw) (+ b[n])
// xq (M, K) and wq (K, N) float8_e4m3fn, row-major; sx, sw f32 per-tensor
// scales read from device memory; the sum in f32; b f32 (N) or none; out
// bf16 or f32.
//
// Replaces: paddle_tpu/ops/fp8_matmul.py `_fp8_kernel` (launched by
// `_fp8_matmul_2d`, pallas_call at :98). Same numerics: each operand is
// upcast from e4m3 to a 16-bit float that holds it exactly (the TPU
// kernel takes bf16, this one f16: both hold every e4m3 value), so every
// product is exact and the sums are f32; the epilogue is
// `acc * (sx * sw)`, then `+ b`, each rounded once (built with
// -fmad=false, and written with __fmul_rn/__fadd_rn), then the cast. Any
// M, K and N: ragged tiles are zero-filled on load and masked on store;
// the TPU wrapper's untileable fallback to XLA has no counterpart.
//
// What bounds it on an H100: on the fp8 training path M = 8192 tokens and
// (K, N) = (2048, 8192) or (8192, 2048), 2*M*K*N = 275 GFLOP against
// ~100 MB of operands, far above the ~590 operations per byte at which
// the e4m3 tensor-core rate (1979 TFLOP/s) would take over from memory:
// the bound is that rate. This kernel runs its products at the 16-bit
// rate (989 TFLOP/s), half of that bound, by design (below).
//
// Design (a simple, right first kernel). A 128x128 output tile per block
// of 8 warps (2 along m x 4 along n), 64-deep K steps. The e4m3 tiles
// (128x64 bytes of xq, 64x128 of wq) stream through a 3-stage cp.async
// ring in shared memory, 16 bytes (16 values) per copy; at each step the
// block converts the landed stage into f16 tiles (one `cvt.rn.f16x2.
// e4m3x2` per two values, through cuda_fp8.h), and the warps run
// mma.sync m16n8k16 f16 x f16 -> f32 on them with ldmatrix loads (the
// (K, N) weight tile is read transposed with ldmatrix.trans, on the
// converted 16-bit values, so the weight is never transposed in memory).
// Native e4m3 mma/wgmma at twice the rate is the later redesign; its
// accumulator precision has to be measured against the plain version
// first. Shapes whose rows are not 16-byte multiples (K or N not a
// multiple of 16) load their tiles with plain byte loads instead of
// cp.async.
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "mma.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 3;
constexpr int NT = 256;                        // 8 warps, 2 (m) x 4 (n)
constexpr int A_RAW = BM * BK;                 // e4m3 bytes of one A tile
constexpr int B_RAW = BK * BN;                 // ... of one B tile
constexpr int STAGE_RAW = A_RAW + B_RAW;
// converted f16 tiles, rows padded by 16 bytes so that the 8 row
// addresses of an ldmatrix fall in distinct banks
constexpr int LDA = BK + 8;                    // A stored [m][k]
constexpr int LDB = BN + 8;                    // B stored [k][n]
constexpr int A16 = BM * LDA;
constexpr int B16 = BK * LDB;
constexpr int SMEM = STAGES * STAGE_RAW + (A16 + B16) * 2;
constexpr int ACC = BM * BN / NT;              // accumulators per thread

// two e4m3 values (low byte first) -> two f16 values (low half first)
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}

// c (4 floats) += a (16x16, row) . b (16x8, col); f16 in, f32 accumulate
__device__ __forceinline__ void mma_f16(float* c, const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + TR) x byte columns [c0, c0 + TC) of a row-major (rows,
// cols) e4m3 array with leading dimension ld into dst (TR x TC bytes);
// bytes past rows or cols are zero. ALIGNED: cols and ld are multiples
// of 16 and the base is 16-byte aligned, so each 16-byte chunk is wholly
// inside or wholly outside and goes by cp.async
template <int TR, int TC, bool ALIGNED>
__device__ __forceinline__ void load_raw(uint8_t* dst, const uint8_t* g,
                                         int ld, int rows, int cols, int r0,
                                         int c0) {
  constexpr int CPR = TC / 16;
  for (int ch = threadIdx.x; ch < TR * CPR; ch += NT) {
    const int r = ch / CPR, c = (ch % CPR) * 16;
    const int gr = r0 + r, gc = c0 + c;
    uint8_t* d = dst + r * TC + c;
    if constexpr (ALIGNED) {
      const bool in = gr < rows && gc < cols;
      ptt::cp_async_16(d, g + (in ? (size_t)gr * ld + gc : 0), in ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = gc + 4 * q + j;
          if (gr < rows && cc < cols)
            v |= static_cast<uint32_t>(g[(size_t)gr * ld + cc]) << (8 * j);
        }
        w[q] = v;
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// a landed TR x TC e4m3 tile -> f16 tile with rows of LD halves
template <int TR, int TC, int LD>
__device__ __forceinline__ void convert_tile(const uint8_t* raw,
                                             uint16_t* dst) {
  constexpr int CPR = TC / 16;
  for (int ch = threadIdx.x; ch < TR * CPR; ch += NT) {
    const int r = ch / CPR, c = (ch % CPR) * 16;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * TC + c);
    const uint32_t in[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o[2 * q] = e4m3x2_to_f16x2(in[q]);
      o[2 * q + 1] = e4m3x2_to_f16x2(in[q] >> 16);
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * LD + c);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// acc += sA (BM x BK, [m][k]) . sB (BK x BN, [k][n]) for this warp's
// 64 x 32 part: index i = (mi * NI + ni) * 4 + e over its m16n8 tiles
__device__ __forceinline__ void tile_product(float* acc, const uint16_t* sA,
                                             const uint16_t* sB) {
  constexpr int MI = BM / 32, NI = BN / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mat = lane >> 3, mrow = lane & 7;
  const int wm = (warp & 1) * (BM / 2), wn = (warp >> 1) * (BN / 4);
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ptt::ldsm_x4(a[mi], sA + (wm + mi * 16 + (lane & 15)) * LDA + ks * 16
                              + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NI / 2; ++np) {
      uint32_t b[4];
      ptt::ldsm_x4_t(b, sB + (ks * 16 + (mat & 1) * 8 + mrow) * LDB + wn
                            + np * 16 + (mat >> 1) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_f16(acc + (mi * NI + 2 * np) * 4, a[mi], b[0], b[1]);
        mma_f16(acc + (mi * NI + 2 * np + 1) * 4, a[mi], b[2], b[3]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi);
template <>
__device__ __forceinline__ void store2<float>(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float lo, float hi) {
  ptt::store_bf16x2(p, lo, hi);
}

template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(NT)
fp8_mm(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
       const float* __restrict__ sx, const float* __restrict__ sw,
       const float* __restrict__ b, T* __restrict__ out, int M, int K,
       int N) {
  extern __shared__ __align__(16) unsigned char fp8_smem[];
  uint8_t* raw = fp8_smem;
  uint16_t* sA = reinterpret_cast<uint16_t*>(fp8_smem + STAGES * STAGE_RAW);
  uint16_t* sB = sA + A16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = (K + BK - 1) / BK;

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  auto load = [&](int kt) {
    uint8_t* st = raw + (kt % STAGES) * STAGE_RAW;
    load_raw<BM, BK, ALIGNED>(st, x, K, M, K, m0, kt * BK);
    load_raw<BK, BN, ALIGNED>(st + A_RAW, w, N, K, N, kt * BK, n0);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s);
    ptt::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    ptt::cp_async_wait<STAGES - 2>();   // step kt has landed
    __syncthreads();                    // ... for every thread; step kt - 1's
                                        // stage and f16 tiles are read
    if (kt + STAGES - 1 < KT) load(kt + STAGES - 1);
    ptt::cp_async_commit();
    const uint8_t* st = raw + (kt % STAGES) * STAGE_RAW;
    convert_tile<BM, BK, LDA>(st, sA);
    convert_tile<BK, BN, LDB>(st + A_RAW, sB);
    __syncthreads();
    tile_product(acc, sA, sB);
  }
  ptt::cp_async_wait<0>();

  // epilogue: acc * (sx * sw) (+ b), each rounded once, then the cast;
  // the accumulator pairs (e, e + 1) are neighbouring columns of one row
  const float s = __fmul_rn(sx[0], sw[0]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int NI = BN / 32;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < ACC; i += 2) {
    const int mi = i / (4 * NI), ni = (i >> 2) % NI, e = i & 3;
    const int gm = m0 + (warp & 1) * (BM / 2) + mi * 16 + (lane >> 2)
        + (e >> 1) * 8;
    const int gn = n0 + (warp >> 1) * (BN / 4) + ni * 8 + 2 * (lane & 3);
    if (gm >= M || gn >= N) continue;
    float v0 = __fmul_rn(acc[i], s), v1 = __fmul_rn(acc[i + 1], s);
    if (b != nullptr) {
      v0 = __fadd_rn(v0, b[gn]);
      if (gn + 1 < N) v1 = __fadd_rn(v1, b[gn + 1]);
    }
    T* o = out + (size_t)gm * N + gn;
    if (pairs && gn + 1 < N) {
      store2<T>(o, v0, v1);
    } else {
      o[0] = ptt::from_f<T>(v0);
      if (gn + 1 < N) o[1] = ptt::from_f<T>(v1);
    }
  }
}

template <typename T, bool ALIGNED>
cudaError_t launch(const uint8_t* x, const uint8_t* w, const float* sx,
                   const float* sw, const float* b, T* out, int M, int K,
                   int N, cudaStream_t s) {
  static bool configured = false;   // the attribute is per kernel, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fp8_mm<T, ALIGNED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fp8_mm<T, ALIGNED><<<grid, NT, SMEM, s>>>(x, w, sx, sw, b, out, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// xq (M, K) and wq (K, N) e4m3 row-major; sx, sw f32 device scalars; b f32
// (N) or null; out (M, N) in `dtype` (0 f32, 1 bf16). Returns
// cudaGetLastError() after the launch.
extern "C" int fp8_matmul(const void* xq, const void* wq, const float* sx,
                          const float* sw, const float* b, void* out, int M,
                          int K, int N, int dtype, void* stream) {
  if (M < 0 || K < 0 || N < 0 || (dtype != ptt::kF32 && dtype != ptt::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x = static_cast<const uint8_t*>(xq);
  const uint8_t* w = static_cast<const uint8_t*>(wq);
  const bool aligned = K % 16 == 0 && N % 16 == 0
      && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w))
          & 15) == 0;
  cudaError_t err;
  if (dtype == ptt::kBF16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    err = aligned ? launch<__nv_bfloat16, true>(x, w, sx, sw, b, o, M, K, N, s)
                  : launch<__nv_bfloat16, false>(x, w, sx, sw, b, o, M, K, N,
                                                 s);
  } else {
    float* o = static_cast<float*>(out);
    err = aligned ? launch<float, true>(x, w, sx, sw, b, o, M, K, N, s)
                  : launch<float, false>(x, w, sx, sw, b, o, M, K, N, s);
  }
  return static_cast<int>(err);
}
