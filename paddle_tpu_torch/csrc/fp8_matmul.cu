// fp8 (e4m3) matmul with the dequant epilogue, for Hopper (sm_90a):
//   out[m, n] = (sum_k xq[m, k] * wq[k, n]) * (sx * sw) (+ b[n])
// xq (M, K) float8_e4m3fn row-major; the weight as wt = wqᵀ (N, K)
// row-major (a column-major wq (K, N) is that array); sx, sw f32
// per-tensor scales read from device memory; the sum in f32; b f32 (N)
// or none; out bf16 or f32.
//
// Replaces: paddle_tpu/ops/fp8_matmul.py `_fp8_kernel` (launched by
// `_fp8_matmul_2d`, pallas_call at :98). Same function: every product of
// two e4m3 values is exact, the sums are f32, and the epilogue is
// `acc * (sx * sw)`, then `+ b`, each rounded once (built with
// -fmad=false, and written with __fmul_rn/__fadd_rn), then the cast.
// Any M and N; K a multiple of 16 and 16-byte-aligned bases (TMA's
// stride rule: the wrapper pads K with zeros, which is exact, and copies
// an unaligned operand).
//
// What bounds it on an H100: on the fp8 training path M = 8192 tokens and
// (K, N) = (2048, 8192) or (8192, 2048), 2*M*K*N = 275 GFLOP against
// ~100 MB of operands, far above the ~590 operations per byte at which
// the e4m3 tensor-core rate (1979 TFLOP/s) takes over from memory: the
// bound is that rate, 0.139 ms.
//
// Why the products are f16, not e4m3. Hopper's e4m3 wgmma sums its
// products in reduced precision. Measured on the H100 against the plain
// version (f32 out, max |Δ| / max |plain|; PERF.md §6 has the readings
// and how to rebuild that variant): the whole K in the wgmma sum ~3e-3
// (K = 2048) and ~8e-3 (K = 8192); that sum promoted into f32 every 128
// of K (what torch._scaled_mm's default does, and its error is the same)
// 1.5e-4 to 2e-4, above the 1e-4 the f32 plain version is held to; every
// 32 ~5e-5, but then the fp8 training step on the card flips twice as
// many e4m3 activation codes as with exact sums and drifts from the
// CPU's past the bound of chip_smoke.py's phase 18 on one seed of four.
// So each e4m3 operand is converted to f16 (exact: f16 holds every e4m3
// value) and the products run on f16 wgmma with f32 sums, at the 16-bit
// rate, half the bound's.
//
// Design. First a small kernel writes wt into an f16 scratch (N, K) (the
// wrapper allocates it), once a call: converting it inside the GEMM would
// repeat the work for every row of output tiles. Then a persistent grid
// (one block an SM) walks the 192x128 output tiles, rastered in groups of
// 8 along M so that neighbouring blocks share their operand tiles in L2.
// A block is a producer warpgroup (setmaxnreg cuts its registers) whose
// one thread keeps TMA loads in flight (a stage is the e4m3 tile of xq and
// the f16 tile of wt, 128 of K, 128-byte swizzle, 56 KB; a ring of 4;
// full/empty mbarriers; it runs on into the next output tile while the
// consumers finish the last one) and three consumer warpgroups (raised
// registers), each owning 64 rows of the output tile: per stage each
// loads its e4m3 rows with ldmatrix, converts them in registers into the
// A operand of eight f16 wgmma m64n128k16 (B: the wt tile, K-major in
// shared memory), and converts the next stage's while those run.
// ldmatrix hands a thread four consecutive bytes of a row where the A
// fragment wants k pairs (2t, 2t+1) and (2t+8, 2t+9); a sum does not care
// about the order of k inside a k16 step, so the f16 wt is written in the
// same permuted order (byte p of each 16 at k 8·((p/2)%2) + 2·(p/4) +
// p%2). The epilogue scales and adds the bias in registers; neighbouring
// lanes swap column pairs so that each stores four consecutive outputs at
// once (the consumers store together while the tensor cores idle, so
// fewer, wider stores are time back), masked at the ragged edge (TMA
// zero-fills tiles past M, N and K).
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

namespace hp = ptt::hopper;

constexpr int NC = 3;                          // consumer warpgroups
constexpr int BM = 64 * NC, BN = 128;          // an output tile
constexpr int BK = 128;                        // k a stage (bytes = values)
constexpr int GROUP_M = 8;
constexpr int A_BYTES = BM * BK;               // the xq tile, e4m3
constexpr int BOX = BN * 128;                  // a 128-byte-wide box of
                                               // wt rows (64 f16 values)
constexpr int STAGE = A_BYTES + 2 * BOX;       // + the f16 wt tile: 56 KB
constexpr int STAGES = 4;
constexpr int NT = 128 * (NC + 1);             // + the producer
constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;
static_assert(SMEM <= 227 * 1024, "a block's shared memory");
// registers a thread after setmaxnreg (128 x REG_P + 128 NC x REG_C within
// the SM's 65536): each consumer thread holds 64 accumulators
constexpr int REG_P = 24, REG_C = 160;

// tile t of the grouped raster -> (m block, n block)
__device__ __forceinline__ void tile_coords(int t, int mt, int nt, int& bm,
                                            int& bn) {
  const int in_group = GROUP_M * nt;
  const int first_m = (t / in_group) * GROUP_M;
  const int rows = min(mt - first_m, GROUP_M);
  bm = first_m + (t % in_group) % rows;
  bn = (t % in_group) / rows;
}

// two e4m3 values (low byte first) -> two f16 values (low half first)
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}

// the f16 image of a 16-byte e4m3 chunk in the permuted k order: the low
// byte pair of each 4-byte word to the first 16 bytes, the high pair to
// the second
__device__ __forceinline__ void convert_chunk(uint4 v, uint4& lo, uint4& hi) {
  lo = make_uint4(e4m3x2_to_f16x2(v.x), e4m3x2_to_f16x2(v.y),
                  e4m3x2_to_f16x2(v.z), e4m3x2_to_f16x2(v.w));
  hi = make_uint4(e4m3x2_to_f16x2(v.x >> 16), e4m3x2_to_f16x2(v.y >> 16),
                  e4m3x2_to_f16x2(v.z >> 16), e4m3x2_to_f16x2(v.w >> 16));
}

// wt (N, K) e4m3 -> w16 (N, K) f16 with the k of every 16 permuted as the
// consumers' A fragments expect; one 16-byte chunk a thread
__global__ void __launch_bounds__(256)
weight_to_f16(const uint4* __restrict__ wt, uint4* __restrict__ w16,
              long long chunks) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= chunks) return;
  uint4 lo, hi;
  convert_chunk(wt[i], lo, hi);
  w16[2 * i] = lo;
  w16[2 * i + 1] = hi;
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
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// the two outputs of this thread at n8 block j of row half h (columns
// col0 + 8j, + 1): total * (sx * sw) (+ b), each rounded once
template <int R>
__device__ __forceinline__ float2 scaled(const float (&total)[R], int j,
                                         int h, float scale, const float* b,
                                         int gn) {
  float v0 = __fmul_rn(total[4 * j + 2 * h], scale);
  float v1 = __fmul_rn(total[4 * j + 2 * h + 1], scale);
  if (b != nullptr) {
    v0 = __fadd_rn(v0, b[gn]);
    v1 = __fadd_rn(v1, b[gn + 1]);
  }
  return make_float2(v0, v1);
}

// four consecutive outputs in one store: 8 bytes of bf16, 16 of f32
__device__ __forceinline__ void store4(__nv_bfloat16* p, float2 a, float2 c) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a.x, a.y);
  const __nv_bfloat162 y = __floats2bfloat162_rn(c.x, c.y);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&x),
                 *reinterpret_cast<const uint32_t*>(&y));
}
__device__ __forceinline__ void store4(float* p, float2 a, float2 c) {
  *reinterpret_cast<float4*>(p) = make_float4(a.x, a.y, c.x, c.y);
}

// this thread's outputs from the 64 x (R / 2) f32 sum `total` (the wgmma
// accumulator layout): total * (sx * sw) (+ b), each rounded once, cast
template <typename T, int R>
__device__ __forceinline__ void epilogue(const float (&total)[R], T* out,
                                         const float* b, float scale,
                                         int row0, int col0, int M, int N) {
  constexpr int NB = R / 4, W = 8 * NB;        // n8 blocks, tile width
  const int t4 = threadIdx.x % 4;
  if ((N & 3) == 0 && col0 - 2 * t4 + W <= N) {
    // the whole tile width lies inside N: neighbouring lanes swap one of
    // their two column pairs of n8 blocks j and j + 1, so that each stores
    // four consecutive columns at once (the stores cost the consumers
    // their tensor time; half as many of them, twice as wide)
    const bool odd = t4 & 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row0 + 8 * h;
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        const float2 a = scaled(total, j, h, scale, b, col0 + 8 * j);
        const float2 c = scaled(total, j + 1, h, scale, b, col0 + 8 * j + 8);
        const float2 send = odd ? a : c;
        const float2 got = make_float2(
            __shfl_xor_sync(0xffffffffu, send.x, 1),
            __shfl_xor_sync(0xffffffffu, send.y, 1));
        if (gm >= M) continue;
        if (!odd)            // columns 8j + 2t4 .. + 3
          store4(out + (size_t)gm * N + col0 + 8 * j, a, got);
        else                 // columns 8(j + 1) + 2(t4 - 1) .. + 3
          store4(out + (size_t)gm * N + col0 + 8 * j + 6, got, c);
      }
    }
    return;
  }
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int gn = col0 + 8 * j;
    if (gn >= N) continue;
    const bool two = gn + 1 < N;
    float b0 = 0.f, b1 = 0.f;
    if (b != nullptr) {
      b0 = b[gn];
      if (two) b1 = b[gn + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row0 + 8 * h;
      if (gm >= M) continue;
      float v0 = __fmul_rn(total[4 * j + 2 * h], scale);
      float v1 = __fmul_rn(total[4 * j + 2 * h + 1], scale);
      if (b != nullptr) {
        v0 = __fadd_rn(v0, b0);
        v1 = __fadd_rn(v1, b1);
      }
      T* o = out + (size_t)gm * N + gn;
      if (pairs && two) {
        store2<T>(o, v0, v1);
      } else {
        o[0] = ptt::from_f<T>(v0);
        if (two) o[1] = ptt::from_f<T>(v1);
      }
    }
  }
}

// the kernel: e4m3 xq converted in registers, f16 wt from TMA, f16
// wgmma m64n128k16 with A in registers, exact f32 sums
template <typename T>
__global__ void __launch_bounds__(NT, 1)
fp8_mm(const __grid_constant__ CUtensorMap map_x,
             const __grid_constant__ CUtensorMap map_w,
             const float* __restrict__ sx, const float* __restrict__ sw,
             const float* __restrict__ b, T* __restrict__ out, int M, int K,
             int N) {
  extern __shared__ unsigned char fp8_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fp8_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const int tiles = mt * nt;
  const int KT = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], NC);      // one arrival per consumer
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: TMA loads of every output tile's stages, in order ----
    hp::setmaxnreg_dec<REG_P>();
    if (threadIdx.x == 0) {
      hp::tma_prefetch_map(&map_x);
      hp::tma_prefetch_map(&map_w);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int bm, bn;
        tile_coords(t, mt, nt, bm, bn);
        for (int kb = 0; kb < KT; ++kb, ++it) {
          const int s = it % STAGES;
          unsigned char* st = smem + s * STAGE;
          hp::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          hp::mbar_arrive_expect_tx(&full[s], STAGE);
          hp::tma_load_2d(st, &map_x, &full[s], kb * BK, bm * BM);
          // the f16 wt tile: two boxes of 64 k, BN rows each
          hp::tma_load_2d(st + A_BYTES, &map_w, &full[s], kb * BK, bn * BN);
          hp::tma_load_2d(st + A_BYTES + BOX, &map_w, &full[s],
                          kb * BK + 64, bn * BN);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows [64c, 64c + 64) of a tile ----
    hp::setmaxnreg_inc<REG_C>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const float scale = __fmul_rn(sx[0], sw[0]);
    float acc[BN / 2];
    // the row this lane addresses for ldmatrix: its matrices are (rows
    // 0-7, chunk 2q), (rows 8-15, 2q), (rows 0-7, 2q + 1) and (rows 8-15,
    // 2q + 1) of the warp's 16 rows
    const int lr = c * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int lc = lane >> 4;
    // the A operand of stage `i`, converted while the wgmmas of the stage
    // before run: two register sets, taken in turn
    uint32_t pa0[8][4], pa1[8][4];
    auto load_a = [&](uint32_t (&pa)[8][4], int i) {
      const int s = i % STAGES;
      hp::mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* row = smem + s * STAGE + lr * 128;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t r[4];
        ptt::ldsm_x4(r, row + (((2 * q + lc) ^ (lr & 7)) * 16));
        // r[0], r[1]: rows g, g + 8 at k step 2q; r[2], r[3]: 2q + 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pa[2 * q + h][0] = e4m3x2_to_f16x2(r[2 * h]);
          pa[2 * q + h][1] = e4m3x2_to_f16x2(r[2 * h + 1]);
          pa[2 * q + h][2] = e4m3x2_to_f16x2(r[2 * h] >> 16);
          pa[2 * q + h][3] = e4m3x2_to_f16x2(r[2 * h + 1] >> 16);
        }
      }
    };
    // the eight wgmmas of stage `i` on A operand `pa`; the next stage's A
    // is loaded before their wait
    auto step = [&](uint32_t (&pa)[8][4], uint32_t (&next)[8][4], int i,
                    int kb) {
      const int s = i % STAGES;
      const uint64_t db =
          hp::desc_sw128(smem + s * STAGE + A_BYTES, 16, 1024);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t d =
            hp::desc_advance(db, (kk / 4) * BOX + (kk % 4) * 32);
        hp::wgmma_m64n128k16_f16_rs(acc, pa[kk], d, kb > 0 || kk > 0);
      }
      hp::wgmma_commit();
      if (kb + 1 < KT) load_a(next, i + 1);
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      if (tid == 0) hp::mbar_arrive(&empty[s]);
    };
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int bm, bn;
      tile_coords(t, mt, nt, bm, bn);
      if (KT > 0) load_a(pa0, it);
      for (int kb = 0; kb < KT; kb += 2, it += 2) {
        step(pa0, pa1, it, kb);
        if (kb + 1 < KT) step(pa1, pa0, it + 1, kb + 1);
      }
      it -= (KT & 1);         // an odd KT took one stage, not two, last
      if (KT == 0) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      }
      epilogue<T>(acc, out, b, scale, bm * BM + c * 64 + warp * 16
                  + lane / 4, bn * BN + 2 * (lane % 4), M, N);
    }
  }
}

}  // namespace

// xq (M, K) and wt (N, K) e4m3 row-major (wt is wqᵀ), K a multiple of 16,
// all three bases 16-byte aligned; w16 an (N, K) f16 scratch that wt is
// written into first; sx, sw f32 device scalars; b f32 (N) or null; out
// (M, N) in `dtype` (0 f32, 1 bf16). Returns a CUDA error code:
// cudaGetLastError() after the launches, or the refusal of the arguments
// or of the tensor maps.
extern "C" int fp8_matmul(const void* xq, const void* wt, void* w16,
                          const float* sx, const float* sw, const float* b,
                          void* out, int M, int K, int N, int dtype,
                          void* stream) {
  if (M < 0 || K < 0 || N < 0 || K % 16 != 0
      || (dtype != ptt::kF32 && dtype != ptt::kBF16)
      || ((reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(wt)
           | reinterpret_cast<uintptr_t>(w16)) & 15) != 0
      || w16 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  if (K == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap mx, mw;
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dw[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t stride[1] = {(cuuint64_t)K};
  const cuuint64_t stride16[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box_x[2] = {BK, BM};
  const cuuint32_t box_w16[2] = {64, BN};        // 64 f16 = 128 bytes
  int err = hp::make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, dx,
                         stride, box_x);
  if (err == 0)
    err = hp::make_map(&mw, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2, w16, dw,
                       stride16, box_w16);
  if (err != 0) return err;
  const long long chunks = (long long)N * K / 16;
  weight_to_f16<<<(unsigned)((chunks + 255) / 256), 256, 0, s>>>(
      static_cast<const uint4*>(wt), static_cast<uint4*>(w16), chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the attribute is per kernel: set at each one's first launch
  static bool configured[2] = {false, false};
  const bool bf16 = dtype == ptt::kBF16;
  const void* kernel = bf16
      ? reinterpret_cast<const void*>(fp8_mm<__nv_bfloat16>)
      : reinterpret_cast<const void*>(fp8_mm<float>);
  if (!configured[bf16]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[bf16] = true;
  }
  const int sms = hp::sm_count();
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  if (bf16)
    fp8_mm<__nv_bfloat16><<<grid, NT, SMEM, s>>>(
        mx, mw, sx, sw, b, static_cast<__nv_bfloat16*>(out), M, K, N);
  else
    fp8_mm<float><<<grid, NT, SMEM, s>>>(
        mx, mw, sx, sw, b, static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory a block takes, bytes
extern "C" int fp8_matmul_smem_bytes() { return SMEM; }
