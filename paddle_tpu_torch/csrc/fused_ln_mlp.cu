// Fused pre-LN residual MLP for Hopper (sm_90a), forward and backward:
//   y = (x if residual) + act(LN(x)·W1 + b1)·W2 + b2
// with act gelu (tanh form), relu or swiglu (silu(LN(x)·Wg + bg) * z),
// x (R, H), W1/Wg (H, M), W2 (M, H), all in one dtype (bf16 or f32);
// LN scale/bias and the row statistics in f32.
//
// Replaces: paddle_tpu/ops/fused_kernels.py `_fmlp_fwd_kernel` (launched
// by `_fmlp_forward`, pallas_call :292), `_fmlp_bwd_kernel` (pallas_call
// :347) and `_fmlp_bwd_dw2_kernel` (pallas_call :372) of
// `_fmlp_backward`. Same numerics: LN in f32 with lnx rounded to x's
// dtype, products of compute-dtype operands accumulated in f32, biases
// and the activation in f32, a rounded to x's dtype before ·W2,
// y = acc + b2 + x rounded once; backward with dy rounded to x's dtype,
// z recomputed in f32, dz/dzg rounded before their products, db1/dbg
// summed in f32, dW and dlnx in f32.
//
// What bounds it on an H100: at one gpt_1p3b layer (R = 8192 tokens,
// H = 2048, M = 8192) the forward is 4·R·H·M = 550 GFLOP against ~100 MB
// of operands, far above the card's ~295 operations per byte: the bound
// is the tensor-core rate (989 TFLOP/s bf16), which only wgmma reaches;
// the backward with dW2 is 8·R·H·M (1.112 ms) without the recompute of z,
// 10·R·H·M with it.
//
// What this design does about it. The TPU kernel keeps a (rows, H) LN'd
// input and a (rows, H) f32 accumulator resident across the whole M
// sweep; at H = 2048 even 64 rows make that accumulator 512 KB, past an
// SM's 228 KB. So each product is a tiled GEMM with the TPU kernel's
// elementwise work fused into its epilogue:
//   forward  (1) one pass over the rows: mu, rstd and lnx (R, H) in x's
//                dtype (a quarter of the (R, M) buffer the forward
//                writes anyway), so every GEMM operand streams raw;
//            (2) z = lnx·W1 (and zg = lnx·Wg), epilogue +b1 and the
//                activation -> a (R, M) in x's dtype;
//            (3) a·W2, epilogue +b2 +x -> y.
//   backward (1') lnx again from x, mu and rstd;
//            (4) da = dy·W2ᵀ and z = lnx·W1 (zg), epilogue
//                dz = da·act'(z) (swiglu: dz, dzg), a = act(z), and the
//                f32 column sums db1 (dbg);
//            (5) dW1 = lnxᵀ·dz (dWg = lnxᵀ·dzg);
//            (6) dlnx = dz·W1ᵀ (+ dzg·Wgᵀ) in f32;
//            (7) dW2 = aᵀ·dy (its own entry point, as the TPU's).
// z is recomputed in (4) rather than saved by the forward: saving it
// would cost an (R, M) f32 buffer per layer (268 MB at gpt_1p3b) held
// from forward to backward, while the recompute is one more GEMM over
// data the kernel reads anyway, and it keeps the forward's residuals to
// mu and rstd as the TPU kernel's are. Transposed operands (lnxᵀ, aᵀ,
// W2ᵀ, W1ᵀ) are never copied. H and M must be multiples of 64; R is any
// (ragged tiles are zero-filled on load and masked on store).
//
// The bf16 path runs on one persistent, warp-specialised TMA + wgmma
// mainloop (gemm_sm90.cuh: a producer warpgroup, two consumers, a 4-6
// stage ring), each product an epilogue of it; each operand is read as
// stored, K-major or MN-major through the wgmma transpose bits:
//   (2) lnx (K-major) · W1 (MN-major) on 128x256 tiles, its epilogue +b1
//       and the activation in f32, a rounded once to bf16; swiglu as two
//       products into two accumulators (z, zg) on 128x192 tiles;
//   (3) a (K-major) · W2 (MN-major) on 128x256 tiles, its epilogue +b2
//       and +x in f32, y rounded once;
//   (4) as two products into two accumulators on 128x192 tiles (three on
//       128x64 for swiglu: registers), its epilogue the activation's
//       backward, the dz / a stores and the column sums (per warp by
//       shuffles, over the warps in shared memory, one f32 atomic a
//       column a tile: their order, and db1's low bits, vary from run to
//       run);
//   (5), (6), (7) on 128x256 tiles, the f32 result stored from the
//       registers.
// The f32 path runs the older cp.async mainloop: a 128x128 (or 128x64)
// output tile per block of 8 warps, 32-deep K steps through a 3-stage
// ring, an FMA loop.
#include <initializer_list>

#include "gemm_sm90.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 32;                  // K step
constexpr int STAGES = 3;               // cp.async ring depth
constexpr int NT = 256;                 // 8 warps, 2 (m) x 4 (n)
constexpr int ACT_GELU = 0, ACT_RELU = 1, ACT_SWIGLU = 2;

// ---- activations (f32, closed-form derivatives) -----------------------
constexpr float kSqrt2Pi = 0.7978845608028654f;

template <int ACT>
__device__ __forceinline__ float act_f(float z) {
  if (ACT == ACT_RELU) return fmaxf(z, 0.f);
  const float u = kSqrt2Pi * (z + 0.044715f * z * z * z);
  return 0.5f * z * (1.f + tanhf(u));
}

// act_f(z) and its derivative, with gelu's tanh taken once
template <int ACT>
__device__ __forceinline__ void act_and_grad(float z, float& a, float& g) {
  if (ACT == ACT_RELU) {
    a = fmaxf(z, 0.f);
    g = z > 0.f ? 1.f : 0.f;
    return;
  }
  const float u = kSqrt2Pi * (z + 0.044715f * z * z * z);
  const float t = tanhf(u);
  const float du = kSqrt2Pi * (1.f + 0.134145f * z * z);
  a = 0.5f * z * (1.f + t);
  g = 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * du;
}

template <int ACT>
__device__ __forceinline__ float act_grad(float z) {
  float a, g;
  act_and_grad<ACT>(z, a, g);
  return g;
}

__device__ __forceinline__ float sigmoid_f(float z) {
  return 1.f / (1.f + expf(-z));
}

// ---- operands ----------------------------------------------------------
// A row-major (rows, cols) array with leading dimension ld; reads past
// rows or cols give 0 (cols are checked per 16-byte chunk: every width
// here is a multiple of 8)
template <typename T>
struct Opnd {
  const T* p;
  int ld;
  int rows;
  int cols;
};

template <typename T>
__host__ __device__ constexpr int vec() {
  return 16 / static_cast<int>(sizeof(T));
}

// shared-memory elements of one staged operand tile, stored (rows, cols)
// with a 16-byte row pad (row starts in distinct banks)
template <typename T, int ROWS, int COLS>
__host__ __device__ constexpr int tile_elems() {
  return ROWS * (COLS + vec<T>());
}

template <typename T, int BM>
__host__ __device__ constexpr int op_elems() {
  return tile_elems<T, BM, BK>() > tile_elems<T, BK, BM>()
      ? tile_elems<T, BM, BK>() : tile_elems<T, BK, BM>();
}

// dynamic shared memory of a kernel with a BM x BN output tile
template <typename T, int BM, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * (op_elems<T, BM>() + op_elems<T, BN>())
      * static_cast<int>(sizeof(T));
}

// rows [r0, r0 + TR) x cols [c0, c0 + TC) of `o` into dst, asynchronously
template <typename T, int TR, int TC>
__device__ __forceinline__ void load_tile(T* dst, const Opnd<T>& o, int r0,
                                          int c0) {
  constexpr int V = vec<T>();
  constexpr int CPR = TC / V;
  constexpr int LDD = TC + V;
  for (int ch = threadIdx.x; ch < TR * CPR; ch += NT) {
    const int r = ch / CPR, c = (ch % CPR) * V;
    const int gr = r0 + r, gc = c0 + c;
    const bool in = gr < o.rows && gc < o.cols;
    const T* src = o.p + (in ? (size_t)gr * o.ld + gc : 0);
    ptt::cp_async_16(dst + r * LDD + c, src, in ? 16 : 0);
  }
}

// ---- per-thread accumulator: BM·BN/256 floats of the output tile -------
// thread (tm, tn) = (tid / 16, tid % 16) owns rows tm + 16·ii, cols
// tn + 16·j; index i = ii · (BN / 16) + j. (f32: the bf16 products run on
// gemm_sm90.cuh.)
template <typename T, int BM, int BN>
__device__ __forceinline__ void coord(int i, int& r, int& c) {
  static_assert(sizeof(T) == 4, "the FMA mainloop is the f32 path");
  const int tid = threadIdx.x;
  r = (tid >> 4) + 16 * (i / (BN / 16));
  c = (tid & 15) + 16 * (i % (BN / 16));
}

template <typename T, int BM, int BN, bool A_K, bool B_K>
__device__ __forceinline__ void tile_product(float* acc, const T* sA,
                                             const T* sB) {
  constexpr int LDA = (A_K ? BK : BM) + vec<T>();
  constexpr int LDB = (B_K ? BK : BN) + vec<T>();
  constexpr int IM = BM / 16, JN = BN / 16;
  const int tid = threadIdx.x;
  const int tm = tid >> 4, tn = tid & 15;
#pragma unroll 2
  for (int kk = 0; kk < BK; ++kk) {
    float a[IM], b[JN];
#pragma unroll
    for (int i = 0; i < IM; ++i) {
      const int m = tm + 16 * i;
      a[i] = A_K ? sA[m * LDA + kk] : sA[kk * LDA + m];
    }
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int n = tn + 16 * j;
      b[j] = B_K ? sB[n * LDB + kk] : sB[kk * LDB + n];
    }
#pragma unroll
    for (int i = 0; i < IM; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j)
        acc[i * JN + j] = fmaf(a[i], b[j], acc[i * JN + j]);
  }
}

// acc (the BM x BN tile at (m0, n0)) += A·B over k in [0, K):
//   A_K: A stored (m, k) [else (k, m)];  B_K: B stored (n, k) [else (k, n)]
template <typename T, int BM, int BN, bool A_K, bool B_K>
__device__ void gemm(float* acc, const Opnd<T>& A, const Opnd<T>& B, int K,
                     int m0, int n0, T* smem) {
  constexpr int SA = op_elems<T, BM>();
  constexpr int STAGE = SA + op_elems<T, BN>();
  const int KT = (K + BK - 1) / BK;
  auto load = [&](int kt) {
    T* sA = smem + (kt % STAGES) * STAGE;
    T* sB = sA + SA;
    const int k0 = kt * BK;
    if (A_K) load_tile<T, BM, BK>(sA, A, m0, k0);
    else     load_tile<T, BK, BM>(sA, A, k0, m0);
    if (B_K) load_tile<T, BN, BK>(sB, B, n0, k0);
    else     load_tile<T, BK, BN>(sB, B, k0, n0);
  };
  __syncthreads();   // the ring is free (a previous product is done)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s);
    ptt::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    ptt::cp_async_wait<STAGES - 2>();   // step kt has landed
    __syncthreads();                    // ... for every thread, and step
                                        // kt - 1's slot is read
    if (kt + STAGES - 1 < KT) load(kt + STAGES - 1);
    ptt::cp_async_commit();
    const T* sA = smem + (kt % STAGES) * STAGE;
    tile_product<T, BM, BN, A_K, B_K>(acc, sA, sA + SA);
  }
  ptt::cp_async_wait<0>();
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

template <typename T>
__device__ __forceinline__ T* dyn_smem() {
  extern __shared__ __align__(16) unsigned char ptt_smem[];
  return reinterpret_cast<T*>(ptt_smem);
}

// ---- (1) row pass: mu, rstd and lnx --------------------------------------
// mode 0: no LN (mu 0, rstd 1, lnx not written: the GEMMs read x);
// mode 1: statistics from x, then lnx; mode 2: lnx from the given mu, rstd
template <typename T>
__global__ void __launch_bounds__(256)
ln_rows(const T* __restrict__ x, const float* __restrict__ s,
        const float* __restrict__ b, int R, int H, float eps, int mode,
        float* __restrict__ mu, float* __restrict__ rstd,
        T* __restrict__ lnx) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  if (mode == 0) {
    if (lane == 0) { mu[row] = 0.f; rstd[row] = 1.f; }
    return;
  }
  const T* xr = x + (size_t)row * H;
  float m, rs;
  if (mode == 1) {
    float sum = 0.f;
    for (int h = lane; h < H; h += 32) sum += ptt::to_f(xr[h]);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    m = sum / H;
    float q = 0.f;
    for (int h = lane; h < H; h += 32) {
      const float d = ptt::to_f(xr[h]) - m;
      q += d * d;
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) q += __shfl_xor_sync(0xffffffffu, q, w);
    rs = 1.f / sqrtf(q / H + eps);
    if (lane == 0) { mu[row] = m; rstd[row] = rs; }
  } else {
    m = mu[row];
    rs = rstd[row];
  }
  // (x - mu) * rstd * s + b in f32 without contraction, as the plain
  // version computes it, rounded to x's dtype
  T* lr = lnx + (size_t)row * H;
  for (int h = lane; h < H; h += 32) {
    const float y = __fmul_rn(__fsub_rn(ptt::to_f(xr[h]), m), rs);
    lr[h] = ptt::from_f<T>(__fadd_rn(__fmul_rn(y, s[h]), b[h]));
  }
}

// ---- (2) a = act(lnx·W1 + b1) --------------------------------------------
template <typename T, int ACT, int BM, int BN>
__global__ void __launch_bounds__(NT)
fmlp_up(const T* __restrict__ lnx, const T* __restrict__ w1,
        const T* __restrict__ b1, const T* __restrict__ wg,
        const T* __restrict__ bg, T* __restrict__ a, int R, int H, int M) {
  constexpr int ACC = BM * BN / NT;
  T* smem = dyn_smem<T>();
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const Opnd<T> X{lnx, H, R, H};
  float z[ACC];
  zero(z);
  gemm<T, BM, BN, true, false>(z, X, Opnd<T>{w1, M, H, M}, H, m0, n0, smem);
  float zg[ACT == ACT_SWIGLU ? ACC : 1];
  if constexpr (ACT == ACT_SWIGLU) {
    zero(zg);
    gemm<T, BM, BN, true, false>(zg, X, Opnd<T>{wg, M, H, M}, H, m0, n0,
                                 smem);
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    int r, c;
    coord<T, BM, BN>(i, r, c);
    r += m0;
    c += n0;
    if (r >= R || c >= M) continue;
    const float zf = z[i] + ptt::to_f(b1[c]);
    float av;
    if constexpr (ACT == ACT_SWIGLU) {
      const float zgf = zg[i] + ptt::to_f(bg[c]);
      av = zgf * sigmoid_f(zgf) * zf;
    } else {
      av = act_f<ACT>(zf);
    }
    a[(size_t)r * M + c] = ptt::from_f<T>(av);
  }
}

// ---- (3) y = a·W2 + b2 (+ x) ----------------------------------------------
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(NT)
fmlp_down(const T* __restrict__ a, const T* __restrict__ w2,
          const T* __restrict__ b2, const T* __restrict__ x,
          T* __restrict__ y, int R, int H, int M, int residual) {
  constexpr int ACC = BM * BN / NT;
  T* smem = dyn_smem<T>();
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float acc[ACC];
  zero(acc);
  gemm<T, BM, BN, true, false>(acc, Opnd<T>{a, M, R, M},
                               Opnd<T>{w2, H, M, H}, M, m0, n0, smem);
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    int r, c;
    coord<T, BM, BN>(i, r, c);
    r += m0;
    c += n0;
    if (r >= R || c >= H) continue;
    float out = acc[i] + ptt::to_f(b2[c]);
    if (residual) out += ptt::to_f(x[(size_t)r * H + c]);
    y[(size_t)r * H + c] = ptt::from_f<T>(out);
  }
}

// col[c] += the sum over this thread's rows of v at column c (the f32
// FMA path; one shared-memory add per element)
template <typename T, int BM, int BN>
__device__ __forceinline__ void col_sums(const float* v, float* col) {
  constexpr int ACC = BM * BN / NT;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    int r, c;
    coord<T, BM, BN>(i, r, c);
    atomicAdd(&col[c], v[i]);
  }
}

// ---- (4) dz (dzg), a and db1 (dbg); f32 -----------------------------------
template <typename T, int ACT, int BM, int BN>
__global__ void __launch_bounds__(NT)
fmlp_act_bwd(const T* __restrict__ lnx, const T* __restrict__ w1,
             const T* __restrict__ b1, const T* __restrict__ w2,
             const T* __restrict__ wg, const T* __restrict__ bg,
             const T* __restrict__ dy, T* __restrict__ dz,
             T* __restrict__ dzg, T* __restrict__ a,
             float* __restrict__ db1, float* __restrict__ dbg, int R, int H,
             int M) {
  constexpr int ACC = BM * BN / NT;
  T* smem = dyn_smem<T>();
  __shared__ float col1[BN], colg[BN];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  for (int c = threadIdx.x; c < BN; c += NT) col1[c] = colg[c] = 0.f;
  const Opnd<T> X{lnx, H, R, H};
  float da[ACC], z[ACC];
  zero(da);
  zero(z);
  // da = dy·W2ᵀ: W2 (M, H) is B stored (n, k)
  gemm<T, BM, BN, true, true>(da, Opnd<T>{dy, H, R, H},
                              Opnd<T>{w2, H, M, H}, H, m0, n0, smem);
  gemm<T, BM, BN, true, false>(z, X, Opnd<T>{w1, M, H, M}, H, m0, n0, smem);
  float zg[ACT == ACT_SWIGLU ? ACC : 1];
  if constexpr (ACT == ACT_SWIGLU) {
    zero(zg);
    gemm<T, BM, BN, true, false>(zg, X, Opnd<T>{wg, M, H, M}, H, m0, n0,
                                 smem);
  }
  // the epilogue leaves dz in da (and dzg in zg), 0 outside the matrix,
  // for the column sums below
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    int r, c;
    coord<T, BM, BN>(i, r, c);
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= R || gc >= M) {
      da[i] = 0.f;
      if constexpr (ACT == ACT_SWIGLU) zg[i] = 0.f;
      continue;
    }
    const float zf = z[i] + ptt::to_f(b1[gc]);
    float av;
    if constexpr (ACT == ACT_SWIGLU) {
      const float zgf = zg[i] + ptt::to_f(bg[gc]);
      const float s = sigmoid_f(zgf);
      const float sg = zgf * s;
      zg[i] = da[i] * zf * (s * (1.f + zgf * (1.f - s)));
      da[i] *= sg;
      av = sg * zf;
      dzg[(size_t)gr * M + gc] = ptt::from_f<T>(zg[i]);
    } else {
      av = act_f<ACT>(zf);
      da[i] *= act_grad<ACT>(zf);
    }
    dz[(size_t)gr * M + gc] = ptt::from_f<T>(da[i]);
    a[(size_t)gr * M + gc] = ptt::from_f<T>(av);
  }
  col_sums<T, BM, BN>(da, col1);
  if constexpr (ACT == ACT_SWIGLU) col_sums<T, BM, BN>(zg, colg);
  __syncthreads();
  for (int c = threadIdx.x; c < BN; c += NT) {
    if (n0 + c >= M) continue;
    atomicAdd(db1 + n0 + c, col1[c]);
    if (ACT == ACT_SWIGLU) atomicAdd(dbg + n0 + c, colg[c]);
  }
}

// ---- (5), (7) C0 (C1) = Aᵀ·B0 (Aᵀ·B1) over the R rows, f32 out; f32 ------
// A (R, MD), B (R, N); C (MD, N)
template <typename T, bool DUAL, int BM, int BN>
__global__ void __launch_bounds__(NT)
fmlp_wgrad(const T* __restrict__ A, const T* __restrict__ B0,
           const T* __restrict__ B1, float* __restrict__ C0,
           float* __restrict__ C1, int R, int MD, int N) {
  constexpr int ACC = BM * BN / NT;
  T* smem = dyn_smem<T>();
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const Opnd<T> AT{A, MD, R, MD};
  float acc[ACC];
#pragma unroll
  for (int p = 0; p < (DUAL ? 2 : 1); ++p) {
    zero(acc);
    gemm<T, BM, BN, false, false>(acc, AT, Opnd<T>{p ? B1 : B0, N, R, N},
                                  R, m0, n0, smem);
    float* C = p ? C1 : C0;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      int r, c;
      coord<T, BM, BN>(i, r, c);
      if (m0 + r < MD && n0 + c < N)
        C[(size_t)(m0 + r) * N + n0 + c] = acc[i];
    }
  }
}

// ---- (6) dlnx = dz·W1ᵀ (+ dzg·Wgᵀ), f32 out; f32 --------------------------
template <typename T, bool DUAL, int BM, int BN>
__global__ void __launch_bounds__(NT)
fmlp_dx(const T* __restrict__ dz, const T* __restrict__ w1,
        const T* __restrict__ dzg, const T* __restrict__ wg,
        float* __restrict__ dlnx, int R, int H, int M) {
  constexpr int ACC = BM * BN / NT;
  T* smem = dyn_smem<T>();
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float acc[ACC];
  zero(acc);
  // W1 (H, M) is B stored (n, k)
  gemm<T, BM, BN, true, true>(acc, Opnd<T>{dz, M, R, M},
                              Opnd<T>{w1, M, H, M}, M, m0, n0, smem);
  if constexpr (DUAL)
    gemm<T, BM, BN, true, true>(acc, Opnd<T>{dzg, M, R, M},
                                Opnd<T>{wg, M, H, M}, M, m0, n0, smem);
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    int r, c;
    coord<T, BM, BN>(i, r, c);
    if (m0 + r < R && n0 + c < H)
      dlnx[(size_t)(m0 + r) * H + n0 + c] = acc[i];
  }
}

// ---- host-side launchers -------------------------------------------------
constexpr int TM = 128;                 // block tile rows
constexpr int TN = 128;                 // block tile cols (64 for the
                                        // f32 backward's (4): registers)

dim3 grid_of(int rows, int cols, int bm, int bn) {
  return dim3((cols + bn - 1) / bn, (rows + bm - 1) / bm);
}

// launch with BYTES of dynamic shared memory (above 48 KB it must be
// allowed per kernel first); returns the CUDA error
template <typename... KArgs, typename... Args>
int launch(void (*kern)(KArgs...), dim3 grid, int bytes, cudaStream_t s,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, NT, bytes, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ln_launch(const T* x, const float* lns, const float* lnb, int R, int H,
              float eps, int mode, float* mu, float* rstd, T* lnx,
              cudaStream_t s) {
  ln_rows<T><<<(R + 7) / 8, 256, 0, s>>>(x, lns, lnb, R, H, eps, mode, mu,
                                         rstd, lnx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward_impl(const void* xv, const float* lns, const float* lnb,
                 const void* w1v, const void* b1v, const void* w2v,
                 const void* b2v, const void* wgv, const void* bgv, void* y,
                 float* mu, float* rstd, void* lnxv, void* av, int R, int H,
                 int M, float eps, int act, int residual, int has_ln,
                 cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* lnx = static_cast<T*>(lnxv);
  int err = ln_launch<T>(x, lns, lnb, R, H, eps, has_ln ? 1 : 0, mu, rstd,
                         lnx, s);
  if (err) return err;
  const T* h = has_ln ? lnx : x;
  const T *w1 = static_cast<const T*>(w1v), *b1 = static_cast<const T*>(b1v);
  const T *wg = static_cast<const T*>(wgv), *bg = static_cast<const T*>(bgv);
  T* a = static_cast<T*>(av);
  constexpr int SM = smem_bytes<T, TM, TN>();
  const dim3 up = grid_of(R, M, TM, TN);
  if (act == ACT_GELU)
    err = launch(fmlp_up<T, ACT_GELU, TM, TN>, up, SM, s, h, w1, b1, wg, bg,
                 a, R, H, M);
  else if (act == ACT_RELU)
    err = launch(fmlp_up<T, ACT_RELU, TM, TN>, up, SM, s, h, w1, b1, wg, bg,
                 a, R, H, M);
  else
    err = launch(fmlp_up<T, ACT_SWIGLU, TM, TN>, up, SM, s, h, w1, b1, wg,
                 bg, a, R, H, M);
  if (err) return err;
  return launch(fmlp_down<T, TM, TN>, grid_of(R, H, TM, TN), SM, s,
                static_cast<const T*>(a), static_cast<const T*>(w2v),
                static_cast<const T*>(b2v), x, static_cast<T*>(y), R, H, M,
                residual);
}

template <typename T>
int backward_impl(const void* xv, const float* lns, const float* lnb,
                  const void* w1v, const void* b1v, const void* w2v,
                  const void* wgv, const void* bgv, float* mu, float* rstd,
                  const void* dyv, void* lnxv, void* dzv, void* dzgv,
                  void* av, float* db1, float* dbg, float* dw1, float* dwg,
                  float* dlnx, int R, int H, int M, int act, int has_ln,
                  cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  const T *w1 = static_cast<const T*>(w1v), *b1 = static_cast<const T*>(b1v);
  const T* w2 = static_cast<const T*>(w2v);
  const T *wg = static_cast<const T*>(wgv), *bg = static_cast<const T*>(bgv);
  T *dz = static_cast<T*>(dzv), *dzg = static_cast<T*>(dzgv);
  T* a = static_cast<T*>(av);
  T* lnx = static_cast<T*>(lnxv);
  const bool swiglu = act == ACT_SWIGLU;
  int err = 0;
  if (has_ln && R > 0)
    err = ln_launch<T>(x, lns, lnb, R, H, 0.f, 2, mu, rstd, lnx, s);
  if (err) return err;
  const T* h = has_ln ? lnx : x;
  constexpr int SM = smem_bytes<T, TM, TN>();
  constexpr int SM64 = smem_bytes<T, TM, 64>();
  if (R > 0) {
    const dim3 agrid = grid_of(R, M, TM, 64);
    if (act == ACT_GELU)
      err = launch(fmlp_act_bwd<T, ACT_GELU, TM, 64>, agrid, SM64, s, h, w1,
                   b1, w2, wg, bg, dy, dz, dzg, a, db1, dbg, R, H, M);
    else if (act == ACT_RELU)
      err = launch(fmlp_act_bwd<T, ACT_RELU, TM, 64>, agrid, SM64, s, h, w1,
                   b1, w2, wg, bg, dy, dz, dzg, a, db1, dbg, R, H, M);
    else
      err = launch(fmlp_act_bwd<T, ACT_SWIGLU, TM, 64>,
                   grid_of(R, M, TM, 64), SM64, s, h, w1, b1, w2, wg, bg, dy,
                   dz, dzg, a, db1, dbg, R, H, M);
    if (err) return err;
  }
  const dim3 wgrid = grid_of(H, M, TM, TN);
  if (swiglu)
    err = launch(fmlp_wgrad<T, true, TM, TN>, wgrid, SM, s, h,
                 static_cast<const T*>(dz), static_cast<const T*>(dzg), dw1,
                 dwg, R, H, M);
  else
    err = launch(fmlp_wgrad<T, false, TM, TN>, wgrid, SM, s, h,
                 static_cast<const T*>(dz), static_cast<const T*>(dzg), dw1,
                 dwg, R, H, M);
  if (err || R == 0) return err;
  const dim3 xgrid = grid_of(R, H, TM, TN);
  if (swiglu)
    return launch(fmlp_dx<T, true, TM, TN>, xgrid, SM, s,
                  static_cast<const T*>(dz), w1, static_cast<const T*>(dzg),
                  wg, dlnx, R, H, M);
  return launch(fmlp_dx<T, false, TM, TN>, xgrid, SM, s,
                static_cast<const T*>(dz), w1, static_cast<const T*>(dzg), wg,
                dlnx, R, H, M);
}

template <typename T>
int dw2_impl(const void* a, const void* dy, float* dw2, int R, int H, int M,
             cudaStream_t s) {
  return launch(fmlp_wgrad<T, false, TM, TN>, grid_of(M, H, TM, TN),
                smem_bytes<T, TM, TN>(), s, static_cast<const T*>(a),
                static_cast<const T*>(dy), static_cast<const T*>(nullptr),
                dw2, static_cast<float*>(nullptr), R, M, H);
}

// ---- the bf16 backward on the TMA + wgmma mainloop (gemm_sm90.cuh) -------
namespace g90 = ptt::gemm90;
namespace hp = ptt::hopper;

// (5), (6), (7): the f32 product stored from the registers, (Mdim, Ndim)
// row-major, masked at the ragged edges (Ndim is even: pairs are whole)
struct EpiStoreF32 {
  float* c;

  template <int BN, int NACC>
  __device__ __forceinline__ void apply(
      float (&acc)[NACC][g90::AccShape<BN>::NH][g90::AccShape<BN>::HW],
      int m0, int n0, int Mdim, int Ndim, int cw, int tid, float*) const {
#pragma unroll
    for (int h = 0; h < g90::AccShape<BN>::NH; ++h)
#pragma unroll
      for (int i = 0; i < g90::AccShape<BN>::HW; i += 2) {
        int r, col;
        g90::acc_coord(cw, tid, h, i, r, col);
        r += m0;
        col += n0;
        if (r < Mdim && col < Ndim)
          *reinterpret_cast<float2*>(c + (size_t)r * Ndim + col) =
              make_float2(acc[0][h][i], acc[0][h][i + 1]);
      }
  }
};

// (4): acc[0] = da = dy·W2ᵀ, acc[1] = z = lnx·W1 (acc[2] = zg = lnx·Wg)
// -> dz (dzg) and a in bf16, and the f32 column sums of dz (dzg) added
// into db1 (dbg): per warp over its 16 rows by shuffles, over the four
// warps in shared memory, one atomic a column a consumer
template <int ACT>
struct EpiActBwd {
  const bf16* b1;
  const bf16* bg;
  bf16* dz;
  bf16* dzg;
  bf16* a;
  float* db1;
  float* dbg;

  template <int BN, int NACC>
  __device__ __forceinline__ void apply(
      float (&acc)[NACC][1][BN / 2], int m0, int n0, int R, int M, int cw,
      int tid, float* scratch) const {
    constexpr bool SW = ACT == ACT_SWIGLU;
    const int warp = tid / 32, lane = tid % 32;
    // a thread's elements come in groups of 8 columns (jb): the same two
    // columns (a pair) in rows r and r + 8, so each bias pair is read
    // once for both rows
#pragma unroll
    for (int jb = 0; jb < BN / 8; ++jb) {
      int r, col;
      g90::acc_coord(cw, tid, 0, 4 * jb, r, col);
      r += m0;
      col += n0;
      const bool cin = col < M;               // M even: the pair is whole
      float2 bb1 = make_float2(0.f, 0.f), bbg = bb1;
      if (cin) {
        bb1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b1 + col));
        if constexpr (SW)
          bbg = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bg + col));
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 4 * jb + 2 * rr;
        const bool in = cin && r + 8 * rr < R;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float da = acc[0][0][i + e];
          float dzv = 0.f, av = 0.f;
          if (in) {
            const float zf = acc[1][0][i + e] + (e ? bb1.y : bb1.x);
            if constexpr (SW) {
              const float zgf = acc[2][0][i + e] + (e ? bbg.y : bbg.x);
              const float sgm = sigmoid_f(zgf);
              const float sg = zgf * sgm;
              acc[2][0][i + e] = da * zf * (sgm * (1.f + zgf * (1.f - sgm)));
              dzv = da * sg;
              av = sg * zf;
            } else {
              float g;
              act_and_grad<ACT>(zf, av, g);
              dzv = da * g;
            }
          } else if constexpr (SW) {
            acc[2][0][i + e] = 0.f;
          }
          acc[0][0][i + e] = dzv;
          acc[1][0][i + e] = av;
        }
        if (in) {
          const size_t o = (size_t)(r + 8 * rr) * M + col;
          *reinterpret_cast<__nv_bfloat162*>(dz + o) =
              __floats2bfloat162_rn(acc[0][0][i], acc[0][0][i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(a + o) =
              __floats2bfloat162_rn(acc[1][0][i], acc[1][0][i + 1]);
          if constexpr (SW)
            *reinterpret_cast<__nv_bfloat162*>(dzg + o) =
                __floats2bfloat162_rn(acc[2][0][i], acc[2][0][i + 1]);
        }
      }
    }
    // column sums: [warp][column] per consumer, dz's then dzg's
    float* cs = scratch + cw * 1024;
#pragma unroll
    for (int jb = 0; jb < BN / 8; ++jb)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1)
#pragma unroll
        for (int v = 0; v < (SW ? 2 : 1); ++v) {
          const float* d = acc[v == 0 ? 0 : NACC - 1][0];
          float t = d[4 * jb + e1] + d[4 * jb + 2 + e1];
          t += __shfl_xor_sync(0xffffffffu, t, 4);
          t += __shfl_xor_sync(0xffffffffu, t, 8);
          t += __shfl_xor_sync(0xffffffffu, t, 16);
          if (lane < 4)
            cs[(v * 4 + warp) * BN + 8 * jb + 2 * lane + e1] = t;
        }
    hp::named_bar_sync(2 + cw, 128);
    for (int col = tid; col < BN; col += 128) {
      if (n0 + col >= M) continue;
      atomicAdd(db1 + n0 + col, cs[col] + cs[BN + col] + cs[2 * BN + col]
                                    + cs[3 * BN + col]);
      if constexpr (SW)
        atomicAdd(dbg + n0 + col, cs[4 * BN + col] + cs[5 * BN + col]
                                      + cs[6 * BN + col] + cs[7 * BN + col]);
    }
    hp::named_bar_sync(2 + cw, 128);   // cs is free for the next tile
  }
};

// (2): acc[0] = z = lnx·W1 (acc[1] = zg = lnx·Wg) -> a = act(z + b1)
// (swiglu: silu(zg + bg) · (z + b1)) in f32, stored once as bf16; each
// bias pair read once for the thread's two rows
template <int ACT>
struct EpiUp {
  const bf16* b1;
  const bf16* bg;
  bf16* a;

  template <int BN, int NACC>
  __device__ __forceinline__ void apply(
      float (&acc)[NACC][g90::AccShape<BN>::NH][g90::AccShape<BN>::HW],
      int m0, int n0, int R, int M, int cw, int tid, float*) const {
#pragma unroll
    for (int h = 0; h < g90::AccShape<BN>::NH; ++h)
#pragma unroll
      for (int jb = 0; jb < g90::AccShape<BN>::HW / 4; ++jb) {
        int r, col;
        g90::acc_coord(cw, tid, h, 4 * jb, r, col);
        r += m0;
        col += n0;
        if (col >= M) continue;              // M even: the pair is whole
        const float2 bb1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b1 + col));
        float2 bbg = bb1;
        if constexpr (ACT == ACT_SWIGLU)
          bbg = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bg + col));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if (r + 8 * rr >= R) continue;
          const int i = 4 * jb + 2 * rr;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float zf = acc[0][h][i + e] + (e ? bb1.y : bb1.x);
            if constexpr (ACT == ACT_SWIGLU) {
              const float zgf = acc[1][h][i + e] + (e ? bbg.y : bbg.x);
              v[e] = zgf * sigmoid_f(zgf) * zf;
            } else {
              v[e] = act_f<ACT>(zf);
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(a + (size_t)(r + 8 * rr) * M
                                             + col) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
  }
};

// (3): acc[0] = a·W2 -> y = acc + b2 (+ x) in f32, stored once as bf16
struct EpiDown {
  const bf16* b2;
  const bf16* x;
  bf16* y;
  int residual;

  template <int BN, int NACC>
  __device__ __forceinline__ void apply(
      float (&acc)[NACC][g90::AccShape<BN>::NH][g90::AccShape<BN>::HW],
      int m0, int n0, int R, int H, int cw, int tid, float*) const {
#pragma unroll
    for (int h = 0; h < g90::AccShape<BN>::NH; ++h)
#pragma unroll
      for (int jb = 0; jb < g90::AccShape<BN>::HW / 4; ++jb) {
        int r, col;
        g90::acc_coord(cw, tid, h, 4 * jb, r, col);
        r += m0;
        col += n0;
        if (col >= H) continue;              // H even: the pair is whole
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b2 + col));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if (r + 8 * rr >= R) continue;
          const int i = 4 * jb + 2 * rr;
          const size_t o = (size_t)(r + 8 * rr) * H + col;
          float v0 = acc[0][h][i] + bb.x, v1 = acc[0][h][i + 1] + bb.y;
          if (residual) {
            const float2 xr = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(x + o));
            v0 += xr.x;
            v1 += xr.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(y + o) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
  }
};

using KK = g90::Prod<0, 0, 0>;   // A and B K-major, into acc 0
using NoP = g90::NoProd;

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

// (4) for one activation: (4a) da = dy·W2ᵀ (W2 (M, H) is B stored (N, K)),
// (4b) z = lnx·W1 (W1 (H, M) is B stored (K, N)), (4c) zg = lnx·Wg
template <int ACT>
int act_bwd_wgmma(const bf16* h, const bf16* w1, const bf16* b1,
                  const bf16* w2, const bf16* wg, const bf16* bg,
                  const bf16* dy, bf16* dz, bf16* dzg, bf16* a, float* db1,
                  float* dbg, int R, int H, int M, cudaStream_t s) {
  constexpr int BN = ACT == ACT_SWIGLU ? 64 : 192;
  using P1 = g90::Prod<0, 1, 1>;
  g90::Maps maps{};
  int err = g90::map_prod<BN, KK>(maps, 0, dy, w2, R, M, H);
  if (err == 0) err = g90::map_prod<BN, P1>(maps, 1, h, w1, R, M, H);
  const EpiActBwd<ACT> epi{b1, bg, dz, dzg, a, db1, dbg};
  if constexpr (ACT == ACT_SWIGLU) {
    using P2 = g90::Prod<0, 1, 2>;
    if (err == 0) err = g90::map_prod<BN, P2>(maps, 2, h, wg, R, M, H);
    if (err) return err;
    return g90::launch<BN, 3, KK, P1, P2>(maps, epi, R, M, H, s);
  } else {
    if (err) return err;
    return g90::launch<BN, 2, KK, P1, NoP>(maps, epi, R, M, H, s);
  }
}

// C (Md, Nd) f32 = Aᵀ·B over the R rows of A (R, Md) and B (R, Nd): both
// MN-major ((5) dW1 = lnxᵀ·dz, dWg = lnxᵀ·dzg; (7) dW2 = aᵀ·dy)
int wgrad_wgmma(const bf16* A, const bf16* B, float* C, int R, int Md,
                int Nd, cudaStream_t s) {
  if (R == 0)   // no rows: the gradient is zero
    return static_cast<int>(
        cudaMemsetAsync(C, 0, (size_t)Md * Nd * sizeof(float), s));
  using TT = g90::Prod<1, 1, 0>;
  g90::Maps maps{};
  const int err = g90::map_prod<256, TT>(maps, 0, A, B, Md, Nd, R);
  if (err) return err;
  return g90::launch<256, 1, TT, NoP, NoP>(maps, EpiStoreF32{C}, Md, Nd, R,
                                           s);
}

// (2) for one activation: z = lnx·W1 (W1 (H, M) is B stored (K, N)),
// zg = lnx·Wg for swiglu
template <int ACT>
int up_wgmma(const bf16* h, const bf16* w1, const bf16* b1, const bf16* wg,
             const bf16* bg, bf16* a, int R, int H, int M, cudaStream_t s) {
  using KT = g90::Prod<0, 1, 0>;
  const EpiUp<ACT> epi{b1, bg, a};
  g90::Maps maps{};
  if constexpr (ACT == ACT_SWIGLU) {
    using KT1 = g90::Prod<0, 1, 1>;
    int err = g90::map_prod<192, KT>(maps, 0, h, w1, R, M, H);
    if (err == 0) err = g90::map_prod<192, KT1>(maps, 1, h, wg, R, M, H);
    if (err) return err;
    return g90::launch<192, 2, KT, KT1, NoP>(maps, epi, R, M, H, s);
  } else {
    const int err = g90::map_prod<256, KT>(maps, 0, h, w1, R, M, H);
    if (err) return err;
    return g90::launch<256, 1, KT, NoP, NoP>(maps, epi, R, M, H, s);
  }
}

// the bf16 forward: (1) the row pass, (2) a = act(lnx·W1 + b1),
// (3) y = a·W2 + b2 (+ x), W2 (M, H) being B stored (K, N)
int forward_wgmma(const void* xv, const float* lns, const float* lnb,
                  const void* w1v, const void* b1v, const void* w2v,
                  const void* b2v, const void* wgv, const void* bgv,
                  void* yv, float* mu, float* rstd, void* lnxv, void* av,
                  int R, int H, int M, float eps, int act, int residual,
                  int has_ln, cudaStream_t s) {
  const bf16* x = static_cast<const bf16*>(xv);
  const bf16* w1 = static_cast<const bf16*>(w1v);
  const bf16* b1 = static_cast<const bf16*>(b1v);
  const bf16* w2 = static_cast<const bf16*>(w2v);
  const bf16* b2 = static_cast<const bf16*>(b2v);
  const bf16* wg = static_cast<const bf16*>(wgv);
  const bf16* bg = static_cast<const bf16*>(bgv);
  bf16* lnx = static_cast<bf16*>(lnxv);
  bf16* a = static_cast<bf16*>(av);
  if (!aligned16({x, w1, b1, w2, b2, wg, bg, yv, lnx, a}))
    return static_cast<int>(cudaErrorInvalidValue);   // TMA's base rule
  int err = ln_launch<bf16>(x, lns, lnb, R, H, eps, has_ln ? 1 : 0, mu,
                            rstd, lnx, s);
  if (err) return err;
  const bf16* h = has_ln ? lnx : x;
  if (act == ACT_GELU)
    err = up_wgmma<ACT_GELU>(h, w1, b1, wg, bg, a, R, H, M, s);
  else if (act == ACT_RELU)
    err = up_wgmma<ACT_RELU>(h, w1, b1, wg, bg, a, R, H, M, s);
  else
    err = up_wgmma<ACT_SWIGLU>(h, w1, b1, wg, bg, a, R, H, M, s);
  if (err) return err;
  using KT = g90::Prod<0, 1, 0>;
  g90::Maps maps{};
  err = g90::map_prod<256, KT>(maps, 0, a, w2, R, H, M);
  if (err) return err;
  return g90::launch<256, 1, KT, NoP, NoP>(
      maps, EpiDown{b2, x, static_cast<bf16*>(yv), residual}, R, H, M, s);
}

int backward_wgmma(const void* xv, const float* lns, const float* lnb,
                   const void* w1v, const void* b1v, const void* w2v,
                   const void* wgv, const void* bgv, float* mu, float* rstd,
                   const void* dyv, void* lnxv, void* dzv, void* dzgv,
                   void* av, float* db1, float* dbg, float* dw1, float* dwg,
                   float* dlnx, int R, int H, int M, int act, int has_ln,
                   cudaStream_t s) {
  const bf16* x = static_cast<const bf16*>(xv);
  const bf16* dy = static_cast<const bf16*>(dyv);
  const bf16 *w1 = static_cast<const bf16*>(w1v);
  const bf16 *b1 = static_cast<const bf16*>(b1v);
  const bf16* w2 = static_cast<const bf16*>(w2v);
  const bf16 *wg = static_cast<const bf16*>(wgv);
  const bf16 *bg = static_cast<const bf16*>(bgv);
  bf16 *dz = static_cast<bf16*>(dzv), *dzg = static_cast<bf16*>(dzgv);
  bf16* a = static_cast<bf16*>(av);
  bf16* lnx = static_cast<bf16*>(lnxv);
  const bool swiglu = act == ACT_SWIGLU;
  const bf16* h = has_ln ? lnx : x;
  if (!aligned16({x, dy, w1, b1, w2, wg, bg, dz, dzg, a, lnx}))
    return static_cast<int>(cudaErrorInvalidValue);   // TMA's base rule
  int err = 0;
  if (has_ln && R > 0)
    err = ln_launch<bf16>(x, lns, lnb, R, H, 0.f, 2, mu, rstd, lnx, s);
  if (err) return err;
  if (R > 0) {
    if (act == ACT_GELU)
      err = act_bwd_wgmma<ACT_GELU>(h, w1, b1, w2, wg, bg, dy, dz, dzg, a,
                                    db1, dbg, R, H, M, s);
    else if (act == ACT_RELU)
      err = act_bwd_wgmma<ACT_RELU>(h, w1, b1, w2, wg, bg, dy, dz, dzg, a,
                                    db1, dbg, R, H, M, s);
    else
      err = act_bwd_wgmma<ACT_SWIGLU>(h, w1, b1, w2, wg, bg, dy, dz, dzg, a,
                                      db1, dbg, R, H, M, s);
    if (err) return err;
  }
  err = wgrad_wgmma(h, dz, dw1, R, H, M, s);
  if (err == 0 && swiglu) err = wgrad_wgmma(h, dzg, dwg, R, H, M, s);
  if (err || R == 0) return err;
  // (6) dlnx = dz·W1ᵀ (+ dzg·Wgᵀ): W1 (H, M) is B stored (N, K)
  g90::Maps maps{};
  err = g90::map_prod<256, KK>(maps, 0, dz, w1, R, H, M);
  if (swiglu) {
    if (err == 0) err = g90::map_prod<256, KK>(maps, 1, dzg, wg, R, H, M);
    if (err) return err;
    return g90::launch<256, 1, KK, KK, NoP>(maps, EpiStoreF32{dlnx}, R, H,
                                            M, s);
  }
  if (err) return err;
  return g90::launch<256, 1, KK, NoP, NoP>(maps, EpiStoreF32{dlnx}, R, H, M,
                                           s);
}

bool shapes_ok(int R, int H, int M) {
  return R >= 0 && H > 0 && M > 0 && H % 64 == 0 && M % 64 == 0;
}

}  // namespace

// Forward: y (R, H), mu/rstd (R) f32; lnx (R, H) and a (R, M) are
// scratch in x's dtype. lns/lnb (H) f32; wg/bg only for act 2 (swiglu).
// act: 0 gelu, 1 relu, 2 swiglu. bf16 runs the TMA/wgmma kernels (every
// bf16 pointer 16-byte aligned, else cudaErrorInvalidValue), f32 the FMA
// kernels. Three launches; returns the first CUDA error.
extern "C" int fmlp_forward(const void* x, const float* lns, const float* lnb,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* wg, const void* bg,
                            void* y, float* mu, float* rstd, void* lnx,
                            void* a, int R, int H, int M, float eps, int act,
                            int residual, int has_ln, int dtype,
                            void* stream) {
  if (!shapes_ok(R, H, M) || act < 0 || act > 2 || (act == 2 && !wg))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16)
    return forward_wgmma(x, lns, lnb, w1, b1, w2, b2, wg, bg, y, mu, rstd,
                         lnx, a, R, H, M, eps, act, residual, has_ln, s);
  if (dtype == ptt::kF32)
    return forward_impl<float>(x, lns, lnb, w1, b1, w2, b2, wg, bg, y, mu,
                               rstd, lnx, a, R, H, M, eps, act, residual,
                               has_ln, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Main backward: dz, a (and dzg) (R, M) in x's dtype; db1 (and dbg) (M)
// f32, ZEROED by the caller (the kernel adds into them); dw1 (and dwg)
// (H, M) f32; dlnx (R, H) f32; lnx (R, H) scratch in x's dtype. dy
// (R, H) already in x's dtype. bf16 runs the TMA/wgmma kernels (every
// bf16 pointer 16-byte aligned, else cudaErrorInvalidValue), f32 the FMA
// kernels. Four launches (five for swiglu in bf16: dWg is its own);
// returns the first CUDA error.
extern "C" int fmlp_backward(const void* x, const float* lns,
                             const float* lnb, const void* w1, const void* b1,
                             const void* w2, const void* wg, const void* bg,
                             float* mu, float* rstd, const void* dy,
                             void* lnx, void* dz, void* dzg, void* a,
                             float* db1, float* dbg, float* dw1, float* dwg,
                             float* dlnx, int R, int H, int M, int act,
                             int has_ln, int dtype, void* stream) {
  if (!shapes_ok(R, H, M) || act < 0 || act > 2
      || (act == 2 && !(wg && dzg && dbg && dwg)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16)
    return backward_wgmma(x, lns, lnb, w1, b1, w2, wg, bg, mu, rstd, dy, lnx,
                          dz, dzg, a, db1, dbg, dw1, dwg, dlnx, R, H, M, act,
                          has_ln, s);
  if (dtype == ptt::kF32)
    return backward_impl<float>(x, lns, lnb, w1, b1, w2, wg, bg, mu, rstd,
                                dy, lnx, dz, dzg, a, db1, dbg, dw1, dwg, dlnx,
                                R, H, M, act, has_ln, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dW2 = aᵀ·dy (M, H) f32 from the main backward's a (R, M) and dy (R, H);
// bf16 on the TMA/wgmma mainloop (16-byte-aligned a and dy), f32 on FMA.
extern "C" int fmlp_backward_dw2(const void* a, const void* dy, float* dw2,
                                 int R, int H, int M, int dtype,
                                 void* stream) {
  if (!shapes_ok(R, H, M)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16) {
    if (!aligned16({a, dy})) return static_cast<int>(cudaErrorInvalidValue);
    return wgrad_wgmma(static_cast<const bf16*>(a),
                       static_cast<const bf16*>(dy), dw2, R, M, H, s);
  }
  if (dtype == ptt::kF32) return dw2_impl<float>(a, dy, dw2, R, H, M, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory a block of the TMA/wgmma GEMM takes with a
// 128 x BN output tile (BN 64, 192 or 256: the tiles it runs), in bytes
extern "C" int fmlp_gemm_smem_bytes(int BN) {
  return BN == 64 ? g90::smem_bytes<64>()
       : BN == 192 ? g90::smem_bytes<192>() : g90::smem_bytes<256>();
}
