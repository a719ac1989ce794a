// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of causal or
// non-causal softmax(q·kᵀ·scale)·v over (B·H, S, D) tensors, from the
// forward's lse and delta = rowsum(dO·O); the (Sq, Sk) probability and
// score-gradient matrices never reach device memory.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_bwd_kernel` (launched by
// `_flash_backward`, pallas_call at :289). Same math and roundings: f32
// scores, p = exp(s - lse) (zero where masked, causal mask
// q_pos + off >= k_pos with off = Sk - Sq), p rounded to dO's dtype
// before dV += pᵀ·dO, ds = p·(dp - delta)·scale rounded to q's dtype
// before dK += dsᵀ·q and dQ += ds·k, f32 accumulation throughout.
//
// What bounds it on an H100: five products of 2·D operations for every
// live (q, k) pair (the two score recomputations s and dp, and dV, dK,
// dQ) against ~7·S·D bytes per head, so at training lengths (S = 2048,
// D = 128) the bound is arithmetic (tensor-core rate, 989 TFLOP/s bf16).
//
// What this design does about it. It is not a copy of the TPU grid,
// whose sequential q sweep carried dK/dV in scratch and wrote dQ
// partials per kv block for XLA to sum. Here one block of 8 warps owns
// (one batch·head, a 64-row K/V tile): K and V stay in shared memory and
// dK, dV in registers while the block loops over the live 64-row q
// tiles (the causal bound starts the loop at the diagonal). Each q tile:
// the warps take Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ on mma.sync m16n8k16 (bf16 in,
// f32 accumulate; warp (r, c) owns kv rows 16r.. and q columns 32c..),
// turn them into pᵀ and dSᵀ in registers and exchange them through
// shared memory as bf16 (the TPU's roundings); then dV += pᵀ·dO and
// dK += dSᵀ·Q (warp (r, c): kv rows 16r.., head columns c·D/2..), and
// dQ = dS·K for the tile, added into an f32 (B·H, Sq, D) buffer with
// atomicAdd (the wrapper casts it). The ragged edge (any Sq, Sk) is
// masked in the kernel. f32 inputs (and other head dims up to 128) run
// a plain FMA kernel of the same structure on 32x32 tiles. Still to
// come: wgmma with TMA staging and a pipelined q-tile ring.
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------
// tensor-core kernel: bf16, D in {64, 128}
// ---------------------------------------------------------------------
constexpr int MQ = 64;     // q rows per inner tile
constexpr int MK = 64;     // k/v rows per block
constexpr int MT = 256;    // threads: 8 warps

template <int D>
constexpr int mma_smem_bytes() {
  // sK, sV, sQ, sdO (rows padded by 16 bytes so ldmatrix is
  // conflict-free), sP and sdS (kv x q), lse and delta of the q tile
  return 4 * 64 * (D + 8) * 2 + 2 * MK * (MQ + 8) * 2 + 2 * MQ * 4;
}

// rows [r0, r0 + n) of a (S, D) bf16 matrix into shared memory with row
// stride D + 8; rows past S are zero-filled
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           int r0, int n, int S) {
  constexpr int CPR = D / 8;            // 16-byte chunks per row
  for (int c = threadIdx.x; c < n * CPR; c += MT) {
    const int r = c / CPR, col = (c % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + col);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(MT)
flash_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int Sq, int Sk, float scale,
              int causal) {
  constexpr int LDS = D + 8;
  constexpr int LDP = MQ + 8;
  constexpr int DH = D / 2;             // head columns per warp
  constexpr int NDH = DH / 8;           // their n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + MK * LDS;
  bf16* sQ = sV + MK * LDS;
  bf16* sdO = sQ + MQ * LDS;
  bf16* sP = sdO + MQ * LDS;            // pᵀ  (kv rows, q columns)
  bf16* sdS = sP + MK * LDP;            // dSᵀ (kv rows, q columns)
  float* sL = reinterpret_cast<float*>(sdS + MK * LDP);
  float* sDl = sL + MQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * MK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wc = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;
  const int off = Sk - Sq;
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* dob = dout + (size_t)bh * Sq * D;
  const float* lb = lse + (size_t)bh * Sq;
  const float* db = delta + (size_t)bh * Sq;
  float* dqb = dq + (size_t)bh * Sq * D;

  stage_tile<D>(sK, k + (size_t)bh * Sk * D, k0, MK, Sk);
  stage_tile<D>(sV, v + (size_t)bh * Sk * D, k0, MK, Sk);

  float dk_acc[NDH][4], dv_acc[NDH][4];
#pragma unroll
  for (int nd = 0; nd < NDH; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  // q rows that can see this kv tile: q + off >= k0 (causal)
  const int q_begin = causal ? (max(0, k0 - off) / MQ) * MQ : 0;
  for (int q0 = q_begin; q0 < Sq; q0 += MQ) {
    __syncthreads();   // the previous tile's shared-memory reads are done
    stage_tile<D>(sQ, qb, q0, MQ, Sq);
    stage_tile<D>(sdO, dob, q0, MQ, Sq);
    if (tid < MQ) {
      const bool in = q0 + tid < Sq;
      sL[tid] = in ? lb[q0 + tid] : 0.f;
      sDl[tid] = in ? db[q0 + tid] : 0.f;
    }
    __syncthreads();

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: kv rows 16wr.., q columns 32wc..
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      const int arow = (wr * 16 + (lane & 15)) * LDS + kk * 16
          + (lane >> 4) * 8;
      ptt::ldsm_x4(ak, sK + arow);
      ptt::ldsm_x4(av, sV + arow);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int brow = (wc * 32 + np * 16 + (mat >> 1) * 8 + mrow) * LDS
            + kk * 16 + (mat & 1) * 8;
        uint32_t b[4];
        ptt::ldsm_x4(b, sQ + brow);
        ptt::mma_16816(st[2 * np], ak, b[0], b[1]);
        ptt::mma_16816(st[2 * np + 1], ak, b[2], b[3]);
        ptt::ldsm_x4(b, sdO + brow);
        ptt::mma_16816(dpt[2 * np], av, b[0], b[1]);
        ptt::mma_16816(dpt[2 * np + 1], av, b[2], b[3]);
      }
    }

    // pᵀ = exp(sᵀ·scale - lse) (masked), dSᵀ = pᵀ·(dPᵀ - delta)·scale,
    // each rounded to bf16 into shared memory
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kv = wr * 16 + g + (e >> 1) * 8;
        const int qc = wc * 32 + nt * 8 + 2 * t + (e & 1);
        const int qp = q0 + qc, kp = k0 + kv;
        const bool live = qp < Sq && kp < Sk && (!causal || qp + off >= kp);
        const float p = live ? expf(st[nt][e] * scale - sL[qc]) : 0.f;
        dpt[nt][e] = p * (dpt[nt][e] - sDl[qc]) * scale;
        st[nt][e] = p;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = (wr * 16 + g + h * 8) * LDP + wc * 32 + nt * 8 + 2 * t;
        ptt::store_bf16x2(sP + idx, st[nt][2 * h], st[nt][2 * h + 1]);
        ptt::store_bf16x2(sdS + idx, dpt[nt][2 * h], dpt[nt][2 * h + 1]);
      }
    }
    __syncthreads();

    // dV += pᵀ·dO and dK += dSᵀ·Q: kv rows 16wr.., head columns DH·wc..
#pragma unroll
    for (int kq = 0; kq < MQ / 16; ++kq) {
      uint32_t ap[4], as[4];
      const int arow = (wr * 16 + (lane & 15)) * LDP + kq * 16
          + (lane >> 4) * 8;
      ptt::ldsm_x4(ap, sP + arow);
      ptt::ldsm_x4(as, sdS + arow);
#pragma unroll
      for (int np = 0; np < NDH / 2; ++np) {
        const int brow = (kq * 16 + (mat & 1) * 8 + mrow) * LDS + wc * DH
            + np * 16 + (mat >> 1) * 8;
        uint32_t b[4];
        ptt::ldsm_x4_t(b, sdO + brow);
        ptt::mma_16816(dv_acc[2 * np], ap, b[0], b[1]);
        ptt::mma_16816(dv_acc[2 * np + 1], ap, b[2], b[3]);
        ptt::ldsm_x4_t(b, sQ + brow);
        ptt::mma_16816(dk_acc[2 * np], as, b[0], b[1]);
        ptt::mma_16816(dk_acc[2 * np + 1], as, b[2], b[3]);
      }
    }

    // dQ (this kv tile's part) = dS·K: q rows 16wr.., head columns DH·wc..
    float dqa[NDH][4];
#pragma unroll
    for (int nd = 0; nd < NDH; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[nd][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      uint32_t a[4];
      ptt::ldsm_x4_t(a, sdS + (kk * 16 + (mat >> 1) * 8 + mrow) * LDP
                            + wr * 16 + (mat & 1) * 8);
#pragma unroll
      for (int np = 0; np < NDH / 2; ++np) {
        uint32_t b[4];
        ptt::ldsm_x4_t(b, sK + (kk * 16 + (mat & 1) * 8 + mrow) * LDS
                              + wc * DH + np * 16 + (mat >> 1) * 8);
        ptt::mma_16816(dqa[2 * np], a, b[0], b[1]);
        ptt::mma_16816(dqa[2 * np + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int nd = 0; nd < NDH; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + wr * 16 + g + (e >> 1) * 8;
        if (row < Sq)
          atomicAdd(dqb + (size_t)row * D + wc * DH + nd * 8 + 2 * t
                        + (e & 1), dqa[nd][e]);
      }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + wr * 16 + g + h * 8;
    if (row >= Sk) continue;
    bf16* dkr = dk + ((size_t)bh * Sk + row) * D + wc * DH;
    bf16* dvr = dv + ((size_t)bh * Sk + row) * D + wc * DH;
#pragma unroll
    for (int nd = 0; nd < NDH; ++nd) {
      ptt::store_bf16x2(dkr + nd * 8 + 2 * t, dk_acc[nd][2 * h],
                        dk_acc[nd][2 * h + 1]);
      ptt::store_bf16x2(dvr + nd * 8 + 2 * t, dv_acc[nd][2 * h],
                        dv_acc[nd][2 * h + 1]);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dq, void* dk,
               void* dv, int BH, int Sq, int Sk, float scale, int causal,
               cudaStream_t stream) {
  auto kern = flash_bwd_mma<D>;
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sk + MK - 1) / MK, BH);
  kern<<<grid, MT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, dq, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// FMA kernel: f32 (and bf16 with head dims other than 64/128), D <= DM
// ---------------------------------------------------------------------
constexpr int FR = 32;     // q rows per inner tile
constexpr int FC = 32;     // k/v rows per block
constexpr int FT = 256;    // threads: each one kv row x DM/8 head columns

template <int DM>
constexpr int fma_smem_bytes() {
  return (2 * FC + 2 * FR) * (DM + 1) * 4 + 2 * FC * (FR + 1) * 4
      + 2 * FR * 4;
}

template <typename T, int DM>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, int r0,
                                          int n, int S, int D) {
  for (int idx = threadIdx.x; idx < n * DM; idx += FT) {
    const int r = idx / DM, d = idx % DM;
    float x = 0.f;
    if (r0 + r < S && d < D) x = ptt::to_f(src[(size_t)(r0 + r) * D + d]);
    dst[r * (DM + 1) + d] = x;
  }
}

template <typename T, int DM>
__global__ void __launch_bounds__(FT)
flash_bwd_fma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
              int Sq, int Sk, int D, float scale, int causal) {
  constexpr int LD = DM + 1;
  constexpr int LP = FR + 1;
  constexpr int DJ = DM / 8;            // head columns per thread
  extern __shared__ float fsm[];
  float* sK = fsm;
  float* sV = sK + FC * LD;
  float* sQ = sV + FC * LD;
  float* sdO = sQ + FR * LD;
  float* sP = sdO + FR * LD;            // pᵀ  (kv rows, q columns)
  float* sdS = sP + FC * LP;            // dSᵀ (kv rows, q columns)
  float* sL = sdS + FC * LP;
  float* sDl = sL + FR;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * FC;
  const int tid = threadIdx.x;
  const int r = tid >> 3;               // kv row (dK/dV, scores), q row (dQ)
  const int cl = tid & 7;               // column lane
  const int off = Sk - Sq;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* dob = dout + (size_t)bh * Sq * D;
  float* dqb = dq + (size_t)bh * Sq * D;

  stage_f32<T, DM>(sK, k + (size_t)bh * Sk * D, k0, FC, Sk, D);
  stage_f32<T, DM>(sV, v + (size_t)bh * Sk * D, k0, FC, Sk, D);

  float dka[DJ], dva[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dka[j] = dva[j] = 0.f;

  const int q_begin = causal ? (max(0, k0 - off) / FR) * FR : 0;
  for (int q0 = q_begin; q0 < Sq; q0 += FR) {
    __syncthreads();
    stage_f32<T, DM>(sQ, qb, q0, FR, Sq, D);
    stage_f32<T, DM>(sdO, dob, q0, FR, Sq, D);
    if (tid < FR) {
      const bool in = q0 + tid < Sq;
      sL[tid] = in ? lse[(size_t)bh * Sq + q0 + tid] : 0.f;
      sDl[tid] = in ? delta[(size_t)bh * Sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4], dp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DM; ++d) {
      const float kk = sK[r * LD + d], vv = sV[r * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = cl + 8 * j;
        s[j] = fmaf(kk, sQ[qc * LD + d], s[j]);
        dp[j] = fmaf(vv, sdO[qc * LD + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = cl + 8 * j;
      const int qp = q0 + qc, kp = k0 + r;
      const bool live = qp < Sq && kp < Sk && (!causal || qp + off >= kp);
      const float p = live ? expf(s[j] * scale - sL[qc]) : 0.f;
      sP[r * LP + qc] = ptt::round_to<T>(p);
      sdS[r * LP + qc] = ptt::round_to<T>(p * (dp[j] - sDl[qc]) * scale);
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < FR; ++qq) {
      const float pp = sP[r * LP + qq], dd = sdS[r * LP + qq];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = cl + 8 * j;
        dva[j] = fmaf(pp, sdO[qq * LD + c], dva[j]);
        dka[j] = fmaf(dd, sQ[qq * LD + c], dka[j]);
      }
    }
    // dQ: thread owns q row r of the tile, head columns cl + 8j
    const int qrow = q0 + r;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = cl + 8 * j;
      float acc = 0.f;
#pragma unroll 8
      for (int kv = 0; kv < FC; ++kv)
        acc = fmaf(sdS[kv * LP + r], sK[kv * LD + c], acc);
      if (qrow < Sq && c < D) atomicAdd(dqb + (size_t)qrow * D + c, acc);
    }
  }

  const int row = k0 + r;
  if (row < Sk) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = cl + 8 * j;
      if (c < D) {
        dk[((size_t)bh * Sk + row) * D + c] = ptt::from_f<T>(dka[j]);
        dv[((size_t)bh * Sk + row) * D + c] = ptt::from_f<T>(dva[j]);
      }
    }
  }
}

template <typename T, int DM>
int launch_fma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dq, void* dk,
               void* dv, int BH, int Sq, int Sk, int D, float scale,
               int causal, cudaStream_t stream) {
  auto kern = flash_bwd_fma<T, DM>;
  constexpr int smem = fma_smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sk + FC - 1) / FC, BH);
  kern<<<grid, FT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dq,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout (BH, Sq, D), k/v (BH, Sk, D) contiguous in `dtype`; lse, delta
// (BH, Sq) f32; dq (BH, Sq, D) f32, ZEROED by the caller (the kernel adds
// into it); dk/dv like k. D <= 128. Returns cudaGetLastError() after the
// launch.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   float* dq, void* dk, void* dv, int BH,
                                   int Sq, int Sk, int D, float scale,
                                   int causal, int dtype, void* stream) {
  if (BH <= 0) return 0;
  if (Sk <= 0 || Sq < 0 || D <= 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16) {
    if (D == 128)
      return launch_mma<128>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Sq,
                             Sk, scale, causal, s);
    if (D == 64)
      return launch_mma<64>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Sq,
                            Sk, scale, causal, s);
    return D <= 64
        ? launch_fma<bf16, 64>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Sq,
                               Sk, D, scale, causal, s)
        : launch_fma<bf16, 128>(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                Sq, Sk, D, scale, causal, s);
  }
  if (dtype == ptt::kF32) {
    return D <= 64
        ? launch_fma<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                Sq, Sk, D, scale, causal, s)
        : launch_fma<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                 Sq, Sk, D, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
