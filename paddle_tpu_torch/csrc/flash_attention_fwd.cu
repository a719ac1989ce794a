// Flash-attention forward for Hopper (sm_90a): o and lse of causal or
// non-causal softmax(q·kᵀ·scale)·v over (B·H, S, D) tensors, one pass,
// the (Sq, Sk) score matrix never written to device memory.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_fwd_kernel` (launched by
// `_flash_forward`, pallas_call at :171). Same contract: o in q's dtype,
// lse = m + log(l) as f32 (B·H, Sq, 1); causal mask q_pos + off >= k_pos
// with off = Sk - Sq (-1e30 for a masked score, -inf past Sk); f32
// softmax statistics and accumulator; the `l == 0 -> 1` guard;
// probabilities rounded to v's dtype before P·V.
//
// What bounds it on an H100: at the long prompts of serving prefill and
// at the training shape (S = 2048, D = 128) the work is 4·S²·D/2
// operations per head against 4·S·D bytes, far above the card's ~295
// operations per byte, so the bound is the bf16 tensor-core rate
// (989 TFLOP/s), which only wgmma reaches.
//
// What this design does about it (bf16, D of 64 or 128: serving and
// training). A persistent grid, one block an SM, each block three
// warpgroups working through (batch·head, 128 q rows) tiles. A producer
// warpgroup (registers cut to 24 by setmaxnreg) whose one thread issues
// TMA loads: each tile's Q once, then 128-row K and V tiles into a
// 2-stage ring (160 KB at D = 128), each a (D, S, B·H) 3D tensor-map box
// with a 128-byte swizzle, so a tile past the end of one head zero-fills
// and never reads the next head's rows; full/empty mbarriers per K and
// per V stage and for Q, so it loads the next tile's Q and K/V while the
// consumers finish the last. Two consumer warpgroups (registers raised
// to 240) each own 64 q rows: S = Q·Kᵀ by wgmma m64n128k16 with Q and K
// K-major in shared memory; the online softmax in registers (scores in
// log2 units, exp2); P packed to bf16 is already the register A operand
// of O += P·V (wgmma m64nDk16, V as an MN-major B through the
// descriptor's transpose bit). The K/V loop stops at the causal diagonal
// (tiles above it are never loaded) and the mask runs only on the
// diagonal and ragged tiles. A block takes q tiles p and n_qt - 1 - p of
// one head in turn, whose causal work adds up to a constant, and the q
// tiles of a head run side by side, sharing its K/V in L2.
// f32 inputs (the BERT path) and other head dims up to 128 run a plain
// FMA kernel of the same contract: each thread a 4x4 score sub-tile and
// a 4 x D/16 slice of the output from shared memory, 64-row tiles, the
// same causal loop bound.
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // k/v rows per tile
constexpr int NT = 256;   // threads: 16 x 16, each 4 rows x 4 keys

template <int DM>
constexpr int smem_bytes() {
  // sQ, sK (reused as sP after the scores are taken), sV; rows padded to
  // DM + 1 floats so column walks hit distinct banks
  return 3 * BQ * (DM + 1) * sizeof(float);
}

template <typename T, int DM>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int D, float scale,
                 int causal) {
  static_assert(BQ == BK, "sP reuses sK's rows");
  constexpr int LD = DM + 1;
  constexpr int LP = BK + 1;
  constexpr int DJ = DM / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sP = sK;               // BQ x LP fits inside BK x LD
  float* sV = sK + BK * LD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;      // key / output-column lane
  const int ty = tid >> 4;      // row lane
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;
  const int off = Sk - Sq;

  for (int idx = tid; idx < BQ * DM; idx += NT) {
    const int r = idx / DM, d = idx % DM;
    float x = 0.f;
    if (q0 + r < Sq && d < D) x = ptt::to_f(qb[(size_t)(q0 + r) * D + d]);
    sQ[r * LD + d] = x;
  }

  // keys this q tile can see: all of them, or (causal) up to the last
  // row's diagonal — tiles past it are never loaded
  // (a row that sees no key, q_pos + off < 0 when Sq > Sk, softmaxes its
  // masked scores over every key, as the plain version does: a tile
  // holding one walks them all)
  int kv_end = Sk;
  if (causal && q0 + off >= 0) kv_end = min(Sk, q0 + BQ + off);
  const int n_tiles = kv_end <= 0 ? 0 : (kv_end + BK - 1) / BK;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ptt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's sP / sV reads are done
    for (int idx = tid; idx < BK * DM; idx += NT) {
      const int c = idx / DM, d = idx % DM;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Sk && d < D) {
        kx = ptt::to_f(kb[(size_t)(k0 + c) * D + d]);
        vx = ptt::to_f(vb[(size_t)(k0 + c) * D + d]);
      }
      sK[c * LD + d] = kx;
      sV[c * LD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DM; ++d) {
      float qa[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }
    __syncthreads();   // sK is about to be overwritten by sP

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = ptt::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kp >= Sk) x = -INFINITY;                  // ragged edge: no mass
        else if (causal && qp + off < kp) x = ptt::kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(ty + 16 * i) * LP + tx + 16 * j] = ptt::round_to<T>(p);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sP[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sV[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((size_t)bh * Sq + r) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = ptt::from_f<T>(acc[i][j] / li);
    }
    if (tx == 0) lse[(size_t)bh * Sq + r] = m[i] + logf(li);
  }
}

template <typename T, int DM>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int Sq, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DM>;
  constexpr int smem = smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------
// Hopper kernel: bf16, D in {64, 128}; wgmma with TMA staging
// ---------------------------------------------------------------------
namespace hp = ptt::hopper;

constexpr int WQ = 128;                 // q rows per block (64 a consumer)
constexpr int WK = 128;                 // k/v rows per tile
constexpr int WT = 384;                 // producer + 2 consumer warpgroups
constexpr int WSTAGES = 2;              // K/V ring
constexpr int BOX = 128 * 128;          // bytes of one (128 rows, 64 d) box
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
__host__ __device__ constexpr int tile_bytes() { return 128 * D * 2; }

template <int D>
constexpr int wgmma_smem_bytes() {
  // Q, K ring, V ring; 1024 of alignment slack; the barriers
  return (1 + 2 * WSTAGES) * tile_bytes<D>() + 1024 + (2 + 4 * WSTAGES) * 8;
}

// 2^x by the MUFU unit alone (ex2.approx, flushing denormal results to
// zero: a probability below 2^-126 of the row's largest is lost either
// way in bf16)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + 128) x all D of head bh into a tile of D / 64 boxes
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int r0, int bh) {
  hp::mbar_arrive_expect_tx(bar, tile_bytes<D>());
#pragma unroll
  for (int b = 0; b < D / 64; ++b)
    hp::tma_load_3d(dst + b * BOX, map, bar, 64 * b, r0, bh);
}

// the causal bound of the K/V loop for the 128 q rows from q0: keys up to
// the last row's diagonal (tiles past it are never loaded). A row that
// sees no key (q_pos + off < 0 when Sq > Sk) softmaxes its masked scores
// over every key, as the plain version does: a tile holding one walks
// them all
__device__ __forceinline__ int kv_tiles(int q0, int Sq, int Sk, int causal) {
  const int off = Sk - Sq;
  int kv_end = Sk;
  if (causal && q0 + off >= 0) kv_end = min(Sk, q0 + WQ + off);
  return kv_end <= 0 ? 0 : (kv_end + WK - 1) / WK;
}

// A persistent grid: block b takes the work items b, b + gridDim.x, ...
// An item is one batch·head's q tiles p and n_qt - 1 - p, the longer
// first: under the causal mask their K/V tiles add up to about n_qt + 1
// whatever p, so a static round-robin keeps the blocks even, and the
// items of one head run side by side (p goes fastest), so its K and V are
// read from L2 by all of them.
__device__ __forceinline__ int item_q0(int p, int half, int n_qt) {
  return (half == 0 ? n_qt - 1 - p : p) * WQ;
}

template <int D>
__global__ void __launch_bounds__(WT, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int BH,
                int Sq, int Sk, float scale, int causal) {
  constexpr int TB = tile_bytes<D>();
  extern __shared__ unsigned char fa_smem_raw[];
  unsigned char* sQ = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fa_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sK = sQ + TB;                     // WSTAGES tiles
  unsigned char* sV = sK + WSTAGES * TB;           // WSTAGES tiles
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + WSTAGES * TB);
  uint64_t* full_q = bar;
  uint64_t* empty_q = bar + 1;
  uint64_t* full_k = bar + 2;
  uint64_t* full_v = full_k + WSTAGES;
  uint64_t* empty_k = full_v + WSTAGES;
  uint64_t* empty_v = empty_k + WSTAGES;

  const int n_qt = (Sq + WQ - 1) / WQ;
  const int n_pairs = (n_qt + 1) / 2;
  const int items = n_pairs * BH;
  const int off = Sk - Sq;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hp::mbar_init(full_q, 1);
    hp::mbar_init(empty_q, 2);            // one arrival per consumer
    for (int s = 0; s < WSTAGES; ++s) {
      hp::mbar_init(&full_k[s], 1);
      hp::mbar_init(&full_v[s], 1);
      hp::mbar_init(&empty_k[s], 2);
      hp::mbar_init(&empty_v[s], 2);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: per item Q once, then its K and V tiles through the
    // ring; it runs on into the next item while the consumers finish ----
    hp::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hp::tma_prefetch_map(&map_q);
      hp::tma_prefetch_map(&map_k);
      hp::tma_prefetch_map(&map_v);
      int it = 0, n = 0;                   // K/V tiles, Q tiles loaded
      for (int item = blockIdx.x; item < items; item += gridDim.x)
      for (int half = 0; half < 2; ++half) {
        const int bh = item / n_pairs, p = item % n_pairs;
        if (half == 1 && 2 * p + 1 == n_qt) break;   // the middle tile
        const int q0 = item_q0(p, half, n_qt);
        const int n_tiles = kv_tiles(q0, Sq, Sk, causal);
        if (n_tiles == 0) continue;
        hp::mbar_wait(empty_q, (n++ & 1) ^ 1);
        load_tile<D>(sQ, &map_q, full_q, q0, bh);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % WSTAGES;
          const uint32_t ph = ((it / WSTAGES) & 1) ^ 1;
          hp::mbar_wait(&empty_k[s], ph);
          load_tile<D>(sK + s * TB, &map_k, &full_k[s], j * WK, bh);
          hp::mbar_wait(&empty_v[s], ph);
          load_tile<D>(sV + s * TB, &map_v, &full_v[s], j * WK, bh);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns q rows [q0 + 64c, q0 + 64c + 64) ----
    hp::setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const float sl2 = scale * LOG2E;                 // scores in log2 units
    const uint64_t dq = hp::desc_sw128(sQ + c * 64 * 128, 16, 1024);
    int it = 0, n = 0;                     // K/V tiles, Q tiles read
    for (int item = blockIdx.x; item < items; item += gridDim.x)
    for (int half = 0; half < 2; ++half) {
      const int bh = item / n_pairs, p = item % n_pairs;
      if (half == 1 && 2 * p + 1 == n_qt) break;     // the middle tile
      const int q0 = item_q0(p, half, n_qt);
      const int n_tiles = kv_tiles(q0, Sq, Sk, causal);
      const int rbase = q0 + 64 * c + 16 * warp + g;  // this thread's rows:
                                                       // rbase, rbase + 8
      float m[2] = {ptt::kNegInf, ptt::kNegInf};     // running max (log2)
      float l[2] = {0.f, 0.f};                       // this thread's part
      float oacc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;

      if (n_tiles > 0) hp::mbar_wait(full_q, n++ & 1);
      for (int j = 0; j < n_tiles; ++j, ++it) {
        const int s = it % WSTAGES;
        const uint32_t ph = (it / WSTAGES) & 1;
        const int k0 = j * WK;

        // S = Q·Kᵀ: 64 x 128 f32, K-major Q and K
        float sacc[64];
        hp::mbar_wait(&full_k[s], ph);
        const uint64_t dk = hp::desc_sw128(sK + s * TB, 16, 1024);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t step = (kk / 4) * BOX + (kk % 4) * 32;
          hp::wgmma_m64n128k16_bf16_ss(sacc, hp::desc_advance(dq, step),
                                       hp::desc_advance(dk, step), kk > 0);
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(sacc);
        if (tid == 0) {
          hp::mbar_arrive(&empty_k[s]);
          if (j + 1 == n_tiles) hp::mbar_arrive(empty_q);  // Q read: free
        }

        // scale, mask where the tile needs it, online softmax in registers
        const bool edge = k0 + WK > Sk;
        const bool diag = causal && k0 + WK - 1 > q0 + 64 * c + off;
        float mx[2] = {ptt::kNegInf, ptt::kNegInf};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          float x = sacc[i] * sl2;
          if (edge || diag) {
            const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
            const int row = rbase + 8 * ((i / 2) & 1);
            if (col >= Sk) x = -INFINITY;             // ragged edge: no mass
            else if (causal && row + off < col) x = ptt::kNegInf;
          }
          sacc[i] = x;
          mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], x);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = exp2_approx(m[r] - m_new);
          m[r] = m_new;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float p = exp2_approx(sacc[i] - m[(i / 2) & 1]);
          sacc[i] = p;
          rs[(i / 2) & 1] += p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i / 2) & 1];

        // P rounded to bf16: key block kk's two n8 blocks of S are the
        // register A operand of one k16 step of O += P·V
        uint32_t pa[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
        }
        hp::mbar_wait(&full_v[s], ph);
        // V as an MN-major B: 16 keys a step (2048 bytes), the two 64-wide
        // d boxes 16 KB apart
        const uint64_t dv = hp::desc_sw128(sV + s * TB, BOX, 1024);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if constexpr (D == 128)
            hp::wgmma_m64n128k16_bf16_rs(oacc, pa[kk],
                                         hp::desc_advance(dv, kk * 2048));
          else
            hp::wgmma_m64n64k16_bf16_rs(oacc, pa[kk],
                                        hp::desc_advance(dv, kk * 2048));
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(oacc);
        if (tid == 0) hp::mbar_arrive(&empty_v[s]);
      }

      // o = acc / l, lse = m·ln2 + log l (a fully masked row keeps the
      // masked value, as the plain version's logsumexp does in f32)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr = l[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const float li = lr == 0.f ? 1.f : lr;
        const float inv = 1.f / li;
        const int row = rbase + 8 * r;
        if (row >= Sq) continue;
        __nv_bfloat16* orow = o + ((size_t)bh * Sq + row) * D;
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jd + 2 * t4) =
              __floats2bfloat162_rn(oacc[4 * jd + 2 * r] * inv,
                                    oacc[4 * jd + 2 * r + 1] * inv);
        if (t4 == 0)
          lse[(size_t)bh * Sq + row] =
              m[r] == ptt::kNegInf ? ptt::kNegInf : m[r] * LN2 + logf(li);
      }
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int BH, int Sq, int Sk, float scale, int causal,
                 cudaStream_t stream) {
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
        | reinterpret_cast<uintptr_t>(v)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // (D, S, BH) maps: a box past the end of one head zero-fills instead of
  // reading the next head's rows
  CUtensorMap mq, mk, mv;
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint64_t dq[3] = {(cuuint64_t)D, (cuuint64_t)Sq, (cuuint64_t)BH};
  const cuuint64_t dkv[3] = {(cuuint64_t)D, (cuuint64_t)Sk, (cuuint64_t)BH};
  const cuuint64_t sq[2] = {(cuuint64_t)D * 2, (cuuint64_t)Sq * D * 2};
  const cuuint64_t skv[2] = {(cuuint64_t)D * 2, (cuuint64_t)Sk * D * 2};
  int err = hp::make_map(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, q, dq, sq,
                         box);
  if (err == 0)
    err = hp::make_map(&mk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, dkv, skv,
                       box);
  if (err == 0)
    err = hp::make_map(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, dkv, skv,
                       box);
  if (err != 0) return err;
  auto kern = flash_fwd_wgmma<D>;
  constexpr int smem = wgmma_smem_bytes<D>();
  static bool configured = false;   // the attribute is per kernel, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int items = BH * (((Sq + WQ - 1) / WQ + 1) / 2);
  const int grid = min(items, hp::sm_count());
  kern<<<grid, WT, smem, stream>>>(mq, mk, mv,
                                   static_cast<__nv_bfloat16*>(o), lse, BH,
                                   Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (BH, Sq, D), k/v (BH, Sk, D) contiguous in `dtype`; o like q;
// lse (BH, Sq) f32. D <= 128. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int BH,
                                   int Sq, int Sk, int D, float scale,
                                   int causal, int dtype, void* stream) {
  if (BH <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || D <= 0 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16) {
    if (D == 128) return launch_wgmma<128>(q, k, v, o, lse, BH, Sq, Sk, scale, causal, s);
    if (D == 64) return launch_wgmma<64>(q, k, v, o, lse, BH, Sq, Sk, scale, causal, s);
    return D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, lse, BH, Sq, Sk, D, scale, causal, s)
                   : launch<__nv_bfloat16, 128>(q, k, v, o, lse, BH, Sq, Sk, D, scale, causal, s);
  }
  if (dtype == ptt::kF32) {
    return D <= 64 ? launch<float, 64>(q, k, v, o, lse, BH, Sq, Sk, D, scale, causal, s)
                   : launch<float, 128>(q, k, v, o, lse, BH, Sq, Sk, D, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory a block of the TMA/wgmma kernel takes at head dim
// D (64 or 128), in bytes
extern "C" int flash_attention_fwd_smem_bytes(int D) {
  return D == 64 ? wgmma_smem_bytes<64>() : wgmma_smem_bytes<128>();
}
