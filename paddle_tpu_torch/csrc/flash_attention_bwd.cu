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
// dQ) against ~8·S·D bytes per head, so at training lengths (S = 2048,
// D = 128) the bound is arithmetic: 171.9 GFLOP at (4, 16, 2048, 128)
// causal, 0.174 ms at the bf16 tensor-core rate (989 TFLOP/s), which
// only wgmma reaches.
//
// What this design does about it (bf16, D of 64 or 128: training). It is
// not a copy of the TPU grid, whose sequential q sweep carried dK/dV in
// scratch and wrote dQ partials per kv block for XLA to sum. A persistent
// grid, one block an SM, each block three warpgroups. A work item is one
// batch·head's kv tiles p and n_kt - 1 - p (128 rows each), the longer
// first: under the causal mask their q tiles add up to a constant, so a
// static round-robin keeps the blocks even, and the items of one head run
// side by side, sharing its Q and dO in L2. The producer warpgroup
// (registers cut to 24 by setmaxnreg) has one thread issue TMA loads
// through (D, S, B·H) 3D tensor maps with a 128-byte swizzle (a tile past
// a head's end zero-fills): the tile's K and V once, then 64-row Q and dO
// tiles with their lse and delta rows (1D maps) into a 2-stage ring with
// full/empty mbarriers, running on into the next item while the
// consumers finish. Two consumer warpgroups (registers raised to 240),
// each owning 64 kv rows, per q tile:
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ by wgmma m64n64k16, both operands K-major
//   in shared memory; pᵀ = exp2(sᵀ·scale·log2e - lse·log2e) and
//   dSᵀ = pᵀ·(dPᵀ - delta)·scale in registers (the mask only on diagonal
//   and ragged tiles), packed to bf16 they are already the register A
//   operands of dV += pᵀ·dO and dK += dSᵀ·Q (wgmma m64nDk16, dO and Q as
//   MN-major B through the transpose bit), so dK and dV (2·64·D f32) live
//   in registers for the whole kv tile;
//   dSᵀ also goes to shared memory in the 128-byte swizzle (two buffers,
//   alternating), and dQ = dS·K is a wgmma with both operands MN-major
//   (dS read through its transpose, K as stored): at D = 128 each
//   consumer takes 64 of the head columns over all 128 kv rows (one
//   named barrier joins the two consumers' dS halves), at D = 64 all
//   columns over its own 64 rows. The f32 dQ part is staged in shared
//   memory and added into the zeroed f32 dq buffer by one TMA reduce-add
//   (cp.reduce.async.bulk.tensor .add) through a (D, Sq, B·H) map, which
//   runs while the next tile computes: at D 128 the two consumers' halves
//   side by side as one contiguous (64 q, 128 d) tile, at D 64 one
//   (64 q, 64 d) tile per consumer.
// The causal loop starts at the first q tile that sees the kv tile.
// What still bounds it: those reduce-adds. With 128-row kv tiles every
// dq element takes one f32 add per kv tile that sees it, 570 MB of adds
// at (4, 16, 2048, 128) causal, and they cost about a third of the
// kernel's time on an H100 (PERF.md §6, PR 7).
// dQ's sums arrive in a different order on every run (the reduce-adds of
// different blocks race), so its low bits vary from run to run.
// f32 inputs (the BERT path) and bf16 with other head dims run a plain
// FMA kernel of the same contract on 32x32 tiles.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------
// Hopper kernel: bf16, D in {64, 128}; wgmma with TMA staging
// ---------------------------------------------------------------------
namespace hp = ptt::hopper;

constexpr int WKV = 128;                // kv rows a tile (64 a consumer)
constexpr int WQ = 64;                  // q rows a tile of the ring
constexpr int WT = 384;                 // producer + 2 consumer warpgroups
constexpr int WSTAGES = 2;              // q-tile ring
constexpr int KBOX = WKV * 128;         // bytes of a (128 rows, 64 d) box
constexpr int QBOX = WQ * 128;          // bytes of a (64 rows, 64 d) box
constexpr int DS_BYTES = WKV * WQ * 2;  // a dSᵀ tile (kv rows, 64 q), bf16
constexpr int LD_N = WQ + 4;            // lse or delta floats a stage: a
                                        // tile's 64 rows from a 16-byte-
                                        // aligned start (TMA's rule), so
                                        // up to 3 more in front
constexpr int LD_SLOT = 96;             // floats between two such boxes:
                                        // each 128-byte aligned
constexpr int DQ_BYTES = WQ * 64 * 4;   // (64 q, 64 d) of dQ, f32
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int kv_bytes() { return (D / 64) * KBOX; }

template <int D>
__host__ __device__ constexpr int q_bytes() { return (D / 64) * QBOX; }

template <int D>
constexpr int wgmma_smem_bytes() {
  // K, V; the ring of Q and dO tiles; two dSᵀ tiles; dQ out (64 x 128
  // f32); lse and delta a stage; the barriers; 1024 of alignment slack
  return 2 * kv_bytes<D>() + WSTAGES * 2 * q_bytes<D>() + 2 * DS_BYTES
      + 2 * DQ_BYTES + WSTAGES * 2 * LD_SLOT * 4 + (2 + 2 * WSTAGES) * 8
      + 1024;
}

// 2^x by the MUFU unit alone (ex2.approx, flushing denormal results to
// zero: a probability below 2^-126 is lost either way in bf16)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ld_shared_volatile(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(hp::smem_addr(p)));
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the first q tile that sees kv rows from k0 (q_pos + off >= k_pos), and
// how many q tiles the loop takes from there
__device__ __forceinline__ int q_tiles(int k0, int Sq, int Sk, int causal,
                                       int& qt0) {
  qt0 = causal ? max(0, k0 - (Sk - Sq)) / WQ : 0;
  return max(0, (Sq + WQ - 1) / WQ - qt0);
}

// kv tile of work item half `half`: p, then n_kt - 1 - p
__device__ __forceinline__ int item_kt(int p, int half, int n_kt) {
  return half == 0 ? p : n_kt - 1 - p;
}

template <int D>
__global__ void __launch_bounds__(WT, 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do,
                const __grid_constant__ CUtensorMap map_lse,
                const __grid_constant__ CUtensorMap map_delta,
                const __grid_constant__ CUtensorMap map_dq,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int Sq,
                int Sk, float scale, int causal) {
  constexpr int KVB = kv_bytes<D>();
  constexpr int QB = q_bytes<D>();
  extern __shared__ unsigned char fb_smem_raw[];
  unsigned char* sK = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fb_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sV = sK + KVB;
  unsigned char* sQ = sV + KVB;          // stage s: Q at sQ + 2·s·QB,
                                         // dO right after it
  unsigned char* sdS = sQ + WSTAGES * 2 * QB;        // two dSᵀ tiles
  float* sdQ = reinterpret_cast<float*>(sdS + 2 * DS_BYTES);  // dQ out,
                                         // f32: one (64, 128) tile or two
                                         // (64, 64)
  float* sLD = sdQ + 2 * DQ_BYTES / 4;   // stage s: lse at 2·s·LD_SLOT,
                                         // delta LD_SLOT on
  uint64_t* bar = reinterpret_cast<uint64_t*>(sLD + WSTAGES * 2 * LD_SLOT);
  uint64_t* full_kv = bar;
  uint64_t* empty_kv = bar + 1;
  uint64_t* full = bar + 2;
  uint64_t* empty = full + WSTAGES;

  const int n_kt = (Sk + WKV - 1) / WKV;
  const int n_pairs = (n_kt + 1) / 2;
  const int items = n_pairs * BH;
  const int off = Sk - Sq;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hp::mbar_init(full_kv, 1);
    hp::mbar_init(empty_kv, 2);          // one arrival per consumer
    for (int s = 0; s < WSTAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 2);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: per kv tile K and V once, then its q tiles (Q, dO,
    // lse, delta) through the ring ----
    hp::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hp::tma_prefetch_map(&map_q);
      hp::tma_prefetch_map(&map_k);
      hp::tma_prefetch_map(&map_v);
      hp::tma_prefetch_map(&map_do);
      int it = 0, n = 0;                   // q tiles, kv tiles loaded
      for (int item = blockIdx.x; item < items; item += gridDim.x)
      for (int half = 0; half < 2; ++half) {
        const int bh = item / n_pairs, p = item % n_pairs;
        if (half == 1 && 2 * p + 1 == n_kt) break;   // the middle tile
        const int k0 = item_kt(p, half, n_kt) * WKV;
        int qt0;
        const int n_q = q_tiles(k0, Sq, Sk, causal, qt0);
        if (n_q == 0) continue;
        hp::mbar_wait(empty_kv, (n++ & 1) ^ 1);
        hp::mbar_arrive_expect_tx(full_kv, 2 * KVB);
#pragma unroll
        for (int b = 0; b < D / 64; ++b) {
          hp::tma_load_3d(sK + b * KBOX, &map_k, full_kv, 64 * b, k0, bh);
          hp::tma_load_3d(sV + b * KBOX, &map_v, full_kv, 64 * b, k0, bh);
        }
        for (int j = 0; j < n_q; ++j, ++it) {
          const int s = it % WSTAGES;
          const int q0 = (qt0 + j) * WQ;
          hp::mbar_wait(&empty[s], ((it / WSTAGES) & 1) ^ 1);
          hp::mbar_arrive_expect_tx(&full[s], 2 * QB + 2 * LD_N * 4);
          unsigned char* sq = sQ + 2 * s * QB;
#pragma unroll
          for (int b = 0; b < D / 64; ++b) {
            hp::tma_load_3d(sq + b * QBOX, &map_q, &full[s], 64 * b, q0, bh);
            hp::tma_load_3d(sq + QB + b * QBOX, &map_do, &full[s], 64 * b,
                            q0, bh);
          }
          // (B·H·Sq) rows of lse and delta from the 16-byte boundary at or
          // before the tile's first row; past a head's end the box holds
          // the next head's rows, which the mask zeroes
          float* ld = sLD + 2 * s * LD_SLOT;
          const int r0 = (bh * Sq + q0) & ~3;
          hp::tma_load_1d(ld, &map_lse, &full[s], r0);
          hp::tma_load_1d(ld + LD_SLOT, &map_delta, &full[s], r0);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns kv rows [k0 + 64c, k0 + 64c + 64) --
    hp::setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const float sl2 = scale * LOG2E;          // scores in log2 units
    // this consumer's K and V rows as K-major A operands
    const uint64_t dka_desc = hp::desc_sw128(sK + c * 64 * 128, 16, 1024);
    const uint64_t dva_desc = hp::desc_sw128(sV + c * 64 * 128, 16, 1024);
    // dQ's operands, both MN-major: dSᵀ (kv rows, 64 q) read as dS, and K
    // (kv rows, d) as stored. D = 128: all 128 kv rows, this consumer's 64
    // head columns (its box of K); D = 64: its own 64 kv rows, every column
    constexpr int DQ_STEPS = D == 128 ? WKV / 16 : 64 / 16;
    const int ds_off = D == 128 ? 0 : c * 64 * 128;
    const uint64_t dqb_desc = hp::desc_sw128(
        sK + (D == 128 ? c * KBOX : c * 64 * 128), QBOX, 1024);
    int it = 0, n = 0;                        // q tiles, kv tiles read
    for (int item = blockIdx.x; item < items; item += gridDim.x)
    for (int half = 0; half < 2; ++half) {
      const int bh = item / n_pairs, p = item % n_pairs;
      if (half == 1 && 2 * p + 1 == n_kt) break;     // the middle tile
      const int k0 = item_kt(p, half, n_kt) * WKV;
      const int kr0 = k0 + 64 * c;                   // this consumer's rows
      int qt0;
      const int n_q = q_tiles(k0, Sq, Sk, causal, qt0);
      float dka[D / 2], dva[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

      if (n_q > 0) hp::mbar_wait(full_kv, n++ & 1);
      for (int j = 0; j < n_q; ++j, ++it) {
        const int s = it % WSTAGES;
        const int q0 = (qt0 + j) * WQ;
        unsigned char* sq = sQ + 2 * s * QB;
        unsigned char* sdo = sq + QB;
        // this tile's lse and delta: rows from (bh·Sq + q0) % 4 on
        const float* sl = sLD + 2 * s * LD_SLOT + ((bh * Sq + q0) & 3);
        hp::mbar_wait(&full[s], (it / WSTAGES) & 1);

        // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 64 kv x 64 q f32 each, K-major
        // operands, 16 of the head dim a step
        float st[32], dpt[32];
        const uint64_t dqs = hp::desc_sw128(sq, 16, 1024);
        const uint64_t ddo = hp::desc_sw128(sdo, 16, 1024);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t sa = (kk / 4) * KBOX + (kk % 4) * 32;
          const uint32_t sb = (kk / 4) * QBOX + (kk % 4) * 32;
          hp::wgmma_m64n64k16_bf16_ss(st, hp::desc_advance(dka_desc, sa),
                                      hp::desc_advance(dqs, sb), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t sa = (kk / 4) * KBOX + (kk % 4) * 32;
          const uint32_t sb = (kk / 4) * QBOX + (kk % 4) * 32;
          hp::wgmma_m64n64k16_bf16_ss(dpt, hp::desc_advance(dva_desc, sa),
                                      hp::desc_advance(ddo, sb), kk > 0);
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(st);
        hp::fence_regs(dpt);

        // pᵀ and dSᵀ in registers; element i: kv row
        // 16·warp + g + 8·((i / 2) % 2), q column 8·(i / 4) + 2·t4 + i % 2
        const bool masked = q0 + WQ > Sq || kr0 + 64 > Sk
            || (causal && q0 + off < kr0 + 63);
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jb + e;
            const int col = 8 * jb + 2 * t4 + (e & 1);
            // read at the point of use (volatile: not hoisted into 32
            // registers held across the loop)
            const float lse_l2 = ld_shared_volatile(sl + col) * LOG2E;
            const float delta = ld_shared_volatile(sl + LD_SLOT + col);
            float pv = exp2_approx(fmaf(st[i], sl2, -lse_l2));
            if (masked) {
              const int qp = q0 + col;
              const int kp = kr0 + 16 * warp + g + 8 * (e >> 1);
              if (qp >= Sq || kp >= Sk || (causal && qp + off < kp))
                pv = 0.f;
            }
            st[i] = pv;
            dpt[i] = pv * (dpt[i] - delta) * scale;
          }
        }
        // bf16 pairs: q block kk's two n8 blocks are one k16 A step
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
            da[kk][r] = pack_bf16(dpt[8 * kk + 2 * r],
                                  dpt[8 * kk + 2 * r + 1]);
          }

        // dV += pᵀ·dO and dK += dSᵀ·Q: dO and Q MN-major, 16 q rows a step
        const uint64_t bdo = hp::desc_sw128(sdo, QBOX, 1024);
        const uint64_t bq = hp::desc_sw128(sq, QBOX, 1024);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (D == 128) {
            hp::wgmma_m64n128k16_bf16_rs(dva, pa[kk],
                                         hp::desc_advance(bdo, kk * 2048));
            hp::wgmma_m64n128k16_bf16_rs(dka, da[kk],
                                         hp::desc_advance(bq, kk * 2048));
          } else {
            hp::wgmma_m64n64k16_bf16_rs(dva, pa[kk],
                                        hp::desc_advance(bdo, kk * 2048));
            hp::wgmma_m64n64k16_bf16_rs(dka, da[kk],
                                        hp::desc_advance(bq, kk * 2048));
          }
        }
        hp::wgmma_commit();

        // dSᵀ into shared memory (row = kv, 128 bytes of q), chunk j of
        // row r at j ^ (r % 8): the 128-byte swizzle the descriptor reads
        unsigned char* sds = sdS + (it & 1) * DS_BYTES;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 64 * c + 16 * warp + g + 8 * (r & 1);
            const int chunk = 2 * kk + (r >> 1);
            *reinterpret_cast<uint32_t*>(
                sds + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * t4) =
                da[kk][r];
          }
        hp::fence_proxy_async();
        if constexpr (D == 128) hp::named_bar_sync(1, 256);   // both halves
        else hp::named_bar_sync(2 + c, 128);

        // dQ (this consumer's part) = dS·K: 64 q x 64 d
        float dqa[32];
        const uint64_t ads = hp::desc_sw128(sds + ds_off, QBOX, 1024);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQ_STEPS; ++kk)
          hp::wgmma_m64n64k16_bf16_ss<1, 1>(
              dqa, hp::desc_advance(ads, kk * 2048),
              hp::desc_advance(dqb_desc, kk * 2048), kk > 0);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(dva);
        hp::fence_regs(dka);
        hp::fence_regs(dqa);
        if (tid == 0) hp::mbar_arrive(&empty[s]);    // Q, dO, lse read

        // dQ out, staged in shared memory once the last tile's reduce-add
        // has read it, then added into dq by one TMA reduce-add through its
        // tensor map (rows past Sq are left alone). D 128: the consumers'
        // 64-column halves side by side, one contiguous (64 q, 128 d) tile;
        // D 64: each consumer's own (64 q, 64 d) part over its kv rows
        // (summing the two first costs more than the second add)
        float* tile = sdQ + (D == 128 ? 0 : c * WQ * 64);
        const int bar_id = D == 128 ? 1 : 2 + c;
        const bool issuer = tid == 0 && (D == 64 || c == 0);
        if (issuer) hp::bulk_wait_read<0>();
        hp::named_bar_sync(bar_id, D == 128 ? 256 : 128);
        float* dqrow = tile + (16 * warp + g) * D + (D == 128 ? 64 * c : 0)
            + 2 * t4;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(dqrow + 8 * h * D + 8 * jb) =
                make_float2(dqa[4 * jb + 2 * h], dqa[4 * jb + 2 * h + 1]);
        hp::fence_proxy_async();
        hp::named_bar_sync(bar_id, D == 128 ? 256 : 128);
        if (issuer) {
          hp::tma_reduce_add_3d(&map_dq, tile, 0, q0, bh);
          hp::bulk_commit();
        }
      }
      if (n_q > 0 && tid == 0) hp::mbar_arrive(empty_kv);  // K, V read

      // dK, dV of this consumer's 64 rows (zero where no q row sees them)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = kr0 + 16 * warp + g + 8 * h;
        if (row >= Sk) continue;
        bf16* dkr = dk + ((size_t)bh * Sk + row) * D;
        bf16* dvr = dv + ((size_t)bh * Sk + row) * D;
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd) {
          *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * jd + 2 * t4) =
              __floats2bfloat162_rn(dka[4 * jd + 2 * h],
                                    dka[4 * jd + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * jd + 2 * t4) =
              __floats2bfloat162_rn(dva[4 * jd + 2 * h],
                                    dva[4 * jd + 2 * h + 1]);
        }
      }
    }
    if (tid == 0) hp::bulk_wait<0>();        // the last reduce-add done
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 float* dq, void* dk, void* dv, int BH, int Sq, int Sk,
                 float scale, int causal, cudaStream_t stream) {
  if (Sq == 0) {   // no q row: dk and dv are zero, dq is empty
    const size_t bytes = (size_t)BH * Sk * D * sizeof(bf16);
    cudaError_t e = cudaMemsetAsync(dk, 0, bytes, stream);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, bytes, stream);
    return static_cast<int>(e);
  }
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
        | reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)
        | reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(delta)
        | reinterpret_cast<uintptr_t>(dq)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // (D, S, BH) maps: a box past the end of one head zero-fills instead of
  // reading the next head's rows (and a reduce-add past it into dq writes
  // nothing); lse and delta as (BH·Sq) rows
  CUtensorMap mq, mk, mv, mdo, ml, mdl, mdq;
  const cuuint32_t qbox[3] = {64, WQ, 1};
  const cuuint32_t kbox[3] = {64, WKV, 1};
  const cuuint64_t dq_[3] = {(cuuint64_t)D, (cuuint64_t)Sq, (cuuint64_t)BH};
  const cuuint64_t dkv[3] = {(cuuint64_t)D, (cuuint64_t)Sk, (cuuint64_t)BH};
  const cuuint64_t sq[2] = {(cuuint64_t)D * 2, (cuuint64_t)Sq * D * 2};
  const cuuint64_t skv[2] = {(cuuint64_t)D * 2, (cuuint64_t)Sk * D * 2};
  const cuuint64_t drow[1] = {(cuuint64_t)BH * Sq};
  const cuuint32_t rbox[1] = {LD_N};
  const auto BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = hp::make_map(&mq, BF, 3, q, dq_, sq, qbox);
  if (err == 0) err = hp::make_map(&mdo, BF, 3, dout, dq_, sq, qbox);
  if (err == 0) err = hp::make_map(&mk, BF, 3, k, dkv, skv, kbox);
  if (err == 0) err = hp::make_map(&mv, BF, 3, v, dkv, skv, kbox);
  if (err == 0)
    err = hp::make_map(&ml, F32, 1, lse, drow, skv, rbox,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0)
    err = hp::make_map(&mdl, F32, 1, delta, drow, skv, rbox,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  const cuuint64_t sdq[2] = {(cuuint64_t)D * 4, (cuuint64_t)Sq * D * 4};
  const cuuint32_t dqbox[3] = {D, WQ, 1};
  if (err == 0)
    err = hp::make_map(&mdq, F32, 3, dq, dq_, sdq, dqbox,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  auto kern = flash_bwd_wgmma<D>;
  constexpr int smem = wgmma_smem_bytes<D>();
  static bool configured = false;   // the attribute is per kernel, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int items = BH * (((Sk + WKV - 1) / WKV + 1) / 2);
  const int grid = min(items, hp::sm_count());
  kern<<<grid, WT, smem, stream>>>(mq, mk, mv, mdo, ml, mdl, mdq,
                                   static_cast<bf16*>(dk),
                                   static_cast<bf16*>(dv), BH, Sq, Sk, scale,
                                   causal);
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
// into it); dk/dv like k. D <= 128. bf16 at D 64 or 128 runs the TMA/wgmma
// kernel (every pointer 16-byte aligned, else cudaErrorInvalidValue), f32
// and bf16 at any other D the FMA kernel. Returns cudaGetLastError()
// after the launch.
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
      return launch_wgmma<128>(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                               Sq, Sk, scale, causal, s);
    if (D == 64)
      return launch_wgmma<64>(q, k, v, dout, lse, delta, dq, dk, dv, BH, Sq,
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

// dynamic shared memory a block of the TMA/wgmma kernel takes at head dim
// D (64 or 128), in bytes
extern "C" int flash_attention_bwd_smem_bytes(int D) {
  return D == 64 ? wgmma_smem_bytes<64>() : wgmma_smem_bytes<128>();
}
