// A persistent, warp-specialised bf16 GEMM mainloop for Hopper (sm_90a)
// on hopper.cuh, with the epilogue a functor: the products of the fused
// LN-MLP backward (fused_ln_mlp.cu) are epilogues of this one loop.
//
// A kernel computes, for every BM x BN tile of an (Mdim, Ndim) output,
// up to three products acc[ACC] (+)= A·B over one depth K, then calls the
// epilogue on the f32 accumulators. Each operand is read as stored, never
// copied transposed: Prod<TA, TB, ACC> says whether A (M x K) and B
// (K x N) are K-major (the depth along the stored row: x (M, K), or w
// stored (N, K)) or MN-major (the output dimension along the row: xᵀ of
// x (K, M), or w (K, N)); the wgmma takes an MN-major operand through its
// transpose bit. A product whose ACC repeats an earlier one's adds into
// it (dlnx = dz·W1ᵀ + dzg·Wgᵀ).
//
// Shape: a persistent grid (one block an SM) walks the output tiles in
// groups of GROUP_M rows of tiles, so the blocks in flight share their A
// and B tiles in L2. A block is three warpgroups. The producer
// (registers cut to 24) has one thread keep TMA loads in flight: a stage
// is the A tile (128 x 64, 16 KB) and the B tile (BN x 64) of one 64-deep
// step, 128-byte swizzle, in a ring of as many stages as ~200 KB holds
// (8 at BN = 64, 5 at BN = 192, 4 at BN = 256), full/empty mbarriers; it
// runs on into the next tile while the consumers finish the last. Two
// consumers (registers raised to 240) each own 64 rows of the tile: per
// stage four wgmma m64nNk16 steps (two m64n128 halves at BN = 256) from shared
// memory, one commit group a stage kept in flight while the next stage's
// group is issued (wait_group 1), so the tensor cores see no gap between
// stages. A box past an edge (ragged M, N or K) zero-fills, so the sums
// are exact; the epilogue masks its stores.
//
// Layout of a stage (every tile 1024-byte aligned): a K-major operand is
// one TMA box of (64 k, rows) with 128-byte rows, consumer c's 64 rows at
// +8 KB; an MN-major operand is boxes of (64 columns, 64 k rows), 8 KB
// each, one after the other along the output dimension (consumer c's A
// columns are box c; B's LBO is the 8 KB between boxes).
#pragma once

#include "hopper.cuh"

namespace ptt {
namespace gemm90 {

namespace hp = ptt::hopper;

constexpr int BM = 128;          // output rows a tile, 64 a consumer
constexpr int BK = 64;           // depth a stage: one 128-byte bf16 row
constexpr int NT = 384;          // producer + 2 consumer warpgroups
constexpr int GROUP_M = 8;       // rows of tiles a raster group
constexpr int A_BYTES = BM * BK * 2;
constexpr int BOX = 64 * BK * 2;  // an MN-major box: 64 columns x 64 k
constexpr int EPI_BYTES = 8192;   // epilogue scratch (column sums)

// one product: acc[ACC] (+)= A·B; TA / TB: that operand is MN-major
template <int TA_, int TB_, int ACC_>
struct Prod {
  static constexpr int TA = TA_, TB = TB_, ACC = ACC_;
};
using NoProd = Prod<0, 0, -1>;

// the A and B maps of up to three products
struct Maps {
  CUtensorMap a[3];
  CUtensorMap b[3];
};

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + BN * BK * 2;
}

template <int BN>
__host__ __device__ constexpr int n_stages() {
  return (200 * 1024) / stage_bytes<BN>();
}

template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  // the ring, the epilogue scratch, the barriers, 1024 of alignment slack
  return n_stages<BN>() * stage_bytes<BN>() + EPI_BYTES
      + 2 * n_stages<BN>() * 8 + 1024;
}

// accumulator of one product: NH halves of HW floats a thread (a 64 x BN
// wgmma accumulator, two 64 x 128 halves at BN = 256; hopper.cuh has the
// layout)
template <int BN>
struct AccShape {
  static constexpr int NH = BN == 256 ? 2 : 1;
  static constexpr int HW = BN == 256 ? 64 : BN / 2;
};

// element i of half h of a consumer's accumulator: row and column within
// the tile for consumer c, thread tid of its warpgroup
__device__ __forceinline__ void acc_coord(int c, int tid, int h, int i,
                                          int& r, int& col) {
  const int warp = tid / 32, lane = tid % 32;
  r = 64 * c + 16 * warp + lane / 4 + 8 * ((i / 2) & 1);
  col = 128 * h + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
}

// tile t of the raster: GROUP_M rows of tiles at a time, down the rows
// first, so that neighbouring blocks share A's and B's tiles
__device__ __forceinline__ void tile_of(int t, int tiles_m, int tiles_n,
                                        int& m_tile, int& n_tile) {
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (t / per_group) * GROUP_M;
  const int gm = min(GROUP_M, tiles_m - first_m);
  const int in = t % per_group;
  m_tile = first_m + in % gm;
  n_tile = in / gm;
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void mma_k16(float (&d)[AccShape<BN>::HW],
                                        uint64_t da, uint64_t db,
                                        int accumulate) {
  if constexpr (BN == 64)
    hp::wgmma_m64n64k16_bf16_ss<TA, TB>(d, da, db, accumulate);
  else if constexpr (BN == 192)
    hp::wgmma_m64n192k16_bf16_ss<TA, TB>(d, da, db, accumulate);
  else
    hp::wgmma_m64n128k16_bf16_ss<TA, TB>(d, da, db, accumulate);
}

// the producer's loads of one stage: A rows m0.., B columns n0.., depth k0..
template <int BN, class P>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const CUtensorMap* ma,
                                           const CUtensorMap* mb,
                                           uint64_t* bar, int m0, int n0,
                                           int k0) {
  hp::mbar_arrive_expect_tx(bar, stage_bytes<BN>());
  if constexpr (P::TA) {
    hp::tma_load_2d(st, ma, bar, m0, k0);
    hp::tma_load_2d(st + BOX, ma, bar, m0 + 64, k0);
  } else {
    hp::tma_load_2d(st, ma, bar, k0, m0);
  }
  unsigned char* sb = st + A_BYTES;
  if constexpr (P::TB) {
#pragma unroll
    for (int b = 0; b < BN / 64; ++b)
      hp::tma_load_2d(sb + b * BOX, mb, bar, n0 + 64 * b, k0);
  } else {
    hp::tma_load_2d(sb, mb, bar, k0, n0);
  }
}

// a consumer's K loop of one product into acc (fresh: the first step
// overwrites it, else adds)
template <int BN, class P>
__device__ __forceinline__ void consume(
    float (&acc)[AccShape<BN>::NH][AccShape<BN>::HW], bool fresh,
    unsigned char* ring, uint64_t* full, uint64_t* empty, int& it, int KT,
    int c, int tid) {
  constexpr int S = n_stages<BN>();
  constexpr int NH = AccShape<BN>::NH;
  for (int kt = 0; kt < KT; ++kt, ++it) {
    const int s = it % S;
    hp::mbar_wait(&full[s], (it / S) & 1);
    unsigned char* sa = ring + s * stage_bytes<BN>();
    unsigned char* sb = sa + A_BYTES;
    // consumer c's A: rows 64c.. of a K-major box, or box c of MN-major
    const uint64_t da = hp::desc_sw128(sa + c * 8192, P::TA ? BOX : 16, 1024);
    const uint64_t db = hp::desc_sw128(sb, P::TB ? BOX : 16, 1024);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t ao = P::TA ? kk * 2048 : kk * 32;
      const uint32_t bo = P::TB ? kk * 2048 : kk * 32;
      const int accumulate = !fresh || kt > 0 || kk > 0;
#pragma unroll
      for (int h = 0; h < NH; ++h)   // 128 columns on: +128 rows or +2 boxes
        mma_k16<BN, P::TA, P::TB>(acc[h], hp::desc_advance(da, ao),
                                  hp::desc_advance(db, h * 16384 + bo),
                                  accumulate);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<1>();               // the last stage's products are done
    if (kt > 0 && tid == 0) hp::mbar_arrive(&empty[(it - 1) % S]);
  }
  hp::wgmma_wait<0>();
  if (KT > 0 && tid == 0) hp::mbar_arrive(&empty[(it - 1) % S]);
#pragma unroll
  for (int h = 0; h < NH; ++h) hp::fence_regs(acc[h]);
}

template <int BN, int NACC, class P0, class P1, class P2, class Epi>
__global__ void __launch_bounds__(NT, 1)
gemm_ws(const __grid_constant__ Maps maps, const Epi epi, int Mdim, int Ndim,
        int K) {
  constexpr int S = n_stages<BN>();
  constexpr int NH = AccShape<BN>::NH, HW = AccShape<BN>::HW;
  extern __shared__ unsigned char gemm_smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gemm_smem_raw) + 1023) & ~uintptr_t(1023));
  float* scratch = reinterpret_cast<float*>(ring + S * stage_bytes<BN>());
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(scratch) + EPI_BYTES);
  uint64_t* empty = full + S;

  const int tiles_m = (Mdim + BM - 1) / BM;
  const int tiles_n = (Ndim + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int KT = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 2);       // one arrival per consumer
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hp::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, nt;
        tile_of(t, tiles_m, tiles_n, mt, nt);
        const int m0 = mt * BM, n0 = nt * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % S;
          hp::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          load_stage<BN, P0>(ring + s * stage_bytes<BN>(), &maps.a[0],
                             &maps.b[0], &full[s], m0, n0, kt * BK);
        }
        if constexpr (P1::ACC >= 0)
          for (int kt = 0; kt < KT; ++kt, ++it) {
            const int s = it % S;
            hp::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
            load_stage<BN, P1>(ring + s * stage_bytes<BN>(), &maps.a[1],
                               &maps.b[1], &full[s], m0, n0, kt * BK);
          }
        if constexpr (P2::ACC >= 0)
          for (int kt = 0; kt < KT; ++kt, ++it) {
            const int s = it % S;
            hp::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
            load_stage<BN, P2>(ring + s * stage_bytes<BN>(), &maps.a[2],
                               &maps.b[2], &full[s], m0, n0, kt * BK);
          }
      }
    }
  } else {
    hp::setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    float acc[NACC][NH][HW];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mt, nt;
      tile_of(t, tiles_m, tiles_n, mt, nt);
      consume<BN, P0>(acc[P0::ACC], true, ring, full, empty, it, KT, c, tid);
      if constexpr (P1::ACC >= 0)
        consume<BN, P1>(acc[P1::ACC], P1::ACC != P0::ACC, ring, full, empty,
                        it, KT, c, tid);
      if constexpr (P2::ACC >= 0)
        consume<BN, P2>(acc[P2::ACC],
                        P2::ACC != P0::ACC && P2::ACC != P1::ACC, ring, full,
                        empty, it, KT, c, tid);
      epi.template apply<BN, NACC>(acc, mt * BM, nt * BN, Mdim, Ndim, c, tid,
                                   scratch);
    }
  }
}

// a (rows, cols) row-major bf16 array as a map of (64 columns, box_rows)
// boxes; cols a multiple of 8 and a 16-byte-aligned base (TMA's rules)
inline int map_bf16(CUtensorMap* m, const void* p, int rows, int cols,
                    int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return hp::make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, dims,
                      strides, box);
}

// the maps of product i: A (M x K) stored (M, K) if K-major, else (K, M);
// B (K x N) stored (N, K) if K-major, else (K, N)
template <int BN, class P>
int map_prod(Maps& maps, int i, const void* a, const void* b, int M, int N,
             int K) {
  int err = P::TA ? map_bf16(&maps.a[i], a, K, M, 64)
                  : map_bf16(&maps.a[i], a, M, K, BM);
  if (err == 0)
    err = P::TB ? map_bf16(&maps.b[i], b, K, N, 64)
                : map_bf16(&maps.b[i], b, N, K, BN);
  return err;
}

// launch gemm_ws on a grid of min(tiles, SMs) blocks; returns the CUDA
// error
template <int BN, int NACC, class P0, class P1, class P2, class Epi>
int launch(const Maps& maps, const Epi& epi, int Mdim, int Ndim, int K,
           cudaStream_t stream) {
  auto kern = gemm_ws<BN, NACC, P0, P1, P2, Epi>;
  constexpr int smem = smem_bytes<BN>();
  static bool configured = false;   // the attribute is per kernel, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int tiles = ((Mdim + BM - 1) / BM) * ((Ndim + BN - 1) / BN);
  const int grid = min(tiles, hp::sm_count());
  kern<<<grid, NT, smem, stream>>>(maps, epi, Mdim, Ndim, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm90
}  // namespace ptt
