// int8 x int8 -> int32 matmul with the dequant epilogue, for Hopper
// (sm_90a): out[m, n] = f32(sum_k xq[m, k] * wq[k, n]) * (xs * ws[n])
// (+ b[n]), cast to the output dtype; optionally after quantizing the
// activations (x in bf16 or f32, one scale for the whole tensor:
// xs = max(max|x|, 1e-8) / 127, xq = round(x / xs) clipped to ±127, round
// half to even, all in f32; a NaN is left out of the abs-max and makes
// its own row's scale NaN, so it reaches that row of the output and no
// other: a poisoned batch row stays in its row).
//
// Replaces: paddle_tpu/ops/int8_matmul.py `_int8_kernel` (launched by
// `_int8_matmul_2d`, pallas_call at :92) and the quantization of
// `dynamic_int8_matmul` (:159) in front of it. Same contract: int32
// accumulation, then in f32 `acc * (xscale * wscale[n]) + bias`, then the
// cast. xs is one scale per tensor or one per row (the TPU wrapper sends
// per-row scales to XLA; here the kernel takes both). Any M, K and N: the
// ragged edges are masked in the kernel, where the TPU wrapper sends K or
// N without a 128 divisor to XLA.
//
// What bounds it on an H100: on the decode path M is the batch (1-8 rows)
// and K x N a weight matrix (up to 2048 x 8192 = 16.8 MB), so the product
// does 2*M ops per weight byte: it streams the int8 weights once, and the
// bound is their bytes over 3.35 TB/s (5.0 µs at 16.8 MB).
//
// Design: one launch per product (two with the quantization), each
// weight byte read once.
// - int8_mm: a block (256 threads) owns 128 columns and 8 rows of the
//   output and a range of K. The K ranges of one column tile are the
//   blocks of one thread-block cluster (up to 8): the most splits whose
//   clusters the card holds in one wave (cudaOccupancyMaxActiveClusters).
// - Weights stream through an 8-stage ring of (64 k x 128 n) tiles in
//   shared memory by 16-byte cp.async copies (56 KB in flight a block),
//   16-byte chunks swizzled so that a warp's reads meet no bank conflict;
//   a ragged or unaligned edge is zero-filled. The activations of the
//   block's K range wait in shared memory as int8 k-quads, [quad][row].
// - Per 32-deep step a warp (its k half, 32 of the columns) transposes
//   4 x 4 byte blocks of the tile with byte permutes into k-quads of one
//   column each, which are the B fragments of mma.sync m16n8k32 (int8 in,
//   int32 sums; rows 8-15 of the A fragment zero): four products a step.
// - The warps' int32 sums meet in the block's shared memory; after a
//   cluster barrier each block of the cluster finishes a slice of the
//   tile from every block's sums (distributed shared memory loads) with
//   the dequant epilogue. No workspace, memset or global atomic. int32
//   sums are exact in any order and the epilogue is built with
//   -fmad=false, so the output is bit-identical to the plain version's.
// - With quantization, int8_quantize (one cluster of 8 blocks, a slice
//   of x each, their maxima exchanged in distributed shared memory) takes
//   the abs-max, the scale and the codes once per call (a true division,
//   __fdiv_rn, and rintf, as the plain version) into a scratch buffer;
//   int8_mm is launched as its programmatic dependent, so its weight
//   loads go out while the codes are made, and it waits for them
//   (griddepcontrol) before it reads the activations.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;              // threads a block: 8 warps
constexpr int BN = 128;              // output columns a block
constexpr int MT = 8;                // output rows a block
constexpr int BKS = 64;              // k rows a stage
constexpr int S = 8;                 // ring stages
constexpr int STAGE = BKS * BN;      // bytes a stage
constexpr int XK = 1024;             // k a pass of staged activations
constexpr int CL_MAX = 8;            // blocks a cluster (portable limit)
constexpr int SMEM = S * STAGE + XK * MT + MT * BN * 4;
constexpr int QT = 256;              // threads a quantizing block
constexpr int QB = 8;                // quantizing blocks: one cluster

struct Args {
  const int8_t* x;     // (M, K)
  const int8_t* w;     // (K, N) row-major
  const float* xs;     // 1 or M scales
  const float* ws;     // (N)
  const float* b;      // (N) or null
  void* out;           // (M, N), f32 or bf16
  int xs_per_row;
  int out_bf16;
  int x_vec;           // K % 4 == 0 and x 4-byte aligned: a word a load
  int dependent;       // x comes from the kernel launched before this one
  int M, K, N;
  int kc;              // K a block
};

// byte offset of (row r, byte c) in a stage: 16-byte chunks swizzled by
// r / 4 so that the 4 k rows a warp reads at once fall in distinct banks
__device__ __forceinline__ int swz(int r, int c) {
  return r * BN + (((c >> 4) ^ (((r >> 2) & 3) << 1)) << 4) + (c & 15);
}

// rows [k0, min(k0 + BKS, ke)) x columns [n0, n0 + BN) of w into dst,
// zero outside; VEC: 16-byte cp.async copies (N % 16 == 0, aligned w)
template <bool VEC>
__device__ __forceinline__ void load_stage(unsigned char* dst,
                                           const Args& p, int k0, int ke,
                                           int n0) {
  for (int ch = threadIdx.x; ch < STAGE / 16; ch += NT) {
    const int r = ch / (BN / 16), c = (ch % (BN / 16)) * 16;
    const int k = k0 + r, n = n0 + c;
    if constexpr (VEC) {
      const bool in = k < ke && n < p.N;
      const int8_t* src = p.w + (in ? (size_t)k * p.N + n : 0);
      ptt::cp_async_16(dst + swz(r, c), src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[swz(r, c + j)] = (k < ke && n + j < p.N)
            ? static_cast<unsigned char>(p.w[(size_t)k * p.N + n + j]) : 0;
    }
  }
}

// bytes k .. k+3 of row r of x as one word, zero at and past ke
__device__ __forceinline__ uint32_t load4(const Args& p, int r, int k,
                                          int ke) {
  const int8_t* x = p.x + (size_t)r * p.K + k;
  if (p.x_vec && k + 3 < ke) return *reinterpret_cast<const uint32_t*>(x);
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (k + e < ke) w |= static_cast<uint32_t>(static_cast<uint8_t>(x[e]))
                         << (8 * e);
  return w;
}

// 4 x 4 byte transpose: in, 4 words of rows k..k+3 (byte j: column j);
// out[j], column j's k-quad (byte i: row k+i)
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// d (16 x 8 s32) += a (16 x 32 s8, rows 8-15 zero) · b (32 x 8 s8)
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a2,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// the cluster barrier in two halves, so that work can go between them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 2) int8_mm(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  uint32_t* xq = reinterpret_cast<uint32_t*>(smem + S * STAGE);  // [quad][row]
  int* red = reinterpret_cast<int*>(xq + XK / 4 * MT);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * MT;
  const int kb = min(rank * p.kc, p.K), ke = min(kb + p.kc, p.K);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  for (int i = tid; i < MT * BN; i += NT) red[i] = 0;

  auto prologue = [&](int p0, int pe) {   // a pass's first stages
    const int nst = (pe - p0 + BKS - 1) / BKS;
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < nst) load_stage<VEC>(ring + s * STAGE, p, p0 + s * BKS, pe, n0);
      ptt::cp_async_commit();
    }
  };
  // a pass's activations, k-quads [quad][row], zero past M and pe: item
  // i = i0 + j·NT + tid of a batch is row i / QL, quad i % QL; a thread's
  // 8 loads of a batch go out together
  auto load_batch = [&](int i0, int p0, int pe, int QL, uint32_t (&w)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * NT + tid, m = i / QL;
      w[j] = i < MT * QL && m0 + m < p.M
          ? load4(p, m0 + m, p0 + 4 * (i % QL), pe) : 0u;
    }
  };
  auto store_batch = [&](int i0, int QL, const uint32_t (&w)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * NT + tid;
      if (i < MT * QL) xq[(i % QL) * MT + i / QL] = w[j];
    }
  };
  auto quads = [](int p0, int pe) {    // a pass's k-quads, whole stages
    return (pe - p0 + BKS - 1) / BKS * (BKS / 4);
  };

  // the decode case (the block's K range one pass of one batch): the
  // activations' loads go out once, before anything waits for them and,
  // unless they come from the quantizing kernel this one was launched
  // behind (then after it), before the weights' first stages
  const int QL0 = quads(kb, min(kb + XK, ke));
  const bool one_read = ke - kb <= XK && MT * QL0 <= 8 * NT;
  uint32_t w[8];
  if (one_read && !p.dependent) load_batch(0, kb, ke, QL0, w);
  if (kb < ke) prologue(kb, min(kb + XK, ke));
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (one_read && p.dependent) load_batch(0, kb, ke, QL0, w);

  // acc[e]: the 16 x 8 s32 tile e of the warp's 32 columns, rows 0-7 live
  int acc[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[e][j] = 0;
  const int g = lane / 4, t = lane % 4;          // fragment coordinates
  const int ks = warp / 4, cgp = warp % 4;       // k half, column group

  for (int p0 = kb; p0 < ke; p0 += XK) {
    const int pe = min(p0 + XK, ke);
    const int nst = (pe - p0 + BKS - 1) / BKS;
    if (p0 != kb) {
      __syncthreads();                 // the last pass is done with both
      prologue(p0, pe);
    }
    const int QL = quads(p0, pe);
    if (one_read) {
      store_batch(0, QL, w);
    } else {
      for (int i0 = 0; i0 < MT * QL; i0 += 8 * NT) {
        load_batch(i0, p0, pe, QL, w);
        store_batch(i0, QL, w);
      }
    }
    for (int st = 0; st < nst; ++st) {
      ptt::cp_async_wait<S - 2>();     // stage st has landed
      __syncthreads();                 // ... for all, and st - 1 is read
      if (st + S - 1 < nst)
        load_stage<VEC>(ring + ((st + S - 1) % S) * STAGE, p,
                        p0 + (st + S - 1) * BKS, pe, n0);
      ptt::cp_async_commit();
      const unsigned char* sw = ring + (st % S) * STAGE;
      // warp (ks, cgp): k rows 32·ks.. of the stage, columns 32·cgp..;
      // lane (g, t) transposes the 4 x 4 bytes at rows 4t.. (and
      // 16 + 4t..), columns 32·cgp + 4g..: tile e takes the columns
      // 32·cgp + 4g' + e, so each column word is lane (g, t)'s B
      uint32_t lo[4], hi[4], blo[4], bhi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 32 * ks + 4 * t + i;
        lo[i] = *reinterpret_cast<const uint32_t*>(
            sw + swz(r, 32 * cgp + 4 * g));
        hi[i] = *reinterpret_cast<const uint32_t*>(
            sw + swz(r + 16, 32 * cgp + 4 * g));
      }
      transpose4(lo, blo);
      transpose4(hi, bhi);
      const int q = st * (BKS / 4) + 8 * ks + t;   // the pass's k-quad
      const uint32_t a0 = xq[q * MT + g], a2 = xq[(q + 4) * MT + g];
#pragma unroll
      for (int e = 0; e < 4; ++e) mma_s8(acc[e], a0, a2, blo[e], bhi[e]);
    }
    ptt::cp_async_wait<0>();
  }

  // the warps' sums in this block's shared memory (row g, tile columns
  // 2t and 2t + 1 of tile e), then the cluster's: each block finishes a
  // slice of the tile from all the blocks' sums
  __syncthreads();                     // red's zeros are everyone's
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    atomicAdd(&red[g * BN + 32 * cgp + 8 * t + e], acc[e][0]);
    atomicAdd(&red[g * BN + 32 * cgp + 8 * t + 4 + e], acc[e][1]);
  }
  cluster.sync();
  const int CL = gridDim.y;            // the cluster is (1, CL, 1)
  for (int e = rank * NT + tid; e < MT * BN; e += CL * NT) {
    const int row = m0 + e / BN, n = n0 + e % BN;
    if (row >= p.M || n >= p.N) continue;
    int part[CL_MAX];                  // the cluster's loads, all at once
#pragma unroll
    for (int r = 0; r < CL_MAX; ++r)
      part[r] = r < CL ? cluster.map_shared_rank(red, r)[e] : 0;
    int sum = 0;
#pragma unroll
    for (int r = 0; r < CL_MAX; ++r) sum += part[r];
    const float xs = p.xs[p.xs_per_row ? row : 0];
    float o = __int2float_rn(sum) * (xs * p.ws[n]);
    if (p.b != nullptr) o = o + p.b[n];
    const size_t oi = (size_t)row * p.N + n;
    if (p.out_bf16)
      static_cast<__nv_bfloat16*>(p.out)[oi] = __float2bfloat16(o);
    else
      static_cast<float*>(p.out)[oi] = o;
  }
  cluster.sync();                      // the others' sums were read
}

// the activations' quantization by one cluster of QB blocks, each a
// slice of x: the abs-max of all of x (the slices' maxima exchanged in
// distributed shared memory; a NaN or inf is left out), the scale
// max(amax, 1e-8) / 127, then round(x / scale) clipped to ±127. The
// scale is written once a row of K (rows r ≡ b mod QB to block b): NaN
// for a row holding a NaN or inf, the tensor's scale for every other
// row, so a non-finite row reaches its own output row and no other.
template <typename XT>
__global__ void __launch_bounds__(QT) int8_quantize(const XT* __restrict__ x,
                                                    int total, int K,
                                                    int8_t* __restrict__ xq,
                                                    float* __restrict__ scale) {
  // the product kernel behind this one may start its weight loads now
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float warp_max[QT / 32];
  __shared__ float amax;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, b = blockIdx.x;
  const int chunk = (total + QB - 1) / QB;
  const int i0 = min(b * chunk, total), i1 = min(i0 + chunk, total);
  float m = 0.f;
#pragma unroll 8
  for (int i = i0 + tid; i < i1; i += QT) {
    const float v = fabsf(ptt::to_f<XT>(x[i]));
    m = fmaxf(m, isfinite(v) ? v : 0.f);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (tid % 32 == 0) warp_max[tid / 32] = m;
  __syncthreads();
  if (tid == 0) {
    float a = 0.f;
    for (int o = 0; o < QT / 32; ++o) a = fmaxf(a, warp_max[o]);
    amax = a;
  }
  cluster.sync();
  float a = 0.f;
#pragma unroll
  for (int r = 0; r < QB; ++r) a = fmaxf(a, *cluster.map_shared_rank(&amax, r));
  cluster_arrive();                    // the others' maxima are read
  const float s = __fdiv_rn(fmaxf(a, 1e-8f), 127.f);
#pragma unroll 8
  for (int i = i0 + tid; i < i1; i += QT) {
    const float q = rintf(__fdiv_rn(ptt::to_f<XT>(x[i]), s));
    xq[i] = static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
  }
  for (int r = b; r < total / K; r += QB) {
    int bad = 0;
    for (int k = tid; k < K; k += QT)
      bad |= !isfinite(ptt::to_f<XT>(x[(size_t)r * K + k]));
    bad = __syncthreads_or(bad);
    if (tid == 0) scale[r] = bad ? __int_as_float(0x7fc00000) : s;
  }
  cluster_wait();
}

// clusters of `cl` blocks of int8_mm<VEC> the card holds at once
template <bool VEC>
int active_clusters(int cl) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, cl, 1);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cl;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, int8_mm<VEC>, &cfg) != cudaSuccess)
    n = 0;
  return n;
}

// int8_mm on a grid of column tiles x K splits x row groups, each column
// tile and row group one cluster; `dependent`: launched behind the
// quantizing kernel (programmatic dependent launch)
template <bool VEC>
int launch_mm(const Args& a, bool dependent, cudaStream_t s) {
  auto kern = int8_mm<VEC>;
  static int active[CL_MAX + 1] = {0};   // clusters resident, by size
  if (active[1] == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess)   // all of the SM's shared memory: 2 blocks
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    for (int cl = 1; cl <= CL_MAX; ++cl) active[cl] = active_clusters<VEC>(cl);
    active[1] = std::max(active[1], 1);
  }
  const int tiles = (a.N + BN - 1) / BN, groups = (a.M + MT - 1) / MT;
  // the most K splits whose clusters the card holds in one wave
  int cl = std::min(CL_MAX, std::max(1, (a.K + BKS - 1) / BKS));
  while (cl > 1 && tiles * groups > active[cl]) --cl;
  Args p = a;
  p.kc = std::max(4, ((a.K + cl - 1) / cl + 3) / 4 * 4);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, cl, groups);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cl;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Args& a, bool dependent, cudaStream_t s) {
  const bool vec = a.N % 16 == 0
      && (reinterpret_cast<uintptr_t>(a.w) & 15) == 0;
  return vec ? launch_mm<true>(a, dependent, s)
             : launch_mm<false>(a, dependent, s);
}

bool bad_args(int M, int K, int N, int out_dtype) {
  return M < 0 || K < 0 || N < 0
      || (out_dtype != ptt::kF32 && out_dtype != ptt::kBF16);
}

Args args_of(const void* xq, const void* w, const float* xs, int xs_per_row,
             const float* ws, const float* b, void* out, int M, int K, int N,
             int out_dtype, bool dependent) {
  const int x_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(xq) % 4 == 0;
  return Args{static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w),
              xs, ws, b, out, xs_per_row, out_dtype == ptt::kBF16, x_vec,
              dependent, M, K, N, 0};
}

// the quantizing cluster on stream s
template <typename XT>
int launch_quantize(const void* x, int total, int K, int8_t* xq,
                    float* scale, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(QB);
  cfg.blockDim = dim3(QT);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = QB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, int8_quantize<XT>,
                                           static_cast<const XT*>(x), total,
                                           K, xq, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq (M, K) int8 and w (K, N) int8, row-major; xs f32 (1 or M values,
// xs_per_row says which); ws f32 (N); b f32 (N) or null; out (M, N) in
// `out_dtype` (0 f32, 1 bf16). One launch; returns the CUDA error.
extern "C" int int8_matmul(const void* xq, const void* w, const float* xs,
                           int xs_per_row, const float* ws, const float* b,
                           void* out, int M, int K, int N, int out_dtype,
                           void* stream) {
  if (bad_args(M, K, N, out_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  return launch(args_of(xq, w, xs, xs_per_row, ws, b, out, M, K, N,
                        out_dtype, false),
                false, static_cast<cudaStream_t>(stream));
}

// The same product of x (M, K) in `x_dtype` (0 f32, 1 bf16), quantized
// per tensor first: xq_buf (M, K) int8 and scale_buf (M) f32 are scratch
// for the codes and the scale (a row's copy, NaN where the row holds a
// NaN). Two launches (the quantizing cluster, then the product as its
// programmatic dependent); returns the CUDA error.
extern "C" int int8_matmul_quantized(const void* x, int x_dtype,
                                     void* xq_buf, float* scale_buf,
                                     const void* w, const float* ws,
                                     const float* b, void* out, int M, int K,
                                     int N, int out_dtype, void* stream) {
  if (bad_args(M, K, N, out_dtype)
      || (x_dtype != ptt::kF32 && x_dtype != ptt::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq_buf);
  const int e = x_dtype == ptt::kBF16
      ? launch_quantize<__nv_bfloat16>(x, M * K, K, q, scale_buf, s)
      : launch_quantize<float>(x, M * K, K, q, scale_buf, s);
  if (e) return e;
  return launch(args_of(q, w, scale_buf, 1, ws, b, out, M, K, N, out_dtype,
                        true),
                true, s);
}

// dynamic shared memory a block of the product takes, in bytes
extern "C" int int8_matmul_smem_bytes() { return SMEM; }
