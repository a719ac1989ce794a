// Paged-attention decode for Hopper (sm_90a): one query per slot attends
// over that slot's K/V, scattered over a shared block pool and named, in
// order, by the slot's block table.
//
// Replaces: paddle_tpu/ops/paged_attention.py `_decode_kernel` (launched
// by `_paged_decode`, pallas_call at :160). Same contract: positions
// >= lengths[b] are masked, f32 online softmax across blocks, f32
// accumulator, probabilities rounded to v's dtype before P·V, and a zero
// output where nothing was attended (l == 0).
//
// Layout. The engine's pool is (n_blocks, L, nh, bs, hd) for all layers
// at once; the kernel takes the whole contiguous pool plus the layer
// index, so no per-layer slice is ever copied (the JAX step copies one
// with jnp.take on every layer of every tick). The K (or V) tile of one
// (pool block, layer, head) is bs·hd contiguous elements: 4 KB in bf16
// at bs 16, hd 128.
//
// What bounds it on an H100: memory. A tick reads each live K/V row once
// (2·len·nh·hd elements per slot) and does 4 operations per element, far
// below the card's ~295 operations per byte, so the bound is the live
// K/V bytes over 3.35 TB/s. Reaching it needs many bytes in flight
// across the whole card, while a decode batch has few (slot, head) pairs
// and ragged lengths.
//
// Design: one launch. The blocks of one (slot, head) form a thread-block
// cluster of CL (<= 8) blocks; grid (CL, nh, B).
// - Work follows the live length: the slot's ceil(len / bs) live pool
//   blocks are divided evenly over the cluster's blocks, so a block with
//   none issues no copy (it only joins the merge). Only live blocks are
//   ever read, so `ragged` cannot change the output.
// - One producer thread walks the block's share of the table and issues
//   a bulk copy (hopper.cuh bulk_load, no tensor map; evict-first in L2,
//   since the K/V is read once a tick) of each K and V tile into a ring of
//   S stages (32 KB in all; six blocks an SM) in shared memory; the
//   copies of the next tiles fly while earlier ones are reduced.
// - Four consumer warps, two to a tile: the pairs take alternate tiles,
//   and a warp takes bs/2 key rows of its tile. A lane takes hd/32 dims
//   of a row from shared memory (a warp reads whole rows, no bank
//   conflict), and the warp's bs/2 partial dot products are reduced
//   together by a transposing butterfly (bs/2 - 1 + 5 - log2(bs/2)
//   shuffles for all of them); the lane holding a key's score takes its
//   exponential, and the probabilities are broadcast for P·V. Each warp
//   keeps its own online-softmax state (m, l, acc) over its keys and
//   releases the stage to the producer through an mbarrier.
// - The warps' states merge in shared memory, and each block writes its
//   (m, l, acc) into rank 0's shared memory (distributed shared memory)
//   between the two halves of one cluster barrier; the others then leave,
//   and rank 0 writes the output. No scratch in device memory and no
//   second kernel. (A variant that split the live tiles of all pairs
//   evenly over one wave of blocks and merged split pairs through an
//   arrival counter in device memory measured slower: PERF.md.)
// - A pool whose K or V base is not 16-byte aligned (a view with an
//   offset) cannot take bulk copies: the producer warp then copies the
//   tiles element by element into the same ring.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;
namespace hp = ptt::hopper;

namespace {

constexpr int NW = 4;                  // consumer warps a block
constexpr int NT = (NW + 1) * 32;      // + one producer warp
constexpr int CL_MAX = 8;              // blocks a cluster (portable limit)
constexpr int RING_BYTES = 32 * 1024;  // the ring's shared memory a block
constexpr int MIN_BLOCKS = 6;          // blocks an SM holds (caps registers)
constexpr int WPT = 2;                 // consumer warps sharing a tile
constexpr int G = NW / WPT;            // tiles the consumers take at once

// ring stages of (K tile, V tile) pairs of `pair_bytes` each: as many as
// RING_BYTES holds, 2 to 8, a multiple of G (so that a stage always
// goes to the same group of consumers, whose barrier phases then follow
// one another)
__host__ __device__ constexpr int ring_stages(int pair_bytes) {
  const int s = RING_BYTES / pair_bytes;
  const int c = (s < 2 ? 2 : s > 8 ? 8 : s) / G * G;
  return c > 0 ? c : G;
}

__host__ __device__ constexpr int smem_of(int hd, int bs, int elt) {
  return ring_stages(2 * bs * hd * elt) * 2 * bs * hd * elt;
}

// max that keeps a NaN (fmaxf returns the other operand): a NaN score
// or softmax state then reaches the output, as it does through the plain
// version's softmax, so a poisoned slot reads non-finite. Equal to fmaxf
// on every other input.
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" :: "l"(p));
}

// the cluster barrier in two halves, so that work can go between them
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Params {
  const void* q;          // (B, nh, hd)
  const void* kp;         // (n_blocks, L, nh, bs, hd)
  const void* vp;
  const int* tables;      // (B, W)
  const int* lengths;     // (B,)
  void* o;                // (B, nh, hd)
  int nh, W, L, layer, n_blocks;
  int bulk;               // pool bases 16-byte aligned: bulk copies
  float scale;
};

template <typename T, int N> struct Vec;   // N contiguous T in one load
template <> struct Vec<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Vec<__nv_bfloat16, 2> { using type = unsigned int; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<float, 2> { using type = float2; };

// N contiguous elements of shared memory at p (aligned to N elements)
// into f32
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&out)[N]) {
  if constexpr (N == 2 || N == 4) {
    typename Vec<T, N>::type raw =
        *reinterpret_cast<const typename Vec<T, N>::type*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = ptt::to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = ptt::to_f(p[i]);
  }
}

// sums of the K partial values of every lane of the warp: afterwards
// lane l holds the whole sum of value l / (32 / K). Each step halves the
// values a lane keeps and sends the other half to its partner.
template <int K>
__device__ __forceinline__ float reduce_keys(float (&v)[K], int lane) {
#pragma unroll
  for (int h = K / 2, o = 16; h >= 1; h /= 2, o /= 2) {
    const bool low = (lane & o) == 0;
#pragma unroll
    for (int k = 0; k < h; ++k) {
      const float send = low ? v[k + h] : v[k];
      const float keep = low ? v[k] : v[k + h];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float x = v[0];
#pragma unroll
  for (int o = 16 / K; o >= 1; o /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD, int BS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
paged_decode(const Params p) {
  constexpr int DPL = HD / 32;         // head dims a lane
  constexpr int TILE = BS * HD;        // elements of one K or V tile
  constexpr int KPW = BS / WPT;        // key rows a consumer warp per tile
  constexpr int S = ring_stages(2 * TILE * sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);             // [S][K, V][TILE]
  __shared__ uint64_t full[S], empty[S];
  __shared__ float w_m[NW], w_l[NW];
  __shared__ __align__(16) float w_acc[NW][HD];
  __shared__ float parts[CL_MAX][HD + 2];   // rank 0: each block's (m, l, acc)

  // phase 1 of the cluster barrier: every block has started (so that
  // rank 0's shared memory exists) by the time the merge waits on it
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = p.lengths[b];
  // issued beside the length's load, so that neither waits on the other:
  // the slot's table row into L1 (the producer reads it) and q (the
  // consumers keep it in registers)
  float qr[DPL];
  if (warp == NW) {
    for (int j = lane * 32; j < p.W; j += 32 * 32)
      prefetch_l1(p.tables + (size_t)b * p.W + j);
  } else {
    const T* q = static_cast<const T*>(p.q) + ((size_t)b * p.nh + h) * HD;
#pragma unroll
    for (int d = 0; d < DPL; ++d) qr[d] = ptt::to_f(q[lane * DPL + d]);
  }
  const int n_live = len <= 0 ? 0 : min((len + BS - 1) / BS, p.W);
  const int first = rank * n_live / CL;              // this block's share
  const int n = (rank + 1) * n_live / CL - first;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      hp::mbar_init(&full[i], p.bulk ? 1 : 32);
      hp::mbar_init(&empty[i], WPT);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp == NW) {
    // producer: the K and V tiles of the share, S ahead of the consumers
    const T* kp = static_cast<const T*>(p.kp);
    const T* vp = static_cast<const T*>(p.vp);
    const size_t blk_stride = (size_t)p.L * p.nh * TILE;
    const size_t head_off = ((size_t)p.layer * p.nh + h) * TILE;
    const int* trow = p.tables + (size_t)b * p.W + first;
    // bulk copies: lane 0 alone; element copies: the whole warp
    const int todo = p.bulk && lane != 0 ? 0 : n;
    const uint64_t pol = hp::l2_evict_first();
    for (int i = 0; i < todo; ++i) {
      const int st = i % S;
      if (i >= S) hp::mbar_wait(&empty[st], (i / S - 1) & 1);
      const int blk = min(max(trow[i], 0), p.n_blocks - 1);
      const size_t off = (size_t)blk * blk_stride + head_off;
      T* dst = ring + (size_t)st * 2 * TILE;
      if (p.bulk) {
        hp::mbar_arrive_expect_tx(&full[st], 2 * TILE * sizeof(T));
        hp::bulk_load(dst, kp + off, TILE * sizeof(T), &full[st], pol);
        hp::bulk_load(dst + TILE, vp + off, TILE * sizeof(T), &full[st], pol);
      } else {
        for (int e = lane; e < TILE; e += 32) {
          dst[e] = kp[off + e];
          dst[TILE + e] = vp[off + e];
        }
        hp::mbar_arrive(&full[st]);
      }
    }
  } else {
    // consumers: WPT warps a tile, tiles g, g + G, ... to group g; warp
    // wk of a group takes key rows [wk·KPW, wk·KPW + KPW) of each
    const int g = warp / WPT, wk = warp % WPT;
    const int key = lane / (32 / KPW);   // the key a lane's sum ends on
    float acc[DPL];
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
    float m = -INFINITY, l = 0.f;
    for (int i = g; i < n; i += G) {
      const int st = i % S;
      hp::mbar_wait(&full[st], (i / S) & 1);
      const T* kt = ring + (size_t)st * 2 * TILE + wk * KPW * HD
          + lane * DPL;
      const T* vt = kt + TILE;
      float part[KPW];
#pragma unroll
      for (int k = 0; k < KPW; ++k) {
        float kr[DPL];
        load_row<T, DPL>(kt + k * HD, kr);
        part[k] = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) part[k] = fmaf(qr[d], kr[d], part[k]);
      }
      float sc = reduce_keys<KPW>(part, lane) * p.scale;
      if ((first + i) * BS + wk * KPW + key >= len) sc = -INFINITY;
      float mx = sc;                   // max over the warp's keys
#pragma unroll
      for (int o = 16; o >= 32 / KPW; o /= 2)
        mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (mx != -INFINITY) {           // the warp has a live key here
        const float m_new = max_nan(m, mx);
        const float alpha = expf(m - m_new);
        const float pk = sc == -INFINITY ? 0.f : expf(sc - m_new);
        float rs = pk;
#pragma unroll
        for (int o = 16; o >= 32 / KPW; o /= 2)
          rs += __shfl_xor_sync(0xffffffffu, rs, o);
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[d] *= alpha;
#pragma unroll
        for (int k = 0; k < KPW; ++k) {
          const float pr = ptt::round_to<T>(
              __shfl_sync(0xffffffffu, pk, k * (32 / KPW)));
          if (pr == 0.f) continue;     // masked (or underflowed): adds 0
          float vr[DPL];
          load_row<T, DPL>(vt + k * HD, vr);
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[d] = fmaf(pr, vr[d], acc[d]);
        }
        l = alpha * l + rs;
        m = m_new;
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[st]);
    }
    if (lane == 0) {
      w_m[warp] = m;
      w_l[warp] = l;
    }
#pragma unroll
    for (int d = 0; d < DPL; ++d) w_acc[warp][lane * DPL + d] = acc[d];
  }
  __syncthreads();

  // the block's state (its warps' merged) into rank 0's shared memory
  cluster_wait();                      // phase 1: rank 0 has started
  {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = max_nan(M, w_m[w]);
    float c[NW], Ls = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      c[w] = w_m[w] == -INFINITY ? 0.f : expf(w_m[w] - M);
      Ls += w_l[w] * c[w];
    }
    float* dst = cluster.map_shared_rank(&parts[rank][0], 0);
    if (M != -INFINITY) {
      for (int d = tid; d < HD; d += NT) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) a = fmaf(w_acc[w][d], c[w], a);
        dst[2 + d] = a;
      }
    }
    if (tid == 0) {
      dst[0] = M;
      dst[1] = Ls;
    }
  }
  cluster_arrive();                    // phase 2: the states are written
  if (rank != 0) return;
  cluster_wait();

  // rank 0: the output from every block's state
  for (int d = tid; d < HD; d += NT) {
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < CL_MAX; ++r)
      if (r < CL) M = max_nan(M, parts[r][0]);
    float Ls = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < CL_MAX; ++r) {
      if (r < CL && parts[r][0] != -INFINITY) {
        const float c = expf(parts[r][0] - M);
        Ls += parts[r][1] * c;
        a = fmaf(parts[r][2 + d], c, a);
      }
    }
    const float li = Ls == 0.f ? 1.f : Ls;
    static_cast<T*>(p.o)[((size_t)b * p.nh + h) * HD + d] =
        ptt::from_f<T>(a / li);
  }
}

// blocks a cluster for B·nh (slot, head) pairs and tables of width W: up
// to 8, no more than W, and halved while half of it still gives every SM
// four blocks
int cluster_of(int B, int nh, int W) {
  int cl = CL_MAX;
  while (cl > 1
         && (cl > W || (long long)B * nh * (cl / 2) >= 4LL * hp::sm_count()))
    cl /= 2;
  return cl;
}

// launches the kernel on B slots, or with `resident` set only counts
// into it the clusters of that launch the card holds at once
template <typename T, int HD, int BS>
int launch(const Params& p, int B, cudaStream_t s, int* resident) {
  auto kern = paged_decode<T, HD, BS>;
  constexpr int SMEM = smem_of(HD, BS, sizeof(T));
  static unsigned ready = 0;           // devices the attribute is set on
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(ready & (1u << (dev & 31)))) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e == cudaSuccess)   // as many blocks an SM as shared memory holds
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready |= 1u << (dev & 31);
  }
  const int cl = cluster_of(B, p.nh, p.W);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, p.nh, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident != nullptr)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(resident, kern, &cfg));
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_bs(int bs, const Params& p, int B, cudaStream_t s, int* res) {
  switch (bs) {
    case 8: return launch<T, HD, 8>(p, B, s, res);
    case 16: return launch<T, HD, 16>(p, B, s, res);
    case 32: return launch<T, HD, 32>(p, B, s, res);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_hd(int hd, int bs, const Params& p, int B, cudaStream_t s,
              int* res = nullptr) {
  switch (hd) {
    case 32: return launch_bs<T, 32>(bs, p, B, s, res);
    case 64: return launch_bs<T, 64>(bs, p, B, s, res);
    case 128: return launch_bs<T, 128>(bs, p, B, s, res);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Blocks a cluster of one (slot, head) for B slots, nh heads and tables
// of width W (the split of each slot's live blocks).
extern "C" int paged_attention_cluster(int B, int nh, int W) {
  return cluster_of(B, nh, W);
}

// Clusters of the launch for B slots, nh heads, tables of width W, head
// dim hd, block size bs and `dtype` that the card holds at once (-1 on
// an error).
extern "C" int paged_attention_resident(int B, int nh, int hd, int bs, int W,
                                        int dtype) {
  const Params p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nh,
                 W, 1, 0, 1, 1, 1.f};
  int n = -1;
  const int e = dtype == ptt::kBF16
      ? launch_hd<__nv_bfloat16>(hd, bs, p, B, nullptr, &n)
      : launch_hd<float>(hd, bs, p, B, nullptr, &n);
  return e == 0 ? n : -1;
}

// Dynamic shared memory (the ring) a block takes at head dim hd, block
// size bs and `dtype`.
extern "C" int paged_attention_smem_bytes(int hd, int bs, int dtype) {
  return smem_of(hd, bs, dtype == ptt::kBF16 ? 2 : 4);
}

// q (B, nh, hd); kpool/vpool (n_blocks, L, nh, bs, hd) contiguous, all in
// `dtype`; tables (B, W) int32; lengths (B,) int32; o like q. Attends
// layer `layer` of the pool. hd in {32, 64, 128}, bs in {8, 16, 32}.
// One launch; returns cudaGetLastError() after it.
extern "C" int paged_attention_decode(const void* q, const void* kpool,
                                      const void* vpool, const int* tables,
                                      const int* lengths, void* o, int B,
                                      int nh, int hd, int bs, int W, int L,
                                      int layer, int n_blocks, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || nh <= 0) return 0;
  if (W <= 0 || L <= 0 || layer < 0 || layer >= L || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bulk = ((reinterpret_cast<uintptr_t>(kpool)
                     | reinterpret_cast<uintptr_t>(vpool)) & 15) == 0;
  const Params p{q, kpool, vpool, tables, lengths, o, nh, W, L, layer,
                 n_blocks, bulk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16) return launch_hd<__nv_bfloat16>(hd, bs, p, B, s);
  if (dtype == ptt::kF32) return launch_hd<float>(hd, bs, p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
