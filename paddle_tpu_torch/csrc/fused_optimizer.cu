// Fused AdamW and LAMB updates for Hopper (sm_90a): one launch updates
// every leaf of a bucket in place.
//
// Replaces: paddle_tpu/ops/fused_optimizer.py `_adamw_kernel` (launched by
// `adamw_flat`, pallas_call at :187) and `_lamb_kernel` (launched by
// `lamb_moments_flat`, pallas_call at :254). Same arithmetic, in the same
// order: f32 math whatever the storage dtypes; AdamW adds the classic L2
// term to the gradient before the moments, computes the step in the pure
// or the eager form, and applies the decoupled decay before the step;
// LAMB writes the moments and the direction r = m̂/(√v̂+ε) + λp in f32
// (the per-leaf trust ratio ‖p‖/‖r‖ stays outside, as in JAX). lr, bc1
// and bc2 are read from a 3-float device buffer (the TPU kernel's SMEM
// scalars), so a schedule or the step count never rebuilds or syncs.
//
// Layout. The TPU kernel updates one flat (R, 1024) buffer that XLA
// concatenates from every leaf inside the jit. In eager PyTorch that
// concatenation and the split back are real copies of p, g, m and v
// (about 4 x 5.3 GB each way at gpt_1p3b, more than the update moves).
// So the leaves stay where they are: the wrapper passes a small device
// table of (p, g, m, v, r, numel, first chunk) per leaf, and the grid
// walks fixed chunks of CHUNK elements; a block finds its chunk's leaf by
// binary search over the table and updates it in place.
//
// What bounds it on an H100: memory. Each parameter reads p, g, m, v and
// writes p, m, v (AdamW) or m, v, r (LAMB): 28 bytes per f32 parameter
// for ~15 operations, far below the card's ~20 f32 operations per byte.
// Each thread moves 4 elements of each stream per 16-byte (f32) or
// 8-byte (bf16) vector load where a leaf's pointers are aligned, scalar
// loads otherwise, with enough blocks in flight to cover the card.
//
// Skip flag. Both entry points take an optional device bool (a null
// pointer for none): when it reads true, every block returns before it
// writes, so params, moments and r stay as they were. The training
// sentinel's verdict and a future dynamic loss scale gate the update
// through it without a host read (a captured step included); the step
// gates its own beta-pow pair or count. The TPU reference selects the old
// tree after the update instead; in place, that would need a second copy
// of the params and moments.
//
// Built with -fmad=false (ops/_build.py EXTRA_FLAGS): no multiply and add
// are contracted, so each operation rounds as the plain PyTorch version's
// separate operations do, and the outputs are bit-identical to it.
#include "common.cuh"

namespace {

constexpr int NT = 256;            // threads per block
constexpr long long CHUNK = 8192;  // elements per chunk (a multiple of 4)

// one leaf of a bucket; pointers as int64, r unused by AdamW
struct Leaf {
  long long p, g, m, v, r, n, c0, pad;
};

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, l2;
  int use_l2, eager;
};

template <typename T, int N> struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<__nv_bfloat16, 4> { using type = uint2; };

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&out)[4]) {
  typename Vec<T, 4>::type raw =
      *reinterpret_cast<const typename Vec<T, 4>::type*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = ptt::to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&in)[4]) {
  typename Vec<T, 4>::type raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = ptt::from_f<T>(in[i]);
  *reinterpret_cast<typename Vec<T, 4>::type*>(p) = raw;
}

// the leaf whose chunks hold chunk c: the last i with leaves[i].c0 <= c
__device__ __forceinline__ int find_leaf(const Leaf* leaves, int n_leaves,
                                         long long c) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].c0 <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned(long long ptr, int bytes) {
  return (ptr & (bytes - 1)) == 0;
}

// AdamW on one element: the TPU kernel's op sequence
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m,
                                           float& v, float lr, float bc1,
                                           float bc2, float sbc, float decay,
                                           const Hyper& h) {
  if (h.use_l2) g = g + h.l2 * p;
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * (g * g);
  float step;
  if (h.eager)
    step = sbc * m / (sqrtf(v) + h.eps);
  else
    step = (m / bc1) / (sqrtf(v / bc2) + h.eps);
  p = p * decay - lr * step;
}

// LAMB moments and direction on one element
__device__ __forceinline__ float lamb_elem(float p, float g, float& m,
                                           float& v, float bc1, float bc2,
                                           const Hyper& h) {
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * (g * g);
  return (m / bc1) / (sqrtf(v / bc2) + h.eps) + h.wd * p;
}

template <typename TP, typename TG, typename TM, bool LAMB>
__global__ void __launch_bounds__(NT)
fused_opt_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                 long long total_chunks, const float* __restrict__ sc,
                 const bool* __restrict__ skip, Hyper h) {
  if (skip != nullptr && *skip) return;
  const float lr = sc[0], bc1 = sc[1], bc2 = sc[2];
  const float sbc = sqrtf(bc2) / bc1;     // eager form's scalar
  const float decay = 1.0f - lr * h.wd;   // decoupled decay factor
  for (long long c = blockIdx.x; c < total_chunks; c += gridDim.x) {
    const Leaf L = leaves[find_leaf(leaves, n_leaves, c)];
    TP* P = reinterpret_cast<TP*>(L.p);
    const TG* G = reinterpret_cast<const TG*>(L.g);
    TM* M = reinterpret_cast<TM*>(L.m);
    TM* V = reinterpret_cast<TM*>(L.v);
    float* R = reinterpret_cast<float*>(L.r);
    const long long start = (c - L.c0) * CHUNK;
    const long long end = min(start + CHUNK, L.n);
    const bool vec = aligned(L.p, 4 * sizeof(TP)) &&
                     aligned(L.g, 4 * sizeof(TG)) &&
                     aligned(L.m, 4 * sizeof(TM)) &&
                     aligned(L.v, 4 * sizeof(TM)) &&
                     (!LAMB || aligned(L.r, 16));
    long long i = start;
    if (vec) {
      const long long vend = start + ((end - start) & ~3LL);
      for (long long j = start + 4 * threadIdx.x; j < vend; j += 4 * NT) {
        float p[4], g[4], m[4], v[4];
        load4(P + j, p);
        load4(G + j, g);
        load4(M + j, m);
        load4(V + j, v);
        if constexpr (LAMB) {
          float r[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            r[e] = lamb_elem(p[e], g[e], m[e], v[e], bc1, bc2, h);
          *reinterpret_cast<float4*>(R + j) = make_float4(r[0], r[1], r[2],
                                                          r[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            adamw_elem(p[e], g[e], m[e], v[e], lr, bc1, bc2, sbc, decay, h);
          store4(P + j, p);
        }
        store4(M + j, m);
        store4(V + j, v);
      }
      i = vend;
    }
    // the scalar rest: a leaf's ragged tail, or an unaligned leaf
    for (long long j = i + threadIdx.x; j < end; j += NT) {
      float p = ptt::to_f(P[j]), g = ptt::to_f(G[j]);
      float m = ptt::to_f(M[j]), v = ptt::to_f(V[j]);
      if constexpr (LAMB) {
        R[j] = lamb_elem(p, g, m, v, bc1, bc2, h);
      } else {
        adamw_elem(p, g, m, v, lr, bc1, bc2, sbc, decay, h);
        P[j] = ptt::from_f<TP>(p);
      }
      M[j] = ptt::from_f<TM>(m);
      V[j] = ptt::from_f<TM>(v);
    }
  }
}

struct Args {
  const Leaf* leaves;
  int n_leaves;
  long long total_chunks;
  const float* sc;
  const bool* skip;
  Hyper h;
  int grid;
  cudaStream_t s;
};

template <typename TP, typename TG, typename TM, bool LAMB>
int launch(const Args& a) {
  fused_opt_kernel<TP, TG, TM, LAMB><<<a.grid, NT, 0, a.s>>>(
      a.leaves, a.n_leaves, a.total_chunks, a.sc, a.skip, a.h);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes (0 f32, 1 bf16) to template arguments
template <bool LAMB, typename TP, typename TG>
int by_m(int m_dt, const Args& a) {
  return m_dt == ptt::kBF16 ? launch<TP, TG, __nv_bfloat16, LAMB>(a)
                            : launch<TP, TG, float, LAMB>(a);
}

template <bool LAMB, typename TP>
int by_g(int g_dt, int m_dt, const Args& a) {
  return g_dt == ptt::kBF16 ? by_m<LAMB, TP, __nv_bfloat16>(m_dt, a)
                            : by_m<LAMB, TP, float>(m_dt, a);
}

template <bool LAMB>
int dispatch(int p_dt, int g_dt, int m_dt, const Args& a) {
  return p_dt == ptt::kBF16 ? by_g<LAMB, __nv_bfloat16>(g_dt, m_dt, a)
                            : by_g<LAMB, float>(g_dt, m_dt, a);
}

bool dtypes_ok(int p_dt, int g_dt, int m_dt) {
  return p_dt >= 0 && p_dt <= 1 && g_dt >= 0 && g_dt <= 1 && m_dt >= 0 &&
         m_dt <= 1;
}

}  // namespace

extern "C" long long fused_opt_chunk() { return CHUNK; }

// table: n_leaves Leaf records (8 int64 each) on the device, c0 the
// leaf's first chunk, in increasing order; total_chunks = sum of
// ceil(n / CHUNK). sc: device f32 [lr, bc1, bc2]. omb1/omb2 are 1 - b1 and
// 1 - b2 as the caller computed them. dtypes: 0 f32, 1 bf16 (g may be
// f32 or p's dtype; m and v share one). skip: a device bool, or null;
// true leaves everything unwritten. Updates p, m, v in place.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_adamw(const void* table, int n_leaves,
                           long long total_chunks, const float* sc,
                           const bool* skip, float b1,
                           float omb1, float b2, float omb2, float eps,
                           float wd, float l2, int use_l2, int eager,
                           int p_dt, int g_dt, int m_dt, int grid,
                           void* stream) {
  if (n_leaves <= 0 || total_chunks <= 0) return 0;
  if (!dtypes_ok(p_dt, g_dt, m_dt) || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const Leaf*>(table), n_leaves, total_chunks, sc, skip,
         Hyper{b1, omb1, b2, omb2, eps, wd, l2, use_l2, eager}, grid,
         static_cast<cudaStream_t>(stream)};
  return dispatch<false>(p_dt, g_dt, m_dt, a);
}

// As fused_adamw, for LAMB: updates m and v in place and writes r (f32,
// at each leaf's r pointer); p is read only. lr in sc is unused. A true
// skip leaves m, v and r unwritten.
extern "C" int fused_lamb(const void* table, int n_leaves,
                          long long total_chunks, const float* sc,
                          const bool* skip, float b1,
                          float omb1, float b2, float omb2, float eps,
                          float wd, int p_dt, int g_dt, int m_dt, int grid,
                          void* stream) {
  if (n_leaves <= 0 || total_chunks <= 0) return 0;
  if (!dtypes_ok(p_dt, g_dt, m_dt) || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const Leaf*>(table), n_leaves, total_chunks, sc, skip,
         Hyper{b1, omb1, b2, omb2, eps, wd, 0.0f, 0, 0}, grid,
         static_cast<cudaStream_t>(stream)};
  return dispatch<true>(p_dt, g_dt, m_dt, a);
}
