// int8 x int8 -> int32 matmul with the dequant epilogue, for Hopper
// (sm_90a): out[m, n] = f32(sum_k xq[m, k] * wq[k, n]) * (xs * ws[n])
// (+ b[n]), cast to the output dtype.
//
// Replaces: paddle_tpu/ops/int8_matmul.py `_int8_kernel` (launched by
// `_int8_matmul_2d`, pallas_call at :92). Same contract: int32
// accumulation, then in f32 `acc * (xscale * wscale[n]) + bias`, then the
// cast. xs is one scale per tensor or one per row (the TPU wrapper sends
// per-row scales to XLA; here the kernel takes both). Any M, K and N: the
// ragged edges are masked in the kernel, where the TPU wrapper sends K or
// N without a 128 divisor to XLA.
//
// What bounds it on an H100: on the decode path M is the batch (1-8 rows)
// and K x N a weight matrix (up to 2048 x 8192), so the product does
// 2*M ops per weight byte: it streams the int8 weights once, and the
// bound is their bytes over 3.35 TB/s.
//
// Design (a simple, right first kernel). A thread owns 4 neighbouring
// columns and 8 rows of the output; a block of 128 threads spans 512
// columns. The contraction dim is split over blockIdx.y so that enough
// blocks stream weights at M = 8 (a split of K, not of N, keeps each
// weight byte read once). Per step of 4 rows of K a thread reads one
// 4-byte word of each of the 4 weight rows (its 4 columns; a warp reads a
// 128-byte line per row), transposes the 4 x 4 bytes with byte permutes
// into one k-quad per column, and runs __dp4a against the activations'
// k-quads, staged in shared memory. The blocks of one split add their
// int32 partial sums into an int32 workspace with atomics (integer sums
// are exact in any order), and a second kernel applies the epilogue. So
// the output is bit-identical to the plain version's int32 product and
// f32 epilogue (built with -fmad=false: `acc * s + b` is not contracted).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 128;          // threads per block
constexpr int CPT = 4;           // output columns per thread
constexpr int MT = 8;            // output rows per block
constexpr int BN = NT * CPT;     // columns per block
constexpr int KC_MAX = 1024;     // most K per block (shared x tile bytes/row)

// columns n..n+3 of weight row k as one word (byte j = column n+j)
template <bool VEC>
__device__ __forceinline__ unsigned int load_w(const int8_t* w, int K, int N,
                                               int k, int n) {
  if (k >= K) return 0u;
  if constexpr (VEC) {
    if (n >= N) return 0u;
    return *reinterpret_cast<const unsigned int*>(w + (size_t)k * N + n);
  } else {
    unsigned int word = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N)
        word |= (unsigned int)(uint8_t)w[(size_t)k * N + n + j] << (8 * j);
    return word;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
int8_mm_splitk(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               int* __restrict__ acc_out, int M, int K, int N, int kc) {
  __shared__ __align__(16) int8_t xs[MT][KC_MAX];
  const int n = blockIdx.x * BN + threadIdx.x * CPT;
  const int k0 = blockIdx.y * kc;
  const int m0 = blockIdx.z * MT;
  const int klen = min(kc, K - k0);
  const int kq_n = (klen + 3) / 4;     // k-quads of this split

  // the activations' tile, zero past M and K
  for (int i = threadIdx.x; i < MT * kq_n * 4; i += NT) {
    const int m = i / (kq_n * 4), kk = i % (kq_n * 4);
    xs[m][kk] = (m0 + m < M && kk < klen)
                    ? x[(size_t)(m0 + m) * K + k0 + kk] : (int8_t)0;
  }
  __syncthreads();

  int acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[m][j] = 0;

#pragma unroll 4
  for (int q = 0; q < kq_n; ++q) {
    const int k = k0 + 4 * q;
    const unsigned int r0 = load_w<VEC>(w, K, N, k, n);
    const unsigned int r1 = load_w<VEC>(w, K, N, k + 1, n);
    const unsigned int r2 = load_w<VEC>(w, K, N, k + 2, n);
    const unsigned int r3 = load_w<VEC>(w, K, N, k + 3, n);
    // 4 x 4 byte transpose: col[j] byte i = row k+i, column n+j
    const unsigned int t0 = __byte_perm(r0, r1, 0x5140);
    const unsigned int t1 = __byte_perm(r0, r1, 0x7362);
    const unsigned int t2 = __byte_perm(r2, r3, 0x5140);
    const unsigned int t3 = __byte_perm(r2, r3, 0x7362);
    int col[CPT];
    col[0] = (int)__byte_perm(t0, t2, 0x5410);
    col[1] = (int)__byte_perm(t0, t2, 0x7632);
    col[2] = (int)__byte_perm(t1, t3, 0x5410);
    col[3] = (int)__byte_perm(t1, t3, 0x7632);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int xw = *reinterpret_cast<const int*>(&xs[m][4 * q]);
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[m][j] = __dp4a(xw, col[j], acc[m][j]);
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m >= M) break;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (n + j < N) atomicAdd(&acc_out[(size_t)(m0 + m) * N + n + j],
                               acc[m][j]);
  }
}

// out = f32(acc) * (xs[row or 0] * ws[n]) (+ b[n]), cast to T
template <typename T>
__global__ void int8_epilogue(const int* __restrict__ acc,
                              const float* __restrict__ xs, int xs_per_row,
                              const float* __restrict__ ws,
                              const float* __restrict__ b, T* __restrict__ out,
                              int M, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * N) return;
  const int row = (int)(i / N), col = (int)(i % N);
  const float s = xs[xs_per_row ? row : 0] * ws[col];
  float o = __int2float_rn(acc[i]) * s;
  if (b != nullptr) o = o + b[col];
  out[i] = ptt::from_f<T>(o);
}

}  // namespace

// Splits of K for a product of this shape (the workspace needs no more).
extern "C" int int8_mm_kc(int M, int K, int N) {
  const int col_tiles = (N + BN - 1) / BN;
  const int row_tiles = (M + MT - 1) / MT;
  const int want = (3 * 132 + col_tiles * row_tiles - 1) /
                   (col_tiles * row_tiles);
  int splits = std::max(1, std::min(want, (K + 15) / 16));
  splits = std::max(splits, (K + KC_MAX - 1) / KC_MAX);
  int kc = (K + splits - 1) / splits;
  kc = (kc + 15) / 16 * 16;
  return std::min(kc, KC_MAX);
}

// x (M, K) int8 and w (K, N) int8, row-major; xs f32 (1 or M values,
// xs_per_row says which); ws f32 (N); b f32 (N) or null; ws_acc an int32
// (M, N) workspace (zeroed here); out (M, N) in `dtype` (0 f32, 1 bf16).
// Returns cudaGetLastError() after the launches.
extern "C" int int8_matmul(const void* x, const void* w, const float* xs,
                           int xs_per_row, const float* ws, const float* b,
                           int* ws_acc, void* out, int M, int K, int N,
                           int dtype, void* stream) {
  if (M < 0 || K < 0 || N < 0 || (dtype != ptt::kF32 && dtype != ptt::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(ws_acc, 0, sizeof(int) * (size_t)M * N, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K > 0) {
    const int kc = int8_mm_kc(M, K, N);
    dim3 grid((N + BN - 1) / BN, (K + kc - 1) / kc, (M + MT - 1) / MT);
    const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 3) == 0;
    const int8_t* xp = static_cast<const int8_t*>(x);
    const int8_t* wp = static_cast<const int8_t*>(w);
    if (vec)
      int8_mm_splitk<true><<<grid, NT, 0, s>>>(xp, wp, ws_acc, M, K, N, kc);
    else
      int8_mm_splitk<false><<<grid, NT, 0, s>>>(xp, wp, ws_acc, M, K, N, kc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = (long long)M * N;
  const int eb = 256;
  const unsigned int eg = (unsigned int)((total + eb - 1) / eb);
  if (dtype == ptt::kBF16)
    int8_epilogue<__nv_bfloat16><<<eg, eb, 0, s>>>(
        ws_acc, xs, xs_per_row, ws, b, static_cast<__nv_bfloat16*>(out), M, N);
  else
    int8_epilogue<float><<<eg, eb, 0, s>>>(ws_acc, xs, xs_per_row, ws, b,
                                           static_cast<float*>(out), M, N);
  return static_cast<int>(cudaGetLastError());
}
