// Fused residual add + LayerNorm for Hopper (sm_90a), forward and
// backward: out = LN(x + y) = ((t - mu) * rstd) * s + b with t = x + y,
// x, y and out (R, H) row-major in one dtype (bf16 or f32), s and b (H,)
// f32, mu and rstd (R,) f32.
//
// Replaces: paddle_tpu/ops/fused_kernels.py `_addln_fwd_kernel` (launched
// by `_addln_forward`, pallas_call :554) and `_addln_bwd_kernel`
// (launched by `_addln_bwd_rule`, pallas_call :584). Same numerics: the
// residual add in f32 (f32(x) + f32(y), not in the compute dtype), the
// two-pass variance mean((t - mu)^2) over the row, rstd = 1/sqrt(var +
// eps), out rounded once to x's dtype, mu and rstd saved in f32; the
// backward recomputes t and xhat = (t - mu) * rstd from x, y and the
// saved statistics, takes dxhat = do * s and
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
// in x's dtype (the gradient of both x and y), and the f32 column sums
// ds = sum_rows do * xhat, db = sum_rows do.
//
// What bounds it on an H100: a few operations per element against
// 2-4 bytes per element per tensor, far below the card's ~295 operations
// per byte: the bound is the bytes moved over 3.35 TB/s. The forward
// reads x and y and writes out (plus 8 bytes a row), the backward reads
// x, y and do and writes dx (the partial column sums are ~1% more).
//
// Design. The TPU kernels walk (rows, H) blocks in order and carry ds/db
// in VMEM scratch across the sequential grid. Here a row group of NT
// threads (NT = 32, 64, 128 or 256, the smallest with NT * 32 >= H) owns
// one row, holding at most 32 values a thread in registers, so each
// tensor is read once: the two sums of the statistics (forward) or of
// the two means (backward) are warp shuffles, plus one shared-memory
// step when NT spans several warps. Loads and stores are 16 bytes a
// thread where H and the base addresses allow (4 f32 or 8 bf16 values,
// and the f32 scale and bias 4 at a time), element by element otherwise. A block is 256 threads, 256 / NT rows.
// The forward takes one row group per row. In the backward each row
// group keeps running column sums of ds and db in shared memory (a
// thread adds only into its own columns, so no two threads touch one
// word) while its block strides over rows; at the end the block sums its
// row groups' columns in a fixed order and writes one partial row per
// block, and a second launch sums those partials column by column, again
// in a fixed order: the result is the same on every run, with no
// atomics. Keeping the sums out of registers lets two blocks share an SM.
// H is at most 8192 (256 threads of 32 values).
#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int PER_THREAD = 32;         // values a thread holds
constexpr int MAX_H = NTHREADS * PER_THREAD;

template <typename T, int V>
__device__ __forceinline__ void load_vals(const T* p, float* out) {
  if constexpr (V == 1) {
    out[0] = ptt::to_f<T>(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "16-byte vectors");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = ptt::to_f<T>(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vals(T* p, const float* in) {
  if constexpr (V == 1) {
    p[0] = ptt::from_f<T>(in[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = ptt::from_f<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// V f32 values (the LayerNorm scale or bias), as 16-byte words where
// V allows (p is then 16-byte aligned)
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (V == 1) {
    out[0] = p[0];
  } else {
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + q);
      out[q] = a.x;
      out[q + 1] = a.y;
      out[q + 2] = a.z;
      out[q + 3] = a.w;
    }
  }
}

// p[0..V) += v[0..V) in shared memory, as 16-byte words where V allows
// (p is then 16-byte aligned), so a warp's adds are conflict-free.
template <int V>
__device__ __forceinline__ void add_vals(float* p, const float* v) {
  if constexpr (V == 1) {
    p[0] += v[0];
  } else {
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      float4 a = *reinterpret_cast<float4*>(p + q);
      a.x += v[q];
      a.y += v[q + 1];
      a.z += v[q + 2];
      a.w += v[q + 3];
      *reinterpret_cast<float4*>(p + q) = a;
    }
  }
}

// Sum of (a, b) over the NT threads of this thread's row group; every
// thread of the group gets the same result. All threads of the block
// must call it (it synchronises the block when NT > 32).
template <int NT>
__device__ __forceinline__ float2 group_sum2(float a, float b,
                                             float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if constexpr (NT == 32) {
    return make_float2(a, b);
  } else {
    const int warp = threadIdx.x >> 5;
    __syncthreads();                   // red may still be read
    if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
    __syncthreads();
    const int first = (threadIdx.x / NT) * (NT / 32);
    float2 s = red[first];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) {
      s.x += red[first + w].x;
      s.y += red[first + w].y;
    }
    return s;
  }
}

template <typename T, int V, int NT>
__global__ void __launch_bounds__(NTHREADS)
addln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const float* __restrict__ s, const float* __restrict__ b,
                 T* __restrict__ out, float* __restrict__ mu,
                 float* __restrict__ rstd, int R, int H, float eps) {
  constexpr int K = PER_THREAD / V;    // vectors a thread holds
  __shared__ float2 red[NTHREADS / 32];
  const int tid = threadIdx.x % NT;
  const long long row = (long long)blockIdx.x * (NTHREADS / NT)
      + threadIdx.x / NT;
  const bool live = row < R;
  const size_t base = live ? (size_t)row * H : 0;
  float t[PER_THREAD];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (tid + k * NT) * V;
    if (live && c < H) {
      float xa[V], ya[V];
      load_vals<T, V>(x + base + c, xa);
      load_vals<T, V>(y + base + c, ya);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        t[k * V + e] = xa[e] + ya[e];
        sum += t[k * V + e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) t[k * V + e] = 0.f;
    }
  }
  const float m = group_sum2<NT>(sum, 0.f, red).x / (float)H;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (tid + k * NT) * V;
    if (c < H) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = t[k * V + e] - m;
        sq += d * d;
      }
    }
  }
  const float var = group_sum2<NT>(sq, 0.f, red).x / (float)H;
  const float rs = 1.0f / sqrtf(var + eps);
  if (!live) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (tid + k * NT) * V;
    if (c < H) {
      float o[V], sv[V], bv[V];
      load_f32<V>(s + c, sv);
      load_f32<V>(b + c, bv);
#pragma unroll
      for (int e = 0; e < V; ++e)
        o[e] = (t[k * V + e] - m) * rs * sv[e] + bv[e];
      store_vals<T, V>(out + base + c, o);
    }
  }
  if (tid == 0) {
    mu[row] = m;
    rstd[row] = rs;
  }
}

// part: (2, gridDim.x, H) f32 — each block's partial ds rows, then db.
// Dynamic shared memory: cols[2][NTHREADS / NT][H], each row group's
// running column sums of ds and db.
template <typename T, int V, int NT>
__global__ void __launch_bounds__(NTHREADS)
addln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const float* __restrict__ s, const float* __restrict__ mu,
                 const float* __restrict__ rstd, const T* __restrict__ dout,
                 T* __restrict__ dx, float* __restrict__ part, int R,
                 int H) {
  constexpr int K = PER_THREAD / V;
  constexpr int GROUPS = NTHREADS / NT;   // rows a block holds at once
  __shared__ float2 red[NTHREADS / 32];
  extern __shared__ float cols[];
  const int tid = threadIdx.x % NT;
  const int g = threadIdx.x / NT;
  float* ds = cols + (size_t)g * H;               // this group's columns
  float* db = cols + (size_t)(GROUPS + g) * H;
  for (int i = threadIdx.x; i < 2 * GROUPS * H; i += NTHREADS) cols[i] = 0.f;
  __syncthreads();
  const long long n_groups = ((long long)R + GROUPS - 1) / GROUPS;
  for (long long rg = blockIdx.x; rg < n_groups; rg += gridDim.x) {
    const long long row = rg * GROUPS + g;
    const bool live = row < R;
    const size_t base = live ? (size_t)row * H : 0;
    const float m = live ? mu[row] : 0.f;
    const float rs = live ? rstd[row] : 0.f;
    float xh[PER_THREAD], dv[PER_THREAD];
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (tid + k * NT) * V;
      if (live && c < H) {
        float xa[V], ya[V], da[V], sv[V], dsv[V];
        load_vals<T, V>(x + base + c, xa);
        load_vals<T, V>(y + base + c, ya);
        load_vals<T, V>(dout + base + c, da);
        load_f32<V>(s + c, sv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int i = k * V + e;
          xh[i] = (xa[e] + ya[e] - m) * rs;
          dv[i] = da[e];
          const float dxh = dv[i] * sv[e];
          a1 += dxh;
          a2 += dxh * xh[i];
          dsv[e] = dv[i] * xh[i];
        }
        // only this thread touches these columns of its group
        add_vals<V>(ds + c, dsv);
        add_vals<V>(db + c, da);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) xh[k * V + e] = dv[k * V + e] = 0.f;
      }
    }
    const float2 sums = group_sum2<NT>(a1, a2, red);
    const float mean1 = sums.x / (float)H;
    const float mean2 = sums.y / (float)H;
    if (live) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = (tid + k * NT) * V;
        if (c < H) {
          float o[V], sv[V];
          load_f32<V>(s + c, sv);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int i = k * V + e;
            const float dxh = dv[i] * sv[e];
            o[e] = rs * (dxh - mean1 - xh[i] * mean2);
          }
          store_vals<T, V>(dx + base + c, o);
        }
      }
    }
  }
  // this block's column sums: row groups in order, ds then db
  __syncthreads();
  float* out_ds = part + (size_t)blockIdx.x * H;
  float* out_db = part + ((size_t)gridDim.x + blockIdx.x) * H;
  for (int c = threadIdx.x; c < H; c += NTHREADS) {
    float a = cols[c], b = cols[(size_t)GROUPS * H + c];
    for (int gg = 1; gg < GROUPS; ++gg) {
      a += cols[(size_t)gg * H + c];
      b += cols[(size_t)(GROUPS + gg) * H + c];
    }
    out_ds[c] = a;
    out_db[c] = b;
  }
}

// ds[c] = sum over the G partial rows of part[0], db[c] of part[1]. A
// block takes 32 columns; its 8 warps each sum every 8th partial row of
// them (coalesced 128-byte rows), then warp 0 adds the 8 sums in order.
constexpr int COL_W = 32, COL_SLICES = 8;

__global__ void __launch_bounds__(COL_W * COL_SLICES)
addln_bwd_cols_kernel(const float* __restrict__ part,
                      float* __restrict__ ds, float* __restrict__ db,
                      int G, int H) {
  __shared__ float2 acc[COL_SLICES][COL_W];
  const int cx = threadIdx.x % COL_W;
  const int sl = threadIdx.x / COL_W;
  const int c = blockIdx.x * COL_W + cx;
  float a = 0.f, b = 0.f;
  if (c < H) {
#pragma unroll 4
    for (int i = sl; i < G; i += COL_SLICES) {
      a += part[(size_t)i * H + c];
      b += part[((size_t)G + i) * H + c];
    }
  }
  acc[sl][cx] = make_float2(a, b);
  __syncthreads();
  if (sl == 0 && c < H) {
    float2 t = acc[0][cx];
#pragma unroll
    for (int j = 1; j < COL_SLICES; ++j) {
      t.x += acc[j][cx].x;
      t.y += acc[j][cx].y;
    }
    ds[c] = t.x;
    db[c] = t.y;
  }
}

int threads_per_row(int H) {
  int nt = 32;
  while (nt * PER_THREAD < H) nt *= 2;
  return nt;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int V>
void launch_fwd(int nt, const void* x, const void* y, const float* s,
                const float* b, void* out, float* mu, float* rstd, int R,
                int H, float eps, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  T* op = static_cast<T*>(out);
  const unsigned int grid =
      (unsigned int)(((long long)R * nt + NTHREADS - 1) / NTHREADS);
#define PTT_ADDLN_FWD(NT_)                                               \
  addln_fwd_kernel<T, V, NT_><<<grid, NTHREADS, 0, st>>>(                \
      xp, yp, s, b, op, mu, rstd, R, H, eps)
  switch (nt) {
    case 32: PTT_ADDLN_FWD(32); break;
    case 64: PTT_ADDLN_FWD(64); break;
    case 128: PTT_ADDLN_FWD(128); break;
    default: PTT_ADDLN_FWD(256); break;
  }
#undef PTT_ADDLN_FWD
}

template <typename T, int V>
void launch_bwd(int nt, const void* x, const void* y, const float* s,
                const float* mu, const float* rstd, const void* dout,
                void* dx, float* part, int G, int R, int H,
                cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const T* dp = static_cast<const T*>(dout);
  T* op = static_cast<T*>(dx);
  // the row groups' ds and db columns: at most 2 * MAX_H floats (64 KB)
  const size_t smem = 2 * (size_t)(NTHREADS / nt) * H * sizeof(float);
#define PTT_ADDLN_BWD(NT_)                                               \
  cudaFuncSetAttribute(addln_bwd_kernel<T, V, NT_>,                      \
                       cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                       (int)smem);                                       \
  addln_bwd_kernel<T, V, NT_><<<G, NTHREADS, smem, st>>>(                \
      xp, yp, s, mu, rstd, dp, op, part, R, H)
  switch (nt) {
    case 32: PTT_ADDLN_BWD(32); break;
    case 64: PTT_ADDLN_BWD(64); break;
    case 128: PTT_ADDLN_BWD(128); break;
    default: PTT_ADDLN_BWD(256); break;
  }
#undef PTT_ADDLN_BWD
}

}  // namespace

// Blocks of the backward's first launch (rows of its partial-sum buffer)
// for R rows of width H on a card with `sms` multiprocessors.
extern "C" int fused_add_ln_bwd_blocks(int R, int H, int sms) {
  if (R <= 0 || H <= 0 || H > MAX_H) return 0;
  const long long groups = NTHREADS / threads_per_row(H);
  const long long n = ((long long)R + groups - 1) / groups;
  const long long cap = 2LL * (sms > 0 ? sms : 1);
  return (int)(n < cap ? n : cap);
}

// x, y, out (R, H); s, b (H,) f32; mu, rstd (R,) f32. dtype: ptt::DType.
extern "C" int fused_add_ln_fwd(const void* x, const void* y, const float* s,
                                const float* b, void* out, float* mu,
                                float* rstd, int R, int H, float eps,
                                int dtype, void* stream) {
  if (R < 0 || H <= 0 || H > MAX_H || (dtype != ptt::kF32 && dtype != ptt::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = threads_per_row(H);
  const int esz = dtype == ptt::kF32 ? 4 : 2;
  const bool vec = (H * esz) % 16 == 0 && aligned16(x) && aligned16(y)
      && aligned16(out) && aligned16(s) && aligned16(b);
  if (dtype == ptt::kF32) {
    if (vec) launch_fwd<float, 4>(nt, x, y, s, b, out, mu, rstd, R, H, eps, st);
    else launch_fwd<float, 1>(nt, x, y, s, b, out, mu, rstd, R, H, eps, st);
  } else {
    if (vec) launch_fwd<__nv_bfloat16, 8>(nt, x, y, s, b, out, mu, rstd, R, H, eps, st);
    else launch_fwd<__nv_bfloat16, 1>(nt, x, y, s, b, out, mu, rstd, R, H, eps, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// dout, dx like x; part: (2, G, H) f32 scratch with G from
// fused_add_ln_bwd_blocks; ds, db (H,) f32. Two launches: the row pass
// (dx and per-block column sums), then the column reduction.
extern "C" int fused_add_ln_bwd(const void* x, const void* y, const float* s,
                                const float* mu, const float* rstd,
                                const void* dout, void* dx, float* part,
                                float* ds, float* db, int G, int R, int H,
                                int dtype, void* stream) {
  if (R <= 0 || H <= 0 || H > MAX_H || G <= 0
      || (dtype != ptt::kF32 && dtype != ptt::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = threads_per_row(H);
  const int esz = dtype == ptt::kF32 ? 4 : 2;
  const bool vec = (H * esz) % 16 == 0 && aligned16(x) && aligned16(y)
      && aligned16(dout) && aligned16(dx) && aligned16(s);
  if (dtype == ptt::kF32) {
    if (vec) launch_bwd<float, 4>(nt, x, y, s, mu, rstd, dout, dx, part, G, R, H, st);
    else launch_bwd<float, 1>(nt, x, y, s, mu, rstd, dout, dx, part, G, R, H, st);
  } else {
    if (vec) launch_bwd<__nv_bfloat16, 8>(nt, x, y, s, mu, rstd, dout, dx, part, G, R, H, st);
    else launch_bwd<__nv_bfloat16, 1>(nt, x, y, s, mu, rstd, dout, dx, part, G, R, H, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  addln_bwd_cols_kernel<<<(H + COL_W - 1) / COL_W, COL_W * COL_SLICES, 0,
                          st>>>(part, ds, db, G, H);
  return static_cast<int>(cudaGetLastError());
}
