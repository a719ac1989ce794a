// MoE dispatch gather for Hopper (sm_90a): out[i] = x[src[i]] for each
// capacity slot i, a row of zeros where src[i] < 0 (an empty slot).
// x (T, H) and out (N, H) row-major in one dtype (bf16 or f32); src (N,)
// int32.
//
// Replaces: paddle_tpu/ops/moe_dispatch.py `_gather_kernel` (launched by
// `_gather_pallas`, pallas_call at :79). Same contract: the packed
// (E*C, H) expert input with empty slots zeroed, bit-identical to the
// composed gather (it is a copy). A slot whose src is >= T is written as
// zeros too (the router never sends one; the plain version raises).
//
// What bounds it on an H100: it moves bytes and computes nothing. Each
// live slot reads one row of x and every slot writes one row of out, so
// the bound is (live rows + all rows) * H * bytes over 3.35 TB/s.
//
// Design. The TPU kernel DMAs one routed row per grid step, the source
// row named by a scalar-prefetched index. Here one warp owns one output
// row (8 rows per block of 256 threads): its lanes read src[i] (one
// broadcast load), then copy the row as 16-byte vectors, lane j taking
// vectors j, j + 32, ... so a warp moves 512 contiguous bytes per step;
// an empty slot stores zeros without reading x. The copy is typeless
// (bytes), so one kernel serves bf16 and f32. Where the row's byte
// length or the base addresses are not 16-byte multiples (any H is
// allowed), the row is copied in 2-byte units instead (bf16 and f32 rows
// are both whole 2-byte units).
#include "common.cuh"

namespace {

constexpr int NT = 256;                 // 8 warps, one output row each
constexpr int ROWS = NT / 32;

template <bool VEC>
__global__ void __launch_bounds__(NT)
moe_gather_rows(const unsigned char* __restrict__ x,
                const int* __restrict__ src, unsigned char* __restrict__ out,
                int T, int N, long long row_bytes) {
  const int i = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= N) return;
  const int s = src[i];
  const bool live = s >= 0 && s < T;
  unsigned char* dst = out + (size_t)i * row_bytes;
  const unsigned char* from = x + (size_t)(live ? s : 0) * row_bytes;
  if constexpr (VEC) {
    const long long nv = row_bytes / 16;
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* f = reinterpret_cast<const uint4*>(from);
    if (live) {
      for (long long v = lane; v < nv; v += 32) d[v] = f[v];
    } else {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (long long v = lane; v < nv; v += 32) d[v] = z;
    }
  } else {
    const long long nh = row_bytes / 2;
    uint16_t* d = reinterpret_cast<uint16_t*>(dst);
    const uint16_t* f = reinterpret_cast<const uint16_t*>(from);
    if (live) {
      for (long long v = lane; v < nh; v += 32) d[v] = f[v];
    } else {
      for (long long v = lane; v < nh; v += 32) d[v] = (uint16_t)0;
    }
  }
}

}  // namespace

// x (T, H), out (N, H) with `elem_bytes` bytes per element (2 or 4),
// src (N,) int32. Returns cudaGetLastError() after the launch.
extern "C" int moe_gather(const void* x, const int* src, void* out, int T,
                          int N, int H, int elem_bytes, void* stream) {
  if (T < 0 || N < 0 || H < 0 || (elem_bytes != 2 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_bytes = (long long)H * elem_bytes;
  const bool vec = row_bytes % 16 == 0
      && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out))
          & 15) == 0;
  const unsigned int grid = (unsigned int)((N + ROWS - 1) / ROWS);
  const unsigned char* xp = static_cast<const unsigned char*>(x);
  unsigned char* op = static_cast<unsigned char*>(out);
  if (vec)
    moe_gather_rows<true><<<grid, NT, 0, s>>>(xp, src, op, T, N, row_bytes);
  else
    moe_gather_rows<false><<<grid, NT, 0, s>>>(xp, src, op, T, N, row_bytes);
  return static_cast<int>(cudaGetLastError());
}
