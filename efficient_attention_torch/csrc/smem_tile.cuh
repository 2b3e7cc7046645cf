// Shared-memory helpers of the linear-attention kernels (lara_fused.cu,
// performer_fused.cu): type conversions, warp reductions, a small product
// over f32 matrices held in shared memory, and the bf16 tile loads and
// tensor-core products of their bf16 routes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace smem_tile {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back: the value a product in T sees.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C(i, j) = sum_{k < K} A(i, k) B(k, j) for i < M, j < N, with A(i, k) =
// A[i * ai + k * ak] and B(k, j) = B[k * bk + j * bj] in shared memory; f(i,
// j, value) receives each output, once, from one thread.  A thread holds a
// 4x4 register tile (rows a + mt*r, columns b + nt*c), so 8 scalar loads feed
// 16 FMAs; neighbouring threads take neighbouring columns.  Rows read past
// the edge are clamped to the last one and their outputs dropped.  Strides
// that are odd (rows of d + 1 floats) keep a warp's column reads free of bank
// conflicts.  The sum over k runs in order, in f32.
template <typename F>
__device__ __forceinline__ void tile_gemm(const float* A, int ai, int ak, const float* B,
                                          int bk, int bj, int M, int N, int K, F&& f) {
  constexpr int TM = 4, TN = 4;
  const int mt = (M + TM - 1) / TM, nt = (N + TN - 1) / TN;
  for (int t = threadIdx.x; t < mt * nt; t += blockDim.x) {
    const int a = t / nt, b = t % nt;
    const float* ar[TM];
    const float* bc[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) ar[r] = A + min(a + mt * r, M - 1) * ai;
#pragma unroll
    for (int c = 0; c < TN; ++c) bc[c] = B + min(b + nt * c, N - 1) * bj;
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float x[TM], y[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) x[r] = ar[r][k * ak];
#pragma unroll
      for (int c = 0; c < TN; ++c) y[c] = bc[c][k * bk];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int i = a + mt * r, j = b + nt * c;
        if (i < M && j < N) f(i, j, acc[r][c]);
      }
  }
}

// Rows [n0, n0 + rows) of one head's d-wide section `part` (0 q, 1 k, 2 v) of
// a packed [N, 3*nh*d] element, into dst [rows][d + 1] in f32.
template <typename T>
__device__ __forceinline__ void load_rows(const T* qkv, int part, int nh, int h, int d,
                                          int n0, int rows, float* dst) {
  const int HD = nh * d, DP = d + 1;
  const T* src = qkv + (size_t)n0 * 3 * HD + part * HD + h * d;
  for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
    const int r = e / d, c = e % d;
    dst[r * DP + c] = to_f(src[(size_t)r * 3 * HD + c]);
  }
}

// s[r] = scale * |row r|^2 for r < rows of x [rows][d + 1], one warp a row.
__device__ __forceinline__ void row_norms(const float* x, int rows, int d, float scale,
                                          float* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) acc = fmaf(x[r * (d + 1) + c], x[r * (d + 1) + c], acc);
    acc = warp_sum(acc);
    if (lane == 0) s[r] = scale * acc;
  }
}

// ---- bf16 tiles on tensor cores (16x16x16 warp MMA, f32 accumulation) ----

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Rows [n0, n0 + rows) of one head's section `part` of a packed bf16 element
// into dst [tile_rows][ld], 8 values a load (d a multiple of 8); rows past
// `rows` are zeroed.
__device__ __forceinline__ void load_tile_bf16(const bf16* qkv, int part, int nh, int h,
                                               int d, int n0, int rows, int tile_rows,
                                               bf16* dst, int ld) {
  const int HD = nh * d, V8 = d / 8;
  for (int e = threadIdx.x; e < tile_rows * V8; e += blockDim.x) {
    const int r = e / V8, v = e % V8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      x = *reinterpret_cast<const uint4*>(qkv + (size_t)(n0 + r) * 3 * HD + part * HD +
                                          h * d + 8 * v);
    *reinterpret_cast<uint4*>(dst + r * ld + 8 * v) = x;
  }
}

// s[r] = scale * |row r|^2 for r < rows of x [rows][ld] (bf16), a warp a row.
__device__ __forceinline__ void row_norms_bf16(const bf16* x, int ld, int rows, int d,
                                               float scale, float* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = __bfloat162float(x[r * ld + c]);
      acc = fmaf(v, v, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) s[r] = scale * acc;
  }
}

using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragBr = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragBc = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

// Products X Y^T for X [M][ld] and Y [N][ld] (bf16, rows of length K; M, N
// and K multiples of 16): out[i][j] = <X_i, Y_j> into f32 [M][ldo], on
// tensor cores, the warps sharing the 16x16 output tiles.  With X2 given, a
// second product X2 Y2^T into out2 at once.
__device__ __forceinline__ void mma_nt2(const bf16* X1, const bf16* Y1, float* out1,
                                        const bf16* X2, const bf16* Y2, float* out2,
                                        int ld, int M, int N, int K, int ldo) {
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5, mt = M / 16, nt = N / 16;
  for (int f = warp; f < (X2 != nullptr ? 2 : 1) * mt * nt; f += warps) {
    const int which = f / (mt * nt), m = f % (mt * nt), i = m / nt, j = m % nt;
    const bf16* X = which ? X2 : X1;
    const bf16* Y = which ? Y2 : Y1;
    FragA a;
    FragBc b;
    FragC c;
    wm::fill_fragment(c, 0.f);
    for (int k = 0; k < K; k += 16) {
      wm::load_matrix_sync(a, X + 16 * i * ld + k, ld);
      wm::load_matrix_sync(b, Y + 16 * j * ld + k, ld);
      wm::mma_sync(c, a, b, c);
    }
    wm::store_matrix_sync((which ? out2 : out1) + 16 * i * ldo + 16 * j, c, ldo,
                          wm::mem_row_major);
  }
}

}  // namespace smem_tile
