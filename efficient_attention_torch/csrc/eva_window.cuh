// Device code of K11 eva_kernel (eva_kernel.cu) and K12 eva_rowmajor
// (eva_rowmajor.cu): the EVA joint softmax over windows.  Plain versions and
// wrappers: efficient_attention_torch/ops/kernels/eva_kernel.py and
// eva_rowmajor.py.
//
// Function.  For one (image b, head h), q, k, v hold G windows of S tokens,
// each token a row of D; rf, beta [C, D] are the chunk summaries.  Each query
// attends over its own window's S keys (plus the bias [H, S, S]) and all C
// chunk keys rf, with values [window v | beta], in one softmax scaled by
// `scale`.  The two kernels differ only in where a window's rows lie: K11
// reads Swin-partitioned windows [B, H, G, S, D] (window g's rows contiguous
// at g*S), K12 row-major tokens [B, H, N, D] of a grid W tokens wide, where
// local position l of window g is token
// ((g / (W/ws)) * ws + l / ws) * W + (g % (W/ws)) * ws + l % ws.
//
// What bounds it: bytes.  At the DeiT-tiny-p8 shape (B=128, 16 windows of 49
// tokens, 49 chunks, 3 heads of 64, bf16) it must read q, k, v (115.6 MB) and
// the summaries (4.8 MB) and write the output (38.5 MB): ~47 us at 3.35 TB/s,
// against ~8 us for its 7.5 GFLOP at the bf16 tensor-core peak.
//
// Design.  The TPU kernel packs TG windows into one dense [TG*S, TG*S + C]
// logits product with the cross-window entries masked to -5e4; those entries
// are exactly 0 after its f32 softmax, so the window-local form here is the
// same function without the wasted block-diagonal products.  A block takes
// `wpb` windows of one (image, head) in turn; the C chunk rows are loaded once
// per block, a window's q, k, v rows once per window, all into shared memory.
// Two routes, chosen by type and head dim (uses_mma):
//  * CUDA cores (f32, or head dims that are not a multiple of 16): K1's
//    forward (eva_packed.cu) on the rows held in f32: each product is a loop
//    over shared memory in which a thread holds a register tile of outputs,
//    rows of D padded to a stride of 4 (mod 8) floats;
//  * tensor cores (bf16, head dims a multiple of 16): the rows held in bf16,
//    padded with zero rows to multiples of 16 (the window to SP, window and
//    chunks to SCP), both products as warp-level 16x16x16 bf16 MMA with f32
//    accumulation (K7's route, local_packed.cu, with the chunk columns).
// Roundings follow the TPU kernel (_eva_kernel): logits in f32 with the f32
// bias added, the numerators exp(l - max) rounded to the input type before
// their product with [v | beta], the denominator summed in f32 from the
// unrounded values, the output out / denom in f32, then cast.  No wgmma, TMA
// or pipelining.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_tile.cuh"

namespace eva_window {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using smem_tile::align128;
using smem_tile::align16;
using smem_tile::bf16;
using smem_tile::from_f;
using smem_tile::round16;
using smem_tile::round_to;
using smem_tile::to_f;
using smem_tile::warp_max;
using smem_tile::warp_sum;

struct Params {
  const void* q;      // [B, H, G*S, D], T
  const void* k;
  const void* v;
  const void* rf;     // [B, H, C, D], T
  const void* beta;
  const float* bias;  // [H, S, S] or null
  void* out;          // [B, H, G*S, D], T
  int B, H, G, S, C;
  int W, ws;          // K12: grid width and window side; K11: W = 0
  int wpb;            // windows per block
  float scale;
};

// Row (within one image and head) of local position l of window g.
__device__ __forceinline__ int token_row(const Params& p, int g, int l) {
  if (p.W == 0) return g * p.S + l;
  const int nww = p.W / p.ws;
  return ((g / nww) * p.ws + l / p.ws) * p.W + (g % nww) * p.ws + l % p.ws;
}

// Row stride (floats) of a D-wide row in shared memory: a multiple of 4 (rows
// start 16-byte aligned) that is 4 mod 8 (row_stride in
// ops/kernels/eva_packed.py).  D is a multiple of 4.
__host__ __device__ constexpr int row_stride(int D) { return ((D / 4 + 1) | 1) * 4; }

__host__ __device__ inline bool uses_mma(int D, bool is_bf16) {
  return is_bf16 && D % 16 == 0;
}

// Offsets (bytes) of the shared-memory regions of a block; the same layouts as
// smem_bytes() in ops/kernels/eva_kernel.py.
struct Layout {
  size_t q, keys, vals, F, P, bias, den, total;
};

// CUDA-core route: keys [S+C][DP] (k | rf) and values [S+C][DP] (v | beta),
// the query rows [S][DP], the logits [S][S+C+1], the bias [S][S] and the
// denominators [S], all f32.
__host__ __device__ inline Layout make_layout(int D, int S, int C) {
  const size_t DP = row_stride(D), SC = S + C;
  Layout L = {};
  size_t o = 0;
  L.keys = o;  o += align16(SC * DP * 4);
  L.vals = o;  o += align16(SC * DP * 4);
  L.q = o;     o += align16(S * DP * 4);
  L.P = o;     o += align16(S * (SC + 1) * 4);
  L.bias = o;  o += align16((size_t)S * S * 4);
  L.den = o;   o += align16((size_t)S * 4);
  L.total = o;
  return L;
}

// Tensor-core route: q [SP][D+8], keys and values [SCP][D+8] and the rounded
// numerators [SP][SCP+8] in bf16; an f32 region for the logits [SP][SCP+4]
// or the output tile [SP][D+4]; the bias [S][S] and the denominators [SP].
__host__ __device__ inline Layout make_mma_layout(int D, int S, int C) {
  const size_t SP = round16(S), SCP = round16(S + C), DB = D + 8;
  const size_t FS = SP * (SCP + 4) > SP * (D + 4) ? SP * (SCP + 4) : SP * (D + 4);
  Layout L = {};
  size_t o = 0;
  L.q = o;     o += align128(SP * DB * 2);
  L.keys = o;  o += align128(SCP * DB * 2);
  L.vals = o;  o += align128(SCP * DB * 2);
  L.F = o;     o += align128(FS * 4);
  L.P = o;     o += align128(SP * (SCP + 8) * 2);
  L.bias = o;  o += align128((size_t)S * S * 4);
  L.den = o;   o += align128(SP * 4);
  L.total = o;
  return L;
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// out[i][j] = <A_i, B_j> over D for i < M, j < N; A and B rows of D floats at
// row_stride(D).  A thread's 7x4 tile is rows a + mt*r and columns b + nt*c;
// f(i, j, value) receives each output inside the bounds.
template <int D, typename F>
__device__ __forceinline__ void gemm_nt(const float* A, int M, const float* B, int N,
                                        F&& f) {
  constexpr int DP = row_stride(D), TR = 7, TC = 4;
  const int mt = (M + TR - 1) / TR, nt = (N + TC - 1) / TC;
  for (int t = threadIdx.x; t < mt * nt; t += kThreads) {
    const int a = t / nt, b = t % nt;
    const float4* ar[TR];
    const float4* br[TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
      ar[r] = reinterpret_cast<const float4*>(A + min(a + mt * r, M - 1) * DP);
#pragma unroll
    for (int c = 0; c < TC; ++c)
      br[c] = reinterpret_cast<const float4*>(B + min(b + nt * c, N - 1) * DP);
    float acc[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < D / 4; ++k) {
      float4 y[TC];
#pragma unroll
      for (int c = 0; c < TC; ++c) y[c] = br[c][k];
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float4 x = ar[r][k];
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[r][c] = dot4(x, y[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int i = a + mt * r, j = b + nt * c;
        if (i < M && j < N) f(i, j, acc[r][c]);
      }
  }
}

// out[i][4q..4q+3] = sum_{j < K} Wt[i * ld + j] V[j][4q..4q+3] for i < M; V rows
// at row_stride(D).  A thread's tile is rows a + mt*r (r < 4) by one float4
// column q; f(i, q, value) receives each row inside the bounds.
template <int D, typename F>
__device__ __forceinline__ void gemm_nn(const float* Wt, int ld, int M, int K,
                                        const float* V, F&& f) {
  constexpr int DP = row_stride(D), TR = 4, D4 = D / 4;
  const int mt = (M + TR - 1) / TR;
  for (int t = threadIdx.x; t < mt * D4; t += kThreads) {
    const int a = t / D4, q = t % D4;
    const float* wr[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) wr[r] = Wt + min(a + mt * r, M - 1) * ld;
    float4 acc[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int j = 0; j < K; ++j) {
      const float4 v = reinterpret_cast<const float4*>(V + j * DP)[q];
#pragma unroll
      for (int r = 0; r < TR; ++r) fma4(acc[r], wr[r][j], v);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r)
      if (a + mt * r < M) f(a + mt * r, q, acc[r]);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 v) {
  dst[0] = from_f<T>(v.x);
  dst[1] = from_f<T>(v.y);
  dst[2] = from_f<T>(v.z);
  dst[3] = from_f<T>(v.w);
}

// The head's bias into bias_s [S][S] (zeros without one).
__device__ __forceinline__ void load_bias(const Params& p, int h, float* bias_s) {
  const float* bh = p.bias != nullptr ? p.bias + (size_t)h * p.S * p.S : nullptr;
  for (int e = threadIdx.x; e < p.S * p.S; e += kThreads)
    bias_s[e] = bh != nullptr ? bh[e] : 0.f;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) fused_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DP = row_stride(D);
  const int S = p.S, C = p.C, SC = S + C, SCP = SC + 1;
  const Layout L = make_layout(D, S, C);
  float* keys = reinterpret_cast<float*>(smem + L.keys);  // [S+C][DP]: k | rf
  float* vals = reinterpret_cast<float*>(smem + L.vals);  // [S+C][DP]: v | beta
  float* qs = reinterpret_cast<float*>(smem + L.q);       // [S][DP]
  float* P = reinterpret_cast<float*>(smem + L.P);        // [S][SCP]
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);  // [S][S]
  float* den_s = reinterpret_cast<float*>(smem + L.den);    // [S]
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t bh = (size_t)b * p.H + h, rows = (size_t)p.G * S;
  const T* q = static_cast<const T*>(p.q) + bh * rows * D;
  const T* k = static_cast<const T*>(p.k) + bh * rows * D;
  const T* v = static_cast<const T*>(p.v) + bh * rows * D;
  const T* rf = static_cast<const T*>(p.rf) + bh * C * D;
  const T* bt = static_cast<const T*>(p.beta) + bh * C * D;
  T* out = static_cast<T*>(p.out) + bh * rows * D;

  for (int e = threadIdx.x; e < C * D; e += kThreads) {
    const int c = e / D, d = e % D;
    keys[(S + c) * DP + d] = to_f(rf[e]);
    vals[(S + c) * DP + d] = to_f(bt[e]);
  }
  load_bias(p, h, bias_s);
  for (int wi = 0; wi < p.wpb; ++wi) {
    const int g = blockIdx.x * p.wpb + wi;
    for (int e = threadIdx.x; e < S * D; e += kThreads) {
      const int l = e / D, d = e % D;
      const size_t src = (size_t)token_row(p, g, l) * D + d;
      qs[l * DP + d] = to_f(q[src]);
      keys[l * DP + d] = to_f(k[src]);
      vals[l * DP + d] = to_f(v[src]);
    }
    __syncthreads();
    // logits: scale * <q_i, key_j> (+ bias on the window's columns)
    gemm_nt<D>(qs, S, keys, SC, [&](int i, int j, float x) {
      P[i * SCP + j] = x * p.scale + (j < S ? bias_s[i * S + j] : 0.f);
    });
    __syncthreads();
    // numerators exp(l - max), rounded to T as the value product takes them;
    // the f32 denominator sums the unrounded values
    for (int i = warp; i < S; i += kWarps) {
      float* row = P + i * SCP;
      float mx = -INFINITY;
      for (int j = lane; j < SC; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      float den = 0.f;
      for (int j = lane; j < SC; j += 32) {
        const float x = expf(row[j] - mx);
        den += x;
        row[j] = round_to<T>(x);
      }
      den = warp_sum(den);
      if (lane == 0) den_s[i] = den;
    }
    __syncthreads();
    gemm_nn<D>(P, SCP, S, SC, vals, [&](int i, int c, float4 x) {
      const float den = den_s[i];
      x.x /= den; x.y /= den; x.z /= den; x.w /= den;
      store4(out + (size_t)token_row(p, g, i) * D + 4 * c, x);
    });
    __syncthreads();  // q, k, v and P are rewritten by the next window
  }
}

// Rows [0, rows) of a [rows][D] bf16 tile at src (row r at src_row(r) * D)
// into dst [.][D + 8], 8 values a 16-byte load.
template <int D, typename R>
__device__ __forceinline__ void load_rows_bf16(const bf16* src, int rows, bf16* dst,
                                               R&& src_row) {
  constexpr int V8 = D / 8, DB = D + 8;
  for (int e = threadIdx.x; e < rows * V8; e += kThreads) {
    const int r = e / V8, c = e % V8;
    *reinterpret_cast<uint4*>(dst + r * DB + 8 * c) =
        *reinterpret_cast<const uint4*>(src + (size_t)src_row(r) * D + 8 * c);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) fused_mma_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DB = D + 8, KD = D + 4;
  const int S = p.S, C = p.C, SC = S + C;
  const int SP = round16(S), SCP = round16(SC), LS = SCP + 4, PS = SCP + 8;
  const Layout L = make_mma_layout(D, S, C);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);       // [SP][DB]
  bf16* keys = reinterpret_cast<bf16*>(smem + L.keys);  // [SCP][DB]: k | rf | 0
  bf16* vals = reinterpret_cast<bf16*>(smem + L.vals);  // [SCP][DB]: v | beta | 0
  float* F = reinterpret_cast<float*>(smem + L.F);      // [SP][LS] or [SP][KD]
  bf16* P = reinterpret_cast<bf16*>(smem + L.P);        // [SP][PS]
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);  // [S][S]
  float* den_s = reinterpret_cast<float*>(smem + L.den);    // [SP]
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t bh = (size_t)b * p.H + h, rows = (size_t)p.G * S;
  const bf16* q = static_cast<const bf16*>(p.q) + bh * rows * D;
  const bf16* k = static_cast<const bf16*>(p.k) + bh * rows * D;
  const bf16* v = static_cast<const bf16*>(p.v) + bh * rows * D;
  bf16* out = static_cast<bf16*>(p.out) + bh * rows * D;

  // the padded rows of q, keys and values and the padded rows and columns of
  // P stay 0
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < SP * DB; e += kThreads) qs[e] = zero;
  for (int e = threadIdx.x; e < SCP * DB; e += kThreads) keys[e] = vals[e] = zero;
  for (int e = threadIdx.x; e < SP * PS; e += kThreads) P[e] = zero;
  __syncthreads();
  const auto chunk_row = [](int r) { return r; };
  load_rows_bf16<D>(static_cast<const bf16*>(p.rf) + bh * C * D, C, keys + S * DB,
                    chunk_row);
  load_rows_bf16<D>(static_cast<const bf16*>(p.beta) + bh * C * D, C, vals + S * DB,
                    chunk_row);
  load_bias(p, h, bias_s);
  for (int wi = 0; wi < p.wpb; ++wi) {
    const int g = blockIdx.x * p.wpb + wi;
    const auto win_row = [&](int l) { return token_row(p, g, l); };
    load_rows_bf16<D>(q, S, qs, win_row);
    load_rows_bf16<D>(k, S, keys, win_row);
    load_rows_bf16<D>(v, S, vals, win_row);
    __syncthreads();
    smem_tile::mma_nt2(qs, keys, F, nullptr, nullptr, nullptr, DB, SP, SCP, D, LS);
    __syncthreads();
    for (int i = warp; i < S; i += kWarps) {
      const float* row = F + i * LS;
      float mx = -INFINITY;
      for (int j = lane; j < SC; j += 32)
        mx = fmaxf(mx, row[j] * p.scale + (j < S ? bias_s[i * S + j] : 0.f));
      mx = warp_max(mx);
      float den = 0.f;
      for (int j = lane; j < SC; j += 32) {
        const float x =
            expf(row[j] * p.scale + (j < S ? bias_s[i * S + j] : 0.f) - mx);
        den += x;
        P[i * PS + j] = __float2bfloat16(x);
      }
      den = warp_sum(den);
      if (lane == 0) den_s[i] = den;
    }
    __syncthreads();
    for (int f = warp; f < (SP / 16) * (D / 16); f += kWarps) {
      const int i = f / (D / 16), j = f % (D / 16);
      smem_tile::FragA a;
      smem_tile::FragBr bv;
      smem_tile::FragC c;
      smem_tile::wm::fill_fragment(c, 0.f);
      for (int kk = 0; kk < SCP; kk += 16) {
        smem_tile::wm::load_matrix_sync(a, P + 16 * i * PS + kk, PS);
        smem_tile::wm::load_matrix_sync(bv, vals + kk * DB + 16 * j, DB);
        smem_tile::wm::mma_sync(c, a, bv, c);
      }
      smem_tile::wm::store_matrix_sync(F + 16 * i * KD + 16 * j, c, KD,
                                       smem_tile::wm::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < S * D; e += kThreads) {
      const int i = e / D, x = e % D;
      out[(size_t)token_row(p, g, i) * D + x] = __float2bfloat16(F[i * KD + x] / den_s[i]);
    }
    __syncthreads();  // q, k, v, F and P are rewritten by the next window
  }
}

template <int D, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.G / p.wpb, p.H, p.B);
  if constexpr (D % 16 == 0) {  // uses_mma(D, true)
    if (sizeof(T) == 2) {
      const Layout L = make_mma_layout(D, p.S, p.C);
      auto kernel = fused_mma_kernel<D>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, L.total, stream>>>(p);
      return cudaGetLastError();
    }
  }
  const Layout L = make_layout(D, p.S, p.C);
  auto kernel = fused_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const Params& p, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch<D, bf16>(p, stream) : launch<D, float>(p, stream);
}

// The head dims the kernels are instantiated for (HEAD_DIMS in
// ops/kernels/eva_kernel.py).
inline cudaError_t launch_any(const Params& p, int d, int is_bf16, cudaStream_t s) {
  if (p.B <= 0 || p.H <= 0 || p.G <= 0 || p.S <= 0 || p.C <= 0 || p.wpb <= 0 ||
      p.G % p.wpb)
    return cudaErrorInvalidValue;
  switch (d) {
    case 8: return launch_dtype<8>(p, is_bf16, s);
    case 12: return launch_dtype<12>(p, is_bf16, s);
    case 16: return launch_dtype<16>(p, is_bf16, s);
    case 24: return launch_dtype<24>(p, is_bf16, s);
    case 32: return launch_dtype<32>(p, is_bf16, s);
    case 48: return launch_dtype<48>(p, is_bf16, s);
    case 64: return launch_dtype<64>(p, is_bf16, s);
    case 128: return launch_dtype<128>(p, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

inline int smem_bytes(int d, int S, int C, int is_bf16) {
  return (int)(uses_mma(d, is_bf16) ? make_mma_layout(d, S, C).total
                                    : make_layout(d, S, C).total);
}

}  // namespace eva_window
