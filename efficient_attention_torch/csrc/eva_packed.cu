// K1 eva_packed: the 2-D EVA joint softmax of the training step, forward and
// backward.
//
// Replaces efficient_attention_tpu/ops/pallas/eva_packed.py::eva_attention_packed
// (forward _kernel, fused backward _bwd_kernel).  Plain versions and wrapper:
// efficient_attention_torch/ops/kernels/eva_packed.py.
//
// Function.  qkv [B, N, 3*H*D] holds q, k, v side by side; rf, beta [B, C, H*D]
// are the chunk summaries.  Each query of head h attends over its own 7x7
// window's keys (plus the RPE bias [H, S, S]) and all C chunk keys rf, with
// values [window v | beta], in one softmax scaled by `scale`.  The backward
// recomputes the softmax (flash style) and gives dqkv, drf, dbeta and the
// window-local dbias.
//
// What bounds it: bytes.  At the DeiT-tiny-p8 training shape (B=128, 28x28
// tokens, 3 heads of 64, bf16) the forward must read qkv (115.6 MB) and the
// summaries (4.8 MB) and write the output (38.5 MB): ~47 us at 3.35 TB/s,
// against ~8 us for its 7.5 GFLOP at the bf16 tensor-core peak.  The backward
// also reads g and writes dqkv (bf16) and drf/dbeta (f32): ~85 us, against
// ~19 us of operations.
//
// Design.  The TPU kernel's row strips, masked dense logits and permutation
// matmuls are layout tricks of the TPU; here the softmax is window-local,
// which is the same function (its masked entries were exactly 0).  A block
// takes `wpb` windows of one (image, head) in turn and keeps everything of a
// window in shared memory, in f32 (bf16 inputs convert exactly): the S query
// rows, the keys [window k | rf] and values [window v | beta] (the C chunk
// rows loaded once per block), the S x (S+C) logits.  Each product is a
// loop over shared memory in which a thread holds a register tile of
// outputs (7x4 logits, or 4 or 7 rows by 4 columns of a D-wide product), so
// a 16-byte load feeds 4 to 7 FMAs where a scalar load fed one; rows of D
// are padded to a stride of 4 (mod 8) floats, so the 8 threads of a
// quarter-warp reading 8 rows hit all 32 banks.  The tiles' rows and
// columns are strided over the output so that neighbouring threads read
// neighbouring rows; reads past the edge are clamped to the last row and
// their outputs dropped.  Roundings follow the TPU kernel: P (forward:
// unnormalised, backward: normalised) and dS are rounded to the input type
// before the products that consume them, every sum is f32, the output is
// out/denom in f32 then cast.
// Reductions across blocks: dq, dk, dv of a window come from that window
// alone and are written directly.  drf, dbeta (summed over an image's
// windows) and dbias (summed over every window of every image) are summed in
// shared memory over the block's windows, then added once per block with f32
// atomics: drf/dbeta into [B, C, H*D], dbias into per-image partials
// [B, H, S, S] that the wrapper sums over B.  So each address sees only
// (windows / wpb) atomic adds.  CUDA cores only: no wgmma, TMA or pipelining.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  const void* qkv;    // [B, N, 3*nh*D], T
  const void* rf;     // [B, C, nh*D], T
  const void* beta;   // [B, C, nh*D], T
  const float* bias;  // [nh, S, S] or null
  const void* g;      // backward: [B, N, nh*D], T
  void* out;          // forward: [B, N, nh*D]; backward: dqkv [B, N, 3*nh*D]; T
  float* drf;         // backward: [B, C, nh*D], zeroed
  float* dbeta;       // backward: [B, C, nh*D], zeroed
  float* dbias;       // backward: [B, nh, S, S] partials, zeroed
  int B, N, gw, ws, nh, C;
  int S;              // tokens per window
  int nww;            // windows per grid row
  int wpb;            // windows per block
  float scale;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Row stride (floats) of a D-wide row in shared memory: a multiple of 4 (rows
// start 16-byte aligned) that is 4 mod 8, so 8 consecutive rows start in 8
// different groups of 4 banks.  D is a multiple of 4.
__host__ __device__ constexpr int row_stride(int D) {
  return ((D / 4 + 1) | 1) * 4;
}

// Offsets (bytes) of the shared-memory regions; the same layout as
// smem_bytes() in ops/kernels/eva_packed.py.  Rows of D are padded to
// row_stride(D) floats, rows of S + C logits to S + C + 1.
struct Layout {
  size_t keys, vals, q, g, P, Ds, bias, dbias, drf, dbeta, rowstat, total;
};

__host__ __device__ inline Layout make_layout(bool backward, int D, int S, int C) {
  const size_t DP = row_stride(D), SCP = S + C + 1;
  Layout L = {};
  size_t o = 0;
  L.keys = o;  o += align16((S + C) * DP * 4);
  L.vals = o;  o += align16((S + C) * DP * 4);
  L.q = o;     o += align16(S * DP * 4);
  L.P = o;     o += align16(S * SCP * 4);
  L.bias = o;  o += align16((size_t)S * S * 4);
  if (backward) {
    L.g = o;     o += align16(S * DP * 4);
    L.Ds = o;    o += align16(S * SCP * 4);
    L.dbias = o; o += align16((size_t)S * S * 4);
    L.drf = o;   o += align16((size_t)C * D * 4);
    L.dbeta = o; o += align16((size_t)C * D * 4);
  } else {
    L.rowstat = o; o += align16((size_t)S * 4);
  }
  L.total = o;
  return L;
}

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

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// out[i][j] = <A_i, B_j> over D for i < M, j < N; A and B rows of D floats
// at row_stride(D).  A thread's 7x4 tile is rows a + mt*r and columns
// b + nt*c; f(i, j, value) receives each output inside the bounds.
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

// out[i][4q..4q+3] = sum_{j < K} W[i * ws + j] V[j][4q..4q+3] for i < M; V rows
// at row_stride(D).  A thread's tile is rows a + mt*r (r < 4) by one float4
// column q; f(i, q, value) receives each row inside the bounds.
template <int D, typename F>
__device__ __forceinline__ void gemm_nn(const float* W, int ws, int M, int K,
                                        const float* V, F&& f) {
  constexpr int DP = row_stride(D), TR = 4, D4 = D / 4;
  const int mt = (M + TR - 1) / TR;
  for (int t = threadIdx.x; t < mt * D4; t += kThreads) {
    const int a = t / D4, q = t % D4;
    const float* wr[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) wr[r] = W + min(a + mt * r, M - 1) * ws;
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

// Two transposed products at once: for r < N, out1[r][4q..] = sum_{i < K}
// W1[i * ws + r] V1[i][4q..] and out2 likewise from W2, V2.  A thread's tile
// is columns a + mt*k (k < 7) of W by one float4 column q of V.
template <int D, typename F>
__device__ __forceinline__ void gemm_tn2(const float* W1, const float* V1, const float* W2,
                                         const float* V2, int ws, int K, int N, F&& f) {
  constexpr int DP = row_stride(D), TR = 7, D4 = D / 4;
  const int mt = (N + TR - 1) / TR;
  for (int t = threadIdx.x; t < mt * D4; t += kThreads) {
    const int a = t / D4, q = t % D4;
    int col[TR];
#pragma unroll
    for (int k = 0; k < TR; ++k) col[k] = min(a + mt * k, N - 1);
    float4 acc1[TR], acc2[TR];
#pragma unroll
    for (int k = 0; k < TR; ++k)
      acc1[k] = acc2[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < K; ++i) {
      const float4 v1 = reinterpret_cast<const float4*>(V1 + i * DP)[q];
      const float4 v2 = reinterpret_cast<const float4*>(V2 + i * DP)[q];
      const float* w1 = W1 + i * ws;
      const float* w2 = W2 + i * ws;
#pragma unroll
      for (int k = 0; k < TR; ++k) {
        fma4(acc1[k], w1[col[k]], v1);
        fma4(acc2[k], w2[col[k]], v2);
      }
    }
#pragma unroll
    for (int k = 0; k < TR; ++k)
      if (a + mt * k < N) f(a + mt * k, q, acc1[k], acc2[k]);
  }
}

// Store 4 consecutive elements of a row of T.
template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 v) {
  dst[0] = from_f<T>(v.x);
  dst[1] = from_f<T>(v.y);
  dst[2] = from_f<T>(v.z);
  dst[3] = from_f<T>(v.w);
}

// Grid token index of local position l of window w.
__device__ __forceinline__ int window_token(const Params& p, int w, int l) {
  const int y = (w / p.nww) * p.ws + l / p.ws;
  const int x = (w % p.nww) * p.ws + l % p.ws;
  return y * p.gw + x;
}

// Load the block's chunk rows (rf into keys[S..], beta into vals[S..]) and
// the head's bias.
template <int D, typename T>
__device__ void load_block(const Params& p, int b, int h, float* keys, float* vals,
                           float* bias_s) {
  constexpr int DP = row_stride(D);
  const int HD = p.nh * D;
  const T* rf = static_cast<const T*>(p.rf) + (size_t)b * p.C * HD + h * D;
  const T* bt = static_cast<const T*>(p.beta) + (size_t)b * p.C * HD + h * D;
  for (int e = threadIdx.x; e < p.C * D; e += kThreads) {
    const int c = e / D, d = e % D;
    keys[(p.S + c) * DP + d] = to_f(rf[(size_t)c * HD + d]);
    vals[(p.S + c) * DP + d] = to_f(bt[(size_t)c * HD + d]);
  }
  const float* bh = p.bias != nullptr ? p.bias + (size_t)h * p.S * p.S : nullptr;
  for (int e = threadIdx.x; e < p.S * p.S; e += kThreads)
    bias_s[e] = bh != nullptr ? bh[e] : 0.f;
}

// Load window w's q, k, v rows (and g's in the backward) of head h.
template <int D, typename T>
__device__ void load_window(const Params& p, int b, int h, int w, float* q, float* keys,
                            float* vals, float* gs) {
  constexpr int DP = row_stride(D);
  const int HD = p.nh * D;
  const T* qkv = static_cast<const T*>(p.qkv) + (size_t)b * p.N * 3 * HD + h * D;
  const int parts = gs != nullptr ? 4 : 3;
  for (int e = threadIdx.x; e < p.S * parts * D; e += kThreads) {
    const int d = e % D, part = (e / D) % parts, l = e / (D * parts);
    const size_t tok = window_token(p, w, l);
    if (part == 3) {
      const T* g = static_cast<const T*>(p.g) + (size_t)b * p.N * HD + h * D;
      gs[l * DP + d] = to_f(g[tok * HD + d]);
    } else {
      const float x = to_f(qkv[tok * 3 * HD + part * HD + d]);
      float* dst = part == 0 ? q : part == 1 ? keys : vals;
      dst[l * DP + d] = x;
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) eva_packed_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S, SC = p.S + p.C, SCP = SC + 1;
  const Layout L = make_layout(false, D, S, p.C);
  float* keys = reinterpret_cast<float*>(smem + L.keys);  // [S+C][DP]: k | rf
  float* vals = reinterpret_cast<float*>(smem + L.vals);  // [S+C][DP]: v | beta
  float* q = reinterpret_cast<float*>(smem + L.q);        // [S][DP]
  float* P = reinterpret_cast<float*>(smem + L.P);        // [S][SCP]
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);      // [S][S]
  float* den_s = reinterpret_cast<float*>(smem + L.rowstat);    // [S]
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int HD = p.nh * D;
  T* out = static_cast<T*>(p.out) + (size_t)b * p.N * HD + h * D;

  load_block<D, T>(p, b, h, keys, vals, bias_s);
  for (int wi = 0; wi < p.wpb; ++wi) {
    const int w = blockIdx.x * p.wpb + wi;
    load_window<D, T>(p, b, h, w, q, keys, vals, nullptr);
    __syncthreads();
    // logits: scale * <q_i, key_j> (+ bias on the window's columns)
    gemm_nt<D>(q, S, keys, SC, [&](int i, int j, float v) {
      P[i * SCP + j] = v * p.scale + (j < S ? bias_s[i * S + j] : 0.f);
    });
    __syncthreads();
    // softmax numerator exp(l - max), rounded to T as the value product takes
    // it; the f32 denominator sums the unrounded values
    for (int i = warp; i < S; i += kWarps) {
      float* row = P + i * SCP;
      float mx = -INFINITY;
      for (int j = lane; j < SC; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      float den = 0.f;
      for (int j = lane; j < SC; j += 32) {
        const float e = expf(row[j] - mx);
        den += e;
        row[j] = round_to<T>(e);
      }
      den = warp_sum(den);
      if (lane == 0) den_s[i] = den;
    }
    __syncthreads();
    // out[i] = sum_j P[i][j] vals[j] / den[i]
    gemm_nn<D>(P, SCP, S, SC, vals, [&](int i, int c, float4 v) {
      const float den = den_s[i];
      v.x /= den; v.y /= den; v.z /= den; v.w /= den;
      store4(out + (size_t)window_token(p, w, i) * HD + 4 * c, v);
    });
    __syncthreads();  // q, k, v and P are rewritten by the next window
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) eva_packed_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S, C = p.C, SC = p.S + p.C, SCP = SC + 1;
  const Layout L = make_layout(true, D, S, C);
  float* keys = reinterpret_cast<float*>(smem + L.keys);  // [S+C][DP]: k | rf
  float* vals = reinterpret_cast<float*>(smem + L.vals);  // [S+C][DP]: v | beta
  float* q = reinterpret_cast<float*>(smem + L.q);        // [S][DP]
  float* gs = reinterpret_cast<float*>(smem + L.g);       // [S][DP]
  float* P = reinterpret_cast<float*>(smem + L.P);        // [S][SCP]
  float* Ds = reinterpret_cast<float*>(smem + L.Ds);      // [S][SCP]
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);    // [S][S]
  float* dbias_s = reinterpret_cast<float*>(smem + L.dbias);  // [S][S]
  float* drf_s = reinterpret_cast<float*>(smem + L.drf);      // [C][D]
  float* dbeta_s = reinterpret_cast<float*>(smem + L.dbeta);  // [C][D]
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HD = p.nh * D;
  T* dqkv = static_cast<T*>(p.out) + (size_t)b * p.N * 3 * HD + h * D;

  load_block<D, T>(p, b, h, keys, vals, bias_s);
  for (int e = tid; e < S * S; e += kThreads) dbias_s[e] = 0.f;
  for (int e = tid; e < C * D; e += kThreads) drf_s[e] = dbeta_s[e] = 0.f;
  for (int wi = 0; wi < p.wpb; ++wi) {
    const int w = blockIdx.x * p.wpb + wi;
    load_window<D, T>(p, b, h, w, q, keys, vals, gs);
    __syncthreads();
    // logits (into P) and dP = <g_i, val_j> (into Ds)
    gemm_nt<D>(q, S, keys, SC, [&](int i, int j, float v) {
      P[i * SCP + j] = v * p.scale + (j < S ? bias_s[i * S + j] : 0.f);
    });
    gemm_nt<D>(gs, S, vals, SC, [&](int i, int j, float v) { Ds[i * SCP + j] = v; });
    __syncthreads();
    // per row: P = softmax, ds = sum_j P dP, dS = P (dP - ds); dbias takes
    // the f32 dS, the products take P and dS rounded to T.  Lane j owns
    // column j of the row throughout, so no barrier is needed inside.
    for (int i = warp; i < S; i += kWarps) {
      float* prow = P + i * SCP;
      float* drow = Ds + i * SCP;
      float mx = -INFINITY;
      for (int j = lane; j < SC; j += 32) mx = fmaxf(mx, prow[j]);
      mx = warp_max(mx);
      float den = 0.f;
      for (int j = lane; j < SC; j += 32) {
        const float e = expf(prow[j] - mx);
        prow[j] = e;
        den += e;
      }
      den = warp_sum(den);
      float ds = 0.f;
      for (int j = lane; j < SC; j += 32) {
        const float pn = prow[j] / den;
        prow[j] = pn;
        ds = fmaf(pn, drow[j], ds);
      }
      ds = warp_sum(ds);
      for (int j = lane; j < SC; j += 32) {
        const float pn = prow[j];
        const float dsf = pn * (drow[j] - ds);
        if (j < S) dbias_s[i * S + j] += dsf;
        drow[j] = round_to<T>(dsf);
        prow[j] = round_to<T>(pn);
      }
    }
    __syncthreads();
    // dq[i] = scale * sum_j dS[i][j] keys[j]
    gemm_nn<D>(Ds, SCP, S, SC, keys, [&](int i, int c, float4 v) {
      v.x *= p.scale; v.y *= p.scale; v.z *= p.scale; v.w *= p.scale;
      store4(dqkv + (size_t)window_token(p, w, i) * 3 * HD + 4 * c, v);
    });
    // column r of dS and P against q and g: r < S gives dk, dv of the
    // window's token r; r >= S adds chunk r - S's share of drf, dbeta
    gemm_tn2<D>(Ds, q, P, gs, SCP, S, SC, [&](int r, int c, float4 a, float4 v) {
      a.x *= p.scale; a.y *= p.scale; a.z *= p.scale; a.w *= p.scale;
      if (r < S) {
        T* row = dqkv + (size_t)window_token(p, w, r) * 3 * HD + 4 * c;
        store4(row + HD, a);
        store4(row + 2 * HD, v);
      } else {
        float4* drf4 = reinterpret_cast<float4*>(drf_s + (r - S) * D) + c;
        float4* dbt4 = reinterpret_cast<float4*>(dbeta_s + (r - S) * D) + c;
        float4 x = *drf4, y = *dbt4;
        x.x += a.x; x.y += a.y; x.z += a.z; x.w += a.w;
        y.x += v.x; y.y += v.y; y.z += v.z; y.w += v.w;
        *drf4 = x;
        *dbt4 = y;
      }
    });
    __syncthreads();  // q, k, v, g, P and dS are rewritten by the next window
  }
  // one atomic add per element and block: (windows / wpb)-way at most
  float* drf = p.drf + (size_t)b * C * HD + h * D;
  float* dbeta = p.dbeta + (size_t)b * C * HD + h * D;
  for (int e = tid; e < C * D; e += kThreads) {
    const int c = e / D, d = e % D;
    atomicAdd(drf + (size_t)c * HD + d, drf_s[e]);
    atomicAdd(dbeta + (size_t)c * HD + d, dbeta_s[e]);
  }
  float* dbias = p.dbias + ((size_t)b * p.nh + h) * S * S;
  for (int e = tid; e < S * S; e += kThreads) atomicAdd(dbias + e, dbias_s[e]);
}

template <int D, typename T>
cudaError_t launch(const Params& p, bool backward, cudaStream_t stream) {
  const Layout L = make_layout(backward, D, p.S, p.C);
  auto kernel = backward ? eva_packed_bwd_kernel<D, T> : eva_packed_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  const int n_win = (p.N / p.gw / p.ws) * p.nww;
  kernel<<<dim3(n_win / p.wpb, p.nh, p.B), kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const Params& p, bool backward, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch<D, __nv_bfloat16>(p, backward, stream)
                 : launch<D, float>(p, backward, stream);
}

cudaError_t dispatch(const Params& p, int d, bool backward, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 12: return launch_dtype<12>(p, backward, is_bf16, s);
    case 16: return launch_dtype<16>(p, backward, is_bf16, s);
    case 32: return launch_dtype<32>(p, backward, is_bf16, s);
    case 64: return launch_dtype<64>(p, backward, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

bool make_params(Params& p, int B, int N, int gw, int ws, int nh, int C, int wpb,
                 float scale) {
  if (B <= 0 || N <= 0 || gw <= 0 || ws <= 0 || nh <= 0 || C <= 0 || wpb <= 0 ||
      N % gw)
    return false;
  const int gh = N / gw;
  if (gh % ws || gw % ws) return false;
  p.B = B; p.N = N; p.gw = gw; p.ws = ws; p.nh = nh; p.C = C;
  p.S = ws * ws;
  p.nww = gw / ws;
  p.wpb = wpb;
  p.scale = scale;
  return ((gh / ws) * p.nww) % wpb == 0;
}

}  // namespace

extern "C" {

// Shared memory of one block, for the wrapper's gate to check its own copy
// of the layout against.
int eva_packed_smem_bytes(int backward, int d, int S, int C) {
  return (int)make_layout(backward != 0, d, S, C).total;
}

const char* eva_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: out [B, N, nh*d] from qkv, rf, beta (all of the input
// type) and bias (f32 or null).  Returns a cudaError_t (0 on success).
int eva_packed_fwd_launch(const void* qkv, const void* rf, const void* beta,
                          const float* bias, void* out, int B, int N, int gw, int ws,
                          int nh, int d, int C, int wpb, int is_bf16, float scale,
                          void* stream) {
  Params p = {};
  if (!make_params(p, B, N, gw, ws, nh, C, wpb, scale)) return cudaErrorInvalidValue;
  p.qkv = qkv; p.rf = rf; p.beta = beta; p.bias = bias; p.out = out;
  return dispatch(p, d, false, is_bf16, stream);
}

// Backward on `stream`: dqkv (input type) and, added into the zeroed f32
// outputs, drf, dbeta [B, C, nh*d] and the per-image dbias partials
// [B, nh, S, S].  Returns a cudaError_t (0 on success).
int eva_packed_bwd_launch(const void* qkv, const void* rf, const void* beta,
                          const float* bias, const void* g, void* dqkv, float* drf,
                          float* dbeta, float* dbias, int B, int N, int gw, int ws,
                          int nh, int d, int C, int wpb, int is_bf16, float scale,
                          void* stream) {
  Params p = {};
  if (!make_params(p, B, N, gw, ws, nh, C, wpb, scale)) return cudaErrorInvalidValue;
  p.qkv = qkv; p.rf = rf; p.beta = beta; p.bias = bias; p.g = g; p.out = dqkv;
  p.drf = drf; p.dbeta = dbeta; p.dbias = dbias;
  return dispatch(p, d, true, is_bf16, stream);
}

}  // extern "C"
