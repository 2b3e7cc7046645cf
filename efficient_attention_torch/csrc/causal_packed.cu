// K3 causal_packed: the causal-EVA joint softmax of the LM training step,
// forward and backward.
//
// Replaces efficient_attention_tpu/ops/pallas/causal_packed.py::causal_eva_packed
// (forward _kernel, fused backward _bwd_kernel).  Plain versions and wrapper:
// efficient_attention_torch/ops/kernels/causal_packed.py.
//
// Function.  q, k, v [B, T, H*D]; rf, beta [B, C, H*D] are the chunk
// summaries; tab [w, w] f32 is the additive local table (causal triangle at
// MASK_VAL plus the head-shared T5 bias).  Query row i of window g (token
// g*w + i) of head h attends over [the window's k | rf] with values
// [the window's v | beta] in one softmax scaled by `scale`: the local columns
// take tab[i][j], chunk column c is masked to MASK_VAL unless
// c < g*(w/cs) + i/cs.  The backward recomputes the softmax (flash style) and
// gives dq, dk, dv, drf, dbeta and dbias [w, w].
//
// What bounds it: bytes.  At the wiki103 training shape (B=18, T=512, 8 heads
// of 128, w=128, cs=8, C=64, bf16) the forward must read q, k, v (56.6 MB) and
// the summaries (4.7 MB) and write the output (18.9 MB): ~24 us at 3.35 TB/s,
// against ~7 us for its 7.25 GFLOP at the bf16 tensor-core peak.  The backward
// also reads g and writes dq, dk, dv (bf16) and drf, dbeta (f32): ~44 us.
//
// Design.  A block takes `qt` query rows of one window of one (row, head):
// grid (T/qt, H, B), 256 threads.  Shared memory holds, in f32 (bf16 inputs
// convert exactly), the tile's query rows (and g rows in the backward), one
// buffer of w + C key rows that is refilled with the value rows once the
// logits are formed, and the qt x (w + C) logits (and dS).  Chunk columns
// that the chunk rule masks for every row of the tile (c at or past the
// last row's limit) would contribute exp(MASK_VAL + ...) = 0 in f32, so the
// block neither loads nor computes them; every other column is formed as the
// TPU kernel forms it.  Each product is a loop over shared memory in which a
// thread holds a register tile (4x4 logits, or 4 rows by a float4 of a
// D-wide product); rows of D are padded to a stride of 4 (mod 8) floats.
// Roundings follow the TPU kernel: logits*scale rounded to T before the table
// is added; P normalised in f32, then rounded to T for the value product;
// in the backward dS and P rounded to T before the products, dbias from the
// f32 dS; every sum f32.
// Reductions across blocks: the forward output and dq of a row come from its
// own block.  dk and dv of a window's key sum over the window's w/qt query
// tiles, drf and dbeta over every tile of a sequence, dbias over rows,
// windows and heads: the backward adds its share with f32 atomics into
// zeroed f32 buffers, dk/dv [B, T, H*D] (w/qt adds an address), drf/dbeta
// [B, C, H*D] (at most T/qt adds) and dbias partials [B, H, w, w] (T/w adds;
// a tile owns its own rows of the table), which the wrapper sums over B and
// H.  CUDA cores only: no wgmma, TMA or pipelining.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskVal = -5e4f;

struct Params {
  const void* q;      // [B, T, nh*D], T
  const void* k;      // [B, T, nh*D], T
  const void* v;      // [B, T, nh*D], T
  const void* rf;     // [B, C, nh*D], T
  const void* beta;   // [B, C, nh*D], T
  const float* tab;   // [w, w]
  const void* g;      // backward: [B, T, nh*D], T
  void* out;          // forward: out; backward: dq; [B, T, nh*D], T
  float* dk;          // backward: [B, T, nh*D], zeroed
  float* dv;          // backward: [B, T, nh*D], zeroed
  float* drf;         // backward: [B, C, nh*D], zeroed
  float* dbeta;       // backward: [B, C, nh*D], zeroed
  float* dbias;       // backward: [B, nh, w, w] partials, zeroed
  int B, T, nh, w, cs, C;
  int qt;             // query rows a block takes; divides w
  float scale;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Row stride (floats) of a D-wide row in shared memory: a multiple of 4 (rows
// start 16-byte aligned) that is 4 mod 8, so 8 consecutive rows start in 8
// different groups of 4 banks.
__host__ __device__ constexpr int row_stride(int D) {
  return ((D / 4 + 1) | 1) * 4;
}

// Offsets (bytes) of the shared-memory regions; the same layout as
// smem_bytes() in ops/kernels/causal_packed.py.
struct Layout {
  size_t q, g, kv, P, Ds, total;
};

__host__ __device__ inline Layout make_layout(bool backward, int D, int w, int C, int qt) {
  const size_t DP = row_stride(D), WCP = (size_t)w + C + 1;
  Layout L = {};
  size_t o = 0;
  L.q = o;  o += align16((size_t)qt * DP * 4);
  if (backward) { L.g = o; o += align16((size_t)qt * DP * 4); }
  L.kv = o; o += align16(((size_t)w + C) * DP * 4);
  L.P = o;  o += align16((size_t)qt * WCP * 4);
  if (backward) { L.Ds = o; o += align16((size_t)qt * WCP * 4); }
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
// at row_stride(D).  A thread's 4x4 tile is rows a + mt*r and columns
// b + nt*c; f(i, j, value) receives each output inside the bounds.
template <int D, typename F>
__device__ __forceinline__ void gemm_nt(const float* A, int M, const float* Bm, int N,
                                        F&& f) {
  constexpr int DP = row_stride(D), TR = 4, TC = 4;
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
      br[c] = reinterpret_cast<const float4*>(Bm + min(b + nt * c, N - 1) * DP);
    float acc[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 4; ++kk) {
      float4 y[TC];
#pragma unroll
      for (int c = 0; c < TC; ++c) y[c] = br[c][kk];
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float4 x = ar[r][kk];
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

// out[i][4q..4q+3] = sum_{j < K} W[i * ld + j] V[j][4q..4q+3] for i < M; V rows
// at row_stride(D).  A thread's tile is rows a + mt*r (r < 4) by one float4
// column q; f(i, q, value) receives each row inside the bounds.
template <int D, typename F>
__device__ __forceinline__ void gemm_nn(const float* W, int ld, int M, int K,
                                        const float* V, F&& f) {
  constexpr int DP = row_stride(D), TR = 4, D4 = D / 4;
  const int mt = (M + TR - 1) / TR;
  for (int t = threadIdx.x; t < mt * D4; t += kThreads) {
    const int a = t / D4, q = t % D4;
    const float* wr[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) wr[r] = W + min(a + mt * r, M - 1) * ld;
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
// W1[i * ld + r] V1[i][4q..] and out2 likewise from W2, V2.  A thread's tile
// is columns a + mt*k (k < 4) of W by one float4 column q of V.
template <int D, typename F>
__device__ __forceinline__ void gemm_tn2(const float* W1, const float* V1, const float* W2,
                                         const float* V2, int ld, int K, int N, F&& f) {
  constexpr int DP = row_stride(D), TR = 4, D4 = D / 4;
  const int mt = (N + TR - 1) / TR;
  for (int t = threadIdx.x; t < mt * D4; t += kThreads) {
    const int a = t / D4, q = t % D4;
    int col[TR];
#pragma unroll
    for (int kk = 0; kk < TR; ++kk) col[kk] = min(a + mt * kk, N - 1);
    float4 acc1[TR], acc2[TR];
#pragma unroll
    for (int kk = 0; kk < TR; ++kk)
      acc1[kk] = acc2[kk] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < K; ++i) {
      const float4 v1 = reinterpret_cast<const float4*>(V1 + i * DP)[q];
      const float4 v2 = reinterpret_cast<const float4*>(V2 + i * DP)[q];
      const float* w1 = W1 + i * ld;
      const float* w2 = W2 + i * ld;
#pragma unroll
      for (int kk = 0; kk < TR; ++kk) {
        fma4(acc1[kk], w1[col[kk]], v1);
        fma4(acc2[kk], w2[col[kk]], v2);
      }
    }
#pragma unroll
    for (int kk = 0; kk < TR; ++kk)
      if (a + mt * kk < N) f(a + mt * kk, q, acc1[kk], acc2[kk]);
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

__device__ __forceinline__ void atomic_add4(float* dst, float4 v) {
  atomicAdd(dst, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
}

// Copy `rows` rows of D elements (row pitch `pitch` elements) to shared
// memory in f32 at row_stride(D).
template <int D, typename T>
__device__ void load_rows(const T* src, size_t pitch, int rows, float* dst) {
  constexpr int DP = row_stride(D);
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * DP + d] = to_f(src[(size_t)r * pitch + d]);
  }
}

// The logit of window row ri (window g), column j < w + C, as the TPU kernel
// forms it from the raw product s = <q, key>: rounded to T after the scale,
// then the table (local columns) or the chunk mask (chunk columns) added.
template <typename T>
__device__ __forceinline__ float joint_logit(const Params& p, float s, int ri, int g, int j) {
  const float add = j < p.w ? __ldg(p.tab + ri * p.w + j)
                            : ((j - p.w) >= g * (p.w / p.cs) + ri / p.cs ? kMaskVal : 0.f);
  return round_to<T>(s * p.scale) + add;
}

// The tile of a block: its first token, window, first window row and the
// columns it needs (all w local ones and the chunks its last row may see).
struct Tile {
  int t0, g, r0, N;
};

__device__ __forceinline__ Tile make_tile(const Params& p) {
  Tile t;
  t.t0 = blockIdx.x * p.qt;
  t.g = t.t0 / p.w;
  t.r0 = t.t0 % p.w;
  const int cv = min(p.C, t.g * (p.w / p.cs) + (t.r0 + p.qt - 1) / p.cs);
  t.N = p.w + cv;
  return t;
}

// Load the window's rows of a (k or v) and the tile's visible chunk rows of
// c (rf or beta) into the key/value buffer.
template <int D, typename T>
__device__ void load_cols(const Params& p, const Tile& tl, const void* a, const void* c,
                          size_t tok, size_t cd, float* kv) {
  constexpr int DP = row_stride(D);
  const int HD = p.nh * D;
  load_rows<D, T>(static_cast<const T*>(a) + tok + (size_t)tl.g * p.w * HD, HD, p.w, kv);
  load_rows<D, T>(static_cast<const T*>(c) + cd, HD, tl.N - p.w, kv + p.w * DP);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) causal_packed_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(false, D, p.w, p.C, p.qt);
  float* qs = reinterpret_cast<float*>(smem + L.q);   // [qt][DP]
  float* kv = reinterpret_cast<float*>(smem + L.kv);  // [w+C][DP]: k | rf, then v | beta
  float* P = reinterpret_cast<float*>(smem + L.P);    // [qt][WCP]
  const int WCP = p.w + p.C + 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int HD = p.nh * D;
  const size_t tok = (size_t)b * p.T * HD + h * D;
  const size_t cd = (size_t)b * p.C * HD + h * D;
  const Tile tl = make_tile(p);

  load_rows<D, T>(static_cast<const T*>(p.q) + tok + (size_t)tl.t0 * HD, HD, p.qt, qs);
  load_cols<D, T>(p, tl, p.k, p.rf, tok, cd, kv);
  __syncthreads();
  gemm_nt<D>(qs, p.qt, kv, tl.N, [&](int i, int j, float s) { P[i * WCP + j] = s; });
  __syncthreads();
  // the values replace the keys while the rows are normalised
  load_cols<D, T>(p, tl, p.v, p.beta, tok, cd, kv);
  for (int i = warp; i < p.qt; i += kWarps) {
    float* row = P + i * WCP;
    const int ri = tl.r0 + i;
    float mx = -INFINITY;
    for (int j = lane; j < tl.N; j += 32) {
      const float l = joint_logit<T>(p, row[j], ri, tl.g, j);
      row[j] = l;
      mx = fmaxf(mx, l);
    }
    mx = warp_max(mx);
    float den = 0.f;
    for (int j = lane; j < tl.N; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      den += e;
    }
    den = warp_sum(den);
    // P normalised in f32, then rounded to T as the value product takes it
    for (int j = lane; j < tl.N; j += 32) row[j] = round_to<T>(row[j] / den);
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out) + tok + (size_t)tl.t0 * HD;
  gemm_nn<D>(P, WCP, p.qt, tl.N, kv, [&](int i, int c, float4 o) {
    store4(out + (size_t)i * HD + 4 * c, o);
  });
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) causal_packed_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(true, D, p.w, p.C, p.qt);
  float* qs = reinterpret_cast<float*>(smem + L.q);   // [qt][DP]
  float* gs = reinterpret_cast<float*>(smem + L.g);   // [qt][DP]
  float* kv = reinterpret_cast<float*>(smem + L.kv);  // [w+C][DP]
  float* P = reinterpret_cast<float*>(smem + L.P);    // [qt][WCP]
  float* Ds = reinterpret_cast<float*>(smem + L.Ds);  // [qt][WCP]
  const int WCP = p.w + p.C + 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int HD = p.nh * D;
  const size_t tok = (size_t)b * p.T * HD + h * D;
  const size_t cd = (size_t)b * p.C * HD + h * D;
  const Tile tl = make_tile(p);
  const size_t row0 = tok + (size_t)tl.t0 * HD;

  load_rows<D, T>(static_cast<const T*>(p.q) + row0, HD, p.qt, qs);
  load_rows<D, T>(static_cast<const T*>(p.g) + row0, HD, p.qt, gs);
  load_cols<D, T>(p, tl, p.k, p.rf, tok, cd, kv);
  __syncthreads();
  gemm_nt<D>(qs, p.qt, kv, tl.N, [&](int i, int j, float s) { P[i * WCP + j] = s; });
  __syncthreads();
  load_cols<D, T>(p, tl, p.v, p.beta, tok, cd, kv);
  __syncthreads();
  // dP = <g_i, val_j>
  gemm_nt<D>(gs, p.qt, kv, tl.N, [&](int i, int j, float s) { Ds[i * WCP + j] = s; });
  __syncthreads();
  // the keys come back for dq while the rows are processed: per row, P =
  // softmax, ds = sum_j P dP, dS = P (dP - ds); dbias takes the f32 dS, the
  // products take P and dS rounded to T.  Lane j owns column j of the row.
  load_cols<D, T>(p, tl, p.k, p.rf, tok, cd, kv);
  float* dbias = p.dbias + ((size_t)b * p.nh + h) * p.w * p.w;
  for (int i = warp; i < p.qt; i += kWarps) {
    float* prow = P + i * WCP;
    float* drow = Ds + i * WCP;
    const int ri = tl.r0 + i;
    float mx = -INFINITY;
    for (int j = lane; j < tl.N; j += 32) {
      const float l = joint_logit<T>(p, prow[j], ri, tl.g, j);
      prow[j] = l;
      mx = fmaxf(mx, l);
    }
    mx = warp_max(mx);
    float den = 0.f;
    for (int j = lane; j < tl.N; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      den += e;
    }
    den = warp_sum(den);
    float ds = 0.f;
    for (int j = lane; j < tl.N; j += 32) {
      const float pn = prow[j] / den;
      prow[j] = pn;
      ds = fmaf(pn, drow[j], ds);
    }
    ds = warp_sum(ds);
    for (int j = lane; j < tl.N; j += 32) {
      const float pn = prow[j];
      const float dsf = pn * (drow[j] - ds);
      if (j < p.w) atomicAdd(dbias + (size_t)ri * p.w + j, dsf);
      drow[j] = round_to<T>(dsf);
      prow[j] = round_to<T>(pn);
    }
  }
  __syncthreads();
  // dq[i] = scale * sum_j dS[i][j] keys[j]: complete in this block
  T* dq = static_cast<T*>(p.out) + row0;
  gemm_nn<D>(Ds, WCP, p.qt, tl.N, kv, [&](int i, int c, float4 o) {
    o.x *= p.scale; o.y *= p.scale; o.z *= p.scale; o.w *= p.scale;
    store4(dq + (size_t)i * HD + 4 * c, o);
  });
  // column r of dS and P against q and g: r < w adds the tile's share of dk,
  // dv of the window's token r; r >= w its share of chunk r - w's drf, dbeta
  const size_t win = tok + (size_t)tl.g * p.w * HD;
  gemm_tn2<D>(Ds, qs, P, gs, WCP, p.qt, tl.N, [&](int r, int c, float4 a, float4 v) {
    a.x *= p.scale; a.y *= p.scale; a.z *= p.scale; a.w *= p.scale;
    if (r < p.w) {
      const size_t at = win + (size_t)r * HD + 4 * c;
      atomic_add4(p.dk + at, a);
      atomic_add4(p.dv + at, v);
    } else {
      const size_t at = cd + (size_t)(r - p.w) * HD + 4 * c;
      atomic_add4(p.drf + at, a);
      atomic_add4(p.dbeta + at, v);
    }
  });
}

template <int D, typename T>
cudaError_t launch(const Params& p, bool backward, cudaStream_t stream) {
  const Layout L = make_layout(backward, D, p.w, p.C, p.qt);
  auto kernel = backward ? causal_packed_bwd_kernel<D, T> : causal_packed_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.T / p.qt, p.nh, p.B), kThreads, L.total, stream>>>(p);
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
    case 64: return launch_dtype<64>(p, backward, is_bf16, s);
    case 128: return launch_dtype<128>(p, backward, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

bool make_params(Params& p, int B, int T, int nh, int w, int cs, int C, int qt,
                 float scale) {
  if (B <= 0 || T <= 0 || nh <= 0 || w <= 0 || cs <= 0 || C <= 0 || qt <= 0 ||
      T % w || w % cs || w % qt)
    return false;
  p.B = B; p.T = T; p.nh = nh; p.w = w; p.cs = cs; p.C = C; p.qt = qt;
  p.scale = scale;
  return true;
}

}  // namespace

extern "C" {

// Shared memory of one block, for the wrapper's gate to check its own copy
// of the layout against.
int causal_packed_smem_bytes(int backward, int d, int w, int C, int qt) {
  return (int)make_layout(backward != 0, d, w, C, qt).total;
}

const char* causal_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: out [B, T, nh*d] from q, k, v, rf, beta (all of the
// input type) and tab (f32).  Returns a cudaError_t (0 on success).
int causal_packed_fwd_launch(const void* q, const void* k, const void* v, const void* rf,
                             const void* beta, const float* tab, void* out, int B, int T,
                             int nh, int d, int w, int cs, int C, int qt, int is_bf16,
                             float scale, void* stream) {
  Params p = {};
  if (!make_params(p, B, T, nh, w, cs, C, qt, scale)) return cudaErrorInvalidValue;
  p.q = q; p.k = k; p.v = v; p.rf = rf; p.beta = beta; p.tab = tab; p.out = out;
  return dispatch(p, d, false, is_bf16, stream);
}

// Backward on `stream`: dq (input type) and, added into the zeroed f32
// outputs, dk, dv [B, T, nh*d], drf, dbeta [B, C, nh*d] and the dbias
// partials [B, nh, w, w].  Returns a cudaError_t (0 on success).
int causal_packed_bwd_launch(const void* q, const void* k, const void* v, const void* rf,
                             const void* beta, const float* tab, const void* g, void* dq,
                             float* dk, float* dv, float* drf, float* dbeta, float* dbias,
                             int B, int T, int nh, int d, int w, int cs, int C, int qt,
                             int is_bf16, float scale, void* stream) {
  Params p = {};
  if (!make_params(p, B, T, nh, w, cs, C, qt, scale)) return cudaErrorInvalidValue;
  p.q = q; p.k = k; p.v = v; p.rf = rf; p.beta = beta; p.tab = tab; p.g = g;
  p.out = dq; p.dk = dk; p.dv = dv; p.drf = drf; p.dbeta = dbeta; p.dbias = dbias;
  return dispatch(p, d, true, is_bf16, stream);
}

}  // extern "C"
