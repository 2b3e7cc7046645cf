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
//    CUDA-core forward (eva_packed.cu) on the rows held in f32: each product
//    is a loop over shared memory in which a thread holds a register tile of
//    outputs, rows of D padded to a stride of 4 (mod 8) floats;
//  * tensor cores (bf16, head dims 16, 32, 48, 64 and 128): K1's tensor-core
//    forward design (window_mma_kernel), on the strip tiles it shares with
//    K1 (eva_strip.cuh).  A block of 4 warps stages in bf16, 16 bytes a
//    cp.async: the chunk rows rf and beta [C][D+8] once a block; a window's
//    q, k and v rows [S][D+8] in two buffers, the next window's loading
//    while this one is computed, so one barrier a window; the bias in f32
//    times log2 e, and a table of the block's token rows (token_row,
//    computed once a block, not for every element).  A warp owns a strip of
//    16 query rows: its logits as mma.sync m16n8k16 fragments in registers
//    (one pass while S + C <= 112, two above), the softmax over the quad of
//    threads that shares a row, P [v | beta] from P repacked in registers,
//    out / denom staged in the strip's own q rows and stored 16 bytes a
//    thread through the token table.  No logit matrix in shared memory:
//    67,968 bytes a block at the DeiT-tiny-p8 shape, three blocks an SM.
// Roundings follow the TPU kernel (_eva_kernel): logits in f32 with the f32
// bias added, the numerators exp(l - max) rounded to the input type before
// their product with [v | beta], the denominator summed in f32 from the
// unrounded values, the output out / denom in f32, then cast.  The
// tensor-core route holds the logits in base 2 (one ex2 an exp), which moves
// the numerators by about 1e-7 relative, far below their bf16 rounding.  No
// wgmma or TMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "eva_strip.cuh"
#include "mma_frag.cuh"
#include "smem_tile.cuh"

namespace eva_window {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The tensor-core route: 4 warps a block, and at most kMaxWpb windows a
// block (WINDOWS_PER_BLOCK in ops/kernels/eva_kernel.py), whose token rows
// its table holds.
constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMaxWpb = 4;

using smem_tile::align128;
using smem_tile::align16;
using smem_tile::bf16;
using smem_tile::from_f;
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

// Whether (D, type) takes the tensor-core route (uses_mma in
// ops/kernels/eva_kernel.py): bf16 and a head dim that is a multiple of 16
// (of the instantiated ones, 16, 32, 48, 64 and 128).
__host__ __device__ inline bool uses_mma(int D, bool is_bf16) {
  return is_bf16 && D % 16 == 0;
}

// Offsets (bytes) of the CUDA-core route's shared memory; the same layout as
// smem_bytes() in ops/kernels/eva_kernel.py: keys [S+C][DP] (k | rf) and
// values [S+C][DP] (v | beta), the query rows [S][DP], the logits
// [S][S+C+1], the bias [S][S] and the denominators [S], all f32.
struct Layout {
  size_t q, keys, vals, P, bias, den, total;
};

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

// Offsets (bytes) of the tensor-core route's shared memory (K1's
// make_fwd_mma_layout); the same layout as smem_bytes() in
// ops/kernels/eva_kernel.py.  bf16: a window's q, k and v rows [S][D+8] in
// two buffers each (buffer b at b * win), the chunk rows rf and beta
// [C][D+8]; f32: the bias [S][S]; int32: the token table [kMaxWpb][S].
struct MmaLayout {
  size_t win, q, kw, vw, kc, vc, bias, tok, total;
};

__host__ __device__ inline MmaLayout make_mma_layout(int D, int S, int C) {
  const size_t DB = D + 8;
  MmaLayout L = {};
  L.win = align128(S * DB * 2);
  size_t o = 0;
  L.q = o;     o += 2 * L.win;
  L.kw = o;    o += 2 * L.win;
  L.vw = o;    o += 2 * L.win;
  L.kc = o;    o += align128(C * DB * 2);
  L.vc = o;    o += align128(C * DB * 2);
  L.bias = o;  o += align128((size_t)S * S * 4);
  L.tok = o;   o += align128((size_t)kMaxWpb * S * 4);
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

// Blocks an SM that the tensor-core kernel's registers are sized for: three
// (at most 168 registers a thread) at head dims 16, 32 and 64; two at head
// dim 48, whose one-pass strip spills when held to 168; one at head dim
// 128 (no path runs it; its shared memory allows one block at 49 + 49 keys
// anyway).
__host__ __device__ constexpr int mma_min_blocks(int D) {
  return D == 128 ? 1 : D == 48 ? 2 : 3;
}

// A window's q, k and v rows into one buffer each with 16-byte asynchronous
// copies; tok holds the window's token rows.
template <int D>
__device__ __forceinline__ void load_window(int S, const int* tok, const bf16* q,
                                            const bf16* k, const bf16* v, bf16* qs, bf16* kw,
                                            bf16* vw) {
  using namespace mma_frag;
  constexpr int DB = D + 8, V8 = D / 8;
  for (int e = threadIdx.x; e < S * 3 * V8; e += kMmaThreads) {
    const int c = e % V8, part = (e / V8) % 3, l = e / (3 * V8);
    const bf16* src = part == 0 ? q : part == 1 ? k : v;
    bf16* dst = part == 0 ? qs : part == 1 ? kw : vw;
    cp_async16(dst + l * DB + 8 * c, src + (size_t)tok[l] * D + 8 * c);
  }
  cp_async_commit();
}

// Strip st (query rows 16 st .. 16 st + 15) of a window: its q rows qs, its
// keys kw | kc and values vw | vc ([.][D+8] bf16 each), the bias bias_s
// [S][S] in base 2; row i < S of the output goes to out + tok[i] * D.  The
// strip body of K1's eva_packed_fwd_mma_kernel (eva_packed.cu), on the tiles
// both share (eva_strip.cuh).  kOnePass: eva_strip::one_pass(S, C).
template <int D, bool kOnePass>
__device__ __forceinline__ void window_strip(const Params& p, int st, bf16* qs,
                                             const bf16* kw, const bf16* vw, const bf16* kc,
                                             const bf16* vc, const float* bias_s,
                                             const int* tok, bf16* out) {
  using namespace mma_frag;
  using eva_strip::fwd_logits_tile;
  using eva_strip::fwd_pv_tile;
  using eva_strip::kResidentTiles;
  constexpr int DB = D + 8, KD = D / 16, V8 = D / 8;
  const int S = p.S, KT = eva_strip::round16(S + p.C) / 16;
  const int lane = threadIdx.x & 31;
  const int cq = 2 * (lane & 3);  // the thread's first column in an 8-column tile
  const int row0 = 16 * st + (lane >> 2);  // the thread's rows: row0, row0 + 8
  uint32_t qa[KD][4];
  {
    const int r = min(16 * st + row_r(lane), S - 1);
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) ldsm_x4(qa[kd], qs + r * DB + 16 * kd + col_r(lane));
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if constexpr (kOnePass) {
    // the logits of every tile, then the row max over the quad, then the
    // numerators and the value product tile by tile
    float s[kResidentTiles][2][4];
#pragma unroll
    for (int kt = 0; kt < kResidentTiles; ++kt) {
      if (kt >= KT) break;
      fwd_logits_tile<D>(p, kt, row0, qa, kw, kc, bias_s, s[kt]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        m[r] = fmaxf(m[r], fmaxf(fmaxf(s[kt][0][2 * r], s[kt][0][2 * r + 1]),
                                 fmaxf(s[kt][1][2 * r], s[kt][1][2 * r + 1])));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
#pragma unroll
    for (int kt = 0; kt < kResidentTiles; ++kt) {
      if (kt >= KT) break;
      fwd_pv_tile<D>(p, kt, s[kt], m, l, vw, vc, o);
    }
  } else {
    // pass 1: the row max; pass 2: the logits again, the numerators and the
    // value product
    for (int kt = 0; kt < KT; ++kt) {
      float s[2][4];
      fwd_logits_tile<D>(p, kt, row0, qa, kw, kc, bias_s, s);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        m[r] = fmaxf(m[r], fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                 fmaxf(s[1][2 * r], s[1][2 * r + 1])));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
    for (int kt = 0; kt < KT; ++kt) {
      float s[2][4];
      fwd_logits_tile<D>(p, kt, row0, qa, kw, kc, bias_s, s);
      fwd_pv_tile<D>(p, kt, s, m, l, vw, vc, o);
    }
  }
  // out / denom in f32, rounded to bf16 into the strip's own q rows (no
  // other warp reads them), then 16 bytes a thread to the tokens
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = quad_sum(l[r]);
    const int i = row0 + 8 * r;
    if (i >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(qs + i * DB + 8 * n + cq) =
          pack_bf16(o[n][2 * r] / den, o[n][2 * r + 1] / den);
  }
  __syncwarp();
  const int nr = min(16, S - 16 * st);
  for (int e = lane; e < nr * V8; e += 32) {
    const int i = 16 * st + e / V8, v = e % V8;
    *reinterpret_cast<uint4*>(out + (size_t)tok[i] * D + 8 * v) =
        *reinterpret_cast<const uint4*>(qs + i * DB + 8 * v);
  }
}

// The tensor-core route (bf16, uses_mma): the design is in the header
// comment.  A block takes wpb windows of one (image, head) in turn.
// kOnePass: eva_strip::one_pass(S, C), a strip's logits stay in registers
// between the row max and their use.
template <int D, bool kOnePass>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks(D))
    window_mma_kernel(const Params p) {
  using namespace mma_frag;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int DB = D + 8, V8 = D / 8;
  const int S = p.S, C = p.C;
  const int NS = (S + 15) / 16;  // strips of 16 query rows
  const MmaLayout L = make_mma_layout(D, S, C);
  bf16* kc = reinterpret_cast<bf16*>(smem + L.kc);            // [C][DB]: rf
  bf16* vc = reinterpret_cast<bf16*>(smem + L.vc);            // [C][DB]: beta
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);    // [S][S]
  int* tok_s = reinterpret_cast<int*>(smem + L.tok);          // [kMaxWpb][S]
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t bh = (size_t)b * p.H + h, rows = (size_t)p.G * S;
  const bf16* q = static_cast<const bf16*>(p.q) + bh * rows * D;
  const bf16* k = static_cast<const bf16*>(p.k) + bh * rows * D;
  const bf16* v = static_cast<const bf16*>(p.v) + bh * rows * D;
  bf16* out = static_cast<bf16*>(p.out) + bh * rows * D;
  // buffer `buf` of a window's q, k or v rows ([S][DB] each)
  auto buffer = [&](size_t region, int buf) {
    return reinterpret_cast<bf16*>(smem + region + buf * L.win);
  };

  {  // the block's chunk rows, bias and token table
    const bf16* rf = static_cast<const bf16*>(p.rf) + bh * C * D;
    const bf16* bt = static_cast<const bf16*>(p.beta) + bh * C * D;
    for (int e = tid; e < C * V8; e += kMmaThreads) {
      const int c = e / V8, x = e % V8;
      cp_async16(kc + c * DB + 8 * x, rf + (size_t)c * D + 8 * x);
      cp_async16(vc + c * DB + 8 * x, bt + (size_t)c * D + 8 * x);
    }
    const float* bias = p.bias != nullptr ? p.bias + (size_t)h * S * S : nullptr;
    for (int e = tid; e < S * S; e += kMmaThreads)
      bias_s[e] = bias != nullptr ? eva_strip::kLog2e * bias[e] : 0.f;
    for (int e = tid; e < p.wpb * S; e += kMmaThreads)
      tok_s[e] = token_row(p, blockIdx.x * p.wpb + e / S, e % S);
    __syncthreads();
  }
  // the first window's rows, in one group with the chunk rows
  load_window<D>(S, tok_s, q, k, v, buffer(L.q, 0), buffer(L.kw, 0), buffer(L.vw, 0));
  for (int wi = 0; wi < p.wpb; ++wi) {
    const int buf = wi & 1;
    const int* tok = tok_s + wi * S;
    bf16* qs = buffer(L.q, buf);
    const bf16* kw = buffer(L.kw, buf);
    const bf16* vw = buffer(L.vw, buf);
    // this window's rows have landed, and every warp is done with the other
    // buffer, into which the next window's rows now load
    cp_async_wait_all();
    __syncthreads();
    if (wi + 1 < p.wpb)
      load_window<D>(S, tok + S, q, k, v, buffer(L.q, buf ^ 1), buffer(L.kw, buf ^ 1),
                     buffer(L.vw, buf ^ 1));
    for (int st = warp; st < NS; st += kMmaWarps)
      window_strip<D, kOnePass>(p, st, qs, kw, vw, kc, vc, bias_s, tok, out);
  }
}

// The tensor-core kernel of a geometry (one pass where a strip's tiles fit
// the registers), prepared for its shared memory.
template <int D>
auto mma_kernel(int S, int C) {
  return eva_strip::one_pass(S, C) ? window_mma_kernel<D, true> : window_mma_kernel<D, false>;
}

template <int D>
cudaError_t prepare_mma(int S, int C) {
  const auto kernel = mma_kernel<D>(S, C);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)make_mma_layout(D, S, C).total);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Blocks of the tensor-core kernel that fit one SM (registers and shared
// memory), from the occupancy calculator, or -1.
template <int D>
int mma_blocks_per_sm(int S, int C) {
  int blocks = 0;
  if (prepare_mma<D>(S, C) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mma_kernel<D>(S, C), kMmaThreads,
                                                    make_mma_layout(D, S, C).total) !=
          cudaSuccess)
    return -1;
  return blocks;
}

template <int D, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.G / p.wpb, p.H, p.B);
  if constexpr (D % 16 == 0) {  // uses_mma(D, true)
    if (sizeof(T) == 2) {
      if (p.wpb > kMaxWpb) return cudaErrorInvalidValue;
      cudaError_t err = prepare_mma<D>(p.S, p.C);
      if (err != cudaSuccess) return err;
      mma_kernel<D>(p.S, p.C)<<<grid, kMmaThreads, make_mma_layout(D, p.S, p.C).total,
                                 stream>>>(p);
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

// Blocks of the tensor-core kernel an SM at (d, S, C), or -1.
inline int mma_blocks_per_sm(int d, int S, int C) {
  switch (d) {
    case 16: return mma_blocks_per_sm<16>(S, C);
    case 32: return mma_blocks_per_sm<32>(S, C);
    case 48: return mma_blocks_per_sm<48>(S, C);
    case 64: return mma_blocks_per_sm<64>(S, C);
    case 128: return mma_blocks_per_sm<128>(S, C);
    default: return -1;
  }
}

}  // namespace eva_window
