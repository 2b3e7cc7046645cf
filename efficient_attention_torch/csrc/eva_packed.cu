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
//
// The backward has a second route, on tensor cores, for bf16 with head dims
// a multiple of 16 (bwd_uses_mma; everything else takes the CUDA-core kernel
// above).  Its roundings are the ones mma.sync m16n8k16 computes: bf16
// operands, f32 sums, so the same function as the CUDA-core route; the
// logits are held in base 2 (scale and bias times log2 e, one ex2 for each
// exp), which moves P by about 1e-7 relative, far below its bf16 rounding.
// A block of 4 warps takes wpb windows of one (image, head) in turn.  Design:
//  * staging in bf16: q, g [S][D+8], keys [k | rf] and values [v | beta]
//    [S+C][D+8], copied 16 bytes at a time (cp.async); the chunk rows once a
//    block, the next window's k and v rows while the transposed products of
//    this one run.  Rows are padded by 16 bytes so that the 8 rows an
//    ldmatrix reads fall in 8 different bank groups.  Rows past the end are
//    never stored: the fragment loads read the last real row instead (keys
//    and values past S + C, q and g past S: their logits are masked to
//    -inf, or their rows of P and dS are 0) or a zero row (P and dS past S);
//  * a warp owns a strip of 16 query rows of a window and computes its
//    logits and dP = g vals^T as mma.sync accumulator fragments, 16 key
//    columns at a time.  Where S + C <= 112 (the one-pass kernel) the
//    strip's fragments stay in registers: the row max, then exp(s - max) in
//    place and the row sums of P and P dP, each reduced over the quad of
//    threads that shares a row (two shuffles, no block-wide step).  Wider
//    strips take two passes: the row statistics online (as in flash
//    attention), then the products again.  Then P and dS = P (dP - sum P dP)
//    in f32; dS into the block's dbias (each element owned by one thread: no
//    atomics, no barrier); P and dS rounded to bf16 into shared memory for
//    the transposed products; dq = dS keys with the dS fragments repacked in
//    registers as operands;
//  * after one barrier, [dk | drf] = dS^T q and [dv | dbeta] = P^T g: the
//    warps share the 16-row output tiles, reading P, dS, q and g through
//    ldmatrix.trans; window rows go to dqkv, chunk rows are summed over the
//    block's windows in shared f32 and added once per block with f32
//    atomics (four at a time for drf and dbeta), as on the CUDA-core route.
// 112,000 bytes of shared memory at the DeiT-tiny-p8 shape (head dim 64,
// 49 + 49 keys), so two blocks fit an SM.  mma.sync and cp.async only: no
// wgmma or TMA.
//
// The forward has a tensor-core route too, behind the same gate
// (fwd_uses_mma: bf16, head dims a multiple of 16; f32 and head dim 12 keep
// the CUDA-core kernel above).  The same roundings as the TPU kernel: the
// numerators exp(s - max) rounded to bf16 as the value product's A operand,
// the denominator the f32 sum of the unrounded ones, out / denom in f32,
// then rounded.  A block of 4 warps takes wpb windows of one (image, head)
// in turn.  Design:
//  * staging in bf16 (16-byte cp.async through the token table): the chunk
//    rows rf and beta [C][D+8] once a block; a window's q, k and v rows
//    [S][D+8] in two buffers, the next window's loading while this one is
//    computed, so one barrier a window; the bias in f32, times log2 e.  No
//    logit matrix in shared memory: 67,968 bytes at the DeiT-tiny-p8 shape,
//    three blocks an SM;
//  * a warp owns a strip of 16 query rows and computes its logits as
//    mma.sync accumulator fragments, 16 key columns [k | rf] at a time.
//    Where S + C <= 112 the strip's fragments stay in registers: the row
//    max over the quad, the numerators exp(s - max) in place, their f32 sum.
//    Wider strips take two passes: the row max alone, then the logits again
//    (no running rescale, which would round the numerators at a running max
//    instead of the final one);
//  * out += P [v | beta] on tensor cores, P's fragments repacked in
//    registers as bf16 operands, the values read through ldmatrix.trans;
//    key and value rows past S + C read the last real row (their P is 0);
//  * the strip's rows, divided by the denominator and rounded, are staged in
//    the strip's own q rows and leave 16 bytes a thread to their tokens.
// The strip's constants and tiles (fwd_logits_tile, fwd_pv_tile) are in
// eva_strip.cuh, shared with K11 and K12's tensor-core kernel
// (eva_window.cuh), which holds its own copy of the strip body below:
// calling a shared body from this kernel raised its register count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "eva_strip.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;
// Windows a block takes in turn at most (WINDOWS_PER_BLOCK in the wrapper):
// the tensor-core backward's token table holds their rows.
constexpr int kMaxWpb = 4;

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

__host__ __device__ inline bool uses_mma(int D, int itemsize) {
  return itemsize == 2 && D % 16 == 0;
}

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }
__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Offsets (bytes) of the tensor-core backward's shared memory; the same
// layout as smem_bytes() in ops/kernels/eva_packed.py.  bf16: q and g
// [S][D+8], keys and values [S+C][D+8], P and dS [S][KB] and one zero row
// [KB], KB = round16(S+C) + 8; f32: the bias and dbias [S][S], the block's
// drf and dbeta sums [C][D]; int32: the token index of each row of the
// block's windows [kMaxWpb][S].
struct MmaLayout {
  size_t q, g, keys, vals, P, Ds, zero, bias, dbias, drf, dbeta, tok, total;
};

__host__ __device__ inline MmaLayout make_mma_layout(int D, int S, int C) {
  const size_t DB = D + 8, SC = S + C, KB = round16(S + C) + 8;
  MmaLayout L = {};
  size_t o = 0;
  L.q = o;     o += align128(S * DB * 2);
  L.g = o;     o += align128(S * DB * 2);
  L.keys = o;  o += align128(SC * DB * 2);
  L.vals = o;  o += align128(SC * DB * 2);
  L.P = o;     o += align128(S * KB * 2);
  L.Ds = o;    o += align128(S * KB * 2);
  L.zero = o;  o += align128(KB * 2);
  L.bias = o;  o += align128((size_t)S * S * 4);
  L.dbias = o; o += align128((size_t)S * S * 4);
  L.drf = o;   o += align128((size_t)C * D * 4);
  L.dbeta = o; o += align128((size_t)C * D * 4);
  L.tok = o;   o += align128((size_t)kMaxWpb * S * 4);
  L.total = o;
  return L;
}

// Offsets (bytes) of the tensor-core forward's shared memory; the same
// layout as smem_bytes() in ops/kernels/eva_packed.py.  bf16: a window's q,
// k and v rows [S][D+8] in two buffers each (buffer b at b * win), the chunk
// rows rf and beta [C][D+8]; f32: the bias [S][S]; int32: the token table
// [kMaxWpb][S].
struct FwdMmaLayout {
  size_t win, q, kw, vw, kc, vc, bias, tok, total;
};

__host__ __device__ inline FwdMmaLayout make_fwd_mma_layout(int D, int S, int C) {
  const size_t DB = D + 8;
  FwdMmaLayout L = {};
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

using bf16 = __nv_bfloat16;

// The strip constants, shared with K11 and K12 (eva_strip.cuh).
using eva_strip::kLog2e;
using eva_strip::kResidentTiles;

// One 16-column tile kt of a strip's logits s (scaled, the bias added on
// the window's columns, -inf past S + C) and of dP = g vals^T, from the
// strip's q and g fragments qa, ga.  Rows are the thread's row0 and
// row0 + 8; s[n][e] and dp[n][e] are column kt*16 + 8n + 2(lane%4) + e%2
// of row row0 + 8 (e / 2).
template <int D>
__device__ __forceinline__ void strip_tile(const Params& p, int kt, int row0,
                                           const uint32_t (&qa)[D / 16][4],
                                           const uint32_t (&ga)[D / 16][4], const bf16* keys,
                                           const bf16* vals, const float* bias_s,
                                           float (&s)[2][4], float (&dp)[2][4]) {
  using namespace mma_frag;
  constexpr int DB = D + 8;
  const int lane = threadIdx.x & 31, SC = p.S + p.C;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  const int j = min(kt * 16 + row_c(lane), SC - 1);
  const bf16* kr = keys + j * DB + col_c(lane);
  const bf16* vr = vals + j * DB + col_c(lane);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t bk[4], bv[4];
    ldsm_x4(bk, kr + 16 * kd);
    ldsm_x4(bv, vr + 16 * kd);
    mma_bf16(s[0], qa[kd], bk[0], bk[1]);
    mma_bf16(s[1], qa[kd], bk[2], bk[3]);
    mma_bf16(dp[0], ga[kd], bv[0], bv[1]);
    mma_bf16(dp[1], ga[kd], bv[2], bv[3]);
  }
  // the bias only on tiles with window columns, the mask only on the last
  // tile (both tests uniform over the warp); the padding rows past S read
  // the bias of row S - 1, their P being 0
  const bool window_cols = kt * 16 < p.S, masked = kt * 16 + 16 > SC;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = min(row0 + 8 * (e >> 1), p.S - 1);
      const int jj = kt * 16 + 8 * n + 2 * (threadIdx.x & 3) + (e & 1);
      float v = s[n][e] * (p.scale * kLog2e);
      if (window_cols && jj < p.S) v += bias_s[i * p.S + jj];
      if (masked && jj >= SC) v = -INFINITY;
      s[n][e] = v;
    }
}

// The row statistics of one tile, online: the max m of the thread's columns
// so far, the sum l of exp(s - m) and the sum t of exp(s - m) dP, rescaled
// as m grows.
__device__ __forceinline__ void online_stats(const float (&s)[2][4], const float (&dp)[2][4],
                                             float (&m)[2], float (&l)[2], float (&t)[2]) {
  using mma_frag::exp2_approx;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                       fmaxf(s[1][2 * r], s[1][2 * r + 1])));
    if (mn == -INFINITY) continue;  // every column so far masked
    const float alpha = exp2_approx(m[r] - mn);
    float sl = 0.f, st = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float x = exp2_approx(s[n][e] - mn);
        sl += x;
        st = fmaf(x, dp[n][e], st);
      }
    l[r] = fmaf(l[r], alpha, sl);
    t[r] = fmaf(t[r], alpha, st);
    m[r] = mn;
  }
}

// Tile kt of a strip from its numerators x = exp(s - m) and dP: P = x / l
// (0 on the padding rows past S) and dS = P (dP - sum_j P dP) in f32; dS
// into the block's dbias; P and dS rounded to bf16 into shared memory (rows
// below S); returns dS as the A fragment (bf16) of the product dS keys.
template <int D>
__device__ __forceinline__ void strip_store(const Params& p, int kt, int row0,
                                            const float (&x)[2][4], const float (&dp)[2][4],
                                            const float (&inv_l)[2], const float (&ds)[2],
                                            bf16* Ps, bf16* Dss, float* dbias_s, int KB,
                                            uint32_t (&a)[4]) {
  using namespace mma_frag;
  const int S = p.S, lane = threadIdx.x & 31, cq = 2 * (lane & 3);
  // rows past S only in the strip's last 8 rows of the window, dbias only on
  // tiles with window columns (both tests uniform over the warp)
  const bool pad_rows = row0 - (lane >> 2) + 16 > S, window_cols = kt * 16 < S;
  float pn[2][4], dsf[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, i = row0 + 8 * r, j = kt * 16 + 8 * n + cq + (e & 1);
      pn[n][e] = pad_rows && i >= S ? 0.f : x[n][e] * inv_l[r];
      dsf[n][e] = pn[n][e] * (dp[n][e] - ds[r]);
      if (window_cols && i < S && j < S) dbias_s[i * S + j] += dsf[n][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i >= S) continue;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int j = kt * 16 + 8 * n + cq;
      *reinterpret_cast<uint32_t*>(Ps + i * KB + j) = pack_bf16(pn[n][2 * r], pn[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(Dss + i * KB + j) =
          pack_bf16(dsf[n][2 * r], dsf[n][2 * r + 1]);
    }
  }
  c_to_a(dsf[0], dsf[1], a);
}

// dq += dS keys over key tile kt, from dS's A fragment a.
template <int D>
__device__ __forceinline__ void strip_dq(const Params& p, int kt, const uint32_t (&a)[4],
                                         const bf16* keys, float (&dq)[D / 8][4]) {
  using namespace mma_frag;
  constexpr int DB = D + 8;
  const int lane = threadIdx.x & 31;
  const bf16* kr = keys + min(kt * 16 + row_r(lane), p.S + p.C - 1) * DB + col_r(lane);
#pragma unroll
  for (int nd = 0; nd < D / 16; ++nd) {
    uint32_t bk[4];
    ldsm_x4_trans(bk, kr + 16 * nd);
    mma_bf16(dq[2 * nd], a, bk[0], bk[1]);
    mma_bf16(dq[2 * nd + 1], a, bk[2], bk[3]);
  }
}

// Two of a window's row sets into shared memory with 16-byte asynchronous
// copies: q and g (qg) or the window's keys and values (k and v, rows 0 to
// S - 1 of keys and vals); tok holds the window's token indices.
template <int D>
__device__ __forceinline__ void load_window_mma(const Params& p, const int* tok,
                                                const bf16* qkv, const bf16* g, bool qg,
                                                bf16* dst0, bf16* dst1) {
  using namespace mma_frag;
  constexpr int DB = D + 8, V8 = D / 8;
  const int HD = p.nh * D;
  for (int e = threadIdx.x; e < p.S * 2 * V8; e += kMmaThreads) {
    const int v = e % V8, which = (e / V8) % 2, l = e / (2 * V8);
    const size_t t = tok[l];
    const bf16* src = qg && which ? g + t * HD : qkv + t * 3 * HD + (qg ? 0 : 1 + which) * HD;
    cp_async16((which ? dst1 : dst0) + l * DB + 8 * v, src + 8 * v);
  }
  cp_async_commit();
}

// The tensor-core backward (bf16, D a multiple of 16): the design is in the
// header comment.  A block takes wpb windows of one (image, head) in turn.
// kOnePass: S + C <= 16 * kResidentTiles, a strip's logits and dP stay in
// registers between the row statistics and their use.
template <int D, bool kOnePass>
__global__ void __launch_bounds__(kMmaThreads, 2) eva_packed_bwd_mma_kernel(const Params p) {
  using namespace mma_frag;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int DB = D + 8, KD = D / 16, V8 = D / 8;
  const int S = p.S, C = p.C, SC = S + C, KT = round16(SC) / 16, KB = 16 * KT + 8;
  const int NS = (S + 15) / 16;  // strips of 16 query rows
  const MmaLayout L = make_mma_layout(D, S, C);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);        // [S][DB]
  bf16* gs = reinterpret_cast<bf16*>(smem + L.g);        // [S][DB]
  bf16* keys = reinterpret_cast<bf16*>(smem + L.keys);   // [S+C][DB]: k | rf
  bf16* vals = reinterpret_cast<bf16*>(smem + L.vals);   // [S+C][DB]: v | beta
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.P);        // [S][KB]
  bf16* Dss = reinterpret_cast<bf16*>(smem + L.Ds);      // [S][KB]
  bf16* zero = reinterpret_cast<bf16*>(smem + L.zero);   // [KB]
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);    // [S][S]
  float* dbias_s = reinterpret_cast<float*>(smem + L.dbias);  // [S][S]
  float* drf_s = reinterpret_cast<float*>(smem + L.drf);      // [C][D]
  float* dbeta_s = reinterpret_cast<float*>(smem + L.dbeta);  // [C][D]
  int* tok_s = reinterpret_cast<int*>(smem + L.tok);          // [kMaxWpb][S]
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HD = p.nh * D;
  const int cq = 2 * (lane & 3);  // the thread's first column in an 8-column tile
  const bf16* qkv = static_cast<const bf16*>(p.qkv) + (size_t)b * p.N * 3 * HD + h * D;
  const bf16* g = static_cast<const bf16*>(p.g) + (size_t)b * p.N * HD + h * D;
  bf16* dqkv = static_cast<bf16*>(p.out) + (size_t)b * p.N * 3 * HD + h * D;

  {  // the block's chunk rows, bias, zeroed sums and token table
    const bf16* rf = static_cast<const bf16*>(p.rf) + (size_t)b * C * HD + h * D;
    const bf16* bt = static_cast<const bf16*>(p.beta) + (size_t)b * C * HD + h * D;
    for (int e = tid; e < C * V8; e += kMmaThreads) {
      const int c = e / V8, v = e % V8;
      cp_async16(keys + (S + c) * DB + 8 * v, rf + (size_t)c * HD + 8 * v);
      cp_async16(vals + (S + c) * DB + 8 * v, bt + (size_t)c * HD + 8 * v);
    }
    const float* bh = p.bias != nullptr ? p.bias + (size_t)h * S * S : nullptr;
    for (int e = tid; e < S * S; e += kMmaThreads) {
      bias_s[e] = bh != nullptr ? kLog2e * bh[e] : 0.f;
      dbias_s[e] = 0.f;
    }
    for (int e = tid; e < C * D; e += kMmaThreads) drf_s[e] = dbeta_s[e] = 0.f;
    for (int e = tid; e < KB; e += kMmaThreads) zero[e] = __float2bfloat16(0.f);
    for (int e = tid; e < p.wpb * S; e += kMmaThreads)
      tok_s[e] = window_token(p, blockIdx.x * p.wpb + e / S, e % S);
    __syncthreads();
  }
  load_window_mma<D>(p, tok_s, qkv, g, false, keys, vals);
  for (int wi = 0; wi < p.wpb; ++wi) {
    const int* tok = tok_s + wi * S;
    // the window's q and g rows (its k and v rows were issued before)
    load_window_mma<D>(p, tok, qkv, g, true, qs, gs);
    cp_async_wait_all();
    __syncthreads();

    for (int st = warp; st < NS; st += kMmaWarps) {
      const int row0 = 16 * st + (lane >> 2);  // the thread's rows: row0, row0 + 8
      uint32_t qa[KD][4], ga[KD][4];
      {
        const int r = min(16 * st + row_r(lane), S - 1);
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          ldsm_x4(qa[kd], qs + r * DB + 16 * kd + col_r(lane));
          ldsm_x4(ga[kd], gs + r * DB + 16 * kd + col_r(lane));
        }
      }
      float dq[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
      float m[2], inv_l[2], ds[2];
      if constexpr (kOnePass) {
        // the logits and dP of every tile, then the row max over the quad,
        // the numerators exp(s - m) in place, and the row sums
        float s[kResidentTiles][2][4], dp[kResidentTiles][2][4];
        m[0] = m[1] = -INFINITY;
#pragma unroll
        for (int kt = 0; kt < kResidentTiles; ++kt) {
          if (kt >= KT) break;
          strip_tile<D>(p, kt, row0, qa, ga, keys, vals, bias_s, s[kt], dp[kt]);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            m[r] = fmaxf(m[r], fmaxf(fmaxf(s[kt][0][2 * r], s[kt][0][2 * r + 1]),
                                     fmaxf(s[kt][1][2 * r], s[kt][1][2 * r + 1])));
        }
        float l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
#pragma unroll
        for (int kt = 0; kt < kResidentTiles; ++kt) {
          if (kt >= KT) break;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              s[kt][n][e] = exp2_approx(s[kt][n][e] - m[r]);
              l[r] += s[kt][n][e];
              t[r] = fmaf(s[kt][n][e], dp[kt][n][e], t[r]);
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          inv_l[r] = 1.f / quad_sum(l[r]);
          ds[r] = quad_sum(t[r]) * inv_l[r];  // sum_j P dP
        }
#pragma unroll
        for (int kt = 0; kt < kResidentTiles; ++kt) {
          if (kt >= KT) break;
          uint32_t a[4];
          strip_store<D>(p, kt, row0, s[kt], dp[kt], inv_l, ds, Ps, Dss, dbias_s, KB, a);
          strip_dq<D>(p, kt, a, keys, dq);
        }
      } else {
        // pass 1: the row statistics online; pass 2: the products again
        float l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
        m[0] = m[1] = -INFINITY;
        for (int kt = 0; kt < KT; ++kt) {
          float s[2][4], dp[2][4];
          strip_tile<D>(p, kt, row0, qa, ga, keys, vals, bias_s, s, dp);
          online_stats(s, dp, m, l, t);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mq = quad_max(m[r]);
          const float alpha = m[r] == -INFINITY ? 0.f : exp2_approx(m[r] - mq);
          inv_l[r] = 1.f / quad_sum(l[r] * alpha);
          ds[r] = quad_sum(t[r] * alpha) * inv_l[r];
          m[r] = mq;
        }
        for (int kt = 0; kt < KT; ++kt) {
          float s[2][4], dp[2][4];
          strip_tile<D>(p, kt, row0, qa, ga, keys, vals, bias_s, s, dp);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = exp2_approx(s[n][e] - m[e >> 1]);
          uint32_t a[4];
          strip_store<D>(p, kt, row0, s, dp, inv_l, ds, Ps, Dss, dbias_s, KB, a);
          strip_dq<D>(p, kt, a, keys, dq);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + 8 * r;
        if (i >= S) continue;
        bf16* dst = dqkv + (size_t)tok[i] * 3 * HD + cq;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(dst + 8 * n) =
              pack_bf16(p.scale * dq[n][2 * r], p.scale * dq[n][2 * r + 1]);
      }
    }
    __syncthreads();
    // the next window's k and v rows load while the transposed products run
    if (wi + 1 < p.wpb) load_window_mma<D>(p, tok + S, qkv, g, false, keys, vals);

    // [dk | drf] = dS^T q (unit u even) and [dv | dbeta] = P^T g (u odd):
    // a unit is two 16-row output tiles of one product, which share the q
    // or g fragments; rows past S + C are dropped
    for (int u = warp; u < 2 * ((KT + 1) / 2); u += kMmaWarps) {
      const int mt = 2 * (u >> 1), which = u & 1;
      const bool two = mt + 1 < KT;  // uniform over the warp
      const bf16* X = which ? Ps : Dss;
      const bf16* Y = which ? gs : qs;
      float acc[2][D / 8][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < NS; ++ks) {
        const int ia = 16 * ks + row_c(lane);
        const bf16* xr = (ia < S ? X + ia * KB : zero) + 16 * mt + col_c(lane);
        uint32_t a[2][4];
        ldsm_x4_trans(a[0], xr);
        if (two) ldsm_x4_trans(a[1], xr + 16);
        const bf16* yr = Y + min(16 * ks + row_r(lane), S - 1) * DB + col_r(lane);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, yr + 16 * nd);
          mma_bf16(acc[0][2 * nd], a[0], bb[0], bb[1]);
          mma_bf16(acc[0][2 * nd + 1], a[0], bb[2], bb[3]);
          if (two) {
            mma_bf16(acc[1][2 * nd], a[1], bb[0], bb[1]);
            mma_bf16(acc[1][2 * nd + 1], a[1], bb[2], bb[3]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 1 && !two) break;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * (mt + m) + (lane >> 2) + 8 * r;
          if (row < S) {
            const float f = which ? 1.f : p.scale;
            bf16* dst = dqkv + (size_t)tok[row] * 3 * HD + (1 + which) * HD + cq;
#pragma unroll
            for (int n = 0; n < D / 8; ++n)
              *reinterpret_cast<uint32_t*>(dst + 8 * n) =
                  pack_bf16(f * acc[m][n][2 * r], f * acc[m][n][2 * r + 1]);
          } else if (row < SC) {
            float* dst = (which ? dbeta_s : drf_s) + (row - S) * D + cq;
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
              dst[8 * n] += acc[m][n][2 * r];
              dst[8 * n + 1] += acc[m][n][2 * r + 1];
            }
          }
        }
      }
    }
    __syncthreads();  // q, k, v, g, P and dS are rewritten by the next window
  }
  // one atomic add per element and block, as on the CUDA-core route, four
  // f32 at a time for drf and dbeta (drf takes its scale here, once)
  float* drf = p.drf + (size_t)b * C * HD + h * D;
  float* dbeta = p.dbeta + (size_t)b * C * HD + h * D;
  for (int e = tid; e < C * D / 4; e += kMmaThreads) {
    const int c = e / (D / 4), d = 4 * (e % (D / 4));
    const float4 x = reinterpret_cast<const float4*>(drf_s)[e];
    atomicAdd(reinterpret_cast<float4*>(drf + (size_t)c * HD + d),
              make_float4(p.scale * x.x, p.scale * x.y, p.scale * x.z, p.scale * x.w));
    atomicAdd(reinterpret_cast<float4*>(dbeta + (size_t)c * HD + d),
              reinterpret_cast<const float4*>(dbeta_s)[e]);
  }
  float* dbias = p.dbias + ((size_t)b * p.nh + h) * S * S;
  for (int e = tid; e < S * S; e += kMmaThreads) atomicAdd(dbias + e, dbias_s[e]);
}

// The forward strip's tiles, shared with K11 and K12 (eva_strip.cuh).
using eva_strip::fwd_logits_tile;
using eva_strip::fwd_pv_tile;

// A window's q, k and v rows into one buffer with 16-byte asynchronous
// copies; tok holds the window's token indices.
template <int D>
__device__ __forceinline__ void load_window_fwd(const Params& p, const int* tok,
                                                const bf16* qkv, bf16* q, bf16* kw, bf16* vw) {
  using namespace mma_frag;
  constexpr int DB = D + 8, V8 = D / 8;
  const int HD = p.nh * D;
  for (int e = threadIdx.x; e < p.S * 3 * V8; e += kMmaThreads) {
    const int v = e % V8, part = (e / V8) % 3, l = e / (3 * V8);
    bf16* dst = part == 0 ? q : part == 1 ? kw : vw;
    cp_async16(dst + l * DB + 8 * v, qkv + (size_t)tok[l] * 3 * HD + part * HD + 8 * v);
  }
  cp_async_commit();
}

// The tensor-core forward (bf16, D a multiple of 16): the design is in the
// header comment.  A block takes wpb windows of one (image, head) in turn.
// kOnePass: S + C <= 16 * kResidentTiles, a strip's logits stay in
// registers between the row max and their use.
template <int D, bool kOnePass>
__global__ void __launch_bounds__(kMmaThreads, 3) eva_packed_fwd_mma_kernel(const Params p) {
  using namespace mma_frag;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int DB = D + 8, KD = D / 16, V8 = D / 8;
  const int S = p.S, C = p.C, KT = round16(S + C) / 16;
  const int NS = (S + 15) / 16;  // strips of 16 query rows
  const FwdMmaLayout L = make_fwd_mma_layout(D, S, C);
  bf16* kc = reinterpret_cast<bf16*>(smem + L.kc);            // [C][DB]: rf
  bf16* vc = reinterpret_cast<bf16*>(smem + L.vc);            // [C][DB]: beta
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);    // [S][S]
  int* tok_s = reinterpret_cast<int*>(smem + L.tok);          // [kMaxWpb][S]
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HD = p.nh * D;
  const int cq = 2 * (lane & 3);  // the thread's first column in an 8-column tile
  const bf16* qkv = static_cast<const bf16*>(p.qkv) + (size_t)b * p.N * 3 * HD + h * D;
  bf16* out = static_cast<bf16*>(p.out) + (size_t)b * p.N * HD + h * D;
  // buffer `buf` of a window's q, k or v rows ([S][DB] each)
  auto rows = [&](size_t region, int buf) {
    return reinterpret_cast<bf16*>(smem + region + buf * L.win);
  };

  {  // the block's chunk rows, bias and token table
    const bf16* rf = static_cast<const bf16*>(p.rf) + (size_t)b * C * HD + h * D;
    const bf16* bt = static_cast<const bf16*>(p.beta) + (size_t)b * C * HD + h * D;
    for (int e = tid; e < C * V8; e += kMmaThreads) {
      const int c = e / V8, v = e % V8;
      cp_async16(kc + c * DB + 8 * v, rf + (size_t)c * HD + 8 * v);
      cp_async16(vc + c * DB + 8 * v, bt + (size_t)c * HD + 8 * v);
    }
    const float* bh = p.bias != nullptr ? p.bias + (size_t)h * S * S : nullptr;
    for (int e = tid; e < S * S; e += kMmaThreads)
      bias_s[e] = bh != nullptr ? kLog2e * bh[e] : 0.f;
    for (int e = tid; e < p.wpb * S; e += kMmaThreads)
      tok_s[e] = window_token(p, blockIdx.x * p.wpb + e / S, e % S);
    __syncthreads();
  }
  // the first window's rows, in one group with the chunk rows
  load_window_fwd<D>(p, tok_s, qkv, rows(L.q, 0), rows(L.kw, 0), rows(L.vw, 0));
  for (int wi = 0; wi < p.wpb; ++wi) {
    const int buf = wi & 1;
    const int* tok = tok_s + wi * S;
    bf16* qs = rows(L.q, buf);
    const bf16* kw = rows(L.kw, buf);
    const bf16* vw = rows(L.vw, buf);
    // this window's rows have landed, and every warp is done with the other
    // buffer, into which the next window's rows now load
    cp_async_wait_all();
    __syncthreads();
    if (wi + 1 < p.wpb)
      load_window_fwd<D>(p, tok + S, qkv, rows(L.q, buf ^ 1), rows(L.kw, buf ^ 1),
                         rows(L.vw, buf ^ 1));

    for (int st = warp; st < NS; st += kMmaWarps) {
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
        // the logits of every tile, then the row max over the quad, then
        // the numerators and the value product tile by tile
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
        // pass 1: the row max; pass 2: the logits again, the numerators and
        // the value product
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
      // out / denom in f32, rounded to bf16 into the strip's own q rows
      // (no other warp reads them), then 16 bytes a thread to the tokens
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
        *reinterpret_cast<uint4*>(out + (size_t)tok[i] * HD + 8 * v) =
            *reinterpret_cast<const uint4*>(qs + i * DB + 8 * v);
      }
    }
  }
}

// The tensor-core kernel of a direction and geometry (one pass where a
// strip's tiles fit the registers) and its shared memory.
template <int D>
auto mma_kernel(bool backward, int S, int C) {
  const bool one_pass = eva_strip::one_pass(S, C);
  if (backward)
    return one_pass ? eva_packed_bwd_mma_kernel<D, true> : eva_packed_bwd_mma_kernel<D, false>;
  return one_pass ? eva_packed_fwd_mma_kernel<D, true> : eva_packed_fwd_mma_kernel<D, false>;
}

inline size_t mma_smem(bool backward, int D, int S, int C) {
  return backward ? make_mma_layout(D, S, C).total : make_fwd_mma_layout(D, S, C).total;
}

template <int D>
cudaError_t prepare_mma(bool backward, int S, int C) {
  const auto kernel = mma_kernel<D>(backward, S, C);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mma_smem(backward, D, S, C));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D>
cudaError_t launch_mma(const Params& p, bool backward, cudaStream_t stream) {
  cudaError_t err = prepare_mma<D>(backward, p.S, p.C);
  if (err != cudaSuccess) return err;
  const int n_win = (p.N / p.gw / p.ws) * p.nww;
  const auto kernel = mma_kernel<D>(backward, p.S, p.C);
  kernel<<<dim3(n_win / p.wpb, p.nh, p.B), kMmaThreads, mma_smem(backward, D, p.S, p.C),
           stream>>>(p);
  return cudaGetLastError();
}

// Blocks of a tensor-core kernel that fit one SM (registers and shared
// memory), from the occupancy calculator.
template <int D>
int mma_blocks_per_sm(bool backward, int S, int C) {
  int blocks = 0;
  if (prepare_mma<D>(backward, S, C) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mma_kernel<D>(backward, S, C),
                                                    kMmaThreads,
                                                    mma_smem(backward, D, S, C)) != cudaSuccess)
    return -1;
  return blocks;
}

cudaError_t dispatch_mma(const Params& p, int d, bool backward, cudaStream_t s) {
  switch (d) {
    case 16: return launch_mma<16>(p, backward, s);
    case 32: return launch_mma<32>(p, backward, s);
    case 64: return launch_mma<64>(p, backward, s);
    default: return cudaErrorInvalidValue;
  }
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

// Whether the backward (bwd_uses_mma) and the forward (fwd_uses_mma) at
// head dim d and element size itemsize take their tensor-core routes (the
// functions of the same names in ops/kernels/eva_packed.py).
int bwd_uses_mma(int d, int itemsize) { return uses_mma(d, itemsize) ? 1 : 0; }
int fwd_uses_mma(int d, int itemsize) { return uses_mma(d, itemsize) ? 1 : 0; }

// Shared memory of one block of the route that (backward, d, itemsize)
// takes, for the wrapper's gate to check its own copy of the layout against.
int eva_packed_smem_bytes(int backward, int d, int S, int C, int itemsize) {
  if (uses_mma(d, itemsize)) return (int)mma_smem(backward != 0, d, S, C);
  return (int)make_layout(backward != 0, d, S, C).total;
}

// Blocks of the tensor-core backward (or forward) that fit one SM at
// (d, S, C), or -1.
int eva_packed_mma_blocks_per_sm(int backward, int d, int S, int C) {
  switch (d) {
    case 16: return mma_blocks_per_sm<16>(backward != 0, S, C);
    case 32: return mma_blocks_per_sm<32>(backward != 0, S, C);
    case 64: return mma_blocks_per_sm<64>(backward != 0, S, C);
    default: return -1;
  }
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

// The forward's tensor-core route on `stream` (bf16 operands; d 16, 32 or
// 64): the same output as eva_packed_fwd_launch.  Returns a cudaError_t.
int eva_packed_fwd_mma_launch(const void* qkv, const void* rf, const void* beta,
                              const float* bias, void* out, int B, int N, int gw, int ws,
                              int nh, int d, int C, int wpb, float scale, void* stream) {
  Params p = {};
  if (!make_params(p, B, N, gw, ws, nh, C, wpb, scale) || !uses_mma(d, 2) ||
      wpb > kMaxWpb)
    return cudaErrorInvalidValue;
  p.qkv = qkv; p.rf = rf; p.beta = beta; p.bias = bias; p.out = out;
  return dispatch_mma(p, d, false, static_cast<cudaStream_t>(stream));
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

// The backward's tensor-core route on `stream` (bf16 operands; d 16, 32 or
// 64): the same outputs as eva_packed_bwd_launch.  Returns a cudaError_t.
int eva_packed_bwd_mma_launch(const void* qkv, const void* rf, const void* beta,
                              const float* bias, const void* g, void* dqkv, float* drf,
                              float* dbeta, float* dbias, int B, int N, int gw, int ws,
                              int nh, int d, int C, int wpb, float scale, void* stream) {
  Params p = {};
  if (!make_params(p, B, N, gw, ws, nh, C, wpb, scale) || !uses_mma(d, 2) ||
      wpb > kMaxWpb)
    return cudaErrorInvalidValue;
  p.qkv = qkv; p.rf = rf; p.beta = beta; p.bias = bias; p.g = g; p.out = dqkv;
  p.drf = drf; p.dbeta = dbeta; p.dbias = dbias;
  return dispatch_mma(p, d, true, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
