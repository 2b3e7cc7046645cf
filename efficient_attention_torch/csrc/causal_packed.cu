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
//
// The f32 forward has a second route on tensor cores, taken by f32 at head
// dims 64 and 128 with w % 16 == 0 (uses_tf32x3; the LM step's shape):
// causal_packed_fwd_tf32x3_kernel.  What bounds it: operations.  At the
// LM shape in f32 the two products over the visible columns are 3.6 GFLOP,
// 54 us at the 67 TFLOP/s f32 peak, against 48 us for the bytes.  Plain
// TF32 would miss the f32 limit (logit errors about 5e-4 at head dim 128),
// so each product is split TF32 (mma_frag.cuh): three mma.sync m16n8k8
// products a fragment pair, f32 sums.  Design:
//  * a block takes qt (16, 32 or 64) query rows of one window of one (row,
//    head), a warp of 32 threads for each strip of 16 rows.  The block's
//    q rows are staged once in f32 (a warp splits its own where used:
//    held in registers, they took 64 more a thread and spilled at head dim
//    128);
//  * the keys and values come through a ring of two stages of 16 key rows
//    and 16 value rows in f32 (cp.async, 16 bytes a copy): the window's
//    local rows first, then the chunk rows rf / beta, so shared memory no
//    longer grows with C (72,192 bytes at head dim 128 with the q rows,
//    three blocks an SM).  Stage t + 1 loads while stage t is computed,
//    one barrier a stage;
//  * the block walks the tiles that its last row can see; a warp skips the
//    tiles its strip cannot see (local tiles past its last row, chunk
//    tiles at or past its last row's chunk limit), whose columns are
//    masked for all its rows (exp of MASK_VAL + ... is 0 in f32).  Local
//    key 0 comes first and every row sees it, so each row's running max is
//    finite from its first tile;
//  * a strip's logits are accumulator fragments (hi hi apart from the two
//    smaller products); scale and the table or chunk mask are applied in
//    base 2, then an online softmax in f32 (running max over the quad,
//    the output rescaled when it rises, ex2);  P's fragments are the A
//    operand of P [v | beta] with no shuffle (mma_frag.cuh), split too;
//  * the k-index of Q K^T runs over d in the order each thread's float4
//    holds it, and the n-index of P V over d likewise, so a thread loads
//    its q, k and v operands 16 bytes at a time and stores 32 bytes of a
//    row: q and k rows at a stride of D + 16 floats and v rows at D + 4
//    put the eight 16-byte loads of each quarter warp in distinct banks;
//  * the output is divided by the row sum once, in f32.
// In f32 the TPU kernel rounds nothing (round_to<float> is the identity),
// so the route differs from it by the split products' dropped terms and
// the order of sums.
//
// The f32 backward has a second route on the same products, behind
// bwd_uses_tf32x3 (the forward's gate and w <= 128; the LM step's shape):
// causal_packed_bwd_tf32x3_kernel.  What bounds it: operations.  At the LM
// shape the five products over the visible columns are 9.1 GFLOP, 135 us
// at the f32 peak, against 85 us for the bytes; recomputing S and dP for
// the row statistics adds two more products.  Design:
//  * a block takes a whole window of one (row, head): grid (T/w, H, B), a
//    warp of 32 threads for each strip of 16 rows (8 at w = 128).  The
//    window's q and g rows are staged once in f32; keys [k | rf] and values
//    [v | beta] come through the forward's ring of two 16-row cp.async
//    stages, the walk twice over.  The q, g, key and value rows are not
//    padded: their 16-byte chunks are XOR-swizzled by row (swz), because
//    the keys are read both along d (Q K^T) and across rows (dS K) and no
//    padding serves both without bank conflicts.  Two f32 tiles
//    [16 keys][w + 8] take the tile's P and dS.  181,248 bytes at head dim
//    128 and w = 128: one block an SM;
//  * the block walks every local tile, then the chunk tiles its last row
//    sees (the forward's walk for qt = w); a warp skips the tiles its strip
//    cannot see.  Pass 1: a warp forms S = Q K^T and dP = G V^T in split
//    TF32 (hi hi apart from the two smaller products) and keeps, in base
//    2 and f32, each row's online max m, l = sum 2^(s - m) and
//    D = sum 2^(s - m) dP, rescaled when m rises; D / l is the TPU
//    kernel's ds = sum(P dP).  Pass 2, a tile at a time: S and dP again,
//    bit for bit; P = 2^(s - m) / l and dS = P (dP - ds) in f32; the f32
//    dS of the local columns added into the dbias partials; dq += dS keys
//    from the accumulator fragments (mma_frag.cuh), 64 floats a thread at
//    head dim 128; P and dS into their tiles.  After a barrier the warps
//    split d in 8 column groups and form the tile's dk = scale dS^T q and
//    dv = P^T g (drf and dbeta for a chunk tile) over the query rows of
//    the strips that see it;
//  * reductions: dq and a window's dk and dv are complete in their block
//    and stored once, with no atomics and no zeroed buffers; drf and dbeta
//    take f32 atomics into zeroed [B, C, H*D] buffers (T/w adds an
//    address), the dbias partials [B, H, w, w] (T/w adds) as before.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

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
  float* dk;          // backward: [B, T, nh*D], zeroed (CUDA-core kernel)
  float* dv;          // backward: [B, T, nh*D], zeroed (CUDA-core kernel)
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

// ---- the f32 forward in split TF32 on tensor cores (header comment)

constexpr int kTf32Keys = 16;      // key (and value) rows a stage
constexpr int kTf32N = kTf32Keys / 8;  // n-tiles of Q K^T, k-steps of P V
constexpr int kTf32Stages = 2;
constexpr int kTf32MaxRows = 64;   // query rows a block, at most
constexpr float kLog2e = 1.4426950408889634f;

// Whether f32 at head dim D and window w takes the route (element size
// `itemsize`): the twin of fwd_uses_tf32x3 in ops/kernels/causal_packed.py.
__host__ __device__ inline bool uses_tf32x3(int D, int w, int itemsize) {
  return itemsize == 4 && (D == 64 || D == 128) && w % 16 == 0;
}

// Row strides (floats) of the q and key rows (16 mod 32: a quarter warp
// reads 16 floats of each of two rows) and of the value rows (4 mod 32: a
// quarter warp reads 16 bytes at column 4g of rows 2c, g < 2, c < 4).
__host__ __device__ constexpr int tf32_k_stride(int D) { return D + 16; }
__host__ __device__ constexpr int tf32_v_stride(int D) { return D + 4; }

// Offsets (bytes) of the q rows and of stage 0's key and value rows, a
// stage's size and the total; the same layout as tf32_smem_bytes() in
// ops/kernels/causal_packed.py.
struct Tf32Layout {
  size_t q, k, v, stage, total;
};

__host__ __device__ inline Tf32Layout make_tf32_layout(int D) {
  Tf32Layout L;
  L.q = 0;
  L.k = (size_t)kTf32MaxRows * tf32_k_stride(D) * 4;
  L.v = L.k + (size_t)kTf32Keys * tf32_k_stride(D) * 4;
  L.stage = (size_t)kTf32Keys * (tf32_k_stride(D) + tf32_v_stride(D)) * 4;
  L.total = L.k + kTf32Stages * L.stage;
  return L;
}

// The chunks below the limit of window row `last` of window g.
__device__ __forceinline__ int chunk_limit(const Params& p, int g, int last) {
  return min(p.C, g * (p.w / p.cs) + last / p.cs);
}

template <int D>
__global__ void __launch_bounds__(128, 3) causal_packed_fwd_tf32x3_kernel(const Params p) {
  using namespace mma_frag;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KS = tf32_k_stride(D), VS = tf32_v_stride(D), V4 = D / 4;
  constexpr int KP = D / 16;  // pairs of k-steps of Q K^T
  constexpr int NQ = D / 32;  // groups of four n-tiles of P V
  const Tf32Layout L = make_tf32_layout(D);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, cq = lane & 3;
  const int HD = p.nh * D;
  const int t0 = blockIdx.x * p.qt, g = t0 / p.w, r0 = t0 % p.w;
  const float* qg = static_cast<const float*>(p.q);
  const float* kg = static_cast<const float*>(p.k);
  const float* vg = static_cast<const float*>(p.v);
  const float* rfg = static_cast<const float*>(p.rf);
  const float* btg = static_cast<const float*>(p.beta);
  const size_t win = ((size_t)b * p.T + (size_t)g * p.w) * HD + h * D;  // window's token 0
  const size_t cd = (size_t)b * p.C * HD + h * D;
  // the block's walk: local tiles to its last row, then the chunk tiles
  const int nloc = (r0 + p.qt - 1) / kTf32Keys + 1;
  const int ntiles = nloc + (chunk_limit(p, g, r0 + p.qt - 1) + kTf32Keys - 1) / kTf32Keys;
  // the strip's: rows rs .. rs + 15; the thread's rows rs + gq and rs + gq + 8
  const int rs = r0 + 16 * warp, last = rs + 15;
  const int sloc = last / kTf32Keys + 1;
  const int slim = chunk_limit(p, g, last);
  const int sch = (slim + kTf32Keys - 1) / kTf32Keys;
  float* qs = reinterpret_cast<float*>(smem + L.q);  // [qt][KS]

  // stage `buf` <- tile t's key rows and value rows; rows past the window's
  // w (or the C chunks) copy the last real row, finite, and their columns
  // are masked to -inf
  auto load_tile = [&](int t, int buf) {
    float* ks = reinterpret_cast<float*>(smem + L.k + buf * L.stage);
    float* vs = reinterpret_cast<float*>(smem + L.v + buf * L.stage);
    const bool local = t < nloc;
    const float* ksrc = local ? kg + win : rfg + cd;
    const float* vsrc = local ? vg + win : btg + cd;
    const int base = kTf32Keys * (local ? t : t - nloc), n = local ? p.w : p.C;
    for (int e = tid; e < kTf32Keys * V4; e += blockDim.x) {
      const int r = e / V4, c4 = e % V4;
      const size_t src = (size_t)min(base + r, n - 1) * HD + 4 * c4;
      cp_async16(ks + r * KS + 4 * c4, ksrc + src);
      cp_async16(vs + r * VS + 4 * c4, vsrc + src);
    }
    cp_async_commit();
  };
  // the block's q rows, in one group with the first tile
  for (int e = tid; e < p.qt * V4; e += blockDim.x) {
    const int r = e / V4, c4 = e % V4;
    cp_async16(qs + r * KS + 4 * c4, qg + win + (size_t)(r0 + r) * HD + 4 * c4);
  }
  load_tile(0, 0);
  // o[nq][tt]: n-tile tt of group nq, its column n is d = 32nq + 4n + tt
  float o[NQ][4][4];
#pragma unroll
  for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
    for (int tt = 0; tt < 4; ++tt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nq][tt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float scale2 = p.scale * kLog2e;
  const int climit[2] = {g * (p.w / p.cs) + (rs + gq) / p.cs,
                         g * (p.w / p.cs) + (rs + gq + 8) / p.cs};

  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed, and every warp is done with the other stage
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < ntiles) load_tile(t + 1, (t + 1) & 1);
    const bool local = t < nloc;
    const int u = local ? t : t - nloc;
    if (local ? u >= sloc : u >= sch) continue;  // masked for the whole strip
    const float* ks = reinterpret_cast<const float*>(smem + L.k + (t & 1) * L.stage);
    const float* vs = reinterpret_cast<const float*>(smem + L.v + (t & 1) * L.stage);

    // S = Q K^T over the tile's keys: hi hi into sb, hi lo + lo hi into ss
    float sb[kTf32N][4], ss[kTf32N][4];
#pragma unroll
    for (int n = 0; n < kTf32N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[n][e] = ss[n][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      // rows rs + gq and rs + gq + 8, columns 16kp + 4cq .. + 3: k-step 2kp
      // takes .x (A column cq) and .y (column cq + 4), k-step 2kp + 1 .z, .w
      float4 qa[2];
      const float* qr = qs + (16 * warp + gq) * KS + 16 * kp + 4 * cq;
      qa[0] = *reinterpret_cast<const float4*>(qr);
      qa[1] = *reinterpret_cast<const float4*>(qr + 8 * KS);
      float4 kk[kTf32N];
#pragma unroll
      for (int n = 0; n < kTf32N; ++n)
        kk[n] = *reinterpret_cast<const float4*>(ks + (8 * n + gq) * KS + 16 * kp + 4 * cq);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float av[4] = {half ? qa[0].z : qa[0].x, half ? qa[1].z : qa[1].x,
                             half ? qa[0].w : qa[0].y, half ? qa[1].w : qa[1].y};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
#pragma unroll
        for (int n = 0; n < kTf32N; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(half ? kk[n].z : kk[n].x, bh0, bl0);
          split_tf32(half ? kk[n].w : kk[n].y, bh1, bl1);
          mma_tf32(ss[n], al, bh0, bh1);
          mma_tf32(ss[n], ah, bl0, bl1);
          mma_tf32(sb[n], ah, bh0, bh1);
        }
      }
    }

    // logits in base 2 with the table (local tiles: row rs + gq + 8r,
    // columns kTf32Keys u + 8n + 2cq, + 1) or the chunk mask, the running
    // max and the numerators; s[n][e] is row rs + gq + 8(e / 2), tile
    // column 8n + 2cq + e % 2
    float s[kTf32N][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kTf32N; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = kTf32Keys * u + 8 * n + 2 * cq;
        float2 add;
        if (local) {
          add = j < p.w ? __ldg(reinterpret_cast<const float2*>(
                              p.tab + (size_t)(rs + gq + 8 * r) * p.w + j))
                        : make_float2(-INFINITY, -INFINITY);
        } else {
          add.x = j >= p.C ? -INFINITY : (j >= climit[r] ? kMaskVal : 0.f);
          add.y = j + 1 >= p.C ? -INFINITY : (j + 1 >= climit[r] ? kMaskVal : 0.f);
        }
        s[n][2 * r] = fmaf(sb[n][2 * r] + ss[n][2 * r], scale2, add.x * kLog2e);
        s[n][2 * r + 1] = fmaf(sb[n][2 * r + 1] + ss[n][2 * r + 1], scale2, add.y * kLog2e);
        mx[r] = fmaxf(mx[r], fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      const float alpha = exp2_approx(m[r] - mn);  // 0 on the first tile
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          o[nq][tt][2 * r] *= alpha;
          o[nq][tt][2 * r + 1] *= alpha;
        }
    }
#pragma unroll
    for (int n = 0; n < kTf32N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }

    // O += P [v | beta]: k-step j takes the tile's keys 8j .. 8j + 7, A
    // column cq as key 8j + 2cq and column cq + 4 as key 8j + 2cq + 1
#pragma unroll
    for (int j = 0; j < kTf32N; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(s[j][0], ah[0], al[0]);
      split_tf32(s[j][2], ah[1], al[1]);
      split_tf32(s[j][1], ah[2], al[2]);
      split_tf32(s[j][3], ah[3], al[3]);
      const float* v0 = vs + (8 * j + 2 * cq) * VS + 4 * gq;
#pragma unroll
      for (int nq = 0; nq < NQ; ++nq) {
        const float4 x0 = *reinterpret_cast<const float4*>(v0 + 32 * nq);
        const float4 x1 = *reinterpret_cast<const float4*>(v0 + VS + 32 * nq);
        const float b0[4] = {x0.x, x0.y, x0.z, x0.w}, b1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b0[tt], bh0, bl0);
          split_tf32(b1[tt], bh1, bl1);
          mma_tf32(o[nq][tt], al, bh0, bh1);
          mma_tf32(o[nq][tt], ah, bl0, bl1);
          mma_tf32(o[nq][tt], ah, bh0, bh1);
        }
      }
    }
  }

  // out = O / row sum in f32; a thread's 8 values of a row and group are
  // columns 32nq + 8cq .. + 7
  float* out = static_cast<float*>(p.out) + win;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = quad_sum(l[r]);
    float* orow = out + (size_t)(rs + gq + 8 * r) * HD + 8 * cq;
#pragma unroll
    for (int nq = 0; nq < NQ; ++nq) {
      *reinterpret_cast<float4*>(orow + 32 * nq) =
          make_float4(o[nq][0][2 * r] / den, o[nq][1][2 * r] / den, o[nq][2][2 * r] / den,
                      o[nq][3][2 * r] / den);
      *reinterpret_cast<float4*>(orow + 32 * nq + 4) =
          make_float4(o[nq][0][2 * r + 1] / den, o[nq][1][2 * r + 1] / den,
                      o[nq][2][2 * r + 1] / den, o[nq][3][2 * r + 1] / den);
    }
  }
}

template <int D>
cudaError_t prepare_tf32() {
  const auto kernel = causal_packed_fwd_tf32x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)make_tf32_layout(D).total);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D>
cudaError_t launch_tf32(const Params& p, cudaStream_t stream) {
  cudaError_t err = prepare_tf32<D>();
  if (err != cudaSuccess) return err;
  // a warp for each strip of 16 query rows
  causal_packed_fwd_tf32x3_kernel<D><<<dim3(p.T / p.qt, p.nh, p.B), 2 * p.qt,
                                       make_tf32_layout(D).total, stream>>>(p);
  return cudaGetLastError();
}

// Blocks of the route's kernel that fit one SM at 64 query rows a block
// (registers and shared memory), from the occupancy calculator, or -1.
template <int D>
int tf32_blocks_per_sm() {
  int blocks = 0;
  if (prepare_tf32<D>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, causal_packed_fwd_tf32x3_kernel<D>, 128,
          make_tf32_layout(D).total) != cudaSuccess)
    return -1;
  return blocks;
}

// ---- the f32 backward in split TF32 on tensor cores (header comment)

constexpr int kTf32BwdMaxW = 128;  // window rows a block, at most (a warp a strip)

// Whether the f32 backward at head dim D and window w takes the route: the
// twin of bwd_uses_tf32x3 in ops/kernels/causal_packed.py.
__host__ __device__ inline bool bwd_uses_tf32x3(int D, int w, int itemsize) {
  return uses_tf32x3(D, w, itemsize) && w <= kTf32BwdMaxW;
}

// Row stride (floats) of the P and dS tiles [16 keys][w queries]: 8 mod 16,
// so that the float2 loads of a half warp (keys g < 4, queries 2c, c < 4)
// fall in distinct banks.
__host__ __device__ constexpr int tf32_bwd_tile_stride(int w) { return w + 8; }

// Offsets (bytes) of the q and g rows, of stage 0's key and value rows, a
// stage's size, the P and dS tiles and the total; the same layout as
// tf32_bwd_smem_bytes() in ops/kernels/causal_packed.py.
struct Tf32BwdLayout {
  size_t q, g, k, v, stage, P, dS, total;
};

__host__ __device__ inline Tf32BwdLayout make_tf32_bwd_layout(int D, int w) {
  Tf32BwdLayout L;
  const size_t rows = (size_t)w * D * 4, tile = (size_t)kTf32Keys * tf32_bwd_tile_stride(w) * 4;
  L.q = 0;
  L.g = rows;
  L.k = 2 * rows;
  L.v = L.k + (size_t)kTf32Keys * D * 4;
  L.stage = (size_t)kTf32Keys * 2 * D * 4;
  L.P = L.k + kTf32Stages * L.stage;
  L.dS = L.P + tile;
  L.total = L.dS + tile;
  return L;
}

// The q, g, key and value rows are D floats with no padding; chunk c (16
// bytes) of row r sits at chunk c ^ swz(r).  Both ways the products read
// them then fall in distinct banks: float4 of chunk 4k + c from rows g and
// g + 1 (a quarter warp: swz differs in bit 2), and float4 of chunk 8n + g
// (or float2 / float from it) from rows 2c and 2c + 1 (swz(2c) = 2c).
__device__ __forceinline__ int swz(int r) { return (r & 6) ^ ((r & 1) << 2); }
template <int D>
__device__ __forceinline__ int swz_at(int r, int d) {
  return r * D + ((((d >> 2) ^ swz(r)) << 2) | (d & 3));
}

// n consecutive floats (n = 1 or 2, 8-byte aligned) from shared memory.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&x)[N]) {
  if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) causal_packed_bwd_tf32x3_kernel(const Params p) {
  using namespace mma_frag;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V4 = D / 4;
  constexpr int KP = D / 16;  // pairs of k-steps of Q K^T and G V^T
  constexpr int NQ = D / 32;  // groups of four n-tiles of dS K
  constexpr int NG = D / 64;  // n-tiles of a column group of dk / dv (8 groups)
  const Tf32BwdLayout L = make_tf32_bwd_layout(D, p.w);
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int gq = lane >> 2, cq = lane & 3;
  const int HD = p.nh * D, SP = tf32_bwd_tile_stride(p.w);
  const float* qg = static_cast<const float*>(p.q);
  const float* kg = static_cast<const float*>(p.k);
  const float* vg = static_cast<const float*>(p.v);
  const float* rfg = static_cast<const float*>(p.rf);
  const float* btg = static_cast<const float*>(p.beta);
  const float* gg = static_cast<const float*>(p.g);
  const size_t win = ((size_t)b * p.T + (size_t)g * p.w) * HD + h * D;  // window's token 0
  const size_t cd = (size_t)b * p.C * HD + h * D;
  // the block's walk (twice: pass 1, then pass 2): every local tile, then
  // the chunk tiles its last row sees
  const int nloc = p.w / kTf32Keys;
  const int ntiles = nloc + (chunk_limit(p, g, p.w - 1) + kTf32Keys - 1) / kTf32Keys;
  // the warp's strip: rows rs .. rs + 15, local tiles 0 .. warp, chunk
  // tiles below sch; the thread's rows rs + gq and rs + gq + 8
  const int rs = 16 * warp;
  const int sch = (chunk_limit(p, g, rs + 15) + kTf32Keys - 1) / kTf32Keys;
  float* qs = reinterpret_cast<float*>(smem + L.q);   // [w][D], swizzled
  float* gs = reinterpret_cast<float*>(smem + L.g);   // [w][D], swizzled
  float* Pt = reinterpret_cast<float*>(smem + L.P);   // [16 keys][SP]
  float* Dt = reinterpret_cast<float*>(smem + L.dS);  // [16 keys][SP]

  // stage i & 1 <- the key rows [k | rf] and value rows [v | beta] of step
  // i's tile (step i of 2 ntiles); rows past the window's w (or the C
  // chunks) copy the last real row, finite, and their columns are masked
  // to -inf
  auto load_tile = [&](int i) {
    const int t = i < ntiles ? i : i - ntiles;
    float* ks = reinterpret_cast<float*>(smem + L.k + (i & 1) * L.stage);
    float* vs = reinterpret_cast<float*>(smem + L.v + (i & 1) * L.stage);
    const bool local = t < nloc;
    const float* ksrc = local ? kg + win : rfg + cd;
    const float* vsrc = local ? vg + win : btg + cd;
    const int base = kTf32Keys * (local ? t : t - nloc), n = local ? p.w : p.C;
    for (int e = tid; e < kTf32Keys * V4; e += blockDim.x) {
      const int r = e / V4, c4 = e % V4;
      const size_t src = (size_t)min(base + r, n - 1) * HD + 4 * c4;
      cp_async16(ks + swz_at<D>(r, 4 * c4), ksrc + src);
      cp_async16(vs + swz_at<D>(r, 4 * c4), vsrc + src);
    }
    cp_async_commit();
  };
  // the window's q and g rows, in one group with the first tile
  for (int e = tid; e < p.w * V4; e += blockDim.x) {
    const int r = e / V4, c4 = e % V4;
    cp_async16(qs + swz_at<D>(r, 4 * c4), qg + win + (size_t)r * HD + 4 * c4);
    cp_async16(gs + swz_at<D>(r, 4 * c4), gg + win + (size_t)r * HD + 4 * c4);
  }
  load_tile(0);

  const float scale2 = p.scale * kLog2e;
  const int climit[2] = {g * (p.w / p.cs) + (rs + gq) / p.cs,
                         g * (p.w / p.cs) + (rs + gq + 8) / p.cs};
  const int xa = swz(gq);  // the swizzle of rows 8n + gq (and rs + gq + 8r)

  // S = Q K^T and dP = G V^T of the strip over step i's tile, hi hi into
  // sb / pb and hi lo + lo hi into ss / ps; then s = the logits in base 2
  // with the table (local tiles) or the chunk mask.  s[n][e] is row
  // rs + gq + 8(e / 2), tile column 8n + 2cq + e % 2.
  auto products = [&](int i, float (&s)[2][4], float (&dp)[2][4]) {
    const int t = i < ntiles ? i : i - ntiles;
    const float* ks = reinterpret_cast<const float*>(smem + L.k + (i & 1) * L.stage);
    const float* vs = reinterpret_cast<const float*>(smem + L.v + (i & 1) * L.stage);
    float sb[2][4], ss[2][4], pb[2][4], ps[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[n][e] = ss[n][e] = pb[n][e] = ps[n][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      // columns 16kp + 4cq .. + 3: k-step 2kp takes .x (A column cq) and
      // .y (column cq + 4), k-step 2kp + 1 .z, .w
      const int off = ((4 * kp + cq) ^ xa) << 2;
      float4 qa[2], ga[2], kk[2], vv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        qa[r] = *reinterpret_cast<const float4*>(qs + (rs + gq + 8 * r) * D + off);
        ga[r] = *reinterpret_cast<const float4*>(gs + (rs + gq + 8 * r) * D + off);
        kk[r] = *reinterpret_cast<const float4*>(ks + (8 * r + gq) * D + off);
        vv[r] = *reinterpret_cast<const float4*>(vs + (8 * r + gq) * D + off);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float av[4] = {half ? qa[0].z : qa[0].x, half ? qa[1].z : qa[1].x,
                             half ? qa[0].w : qa[0].y, half ? qa[1].w : qa[1].y};
        const float gv[4] = {half ? ga[0].z : ga[0].x, half ? ga[1].z : ga[1].x,
                             half ? ga[0].w : ga[0].y, half ? ga[1].w : ga[1].y};
        uint32_t ah[4], al[4], gh[4], gl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split_tf32(av[j], ah[j], al[j]);
          split_tf32(gv[j], gh[j], gl[j]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(half ? kk[n].z : kk[n].x, bh0, bl0);
          split_tf32(half ? kk[n].w : kk[n].y, bh1, bl1);
          mma_tf32(ss[n], al, bh0, bh1);
          mma_tf32(ss[n], ah, bl0, bl1);
          mma_tf32(sb[n], ah, bh0, bh1);
          split_tf32(half ? vv[n].z : vv[n].x, bh0, bl0);
          split_tf32(half ? vv[n].w : vv[n].y, bh1, bl1);
          mma_tf32(ps[n], gl, bh0, bh1);
          mma_tf32(ps[n], gh, bl0, bl1);
          mma_tf32(pb[n], gh, bh0, bh1);
        }
      }
    }
    const bool local = t < nloc;
    const int u = local ? t : t - nloc;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = kTf32Keys * u + 8 * n + 2 * cq;
        float2 add;
        if (local) {
          add = __ldg(reinterpret_cast<const float2*>(p.tab + (size_t)(rs + gq + 8 * r) * p.w + j));
        } else {
          add.x = j >= p.C ? -INFINITY : (j >= climit[r] ? kMaskVal : 0.f);
          add.y = j + 1 >= p.C ? -INFINITY : (j + 1 >= climit[r] ? kMaskVal : 0.f);
        }
        s[n][2 * r] = fmaf(sb[n][2 * r] + ss[n][2 * r], scale2, add.x * kLog2e);
        s[n][2 * r + 1] = fmaf(sb[n][2 * r + 1] + ss[n][2 * r + 1], scale2, add.y * kLog2e);
        dp[n][2 * r] = pb[n][2 * r] + ps[n][2 * r];
        dp[n][2 * r + 1] = pb[n][2 * r + 1] + ps[n][2 * r + 1];
      }
  };
  // whether the strip sees step i's tile
  auto visible = [&](int i) {
    const int t = i < ntiles ? i : i - ntiles;
    return t < nloc ? t <= warp : t - nloc < sch;
  };

  // ---- pass 1: each row's max m, sum l of 2^(s - m) and
  // D = sum 2^(s - m) dP, online (rescaled when m rises), in f32
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  for (int i = 0; i < ntiles; ++i) {
    // tile i has landed, and every warp is done with the other stage
    cp_async_wait_all();
    __syncthreads();
    load_tile(i + 1);
    if (!visible(i)) continue;  // masked for the whole strip
    float s[2][4], dp[2][4];
    products(i, s, dp);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                             fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      const float mn = fmaxf(m[r], quad_max(mx));
      const float alpha = exp2_approx(m[r] - mn);  // 0 on the first tile
      m[r] = mn;
      l[r] *= alpha;
      dd[r] *= alpha;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = exp2_approx(s[n][e] - m[e >> 1]);
        l[e >> 1] += x;
        dd[e >> 1] = fmaf(x, dp[n][e], dd[e >> 1]);
      }
  }
  // 1 / l, and ds = D / l: the TPU kernel's sum(P * dP)
  float il[2], ds[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = quad_sum(l[r]);
    il[r] = 1.f / den;
    ds[r] = quad_sum(dd[r]) / den;
  }

  // ---- pass 2, a tile at a time: P and dS; dbias; dq += dS keys; then,
  // after a barrier, the tile's dk, dv (or drf, dbeta) from P and dS
  // o[nq][tt]: n-tile tt of group nq of dq, its column n is d = 32nq + 4n + tt
  float o[NQ][4][4];
#pragma unroll
  for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
    for (int tt = 0; tt < 4; ++tt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nq][tt][e] = 0.f;
  float* dbias = p.dbias + ((size_t)b * p.nh + h) * p.w * p.w;
  for (int i = ntiles; i < 2 * ntiles; ++i) {
    // tile i has landed; every warp is done with the other stage and with
    // the P and dS tiles
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < 2 * ntiles) load_tile(i + 1);
    const int t = i - ntiles;
    const bool local = t < nloc;
    const int u = local ? t : t - nloc;
    if (visible(i)) {
      float s[2][4], dp[2][4];
      products(i, s, dp);
      // s <- P = 2^(s - m) / l, dp <- dS = P (dP - ds), both f32
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2_approx(s[n][e] - m[e >> 1]) * il[e >> 1];
          dp[n][e] = s[n][e] * (dp[n][e] - ds[e >> 1]);
        }
      if (local) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            atomicAdd(dbias + (size_t)(rs + gq + 8 * (e >> 1)) * p.w + kTf32Keys * u + 8 * n +
                          2 * cq + (e & 1),
                      dp[n][e]);
      }
      // dq += dS keys: k-step j takes the tile's keys 8j .. 8j + 7, A
      // column cq as key 8j + 2cq and column cq + 4 as key 8j + 2cq + 1;
      // the keys' row 8j + 2cq (+ 1) at chunk 8nq + gq holds columns
      // d = 32nq + 4gq + tt of n-tiles tt
      const float* ks = reinterpret_cast<const float*>(smem + L.k + (i & 1) * L.stage);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t ah[4], al[4];
        split_tf32(dp[j][0], ah[0], al[0]);
        split_tf32(dp[j][2], ah[1], al[1]);
        split_tf32(dp[j][1], ah[2], al[2]);
        split_tf32(dp[j][3], ah[3], al[3]);
        const int r0 = 8 * j + 2 * cq;
#pragma unroll
        for (int nq = 0; nq < NQ; ++nq) {
          const float4 x0 = *reinterpret_cast<const float4*>(ks + swz_at<D>(r0, 32 * nq + 4 * gq));
          const float4 x1 =
              *reinterpret_cast<const float4*>(ks + swz_at<D>(r0 + 1, 32 * nq + 4 * gq));
          const float b0[4] = {x0.x, x0.y, x0.z, x0.w}, b1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(b0[tt], bh0, bl0);
            split_tf32(b1[tt], bh1, bl1);
            mma_tf32(o[nq][tt], al, bh0, bh1);
            mma_tf32(o[nq][tt], ah, bl0, bl1);
            mma_tf32(o[nq][tt], ah, bh0, bh1);
          }
        }
      }
      // P and dS into the tiles, key-major: key 8n + 2cq + e % 2, query
      // rs + gq + 8(e / 2)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = (8 * n + 2 * cq + (e & 1)) * SP + rs + gq + 8 * (e >> 1);
          Pt[at] = s[n][e];
          Dt[at] = dp[n][e];
        }
    }
    __syncthreads();
    // the tile's dk = scale dS^T q and dv = P^T g (chunk tiles: drf, dbeta)
    // over the query rows of the strips that see it (a suffix of strips:
    // local tile u is seen by strips u .., a chunk tile from the first
    // strip whose chunk limit passes it); a warp takes column groups of
    // 8 NG columns, group c holding d = 8 NG c + NG n + tt of n-tiles tt.
    // k-step kk takes queries 8kk .. 8kk + 7, A column cq as query
    // 8kk + 2cq and column cq + 4 as query 8kk + 2cq + 1
    int first = u;
    if (!local) {
      first = 0;
      while (16 * first + 15 < p.w &&
             (chunk_limit(p, g, 16 * first + 15) + kTf32Keys - 1) / kTf32Keys <= u)
        ++first;
    }
    for (int grp = warp; grp < 8; grp += nw) {
      const int cb = 8 * NG * grp;
      float kb[NG][4], kt[NG][4], vb[NG][4], vt[NG][4];
#pragma unroll
      for (int tt = 0; tt < NG; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) kb[tt][e] = kt[tt][e] = vb[tt][e] = vt[tt][e] = 0.f;
      for (int kk = 2 * first; kk < p.w / 8; ++kk) {
        const int q0 = 8 * kk + 2 * cq;
        const float2 d0 = *reinterpret_cast<const float2*>(Dt + gq * SP + q0);
        const float2 d1 = *reinterpret_cast<const float2*>(Dt + (gq + 8) * SP + q0);
        const float2 p0 = *reinterpret_cast<const float2*>(Pt + gq * SP + q0);
        const float2 p1 = *reinterpret_cast<const float2*>(Pt + (gq + 8) * SP + q0);
        uint32_t dh[4], dl[4], ph[4], pl[4];
        split_tf32(d0.x, dh[0], dl[0]);
        split_tf32(d1.x, dh[1], dl[1]);
        split_tf32(d0.y, dh[2], dl[2]);
        split_tf32(d1.y, dh[3], dl[3]);
        split_tf32(p0.x, ph[0], pl[0]);
        split_tf32(p1.x, ph[1], pl[1]);
        split_tf32(p0.y, ph[2], pl[2]);
        split_tf32(p1.y, ph[3], pl[3]);
        float qa[NG], qb[NG], ga[NG], gb[NG];
        load_n<NG>(qs + swz_at<D>(q0, cb + NG * gq), qa);
        load_n<NG>(qs + swz_at<D>(q0 + 1, cb + NG * gq), qb);
        load_n<NG>(gs + swz_at<D>(q0, cb + NG * gq), ga);
        load_n<NG>(gs + swz_at<D>(q0 + 1, cb + NG * gq), gb);
#pragma unroll
        for (int tt = 0; tt < NG; ++tt) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(qa[tt], bh0, bl0);
          split_tf32(qb[tt], bh1, bl1);
          mma_tf32(kt[tt], dl, bh0, bh1);
          mma_tf32(kt[tt], dh, bl0, bl1);
          mma_tf32(kb[tt], dh, bh0, bh1);
          split_tf32(ga[tt], bh0, bl0);
          split_tf32(gb[tt], bh1, bl1);
          mma_tf32(vt[tt], pl, bh0, bh1);
          mma_tf32(vt[tt], ph, bl0, bl1);
          mma_tf32(vb[tt], ph, bh0, bh1);
        }
      }
      // the thread's row gq + 8r (a key of the tile), columns
      // cb + 2 NG cq + x, x < 2 NG: x = NG (e % 2) + tt
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = kTf32Keys * u + gq + 8 * r;
        float dkv[2 * NG], dvv[2 * NG];
#pragma unroll
        for (int tt = 0; tt < NG; ++tt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            dkv[NG * e + tt] = p.scale * (kb[tt][2 * r + e] + kt[tt][2 * r + e]);
            dvv[NG * e + tt] = vb[tt][2 * r + e] + vt[tt][2 * r + e];
          }
        const int col = cb + 2 * NG * cq;
        if (local) {
          float* dk = p.dk + win + (size_t)key * HD + col;
          float* dv = p.dv + win + (size_t)key * HD + col;
          if constexpr (NG == 2) {
            *reinterpret_cast<float4*>(dk) = make_float4(dkv[0], dkv[1], dkv[2], dkv[3]);
            *reinterpret_cast<float4*>(dv) = make_float4(dvv[0], dvv[1], dvv[2], dvv[3]);
          } else {
            *reinterpret_cast<float2*>(dk) = make_float2(dkv[0], dkv[1]);
            *reinterpret_cast<float2*>(dv) = make_float2(dvv[0], dvv[1]);
          }
        } else if (key < p.C) {
#pragma unroll
          for (int x = 0; x < 2 * NG; ++x) {
            atomicAdd(p.drf + cd + (size_t)key * HD + col + x, dkv[x]);
            atomicAdd(p.dbeta + cd + (size_t)key * HD + col + x, dvv[x]);
          }
        }
      }
    }
  }

  // dq = scale dS keys, complete in this block; a thread's 8 values of a
  // row and group are columns 32nq + 8cq .. + 7
  float* dq = static_cast<float*>(p.out) + win;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* orow = dq + (size_t)(rs + gq + 8 * r) * HD + 8 * cq;
#pragma unroll
    for (int nq = 0; nq < NQ; ++nq) {
      *reinterpret_cast<float4*>(orow + 32 * nq) =
          make_float4(p.scale * o[nq][0][2 * r], p.scale * o[nq][1][2 * r],
                      p.scale * o[nq][2][2 * r], p.scale * o[nq][3][2 * r]);
      *reinterpret_cast<float4*>(orow + 32 * nq + 4) =
          make_float4(p.scale * o[nq][0][2 * r + 1], p.scale * o[nq][1][2 * r + 1],
                      p.scale * o[nq][2][2 * r + 1], p.scale * o[nq][3][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t prepare_tf32_bwd() {
  const auto kernel = causal_packed_bwd_tf32x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)make_tf32_bwd_layout(D, kTf32BwdMaxW).total);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D>
cudaError_t launch_tf32_bwd(const Params& p, cudaStream_t stream) {
  cudaError_t err = prepare_tf32_bwd<D>();
  if (err != cudaSuccess) return err;
  // a block a window, a warp for each strip of 16 of its rows
  causal_packed_bwd_tf32x3_kernel<D><<<dim3(p.T / p.w, p.nh, p.B), 2 * p.w,
                                       make_tf32_bwd_layout(D, p.w).total, stream>>>(p);
  return cudaGetLastError();
}

// Blocks of the route's backward that fit one SM at windows of 128
// (registers and shared memory), from the occupancy calculator, or -1.
template <int D>
int tf32_bwd_blocks_per_sm() {
  int blocks = 0;
  if (prepare_tf32_bwd<D>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, causal_packed_bwd_tf32x3_kernel<D>, 2 * kTf32BwdMaxW,
          make_tf32_bwd_layout(D, kTf32BwdMaxW).total) != cudaSuccess)
    return -1;
  return blocks;
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

// Whether the forward at head dim d, window w and element size itemsize
// takes the split-TF32 route (fwd_uses_tf32x3 in the wrapper).
int causal_packed_fwd_uses_tf32x3(int d, int w, int itemsize) {
  return uses_tf32x3(d, w, itemsize) ? 1 : 0;
}

// Shared memory of one block of the split-TF32 forward at head dim d (the
// wrapper's tf32_smem_bytes); it does not depend on w, C or the rows.
int causal_packed_tf32_smem_bytes(int d) { return (int)make_tf32_layout(d).total; }

// Blocks of the split-TF32 forward that fit one SM at head dim d, or -1.
int causal_packed_tf32_blocks_per_sm(int d) {
  switch (d) {
    case 64: return tf32_blocks_per_sm<64>();
    case 128: return tf32_blocks_per_sm<128>();
    default: return -1;
  }
}

// Whether the backward at head dim d, window w and element size itemsize
// takes the split-TF32 route (bwd_uses_tf32x3 in the wrapper).
int causal_packed_bwd_uses_tf32x3(int d, int w, int itemsize) {
  return bwd_uses_tf32x3(d, w, itemsize) ? 1 : 0;
}

// Shared memory of one block of the split-TF32 backward at head dim d and
// window w (the wrapper's tf32_bwd_smem_bytes).
int causal_packed_tf32_bwd_smem_bytes(int d, int w) {
  return (int)make_tf32_bwd_layout(d, w).total;
}

// Blocks of the split-TF32 backward that fit one SM at head dim d and
// windows of 128, or -1.
int causal_packed_tf32_bwd_blocks_per_sm(int d) {
  switch (d) {
    case 64: return tf32_bwd_blocks_per_sm<64>();
    case 128: return tf32_bwd_blocks_per_sm<128>();
    default: return -1;
  }
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

// The forward's split-TF32 route on `stream` (f32 operands; d 64 or 128,
// w % 16 == 0, qt 16, 32 or 64): the same output as causal_packed_fwd_launch.
// Returns a cudaError_t (0 on success).
int causal_packed_fwd_tf32x3_launch(const void* q, const void* k, const void* v,
                                    const void* rf, const void* beta, const float* tab,
                                    void* out, int B, int T, int nh, int d, int w, int cs,
                                    int C, int qt, float scale, void* stream) {
  Params p = {};
  if (!make_params(p, B, T, nh, w, cs, C, qt, scale) || !uses_tf32x3(d, w, 4) ||
      qt % 16 || qt > 64)
    return cudaErrorInvalidValue;
  p.q = q; p.k = k; p.v = v; p.rf = rf; p.beta = beta; p.tab = tab; p.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch_tf32<64>(p, s) : launch_tf32<128>(p, s);
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

// The backward's split-TF32 route on `stream` (f32 operands; d 64 or 128,
// w % 16 == 0, w <= 128): dq, dk, dv (f32, stored whole) and, added into
// the zeroed f32 outputs, drf, dbeta [B, C, nh*d] and the dbias partials
// [B, nh, w, w].  Returns a cudaError_t (0 on success).
int causal_packed_bwd_tf32x3_launch(const void* q, const void* k, const void* v,
                                    const void* rf, const void* beta, const float* tab,
                                    const void* g, void* dq, float* dk, float* dv, float* drf,
                                    float* dbeta, float* dbias, int B, int T, int nh, int d,
                                    int w, int cs, int C, float scale, void* stream) {
  Params p = {};
  if (!make_params(p, B, T, nh, w, cs, C, w, scale) || !bwd_uses_tf32x3(d, w, 4))
    return cudaErrorInvalidValue;
  p.q = q; p.k = k; p.v = v; p.rf = rf; p.beta = beta; p.tab = tab; p.g = g;
  p.out = dq; p.dk = dk; p.dv = dv; p.drf = drf; p.dbeta = dbeta; p.dbias = dbias;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch_tf32_bwd<64>(p, s) : launch_tf32_bwd<128>(p, s);
}

}  // extern "C"
