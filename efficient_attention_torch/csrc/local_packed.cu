// K7 local_packed: exact 2-D window attention over the packed qkv (forward).
//
// Replaces efficient_attention_tpu/ops/pallas/local_packed.py::local_attention_packed
// (_fwd, _kernel).  Plain version and wrapper:
// efficient_attention_torch/ops/kernels/local_packed.py.
//
// Function.  qkv [B, N, 3*H*D] holds q, k, v side by side.  Each query of head
// h attends over the keys of its own ws x ws window, plus the RPE bias
// [H, S, S], in one softmax scaled by `scale`; out [B, N, H*D].  It is K1
// (eva_packed.cu) without chunk columns.  Roundings follow the TPU kernel:
// logits and softmax in f32, the softmax normalised first (p / sum), the
// normalised probabilities rounded to the input type before their product
// with v, the product summed in f32, the output cast last.
//
// What bounds it: bytes.  At the DeiT-tiny-p8 serving shape (B=128, 28x28
// tokens, 3 heads of 64, bf16) it must read qkv (115.6 MB) and write the
// output (38.5 MB): ~46 us at 3.35 TB/s, against ~4.8 us for its 4.7 GFLOP
// (two products of N x S x D per image and head) at the bf16 tensor-core
// peak.
//
// Two routes, chosen by type and head dim (uses_mma).
//
// CUDA cores (f32 inputs, or head dims not a multiple of 16).  A block takes
// `wpb` windows of one (image, head) in turn and keeps a window in shared
// memory in f32 (bf16 inputs convert exactly): its S query, key and value
// rows and its S x S logits, plus the head's bias.  Each product is a loop
// over shared memory in which a thread holds a register tile of outputs (7x4
// logits, or 4 rows by 4 columns of the D-wide output), so a 16-byte load
// feeds 4 to 7 FMAs; rows of D are padded to a stride of 4 (mod 8) floats,
// so the 8 threads of a quarter-warp reading 8 rows hit all 32 banks.
//
// Tensor cores (bf16, head dims 16, 32 and 64): K1's tensor-core forward
// design (eva_packed_fwd_mma_kernel) without the chunk columns, on the
// logit tile it shares with K1, K11 and K12 (eva_strip::fwd_logits_tile,
// read with C = 0).  A block of 4 warps takes wpb windows of one (image,
// head) in turn:
//  * staging in bf16: a table of the block's token indices [kMaxWpb][S] and
//    the bias (f32, times log2 e; zeros without one) once a block; a
//    window's q, k and v rows [S][D+8] by 16-byte cp.async into two
//    buffers, the next window's loading while this one is computed, so one
//    barrier a window.  No logit or P matrix in shared memory: 53,632 bytes
//    a block at S = 49, head dim 64 (the wmma route this replaced held
//    an f32 logit matrix and a bf16 P too: 64,000), three blocks an SM;
//  * a warp owns a strip of 16 query rows and computes its logits in base 2
//    as mma.sync m16n8k16 fragments, 16 key columns at a time: key rows past
//    S read the last real row and their columns are -inf; query rows past S
//    read row S - 1 and are never stored;
//  * where round16(S) <= 112 (one pass; the serving cell's S = 49 is 4
//    tiles) the strip's logits stay in registers: the row max over the
//    quad, the numerators exp2(s - max) in place, their f32 sum over the
//    quad.  Wider windows take two passes: the row max and the f32 sum
//    online (only the sum is rescaled, never a rounded value), then the
//    logits again;
//  * P = numerator / sum, rounded to bf16, is the A operand of the value
//    product (repacked in registers), the values read through
//    ldmatrix.trans, f32 sums.  This is K7's order, not K1's: K1 rounds the
//    numerators and divides after the product (eva_strip::fwd_pv_tile), so
//    K7 keeps its own value step.  The division is a multiply by the f32
//    reciprocal of the sum, within an f32 ulp of p / sum;
//  * the strip's rows, cast to bf16, are staged in the strip's own q rows
//    and leave 16 bytes a thread to their tokens.
// mma.sync and cp.async only: no wgmma or TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "eva_strip.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  const void* qkv;    // [B, N, 3*nh*D], T
  const float* bias;  // [nh, S, S] or null
  void* out;          // [B, N, nh*D], T
  int B, N, gw, ws, nh;
  int S;              // tokens per window
  int nww;            // windows per grid row
  int wpb;            // windows per block
  int C;              // always 0: the strip tiles (eva_strip.cuh) read p.C
  float scale;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Row stride (floats) of a D-wide row in shared memory: a multiple of 4 that
// is 4 mod 8 (row_stride in ops/kernels/eva_packed.py).  D is a multiple of 4.
__host__ __device__ constexpr int row_stride(int D) {
  return ((D / 4 + 1) | 1) * 4;
}

// Offsets (bytes) of the shared-memory regions; the same layout as
// smem_bytes() in ops/kernels/local_packed.py.
struct Layout {
  size_t q, keys, vals, P, bias, total;
};

__host__ __device__ inline Layout make_layout(int D, int S) {
  const size_t DP = row_stride(D);
  Layout L = {};
  size_t o = 0;
  L.q = o;     o += align16(S * DP * 4);
  L.keys = o;  o += align16(S * DP * 4);
  L.vals = o;  o += align16(S * DP * 4);
  L.P = o;     o += align16((size_t)S * (S + 1) * 4);
  L.bias = o;  o += align16((size_t)S * S * 4);
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

// out[i][j] = <A_i, B_j> over D for i < M, j < N (rows at row_stride(D)); a
// thread's 7x4 tile is rows a + mt*r and columns b + nt*c.
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

// out[i][4q..4q+3] = sum_{j < K} W[i * ws + j] V[j][4q..4q+3] for i < M (V rows
// at row_stride(D)); a thread's tile is rows a + mt*r (r < 4) by one float4
// column q.
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

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) local_packed_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DP = row_stride(D);
  const int S = p.S, SP = S + 1;
  const Layout L = make_layout(D, S);
  float* q = reinterpret_cast<float*>(smem + L.q);        // [S][DP]
  float* keys = reinterpret_cast<float*>(smem + L.keys);  // [S][DP]
  float* vals = reinterpret_cast<float*>(smem + L.vals);  // [S][DP]
  float* P = reinterpret_cast<float*>(smem + L.P);        // [S][SP]
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);  // [S][S]
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int HD = p.nh * D;
  const T* qkv = static_cast<const T*>(p.qkv) + (size_t)b * p.N * 3 * HD + h * D;
  T* out = static_cast<T*>(p.out) + (size_t)b * p.N * HD + h * D;

  const float* bh = p.bias != nullptr ? p.bias + (size_t)h * S * S : nullptr;
  for (int e = threadIdx.x; e < S * S; e += kThreads)
    bias_s[e] = bh != nullptr ? bh[e] : 0.f;
  for (int wi = 0; wi < p.wpb; ++wi) {
    const int w = blockIdx.x * p.wpb + wi;
    for (int e = threadIdx.x; e < S * 3 * D; e += kThreads) {
      const int d = e % D, part = (e / D) % 3, l = e / (3 * D);
      const float x = to_f(qkv[(size_t)window_token(p, w, l) * 3 * HD + part * HD + d]);
      (part == 0 ? q : part == 1 ? keys : vals)[l * DP + d] = x;
    }
    __syncthreads();
    gemm_nt<D>(q, S, keys, S, [&](int i, int j, float v) {
      P[i * SP + j] = v * p.scale + bias_s[i * S + j];
    });
    __syncthreads();
    // softmax in f32, normalised, then rounded to T for the value product
    for (int i = warp; i < S; i += kWarps) {
      float* row = P + i * SP;
      float mx = -INFINITY;
      for (int j = lane; j < S; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      float den = 0.f;
      for (int j = lane; j < S; j += 32) {
        const float e = expf(row[j] - mx);
        row[j] = e;
        den += e;
      }
      den = warp_sum(den);
      for (int j = lane; j < S; j += 32) row[j] = round_to<T>(row[j] / den);
    }
    __syncthreads();
    gemm_nn<D>(P, SP, S, S, vals, [&](int i, int c, float4 v) {
      store4(out + (size_t)window_token(p, w, i) * HD + 4 * c, v);
    });
    __syncthreads();  // q, k, v and P are rewritten by the next window
  }
}

// ---- the bf16 route: K1's tensor-core forward design (header comment) ----

// 4 warps a block; at most kMaxWpb windows a block (WINDOWS_PER_BLOCK in the
// wrapper), whose token indices the block's table holds.
constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMaxWpb = 4;

using eva_strip::bf16;
using eva_strip::kLog2e;
using eva_strip::kResidentTiles;
using eva_strip::round16;

__host__ __device__ inline bool uses_mma(int d) { return d % 16 == 0; }

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Offsets (bytes) of the tensor-core route's shared memory; the same layout
// as smem_bytes(d, S, 2) in the wrapper.  bf16: a window's q, k and v rows
// [S][D+8] in two buffers each (buffer b at b * win); f32: the bias [S][S];
// int32: the token table [kMaxWpb][S].
struct MmaLayout {
  size_t win, q, kw, vw, bias, tok, total;
};

__host__ __device__ inline MmaLayout make_mma_layout(int D, int S) {
  const size_t DB = D + 8;
  MmaLayout L = {};
  L.win = align128(S * DB * 2);
  size_t o = 0;
  L.q = o;     o += 2 * L.win;
  L.kw = o;    o += 2 * L.win;
  L.vw = o;    o += 2 * L.win;
  L.bias = o;  o += align128((size_t)S * S * 4);
  L.tok = o;   o += align128((size_t)kMaxWpb * S * 4);
  L.total = o;
  return L;
}

// A window's q, k and v rows into one buffer each with 16-byte asynchronous
// copies; tok holds the window's token indices.
template <int D>
__device__ __forceinline__ void load_window(const Params& p, const int* tok, const bf16* qkv,
                                            bf16* q, bf16* kw, bf16* vw) {
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

// Tile kt of a strip's value product from its numerators x = exp2(s - max)
// and the reciprocals inv of its f32 row sums: o += P v with P = x * inv
// rounded to bf16 as the A operand.  Value rows past S read the last real
// row (their P is 0).
template <int D>
__device__ __forceinline__ void pv_tile(const Params& p, int kt, const float (&x)[2][4],
                                        const float (&inv)[2], const bf16* vw,
                                        float (&o)[D / 8][4]) {
  using namespace mma_frag;
  const int lane = threadIdx.x & 31;
  float pn[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) pn[n][e] = x[n][e] * inv[e >> 1];
  uint32_t a[4];
  c_to_a(pn[0], pn[1], a);
  const bf16* vr = vw + min(kt * 16 + row_r(lane), p.S - 1) * (D + 8) + col_r(lane);
#pragma unroll
  for (int nd = 0; nd < D / 16; ++nd) {
    uint32_t bv[4];
    ldsm_x4_trans(bv, vr + 16 * nd);
    mma_bf16(o[2 * nd], a, bv[0], bv[1]);
    mma_bf16(o[2 * nd + 1], a, bv[2], bv[3]);
  }
}

// The row max of a logit tile s over the thread's columns, into m.
__device__ __forceinline__ void tile_max(const float (&s)[2][4], float (&m)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
    m[r] = fmaxf(m[r], fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                             fmaxf(s[1][2 * r], s[1][2 * r + 1])));
}

// The tensor-core route (bf16, uses_mma): the design is in the header
// comment.  A block takes wpb windows of one (image, head) in turn.
// kOnePass: eva_strip::one_pass(S, 0), a strip's logits stay in registers
// between the row statistics and the value product.
template <int D, bool kOnePass>
__global__ void __launch_bounds__(kMmaThreads, 3) local_packed_fwd_mma_kernel(const Params p) {
  using namespace mma_frag;
  using eva_strip::fwd_logits_tile;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int DB = D + 8, KD = D / 16, V8 = D / 8;
  const int S = p.S, KT = round16(S) / 16;  // key tiles, and strips, of 16
  const MmaLayout L = make_mma_layout(D, S);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);  // [S][S]
  int* tok_s = reinterpret_cast<int*>(smem + L.tok);        // [kMaxWpb][S]
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

  {  // the block's bias and token table
    const float* bh = p.bias != nullptr ? p.bias + (size_t)h * S * S : nullptr;
    for (int e = tid; e < S * S; e += kMmaThreads)
      bias_s[e] = bh != nullptr ? kLog2e * bh[e] : 0.f;
    for (int e = tid; e < p.wpb * S; e += kMmaThreads)
      tok_s[e] = window_token(p, blockIdx.x * p.wpb + e / S, e % S);
    __syncthreads();
  }
  load_window<D>(p, tok_s, qkv, rows(L.q, 0), rows(L.kw, 0), rows(L.vw, 0));
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
      load_window<D>(p, tok + S, qkv, rows(L.q, buf ^ 1), rows(L.kw, buf ^ 1),
                     rows(L.vw, buf ^ 1));

    for (int st = warp; st < KT; st += kMmaWarps) {
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
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2];
      if constexpr (kOnePass) {
        // the logits of every tile and the row max over the quad; the
        // numerators in place and their sum over the quad; then P v
        float s[kResidentTiles][2][4];
#pragma unroll
        for (int kt = 0; kt < kResidentTiles; ++kt) {
          if (kt >= KT) break;
          fwd_logits_tile<D>(p, kt, row0, qa, kw, nullptr, bias_s, s[kt]);
          tile_max(s[kt], m);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
#pragma unroll
        for (int kt = 0; kt < kResidentTiles; ++kt) {
          if (kt >= KT) break;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[kt][n][e] = exp2_approx(s[kt][n][e] - m[e >> 1]);
              l[e >> 1] += s[kt][n][e];
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l[r]);
#pragma unroll
        for (int kt = 0; kt < kResidentTiles; ++kt) {
          if (kt >= KT) break;
          pv_tile<D>(p, kt, s[kt], inv, vw, o);
        }
      } else {
        // pass 1: the row max over the quad and the f32 sum online (the sum
        // rescaled to each new max); pass 2: the logits again, P v
        for (int kt = 0; kt < KT; ++kt) {
          float s[2][4], mt[2] = {m[0], m[1]};
          fwd_logits_tile<D>(p, kt, row0, qa, kw, nullptr, bias_s, s);
          tile_max(s, mt);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mt[r] = quad_max(mt[r]);
            l[r] *= exp2_approx(m[r] - mt[r]);
            m[r] = mt[r];
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) l[e >> 1] += exp2_approx(s[n][e] - m[e >> 1]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l[r]);
        for (int kt = 0; kt < KT; ++kt) {
          float s[2][4];
          fwd_logits_tile<D>(p, kt, row0, qa, kw, nullptr, bias_s, s);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = exp2_approx(s[n][e] - m[e >> 1]);
          pv_tile<D>(p, kt, s, inv, vw, o);
        }
      }
      // the rows, rounded to bf16, into the strip's own q rows (no other
      // warp reads them), then 16 bytes a thread to the tokens
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + 8 * r;
        if (i >= S) continue;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(qs + i * DB + 8 * n + cq) =
              pack_bf16(o[n][2 * r], o[n][2 * r + 1]);
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

// The tensor-core kernel of a geometry (one pass where a strip's tiles fit
// the registers), prepared for its shared memory.
template <int D>
auto mma_kernel(int S) {
  return eva_strip::one_pass(S, 0) ? local_packed_fwd_mma_kernel<D, true>
                                   : local_packed_fwd_mma_kernel<D, false>;
}

template <int D>
cudaError_t prepare_mma(int S) {
  const auto kernel = mma_kernel<D>(S);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)make_mma_layout(D, S).total);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Blocks of the tensor-core kernel that fit one SM (registers and shared
// memory), from the occupancy calculator, or -1.
template <int D>
int mma_blocks_per_sm(int S) {
  int blocks = 0;
  if (prepare_mma<D>(S) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mma_kernel<D>(S), kMmaThreads,
                                                    make_mma_layout(D, S).total) !=
          cudaSuccess)
    return -1;
  return blocks;
}

template <int D, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.N / p.gw / p.ws) * p.nww / p.wpb, p.nh, p.B);
  if constexpr (D % 16 == 0) {  // uses_mma(D)
    if (sizeof(T) == 2) {
      if (p.wpb > kMaxWpb) return cudaErrorInvalidValue;
      cudaError_t err = prepare_mma<D>(p.S);
      if (err != cudaSuccess) return err;
      mma_kernel<D>(p.S)<<<grid, kMmaThreads, make_mma_layout(D, p.S).total, stream>>>(p);
      return cudaGetLastError();
    }
  }
  const Layout L = make_layout(D, p.S);
  auto kernel = local_packed_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const Params& p, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch<D, __nv_bfloat16>(p, stream) : launch<D, float>(p, stream);
}

}  // namespace

extern "C" {

// Whether (d, itemsize) takes the tensor-core route (uses_mma in
// ops/kernels/local_packed.py).
int local_packed_uses_mma(int d, int itemsize) { return itemsize == 2 && uses_mma(d); }

// Shared memory of one block of the route that (d, S, is_bf16) takes.
int local_packed_smem_bytes(int d, int S, int is_bf16) {
  return (int)(is_bf16 && uses_mma(d) ? make_mma_layout(d, S).total
                                      : make_layout(d, S).total);
}

// Blocks of the tensor-core kernel that fit one SM at (d, S), or -1.
int local_packed_mma_blocks_per_sm(int d, int S) {
  switch (d) {
    case 16: return mma_blocks_per_sm<16>(S);
    case 32: return mma_blocks_per_sm<32>(S);
    case 64: return mma_blocks_per_sm<64>(S);
    default: return -1;
  }
}

const char* local_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: out [B, N, nh*d] from qkv (float32 or bfloat16) and
// bias (f32 [nh, S, S] or null).  Returns a cudaError_t (0 on success).
int local_packed_launch(const void* qkv, const float* bias, void* out, int B, int N,
                        int gw, int ws, int nh, int d, int wpb, int is_bf16,
                        float scale, void* stream) {
  if (B <= 0 || N <= 0 || gw <= 0 || ws <= 0 || nh <= 0 || wpb <= 0 || N % gw)
    return cudaErrorInvalidValue;
  const int gh = N / gw;
  if (gh % ws || gw % ws || ((gh / ws) * (gw / ws)) % wpb) return cudaErrorInvalidValue;
  Params p = {};
  p.qkv = qkv; p.bias = bias; p.out = out;
  p.B = B; p.N = N; p.gw = gw; p.ws = ws; p.nh = nh;
  p.S = ws * ws;
  p.nww = gw / ws;
  p.wpb = wpb;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 12: return launch_dtype<12>(p, is_bf16, s);
    case 16: return launch_dtype<16>(p, is_bf16, s);
    case 32: return launch_dtype<32>(p, is_bf16, s);
    case 64: return launch_dtype<64>(p, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
