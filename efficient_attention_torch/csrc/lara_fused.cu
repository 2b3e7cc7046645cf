// K5 lara_fused: the mis-opt LARA combine of the eval forward, one kernel.
//
// Replaces efficient_attention_tpu/ops/pallas/lara_fused.py::lara_attention_fused
// (_fwd, _kernel).  Plain version and wrapper:
// efficient_attention_torch/ops/kernels/lara_fused.py.
//
// Function.  qkv [B, N, 3*H*D] holds q, k, v side by side; w, q_bar [B, H, C, D]
// are the proposal means and query landmarks, bal, lprop [B, H, C] the
// landmark-side terms (f32).  For each (image, head):
//   lpk[c, n] = <w_c, k_n>/sqrt(d) - |k_n|^2/(2 sqrt d), lse_k[c] = logsumexp_n,
//   kv[c] = softmax_n(lpk[c]) v, lse_t[c] = logsumexp_n scale <q_bar_c, q_n>;
// then per token n, with t[c] = exp(scale <q_bar_c, q_n> - lse_t[c]):
//   alpha[c] = bal[c] + coeff (t[c] - mean_c t), log_iw[c] = log max(alpha,
//   1e-8) + lpq[n, c] + lse_k[c] - lprop[c], out[n] = softmax_c(log_iw) kv.
//
// What bounds it: bytes.  At the DeiT-tiny-p8 LARA serving shape (B=128, 28x28
// tokens, 3 heads of 64, C=49, bf16) it must read qkv (115.6 MB) and the
// landmarks (9.8 MB of f32) and write the output (38.5 MB): ~49 us at 3.35
// TB/s, against ~9.5 us for its 9.4 GFLOP (five products of N x C x D per
// image and head) at the bf16 tensor-core peak.
//
// Three routes, chosen by geometry (plan(), twin of plan() in the wrapper).
//
// Tensor cores in a cluster (bf16, head dims 16, 32 and 64, at most 64
// landmarks; lara_fused_cluster_kernel).  The landmark statistics need every
// token of an (image, head) before any token's combine, and one (image,
// head) of q, k, v (301 KB in bf16 at N = 784) does not fit one SM; split
// over a thread-block cluster of R blocks it does, so qkv is read from
// device memory once, as the TPU kernel reads it once (the whole element
// resident in VMEM).  Block `rank` owns a contiguous slice of
// rows = ceil(N / R) tokens.  16 warps, one block an SM (128 registers);
// mma.sync m16n8k16 with f32 sums, operands by ldmatrix (mma_frag.cuh);
// landmarks padded with zero rows to CP = round16(C) and left out of every
// max, sum and mean; fragment loads of token rows past the slice read its
// last real row (K1's rule), and those rows are left out of every max and
// sum and never stored.
//  * staging: w and q_bar (f32, loaded first so that they do not queue
//    behind the rows, then rounded to bf16 [CP][D+8]), balance and log
//    proposal; the slice's q and k rows, then its v rows [rows][D+8] in bf16
//    by 16-byte cp.async (v lands while phase A starts); each token's |k|^2
//    (times log2 e / (2 sqrt d));
//  * phase A, the statistics, with the landmarks as rows: a warp owns a
//    16-landmark strip and every NSH-th 16-token tile of the slice.  It forms
//    lpk = w k^T and the landmark logits q_bar q^T in fragments, in base 2:
//    the per-landmark maxima of lpk (quad reductions, then across warps in
//    shared memory) and, online, the maxima and sums of exp2 of the landmark
//    logits (nothing of them is rounded).  The lpk logits of the warp's
//    first kHeld tiles stay in registers.  Each block writes its maxima into
//    every block; cluster barrier #1; the true maxima over all N tokens, in
//    rank order.  The warp sums exp2(lpk - m_k) in f32 and rounds it to bf16
//    as the A operand of P v (repacked in registers, FlashAttention-2's
//    way; later tiles' logits formed again), its kv sums [16 x D] in
//    registers; the warps of a strip add theirs in f32 in a fixed order into
//    the block's [CP][D+8], over k and v, which nothing reads any more;
//  * the exchange, a reduce-scatter then an all-gather, each by writes into
//    the owner's or every block's shared memory (a write is not a round
//    trip; the barrier after it makes it visible).  Block r owns landmarks
//    [r LO, (r + 1) LO), LO = ceil(C / R): every block writes its kv sums,
//    den and landmark-logit (maximum, sum) of those landmarks into r's
//    memory; cluster barrier #2 (meanwhile each warp forms phase B's
//    products for its first strip); r adds them in rank order (so every
//    block sees the same bits), forms lse_k, lse_t and round(kv / den), and
//    writes them into every block; cluster barrier #3, after which no block
//    touches another's memory.  A block writes its f32 kv sums, C D 4 bytes
//    (12.5 KB at the headline), and as an owner about C D 2 bytes of bf16
//    kv rows; reading every rank's f32 kv would be R C D 4;
//  * phase B, each token's combine, K1's strip with the landmarks as keys: a
//    warp owns 16 token rows and forms q w^T and q q_bar^T [16 x CP] in
//    fragments; the row work is quad reductions: t, its mean over the C real
//    landmarks, alpha, the weights.  A token's |q|^2 term is the same for
//    every landmark and cancels in the softmax over them, and softmax(log
//    max(alpha, 1e-8) + x) is max(alpha, 1e-8) exp2(x - max x) over its sum,
//    so the weights take two exponentials and no logarithm.  The weights,
//    normalised then rounded to bf16, are the A operand of the product with
//    kv (ldmatrix.trans); the [16 x D] output is staged in the strip's own q
//    rows and stored 16 bytes a thread.
// No logit matrix in shared memory.  Two passes over the tokens' lpk, as the
// plain version: the numerators are rounded against the true maxima, never
// a running one.  Exponentials are ex2 on base-2 logits (relative error
// about 2^-22, against bf16's 2^-8).  The cluster size (plan()) is the
// smallest whose blocks fit: at the DeiT-tiny-p8 headline two blocks of 392
// tokens, 221,568 bytes each, the fastest of the sizes timed there
// (scripts/torch_lara_fused_check.py; PERF.md).
//
// wmma (bf16 geometries the cluster route does not hold whose head dim is a
// multiple of 16 and whose kv tiles fit the warps' accumulators: other head
// dims, more than 64 landmarks, or more tokens than a cluster holds;
// lara_fused_mma_kernel): the CUDA-core route's three passes below with
// every product on wmma 16x16x16 tiles.
//
// CUDA cores (f32, and bf16 geometries neither route above holds;
// lara_fused_kernel).  One block takes one
// (image, head) and walks its tokens three times in tiles of 32 rows held in
// shared memory (f32): pass 1 finds the true maxima of lpk and of the
// landmark logits over the tokens, pass 2 sums the shifted exponentials and
// accumulates the rounded numerators against v into kv, pass 3 runs each
// token's combine.  A tile's v rows reuse its q rows' buffer.  Products run
// through smem_tile::tile_gemm (4x4 register tiles over rows padded to odd
// strides).
//
// Every route shifts the token softmaxes by their true maximum, as the JAX
// twin and eager path do (the TPU kernel's fixed bound |w_c|^2/(2 sqrt d)
// underflows for keys far from w_c), and rounds as the TPU kernel does:
// both operands of every product in the input type (w, q_bar, the
// token-softmax numerators, the SNIS weights and kv rounded first), every
// sum f32, the output cast last.
//
// Built with -DLARA_PHASES (scripts/torch_lara_fused_check.py), the cluster
// kernel records, from thread 0 of each block, clock64() at its phase
// boundaries into g_lara_phases[0..8][block] (start, staged, the block's
// statistics, the true maxima, the sums and kv, barrier #2, the owners'
// writes, barrier #3, phase B) and the global timer at the block's start
// and end into [10] and [11]; lara_fused_phases_copy reads them back.
// Without it the marks compile to nothing.
#include <cooperative_groups.h>
#include <float.h>

#include "mma_frag.cuh"
#include "smem_tile.cuh"

namespace {

using namespace smem_tile;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // token rows a block holds at once (TOKEN_TILE)
constexpr int kMaxAcc = 4;  // kv accumulator tiles a warp holds (MMA_MAX_ACC)

struct Params {
  const void* qkv;     // [B, N, 3*nh*d], T
  const float* w;      // [B, nh, C, d]
  const float* qb;     // [B, nh, C, d]
  const float* bal;    // [B, nh, C]
  const float* lprop;  // [B, nh, C]
  void* out;           // [B, N, nh*d], T
  int B, N, nh, d, C;
  int R, rows;         // cluster route: blocks a cluster, token rows a block
  float scale, dn, alpha;
};

// Offsets (bytes) of the shared-memory regions; the same layout as
// smem_bytes() in ops/kernels/lara_fused.py.
struct Layout {
  size_t W, QB, KV, Q, K, L1, L2, stats, rows, total;
};

__host__ __device__ inline Layout make_layout(int d, int C) {
  const size_t DP = d + 1;
  const int a = C * (kTile + 1), b = kTile * (C + 1);
  const size_t logits = align16((size_t)(a > b ? a : b) * 4);
  Layout L = {};
  size_t o = 0;
  L.W = o;     o += align16(C * DP * 4);
  L.QB = o;    o += align16(C * DP * 4);
  L.KV = o;    o += align16(C * DP * 4);
  L.Q = o;     o += align16(kTile * DP * 4);
  L.K = o;     o += align16(kTile * DP * 4);
  L.L1 = o;    o += logits;
  L.L2 = o;    o += logits;
  L.stats = o; o += align16((size_t)8 * C * 4);
  L.rows = o;  o += align16(kTile * 4);
  L.total = o;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lara_fused_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = p.d, C = p.C, DP = d + 1, CP = kTile + 1, CQ = C + 1;
  const int HD = p.nh * d;
  const Layout L = make_layout(d, C);
  float* W = reinterpret_cast<float*>(smem + L.W);      // [C][DP]
  float* QB = reinterpret_cast<float*>(smem + L.QB);    // [C][DP]
  float* KV = reinterpret_cast<float*>(smem + L.KV);    // [C][DP]
  float* Q = reinterpret_cast<float*>(smem + L.Q);      // [kTile][DP]: q, then v
  float* K = reinterpret_cast<float*>(smem + L.K);      // [kTile][DP]
  float* L1 = reinterpret_cast<float*>(smem + L.L1);    // [C][CP] or [kTile][CQ]
  float* L2 = reinterpret_cast<float*>(smem + L.L2);    // [C][CP] or [kTile][CQ]
  float* st = reinterpret_cast<float*>(smem + L.stats);
  float* m_k = st, *den = st + C, *lse_k = st + 2 * C, *m_t = st + 3 * C;
  float* den_t = st + 4 * C, *lse_t = st + 5 * C, *bal = st + 6 * C, *lprop = st + 7 * C;
  float* rn = reinterpret_cast<float*>(smem + L.rows);  // [kTile] token norms
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const T* qkv = static_cast<const T*>(p.qkv) + (size_t)b * p.N * 3 * HD;
  T* out = static_cast<T*>(p.out) + (size_t)b * p.N * HD + h * d;
  const size_t lm = ((size_t)b * p.nh + h) * C;  // this (image, head)'s landmarks

  for (int e = tid; e < C * d; e += blockDim.x) {
    const int c = e / d, x = e % d;
    W[c * DP + x] = round_to<T>(p.w[lm * d + e]);
    QB[c * DP + x] = round_to<T>(p.qb[lm * d + e]);
    KV[c * DP + x] = 0.f;
  }
  for (int c = tid; c < C; c += blockDim.x) {
    m_k[c] = m_t[c] = -INFINITY;
    den[c] = den_t[c] = 0.f;
    bal[c] = p.bal[lm + c];
    lprop[c] = p.lprop[lm + c];
  }
  const float half = 0.5f * p.dn;

  // the two landmark logit tiles [C][rows]: lpk (L1) and scale <q_bar, q> (L2)
  auto logit_tiles = [&](int rows) {
    tile_gemm(W, DP, 1, K, 1, DP, C, rows, d,
              [&](int c, int r, float v) { L1[c * CP + r] = p.dn * v - rn[r]; });
    tile_gemm(QB, DP, 1, Q, 1, DP, C, rows, d,
              [&](int c, int r, float v) { L2[c * CP + r] = p.scale * v; });
  };

  // pass 1: the maxima over tokens
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_rows<T>(qkv, 0, p.nh, h, d, n0, rows, Q);
    load_rows<T>(qkv, 1, p.nh, h, d, n0, rows, K);
    __syncthreads();
    row_norms(K, rows, d, half, rn);
    __syncthreads();
    logit_tiles(rows);
    __syncthreads();
    for (int c = warp; c < C; c += warps) {
      float a = -INFINITY, t = -INFINITY;
      for (int r = lane; r < rows; r += 32) {
        a = fmaxf(a, L1[c * CP + r]);
        t = fmaxf(t, L2[c * CP + r]);
      }
      a = warp_max(a);
      t = warp_max(t);
      if (lane == 0) {
        m_k[c] = fmaxf(m_k[c], a);
        m_t[c] = fmaxf(m_t[c], t);
      }
    }
    __syncthreads();
  }

  // pass 2: the shifted sums, and kv += round(exp(lpk - m_k)) v; the v
  // rows take the q rows' buffer once the logits are formed
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_rows<T>(qkv, 0, p.nh, h, d, n0, rows, Q);
    load_rows<T>(qkv, 1, p.nh, h, d, n0, rows, K);
    __syncthreads();
    row_norms(K, rows, d, half, rn);
    __syncthreads();
    logit_tiles(rows);
    __syncthreads();
    load_rows<T>(qkv, 2, p.nh, h, d, n0, rows, Q);
    for (int c = warp; c < C; c += warps) {
      float sk = 0.f, stt = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float e = expf(L1[c * CP + r] - m_k[c]);
        sk += e;
        L1[c * CP + r] = round_to<T>(e);
        stt += expf(L2[c * CP + r] - m_t[c]);
      }
      sk = warp_sum(sk);
      stt = warp_sum(stt);
      if (lane == 0) {
        den[c] += sk;
        den_t[c] += stt;
      }
    }
    __syncthreads();
    tile_gemm(L1, CP, 1, Q, DP, 1, C, d, rows,
              [&](int c, int e, float v) { KV[c * DP + e] += v; });
    __syncthreads();
  }
  for (int c = tid; c < C; c += blockDim.x) {
    den[c] = fmaxf(den[c], 1e-15f);
    lse_k[c] = logf(den[c]) + m_k[c];
    lse_t[c] = logf(fmaxf(den_t[c], 1e-30f)) + m_t[c];
  }
  __syncthreads();
  for (int e = tid; e < C * d; e += blockDim.x) {
    const int c = e / d, x = e % d;
    KV[c * DP + x] = round_to<T>(KV[c * DP + x] / den[c]);
  }
  __syncthreads();

  // pass 3: each token's mis-opt combine over the landmarks
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_rows<T>(qkv, 0, p.nh, h, d, n0, rows, Q);
    __syncthreads();
    row_norms(Q, rows, d, half, rn);
    __syncthreads();
    tile_gemm(Q, DP, 1, W, 1, DP, rows, C, d,
              [&](int r, int c, float v) { L1[r * CQ + c] = p.dn * v - rn[r]; });
    tile_gemm(Q, DP, 1, QB, 1, DP, rows, C, d,
              [&](int r, int c, float v) { L2[r * CQ + c] = p.scale * v; });
    __syncthreads();
    for (int r = warp; r < rows; r += warps) {
      float* lw = L1 + r * CQ;
      float* lt = L2 + r * CQ;
      float ts = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float t = expf(lt[c] - lse_t[c]);
        lt[c] = t;
        ts += t;
      }
      const float mean = warp_sum(ts) / (float)C;
      float mx = -INFINITY;
      for (int c = lane; c < C; c += 32) {
        const float a = bal[c] + p.alpha * (lt[c] - mean);
        const float li = logf(fmaxf(a, 1e-8f)) + lw[c] + lse_k[c] - lprop[c];
        lw[c] = li;
        mx = fmaxf(mx, li);
      }
      mx = warp_max(mx);
      float s = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float e = expf(lw[c] - mx);
        lw[c] = e;
        s += e;
      }
      s = warp_sum(s);
      for (int c = lane; c < C; c += 32) lw[c] = round_to<T>(lw[c] / s);
    }
    __syncthreads();
    tile_gemm(L1, CQ, 1, KV, DP, 1, rows, d, C, [&](int r, int e, float v) {
      out[(size_t)(n0 + r) * HD + e] = from_f<T>(v);
    });
    __syncthreads();  // Q, L1, L2 and the norms are rewritten by the next tile
  }
}

// ---- the wmma route: the same passes with every product on tensor cores ----
//
// For bf16 geometries that uses_wmma() takes and the cluster route does not
// hold (plan()).  Every product above runs as warp-level bf16 MMA
// (16x16x16 tiles, f32 accumulation): its operands are values of bf16
// already (q, k, v, and w, q_bar, the numerators, the SNIS weights and kv
// rounded as above), so the products are exact and only the summation order
// differs from the CUDA-core route.  Landmarks are padded with zero rows to
// CP, a multiple of 16, and the padded rows and columns are left out of
// every max, sum and mean.  The operands live in shared memory in bf16 (rows
// padded by 8), the logits in f32; kv is summed in accumulator fragments
// that stay in registers through pass 2.

// Whether the wmma kernel takes (d, C): d a multiple of 16 and the kv tiles
// within the warps' accumulators (uses_wmma() in ops/kernels/lara_fused.py).
__host__ __device__ inline bool uses_wmma(int d, int C) {
  return d % 16 == 0 && (round16(C) / 16) * (d / 16) <= kWarps * kMaxAcc;
}

struct MmaLayout {
  size_t W, QB, KV, Q, K, V, F, P, stats, rows, total;
};

// The wmma route's shared memory (wmma_smem_bytes() in the wrapper): w,
// q_bar and the rounded kv [CP][d + 8] and the q, k, v tiles [kTile][d + 8]
// in bf16; F, f32, holds the two logit tiles ([CP][kTile + 4]
// in passes 1-2, [kTile][CP + 4] in pass 3), the kv sums [CP][d + 4] between
// passes 2 and 3, and the output tile [kTile][d + 4]; P, bf16, the rounded
// numerators [CP][kTile + 8] or SNIS weights [kTile][CP + 8].
__host__ __device__ inline MmaLayout make_mma_layout(int d, int C) {
  const size_t CP = round16(C), DB = d + 8;
  const size_t LF = CP * (kTile + 4) > kTile * (CP + 4) ? CP * (kTile + 4) : kTile * (CP + 4);
  size_t FS = 2 * LF;
  if (CP * (d + 4) > FS) FS = CP * (d + 4);
  if (kTile * (d + 4) > FS) FS = kTile * (d + 4);
  const size_t PB = CP * (kTile + 8) > kTile * (CP + 8) ? CP * (kTile + 8) : kTile * (CP + 8);
  MmaLayout L = {};
  size_t o = 0;
  L.W = o;     o += align128(CP * DB * 2);
  L.QB = o;    o += align128(CP * DB * 2);
  L.KV = o;    o += align128(CP * DB * 2);
  L.Q = o;     o += align128(kTile * DB * 2);
  L.K = o;     o += align128(kTile * DB * 2);
  L.V = o;     o += align128(kTile * DB * 2);
  L.F = o;     o += align128(FS * 4);
  L.P = o;     o += align128(PB * 2);
  L.stats = o; o += align128(8 * CP * 4);
  L.rows = o;  o += align128(kTile * 4);
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(kThreads, 3) lara_fused_mma_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = p.d, C = p.C, CP = round16(C), DB = d + 8, HD = p.nh * d;
  const int LT = kTile + 4, LC = CP + 4, KD = d + 4, TB = kTile + 8, PC = CP + 8;
  const MmaLayout L = make_mma_layout(d, C);
  bf16* W = reinterpret_cast<bf16*>(smem + L.W);     // [CP][DB]
  bf16* QB = reinterpret_cast<bf16*>(smem + L.QB);   // [CP][DB]
  bf16* KVb = reinterpret_cast<bf16*>(smem + L.KV);  // [CP][DB]
  bf16* Q = reinterpret_cast<bf16*>(smem + L.Q);     // [kTile][DB]
  bf16* K = reinterpret_cast<bf16*>(smem + L.K);     // [kTile][DB]
  bf16* V = reinterpret_cast<bf16*>(smem + L.V);     // [kTile][DB]
  float* F = reinterpret_cast<float*>(smem + L.F);
  bf16* P = reinterpret_cast<bf16*>(smem + L.P);
  float* st = reinterpret_cast<float*>(smem + L.stats);
  float* m_k = st, *den = st + CP, *lse_k = st + 2 * CP, *m_t = st + 3 * CP;
  float* den_t = st + 4 * CP, *lse_t = st + 5 * CP, *bal = st + 6 * CP, *lprop = st + 7 * CP;
  float* rn = reinterpret_cast<float*>(smem + L.rows);
  const int LF = CP * LT > kTile * LC ? CP * LT : kTile * LC;
  float* L1 = F;       // [CP][LT] in passes 1-2, [kTile][LC] in pass 3
  float* L2 = F + LF;  // the same
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* qkv = static_cast<const bf16*>(p.qkv) + (size_t)b * p.N * 3 * HD;
  bf16* out = static_cast<bf16*>(p.out) + (size_t)b * p.N * HD + h * d;
  const size_t lm = ((size_t)b * p.nh + h) * C;
  const float half = 0.5f * p.dn;

  for (int e = tid; e < CP * d; e += blockDim.x) {
    const int c = e / d, x = e % d;
    W[c * DB + x] = __float2bfloat16(c < C ? p.w[(lm + c) * d + x] : 0.f);
    QB[c * DB + x] = __float2bfloat16(c < C ? p.qb[(lm + c) * d + x] : 0.f);
  }
  for (int c = tid; c < C; c += blockDim.x) {
    m_k[c] = m_t[c] = -INFINITY;
    den[c] = den_t[c] = 0.f;
    bal[c] = p.bal[lm + c];
    lprop[c] = p.lprop[lm + c];
  }

  // pass 1: the maxima over tokens
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_tile_bf16(qkv, 0, p.nh, h, d, n0, rows, kTile, Q, DB);
    load_tile_bf16(qkv, 1, p.nh, h, d, n0, rows, kTile, K, DB);
    __syncthreads();
    row_norms_bf16(K, DB, rows, d, half, rn);
    mma_nt2(W, K, L1, QB, Q, L2, DB, CP, kTile, d, LT);
    __syncthreads();
    for (int c = warp; c < C; c += kWarps) {
      float a = -INFINITY, t = -INFINITY;
      for (int r = lane; r < rows; r += 32) {
        a = fmaxf(a, p.dn * L1[c * LT + r] - rn[r]);
        t = fmaxf(t, p.scale * L2[c * LT + r]);
      }
      a = warp_max(a);
      t = warp_max(t);
      if (lane == 0) {
        m_k[c] = fmaxf(m_k[c], a);
        m_t[c] = fmaxf(m_t[c], t);
      }
    }
    __syncthreads();
  }

  // pass 2: the shifted sums, and kv += round(exp(lpk - m_k)) v in fragments
  const int kv_tiles = (CP / 16) * (d / 16), dt = d / 16;
  FragC acc[kMaxAcc];
#pragma unroll
  for (int s = 0; s < kMaxAcc; ++s) wm::fill_fragment(acc[s], 0.f);
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_tile_bf16(qkv, 0, p.nh, h, d, n0, rows, kTile, Q, DB);
    load_tile_bf16(qkv, 1, p.nh, h, d, n0, rows, kTile, K, DB);
    load_tile_bf16(qkv, 2, p.nh, h, d, n0, rows, kTile, V, DB);
    __syncthreads();
    row_norms_bf16(K, DB, rows, d, half, rn);
    mma_nt2(W, K, L1, QB, Q, L2, DB, CP, kTile, d, LT);
    __syncthreads();
    for (int c = warp; c < CP; c += kWarps) {
      float sk = 0.f, stt = 0.f;
      for (int r = lane; r < kTile; r += 32) {
        float e = 0.f;
        if (c < C && r < rows) {
          e = expf(p.dn * L1[c * LT + r] - rn[r] - m_k[c]);
          sk += e;
          stt += expf(p.scale * L2[c * LT + r] - m_t[c]);
        }
        P[c * TB + r] = __float2bfloat16(e);
      }
      sk = warp_sum(sk);
      stt = warp_sum(stt);
      if (lane == 0 && c < C) {
        den[c] += sk;
        den_t[c] += stt;
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kMaxAcc; ++s) {
      const int f = warp + kWarps * s;
      if (f < kv_tiles) {
        const int i = f / dt, j = f % dt;
        FragA a;
        FragBr bv;
        for (int k = 0; k < kTile; k += 16) {
          wm::load_matrix_sync(a, P + 16 * i * TB + k, TB);
          wm::load_matrix_sync(bv, V + k * DB + 16 * j, DB);
          wm::mma_sync(acc[s], a, bv, acc[s]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < kMaxAcc; ++s) {
    const int f = warp + kWarps * s;
    if (f < kv_tiles)
      wm::store_matrix_sync(F + 16 * (f / dt) * KD + 16 * (f % dt), acc[s], KD,
                            wm::mem_row_major);
  }
  for (int c = tid; c < C; c += blockDim.x) {
    den[c] = fmaxf(den[c], 1e-15f);
    lse_k[c] = logf(den[c]) + m_k[c];
    lse_t[c] = logf(fmaxf(den_t[c], 1e-30f)) + m_t[c];
  }
  __syncthreads();
  for (int e = tid; e < CP * d; e += blockDim.x) {
    const int c = e / d, x = e % d;
    KVb[c * DB + x] = __float2bfloat16(c < C ? F[c * KD + x] / den[c] : 0.f);
  }
  __syncthreads();

  // pass 3: each token's mis-opt combine over the landmarks
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_tile_bf16(qkv, 0, p.nh, h, d, n0, rows, kTile, Q, DB);
    __syncthreads();
    row_norms_bf16(Q, DB, rows, d, half, rn);
    mma_nt2(Q, W, L1, Q, QB, L2, DB, kTile, CP, d, LC);
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      float* lw = L1 + r * LC;
      float* lt = L2 + r * LC;
      float ts = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float t = expf(p.scale * lt[c] - lse_t[c]);
        lt[c] = t;
        ts += t;
      }
      const float mean = warp_sum(ts) / (float)C;
      float mx = -INFINITY;
      for (int c = lane; c < C; c += 32) {
        const float a = bal[c] + p.alpha * (lt[c] - mean);
        const float li = logf(fmaxf(a, 1e-8f)) + p.dn * lw[c] - rn[r] + lse_k[c] - lprop[c];
        lw[c] = li;
        mx = fmaxf(mx, li);
      }
      mx = warp_max(mx);
      float s = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float e = expf(lw[c] - mx);
        lw[c] = e;
        s += e;
      }
      s = warp_sum(s);
      for (int c = lane; c < CP; c += 32)
        P[r * PC + c] = __float2bfloat16(c < C ? lw[c] / s : 0.f);
    }
    __syncthreads();
    for (int f = warp; f < (kTile / 16) * dt; f += kWarps) {
      const int i = f / dt, j = f % dt;
      FragA a;
      FragBr bk;
      FragC c;
      wm::fill_fragment(c, 0.f);
      for (int k = 0; k < CP; k += 16) {
        wm::load_matrix_sync(a, P + 16 * i * PC + k, PC);
        wm::load_matrix_sync(bk, KVb + k * DB + 16 * j, DB);
        wm::mma_sync(c, a, bk, c);
      }
      wm::store_matrix_sync(F + 16 * i * KD + 16 * j, c, KD, wm::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < rows * d; e += blockDim.x) {
      const int r = e / d, x = e % d;
      out[(size_t)(n0 + r) * HD + x] = __float2bfloat16(F[r * KD + x]);
    }
    __syncthreads();  // Q, F and P are rewritten by the next tile
  }
}

// ---- the cluster route: a thread-block cluster per (image, head) ----
//
// The design is in the header comment.  A cluster of R blocks takes one
// (image, head): grid (R * nh, B), clusters of R along x.

namespace cg = cooperative_groups;

constexpr int kCWarps = 16;     // a cluster block's warps: one block an SM, 128 registers
constexpr int kCThreads = 32 * kCWarps;
constexpr int kMaxRanks = 16;   // cluster sizes go to 16 (non-portable above 8)
constexpr int kMaxTiles = 4;    // landmark tiles of 16 a phase-B strip holds: C <= 64
constexpr int kSmemLimit = 232448;
constexpr int kHeld = 4;        // phase-A tiles whose lpk logits a warp keeps in registers
constexpr int kStats = 9;       // per-landmark rows of f32 in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// Whether the cluster route's kernel is built for (d, C) in bf16 (uses_mma()
// in the wrapper).
__host__ __device__ inline bool uses_cluster(int d, int C) {
  return (d == 16 || d == 32 || d == 64) && C <= 16 * kMaxTiles;
}

struct ClusterLayout {
  size_t Q, K, V, W, QB, KV, KVP, KVR, MX, DR, TR, stats, norms, red, total;
};

// The cluster route's shared memory (smem_bytes(d, C, 2, rows, R) in the
// wrapper), each region 128-byte aligned: q, k, v [RP][D+8] (RP the block's
// rows rounded up to 16) and w, q_bar, kv [CP][D+8] in bf16; the block's f32
// kv sums [CP][D+8] over k and v; what the other blocks write here, in f32:
// as the owner of LO = ceil(C / R) landmarks, every block's kv sums
// [R][LO][D], den [R][LO] and (maximum, sum) of the landmark logits
// [R][LO][2], and every block's maxima [R][CP]; nine per-landmark rows [CP]
// and the per-token norms [RP] in f32; the warps' row statistics
// [kCWarps][3][16] in f32.
__host__ __device__ inline ClusterLayout make_cluster_layout(int d, int C, int rows, int R) {
  const size_t RP = round16(rows), CP = round16(C), DB = d + 8, LO = (C + R - 1) / R;
  ClusterLayout L = {};
  size_t o = 0;
  L.Q = o;     o += align128(RP * DB * 2);
  L.K = L.KVP = o;  // the kv sums take k's and v's place once phase A is done
  L.V = o + align128(RP * DB * 2);
  const size_t kv2 = 2 * align128(RP * DB * 2), kvp = align128(CP * DB * 4);
  o += kv2 > kvp ? kv2 : kvp;
  L.W = o;     o += align128(CP * DB * 2);
  L.QB = o;    o += align128(CP * DB * 2);
  L.KV = o;    o += align128(CP * DB * 2);
  L.KVR = o;   o += align128(R * LO * d * 4);
  L.MX = o;    o += align128(R * CP * 4);
  L.DR = o;    o += align128(R * LO * 4);
  L.TR = o;    o += align128(R * LO * 8);
  L.stats = o; o += align128(kStats * CP * 4);
  L.norms = o; o += align128(RP * 4);
  L.red = o;   o += align128(kCWarps * 3 * 16 * 4);
  L.total = o;
  return L;
}

// The cluster size the route takes at (N, d, C) in bf16, or 0 where it does
// not take the geometry (plan() in the wrapper): the smallest whose blocks
// fit, every block holding at least one token.
inline int plan_ranks(int N, int d, int C) {
  if (N <= 0 || C <= 0 || !uses_cluster(d, C)) return 0;
  for (int R = 1; R <= kMaxRanks; ++R) {
    const int rows = (N + R - 1) / R;
    if ((R - 1) * rows < N && make_cluster_layout(d, C, rows, R).total <= kSmemLimit) return R;
  }
  return 0;
}

#ifdef LARA_PHASES
constexpr int kPhaseBlocks = 16384;
__device__ unsigned long long g_lara_phases[12][kPhaseBlocks];
__device__ __forceinline__ void phase_store(int mark, unsigned long long t) {
  const unsigned blk = blockIdx.x + gridDim.x * blockIdx.y;
  if (threadIdx.x == 0 && blk < kPhaseBlocks) g_lara_phases[mark][blk] = t;
}
__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_MARK(k) phase_store((k), clock64())
#define PHASE_TIMER(k) phase_store((k), global_timer())
#define PHASE_END() (__syncthreads(), PHASE_MARK(8), PHASE_TIMER(11))
#else
#define PHASE_MARK(k) ((void)0)
#define PHASE_TIMER(k) ((void)0)
#define PHASE_END() ((void)0)
#endif

// The two halves of a cluster barrier: arrive (what this block wrote is
// released to the cluster) and wait (what the others wrote is acquired).
// Between them a thread may do work that touches no other block's memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Waits until at most one group of this thread's cp.async copies is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// (max, sum of exp2(x - max)) pairs merged: the larger maximum, each sum
// rescaled to it.  A floor of -FLT_MAX for the maxima keeps empty pairs
// (-FLT_MAX, 0) exact.
__device__ __forceinline__ float2 lse_merge(float2 a, float2 v) {
  const float m = fmaxf(a.x, v.x);
  return make_float2(m, a.y * mma_frag::exp2_approx(a.x - m) +
                            v.y * mma_frag::exp2_approx(v.x - m));
}

// One 16-token tile tt of a phase-A strip in base 2, -inf at tokens past the
// block's nr: the lpk logits (s) of the warp's 16 landmarks (A fragments
// wa) and, with kT, their landmark logits q_bar q^T (t; A fragments ba).
// s[n][e] is landmark g + 8 (e / 2) of the strip, token tt*16 + 8n +
// 2(lane % 4) + e % 2.
template <int D, bool kT>
__device__ __forceinline__ void landmark_tile(const uint32_t (&wa)[D / 16][4],
                                              const uint32_t (&ba)[D / 16][4],
                                              const bf16* K, const bf16* Q, const float* nk,
                                              int nr, int tt, float c1, float c2,
                                              float (&s)[2][4], float (&t)[2][4]) {
  using namespace mma_frag;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = t[n][e] = 0.f;
  const int r = min(tt * 16 + row_c(lane), nr - 1) * (D + 8) + col_c(lane);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t bk[4];
    ldsm_x4(bk, K + r + 16 * kd);
    mma_bf16(s[0], wa[kd], bk[0], bk[1]);
    mma_bf16(s[1], wa[kd], bk[2], bk[3]);
    if (kT) {
      uint32_t bq[4];
      ldsm_x4(bq, Q + r + 16 * kd);
      mma_bf16(t[0], ba[kd], bq[0], bq[1]);
      mma_bf16(t[1], ba[kd], bq[2], bq[3]);
    }
  }
  const bool masked = tt * 16 + 16 > nr;  // uniform over the warp
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tok = tt * 16 + 8 * n + 2 * (lane & 3) + (e & 1);
      s[n][e] = s[n][e] * c1 - nk[min(tok, nr - 1)];
      t[n][e] *= c2;
      if (masked && tok >= nr) s[n][e] = t[n][e] = -INFINITY;
    }
}

// The row maxima mk of a phase-A tile's lpk logits s.
__device__ __forceinline__ void tile_max(const float (&s)[2][4], float (&mk)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    mk[i] = fmaxf(mk[i], fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                               fmaxf(s[1][2 * i], s[1][2 * i + 1])));
}

// The online (maxima, sums of exp2(t - maxima)) mt, lt of a phase-A tile's
// landmark logits t.
__device__ __forceinline__ void tile_lse(const float (&t)[2][4], float (&mt)[2],
                                         float (&lt)[2]) {
  using mma_frag::exp2_approx;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m = fmaxf(mt[i], fmaxf(fmaxf(t[0][2 * i], t[0][2 * i + 1]),
                                       fmaxf(t[1][2 * i], t[1][2 * i + 1])));
    lt[i] = lt[i] * exp2_approx(mt[i] - m) + exp2_approx(t[0][2 * i] - m) +
            exp2_approx(t[0][2 * i + 1] - m) + exp2_approx(t[1][2 * i] - m) +
            exp2_approx(t[1][2 * i + 1] - m);
    mt[i] = m;
  }
}

// kv += round(exp2(s - m_k)) v for a phase-A tile tt (numerators summed in
// f32 into dk first), the values read through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void pv_tile(float (&s)[2][4], const float (&gk)[2], float (&dk)[2],
                                        const bf16* V, int tt, int nr, float (&o)[D / 8][4]) {
  using namespace mma_frag;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = exp2_approx(s[n][e] - gk[e >> 1]);  // ex2(-inf) = 0 past nr
      dk[e >> 1] += s[n][e];
    }
  uint32_t a[4];
  c_to_a(s[0], s[1], a);
  const bf16* vr = V + min(tt * 16 + row_r(lane), nr - 1) * (D + 8) + col_r(lane);
#pragma unroll
  for (int nd = 0; nd < D / 16; ++nd) {
    uint32_t bv[4];
    ldsm_x4_trans(bv, vr + 16 * nd);
    mma_bf16(o[2 * nd], a, bv[0], bv[1]);
    mma_bf16(o[2 * nd + 1], a, bv[2], bv[3]);
  }
}

// Phase B's products of the strip at rows r0: q w^T (sw) and q q_bar^T (sq),
// [16 x CP] in fragments; sw[kt][n][e] is row r0 + g + 8 (e / 2), landmark
// kt*16 + 8n + 2(lane % 4) + e % 2.  Rows past nr read row nr - 1.
template <int D>
__device__ __forceinline__ void strip_logits(const bf16* Q, const bf16* W, const bf16* QB,
                                             int r0, int nr, int C, int NLT,
                                             float (&sw)[kMaxTiles][2][4],
                                             float (&sq)[kMaxTiles][2][4]) {
  using namespace mma_frag;
  constexpr int DB = D + 8;
  const int lane = threadIdx.x & 31;
  uint32_t qa[D / 16][4];
  const bf16* qr = Q + min(r0 + row_r(lane), nr - 1) * DB + col_r(lane);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) ldsm_x4(qa[kd], qr + 16 * kd);
#pragma unroll
  for (int kt = 0; kt < kMaxTiles; ++kt) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sw[kt][n][e] = sq[kt][n][e] = 0.f;
    if (kt < NLT) {  // the second 8 columns only where some are real
      const int lr = (kt * 16 + row_c(lane)) * DB + col_c(lane);
      const bool both = kt * 16 + 8 < C;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t bw[4], bq[4];
        ldsm_x4(bw, W + lr + 16 * kd);
        ldsm_x4(bq, QB + lr + 16 * kd);
        mma_bf16(sw[kt][0], qa[kd], bw[0], bw[1]);
        mma_bf16(sq[kt][0], qa[kd], bq[0], bq[1]);
        if (both) {
          mma_bf16(sw[kt][1], qa[kd], bw[2], bw[3]);
          mma_bf16(sq[kt][1], qa[kd], bq[2], bq[3]);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kCThreads, 1) lara_fused_cluster_kernel(const Params p) {
  using namespace mma_frag;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DB = D + 8, KD = D / 16;
  constexpr int kLm = (16 * kMaxTiles * (D / 4) + kCThreads - 1) / kCThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const int R = p.R, rank = (int)cluster.block_rank();
  const int C = p.C, CP = round16(C), NLT = CP / 16, HD = p.nh * D, LO = (C + R - 1) / R;
  const int h = blockIdx.x / R, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, qd = lane & 3;
  const int n0 = rank * p.rows, nr = min(p.rows, p.N - n0), NT = (nr + 15) / 16;
  const ClusterLayout L = make_cluster_layout(D, C, p.rows, R);
  bf16* Q = reinterpret_cast<bf16*>(smem + L.Q);      // [RP][DB]; phase B's output rows
  bf16* K = reinterpret_cast<bf16*>(smem + L.K);      // [RP][DB]
  bf16* V = reinterpret_cast<bf16*>(smem + L.V);      // [RP][DB]
  bf16* W = reinterpret_cast<bf16*>(smem + L.W);      // [CP][DB]
  bf16* QB = reinterpret_cast<bf16*>(smem + L.QB);    // [CP][DB]
  bf16* KV = reinterpret_cast<bf16*>(smem + L.KV);    // [CP][DB]: round(kv / den)
  float* KVP = reinterpret_cast<float*>(smem + L.KVP);  // [CP][DB]: this block's kv sums
  float* KVR = reinterpret_cast<float*>(smem + L.KVR);  // [R][LO][D]: every block's, owned
  float* MX = reinterpret_cast<float*>(smem + L.MX);    // [R][CP]: every block's maxima
  float* DR = reinterpret_cast<float*>(smem + L.DR);    // [R][LO]: every block's den, owned
  float2* TR = reinterpret_cast<float2*>(smem + L.TR);  // [R][LO]: every block's (m_t, sum)
  // per landmark, base 2: this block's maxima of lpk and the true ones,
  // this block's sums of exp2(lpk - m_k) and (maximum, sum of exp2(t -
  // maximum)) of the landmark logits t, balance and log proposal, then
  // log2(den) + m_k - lprop log2 e and lse_t log2 e
  float* st = reinterpret_cast<float*>(smem + L.stats);
  float* pmk = st, *gmk = st + CP, *pden = st + 2 * CP, *bal = st + 3 * CP;
  float* lprop = st + 4 * CP, *cst = st + 5 * CP, *lst = st + 6 * CP;
  float2* pT = reinterpret_cast<float2*>(st + 7 * CP);  // [CP]
  float* nk = reinterpret_cast<float*>(smem + L.norms);  // [RP]: |k|^2 log2 e / (2 sqrt d)
  float* red = reinterpret_cast<float*>(smem + L.red);   // [kCWarps][3][16]
  const bf16* qkv = static_cast<const bf16*>(p.qkv) + ((size_t)b * p.N + n0) * 3 * HD + h * D;
  const size_t lm = ((size_t)b * p.nh + h) * C;  // this (image, head)'s landmarks
  const float c1 = p.dn * kLog2e, c2 = p.scale * kLog2e;

  PHASE_TIMER(10);
  PHASE_MARK(0);
  cluster_arrive();  // #0: this block runs (the others may write its memory)
  // ---- staging: w and q_bar loaded first (then rounded to bf16; zero rows
  // past C, and zero kv rows there) and the landmark terms; the slice's q
  // and k rows, then its v rows, by cp.async behind them
  {
    float4 w4[kLm], q4[kLm];
#pragma unroll
    for (int j = 0; j < kLm; ++j) {
      const int e = tid + j * kCThreads, c = e / (D / 4), x = 4 * (e % (D / 4));
      w4[j] = q4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < C) {
        w4[j] = *reinterpret_cast<const float4*>(p.w + (lm + c) * D + x);
        q4[j] = *reinterpret_cast<const float4*>(p.qb + (lm + c) * D + x);
      }
    }
    const float bl = tid < C ? p.bal[lm + tid] : 0.f, lp = tid < C ? p.lprop[lm + tid] : 0.f;
    for (int e = tid; e < nr * 2 * (D / 8); e += kCThreads) {
      const int v = e % (D / 8), part = (e / (D / 8)) % 2, t = e / (2 * (D / 8));
      cp_async16((part ? K : Q) + t * DB + 8 * v,
                 qkv + (size_t)t * 3 * HD + part * HD + 8 * v);
    }
    cp_async_commit();
    for (int e = tid; e < nr * (D / 8); e += kCThreads) {
      const int v = e % (D / 8), t = e / (D / 8);
      cp_async16(V + t * DB + 8 * v, qkv + (size_t)t * 3 * HD + 2 * HD + 8 * v);
    }
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < kLm; ++j) {
      const int e = tid + j * kCThreads, c = e / (D / 4), x = 4 * (e % (D / 4));
      if (c < CP) {
        *reinterpret_cast<uint2*>(W + c * DB + x) =
            make_uint2(pack_bf16(w4[j].x, w4[j].y), pack_bf16(w4[j].z, w4[j].w));
        *reinterpret_cast<uint2*>(QB + c * DB + x) =
            make_uint2(pack_bf16(q4[j].x, q4[j].y), pack_bf16(q4[j].z, q4[j].w));
        if (c >= C) *reinterpret_cast<uint2*>(KV + c * DB + x) = make_uint2(0u, 0u);
      }
    }
    if (tid < CP) {
      bal[tid] = bl;
      lprop[tid] = lp;
    }
  }
  cp_async_wait_one();  // q and k
  __syncthreads();
  // each token's |k|^2 in f32, times log2 e / (2 sqrt d)
  for (int t = tid; t < nr; t += kCThreads) {
    float sum = 0.f;
#pragma unroll
    for (int x = 0; x < D; x += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(K + t * DB + x);
      const uint32_t w2[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w2[j]));
        sum += f.x * f.x + f.y * f.y;
      }
    }
    nk[t] = 0.5f * c1 * sum;
  }
  __syncthreads();
  PHASE_MARK(1);

  // ---- phase A: a warp owns landmark strip `strip` and every NSH-th token
  // tile from `share`; the lpk logits of its first kHeld tiles stay in
  // registers through barrier #1, later tiles' are formed again after it.
  // The landmark logits' maxima and sums are taken online (nothing of them
  // is rounded).
  const int NSH = kCWarps / NLT, strip = warp / NSH, share = warp % NSH;
  const bool active = strip < NLT;
  uint32_t wa[KD][4], ba[KD][4];
  if (active) {
    const int r = (strip * 16 + row_r(lane)) * DB + col_r(lane);
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      ldsm_x4(wa[kd], W + r + 16 * kd);
      ldsm_x4(ba[kd], QB + r + 16 * kd);
    }
  }
  float sk[kHeld][2][4];
  float mk[2] = {-INFINITY, -INFINITY}, mt[2] = {-FLT_MAX, -FLT_MAX}, lt[2] = {0.f, 0.f};
  // the warp's tiles; where it has kHeld or more, the held tiles' loops have
  // no branch, so their products interleave
  const int mine = active && share < NT ? (NT - share + NSH - 1) / NSH : 0;
  const auto stats_held = [&](int i) {
    float t[2][4];
    landmark_tile<D, true>(wa, ba, K, Q, nk, nr, share + i * NSH, c1, c2, sk[i], t);
    tile_max(sk[i], mk);
    tile_lse(t, mt, lt);
  };
  if (mine >= kHeld) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i) stats_held(i);
  } else {
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      if (i < mine) stats_held(i);
  }
  for (int tt = share + kHeld * NSH; active && tt < NT; tt += NSH) {
    float s[2][4], t[2][4];
    landmark_tile<D, true>(wa, ba, K, Q, nk, nr, tt, c1, c2, s, t);
    tile_max(s, mk);
    tile_lse(t, mt, lt);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mk[i] = quad_max(mk[i]);
    const float m = quad_max(mt[i]);
    lt[i] = quad_sum(lt[i] * exp2_approx(mt[i] - m));
    if (active && qd == 0) {
      red[warp * 48 + g + 8 * i] = mk[i];
      red[warp * 48 + 16 + g + 8 * i] = m;
      red[warp * 48 + 32 + g + 8 * i] = lt[i];
    }
  }
  __syncthreads();
  for (int c = tid; c < CP; c += kCThreads) {  // the shares in share order
    float a = -INFINITY;
    float2 T = make_float2(-FLT_MAX, 0.f);
    for (int sh = 0; sh < NSH; ++sh) {
      const float* rw = red + ((c >> 4) * NSH + sh) * 48 + (c & 15);
      a = fmaxf(a, rw[0]);
      T = lse_merge(T, make_float2(rw[16], rw[32]));
    }
    pmk[c] = a;
    pT[c] = T;
  }
  __syncthreads();
  PHASE_MARK(2);
  cluster_wait();  // #0: every block of the cluster runs
  for (int e = tid; e < R * CP; e += kCThreads)  // this block's maxima into every block
    cluster.map_shared_rank(MX, e / CP)[rank * CP + e % CP] = pmk[e % CP];
  cp_async_wait_all();  // v
  cluster_arrive();     // #1: every block's maxima are in place
  cluster_wait();
  for (int c = tid; c < CP; c += kCThreads) {
    float a = -INFINITY;
    for (int r = 0; r < R; ++r) a = fmaxf(a, MX[r * CP + c]);
    gmk[c] = a;
  }
  __syncthreads();
  PHASE_MARK(3);

  // the sums and kv against the true maxima: exp2(lpk - m_k) rounded to
  // bf16 as the A operand of P v, f32 sums of the unrounded ones
  float o[D / 8][4], dk[2] = {0.f, 0.f}, gk[2];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) gk[i] = active ? gmk[strip * 16 + g + 8 * i] : 0.f;
  if (mine >= kHeld) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i) pv_tile<D>(sk[i], gk, dk, V, share + i * NSH, nr, o);
  } else {
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      if (i < mine) pv_tile<D>(sk[i], gk, dk, V, share + i * NSH, nr, o);
  }
  for (int tt = share + kHeld * NSH; active && tt < NT; tt += NSH) {
    float s[2][4], t[2][4];
    landmark_tile<D, false>(wa, ba, K, Q, nk, nr, tt, c1, c2, s, t);
    pv_tile<D>(s, gk, dk, V, tt, nr, o);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dk[i] = quad_sum(dk[i]);
    if (active && qd == 0) red[warp * 48 + g + 8 * i] = dk[i];  // read before #1
  }
  // this block's kv sums, over k and v (no warp reads them any more): the
  // shares of a strip add theirs in share order
  __syncthreads();
  for (int j = 0; j < NSH; ++j) {
    if (active && share == j) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float2* dst = reinterpret_cast<float2*>(KVP + (strip * 16 + g + 8 * i) * DB +
                                                  8 * nd + 2 * qd);
          float2 v = make_float2(o[nd][2 * i], o[nd][2 * i + 1]);
          if (j > 0) {
            const float2 was = *dst;
            v.x += was.x;
            v.y += was.y;
          }
          *dst = v;
        }
    }
    __syncthreads();
  }
  for (int c = tid; c < CP; c += kCThreads) {
    float a = 0.f;
    for (int sh = 0; sh < NSH; ++sh) a += red[((c >> 4) * NSH + sh) * 48 + (c & 15)];
    pden[c] = a;
  }
  __syncthreads();
  PHASE_MARK(4);

  // ---- the exchange.  Each block writes its sums of landmark c into the
  // shared memory of c's owner, block c / LO; the owner adds them in rank
  // order and writes round(kv / den) and the lse terms into every block.
  for (int e = tid; e < C * (D / 4); e += kCThreads) {
    const int c = e / (D / 4), x = 4 * (e % (D / 4)), owner = c / LO;
    *reinterpret_cast<float4*>(cluster.map_shared_rank(KVR, owner) +
                               (rank * LO + c - owner * LO) * D + x) =
        *reinterpret_cast<const float4*>(KVP + c * DB + x);
  }
  for (int c = tid; c < C; c += kCThreads) {
    const int owner = c / LO, slot = rank * LO + c - owner * LO;
    cluster.map_shared_rank(DR, owner)[slot] = pden[c];
    cluster.map_shared_rank(TR, owner)[slot] = pT[c];
  }
  cluster_arrive();  // #2: this block's sums are in their owners' memory
  // meanwhile phase B's products for the warp's first strip (local rows;
  // a warp with no strip forms its last row's, unused, rather than hold a
  // predicate through the exchange)
  float sw[kMaxTiles][2][4], sq[kMaxTiles][2][4];
  strip_logits<D>(Q, W, QB, 16 * warp, nr, C, NLT, sw, sq);
  cluster_wait();
  PHASE_MARK(5);
  const int c0 = min(C, rank * LO), c1e = min(C, c0 + LO);
  for (int c = c0 + tid; c < c1e; c += kCThreads) {
    float den = 0.f;
    float2 T = make_float2(-FLT_MAX, 0.f);
    for (int r = 0; r < R; ++r) {
      den += DR[r * LO + c - c0];
      T = lse_merge(T, TR[r * LO + c - c0]);
    }
    den = fmaxf(den, 1e-15f);
    red[c - c0] = den;
    const float ck = log2f(den) + gmk[c] - kLog2e * lprop[c];
    const float ct = log2f(fmaxf(T.y, 1e-30f)) + T.x;
    for (int r = 0; r < R; ++r) {
      cluster.map_shared_rank(cst, r)[c] = ck;
      cluster.map_shared_rank(lst, r)[c] = ct;
    }
  }
  __syncthreads();
  for (int e = tid; e < (c1e - c0) * (D / 4); e += kCThreads) {
    const int c = c0 + e / (D / 4), x = 4 * (e % (D / 4));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(KVR + (r * LO + c - c0) * D + x);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    const float den = red[c - c0];
    const uint2 kv = make_uint2(pack_bf16(acc.x / den, acc.y / den),
                                pack_bf16(acc.z / den, acc.w / den));
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<uint2*>(cluster.map_shared_rank(KV, r) + c * DB + x) = kv;
  }
  PHASE_MARK(6);
  cluster_arrive();  // #3: every kv row and lse term is in place; from here
  cluster_wait();    // on no block touches another's memory
  PHASE_MARK(7);

  // ---- phase B: a warp owns 16 token rows; the landmarks are its keys.
  // The row's |q|^2 term is the same for every landmark and cancels in the
  // softmax over them, and softmax(log alpha + x) is alpha exp(x - max x)
  // over its sum; column groups of 8 wholly past C are skipped (uniform over
  // the warp).
  bf16* out = static_cast<bf16*>(p.out) + ((size_t)b * p.N + n0) * HD + h * D;
  for (int sp = warp; sp < NT; sp += kCWarps) {
    const int r0 = sp * 16;
    if (sp != warp) strip_logits<D>(Q, W, QB, r0, nr, C, NLT, sw, sq);
    // rows r0 + g and r0 + g + 8; column c = kt*16 + 8n + 2 qd + e % 2
    float rs[2] = {0.f, 0.f}, mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < kMaxTiles; ++kt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        if (kt * 16 + 8 * n < C) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = kt * 16 + 8 * n + 2 * qd + (e & 1);
            const bool real = c < C;
            const float tv = real ? exp2_approx(sq[kt][n][e] * c2 - lst[c]) : 0.f;
            const float x = real ? sw[kt][n][e] * c1 + cst[c] : -INFINITY;
            sq[kt][n][e] = tv;
            sw[kt][n][e] = x;
            rs[e >> 1] += tv;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
    float mean[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mean[i] = quad_sum(rs[i]) / (float)C;
      mx[i] = quad_max(mx[i]);
    }
#pragma unroll
    for (int kt = 0; kt < kMaxTiles; ++kt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = kt * 16 + 8 * n + 2 * qd + (e & 1);
          float w = 0.f;  // wholly padded groups hold 0
          if (kt * 16 + 8 * n < C && c < C) {
            const float a = bal[c] + p.alpha * (sq[kt][n][e] - mean[e >> 1]);
            w = fmaxf(a, 1e-8f) * exp2_approx(sw[kt][n][e] - mx[e >> 1]);
          }
          sw[kt][n][e] = w;
          sum[e >> 1] += w;
        }
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) inv[i] = 1.f / quad_sum(sum[i]);
    // out = round(weights) kv: the weights normalised, then rounded
    float o2[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o2[nd][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kMaxTiles; ++kt) {
      if (kt < NLT) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sw[kt][n][e] *= inv[e >> 1];
        uint32_t a[4];
        c_to_a(sw[kt][0], sw[kt][1], a);
        const bf16* kr = KV + (kt * 16 + row_r(lane)) * DB + col_r(lane);
#pragma unroll
        for (int nd = 0; nd < KD; ++nd) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, kr + 16 * nd);
          mma_bf16(o2[2 * nd], a, bv[0], bv[1]);
          mma_bf16(o2[2 * nd + 1], a, bv[2], bv[3]);
        }
      }
    }
    // the strip's rows cast to bf16 in its own q rows, then 16 bytes a lane
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(Q + (r0 + g + 8 * i) * DB + 8 * nd + 2 * qd) =
            pack_bf16(o2[nd][2 * i], o2[nd][2 * i + 1]);
    __syncwarp();
    for (int e = lane; e < 16 * (D / 8); e += 32) {
      const int r = e / (D / 8), x = 8 * (e % (D / 8));
      if (r0 + r < nr)
        *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * HD + x) =
            *reinterpret_cast<const uint4*>(Q + (r0 + r) * DB + x);
    }
  }
  PHASE_END();
}

template <int D>
cudaError_t prepare_cluster(const Params& p, size_t smem) {
  const auto kernel = lara_fused_cluster_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || p.R <= 8) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The launch configuration of the cluster kernel (attr must outlive cfg).
inline cudaLaunchConfig_t cluster_config(const Params& p, size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.R * p.nh, p.B);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D>
cudaError_t launch_cluster(const Params& p, cudaStream_t stream) {
  const size_t smem = make_cluster_layout(D, p.C, p.rows, p.R).total;
  cudaError_t err = prepare_cluster<D>(p, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(p, smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, lara_fused_cluster_kernel<D>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of the kernel that fit the card at once, or -1.
template <int D>
int max_active_clusters(const Params& p) {
  const size_t smem = make_cluster_layout(D, p.C, p.rows, p.R).total;
  if (prepare_cluster<D>(p, smem) != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(p, smem, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, lara_fused_cluster_kernel<D>, &cfg) != cudaSuccess)
    return -1;
  return n;
}

cudaError_t launch_wmma(const Params& p, cudaStream_t stream) {
  const MmaLayout L = make_mma_layout(p.d, p.C);
  cudaError_t err = cudaFuncSetAttribute(
      lara_fused_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  lara_fused_mma_kernel<<<dim3(p.nh, p.B), kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cuda_cores(const Params& p, cudaStream_t stream) {
  const Layout L = make_layout(p.d, p.C);
  auto kernel = lara_fused_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.nh, p.B), kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

// The geometry fields of p for cluster size R (0: no cluster); false where
// no route takes them.
bool make_geometry(Params& p, int B, int N, int nh, int d, int C, int R) {
  if (B <= 0 || B > 65535 || N <= 0 || nh <= 0 || d <= 0 || C <= 0 || R < 0 ||
      R > kMaxRanks)
    return false;
  p.B = B; p.N = N; p.nh = nh; p.d = d; p.C = C; p.R = R;
  p.rows = R > 0 ? (N + R - 1) / R : 0;
  if (R == 0) return true;
  return uses_cluster(d, C) && (R - 1) * p.rows < N &&
         make_cluster_layout(d, C, p.rows, R).total <= (size_t)kSmemLimit;
}

}  // namespace

extern "C" {

// The route the wrapper's plan() takes at (N, d, C, is_bf16), its twin:
// the cluster size (> 0) of the cluster route, else -1 for the wmma kernel
// where its block fits, else 0 for the CUDA-core kernel where its block
// fits, -2 where no route holds the geometry.
int lara_fused_plan(int N, int d, int C, int is_bf16) {
  if (N <= 0 || d <= 0 || C <= 0) return -2;
  const int R = is_bf16 ? plan_ranks(N, d, C) : 0;
  if (R > 0) return R;
  if (is_bf16 && uses_wmma(d, C) && make_mma_layout(d, C).total <= (size_t)kSmemLimit)
    return -1;
  if (make_layout(d, C).total <= (size_t)kSmemLimit) return 0;
  return -2;
}

// Shared memory of one block (smem_bytes() in the wrapper): of the cluster
// route with `rows` token rows a block in clusters of `ranks` where rows > 0,
// else of the wmma kernel for bf16 where it takes (d, C), else of the
// CUDA-core kernel.
int lara_fused_smem_bytes(int d, int C, int is_bf16, int rows, int ranks) {
  if (rows > 0) return (int)make_cluster_layout(d, C, rows, ranks).total;
  return (int)(is_bf16 && uses_wmma(d, C) ? make_mma_layout(d, C).total
                                          : make_layout(d, C).total);
}

// Clusters of R blocks of the cluster kernel at (N, d, C) that fit the card
// at once (the occupancy calculator), or -1.
int lara_fused_max_active_clusters(int N, int d, int C, int R) {
  Params p = {};
  if (R <= 0 || !make_geometry(p, 1, N, 1, d, C, R)) return -1;
  switch (d) {
    case 16: return max_active_clusters<16>(p);
    case 32: return max_active_clusters<32>(p);
    case 64: return max_active_clusters<64>(p);
    default: return -1;
  }
}

#ifdef LARA_PHASES
// Copies g_lara_phases ([12][16384] uint64) to host memory at dst; a
// cudaError_t.
int lara_fused_phases_copy(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_lara_phases, sizeof(g_lara_phases));
}
#endif

const char* lara_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: out [B, N, nh*d] from qkv (float32 or bfloat16) and the
// f32 landmark operands.  `ranks` > 0 launches the cluster kernel (bf16) with
// clusters of that size, 0 the CUDA-core kernel, -1 the wmma kernel (bf16);
// the wrapper's plan() picks it.  Returns a cudaError_t (0 on success).
int lara_fused_launch(const void* qkv, const float* w, const float* qb, const float* bal,
                      const float* lprop, void* out, int B, int N, int nh, int d, int C,
                      int is_bf16, float scale, float dn, float alpha, int ranks,
                      void* stream) {
  Params p = {};
  if (!make_geometry(p, B, N, nh, d, C, ranks > 0 ? ranks : 0)) return cudaErrorInvalidValue;
  p.qkv = qkv; p.w = w; p.qb = qb; p.bal = bal; p.lprop = lprop; p.out = out;
  p.scale = scale; p.dn = dn; p.alpha = alpha;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ranks > 0) {
    if (!is_bf16) return cudaErrorInvalidValue;
    switch (d) {
      case 16: return launch_cluster<16>(p, s);
      case 32: return launch_cluster<32>(p, s);
      case 64: return launch_cluster<64>(p, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (ranks == -1) {
    if (!is_bf16 || !uses_wmma(d, C)) return cudaErrorInvalidValue;
    return launch_wmma(p, s);
  }
  if (ranks != 0) return cudaErrorInvalidValue;
  return is_bf16 ? launch_cuda_cores<__nv_bfloat16>(p, s) : launch_cuda_cores<float>(p, s);
}

}  // extern "C"
