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
// Design.  The landmark statistics need every token of an (image, head)
// before any token's combine, and one (image, head) of q, k, v (301 KB in
// bf16 at N=784) does not fit in an SM's shared memory.  So one block takes
// one (image, head) and walks its tokens three times in tiles of 32 rows held
// in shared memory (f32): pass 1 finds the true maxima of lpk and of the
// landmark logits over the tokens, pass 2 sums the shifted exponentials and
// accumulates the rounded numerators against v into kv, pass 3 runs each
// token's combine.  A tile's v rows reuse its q rows' buffer, which keeps a
// block at 69.6 KB at the LARA shape: three blocks an SM, so all 384 blocks
// of B=128 x 3 heads are resident at once.  The token softmaxes are shifted by their true maximum, as
// the JAX twin and eager path are (the TPU kernel's fixed bound
// |w_c|^2/(2 sqrt d) underflows for keys far from w_c).  Products run on CUDA
// cores through smem_tile::tile_gemm (4x4 register tiles over rows padded to
// odd strides).  Roundings follow the TPU kernel: both operands of every
// product in the input type (w, q_bar, the token-softmax numerators, the SNIS
// weights and kv rounded first), every sum f32, the output cast last.  No
// tensor cores, TMA or pipelining.
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

// ---- the bf16 route: the same passes with every product on tensor cores ----
//
// For bf16 inputs whose head dim is a multiple of 16, every product above
// runs as warp-level bf16 MMA (16x16x16 tiles, f32 accumulation): its
// operands are values of bf16 already (q, k, v, and w, q_bar, the numerators,
// the SNIS weights and kv rounded as above), so the products are exact and
// only the summation order differs from the CUDA-core route.  Landmarks are
// padded with zero rows to CP, a multiple of 16 (49 -> 64), and the padded
// rows and columns are left out of every max, sum and mean.  The operands
// live in shared memory in bf16 (rows padded by 8), the logits in f32; kv is
// summed in accumulator fragments that stay in registers through pass 2.

// Whether the bf16 route takes (d, C): d a multiple of 16 and the kv tiles
// within the warps' accumulators (uses_mma() in ops/kernels/lara_fused.py).
__host__ __device__ inline bool uses_mma(int d, int C) {
  return d % 16 == 0 && (round16(C) / 16) * (d / 16) <= kWarps * kMaxAcc;
}

struct MmaLayout {
  size_t W, QB, KV, Q, K, V, F, P, stats, rows, total;
};

// The bf16 route's shared memory (smem_bytes(..., itemsize=2) in the
// wrapper): w, q_bar and the rounded kv [CP][d + 8] and the q, k, v tiles
// [kTile][d + 8] in bf16; F, f32, holds the two logit tiles ([CP][kTile + 4]
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

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (sizeof(T) == 2 && uses_mma(p.d, p.C)) {
    const MmaLayout L = make_mma_layout(p.d, p.C);
    cudaError_t err = cudaFuncSetAttribute(
        lara_fused_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return err;
    lara_fused_mma_kernel<<<dim3(p.nh, p.B), kThreads, L.total, stream>>>(p);
    return cudaGetLastError();
  }
  const Layout L = make_layout(p.d, p.C);
  auto kernel = lara_fused_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.nh, p.B), kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one block of the route that (d, C, is_bf16) takes.
int lara_fused_smem_bytes(int d, int C, int is_bf16) {
  return (int)(is_bf16 && uses_mma(d, C) ? make_mma_layout(d, C).total
                                         : make_layout(d, C).total);
}

const char* lara_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: out [B, N, nh*d] from qkv (float32 or bfloat16) and the
// f32 landmark operands.  Returns a cudaError_t (0 on success).
int lara_fused_launch(const void* qkv, const float* w, const float* qb, const float* bal,
                      const float* lprop, void* out, int B, int N, int nh, int d, int C,
                      int is_bf16, float scale, float dn, float alpha, void* stream) {
  if (B <= 0 || N <= 0 || nh <= 0 || d <= 0 || C <= 0) return cudaErrorInvalidValue;
  Params p = {};
  p.qkv = qkv; p.w = w; p.qb = qb; p.bal = bal; p.lprop = lprop; p.out = out;
  p.B = B; p.N = N; p.nh = nh; p.d = d; p.C = C;
  p.scale = scale; p.dn = dn; p.alpha = alpha;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // extern "C"
