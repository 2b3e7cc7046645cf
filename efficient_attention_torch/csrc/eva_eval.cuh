// Device code of the 2-D EVA eval kernels: K8 (eva_summaries.cu), K9
// (eva_packed_out.cu) and K10 (eva_mega.cu).  Two kernels, each in two forms:
//
//   eva_summaries_kernel  the chunk summaries (rf_k_bar, beta) of one chunk-row
//                         strip of one (image, head): from a strip of qkv
//                         staged in shared memory (K8), or from the strip's
//                         tokens x projected to q, k, v inside the block (K10,
//                         eva_summaries_from_x);
//   eva_out_kernel        the joint softmax of one window over every head, then
//                         the output projection of the window's rows (K9),
//                         with q, k, v read from qkv or projected from x inside
//                         the block (K10, eva_attention_from_x).
//
// Each .cu file instantiates the forms it launches and exports a plain C
// interface.  The products that take a weight (the qkv projection of K10 and
// the output projection of K9 and K10) run in project(): in bf16 on tensor
// cores (16x16x16 warp MMA, f32 accumulation) where every width is a multiple
// of 16, else on CUDA cores in f32.  The weight is read from device memory as
// it is needed, not staged: every block of a launch reads the same weight,
// which stays in L2 (221 KB for the cell's Wqkv in bf16), and shared memory is
// left to the tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "smem_tile.cuh"

namespace eva_eval {

using smem_tile::align128;
using smem_tile::bf16;
using smem_tile::from_f;
using smem_tile::round16;
using smem_tile::round_to;
using smem_tile::to_f;
using smem_tile::warp_max;
using smem_tile::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-6f;

// Row stride (floats) of a D-wide f32 row in shared memory: a multiple of 4
// that is 4 mod 8 (row_stride in ops/kernels/eva_packed.py).
__host__ __device__ constexpr int row_stride(int D) { return ((D / 4 + 1) | 1) * 4; }

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// ---- the products of the joint softmax (those of K1's forward, eva_packed.cu)

// out[i][j] = <A_i, B_j> over D for i < M, j < N; A and B rows of D floats at
// row_stride(D).  A thread's 7x4 tile is rows a + mt*r and columns b + nt*c.
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

// ---- the products that take a weight

// Where column n of a product reads its weight [K][ldb]: at column
// (n / block) * stride + offset + n % block, so one product can take one
// head's d-wide slice of each of q, k and v.
struct Cols {
  int block, stride, offset;
  __device__ __forceinline__ int operator()(int n) const {
    return (n / block) * stride + offset + n % block;
  }
};

// 4 consecutive weights as floats (16 bytes of f32, 8 of bf16, aligned).
__device__ __forceinline__ float4 load4(const float* w) {
  return __ldg(reinterpret_cast<const float4*>(w));
}
__device__ __forceinline__ float4 load4(const bf16* w) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(w));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// CUDA cores: f(i, n, sum_k A[i][k] W[k][cols(n)]) for i < M, n < N (N and
// cols.block multiples of 4).  A (T) lies in shared memory, rows lda apart; W
// (T, [K][ldb]) in device memory.  A thread's tile is 4 rows (a + mt*r) by 4
// consecutive columns, neighbouring threads on neighbouring columns; the sum
// over k runs in order, in f32.
template <typename T, typename F>
__device__ __forceinline__ void project_cc(const T* A, int lda, int M, int K, const T* W,
                                           int ldb, Cols cols, int N, F&& f) {
  constexpr int TR = 4;
  const int mt = (M + TR - 1) / TR, nq = N / 4;
  for (int t = threadIdx.x; t < mt * nq; t += kThreads) {
    const int a = t / nq, q = t % nq;
    const T* ar[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) ar[r] = A + min(a + mt * r, M - 1) * lda;
    const T* w = W + cols(4 * q);
    float4 acc[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 v = load4(w + (size_t)k * ldb);
#pragma unroll
      for (int r = 0; r < TR; ++r) fma4(acc[r], to_f(ar[r][k]), v);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int i = a + mt * r;
      if (i < M) {
        f(i, 4 * q, acc[r].x);
        f(i, 4 * q + 1, acc[r].y);
        f(i, 4 * q + 2, acc[r].z);
        f(i, 4 * q + 3, acc[r].w);
      }
    }
  }
}

// The warp's 16x16 f32 tile c, rows from row0 and columns from col0, through
// its [16][16] scratch s to f(i, n, value) for rows i < M.
template <typename F>
__device__ __forceinline__ void tile_out(const smem_tile::FragC& c, float* s, int row0,
                                         int col0, int M, F&& f) {
  namespace wm = nvcuda::wmma;
  const int lane = threadIdx.x & 31;
  wm::store_matrix_sync(s, c, 16, wm::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const int i = row0 + e / 16;
    if (i < M) f(i, col0 + e % 16, s[e]);
  }
  __syncwarp();
}

// Tensor cores, bf16 (MP, K, N, cols.block and lda multiples of 16, 16, 16,
// 16 and 8; A's rows [M, MP) hold anything finite, their outputs are
// dropped): each warp takes a 16-wide column strip of up to kMaxRowTiles row
// tiles of the output and runs the whole sum over k as 16x16x16 MMAs with f32
// accumulation, each fragment of W (read from device memory) feeding every
// row tile of A (shared memory); each tile passes through the warp's [16][16]
// f32 scratch to f(i, n, value).  The products of bf16 values are exact, so
// only the order of the f32 sums differs from the CUDA-core route.
constexpr int kMaxRowTiles = 8;

template <typename F>
__device__ __forceinline__ void project_mma(const bf16* A, int lda, int M, int MP, int K,
                                            const bf16* W, int ldb, Cols cols, int N,
                                            float* scratch, F&& f) {
  namespace wm = nvcuda::wmma;
  const int warp = threadIdx.x >> 5;
  const int mt = MP / 16, nt = N / 16;
  const int groups = (mt + kMaxRowTiles - 1) / kMaxRowTiles;
  float* s = scratch + warp * 256;
  for (int job = warp; job < nt * groups; job += kWarps) {
    const int tj = job % nt, t0 = (job / nt) * kMaxRowTiles;
    const bf16* wcol = W + cols(16 * tj);
    smem_tile::FragC c[kMaxRowTiles];
#pragma unroll
    for (int ti = 0; ti < kMaxRowTiles; ++ti) wm::fill_fragment(c[ti], 0.f);
    // the next k-step's weight fragment is loaded before this step's MMAs
    smem_tile::FragBr b, next;
    wm::load_matrix_sync(b, wcol, ldb);
    for (int k = 0; k < K; k += 16) {
      if (k + 16 < K) wm::load_matrix_sync(next, wcol + (size_t)(k + 16) * ldb, ldb);
#pragma unroll
      for (int ti = 0; ti < kMaxRowTiles; ++ti) {
        if (t0 + ti < mt) {
          smem_tile::FragA a;
          wm::load_matrix_sync(a, A + (size_t)16 * (t0 + ti) * lda + k, lda);
          wm::mma_sync(c[ti], a, b, c[ti]);
        }
      }
      b = next;
    }
#pragma unroll
    for (int ti = 0; ti < kMaxRowTiles; ++ti)
      if (t0 + ti < mt) tile_out(c[ti], s, 16 * (t0 + ti), 16 * tj, M, f);
  }
}

template <typename T, bool MMA, typename F>
__device__ __forceinline__ void project(const T* A, int lda, int M, int MP, int K,
                                        const T* W, int ldb, Cols cols, int N,
                                        float* scratch, F&& f) {
  if constexpr (MMA) {
    project_mma(reinterpret_cast<const bf16*>(A), lda, M, MP, K,
                reinterpret_cast<const bf16*>(W), ldb, cols, N, scratch, f);
  } else {
    project_cc(A, lda, M, K, W, ldb, cols, N, f);
  }
}

// dst[r][0, cols) = row row_of(r) of src (rows src_ld apart) for r < rows, 16
// bytes a load where the widths allow it; rows [rows, rows_pad) are zeroed.
template <typename T, typename RowOf>
__device__ __forceinline__ void stage_rows(const T* src, int src_ld, int cols, int rows,
                                           int rows_pad, T* dst, int ld, RowOf row_of) {
  constexpr int kPer = 16 / sizeof(T);
  if (cols % kPer == 0 && src_ld % kPer == 0 && ld % kPer == 0) {
    const int vecs = cols / kPer;
    for (int e = threadIdx.x; e < rows_pad * vecs; e += kThreads) {
      const int r = e / vecs, v = e % vecs;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows)
        u = __ldg(reinterpret_cast<const uint4*>(src + (size_t)row_of(r) * src_ld) + v);
      reinterpret_cast<uint4*>(dst + (size_t)r * ld)[v] = u;
    }
  } else {
    for (int e = threadIdx.x; e < rows_pad * cols; e += kThreads) {
      const int r = e / cols, c = e % cols;
      dst[(size_t)r * ld + c] = r < rows ? src[(size_t)row_of(r) * src_ld + c] : from_f<T>(0.f);
    }
  }
}

// LayerNorm over the D values a warp holds, DPL per lane (lane-strided).
template <int D, int DPL>
__device__ __forceinline__ void warp_layer_norm(float (&x)[DPL], const float* s,
                                                const float* b, int lane) {
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    if (lane + 32 * i < D) sum += x[i];
  const float mean = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    if (lane + 32 * i < D) sq += (x[i] - mean) * (x[i] - mean);
  const float inv = rsqrtf(warp_sum(sq) / D + kLnEps);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int o = lane + 32 * i;
    if (o < D) x[i] = (x[i] - mean) * inv * s[o] + b[o];
  }
}

// ---- the chunk summaries (K8; K10's eva_summaries_from_x)

struct SumParams {
  const void* qkv;     // K8: [B, N, 3*nh*D], T
  const void* x;       // K10: [B, N, XD], T
  const void* wqkv;    // K10: [XD, 3*nh*D], T ([in, out])
  const float* bqkv;   // K10: [3*nh*D]
  const float* wq;     // adaptive_mu_q Dense [D, D] (in, out)
  const float* bq;     // [D]
  const float* wk;     // adaptive_mu_k Dense
  const float* bk;
  const float* lnq_s;  // [D], null unless use_ln
  const float* lnq_b;
  const float* lnk_s;
  const float* lnk_b;
  void* rf;            // [B, C, nh*D], T
  void* beta;          // [B, C, nh*D], T
  int B, N, gw, j, nh, XD;
  int wc, C, R;        // chunks per grid row, chunks, tokens per strip (j * gw)
  int use_ln;
};

struct SumLayout {
  size_t tok, mean, x, scratch, total;
};

// Offsets (bytes) of the shared-memory regions; the same layout as
// smem_bytes() in ops/kernels/eva_summaries.py.  XD = 0 for K8.
__host__ __device__ inline SumLayout make_sum_layout(int R, int D, int esize, int XD) {
  SumLayout L = {};
  size_t o = 0;
  L.tok = o;  o += align128((size_t)R * 3 * D * esize);
  L.mean = o; o += align128((size_t)kWarps * 2 * D * 4);
  if (XD > 0) {
    L.x = o;       o += align128((size_t)round16(R) * (XD + 8) * esize);
    L.scratch = o; o += align128((size_t)kWarps * 256 * 4);
  }
  L.total = o;
  return L;
}

// One block a (chunk-row strip hr, head h, image b).  The strip's j*gw tokens
// are contiguous in qkv; its q, k, v rows of head h go to tok [R][3][D] in T.
// One warp a chunk: the means of q and k over the chunk's j*j members (f32),
// the adaptive Dense (+LN) into rf_q and rf_k, mu = (rf_q + rf_k)/2, and an
// online softmax of <mu, k_t>/sqrt(d) - |k_t|^2/(2 sqrt(d)) over the members
// (shifted by the running, so in the end the true, maximum) that weights
// their values into beta.  All arithmetic f32; rf_k_bar and beta are written
// in T.
template <int D, typename T, bool FROM_X, bool MMA>
__global__ void __launch_bounds__(kThreads) eva_summaries_kernel(const SumParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hr = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const SumLayout L = make_sum_layout(p.R, D, sizeof(T), FROM_X ? p.XD : 0);
  T* tok = reinterpret_cast<T*>(smem + L.tok);  // [R][3][D]: q, k, v of head h
  const int HD = p.nh * D;
  const int t0 = hr * p.R;  // the strip's first token
  auto strip_row = [&](int r) { return t0 + r; };
  if constexpr (FROM_X) {
    // q, k, v of head h = x Wqkv[:, its columns] + bqkv, rounded to T (JAX's
    // order: project, round, then take the means)
    T* xs = reinterpret_cast<T*>(smem + L.x);  // [round16(R)][XD + 8]
    const int ld = p.XD + 8;
    stage_rows(static_cast<const T*>(p.x) + (size_t)b * p.N * p.XD, p.XD, p.XD, p.R,
               round16(p.R), xs, ld, strip_row);
    __syncthreads();
    const Cols cols{D, HD, h * D};
    project<T, MMA>(xs, ld, p.R, round16(p.R), p.XD, static_cast<const T*>(p.wqkv),
                    3 * HD, cols, 3 * D, reinterpret_cast<float*>(smem + L.scratch),
                    [&](int i, int n, float v) {
                      tok[i * 3 * D + n] = from_f<T>(v + p.bqkv[cols(n)]);
                    });
  } else {
    const T* qkv = static_cast<const T*>(p.qkv) + (size_t)b * p.N * 3 * HD;
    constexpr int kPer = 16 / sizeof(T);
    if constexpr (D % kPer == 0) {
      constexpr int V = D / kPer;
      for (int e = threadIdx.x; e < p.R * 3 * V; e += kThreads) {
        const int v = e % V, part = (e / V) % 3, r = e / (3 * V);
        const T* src = qkv + (size_t)strip_row(r) * 3 * HD + part * HD + h * D;
        reinterpret_cast<uint4*>(tok)[e] = __ldg(reinterpret_cast<const uint4*>(src) + v);
      }
    } else {
      for (int e = threadIdx.x; e < p.R * 3 * D; e += kThreads) {
        const int dd = e % D, part = (e / D) % 3, r = e / (3 * D);
        tok[e] = qkv[(size_t)strip_row(r) * 3 * HD + part * HD + h * D + dd];
      }
    }
  }
  __syncthreads();

  constexpr int DPL = (D + 31) / 32;  // dims per lane
  const float dn = 1.f / sqrtf((float)D);
  const int jj = p.j * p.j;
  float* mean_q = reinterpret_cast<float*>(smem + L.mean) + warp * 2 * D;
  float* mean_k = mean_q + D;
  T* rf_out = static_cast<T*>(p.rf) + (size_t)b * p.C * HD + h * D;
  T* beta_out = static_cast<T*>(p.beta) + (size_t)b * p.C * HD + h * D;
  for (int cx = warp; cx < p.wc; cx += kWarps) {
    // member m of chunk cx is strip row (m / j) * gw + cx * j + m % j
    auto member = [&](int m) {
      return tok + ((size_t)(m / p.j) * p.gw + cx * p.j + m % p.j) * 3 * D;
    };
    float sq[DPL], sk[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) sq[i] = sk[i] = 0.f;
    for (int m = 0; m < jj; ++m) {
      const T* row = member(m);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        if (dd < D) {
          sq[i] += to_f(row[dd]);
          sk[i] += to_f(row[D + dd]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) {
        mean_q[dd] = sq[i] / jj;
        mean_k[dd] = sk[i] / jj;
      }
    }
    __syncwarp();
    float rq[DPL], rk[DPL], mu[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int o = lane + 32 * i;
      float aq = 0.f, ak = 0.f;
      if (o < D) {
        aq = p.bq[o];
        ak = p.bk[o];
        for (int in = 0; in < D; ++in) {
          aq = fmaf(mean_q[in], __ldg(p.wq + in * D + o), aq);
          ak = fmaf(mean_k[in], __ldg(p.wk + in * D + o), ak);
        }
      }
      rq[i] = aq;
      rk[i] = ak;
    }
    __syncwarp();  // mean_q/mean_k are rewritten by this warp's next chunk
    if (p.use_ln) {
      warp_layer_norm<D, DPL>(rq, p.lnq_s, p.lnq_b, lane);
      warp_layer_norm<D, DPL>(rk, p.lnk_s, p.lnk_b, lane);
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) mu[i] = 0.5f * (rq[i] + rk[i]);
    float mx = -INFINITY, den = 0.f, pv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) pv[i] = 0.f;
    for (int m = 0; m < jj; ++m) {
      const T* row = member(m);
      float dot = 0.f, nrm = 0.f, vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        vv[i] = 0.f;
        if (dd < D) {
          const float kv = to_f(row[D + dd]);
          dot = fmaf(mu[i], kv, dot);
          nrm = fmaf(kv, kv, nrm);
          vv[i] = to_f(row[2 * D + dd]);
        }
      }
      const float lp = dn * warp_sum(dot) - 0.5f * dn * warp_sum(nrm);
      const float mnew = fmaxf(mx, lp);
      const float corr = expf(mx - mnew), e = expf(lp - mnew);
      den = den * corr + e;
#pragma unroll
      for (int i = 0; i < DPL; ++i) pv[i] = fmaf(pv[i], corr, e * vv[i]);
      mx = mnew;
    }
    const size_t c = (size_t)hr * p.wc + cx;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) {
        rf_out[c * HD + dd] = from_f<T>(rk[i]);
        beta_out[c * HD + dd] = from_f<T>(pv[i] / den);
      }
    }
  }
}

// Fills p's geometry; false where the kernel cannot take it.
inline bool sum_geometry(SumParams& p, int B, int N, int gw, int j, int nh, int XD,
                         int use_ln) {
  if (B <= 0 || N <= 0 || gw <= 0 || j <= 0 || nh <= 0 || XD < 0 || N % gw) return false;
  const int gh = N / gw;
  if (gh % j || gw % j) return false;
  if (use_ln && (!p.lnq_s || !p.lnq_b || !p.lnk_s || !p.lnk_b)) return false;
  p.B = B; p.N = N; p.gw = gw; p.j = j; p.nh = nh; p.XD = XD;
  p.wc = gw / j;
  p.C = (gh / j) * p.wc;
  p.R = j * gw;
  p.use_ln = use_ln;
  return true;
}

template <int D, typename T, bool FROM_X, bool MMA>
cudaError_t launch_sum_inst(const SumParams& p, cudaStream_t stream) {
  const SumLayout L = make_sum_layout(p.R, D, sizeof(T), FROM_X ? p.XD : 0);
  auto kernel = eva_summaries_kernel<D, T, FROM_X, MMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.N / p.R, p.nh, p.B), kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

// The tensor-core route where the inputs are bf16 and every width of the
// projection is a multiple of 16.
template <int D, bool FROM_X>
cudaError_t launch_sum_d(const SumParams& p, int is_bf16, cudaStream_t stream) {
  if (!is_bf16) return launch_sum_inst<D, float, FROM_X, false>(p, stream);
  if constexpr (FROM_X && D % 16 == 0) {
    if (p.XD % 16 == 0) return launch_sum_inst<D, bf16, FROM_X, true>(p, stream);
  }
  return launch_sum_inst<D, bf16, FROM_X, false>(p, stream);
}

template <bool FROM_X>
cudaError_t launch_summaries(const SumParams& p, int d, int is_bf16, cudaStream_t stream) {
  switch (d) {
    case 12: return launch_sum_d<12, FROM_X>(p, is_bf16, stream);
    case 16: return launch_sum_d<16, FROM_X>(p, is_bf16, stream);
    case 32: return launch_sum_d<32, FROM_X>(p, is_bf16, stream);
    case 64: return launch_sum_d<64, FROM_X>(p, is_bf16, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the joint softmax and the output projection (K9; K10's
// eva_attention_from_x)

struct OutParams {
  const void* qkv;     // K9: [B, N, 3*nh*D], T
  const void* x;       // K10: [B, N, XD], T
  const void* wqkv;    // K10: [XD, 3*nh*D], T ([in, out])
  const float* bqkv;   // K10: [3*nh*D]
  const void* rf;      // [B, C, nh*D], T
  const void* beta;    // [B, C, nh*D], T
  const float* bias;   // [nh, S, S] or null
  const void* wo;      // [nh*D, nh*D], T ([in, out])
  const float* bo;     // [nh*D]
  void* out;           // [B, N, nh*D], T
  int B, N, gw, ws, nh, C, XD;
  int S;               // tokens per window
  int nww;             // windows per grid row
  float scale;
};

struct OutLayout {
  size_t keys, vals, q, P, bias, den, attn, x, total;
};

// Offsets (bytes) of the shared-memory regions of the CUDA-core route; the
// same layout as smem_bytes_out() in ops/kernels/eva_packed.py.  XD = 0 for
// K9.
__host__ __device__ inline OutLayout make_out_layout(int D, int S, int C, int nh, int esize,
                                                     int XD) {
  const size_t DP = row_stride(D), SCP = S + C + 1, HD = (size_t)nh * D;
  OutLayout L = {};
  size_t o = 0;
  L.keys = o;    o += align128((S + C) * DP * 4);
  L.vals = o;    o += align128((S + C) * DP * 4);
  L.q = o;       o += align128(S * DP * 4);
  L.P = o;       o += align128(S * SCP * 4);
  L.bias = o;    o += align128((size_t)S * S * 4);
  L.den = o;     o += align128((size_t)S * 4);
  L.attn = o;    o += align128((size_t)S * (HD + 8) * esize);
  if (XD > 0) {
    L.x = o;     o += align128((size_t)S * (XD + 8) * esize);
  }
  L.total = o;
  return L;
}

// One block a (window w, image b).  For each head in turn: the window's q, k,
// v rows (read from qkv, or projected from the staged x rows and rounded to T)
// and the head's chunk rows go to shared memory in f32, then K1's forward: the
// logits scale*<q, [k | rf]> (+ bias on the window's columns), the softmax
// numerators exp(l - max) rounded to T, their product with [v | beta] in f32
// over the f32 sum of the unrounded numerators, rounded to T into the
// window's output rows attn [S][H*D].  Once every head is in, attn Wo + bo
// (f32 sums) is written in T.
template <int D, typename T, bool FROM_X>
__global__ void __launch_bounds__(kThreads) eva_out_kernel(const OutParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DP = row_stride(D);
  const int S = p.S, C = p.C, SC = S + C, SCP = SC + 1;
  const int HD = p.nh * D, AP = HD + 8;
  const OutLayout L = make_out_layout(D, S, C, p.nh, sizeof(T), FROM_X ? p.XD : 0);
  float* keys = reinterpret_cast<float*>(smem + L.keys);      // [S+C][DP]: k | rf
  float* vals = reinterpret_cast<float*>(smem + L.vals);      // [S+C][DP]: v | beta
  float* q = reinterpret_cast<float*>(smem + L.q);            // [S][DP]
  float* P = reinterpret_cast<float*>(smem + L.P);            // [S][SCP]
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);    // [S][S]
  float* den_s = reinterpret_cast<float*>(smem + L.den);      // [S]
  T* attn = reinterpret_cast<T*>(smem + L.attn);              // [S][AP]
  const int w = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // grid token of local position l of the window
  auto token = [&](int l) {
    return ((w / p.nww) * p.ws + l / p.ws) * p.gw + (w % p.nww) * p.ws + l % p.ws;
  };
  if constexpr (FROM_X) {
    stage_rows(static_cast<const T*>(p.x) + (size_t)b * p.N * p.XD, p.XD, p.XD, S, S,
               reinterpret_cast<T*>(smem + L.x), p.XD + 8, token);
  }
  const T* rf = static_cast<const T*>(p.rf) + (size_t)b * C * HD;
  const T* bt = static_cast<const T*>(p.beta) + (size_t)b * C * HD;
  for (int h = 0; h < p.nh; ++h) {
    if constexpr (FROM_X) {
      __syncthreads();  // the staged x rows
      const Cols cols{D, HD, h * D};
      project_cc(reinterpret_cast<const T*>(smem + L.x), p.XD + 8, S, p.XD,
                 static_cast<const T*>(p.wqkv), 3 * HD, cols, 3 * D,
                 [&](int i, int n, float v) {
                        const int part = n / D, dd = n % D;
                        const float x = round_to<T>(v + p.bqkv[cols(n)]);
                        (part == 0 ? q : part == 1 ? keys : vals)[i * DP + dd] = x;
                      });
    } else {
      const T* qkv = static_cast<const T*>(p.qkv) + (size_t)b * p.N * 3 * HD + h * D;
      for (int e = threadIdx.x; e < S * 3 * D; e += kThreads) {
        const int dd = e % D, part = (e / D) % 3, l = e / (3 * D);
        const float x = to_f(qkv[(size_t)token(l) * 3 * HD + part * HD + dd]);
        (part == 0 ? q : part == 1 ? keys : vals)[l * DP + dd] = x;
      }
    }
    for (int e = threadIdx.x; e < C * D; e += kThreads) {
      const int c = e / D, dd = e % D;
      keys[(S + c) * DP + dd] = to_f(rf[(size_t)c * HD + h * D + dd]);
      vals[(S + c) * DP + dd] = to_f(bt[(size_t)c * HD + h * D + dd]);
    }
    const float* bh = p.bias != nullptr ? p.bias + (size_t)h * S * S : nullptr;
    for (int e = threadIdx.x; e < S * S; e += kThreads) bias_s[e] = bh != nullptr ? bh[e] : 0.f;
    __syncthreads();
    gemm_nt<D>(q, S, keys, SC, [&](int i, int j, float v) {
      P[i * SCP + j] = v * p.scale + (j < S ? bias_s[i * S + j] : 0.f);
    });
    __syncthreads();
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
    gemm_nn<D>(P, SCP, S, SC, vals, [&](int i, int c, float4 v) {
      const float den = den_s[i];
      T* row = attn + i * AP + h * D + 4 * c;
      row[0] = from_f<T>(v.x / den);
      row[1] = from_f<T>(v.y / den);
      row[2] = from_f<T>(v.z / den);
      row[3] = from_f<T>(v.w / den);
    });
    __syncthreads();  // q, k, v, P and the bias are rewritten by the next head
  }
  T* out = static_cast<T*>(p.out) + (size_t)b * p.N * HD;
  project_cc(attn, AP, S, HD, static_cast<const T*>(p.wo), HD, Cols{HD, 0, 0}, HD,
             [&](int i, int n, float v) {
               out[(size_t)token(i) * HD + n] = from_f<T>(v + p.bo[n]);
             });
}

// ---- the same on tensor cores: bf16 inputs, head dims (and XD) multiples
// of 16
//
// Per head, the window's q, k, v rows and the head's chunk rows are held in
// bf16 (rows padded with zeros: q to SP = round16(S), keys and values to KP =
// round16(S + C)); the logits q [k | rf]^T and the product of the rounded
// numerators with [v | beta] run as 16x16x16 warp MMAs with f32
// accumulation.  Their operands are bf16 values already (q, k, v, and the
// numerators rounded as on the CUDA-core route), so only the order of the f32
// sums differs from it.  The numerators overwrite the keys, which are dead
// once the logits are in; K10's x rows are staged per head inside the logits'
// region, which is dead while q, k, v are projected.  That keeps a block near
// 100 KB, two blocks an SM.

__host__ __device__ inline bool out_uses_mma(int D, int esize, int XD) {
  return esize == 2 && D % 16 == 0 && XD % 16 == 0;
}

struct OutMmaLayout {
  size_t q, keys, vals, F, xs, den, attn, total;
};

// The same layout as smem_bytes_out() in ops/kernels/eva_packed.py for this
// route: q [SP][D+8], keys then numerators (the larger of [KP][D+8] and
// [SP][KP+8]), values [KP][D+8] and the output rows [SP][H*D+8] in bf16; the
// logits [SP][KP+4] in f32, a region which also holds K10's x rows [SP][XD+8]
// (bf16) and, after them (at xs), the per-warp MMA scratch; the row sums.
__host__ __device__ inline OutMmaLayout make_out_mma_layout(int D, int S, int C, int nh,
                                                            int XD) {
  const size_t SP = round16(S), KP = round16(S + C), DB = D + 8, HD = (size_t)nh * D;
  const size_t xbytes = XD > 0 ? align128(SP * (XD + 8) * 2) : 0;
  const size_t logits = SP * (KP + 4) * 4, scratch = (size_t)kWarps * 256 * 4;
  OutMmaLayout L = {};
  size_t o = 0;
  L.q = o;    o += align128(SP * DB * 2);
  L.keys = o; o += align128((KP * DB > SP * (KP + 8) ? KP * DB : SP * (KP + 8)) * 2);
  L.vals = o; o += align128(KP * DB * 2);
  L.F = o;    o += align128(logits > xbytes + scratch ? logits : xbytes + scratch);
  L.xs = xbytes;
  L.den = o;  o += align128(SP * 4);
  L.attn = o; o += align128(SP * (HD + 8) * 2);
  L.total = o;
  return L;
}

__host__ __device__ inline size_t out_smem_bytes(int D, int S, int C, int nh, int esize,
                                                 int XD) {
  return out_uses_mma(D, esize, XD) ? make_out_mma_layout(D, S, C, nh, XD).total
                                    : make_out_layout(D, S, C, nh, esize, XD).total;
}

template <int D, bool FROM_X>
__global__ void __launch_bounds__(kThreads, 2) eva_out_mma_kernel(const OutParams p) {
  namespace wm = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DB = D + 8;
  const int S = p.S, C = p.C, SC = S + C, SP = round16(S), KP = round16(SC);
  const int FS = KP + 4, PS = KP + 8;
  const int HD = p.nh * D, AP = HD + 8;
  const OutMmaLayout L = make_out_mma_layout(D, S, C, p.nh, FROM_X ? p.XD : 0);
  bf16* q = reinterpret_cast<bf16*>(smem + L.q);        // [SP][DB]
  bf16* keys = reinterpret_cast<bf16*>(smem + L.keys);  // [KP][DB]: k | rf | 0
  bf16* P = keys;                                        // [SP][PS], once the logits are in
  bf16* vals = reinterpret_cast<bf16*>(smem + L.vals);  // [KP][DB]: v | beta | 0
  float* F = reinterpret_cast<float*>(smem + L.F);      // [SP][FS] logits
  bf16* xs = reinterpret_cast<bf16*>(smem + L.F);       // [SP][XD + 8], K10
  float* scratch = reinterpret_cast<float*>(smem + L.F + L.xs);  // [warps][16][16]
  float* den_s = reinterpret_cast<float*>(smem + L.den);  // [SP]
  bf16* attn = reinterpret_cast<bf16*>(smem + L.attn);  // [SP][AP]
  const int w = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto token = [&](int l) {
    return ((w / p.nww) * p.ws + l / p.ws) * p.gw + (w % p.nww) * p.ws + l % p.ws;
  };
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < SP * DB; e += kThreads) q[e] = zero;
  for (int e = threadIdx.x; e < (SP - S) * AP; e += kThreads) attn[S * AP + e] = zero;
  const bf16* rf = static_cast<const bf16*>(p.rf) + (size_t)b * C * HD;
  const bf16* bt = static_cast<const bf16*>(p.beta) + (size_t)b * C * HD;
  const float* bias = p.bias;
  for (int h = 0; h < p.nh; ++h) {
    __syncthreads();  // the zeroed q rows; the previous head's P and attn work
    // rows < S of q, k, v of head h
    if constexpr (FROM_X) {
      const int ld = p.XD + 8;
      stage_rows(static_cast<const bf16*>(p.x) + (size_t)b * p.N * p.XD, p.XD, p.XD, S, SP,
                 xs, ld, token);
      __syncthreads();
      const Cols cols{D, HD, h * D};
      project_mma(xs, ld, S, SP, p.XD, static_cast<const bf16*>(p.wqkv), 3 * HD, cols,
                  3 * D, scratch, [&](int i, int n, float v) {
                    const int part = n / D, dd = n % D;
                    (part == 0 ? q : part == 1 ? keys : vals)[i * DB + dd] =
                        __float2bfloat16(v + p.bqkv[cols(n)]);
                  });
    } else {
      constexpr int V8 = D / 8;
      const bf16* qkv = static_cast<const bf16*>(p.qkv) + (size_t)b * p.N * 3 * HD + h * D;
      for (int e = threadIdx.x; e < S * 3 * V8; e += kThreads) {
        const int v = e % V8, part = (e / V8) % 3, l = e / (3 * V8);
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            qkv + (size_t)token(l) * 3 * HD + part * HD) + v);
        *reinterpret_cast<uint4*>((part == 0 ? q : part == 1 ? keys : vals) + l * DB + 8 * v) = u;
      }
    }
    // rows [S, KP) of the keys and values: the head's chunk rows, then zeros
    for (int e = threadIdx.x; e < (KP - S) * (D / 8); e += kThreads) {
      const int c = e / (D / 8), v = e % (D / 8);
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (c < C) {
        kr = __ldg(reinterpret_cast<const uint4*>(rf + (size_t)c * HD + h * D) + v);
        vr = __ldg(reinterpret_cast<const uint4*>(bt + (size_t)c * HD + h * D) + v);
      }
      *reinterpret_cast<uint4*>(keys + (S + c) * DB + 8 * v) = kr;
      *reinterpret_cast<uint4*>(vals + (S + c) * DB + 8 * v) = vr;
    }
    __syncthreads();
    smem_tile::mma_nt2(q, keys, F, nullptr, nullptr, nullptr, DB, SP, KP, D, FS);
    __syncthreads();
    // softmax numerators exp(l - max), rounded to bf16 into P (zero past the
    // S + C columns and on the padded rows); the f32 sums of the unrounded.
    // Eight lanes a row, four rows a warp at once (SP, a multiple of 16, holds
    // whole groups of four rows).
    const float* bh = bias != nullptr ? bias + (size_t)h * S * S : nullptr;
    const int sub = lane >> 3, sl = lane & 7;
    for (int i0 = 4 * warp; i0 < SP; i0 += 4 * kWarps) {
      const int i = i0 + sub;
      const bool valid = i < S;
      bf16* prow = P + i * PS;
      float* row = F + i * FS;
      float mx = -INFINITY;
      if (valid) {
        for (int j = sl; j < SC; j += 8) {
          const float l =
              row[j] * p.scale + (j < S && bh != nullptr ? __ldg(bh + i * S + j) : 0.f);
          row[j] = l;
          mx = fmaxf(mx, l);
        }
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float den = 0.f;
      for (int j = sl; j < KP; j += 8) {
        float e = 0.f;
        if (valid && j < SC) {
          e = expf(row[j] - mx);
          den += e;
        }
        prow[j] = __float2bfloat16(e);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
      if (valid && sl == 0) den_s[i] = den;
    }
    __syncthreads();
    // out = P [v | beta] / den, rounded to bf16 into the window's output rows
    for (int f = warp; f < (SP / 16) * (D / 16); f += kWarps) {
      const int ti = f / (D / 16), tj = f % (D / 16);
      smem_tile::FragA a;
      smem_tile::FragBr bv;
      smem_tile::FragC c;
      wm::fill_fragment(c, 0.f);
      for (int k = 0; k < KP; k += 16) {
        wm::load_matrix_sync(a, P + 16 * ti * PS + k, PS);
        wm::load_matrix_sync(bv, vals + k * DB + 16 * tj, DB);
        wm::mma_sync(c, a, bv, c);
      }
      tile_out(c, scratch + warp * 256, 16 * ti, 16 * tj, S, [&](int i, int n, float v) {
        attn[i * AP + h * D + n] = __float2bfloat16(v / den_s[i]);
      });
    }
  }
  __syncthreads();
  bf16* out = static_cast<bf16*>(p.out) + (size_t)b * p.N * HD;
  project_mma(attn, AP, S, SP, HD, static_cast<const bf16*>(p.wo), HD, Cols{HD, 0, 0}, HD,
              scratch, [&](int i, int n, float v) {
                out[(size_t)token(i) * HD + n] = __float2bfloat16(v + p.bo[n]);
              });
}

// Fills p's geometry; false where the kernel cannot take it.
inline bool out_geometry(OutParams& p, int B, int N, int gw, int ws, int nh, int C, int XD,
                         float scale) {
  if (B <= 0 || N <= 0 || gw <= 0 || ws <= 0 || nh <= 0 || C <= 0 || XD < 0 || N % gw)
    return false;
  const int gh = N / gw;
  if (gh % ws || gw % ws) return false;
  p.B = B; p.N = N; p.gw = gw; p.ws = ws; p.nh = nh; p.C = C; p.XD = XD;
  p.S = ws * ws;
  p.nww = gw / ws;
  p.scale = scale;
  return true;
}

template <typename Kernel>
cudaError_t launch_out_kernel(Kernel kernel, size_t smem, const OutParams& p,
                              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_win = (p.N / p.gw / p.ws) * p.nww;
  kernel<<<dim3(n_win, p.B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The tensor-core route where the inputs are bf16 and the head dim (and XD)
// are multiples of 16 (out_uses_mma), else the CUDA-core route.
template <int D, bool FROM_X>
cudaError_t launch_out_d(const OutParams& p, int is_bf16, cudaStream_t stream) {
  const int XD = FROM_X ? p.XD : 0;
  const size_t smem = out_smem_bytes(D, p.S, p.C, p.nh, is_bf16 ? 2 : 4, XD);
  if (!is_bf16) return launch_out_kernel(eva_out_kernel<D, float, FROM_X>, smem, p, stream);
  if constexpr (D % 16 == 0) {
    if (out_uses_mma(D, 2, XD))
      return launch_out_kernel(eva_out_mma_kernel<D, FROM_X>, smem, p, stream);
  }
  return launch_out_kernel(eva_out_kernel<D, bf16, FROM_X>, smem, p, stream);
}

template <bool FROM_X>
cudaError_t launch_out(const OutParams& p, int d, int is_bf16, cudaStream_t stream) {
  switch (d) {
    case 12: return launch_out_d<12, FROM_X>(p, is_bf16, stream);
    case 16: return launch_out_d<16, FROM_X>(p, is_bf16, stream);
    case 32: return launch_out_d<32, FROM_X>(p, is_bf16, stream);
    case 64: return launch_out_d<64, FROM_X>(p, is_bf16, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace eva_eval
