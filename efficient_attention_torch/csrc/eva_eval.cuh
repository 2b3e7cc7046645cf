// Device code of the 2-D EVA eval kernels: K8 (eva_summaries.cu), K9
// (eva_packed_out.cu) and K10 (eva_mega.cu).  Two kernels, each in two forms:
//
//   eva_summaries_kernel  the chunk summaries (rf_k_bar, beta) of one chunk-row
//                         strip of one (image, head): from a strip of qkv
//                         staged in shared memory (K8), or from the strip's
//                         tokens x projected to q, k, v inside the block (K10,
//                         eva_summaries_from_x); in bf16 where the wrapper's
//                         mma_plan takes the launch, eva_summaries_mma_kernel
//                         instead: persistent blocks that walk the strips
//                         with a cp.async ring, K10's projection on mma.sync
//                         from the head's Wqkv columns held in shared memory;
//   eva_out_kernel        the joint softmax of one window over every head, then
//                         the output projection of the window's rows (K9),
//                         with q, k, v read from qkv or projected from x inside
//                         the block (K10, eva_attention_from_x).
//
// Each .cu file instantiates the forms it launches and exports a plain C
// interface.  The products that take a weight (the qkv projection of K10 and
// the output projection of K9 and K10) run on tensor cores in bf16 where
// every width is a multiple of 16, else on CUDA cores in f32 (project_cc,
// the weight read from device memory as it is needed).  On tensor cores,
// K10's summaries take sum_project() in the persistent kernel (mma.sync
// m16n8k16, the weight resident in shared memory) or, where mma_plan leaves
// the launch to the first kernel, project() (16x16x16 warp MMA, the weight
// read from L2 one fragment at a time), and the joint softmax takes
// eva_out_mma_kernel's products (mma.sync m16n8k16, Wo whole in shared
// memory where it fits, else the weight streamed through a ring of two
// slabs of 96 rows, or 16, that every warp of the block reads).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "eva_strip.cuh"
#include "mma_frag.cuh"
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
  int stages;          // the persistent route's ring of item buffers
};

struct SumLayout {
  size_t tok, mean, x, scratch, total;
};

// Built with -DEVA_SUM_PHASES (scripts/torch_eva_summaries_check.py), the
// summaries kernels record, from thread 0 of each block (and the two-team
// kernel from its first body thread too), the clock64()
// cycles of their phases into g_sum_phases[2..7][block] (summed over a
// persistent block's items) and the global timer at the block's start and
// end into g_sum_phases[0] and [1]; the .cu files' *_sum_phases_copy read
// them back.  Without it the marks compile to nothing.
enum { kSumStage, kSumProj, kSumMeans, kSumDense, kSumLogits, kSumWrites, kSumPhaseCount };
#ifdef EVA_SUM_PHASES
constexpr int kSumPhaseBlocks = 16384;
__device__ unsigned long long g_sum_phases[2 + kSumPhaseCount][kSumPhaseBlocks];
struct SumPhases {
  long long last = 0, sum[kSumPhaseCount] = {};
  unsigned long long t0 = 0;
  __device__ static unsigned long long timer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ void start() {
    t0 = timer();
    last = clock64();
  }
  __device__ void mark(int phase, bool barrier = false) {
    if (barrier) __syncthreads();
    const long long t = clock64();
    sum[phase] += t - last;
    last = t;
  }
  // thread 0 writes every phase; then thread `second` (> 0: the two-team
  // kernel's first body thread) the phases it marked
  __device__ void end(int second = 0) {
    __syncthreads();
    const unsigned blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    if (threadIdx.x == 0 && blk < kSumPhaseBlocks) {
      g_sum_phases[0][blk] = t0;
      g_sum_phases[1][blk] = timer();
      for (int k = 0; k < kSumPhaseCount; ++k) g_sum_phases[2 + k][blk] = sum[k];
    }
    __syncthreads();
    if (second > 0 && threadIdx.x == second && blk < kSumPhaseBlocks)
      for (int k = 0; k < kSumPhaseCount; ++k)
        if (sum[k] != 0) g_sum_phases[2 + k][blk] = sum[k];
  }
};
#else
struct SumPhases {
  __device__ void start() {}
  __device__ void mark(int, bool = false) {}
  __device__ void end(int = 0) {}
};
#endif

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
  SumPhases phases;
  phases.start();
  if constexpr (FROM_X) {
    // q, k, v of head h = x Wqkv[:, its columns] + bqkv, rounded to T (JAX's
    // order: project, round, then take the means)
    T* xs = reinterpret_cast<T*>(smem + L.x);  // [round16(R)][XD + 8]
    const int ld = p.XD + 8;
    stage_rows(static_cast<const T*>(p.x) + (size_t)b * p.N * p.XD, p.XD, p.XD, p.R,
               round16(p.R), xs, ld, strip_row);
    __syncthreads();
    phases.mark(kSumStage);
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
  phases.mark(FROM_X ? kSumProj : kSumStage);

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
    phases.mark(kSumMeans);
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
    phases.mark(kSumDense);
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
    phases.mark(kSumLogits);
    const size_t c = (size_t)hr * p.wc + cx;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) {
        rf_out[c * HD + dd] = from_f<T>(rk[i]);
        beta_out[c * HD + dd] = from_f<T>(pv[i] / den);
      }
    }
    phases.mark(kSumWrites);
  }
  phases.end();
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

// The launch's route and layout, as the wrapper's mma_plan() picks them:
// warps 0 the first kernel (eva_summaries_kernel), else the persistent
// tensor-core kernel with `warps` warps a block (8 or 16), a ring of
// `stages` item buffers, `bps` blocks an SM, and teams 2 for K10's two-team
// kernel (eva_summaries_ws_kernel: 16 warps, one stage, one block an SM).
struct SumConfig {
  int warps, stages, bps, teams;
};

template <bool FROM_X>
cudaError_t launch_sum_mma(SumParams p, int d, const SumConfig& cfg, cudaStream_t stream);

template <bool FROM_X>
cudaError_t launch_summaries(const SumParams& p, int d, int is_bf16, const SumConfig& cfg,
                             cudaStream_t stream) {
  if (cfg.warps != 0) {
    if (!is_bf16) return cudaErrorInvalidValue;
    return launch_sum_mma<FROM_X>(p, d, cfg, stream);
  }
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
  // the tensor-core route (launch_out_mma): its layout's heads a group, Wo
  // whole and slab rows (OutMmaLayout; its split is the kernel's kSplit),
  // and windows a block
  int hg, wo_whole, slab, wpb;
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
// K1's forward strips (eva_strip.cuh) with both projections on mma.sync
// m16n8k16.  A block of 12 warps takes wpb windows of one image in turn,
// every head of each, hg heads at a time (a head group):
//  * staging (16-byte cp.async): the window's q, k and v rows (K9: read
//    from qkv; K10: projected from its x rows [S][XD + 8], staged once a
//    window), the chunk rows rf and beta [hg][C][D + 8] and the bias
//    [hg][S][S] (f32, times log2 e) of a head group, the weights and the
//    bias vectors.  Where every head fits (hg = H) the chunk rows and the
//    bias are staged once a block.  Fragment loads past the last real row
//    read the last real row; nothing is zero-filled;
//  * where the attention rows go (the layout's split, the kernel's
//    kSplit): either into the same head's q columns of the strip's rows,
//    which no other warp reads, with every head's q, k and v rows
//    [S][3*H*D + 8] staged at once; or into a buffer of their own
//    [S][H*D + 8], with the window's q, k and v rows staged a head group at
//    a time [S][3*hg*D + 8] (K10: projected a group at a time), so that
//    wide models fit;
//  * attention: a warp a (head, 16-row strip) job, K1's one-pass or
//    two-pass strip body with the logits in registers (no logit matrix in
//    shared memory, no block-wide step between heads); o / l rounded to
//    bf16;
//  * the products that take a weight: A from shared memory through
//    ldmatrix, the weight [K][N] through ldmatrix.trans, f32 sums in
//    registers, a warp a 32 x 32 tile of each pass of 64 rows and
//    kProjCols columns; the epilogue takes the sums straight from the
//    fragments: K10's qkv = x Wqkv + bqkv rounded to bf16 into the window's
//    rows, the output attn Wo + bo rounded to bf16 into out[b, token(i)],
//    two values a store.  Wo lies whole in shared memory where it fits
//    (wo_whole: K9 loads it once a block, K10 once a window over the Wqkv
//    ring, while the strips run) and its product takes no barrier
//    (smem_product); Wqkv, and Wo where it does not fit, stream through a
//    ring of two slabs of kSlabRows rows (kSmallSlabRows where the larger
//    ring does not fit) that every warp reads, one barrier a slab
//    (ring_product).
// The roundings are the TPU kernels': qkv rounded (K10), the unnormalised
// numerators rounded to bf16 as the value product's operand over the f32
// sum of the unrounded ones, out / denom rounded, the projection summed in
// f32 plus bo, then rounded.

__host__ __device__ inline bool out_uses_mma(int D, int esize, int XD) {
  return esize == 2 && D % 16 == 0 && XD % 16 == 0;
}

constexpr int kMmaThreads = 384;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMaxWpb = 8;         // windows a block takes in turn
constexpr int kSlabRows = 96;      // weight rows a slab holds (a multiple of 16)
constexpr int kSmallSlabRows = 16;  // the same where a ring of kSlabRows does not fit
constexpr int kProjRowTiles = 4;   // 16-row tiles a product pass holds
// a warp's tile of a pass: kWarpRowTiles x kWarpColTiles tiles of 16 x 16,
// the warps in kColGroups columns of tiles
constexpr int kWarpRowTiles = 2, kWarpColTiles = 2;
constexpr int kColGroups = kMmaWarps * kWarpRowTiles / kProjRowTiles;
constexpr int kProjCols = kColGroups * kWarpColTiles * 16;  // columns a pass holds
constexpr size_t kSmemLimit = 232448;  // a block's shared memory on Hopper

struct OutMmaLayout {
  size_t win, x, attn, kc, vc, bias, wgt, vec, tok, total;
  int hg;            // heads a group
  int wo_whole;      // Wo [H*D][H*D + 8] whole in the weight region
  int split;         // attention rows in their own buffer, window rows a group
  int slab;          // rows of a ring slab
};

// The same layout as out_mma_layout() in ops/kernels/eva_packed.py: the
// window's q, k, v rows ([S][3*H*D + 8], or with split [S][3*hg*D + 8]),
// K10's x rows [S][XD + 8], with split the attention rows [S][H*D + 8], the
// chunk rows rf and beta [hg][C][D + 8] (all bf16), the bias [hg][S][S]
// (f32), the weight region (bf16: the ring [2][slab][kProjCols + 8], or Wo
// whole, or the larger of the two), the bias vectors (f32: K10's bqkv
// [3*H*D], then bo [H*D]) and the token table [kMaxWpb][S] (int32), each
// region 128-byte aligned.
__host__ __device__ inline OutMmaLayout out_mma_layout(int D, int S, int C, int nh, int XD,
                                                       int hg, int wo_whole, int split,
                                                       int slab) {
  const size_t HD = (size_t)nh * D, DB = D + 8;
  // a ring where a product streams: K10's qkv projection, K9's without Wo
  // whole
  const bool streams = XD > 0 || !wo_whole;
  const size_t ring = streams ? (size_t)2 * slab * (kProjCols + 8) * 2 : 0;
  const size_t whole = wo_whole ? HD * (HD + 8) * 2 : 0;
  OutMmaLayout L = {};
  L.hg = hg;
  L.wo_whole = wo_whole;
  L.split = split;
  L.slab = slab;
  size_t o = 0;
  L.win = o;  o += align128((size_t)S * (3 * (split ? (size_t)hg * D : HD) + 8) * 2);
  L.x = o;    o += XD > 0 ? align128((size_t)S * (XD + 8) * 2) : 0;
  L.attn = o; o += split ? align128((size_t)S * (HD + 8) * 2) : 0;
  L.kc = o;   o += align128((size_t)hg * C * DB * 2);
  L.vc = o;   o += align128((size_t)hg * C * DB * 2);
  L.bias = o; o += align128((size_t)hg * S * S * 4);
  L.wgt = o;  o += align128(ring > whole ? ring : whole);
  L.vec = o;  o += align128((XD > 0 ? 4 : 1) * HD * 4);
  L.tok = o;  o += align128((size_t)kMaxWpb * S * 4);
  L.total = o;
  return L;
}

// The layout a launch takes, the first that fits of: the attention rows
// over the q columns, then in their own buffer (split), then that with the
// small ring; in each, every head in one group where it fits, else the most
// heads that fit, and for those Wo whole in shared memory where it fits,
// else streamed.  false (L the last layout tried) where none fits.
__host__ __device__ inline bool out_mma_plan(int D, int S, int C, int nh, int XD,
                                             OutMmaLayout& L) {
  const int modes[3][2] = {{0, kSlabRows}, {1, kSlabRows}, {1, kSmallSlabRows}};
  for (const auto& mode : modes)
    for (int hg = nh; hg >= 1; --hg)
      for (int wo_whole = 1; wo_whole >= 0; --wo_whole) {
        L = out_mma_layout(D, S, C, nh, XD, hg, wo_whole, mode[0], mode[1]);
        if (L.total <= kSmemLimit) return true;
      }
  return false;
}

__host__ __device__ inline size_t out_smem_bytes(int D, int S, int C, int nh, int esize,
                                                 int XD) {
  if (!out_uses_mma(D, esize, XD)) return make_out_layout(D, S, C, nh, esize, XD).total;
  OutMmaLayout L;
  out_mma_plan(D, S, C, nh, XD, L);
  return L.total;
}

// Built with -DEVA_OUT_PHASES (scripts/torch_eva_out_check.py), the
// tensor-core kernel sums, in thread 0 of each block, the clock64() cycles
// of its phases over the block's windows (with a barrier after the strips,
// so that each phase ends when every warp is done) into g_out_phases[2..5]
// [block] (staging: a head group's chunk rows and the waits for its window
// rows; the qkv projection; the strips; the output projection) and the global
// timer at the block's start and end into g_out_phases[0] and [1]; the
// .cu files' *_phases_copy read them back.  Without it the marks compile to
// nothing.
#ifdef EVA_OUT_PHASES
constexpr int kPhaseBlocks = 16384;
__device__ unsigned long long g_out_phases[6][kPhaseBlocks];
struct OutPhases {
  long long last = 0, sum[4] = {0, 0, 0, 0};
  unsigned long long t0 = 0;
  __device__ static unsigned long long timer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ void start() {
    t0 = timer();
    last = clock64();
  }
  __device__ void mark(int phase, bool barrier = false) {
    if (barrier) __syncthreads();
    const long long t = clock64();
    sum[phase] += t - last;
    last = t;
  }
  __device__ void end() {
    const unsigned blk = blockIdx.x + gridDim.x * blockIdx.y;
    if (threadIdx.x != 0 || blk >= kPhaseBlocks) return;
    g_out_phases[0][blk] = t0;
    g_out_phases[1][blk] = timer();
    for (int k = 0; k < 4; ++k) g_out_phases[2 + k][blk] = sum[k];
  }
};
#else
struct OutPhases {
  __device__ void start() {}
  __device__ void mark(int, bool = false) {}
  __device__ void end() {}
};
#endif
enum { kPhaseStage, kPhaseProj, kPhaseStrips, kPhaseOut };

// Grid token of local position l of window w.
__device__ __forceinline__ int out_token(const OutParams& p, int w, int l) {
  return ((w / p.nww) * p.ws + l / p.ws) * p.gw + (w % p.nww) * p.ws + l % p.ws;
}

// ---- the products that take a weight: y = A W for the rows i < S of A
// [S][K] (bf16, shared memory, rows lda apart; row tiles past S read row
// S - 1) and W [K][N] (bf16; K and N multiples of 16), to epi(i, n,
// y[i][n], y[i][n + 1]) for even n, in f32.  A pass holds up to
// kProjRowTiles row tiles and kProjCols columns (NT column tiles of 16), a
// warp its kWarpRowTiles x kWarpColTiles tiles of them.

using ProjAcc = float[kWarpRowTiles][kWarpColTiles][2][4];

// The warp's first row tile (from the pass's r0) and first column tile.
__device__ __forceinline__ int proj_row_tile(int r0) {
  return r0 + (threadIdx.x >> 5) / kColGroups * kWarpRowTiles;
}
__device__ __forceinline__ int proj_col_tile() {
  return (threadIdx.x >> 5) % kColGroups * kWarpColTiles;
}

// acc += A[the warp's rows][k, k + 16) W[k, k + 16)[the warp's columns],
// wk pointing at W's row k, the pass's first column, rows ldr apart in
// shared memory.
__device__ __forceinline__ void proj_kstep(ProjAcc& acc, const bf16* A, int lda, int S, int r0,
                                           int MT, int NT, int k, const bf16* wk, int ldr) {
  using namespace mma_frag;
  const int lane = threadIdx.x & 31, rt = proj_row_tile(r0), ct = proj_col_tile();
  uint32_t a[kWarpRowTiles][4], bw[kWarpColTiles][4];
#pragma unroll
  for (int t = 0; t < kWarpRowTiles; ++t)
    if (rt + t < MT)
      ldsm_x4(a[t], A + min(16 * (rt + t) + row_r(lane), S - 1) * lda + k + col_r(lane));
#pragma unroll
  for (int u = 0; u < kWarpColTiles; ++u)
    if (ct + u < NT)
      ldsm_x4_trans(bw[u], wk + row_r(lane) * ldr + 16 * (ct + u) + col_r(lane));
#pragma unroll
  for (int t = 0; t < kWarpRowTiles; ++t)
#pragma unroll
    for (int u = 0; u < kWarpColTiles; ++u)
      if (rt + t < MT && ct + u < NT) {
        mma_bf16(acc[t][u][0], a[t], bw[u][0], bw[u][1]);
        mma_bf16(acc[t][u][1], a[t], bw[u][2], bw[u][3]);
      }
}

__device__ __forceinline__ void proj_zero(ProjAcc& acc) {
#pragma unroll
  for (int t = 0; t < kWarpRowTiles; ++t)
#pragma unroll
    for (int u = 0; u < kWarpColTiles; ++u)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][u][n][e] = 0.f;
}

template <typename Epi>
__device__ __forceinline__ void proj_store(const ProjAcc& acc, int S, int r0, int MT, int NT,
                                           int c0, Epi&& epi) {
  const int lane = threadIdx.x & 31, rt = proj_row_tile(r0), ct = proj_col_tile();
#pragma unroll
  for (int t = 0; t < kWarpRowTiles; ++t)
#pragma unroll
    for (int u = 0; u < kWarpColTiles; ++u) {
      if (rt + t >= MT || ct + u >= NT) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 16 * (rt + t) + (lane >> 2) + 8 * r;
        if (i >= S) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          epi(i, c0 + 16 * (ct + u) + 8 * n + 2 * (lane & 3), acc[t][u][n][2 * r],
              acc[t][u][n][2 * r + 1]);
      }
    }
}

// W [K][N] (device memory, rows N apart) whole into shared memory at ws,
// rows N + 8 apart, 16 bytes a copy, in the caller's commit group.
__device__ __forceinline__ void load_weight(const bf16* W, int K, int N, bf16* ws) {
  const int V8 = N / 8;
  for (int e = threadIdx.x; e < K * V8; e += kMmaThreads) {
    const int r = e / V8, v = e % V8;
    mma_frag::cp_async16(ws + r * (N + 8) + 8 * v, W + (size_t)r * N + 8 * v);
  }
}

// The product with W whole in shared memory (ws, rows N + 8 apart): no
// barrier, so A and W must be visible to every warp before the call.
template <typename Epi>
__device__ __forceinline__ void smem_product(const bf16* A, int lda, int S, int K,
                                             const bf16* ws, int N, Epi&& epi) {
  const int MT = (S + 15) / 16;
  for (int r0 = 0; r0 < MT; r0 += kProjRowTiles)
    for (int c0 = 0; c0 < N; c0 += kProjCols) {
      const int NT = min(kProjCols, N - c0) / 16;
      ProjAcc acc;
      proj_zero(acc);
      for (int k = 0; k < K; k += 16)
        proj_kstep(acc, A, lda, S, r0, MT, NT, k, ws + k * (N + 8) + c0, N + 8);
      proj_store(acc, S, r0, MT, NT, c0, epi);
    }
}

// The product with W [K][ldw] in device memory (its columns col(n) for n <
// N), streamed through the ring's two buffers in slabs of `slab` rows of
// one pass's columns, the passes' slabs one stream, each loading while the
// one before is in use.  A is read only after a barrier, so the caller's
// writes to it need none of their own; it ends with one, after which the
// ring may be refilled.
template <typename Col, typename Epi>
__device__ __forceinline__ void ring_product(const bf16* A, int lda, int S, int K,
                                             const bf16* W, int ldw, int N, Col&& col,
                                             int slab, bf16* ring, Epi&& epi) {
  using namespace mma_frag;
  const int KS = (K + slab - 1) / slab, MT = (S + 15) / 16;
  const int NP = (N + kProjCols - 1) / kProjCols;  // column passes
  const int buf = slab * (kProjCols + 8);           // a ring buffer's elements
  for (int r0 = 0; r0 < MT; r0 += kProjRowTiles) {
    // slab t of the stream (pass t / KS, its rows slab (t % KS)..) into
    // its ring buffer, one commit group a slab (empty past the last)
    auto issue = [&](int t) {
      if (t < NP * KS) {
        const int c0 = (t / KS) * kProjCols, s = t % KS;
        const int nw = min(kProjCols, N - c0), V8 = nw / 8;
        const int rows = min(slab, K - slab * s);
        bf16* dst = ring + (t & 1) * buf;
        for (int e = threadIdx.x; e < rows * V8; e += kMmaThreads) {
          const int r = e / V8, v = e % V8;
          cp_async16(dst + r * (nw + 8) + 8 * v,
                     W + (size_t)(slab * s + r) * ldw + col(c0 + 8 * v));
        }
      }
      cp_async_commit();
    };
    issue(0);
    ProjAcc acc;
    for (int t = 0; t < NP * KS; ++t) {
      const int c0 = (t / KS) * kProjCols, s = t % KS;
      const int nw = min(kProjCols, N - c0);
      if (s == 0) proj_zero(acc);
      // slab t has landed, and every warp is done with the buffer that
      // slab t + 1 now loads into
      cp_async_wait_all();
      __syncthreads();
      issue(t + 1);
      const bf16* sl = ring + (t & 1) * buf;
#pragma unroll
      for (int kk = 0; kk < kSlabRows; kk += 16) {
        if (kk >= slab || slab * s + kk >= K) break;
        proj_kstep(acc, A, lda, S, r0, MT, nw / 16, slab * s + kk, sl + kk * (nw + 8), nw + 8);
      }
      if (s == KS - 1) proj_store(acc, S, r0, MT, nw / 16, c0, epi);
    }
    __syncthreads();  // the ring is refilled next
  }
}

// One (head, 16-row strip st) job: K1's forward strip (eva_packed.cu) over
// the head's q, k, v columns of the window's rows (rows ldw apart), its
// chunk rows kc, vc and its bias; o / l rounded to bf16 into the strip's
// rows of ao (rows ldo apart), which may be its own q rows.
template <int D, bool kOnePass>
__device__ __forceinline__ void out_strip(const OutParams& p, int st, const bf16* qw,
                                          const bf16* kw, const bf16* vw, int ldw,
                                          const bf16* kc, const bf16* vc, const float* bias_s,
                                          bf16* ao, int ldo) {
  using namespace mma_frag;
  using eva_strip::fwd_logits_tile;
  using eva_strip::fwd_pv_tile;
  using eva_strip::kResidentTiles;
  constexpr int KD = D / 16;
  const int lane = threadIdx.x & 31, S = p.S, KT = round16(S + p.C) / 16;
  const int row0 = 16 * st + (lane >> 2);  // the thread's rows: row0, row0 + 8
  uint32_t qa[KD][4];
  {
    const int r = min(16 * st + row_r(lane), S - 1);
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) ldsm_x4(qa[kd], qw + r * ldw + 16 * kd + col_r(lane));
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if constexpr (kOnePass) {
    float s[kResidentTiles][2][4];
#pragma unroll
    for (int kt = 0; kt < kResidentTiles; ++kt) {
      if (kt >= KT) break;
      fwd_logits_tile<D>(p, kt, row0, qa, kw, kc, bias_s, s[kt], ldw);
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
      fwd_pv_tile<D>(p, kt, s[kt], m, l, vw, vc, o, ldw);
    }
  } else {
    // the row max, then the logits again at the final max (no running
    // rescale), as K1's two-pass strip
    for (int kt = 0; kt < KT; ++kt) {
      float s[2][4];
      fwd_logits_tile<D>(p, kt, row0, qa, kw, kc, bias_s, s, ldw);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        m[r] = fmaxf(m[r], fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                 fmaxf(s[1][2 * r], s[1][2 * r + 1])));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
    for (int kt = 0; kt < KT; ++kt) {
      float s[2][4];
      fwd_logits_tile<D>(p, kt, row0, qa, kw, kc, bias_s, s, ldw);
      fwd_pv_tile<D>(p, kt, s, m, l, vw, vc, o, ldw);
    }
  }
  __syncwarp();  // every lane's q fragments are in
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = quad_sum(l[r]);
    const int i = row0 + 8 * r;
    if (i >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(ao + i * ldo + 8 * n + cq) =
          pack_bf16(o[n][2 * r] / den, o[n][2 * r + 1] / den);
  }
}

// The design is in the comment at the head of this section.  kOnePass: S + C
// <= 16 * kResidentTiles, a strip's logits stay in registers.  kSplit: the
// layout's split (the attention rows in their own buffer, the window's q, k
// and v rows a head group at a time).
template <int D, bool FROM_X, bool kOnePass, bool kSplit>
__global__ void __launch_bounds__(kMmaThreads, 1) eva_out_mma_kernel(const OutParams p) {
  using namespace mma_frag;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DB = D + 8, V8 = D / 8;
  const int S = p.S, C = p.C, nh = p.nh, HD = nh * D;
  const int LW = 3 * (kSplit ? p.hg * D : HD) + 8;  // the window rows' stride
  const int NS = (S + 15) / 16;  // strips of 16 query rows
  const int XD = FROM_X ? p.XD : 0;
  const int slab = kSplit ? p.slab : kSlabRows;
  const OutMmaLayout L = out_mma_layout(D, S, C, nh, XD, p.hg, p.wo_whole, kSplit, slab);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x);           // K10: [S][XD + 8]
  bf16* win = reinterpret_cast<bf16*>(smem + L.win);        // [S][LW]: q, k, v
  bf16* attn_s = reinterpret_cast<bf16*>(smem + L.attn);    // kSplit: [S][HD + 8]
  bf16* kc = reinterpret_cast<bf16*>(smem + L.kc);          // [hg][C][DB]: rf
  bf16* vc = reinterpret_cast<bf16*>(smem + L.vc);          // [hg][C][DB]: beta
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);  // [hg][S][S]
  bf16* wgt = reinterpret_cast<bf16*>(smem + L.wgt);        // the ring, or Wo whole
  int* tok_s = reinterpret_cast<int*>(smem + L.tok);        // [wpb][S]
  float* bqkv_s = reinterpret_cast<float*>(smem + L.vec);   // K10: [3 HD]
  float* bo_s = bqkv_s + (FROM_X ? 3 * HD : 0);             // [HD]
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5;
  // (device pointers are formed from the parameters where they are used,
  // so that no register holds them through the strips)

  // the chunk rows and bias of heads [h0, h0 + hg) (the chunk rows in the
  // caller's commit group)
  auto stage_heads = [&](int h0) {
    const bf16* rf = static_cast<const bf16*>(p.rf) + (size_t)b * C * HD;
    const bf16* bt = static_cast<const bf16*>(p.beta) + (size_t)b * C * HD;
    const int n = min(p.hg, nh - h0);
    for (int e = tid; e < n * C * V8; e += kMmaThreads) {
      const int v = e % V8, c = (e / V8) % C, h = e / (V8 * C);
      const size_t src = (size_t)c * HD + (h0 + h) * D + 8 * v;
      cp_async16(kc + (h * C + c) * DB + 8 * v, rf + src);
      cp_async16(vc + (h * C + c) * DB + 8 * v, bt + src);
    }
    const float* bh = p.bias != nullptr ? p.bias + (size_t)h0 * S * S : nullptr;
    for (int e = tid; e < n * S * S; e += kMmaThreads)
      bias_s[e] = bh != nullptr ? eva_strip::kLog2e * bh[e] : 0.f;
  };
  // column n (< 3G) of the window's rows as a column of qkv (and of Wqkv):
  // with kSplit the q, k and v columns of the G / D heads from h0, else n
  auto qkv_col = [&](int n, int G, int h0) {
    return kSplit ? n / G * HD + h0 * D + n % G : n;
  };
  // window wi's rows (K9: q, k, v of the G / D heads from h0 from qkv into
  // win; K10: x into xs), in the caller's commit group
  auto load_rows = [&](int wi, int G, int h0) {
    const int* tok = tok_s + wi * S;
    if constexpr (FROM_X) {
      const bf16* x = static_cast<const bf16*>(p.x) + (size_t)b * p.N * XD;
      const int V = XD / 8;
      for (int e = tid; e < S * V; e += kMmaThreads) {
        const int l = e / V, v = e % V;
        cp_async16(xs + l * (XD + 8) + 8 * v, x + (size_t)tok[l] * XD + 8 * v);
      }
    } else {
      const bf16* qkv = static_cast<const bf16*>(p.qkv) + (size_t)b * p.N * 3 * HD;
      const int V = 3 * G / 8;
      for (int e = tid; e < S * V; e += kMmaThreads) {
        const int l = e / V, v = e % V;
        cp_async16(win + l * LW + 8 * v,
                   qkv + (size_t)tok[l] * 3 * HD + qkv_col(8 * v, G, h0));
      }
    }
  };
  // q, k, v = x Wqkv + bqkv of the G / D heads from h0, rounded to bf16
  // into the window's rows
  auto project_qkv = [&](int G, int h0) {
    ring_product(xs, XD + 8, S, XD, static_cast<const bf16*>(p.wqkv), 3 * HD, 3 * G,
                 [&](int n) { return qkv_col(n, G, h0); }, slab, wgt,
                 [&](int i, int n, float y0, float y1) {
                   const int c = qkv_col(n, G, h0);
                   *reinterpret_cast<uint32_t*>(win + i * LW + n) =
                       pack_bf16(y0 + bqkv_s[c], y1 + bqkv_s[c + 1]);
                 });
  };

  OutPhases phases;
  phases.start();
  for (int e = tid; e < p.wpb * S; e += kMmaThreads)
    tok_s[e] = out_token(p, blockIdx.x * p.wpb + e / S, e % S);
  // the epilogues read the bias vectors from here, not from device memory
  // behind their own stores
  for (int e = tid; e < HD; e += kMmaThreads) bo_s[e] = p.bo[e];
  if constexpr (FROM_X)
    for (int e = tid; e < 3 * HD; e += kMmaThreads) bqkv_s[e] = p.bqkv[e];
  __syncthreads();
  const bool one_group = p.hg >= nh;
  if (one_group) stage_heads(0);
  if (!FROM_X && p.wo_whole)  // K9: Wo once a block
    load_weight(static_cast<const bf16*>(p.wo), HD, HD, wgt);
  if (FROM_X || !kSplit) load_rows(0, HD, 0);
  cp_async_commit();
  bf16* ao = kSplit ? attn_s : win;  // the attention rows
  const int ldo = kSplit ? HD + 8 : LW;
  for (int wi = 0; wi < p.wpb; ++wi) {
    const int* tok = tok_s + wi * S;
    if (!FROM_X && !kSplit && wi > 0) {
      load_rows(wi, HD, 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
    phases.mark(kPhaseStage);
    if constexpr (FROM_X && !kSplit) {
      // every head's q, k, v; then Wo over the ring and the next window's x
      // rows over this one's
      project_qkv(HD, 0);
      phases.mark(kPhaseProj);
      if (p.wo_whole) load_weight(static_cast<const bf16*>(p.wo), HD, HD, wgt);
      if (wi + 1 < p.wpb) load_rows(wi + 1, HD, 0);
      cp_async_commit();
    }
    // attention, hg heads at a time
    for (int h0 = 0; h0 < nh; h0 += p.hg) {
      const int G = kSplit ? min(p.hg, nh - h0) * D : HD;  // a third of the rows
      if (!one_group || (!FROM_X && kSplit)) {
        __syncthreads();  // every warp is done with the previous group
        if (!one_group) stage_heads(h0);
        if (!FROM_X && kSplit) load_rows(wi, G, h0);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        phases.mark(kPhaseStage);
      }
      if constexpr (FROM_X && kSplit) {
        // the group's q, k, v; after the last group, Wo over the ring and
        // the next window's x rows over this one's
        project_qkv(G, h0);
        phases.mark(kPhaseProj);
        if (h0 + p.hg >= nh) {
          if (p.wo_whole) load_weight(static_cast<const bf16*>(p.wo), HD, HD, wgt);
          if (wi + 1 < p.wpb) load_rows(wi + 1, HD, 0);
          cp_async_commit();
        }
      }
      const int jobs = min(p.hg, nh - h0) * NS;
      for (int job = warp; job < jobs; job += kMmaWarps) {
        const int hl = job / NS, h = h0 + hl;
        const int c = (kSplit ? hl : h) * D;  // the head's q column in the rows
        out_strip<D, kOnePass>(p, job % NS, win + c, win + G + c, win + 2 * G + c, LW,
                               kc + hl * C * DB, vc + hl * C * DB,
                               bias_s + (size_t)hl * S * S, ao + h * D, ldo);
      }
      phases.mark(kPhaseStrips, true);
    }
    // out = attn Wo + bo
    auto store_out = [&](int i, int n, float y0, float y1) {
      bf16* out = static_cast<bf16*>(p.out) + ((size_t)b * p.N + tok[i]) * HD;
      *reinterpret_cast<uint32_t*>(out + n) = pack_bf16(y0 + bo_s[n], y1 + bo_s[n + 1]);
    };
    if (p.wo_whole) {
      if (FROM_X) cp_async_wait_all();  // Wo (and the next x rows)
      __syncthreads();  // every head's attention rows, Wo
      smem_product(ao, ldo, S, HD, wgt, HD, store_out);
      __syncthreads();  // the rows (and K10's weight region) are rewritten next
    } else {
      ring_product(ao, ldo, S, HD, static_cast<const bf16*>(p.wo), HD, HD,
                   [](int n) { return n; }, slab, wgt, store_out);
    }
    phases.mark(kPhaseOut);
  }
  phases.end();
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

// Windows a block of the tensor-core route takes in turn: the most (up to
// kMaxWpb, dividing an image's windows) that leave a block or more for each
// SM.
inline int out_windows_per_block(const OutParams& p, int sms) {
  const int n_win = (p.N / p.gw / p.ws) * p.nww;
  for (int wpb = kMaxWpb; wpb > 1; wpb /= 2)
    if (n_win % wpb == 0 && (long long)p.B * (n_win / wpb) >= sms) return wpb;
  return 1;
}

// The tensor-core kernel of a geometry and its layout L: one pass where a
// strip's logits fit the registers.  Built with -DEVA_OUT_TWO_PASS
// (scripts/torch_eva_out_check.py, to time the one-pass strips, which
// spill, against strips that do not), always two passes.
template <int D, bool FROM_X>
auto out_mma_kernel(int S, int C, const OutMmaLayout& L) {
#ifdef EVA_OUT_TWO_PASS
  if (false)
#else
  if (eva_strip::one_pass(S, C))
#endif
    return L.split ? eva_out_mma_kernel<D, FROM_X, true, true>
                   : eva_out_mma_kernel<D, FROM_X, true, false>;
  return L.split ? eva_out_mma_kernel<D, FROM_X, false, true>
                 : eva_out_mma_kernel<D, FROM_X, false, false>;
}

template <int D, bool FROM_X>
cudaError_t prepare_out_mma(int S, int C, int nh, int XD, OutMmaLayout& L) {
  if (!out_mma_plan(D, S, C, nh, XD, L)) return cudaErrorInvalidValue;
  const auto kernel = out_mma_kernel<D, FROM_X>(S, C, L);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D, bool FROM_X>
cudaError_t launch_out_mma(OutParams p, cudaStream_t stream) {
  OutMmaLayout L;
  cudaError_t err = prepare_out_mma<D, FROM_X>(p.S, p.C, p.nh, FROM_X ? p.XD : 0, L);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  p.hg = L.hg;
  p.wo_whole = L.wo_whole;
  p.slab = L.slab;
  p.wpb = out_windows_per_block(p, sms);
  const int n_win = (p.N / p.gw / p.ws) * p.nww;
  const auto kernel = out_mma_kernel<D, FROM_X>(p.S, p.C, L);
  kernel<<<dim3(n_win / p.wpb, p.B), kMmaThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

// Blocks of the tensor-core kernel that fit one SM (registers and shared
// memory, from the occupancy calculator), or -1.
template <bool FROM_X>
int out_mma_blocks_per_sm(int d, int S, int C, int nh, int XD) {
  auto blocks = [&](auto kernel, cudaError_t prepared, size_t smem) {
    int n = 0;
    if (prepared != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kMmaThreads, smem) !=
            cudaSuccess)
      return -1;
    return n;
  };
  OutMmaLayout L;
  switch (d) {
    case 16: {
      const cudaError_t err = prepare_out_mma<16, FROM_X>(S, C, nh, XD, L);
      return blocks(out_mma_kernel<16, FROM_X>(S, C, L), err, L.total);
    }
    case 32: {
      const cudaError_t err = prepare_out_mma<32, FROM_X>(S, C, nh, XD, L);
      return blocks(out_mma_kernel<32, FROM_X>(S, C, L), err, L.total);
    }
    case 64: {
      const cudaError_t err = prepare_out_mma<64, FROM_X>(S, C, nh, XD, L);
      return blocks(out_mma_kernel<64, FROM_X>(S, C, L), err, L.total);
    }
    default: return -1;
  }
}

// The tensor-core route where the inputs are bf16 and the head dim (and XD)
// are multiples of 16 (out_uses_mma), else the CUDA-core route.
template <int D, bool FROM_X>
cudaError_t launch_out_d(const OutParams& p, int is_bf16, cudaStream_t stream) {
  const int XD = FROM_X ? p.XD : 0;
  if constexpr (D % 16 == 0) {
    if (is_bf16 && out_uses_mma(D, 2, XD)) return launch_out_mma<D, FROM_X>(p, stream);
  }
  const size_t smem = make_out_layout(D, p.S, p.C, p.nh, is_bf16 ? 2 : 4, XD).total;
  if (!is_bf16) return launch_out_kernel(eva_out_kernel<D, float, FROM_X>, smem, p, stream);
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

// ---- the persistent tensor-core summaries (bf16)

constexpr int kSumDenseThreads = 256;  // threads of one Dense partition
constexpr int kSumProjCols = 48;       // columns of one projection job: three 16-wide tiles

struct SumMmaLayout {
  size_t w, ring, stage, tok, tok_stage, vec, mean, part, lw, moff, total;
};

// Offsets (bytes) of the persistent kernel's shared memory; the same layout
// as mma_smem_bytes() in ops/kernels/eva_summaries.py: K10's Wqkv columns of
// the block's head [XD][3D + 8] (bf16), the ring of `stages` item buffers
// (K8: the strip's q | k | v rows of one head [R][3D + 8]; K10: its x rows
// [R][XD + 8]), K10's projected rows [R][3D + 8], the f32 vectors (the
// adaptive biases and LN; K10's bqkv columns), the chunks' means [wc][2][D],
// the Dense's partial sums [256 / 2D][wc][2D], the members' weights
// [wc][JJ] and their row offsets [wc][JJ] (int), each 128-byte aligned.
// XD = 0 for K8.  K10's two-team kernel (teams 2) keeps two buffers of
// projected rows.
__host__ __device__ inline SumMmaLayout sum_mma_layout(int R, int D, int XD, int wc, int JJ,
                                                       int stages, int teams = 1) {
  const size_t LT = 3 * D + 8;
  SumMmaLayout L = {};
  size_t o = 0;
  L.w = o;     o += align128((size_t)XD * LT * 2);
  L.stage = align128((size_t)R * (XD > 0 ? XD + 8 : LT) * 2);
  L.ring = o;  o += stages * L.stage;
  L.tok_stage = align128((size_t)R * LT * 2);
  L.tok = o;   o += XD > 0 ? teams * L.tok_stage : 0;
  L.vec = o;   o += align128((size_t)(6 * D + (XD > 0 ? 3 * D : 0)) * 4);
  L.mean = o;  o += align128((size_t)wc * 2 * D * 4);
  L.part = o;  o += align128((size_t)kSumDenseThreads * wc * 4);
  L.lw = o;    o += align128((size_t)wc * JJ * 4);
  L.moff = o;  o += align128((size_t)wc * JJ * 4);
  L.total = o;
  return L;
}

// cp.async.wait_group n for n in 0..2 (the ring's depth less one or two).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__device__ __forceinline__ float2 ld_bf2(const bf16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}

// Blocks of a persistent launch (mma_blocks() in the wrapper): a multiple of
// the heads, at most bps an SM, and no more than there are items.
__host__ __device__ inline int sum_mma_blocks(int B, int nh, int strips, int sms, int bps) {
  const long long fit = (long long)sms * bps / nh, items = (long long)strips * B;
  return nh * (int)(fit < 1 ? 1 : (items < fit ? items : fit));
}

// K10's projection of one item: tok[i][n] = x[i] . W[:, n] + bias[n], summed
// in f32 and rounded to bf16, for the strip's rows i < R and the head's 3D
// columns n (q | k | v), on mma.sync m16n8k16.  x [R][XD + 8] and the
// head's Wqkv columns W [XD][3D + 8] lie in shared memory; a warp's job is
// RT 16-row tiles by 16 CT columns over the whole sum (each W fragment
// feeds every row tile), rows past R reading row R - 1 (their outputs
// dropped), the fragments rounded straight into the rows.
template <int D, int RT, int CT, bool PIPE>
__device__ __forceinline__ void sum_project_jobs(const bf16* xs, int XD, int R, const bf16* wsl,
                                                 const float* bias, bf16* tok, int rt0, int MT,
                                                 int warp, int NW) {
  using namespace mma_frag;
  constexpr int LT = 3 * D + 8, NG = 3 * D / (16 * CT);
  const int lane = threadIdx.x & 31, ldx = XD + 8;
  for (int job = warp; job < (MT - rt0 + RT - 1) / RT * NG; job += NW) {
    const int rt = rt0 + RT * (job / NG), c0 = (job % NG) * 16 * CT;
    float acc[RT][2 * CT][4];
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int n = 0; n < 2 * CT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.f;
    const bf16* ar[RT];
#pragma unroll
    for (int t = 0; t < RT; ++t)
      ar[t] = xs + min(16 * (rt + t) + row_r(lane), R - 1) * ldx + col_r(lane);
    const bf16* br = wsl + row_r(lane) * LT + c0 + col_r(lane);
    if constexpr (PIPE) {
      // the next k-step's fragments load while this one's products run
      uint32_t a0[RT][4], a1[RT][4], b0[CT][4], b1[CT][4];
      auto load = [&](uint32_t(&aa)[RT][4], uint32_t(&bb)[CT][4], int k) {
#pragma unroll
        for (int t = 0; t < RT; ++t)
          if (rt + t < MT) ldsm_x4(aa[t], ar[t] + k);
#pragma unroll
        for (int u = 0; u < CT; ++u) ldsm_x4_trans(bb[u], br + k * LT + 16 * u);
      };
      auto products = [&](const uint32_t(&aa)[RT][4], const uint32_t(&bb)[CT][4]) {
#pragma unroll
        for (int u = 0; u < CT; ++u)
#pragma unroll
          for (int t = 0; t < RT; ++t)
            if (rt + t < MT) {
              mma_bf16(acc[t][2 * u], aa[t], bb[u][0], bb[u][1]);
              mma_bf16(acc[t][2 * u + 1], aa[t], bb[u][2], bb[u][3]);
            }
      };
      load(a0, b0, 0);
      for (int k = 0; k < XD; k += 32) {
        if (k + 16 < XD) load(a1, b1, k + 16);
        products(a0, b0);
        if (k + 32 < XD) load(a0, b0, k + 32);
        if (k + 16 < XD) products(a1, b1);
      }
    } else {
      for (int k = 0; k < XD; k += 16) {
        uint32_t a[RT][4];
#pragma unroll
        for (int t = 0; t < RT; ++t)
          if (rt + t < MT) ldsm_x4(a[t], ar[t] + k);
#pragma unroll
        for (int u = 0; u < CT; ++u) {
          uint32_t bw[4];
          ldsm_x4_trans(bw, br + k * LT + 16 * u);
#pragma unroll
          for (int t = 0; t < RT; ++t)
            if (rt + t < MT) {
              mma_bf16(acc[t][2 * u], a[t], bw[0], bw[1]);
              mma_bf16(acc[t][2 * u + 1], a[t], bw[2], bw[3]);
            }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      if (rt + t >= MT) continue;  // past the range (its accumulators are zero)
      const int r0 = 16 * (rt + t) + (lane >> 2);
#pragma unroll
      for (int n = 0; n < 2 * CT; ++n) {
        const int col = c0 + 8 * n + 2 * (lane & 3);
        const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (r0 + 8 * r < R)
            *reinterpret_cast<uint32_t*>(tok + (r0 + 8 * r) * LT + col) =
                pack_bf16(acc[t][n][2 * r] + b0, acc[t][n][2 * r + 1] + b1);
      }
    }
  }
}

// Row tiles [rt0, MT) (the item's R rows end in tile MT - 1) by NW warps
// (warp the caller's index among them): jobs of two row tiles by 48
// columns where there are as many as warps (the headline's 112 rows: 16
// jobs), else of one tile by 16 columns (PVT-B3's third stage: 28 rows, 12
// jobs), so that every warp has one.
template <int D, bool PIPE = false>
__device__ __forceinline__ void sum_project(const bf16* xs, int XD, int R, const bf16* wsl,
                                            const float* bias, bf16* tok, int rt0, int MT,
                                            int warp, int NW) {
  if ((MT - rt0 + 1) / 2 * (3 * D / kSumProjCols) >= NW)
    sum_project_jobs<D, 2, 3, PIPE>(xs, XD, R, wsl, bias, tok, rt0, MT, warp, NW);
  else
    sum_project_jobs<D, 1, 1, PIPE>(xs, XD, R, wsl, bias, tok, rt0, MT, warp, NW);
}

// LayerNorm of two rows of D values a warp holds, DPL per lane
// (lane-strided), their reductions interleaved (eva_single.cu's).
template <int D, int DPL>
__device__ __forceinline__ void warp_layer_norm2(float (&x)[DPL], const float* xs,
                                                 const float* xb, float (&y)[DPL],
                                                 const float* ys, const float* yb, int lane) {
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    if (lane + 32 * i < D) {
      sx += x[i];
      sy += y[i];
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
    sy += __shfl_xor_sync(0xffffffffu, sy, o);
  }
  const float mx = sx / D, my = sy / D;
  float qx = 0.f, qy = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    if (lane + 32 * i < D) {
      qx += (x[i] - mx) * (x[i] - mx);
      qy += (y[i] - my) * (y[i] - my);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qx += __shfl_xor_sync(0xffffffffu, qx, o);
    qy += __shfl_xor_sync(0xffffffffu, qy, o);
  }
  const float ix = rsqrtf(qx / D + kLnEps), iy = rsqrtf(qy / D + kLnEps);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int o = lane + 32 * i;
    if (o < D) {
      x[i] = (x[i] - mx) * ix * xs[o] + xb[o];
      y[i] = (y[i] - my) * iy * ys[o] + yb[o];
    }
  }
}

// <mu, k> and |k|^2 over the dimensions 8 t0 .. 8 (t0 + n) of a member's k
// row (bf16) and mu (f32), in two sums each.
__device__ __forceinline__ void logit_sums(const bf16* k, const float* mu, int t0, int n,
                                           float& dot_out, float& nrm_out) {
  const uint4* kr = reinterpret_cast<const uint4*>(k);
  float dot[2] = {0.f, 0.f}, nrm[2] = {0.f, 0.f};
#pragma unroll 2
  for (int t8 = t0; t8 < t0 + n; ++t8) {
    const uint4 ut = kr[t8];
    const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&ut);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float4 m4 = reinterpret_cast<const float4*>(mu)[2 * t8 + hh];
      const float2 k0 = __bfloat1622float2(e2[2 * hh]);
      const float2 k1 = __bfloat1622float2(e2[2 * hh + 1]);
      dot[hh] = fmaf(m4.w, k1.y, fmaf(m4.z, k1.x, fmaf(m4.y, k0.y, fmaf(m4.x, k0.x, dot[hh]))));
      nrm[hh] = fmaf(k1.y, k1.y, fmaf(k1.x, k1.x, fmaf(k0.y, k0.y, fmaf(k0.x, k0.x, nrm[hh]))));
    }
  }
  dot_out = dot[0] + dot[1];
  nrm_out = nrm[0] + nrm[1];
}

// The max and the sum of v over lane groups of `width` (a power of two):
// the members of one chunk.
__device__ __forceinline__ float group_max(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The summaries of one item from its rows [R][3D + 8] (q | k | v of head
// h), by a team of NW warps (warp and ttid its warp and thread index in the
// team) whose barrier is sync(): the means, the adaptive Dense, then a warp
// a chunk LN, mu, the logits, softmax and beta (the design at
// eva_summaries_mma_kernel); rf_k and beta of the item's chunks, strip hr
// of image b, rounded to bf16 into device memory.
struct SumCtx {
  const float* vec;  // bq, bk, lnq s/b, lnk s/b [6][D]
  float* mean;       // [wc][2][D] means of q, k; then mu
  float* part;       // [KG][wc][2D] Dense partial sums
  float* lw;         // [wc][JJ] members' weights
  const int* moff;   // [wc][JJ] members' row offsets
  int h, wc, JJ, width;
  float dn;
};

// A thread's slice of its Dense column (sum_body's dcol, dgrp): inputs
// [dgrp DK, dgrp DK + DK) of column dcol of wq (dcol < D) or wk.
template <int D>
__device__ __forceinline__ void sum_dense_slice(const SumParams& p, int ttid,
                                                float (&wr)[D * D / 128]) {
  constexpr int DK = D * D / 128;
  const int dcol = ttid % (2 * D), dgrp = (ttid % kSumDenseThreads) / (2 * D);
  const float* W = (dcol < D ? p.wq : p.wk) + dcol % D;
#pragma unroll
  for (int k = 0; k < DK; ++k) wr[k] = W[(dgrp * DK + k) * D];
}

// The Dense: a partition of kSumDenseThreads threads takes every CH-th
// chunk; in it thread (g, column) sums inputs [g DK, g DK + DK) of its
// column, KG groups of the 2D columns of rf_q and rf_k.
template <int D, int NW, typename Sync>
__device__ __forceinline__ void sum_body(const SumParams& p, const SumCtx& x, const bf16* rows,
                                         int hr, int b, int warp, int ttid,
                                         const float (&wr)[D * D / 128], Sync&& sync,
                                         SumPhases& phases) {
  using namespace mma_frag;
  constexpr int V8 = D / 8, NP = D / 2, DPL = (D + 31) / 32;
  constexpr int KG = kSumDenseThreads / (2 * D), DK = D / KG, CH = 32 * NW / kSumDenseThreads;
  const int lane = threadIdx.x & 31, wc = x.wc, JJ = x.JJ, HD = p.nh * D, h = x.h;
  const int dcol = ttid % (2 * D), dgrp = (ttid % kSumDenseThreads) / (2 * D);
  const int dpart = ttid / kSumDenseThreads, width = x.width;
  const float* vec = x.vec;
  float* mean = x.mean;
  float* part = x.part;
  float* lw = x.lw;
  const int* moff = x.moff;
  const float dn = x.dn;
  // the means of q and k, a warp a chunk, a lane a dimension pair
  for (int c = warp; c < wc; c += NW) {
    if (lane < NP) {
      float2 sq = make_float2(0.f, 0.f), sk = make_float2(0.f, 0.f);
#pragma unroll 4
      for (int m = 0; m < JJ; ++m) {
        const bf16* row = rows + moff[c * JJ + m] + 2 * lane;
        const float2 a = ld_bf2(row), k2 = ld_bf2(row + D);
        sq.x += a.x;
        sq.y += a.y;
        sk.x += k2.x;
        sk.y += k2.y;
      }
      *reinterpret_cast<float2*>(mean + c * 2 * D + 2 * lane) =
          make_float2(sq.x / JJ, sq.y / JJ);
      *reinterpret_cast<float2*>(mean + c * 2 * D + D + 2 * lane) =
          make_float2(sk.x / JJ, sk.y / JJ);
    }
  }
  sync();
  phases.mark(kSumMeans);
  // the adaptive Dense's partial sums, two chunks at a time (two sums
  // each, over even and odd inputs)
  {
    const float* mcol = mean + (dcol / D) * D + dgrp * DK;
    for (int c = dpart; c < wc; c += 2 * CH) {
      const int c2 = c + CH;
      const bool has2 = c2 < wc;
      float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < DK; k += 2) {
        const float2 m0 = *reinterpret_cast<const float2*>(mcol + c * 2 * D + k);
        s0[0] = fmaf(m0.x, wr[k], s0[0]);
        s0[1] = fmaf(m0.y, wr[k + 1], s0[1]);
        if (has2) {
          const float2 m1 = *reinterpret_cast<const float2*>(mcol + c2 * 2 * D + k);
          s1[0] = fmaf(m1.x, wr[k], s1[0]);
          s1[1] = fmaf(m1.y, wr[k + 1], s1[1]);
        }
      }
      part[(dgrp * wc + c) * 2 * D + dcol] = s0[0] + s0[1];
      if (has2) part[(dgrp * wc + c2) * 2 * D + dcol] = s1[0] + s1[1];
    }
  }
  sync();
  phases.mark(kSumDense);
  // a warp a chunk: the Dense's sums, LN, mu, the logits, softmax and
  // beta, and the writes
  bf16* rf_out = static_cast<bf16*>(p.rf) + ((size_t)b * p.C + (size_t)hr * wc) * HD + h * D;
  bf16* beta_out =
      static_cast<bf16*>(p.beta) + ((size_t)b * p.C + (size_t)hr * wc) * HD + h * D;
  for (int c = warp; c < wc; c += NW) {
    float rq[DPL], rk[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int dd = lane + 32 * i;
      rq[i] = rk[i] = 0.f;
      if (dd < D) {
        rq[i] = vec[dd];
        rk[i] = vec[D + dd];
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          rq[i] += part[(g * wc + c) * 2 * D + dd];
          rk[i] += part[(g * wc + c) * 2 * D + D + dd];
        }
      }
    }
    if (p.use_ln)
      warp_layer_norm2<D, DPL>(rq, vec + 2 * D, vec + 3 * D, rk, vec + 4 * D, vec + 5 * D,
                               lane);
    float* mu = mean + c * 2 * D;  // the chunk's means are spent
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) {
        mu[dd] = 0.5f * (rq[i] + rk[i]);
        rf_out[(size_t)c * HD + dd] = __float2bfloat16_rn(rk[i]);
      }
    }
    __syncwarp();
    // <mu, k>/sqrt(d) - |k|^2/(2 sqrt(d)): with at most 16 members two
    // lanes a member, each over half of the dimensions, else a lane a
    // member
    const int* mo = moff + c * JJ;
    float* lwc = lw + c * JJ;
    float mx = -INFINITY;
    if (JJ <= 16) {
      const int m = lane & 15;
      float dot = 0.f, nrm = 0.f;
      if (m < JJ) logit_sums(rows + mo[m] + D, mu, (lane >> 4) * V8 / 2, V8 / 2, dot, nrm);
      dot += __shfl_xor_sync(0xffffffffu, dot, 16);
      nrm += __shfl_xor_sync(0xffffffffu, nrm, 16);
      if (m < JJ) {
        mx = dn * dot - 0.5f * dn * nrm;
        if (lane < 16) lwc[m] = mx;
      }
    } else {
      for (int m = lane; m < JJ; m += 32) {
        float dot = 0.f, nrm = 0.f;
        logit_sums(rows + mo[m] + D, mu, 0, V8, dot, nrm);
        const float l = dn * dot - 0.5f * dn * nrm;
        lwc[m] = l;
        mx = fmaxf(mx, l);
      }
    }
    mx = group_max(mx, width);
    float sum = 0.f;
    for (int m = lane; m < JJ; m += 32) {
      const float e = expf(lwc[m] - mx);
      lwc[m] = e;
      sum += e;
    }
    sum = __shfl_sync(0xffffffffu, group_sum(sum, width), 0);  // to every lane
    __syncwarp();
    // beta = sum of the weights times v, over their sum, a lane a pair
    if (lane < NP) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll 4
      for (int m = 0; m < JJ; ++m) {
        const float x = lwc[m];
        const float2 vv = ld_bf2(rows + mo[m] + 2 * D + 2 * lane);
        acc.x = fmaf(x, vv.x, acc.x);
        acc.y = fmaf(x, vv.y, acc.y);
      }
      *reinterpret_cast<uint32_t*>(beta_out + (size_t)c * HD + 2 * lane) =
          pack_bf16(acc.x / sum, acc.y / sum);
    }
  }
}

// The persistent summaries kernel (bf16; D 16, 32 or 64; chunks of at most
// 64 members; 256 or 512 threads).  Block k keeps head h = k % nh for its
// life and takes the (strip, image) pairs k / nh, k / nh + gridDim / nh, ...
// (mma_walk() in the wrapper), so the blocks of one pair's heads run side by
// side and read its rows from device memory about once.  An item's rows
// (K8: the strip's q, k, v columns of head h; K10: its x rows) arrive in a
// ring of `stages` buffers by cp.async, 16 bytes a thread, while earlier
// items are computed.  K10 holds the head's Wqkv columns in shared memory
// for the block's life and projects each item on mma.sync into [R][3D + 8]
// rows.  The chunk body is K2's phase 1 (eva_single.cu): the q and k sums
// a warp a chunk, a lane a dimension pair; the adaptive Dense a thread an
// output column, its slice of wq or wk held in registers for the block's
// life, over every chunk of the item (partial sums over slices of the input
// dimension, added in the next phase); then, a warp a chunk, LN, mu, the
// members' logits (two lanes a member, each over half the dimensions, where
// a chunk has at most 16; else a lane a member), their true max, exp and
// sum, and beta a lane a dimension pair.  All of it in f32; rf_k and beta
// rounded to bf16 into device memory.  Built with -DEVA_SUM_PHASES the
// block's thread 0 sums its cycles by phase (SumPhases), each phase ending
// at a barrier.
// The blocks an SM a kernel of NW warps is built for (its registers): two
// of 8 warps, one of 16.  mma_plan() in the wrapper keeps a launch's
// blocks an SM within it.
__host__ __device__ constexpr int sum_mma_max_bps(int NW) { return NW == 16 ? 1 : 2; }

template <int D, bool FROM_X, int NW>
__global__ void __launch_bounds__(32 * NW, sum_mma_max_bps(NW))
    eva_summaries_mma_kernel(const SumParams p) {
  using namespace mma_frag;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LT = 3 * D + 8, V8 = D / 8, DK = D * D / 128, NT = 32 * NW;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int R = p.R, j = p.j, JJ = j * j, wc = p.wc, nh = p.nh, HD = nh * D;
  const int XD = FROM_X ? p.XD : 0, S = p.stages;
  const SumMmaLayout L = sum_mma_layout(R, D, XD, wc, JJ, S);
  bf16* wsl = reinterpret_cast<bf16*>(smem + L.w);        // K10: [XD][LT], head h's q | k | v
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);    // [S] items' rows
  bf16* tok = reinterpret_cast<bf16*>(smem + L.tok);      // K10: [R][LT] projected
  float* vec = reinterpret_cast<float*>(smem + L.vec);    // bq, bk, lnq s/b, lnk s/b; K10 bqkv's
  float* mean = reinterpret_cast<float*>(smem + L.mean);  // [wc][2][D] means of q, k; then mu
  float* part = reinterpret_cast<float*>(smem + L.part);  // [KG][wc][2D] Dense partial sums
  float* lw = reinterpret_cast<float*>(smem + L.lw);      // [wc][JJ] members' weights
  int* moff = reinterpret_cast<int*>(smem + L.moff);      // [wc][JJ] members' row offsets
  const size_t stage_elems = L.stage / 2;
  const int h = blockIdx.x % nh, strips = p.N / R, pairs = strips * p.B;
  const int q0 = blockIdx.x / nh, qstep = gridDim.x / nh;
  const int items = q0 < pairs ? (pairs - q0 + qstep - 1) / qstep : 0;
  // column n < 3D of head h's q | k | v as a column of qkv and of Wqkv
  auto qkv_col = [&](int n) { return (n / D) * HD + h * D + n % D; };
  // item t's rows into ring buffer t % S, one commit group an item (empty
  // past the last)
  auto issue = [&](int t) {
    if (t < items) {
      const int q = q0 + t * qstep, hr = q % strips, b = q / strips;
      bf16* dst = ring + (size_t)(t % S) * stage_elems;
      if constexpr (FROM_X) {
        const bf16* src =
            static_cast<const bf16*>(p.x) + ((size_t)b * p.N + (size_t)hr * R) * XD;
        const int V = XD / 8;
        for (int e = tid; e < R * V; e += NT) {
          const int r = e / V, v = e % V;
          cp_async16(dst + r * (XD + 8) + 8 * v, src + (size_t)r * XD + 8 * v);
        }
      } else {
        const bf16* src =
            static_cast<const bf16*>(p.qkv) + ((size_t)b * p.N + (size_t)hr * R) * 3 * HD;
        for (int e = tid; e < R * 3 * V8; e += NT) {
          const int r = e / (3 * V8), c = e % (3 * V8);
          cp_async16(dst + r * LT + 8 * c, src + (size_t)r * 3 * HD + qkv_col(8 * c));
        }
      }
    }
    cp_async_commit();
  };

  SumPhases phases;
  phases.start();
  // the block's constants, landed by the first item's wait
  for (int e = tid; e < D; e += NT) {
    vec[e] = p.bq[e];
    vec[D + e] = p.bk[e];
    if (p.use_ln) {
      vec[2 * D + e] = p.lnq_s[e];
      vec[3 * D + e] = p.lnq_b[e];
      vec[4 * D + e] = p.lnk_s[e];
      vec[5 * D + e] = p.lnk_b[e];
    }
  }
  for (int e = tid; e < wc * JJ; e += NT) {
    // member m of chunk c is strip row (m / j) gw + c j + m % j
    const int c = e / JJ, m = e % JJ;
    moff[e] = ((m / j) * p.gw + c * j + m % j) * LT;
  }
  if constexpr (FROM_X) {
    for (int e = tid; e < 3 * D; e += NT) vec[6 * D + e] = p.bqkv[qkv_col(e)];
    const bf16* w = static_cast<const bf16*>(p.wqkv);
    for (int e = tid; e < XD * 3 * V8; e += NT) {
      const int k = e / (3 * V8), c = e % (3 * V8);
      cp_async16(wsl + k * LT + 8 * c, w + (size_t)k * 3 * HD + qkv_col(8 * c));
    }
  }
  float wr[DK];  // the thread's slice of its Dense column, for the block's life
  sum_dense_slice<D>(p, tid, wr);
  // K10 fills every buffer ahead (one frees once projected), K8 all but the
  // one the next item reads from
  for (int s = 0; s < (FROM_X ? S : S - 1); ++s) issue(s);

  int width = 1;  // lanes a chunk's members span: a power of two, at most 32
  while (width < JJ && width < 32) width <<= 1;
  const SumCtx ctx{vec, mean, part, lw, moff, h, wc, JJ, width, 1.f / sqrtf((float)D)};
  for (int t = 0; t < items; ++t) {
    const int q = q0 + t * qstep, hr = q % strips, b = q / strips;
    const bf16* stage = ring + (size_t)(t % S) * stage_elems;
    cp_async_wait_n(FROM_X ? S - 1 : S - 2);  // item t has landed
    __syncthreads();                          // ... for every thread; item t - 1 is done
    if constexpr (!FROM_X) issue(t + S - 1);  // into item t - 1's buffer
    phases.mark(kSumStage);
    const bf16* rows = stage;  // [R][LT]: q | k | v of head h
    if constexpr (FROM_X) {
      sum_project<D>(stage, XD, R, wsl, vec + 6 * D, tok, 0, (R + 15) / 16, warp, NW);
      __syncthreads();
      issue(t + S);  // into this item's x buffer
      phases.mark(kSumProj);
      rows = tok;
    }

    sum_body<D, NW>(p, ctx, rows, hr, b, warp, tid, wr, [] { __syncthreads(); }, phases);
    phases.mark(kSumLogits, true);
  }
  phases.end();
}

// cp.async.wait_group 1: all but the newest commit group have landed.
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Named barriers (bar.sync / bar.arrive) among n threads of the block.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// K10's two-team persistent kernel (bf16; 16 warps; the layout with two
// buffers of projected rows and one of x rows): warps 0-7 project item t
// into rows buffer t % 2 while warps 8-15 summarise item t - 1 from the
// other, so the body overlaps the projection.  The projectors load the x
// rows in two halves (rows [0, 64) and [64, R)), each refilled for the next
// item as soon as both halves' projection is past it, so the next item's
// loads overlap this item's projection.  Named barriers: 1 among the
// projectors, 2 among the body's warps, FULL (3, 4: a rows buffer is
// projected) and EMPTY (5, 6: the body is done with it) between the teams.
// The body is sum_body's; the arithmetic is eva_summaries_mma_kernel's.
template <int D>
__global__ void __launch_bounds__(512, 1) eva_summaries_ws_kernel(const SumParams p) {
  using namespace mma_frag;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LT = 3 * D + 8, V8 = D / 8, DK = D * D / 128;
  constexpr int kTeam = 256, kFull = 3, kEmpty = 5;
  const int tid = threadIdx.x, warp = tid >> 5;
  const bool projector = tid < kTeam;
  const int R = p.R, j = p.j, JJ = j * j, wc = p.wc, nh = p.nh, HD = nh * D, XD = p.XD;
  const SumMmaLayout L = sum_mma_layout(R, D, XD, wc, JJ, 1, 2);
  bf16* wsl = reinterpret_cast<bf16*>(smem + L.w);        // [XD][LT], head h's q | k | v
  bf16* xs = reinterpret_cast<bf16*>(smem + L.ring);      // [R][XD + 8] an item's x rows
  bf16* tok = reinterpret_cast<bf16*>(smem + L.tok);      // [2][R][LT] projected
  float* vec = reinterpret_cast<float*>(smem + L.vec);    // bq, bk, lnq s/b, lnk s/b, bqkv's
  float* mean = reinterpret_cast<float*>(smem + L.mean);  // [wc][2][D]
  float* part = reinterpret_cast<float*>(smem + L.part);  // [KG][wc][2D]
  float* lw = reinterpret_cast<float*>(smem + L.lw);      // [wc][JJ]
  int* moff = reinterpret_cast<int*>(smem + L.moff);      // [wc][JJ]
  const size_t tok_elems = L.tok_stage / 2;
  const int h = blockIdx.x % nh, strips = p.N / R, pairs = strips * p.B;
  const int q0 = blockIdx.x / nh, qstep = gridDim.x / nh;
  const int items = q0 < pairs ? (pairs - q0 + qstep - 1) / qstep : 0;
  // x's halves: rows [0, R1) (row tiles [0, MT1)) and [R1, R)
  const int MT = (R + 15) / 16, MT1 = min(MT, 4), R1 = min(R, 16 * MT1);
  auto qkv_col = [&](int n) { return (n / D) * HD + h * D + n % D; };
  // rows [r0, r1) of item t's x by the projectors, one commit group (empty
  // past the last item)
  auto issue = [&](int t, int r0, int r1) {
    if (t < items) {
      const int q = q0 + t * qstep, hr = q % strips, b = q / strips;
      const bf16* src = static_cast<const bf16*>(p.x) + ((size_t)b * p.N + (size_t)hr * R) * XD;
      const int V = XD / 8;
      for (int e = tid; e < (r1 - r0) * V; e += kTeam) {
        const int r = r0 + e / V, v = e % V;
        cp_async16(xs + r * (XD + 8) + 8 * v, src + (size_t)r * XD + 8 * v);
      }
    }
    cp_async_commit();
  };

  SumPhases phases;
  phases.start();
  for (int e = tid; e < D; e += 2 * kTeam) {
    vec[e] = p.bq[e];
    vec[D + e] = p.bk[e];
    if (p.use_ln) {
      vec[2 * D + e] = p.lnq_s[e];
      vec[3 * D + e] = p.lnq_b[e];
      vec[4 * D + e] = p.lnk_s[e];
      vec[5 * D + e] = p.lnk_b[e];
    }
  }
  for (int e = tid; e < wc * JJ; e += 2 * kTeam) {
    const int c = e / JJ, m = e % JJ;
    moff[e] = ((m / j) * p.gw + c * j + m % j) * LT;
  }
  for (int e = tid; e < 3 * D; e += 2 * kTeam) vec[6 * D + e] = p.bqkv[qkv_col(e)];
  float wr[DK];  // a body thread's slice of its Dense column
  if (projector) {
    const bf16* w = static_cast<const bf16*>(p.wqkv);
    for (int e = tid; e < XD * 3 * V8; e += kTeam) {
      const int k = e / (3 * V8), c = e % (3 * V8);
      cp_async16(wsl + k * LT + 8 * c, w + (size_t)k * 3 * HD + qkv_col(8 * c));
    }
    issue(0, 0, R1);  // with Wqkv's columns
    issue(0, R1, R);
  } else {
    sum_dense_slice<D>(p, tid - kTeam, wr);
  }
  __syncthreads();  // the constants
  int width = 1;
  while (width < JJ && width < 32) width <<= 1;
  const SumCtx ctx{vec, mean, part, lw, moff, h, wc, JJ, width, 1.f / sqrtf((float)D)};
  if (projector) {
    for (int t = 0; t < items; ++t) {
      bf16* out = tok + (size_t)(t & 1) * tok_elems;
      cp_async_wait_1();  // rows [0, R1) of item t
      named_sync(1, kTeam);
      if (t >= 2) named_sync(kEmpty + (t & 1), 2 * kTeam);  // item t - 2's rows are spent
      phases.mark(kSumStage);
      sum_project<D, true>(xs, XD, R, wsl, vec + 6 * D, out, 0, MT1, warp, 8);
      named_sync(1, kTeam);
      issue(t + 1, 0, R1);
      cp_async_wait_1();  // rows [R1, R) of item t
      named_sync(1, kTeam);
      sum_project<D, true>(xs, XD, R, wsl, vec + 6 * D, out, MT1, MT, warp, 8);
      named_sync(1, kTeam);
      issue(t + 1, R1, R);
      phases.mark(kSumProj);
      named_arrive(kFull + (t & 1), 2 * kTeam);
    }
  } else {
    for (int t = 0; t < items; ++t) {
      const int q = q0 + t * qstep, hr = q % strips, b = q / strips;
      named_sync(kFull + (t & 1), 2 * kTeam);
      phases.mark(kSumWrites);  // (the body team's wait for projected rows)
      sum_body<D, 8>(p, ctx, tok + (size_t)(t & 1) * tok_elems, hr, b, warp - 8, tid - kTeam,
                     wr, [] { named_sync(2, kTeam); }, phases);
      phases.mark(kSumLogits);
      if (t + 2 < items) named_arrive(kEmpty + (t & 1), 2 * kTeam);
    }
  }
  phases.end(kTeam);
}

// A layout a launch may take: 8 or 16 warps (one or two Dense partitions),
// the ring deep enough for the form (K8 reads its rows from the ring, so it
// needs a second buffer to load into), the blocks an SM that the kernel is
// built for; two teams only for K10 at 16 warps, one stage, one block an SM.
inline bool sum_mma_config_ok(bool from_x, const SumConfig& cfg) {
  if (cfg.teams == 2)
    return from_x && cfg.warps == 16 && cfg.stages == 1 && cfg.bps == 1;
  return cfg.teams == 1 && (cfg.warps == 8 || cfg.warps == 16) &&
         cfg.stages >= (from_x ? 1 : 2) && cfg.stages <= 3 && cfg.bps >= 1 &&
         cfg.bps <= sum_mma_max_bps(cfg.warps);
}

using SumKernel = void (*)(const SumParams);

// The persistent route's kernel of a layout, or null.
template <int D, bool FROM_X>
SumKernel sum_mma_kernel_d(const SumConfig& cfg) {
  if constexpr (FROM_X) {
    if (cfg.teams == 2) return eva_summaries_ws_kernel<D>;
  }
  return cfg.warps == 8 ? eva_summaries_mma_kernel<D, FROM_X, 8>
                        : eva_summaries_mma_kernel<D, FROM_X, 16>;
}

template <bool FROM_X>
SumKernel sum_mma_kernel(int d, const SumConfig& cfg) {
  switch (d) {
    case 16: return sum_mma_kernel_d<16, FROM_X>(cfg);
    case 32: return sum_mma_kernel_d<32, FROM_X>(cfg);
    case 64: return sum_mma_kernel_d<64, FROM_X>(cfg);
    default: return nullptr;
  }
}

inline cudaError_t prepare_sum_mma(SumKernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The persistent route at layout cfg, or an error where it cannot take the
// launch (never the first kernel in its place).
template <bool FROM_X>
cudaError_t launch_sum_mma(SumParams p, int d, const SumConfig& cfg, cudaStream_t stream) {
  if (!sum_mma_config_ok(FROM_X, cfg) || p.j * p.j > 64 || (FROM_X && p.XD % 16))
    return cudaErrorInvalidValue;
  const SumKernel kernel = sum_mma_kernel<FROM_X>(d, cfg);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  p.stages = cfg.stages;
  const SumMmaLayout L = sum_mma_layout(p.R, d, FROM_X ? p.XD : 0, p.wc, p.j * p.j,
                                        cfg.stages, cfg.teams);
  if (L.total > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = prepare_sum_mma(kernel, L.total);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  const int blocks = sum_mma_blocks(p.B, p.nh, p.N / p.R, sms, cfg.bps);
  kernel<<<blocks, 32 * cfg.warps, L.total, stream>>>(p);
  return cudaGetLastError();
}

// Blocks of the layout's kernel (warps, teams) at `smem` bytes that fit an
// SM (registers and shared memory, from the occupancy calculator), or -1.
template <bool FROM_X>
int sum_mma_blocks_per_sm(int d, int warps, int teams, int smem) {
  const SumConfig cfg{warps, 1, 1, teams};
  const SumKernel kernel = (warps == 8 || warps == 16) ? sum_mma_kernel<FROM_X>(d, cfg) : nullptr;
  int n = 0;
  if (kernel == nullptr || prepare_sum_mma(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * warps, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace eva_eval
