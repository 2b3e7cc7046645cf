// K2 eva_single: 2-D EVA chunk summaries and joint softmax in one kernel.
//
// Replaces efficient_attention_tpu/ops/pallas/eva_single.py::eva_attention_single
// (the TPU kernel of the EVA eval forward).  Plain version and wrapper:
// efficient_attention_torch/ops/kernels/eva_single.py.
//
// What bounds it: bytes.  At the DeiT-tiny-p8 eval shape (B=128, 28x28 tokens,
// 3 heads of 64, bf16) it must read qkv (115.6 MB) and write the output
// (38.5 MB); that is ~46 us at 3.35 TB/s, against ~8 us for its ~8 GFLOP at
// the bf16 tensor-core peak.
//
// Two routes, each one launch that reads qkv from device memory once and
// keeps the chunk summaries on the chip.  A thread-block cluster of CS blocks
// takes one (image, head); each block holds the q/k/v rows of its own windows
// (whole windows, in window order) in shared memory.  Chunks (j x j tokens)
// do not line up with windows, so a chunk's members may lie in several
// blocks of the cluster, whose shared memory the blocks reach through
// distributed shared memory.
//
// The CUDA-core route (eva_single_kernel; f32, and bf16 at head dim 12),
// all arithmetic in f32, the output written in the input dtype:
//   phase 1  block r summarises chunks c with c % CS == r: means of q and k,
//            the adaptive Dense (+LN) into rf_q, rf_k, mu = (rf_q + rf_k)/2,
//            and the per-chunk softmax of <mu,k>/sqrt(d) - |k|^2/(2 sqrt(d))
//            over the chunk's members, shifted by its true maximum, weighting
//            their values into beta.  One warp per chunk, reading every
//            member row across the cluster.
//   gather   every block copies all chunks' rf_k and beta into its own memory.
//   phase 2  one thread per query: an online softmax over its window's keys
//            (+ RPE bias) and the C chunk keys, values [window v | beta].
//            Phase 2's exponentials use the fast __expf (about 2 ulp near 0).
//
// The tensor-core route (eva_single_mma_kernel; bf16 at head dims 16, 32 and
// 64, uses_mma), with the TPU kernel's roundings: the summaries in f32 (at
// least as exact as the TPU kernel's bf16 operands there), rf_k and beta
// rounded to bf16 as keys and values, the numerators exp(l - max) rounded to
// bf16 for the value product, the denominator the f32 sum of the unrounded
// ones, out / denom in f32, then rounded.  4 warps a block.  Design:
//  * staging (cp.async through a token table): the block's q, k and v rows
//    [T][D+8] in bf16, in K1's padded layout (rows 16 bytes apart in bank
//    groups, so ldmatrix is conflict-free), and the bias [S][S] in f32,
//    scaled by log2 e once landed; meanwhile the chunks the block owns (those
//    whose first token it holds) and their members (rank, slot);
//  * phase 1 between two cluster barriers: a warp takes an owned chunk and
//    reads its members' rows where they lie, from its own shared memory or,
//    for members in another block, through distributed shared memory (a
//    lane a dimension pair, 4-byte loads that coalesce across the warp):
//    the q and k sums and means; the adaptive Dense a thread an output
//    column over the owned chunks; LN and mu; the members' logits in f32 a
//    lane a member (two chunks a warp where a chunk has at most 16
//    members); their true maximum, exp and sum; beta; rf_k and beta rounded
//    to bf16 and written into every block's chunk rows [C][D+8].  Owning a
//    chunk by its first token keeps about three quarters of the members'
//    reads in the block at the DeiT-tiny-p8 shape.  (Phase 1 from block-local
//    partial sums merged by owners took four barriers with a remote round
//    trip after each and measured slower; PERF.md.)
//  * phase 2 on K1's forward strip design (eva_packed.cu): a warp owns a
//    strip of 16 query rows of a window and computes its logits as mma.sync
//    accumulator fragments, 16 key columns [k | rf_k] at a time
//    (eva_strip::fwd_logits_tile, base 2, the bias on the window columns,
//    -inf past S + C, rows past the end reading the last real row); one pass
//    where S + C <= 112, two above; the quad's row max, then
//    eva_strip::fwd_pv_tile (numerators rounded to bf16 as the A operand,
//    f32 sums); the strip's rows divided by the denominator, rounded, staged
//    in the strip's own q rows and stored 16 bytes a thread.  No logit matrix
//    in shared memory: 76,288 bytes at the DeiT-tiny-p8 shape (cluster 8, two
//    windows a block), three blocks an SM.  mma.sync and cp.async only: no
//    wgmma or TMA.
// A cluster takes the most windows a block, among blocks of two windows or
// more first, that still leave three blocks an SM, else two (plan() in the
// wrapper): a block's strips share phase 1's fixed cost.
//
// Built with -DEVA_SINGLE_PHASES (scripts/torch_eva_single_phases.py), the
// tensor-core kernel records, from thread 0 of each block, clock64() at its
// phase boundaries into g_phases[0..7][block] and the global timer at the
// block's start and end into g_phases[8] and [9]; eva_single_phases_copy
// reads them back.  Without it the marks compile to nothing.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "eva_strip.cuh"
#include "mma_frag.cuh"

namespace cg = cooperative_groups;

#ifdef EVA_SINGLE_PHASES
constexpr int kPhaseBlocks = 16384;
__device__ unsigned long long g_phases[10][kPhaseBlocks];
__device__ __forceinline__ void phase_store(int mark, unsigned long long t) {
  const unsigned blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (threadIdx.x == 0 && blk < kPhaseBlocks) g_phases[mark][blk] = t;
}
__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_MARK(k) phase_store((k), clock64())
#define PHASE_TIMER(k) phase_store((k), global_timer())
#define PHASE_END() (__syncthreads(), PHASE_MARK(7), PHASE_TIMER(9))
#else
#define PHASE_MARK(k) ((void)0)
#define PHASE_TIMER(k) ((void)0)
#define PHASE_END() ((void)0)
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-6f;

struct Params {
  const void* qkv;     // [B, N, 3*nh*D], T
  void* out;           // [B, N, nh*D], T
  const float* wq;     // [D, D] (in, out)
  const float* bq;     // [D]
  const float* wk;
  const float* bk;
  const float* lnq_s;  // [D], null unless use_ln
  const float* lnq_b;
  const float* lnk_s;
  const float* lnk_b;
  const float* bias;   // [nh, S, S] or null
  int B, N, gw, ws, j, nh;
  int C, wc;           // chunks, chunks per grid row
  int S;               // tokens per window
  int nww;             // windows per grid row
  int CS;              // cluster size (blocks per (image, head))
  int wpb;             // windows per block
  int T;               // tokens per block
  int CO;              // chunks summarised per block (at most)
  int OC;              // chunks a block owns (at most; tensor-core route)
  int use_ln;
  float scale;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

struct Layout {
  size_t tok, rf_all, beta_all, rf_own, beta_own, bias, scratch, total;
};

// The same layout as smem_bytes() in ops/kernels/eva_single.py.
__host__ __device__ inline Layout make_layout(int T, int D, int esize, int C,
                                              int CO, int S) {
  Layout L;
  size_t o = 0;
  L.tok = o;      o += align16((size_t)T * 3 * D * esize);
  L.rf_all = o;   o += align16((size_t)C * D * 4);
  L.beta_all = o; o += align16((size_t)C * D * 4);
  L.rf_own = o;   o += align16((size_t)CO * D * 4);
  L.beta_own = o; o += align16((size_t)CO * D * 4);
  L.bias = o;     o += align16((size_t)S * S * 4);
  L.scratch = o;  o += align16((size_t)kWarps * 2 * D * 4);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows of D elements are read 16 bytes at a time where a row is a whole
// number of 16-byte vectors (rows then start 16-byte aligned), else one
// element at a time.
template <int D, typename T>
struct Row {
  static constexpr int kPer = 16 / sizeof(T);  // elements per 16 bytes
  static constexpr bool kVec = D % kPer == 0;

  // sum_i a[i] * row[i], over four partial sums so the FMAs do not wait on
  // one another
  __device__ __forceinline__ static float dot(const float (&a)[D], const T* row) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kVec) {
      const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
      for (int i = 0; i < D / kPer; ++i) {
        uint4 u = r4[i];
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int t = 0; t < kPer; ++t)
          s[(i * kPer + t) & 3] = fmaf(a[i * kPer + t], to_f(e[t]), s[(i * kPer + t) & 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < D; ++i) s[i & 3] = fmaf(a[i], to_f(row[i]), s[i & 3]);
    }
    return (s[0] + s[1]) + (s[2] + s[3]);
  }

  // acc += p * row
  __device__ __forceinline__ static void axpy(float (&acc)[D], float p, const T* row) {
    if constexpr (kVec) {
      const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
      for (int i = 0; i < D / kPer; ++i) {
        uint4 u = r4[i];
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int t = 0; t < kPer; ++t) acc[i * kPer + t] = fmaf(p, to_f(e[t]), acc[i * kPer + t]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] = fmaf(p, to_f(row[i]), acc[i]);
    }
  }
};

// One step of an online softmax: fold logit l with value row v into the
// running max mx, denominator den and weighted sum acc.  The running sums are
// rescaled only when the max grows.
template <int D, typename T>
__device__ __forceinline__ void softmax_step(float (&acc)[D], float& den, float& mx,
                                             float l, const T* v) {
  if (l > mx) {
    const float corr = __expf(mx - l);  // 0 on the first step (mx = -inf)
    den *= corr;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] *= corr;
    mx = l;
  }
  const float e = __expf(l - mx);
  den += e;
  Row<D, T>::axpy(acc, e, v);
}

// Global token index of slot `slot` of block `rank` (slots are in window order).
__device__ __forceinline__ int slot_token(const Params& p, int rank, int slot) {
  const int w = rank * p.wpb + slot / p.S, l = slot % p.S;
  const int y = (w / p.nww) * p.ws + l / p.ws;
  const int x = (w % p.nww) * p.ws + l % p.ws;
  return y * p.gw + x;
}

// Owner block and slot of grid token (y, x).
__device__ __forceinline__ void token_home(const Params& p, int y, int x, int& rank,
                                           int& slot) {
  const int w = (y / p.ws) * p.nww + x / p.ws;
  rank = w / p.wpb;
  slot = (w % p.wpb) * p.S + (y % p.ws) * p.ws + (x % p.ws);
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

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) eva_single_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout L = make_layout(p.T, D, sizeof(T), p.C, p.CO, p.S);
  T* tok = reinterpret_cast<T*>(smem + L.tok);  // [T][3][D]: q, k, v rows
  float* rf_all = reinterpret_cast<float*>(smem + L.rf_all);      // [C][D]
  float* beta_all = reinterpret_cast<float*>(smem + L.beta_all);  // [C][D]
  float* rf_own = reinterpret_cast<float*>(smem + L.rf_own);      // [CO][D]
  float* beta_own = reinterpret_cast<float*>(smem + L.beta_own);  // [CO][D]
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);        // [S][S]
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);    // [warps][2][D]

  const int HD = p.nh * D;
  const T* qkv = static_cast<const T*>(p.qkv) + (size_t)b * p.N * 3 * HD;

  // ---- load this block's q/k/v rows of head h, and the head's bias
  if constexpr (Row<D, T>::kVec) {
    constexpr int kPer = Row<D, T>::kPer, kVecs = D / kPer;
    uint4* dst = reinterpret_cast<uint4*>(tok);
    for (int e = tid; e < p.T * 3 * kVecs; e += kThreads) {
      const int v = e % kVecs, r = e / kVecs, part = r % 3, slot = r / 3;
      const T* src = qkv + (size_t)slot_token(p, rank, slot) * 3 * HD + (part * p.nh + h) * D;
      dst[e] = reinterpret_cast<const uint4*>(src)[v];
    }
  } else {
    for (int e = tid; e < p.T * 3 * D; e += kThreads) {
      const int dd = e % D, r = e / D, part = r % 3, slot = r / 3;
      tok[e] = qkv[(size_t)slot_token(p, rank, slot) * 3 * HD + (part * p.nh + h) * D + dd];
    }
  }
  if (p.bias != nullptr) {
    const float* bh = p.bias + (size_t)h * p.S * p.S;
    for (int e = tid; e < p.S * p.S; e += kThreads) bias_s[e] = bh[e];
  }
  cluster.sync();

  // ---- phase 1: summaries of chunks c = rank, rank + CS, ...; a warp each
  constexpr int DPL = (D + 31) / 32;  // dims per lane
  const float dn = 1.f / sqrtf((float)D);
  const int jj = p.j * p.j;
  float* mean_q = scratch + warp * 2 * D;
  float* mean_k = mean_q + D;
  for (int co = warp; co < p.CO; co += kWarps) {
    const int c = co * p.CS + rank;
    if (c >= p.C) break;
    const int y0 = (c / p.wc) * p.j, x0 = (c % p.wc) * p.j;
    float sq[DPL], sk[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) sq[i] = sk[i] = 0.f;
    for (int m = 0; m < jj; ++m) {
      int home, slot;
      token_home(p, y0 + m / p.j, x0 + m % p.j, home, slot);
      const T* row = cluster.map_shared_rank(tok, home) + (size_t)slot * 3 * D;
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
    for (int i = 0; i < DPL; ++i) {
      mu[i] = 0.5f * (rq[i] + rk[i]);
      const int dd = lane + 32 * i;
      if (dd < D) rf_own[co * D + dd] = rk[i];
    }
    // online softmax over the chunk's members: shifted by the running max
    float mx = -INFINITY, den = 0.f, pv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) pv[i] = 0.f;
    for (int m = 0; m < jj; ++m) {
      int home, slot;
      token_home(p, y0 + m / p.j, x0 + m % p.j, home, slot);
      const T* row = cluster.map_shared_rank(tok, home) + (size_t)slot * 3 * D;
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
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) beta_own[co * D + dd] = pv[i] / den;
    }
  }
  cluster.sync();

  // ---- gather every chunk's rf_k and beta from the block that made it
  for (int e = tid; e < p.C * D; e += kThreads) {
    const int c = e / D, dd = e % D;
    const int home = c % p.CS, co = c / p.CS;
    rf_all[e] = cluster.map_shared_rank(rf_own, home)[co * D + dd];
    beta_all[e] = cluster.map_shared_rank(beta_own, home)[co * D + dd];
  }
  cluster.sync();  // no block may exit while another still reads its memory

  // ---- phase 2: joint softmax, one thread per query
  T* out = static_cast<T*>(p.out) + (size_t)b * p.N * HD + h * D;
  for (int slot = tid; slot < p.T; slot += kThreads) {
    const int wloc = slot / p.S, qi = slot % p.S;
    float q[D], acc[D];
    {
      const T* qrow = tok + (size_t)slot * 3 * D;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        q[i] = to_f(qrow[i]) * p.scale;
        acc[i] = 0.f;
      }
    }
    float mx = -INFINITY, den = 0.f;
    const T* win = tok + (size_t)wloc * p.S * 3 * D;
    const float* brow = p.bias != nullptr ? bias_s + qi * p.S : nullptr;
    for (int kk = 0; kk < p.S; ++kk) {
      const T* krow = win + (size_t)kk * 3 * D + D;
      float l = Row<D, T>::dot(q, krow);
      if (brow != nullptr) l += brow[kk];
      softmax_step<D, T>(acc, den, mx, l, krow + D);
    }
    for (int c = 0; c < p.C; ++c) {
      const float l = Row<D, float>::dot(q, rf_all + c * D);
      softmax_step<D, float>(acc, den, mx, l, beta_all + c * D);
    }
    const float inv = 1.f / den;
    T* orow = out + (size_t)slot_token(p, rank, slot) * HD;
#pragma unroll
    for (int i = 0; i < D; ++i) orow[i] = from_f<T>(acc[i] * inv);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core route (bf16, uses_mma): the design is in the header comment.

// The chunks whose first token lies in window w: chunk rows cy0 .. cy1 - 1
// and columns cx0 .. cx1 - 1.  Each chunk is owned by the block that holds
// its first token.
struct OwnRect {
  int cy0, cy1, cx0, cx1;
};

__host__ __device__ inline OwnRect own_rect(int w, int nww, int ws, int j) {
  const int wy = (w / nww) * ws, wx = (w % nww) * ws;
  OwnRect r;
  r.cy0 = (wy + j - 1) / j;
  r.cy1 = (wy + ws + j - 1) / j;
  r.cx0 = (wx + j - 1) / j;
  r.cx1 = (wx + ws + j - 1) / j;
  return r;
}

// The most chunks a block of the cluster owns.
__host__ __device__ inline int owned_chunks(int CS, int wpb, int nww, int ws, int j) {
  int most = 0;
  for (int r = 0; r < CS; ++r) {
    int n = 0;
    for (int w = r * wpb; w < r * wpb + wpb; ++w) {
      const OwnRect o = own_rect(w, nww, ws, j);
      n += (o.cy1 - o.cy0) * (o.cx1 - o.cx0);
    }
    if (n > most) most = n;
  }
  return most;
}

constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;

using bf16 = __nv_bfloat16;

__host__ __device__ inline bool uses_mma(int D, int itemsize) {
  return itemsize == 2 && (D == 16 || D == 32 || D == 64);
}

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Offsets (bytes) of the tensor-core route's shared memory; the same layout
// as mma_smem_bytes() in ops/kernels/eva_single.py.  bf16: the block's q, k
// and v rows [T][D+8], the chunk rows rf_k and beta [C][D+8]; f32: the bias
// [S][S]; int32: the token table [T]; the owned chunks' indices [CO];
// uint16: their members [CO][j*j] (rank << 12 | slot); f32: their means
// [CO][2][D], rf_q then mu and rf_k [CO][D] each, a warp's member weights
// [4][2][j*j].
struct MmaLayout {
  size_t q, k, v, kc, vc, bias, tok, own, mem, mean, mu, rf, lw, total;
};

__host__ __device__ inline MmaLayout make_mma_layout(int D, int T, int S, int C, int CO,
                                                     int JJ) {
  const size_t DB = D + 8;
  MmaLayout L = {};
  size_t o = 0;
  L.q = o;     o += align128((size_t)T * DB * 2);
  L.k = o;     o += align128((size_t)T * DB * 2);
  L.v = o;     o += align128((size_t)T * DB * 2);
  L.kc = o;    o += align128((size_t)C * DB * 2);
  L.vc = o;    o += align128((size_t)C * DB * 2);
  L.bias = o;  o += align128((size_t)S * S * 4);
  L.tok = o;   o += align128((size_t)T * 4);
  L.own = o;   o += align128((size_t)CO * 4);
  L.mem = o;   o += align128((size_t)CO * JJ * 2);
  L.mean = o;  o += align128((size_t)CO * 2 * D * 4);
  L.mu = o;    o += align128((size_t)CO * D * 4);
  L.rf = o;    o += align128((size_t)CO * D * 4);
  L.lw = o;    o += align128((size_t)kMmaWarps * 2 * JJ * 4);
  L.total = o;
  return L;
}

// 4 bytes global -> shared, asynchronously (the 16-byte copies bypass L1;
// a copy this small goes through it); complete after cp_async_wait_all.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(mma_frag::smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ float2 ld_bf2(const bf16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Strip st (query rows 16 st .. 16 st + 15) of a window: its q rows qs, its
// keys kw | kc and values vw | vc ([.][D+8] bf16 each), the bias bias_s
// [S][S] in base 2; row i < S of the output goes to out + tok[i] * HD.  The
// strip body of K1's eva_packed_fwd_mma_kernel (eva_packed.cu), on the tiles
// both share (eva_strip.cuh).  kOnePass: eva_strip::one_pass(S, C).
template <int D, bool kOnePass>
__device__ __forceinline__ void single_strip(const Params& p, int st, bf16* qs,
                                             const bf16* kw, const bf16* vw, const bf16* kc,
                                             const bf16* vc, const float* bias_s,
                                             const int* tok, bf16* out, int HD) {
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
    *reinterpret_cast<uint4*>(out + (size_t)tok[i] * HD + 8 * v) =
        *reinterpret_cast<const uint4*>(qs + i * DB + 8 * v);
  }
}

// LayerNorm of two rows of D values a warp holds, DPL per lane
// (lane-strided), their reductions interleaved.
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

// The owned chunks' summaries of the tensor-core route, between its two
// cluster barriers: their members' rows read where they lie in the cluster,
// through distributed shared memory unless in this block; rf_k and beta
// rounded to bf16 into every block's chunk rows.
template <int D>
__device__ __forceinline__ void mma_summaries(const Params& p, unsigned char* smem, int rank,
                                           int n_own) {
  using namespace mma_frag;
  constexpr int DB = D + 8, V8 = D / 8, NP = D / 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int CS = p.CS, JJ = p.j * p.j;
  const MmaLayout L = make_mma_layout(D, p.T, p.S, p.C, p.OC, JJ);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L.q);              // [T][DB]
  bf16* k_s = reinterpret_cast<bf16*>(smem + L.k);              // [T][DB]
  bf16* v_s = reinterpret_cast<bf16*>(smem + L.v);              // [T][DB]
  bf16* kc = reinterpret_cast<bf16*>(smem + L.kc);              // [C][DB]: rf_k
  bf16* vc = reinterpret_cast<bf16*>(smem + L.vc);              // [C][DB]: beta
  const int* own = reinterpret_cast<const int*>(smem + L.own);  // [OC]
  const unsigned short* mem = reinterpret_cast<const unsigned short*>(smem + L.mem);
  float* mean = reinterpret_cast<float*>(smem + L.mean);        // [OC][2][D]
  float* mu = reinterpret_cast<float*>(smem + L.mu);            // [OC][D]
  float* rf = reinterpret_cast<float*>(smem + L.rf);            // [OC][D]
  float* lw = reinterpret_cast<float*>(smem + L.lw) + warp * 2 * JJ;  // [2][JJ]
  const float dn = 1.f / sqrtf((float)D);

  // the q and k sums and means, a warp a chunk
  auto rows_of = [&](bf16* base, int r) -> const bf16* {
    return r == rank ? base : cluster.map_shared_rank(base, r);
  };
  const float inv_jj = 1.f / (float)JJ;
  for (int co = warp; co < n_own; co += kMmaWarps) {
    const unsigned short* ml = mem + co * JJ;
    float2 sq = make_float2(0.f, 0.f), sk = make_float2(0.f, 0.f);
    if (lane < NP) {
#pragma unroll 8
      for (int m = 0; m < JJ; ++m) {
        const int e = ml[m], off = (e & 4095) * DB + 2 * lane;
        const float2 a = ld_bf2(rows_of(q_s, e >> 12) + off);
        const float2 c2 = ld_bf2(rows_of(k_s, e >> 12) + off);
        sq.x += a.x; sq.y += a.y;
        sk.x += c2.x; sk.y += c2.y;
      }
      *reinterpret_cast<float2*>(mean + co * 2 * D + 2 * lane) =
          make_float2(sq.x * inv_jj, sq.y * inv_jj);
      *reinterpret_cast<float2*>(mean + co * 2 * D + D + 2 * lane) =
          make_float2(sk.x * inv_jj, sk.y * inv_jj);
    }
  }
  __syncthreads();
  PHASE_MARK(3);
  // the adaptive Dense: a thread per output column of rf_q (into mu) or rf_k
  // (into rf), over the owned chunks 8 at a time
  constexpr int G = kMmaThreads / (2 * D);  // thread groups over the owned chunks
  const int col = tid % (2 * D), grp = tid / (2 * D);
  const int which = col / D, o = col % D;
  const float bo = which ? p.bk[o] : p.bq[o];
  const float* W = (which ? p.wk : p.wq) + o;
  for (int c0 = grp; c0 < n_own; c0 += 8 * G) {
    float acc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[u] = bo;
#pragma unroll 4
    for (int i4 = 0; i4 < D / 4; ++i4) {
      float wcol4[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) wcol4[t] = __ldg(W + (4 * i4 + t) * D);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int co = c0 + u * G;
        if (co < n_own) {
          const float4 m4 =
              *reinterpret_cast<const float4*>(mean + co * 2 * D + which * D + 4 * i4);
          acc[u] = fmaf(m4.x, wcol4[0], acc[u]);
          acc[u] = fmaf(m4.y, wcol4[1], acc[u]);
          acc[u] = fmaf(m4.z, wcol4[2], acc[u]);
          acc[u] = fmaf(m4.w, wcol4[3], acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int co = c0 + u * G;
      if (co < n_own) (which ? rf : mu)[co * D + o] = acc[u];
    }
  }
  __syncthreads();
  PHASE_MARK(4);
  // LN of rf_q and rf_k and mu = (rf_q + rf_k) / 2, a warp a chunk
  {
    constexpr int DPL = (D + 31) / 32;
    for (int co = warp; co < n_own; co += kMmaWarps) {
      float rq[DPL], rk[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        rq[i] = dd < D ? mu[co * D + dd] : 0.f;
        rk[i] = dd < D ? rf[co * D + dd] : 0.f;
      }
      if (p.use_ln) warp_layer_norm2<D, DPL>(rq, p.lnq_s, p.lnq_b, rk, p.lnk_s, p.lnk_b, lane);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        if (dd < D) {
          mu[co * D + dd] = 0.5f * (rq[i] + rk[i]);
          rf[co * D + dd] = rk[i];
        }
      }
    }
  }
  __syncwarp();
  // the members' logits <mu,k>/sqrt(d) - |k|^2/(2 sqrt(d)) in f32, a lane a
  // member (with at most 16 members a chunk, each half warp one of the two
  // chunks); their true max, exp and sum; beta = sum of exp v / sum, a lane
  // a dimension pair; rf_k and beta rounded to bf16 into every block's chunk
  // rows
  const bool halves = JJ <= 16;
  for (int co = warp; co < n_own; co += 2 * kMmaWarps) {
    const bool two = co + kMmaWarps < n_own;
    float* lwb = lw + JJ;  // chunk b's weights
    float mxa = -INFINITY, mxb = -INFINITY;
    for (int i = 0; i < (halves ? 1 : 2); ++i) {
      // a lane's member and chunk: halves, lanes 0-15 chunk a and 16-31 b
      const int part = halves ? lane >> 4 : i;
      if (part == 1 && !two) continue;
      const int cc = co + part * kMmaWarps;
      const unsigned short* ml = mem + cc * JJ;
      const float4* mr = reinterpret_cast<const float4*>(mu + cc * D);
      float* lwc = part ? lwb : lw;
      for (int m = halves ? lane & 15 : lane; m < JJ; m += halves ? 16 : 32) {
        const int e = ml[m];
        const uint4* kr = reinterpret_cast<const uint4*>(rows_of(k_s, e >> 12) + (e & 4095) * DB);
        float dot[2] = {0.f, 0.f}, nrm[2] = {0.f, 0.f};
#pragma unroll 2
        for (int t = 0; t < V8; ++t) {
          const uint4 ut = kr[t];
          const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&ut);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float4 m4 = mr[2 * t + hh];
            const float2 k0 = __bfloat1622float2(e2[2 * hh]);
            const float2 k1 = __bfloat1622float2(e2[2 * hh + 1]);
            dot[hh] =
                fmaf(m4.x, k0.x, fmaf(m4.y, k0.y, fmaf(m4.z, k1.x, fmaf(m4.w, k1.y, dot[hh]))));
            nrm[hh] =
                fmaf(k0.x, k0.x, fmaf(k0.y, k0.y, fmaf(k1.x, k1.x, fmaf(k1.y, k1.y, nrm[hh]))));
          }
        }
        const float l = dn * (dot[0] + dot[1]) - 0.5f * dn * (nrm[0] + nrm[1]);
        lwc[m] = l;
        if (part) mxb = fmaxf(mxb, l);
        else mxa = fmaxf(mxa, l);
      }
    }
    // the maxima and sums: over each half warp, or over the warp per chunk
    float suma, sumb;
    if (halves) {
      float m0 = lane < 16 ? mxa : mxb;
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o2));
      float s0 = 0.f;
      if ((lane & 15) < JJ && (lane < 16 || two)) {
        float* lwc = lane < 16 ? lw : lwb;
        const float x = expf(lwc[lane & 15] - m0);
        lwc[lane & 15] = x;
        s0 = x;
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) s0 += __shfl_xor_sync(0xffffffffu, s0, o2);
      suma = __shfl_sync(0xffffffffu, s0, 0);
      sumb = __shfl_sync(0xffffffffu, s0, 16);
    } else {
      mxa = warp_max(mxa);
      mxb = warp_max(mxb);
      float sa = 0.f, sb = 0.f;
      for (int m = lane; m < JJ; m += 32) {
        const float x = expf(lw[m] - mxa);
        lw[m] = x;
        sa += x;
        if (two) {
          const float y = expf(lwb[m] - mxb);
          lwb[m] = y;
          sb += y;
        }
      }
      suma = warp_sum(sa);
      sumb = warp_sum(sb);
    }
    __syncwarp();
    if (lane < NP) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && !two) break;
        const int cc = co + i * kMmaWarps, c = own[cc];
        const unsigned short* ml = mem + cc * JJ;
        const float* lwc = i ? lwb : lw;
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll 8
        for (int m = 0; m < JJ; ++m) {
          const int e = ml[m];
          const float x = lwc[m];
          const float2 vv = ld_bf2(rows_of(v_s, e >> 12) + (e & 4095) * DB + 2 * lane);
          acc.x = fmaf(x, vv.x, acc.x);
          acc.y = fmaf(x, vv.y, acc.y);
        }
        const float den = i ? sumb : suma;
        const uint32_t kbits = pack_bf16(rf[cc * D + 2 * lane], rf[cc * D + 2 * lane + 1]);
        const uint32_t vbits = pack_bf16(acc.x / den, acc.y / den);
        for (int r = 0; r < CS; ++r) {
          *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(kc, r) + c * DB + 2 * lane) =
              kbits;
          *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(vc, r) + c * DB + 2 * lane) =
              vbits;
        }
      }
    }
    __syncwarp();  // lw is rewritten for the warp's next chunks
  }
}

// The tensor-core route (bf16, D 16, 32 or 64): the design is in the header
// comment.  A cluster of CS blocks takes one (image, head); block `rank`
// holds windows rank * wpb .. rank * wpb + wpb - 1 and owns the chunks whose
// first token it holds.  A lane of a phase-1 warp owns the dimension pair
// 2 lane, 2 lane + 1 (lanes past D / 2 idle there) or, for the logits, a
// member.  kOnePass: eva_strip::one_pass(S, C), a strip's logits stay in
// registers between the row max and their use.
template <int D, bool kOnePass>
__global__ void __launch_bounds__(kMmaThreads, 3) eva_single_mma_kernel(const Params p) {
  using namespace mma_frag;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int DB = D + 8, V8 = D / 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int S = p.S, T = p.T, HD = p.nh * D, JJ = p.j * p.j;
  const MmaLayout L = make_mma_layout(D, T, S, p.C, p.OC, JJ);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L.q);              // [T][DB]
  bf16* k_s = reinterpret_cast<bf16*>(smem + L.k);              // [T][DB]
  bf16* v_s = reinterpret_cast<bf16*>(smem + L.v);              // [T][DB]
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);      // [S][S]
  int* tok = reinterpret_cast<int*>(smem + L.tok);              // [T]
  int* own = reinterpret_cast<int*>(smem + L.own);              // [OC]
  unsigned short* mem = reinterpret_cast<unsigned short*>(smem + L.mem);  // [OC][JJ]
  const bf16* qkv = static_cast<const bf16*>(p.qkv) + (size_t)b * p.N * 3 * HD + h * D;
  const float* bh = p.bias != nullptr ? p.bias + (size_t)h * S * S : nullptr;
  int n_own = 0;  // the chunks whose first token this block holds
  for (int w = rank * p.wpb; w < rank * p.wpb + p.wpb; ++w) {
    const OwnRect r = own_rect(w, p.nww, p.ws, p.j);
    n_own += (r.cy1 - r.cy0) * (r.cx1 - r.cx0);
  }

  PHASE_TIMER(8);
  PHASE_MARK(0);
  // ---- staging: the token table, then the q, k, v rows and the bias
  // (cp.async, the bias scaled to base 2 once landed); meanwhile the owned
  // chunks and their members (rank, slot)
  for (int t = tid; t < T; t += kMmaThreads) tok[t] = slot_token(p, rank, t);
  __syncthreads();
  for (int e = tid; e < T * 3 * V8; e += kMmaThreads) {
    const int v = e % V8, part = (e / V8) % 3, slot = e / (3 * V8);
    bf16* dst = part == 0 ? q_s : part == 1 ? k_s : v_s;
    cp_async16(dst + slot * DB + 8 * v, qkv + (size_t)tok[slot] * 3 * HD + part * HD + 8 * v);
  }
  if (bh != nullptr)
    for (int e = tid; e < S * S; e += kMmaThreads) cp_async4(bias_s + e, bh + e);
  cp_async_commit();
  if (tid == 0) {
    int n = 0;
    for (int w = rank * p.wpb; w < rank * p.wpb + p.wpb; ++w) {
      const OwnRect r = own_rect(w, p.nww, p.ws, p.j);
      for (int cy = r.cy0; cy < r.cy1; ++cy)
        for (int cx = r.cx0; cx < r.cx1; ++cx) own[n++] = cy * p.wc + cx;
    }
  }
  __syncthreads();
  for (int e = tid; e < n_own * JJ; e += kMmaThreads) {
    const int c = own[e / JJ], m = e % JJ;
    int home, slot;
    token_home(p, (c / p.wc) * p.j + m / p.j, (c % p.wc) * p.j + m % p.j, home, slot);
    mem[e] = (unsigned short)(home << 12 | slot);
  }
  cp_async_wait_all();
  for (int e = tid; e < S * S; e += kMmaThreads)  // this thread's own copies
    bias_s[e] = bh != nullptr ? eva_strip::kLog2e * bias_s[e] : 0.f;
  PHASE_MARK(1);
  cluster.sync();  // #1: every block's rows are in place
  PHASE_MARK(2);

  // ---- phase 1: the owned chunks' summaries
  mma_summaries<D>(p, smem, rank, n_own);
  PHASE_MARK(5);
  cluster.sync();  // #2: every block's chunk rows are in place; from here on
                   // no block touches another's memory
  PHASE_MARK(6);

  // ---- phase 2: the joint softmax, a warp a strip of 16 query rows
  const bf16* kc = reinterpret_cast<const bf16*>(smem + L.kc);  // [C][DB]: rf_k
  const bf16* vc = reinterpret_cast<const bf16*>(smem + L.vc);  // [C][DB]: beta
  const int NS = (S + 15) / 16;
  bf16* out = static_cast<bf16*>(p.out) + (size_t)b * p.N * HD + h * D;
  for (int idx = warp; idx < p.wpb * NS; idx += kMmaWarps) {
    const int wl = idx / NS, st = idx % NS;
    single_strip<D, kOnePass>(p, st, q_s + wl * S * DB, k_s + wl * S * DB, v_s + wl * S * DB,
                              kc, vc, bias_s, tok + wl * S, out, HD);
  }
  PHASE_END();
}

// The tensor-core kernel of a geometry (one pass where a strip's tiles fit
// the registers).
template <int D>
auto mma_kernel(int S, int C) {
  return eva_strip::one_pass(S, C) ? eva_single_mma_kernel<D, true>
                                   : eva_single_mma_kernel<D, false>;
}

inline size_t mma_smem(int D, const Params& p) {
  return make_mma_layout(D, p.T, p.S, p.C, p.OC, p.j * p.j).total;
}

template <int D>
cudaError_t prepare_mma(const Params& p) {
  const auto kernel = mma_kernel<D>(p.S, p.C);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mma_smem(D, p));
  if (err != cudaSuccess) return err;
  if (p.CS > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  cudaError_t err = prepare_mma<D>(p);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.CS, p.nh, p.B);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = mma_smem(D, p);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mma_kernel<D>(p.S, p.C), p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Blocks of the tensor-core kernel that fit one SM (registers and shared
// memory), from the occupancy calculator, or -1.
template <int D>
int mma_blocks_per_sm(const Params& p) {
  int blocks = 0;
  if (prepare_mma<D>(p) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mma_kernel<D>(p.S, p.C),
                                                    kMmaThreads, mma_smem(D, p)) !=
          cudaSuccess)
    return -1;
  return blocks;
}

template <int D, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const Layout L = make_layout(p.T, D, sizeof(T), p.C, p.CO, p.S);
  auto kernel = eva_single_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.CS, p.nh, p.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const Params& p, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch<D, __nv_bfloat16>(p, stream) : launch<D, float>(p, stream);
}

// The geometry fields of p (grid gh x gw = N / gw, windows ws x ws, chunks
// j x j, clusters of `cluster` blocks); false where the kernels cannot take
// it.
bool make_geometry(Params& p, int B, int N, int gw, int ws, int j, int nh, int cluster) {
  if (B <= 0 || N <= 0 || gw <= 0 || ws <= 0 || j <= 0 || nh <= 0 || cluster <= 0 ||
      cluster > 16 || N % gw)
    return false;
  const int gh = N / gw;
  if (gh % ws || gw % ws || gh % j || gw % j) return false;
  p.B = B; p.N = N; p.gw = gw; p.ws = ws; p.j = j; p.nh = nh;
  p.wc = gw / j;
  p.C = (gh / j) * p.wc;
  p.S = ws * ws;
  p.nww = gw / ws;
  const int n_win = (gh / ws) * p.nww;
  if (n_win % cluster) return false;
  p.CS = cluster;
  p.wpb = n_win / cluster;
  p.T = p.wpb * p.S;
  p.CO = (p.C + cluster - 1) / cluster;
  p.OC = owned_chunks(cluster, p.wpb, p.nww, ws, j);
  return true;
}

}  // namespace

extern "C" {

// Shared memory of one block of the CUDA-core route, for the wrapper's gate
// to check its own copy of the layout against.
int eva_single_smem_bytes(int tokens, int d, int esize, int chunks, int own_chunks,
                          int ws) {
  return (int)make_layout(tokens, d, esize, chunks, own_chunks, ws * ws).total;
}

// Whether bf16 (itemsize 2) or f32 (4) at head dim d takes the tensor-core
// route (uses_mma in ops/kernels/eva_single.py).
int eva_single_uses_mma(int d, int itemsize) { return uses_mma(d, itemsize) ? 1 : 0; }

// Shared memory of one block of the tensor-core route at grid gh x gw,
// windows ws, chunks j, head dim d and cluster size `cluster` (the wrapper's
// mma_smem_bytes), or -1.
int eva_single_mma_smem_bytes(int gh, int gw, int ws, int j, int d, int cluster) {
  Params p = {};
  if (!make_geometry(p, 1, gh * gw, gw, ws, j, 1, cluster)) return -1;
  return (int)mma_smem(d, p);
}

// Blocks of the tensor-core kernel that fit one SM at that geometry, or -1.
int eva_single_mma_blocks_per_sm(int gh, int gw, int ws, int j, int d, int cluster) {
  Params p = {};
  if (!make_geometry(p, 1, gh * gw, gw, ws, j, 1, cluster)) return -1;
  switch (d) {
    case 16: return mma_blocks_per_sm<16>(p);
    case 32: return mma_blocks_per_sm<32>(p);
    case 64: return mma_blocks_per_sm<64>(p);
    default: return -1;
  }
}

#ifdef EVA_SINGLE_PHASES
// Copies g_phases ([10][16384] uint64) to host memory at dst; a cudaError_t.
int eva_single_phases_copy(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_phases, sizeof(g_phases));
}
#endif

const char* eva_single_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the CUDA-core kernel on `stream`; returns a cudaError_t (0 on
// success).
int eva_single_launch(const void* qkv, void* out, const float* wq, const float* bq,
                      const float* wk, const float* bk, const float* lnq_s,
                      const float* lnq_b, const float* lnk_s, const float* lnk_b,
                      const float* bias, int B, int N, int gw, int ws, int j, int nh,
                      int d, int cluster, int use_ln, int is_bf16, float scale,
                      void* stream) {
  Params p = {};
  if (!make_geometry(p, B, N, gw, ws, j, nh, cluster) || cluster > 8)
    return cudaErrorInvalidValue;
  if (use_ln && (!lnq_s || !lnq_b || !lnk_s || !lnk_b)) return cudaErrorInvalidValue;
  p.qkv = qkv; p.out = out;
  p.wq = wq; p.bq = bq; p.wk = wk; p.bk = bk;
  p.lnq_s = lnq_s; p.lnq_b = lnq_b; p.lnk_s = lnk_s; p.lnk_b = lnk_b;
  p.bias = bias;
  p.use_ln = use_ln;
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

// Launches the tensor-core kernel (bf16 qkv and output; d 16, 32 or 64;
// clusters of up to 16 blocks) on `stream`; returns a cudaError_t.
int eva_single_mma_launch(const void* qkv, void* out, const float* wq, const float* bq,
                          const float* wk, const float* bk, const float* lnq_s,
                          const float* lnq_b, const float* lnk_s, const float* lnk_b,
                          const float* bias, int B, int N, int gw, int ws, int j, int nh,
                          int d, int cluster, int use_ln, float scale, void* stream) {
  Params p = {};
  // a member is (rank << 12 | slot) in 16 bits
  if (!make_geometry(p, B, N, gw, ws, j, nh, cluster) || !uses_mma(d, 2) || p.T > 4096)
    return cudaErrorInvalidValue;
  if (use_ln && (!lnq_s || !lnq_b || !lnk_s || !lnk_b)) return cudaErrorInvalidValue;
  if (mma_smem(d, p) > 232448) return cudaErrorInvalidValue;
  p.qkv = qkv; p.out = out;
  p.wq = wq; p.bq = bq; p.wk = wk; p.bk = bk;
  p.lnq_s = lnq_s; p.lnq_b = lnq_b; p.lnk_s = lnk_s; p.lnk_b = lnk_b;
  p.bias = bias;
  p.use_ln = use_ln;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_mma<16>(p, s);
    case 32: return launch_mma<32>(p, s);
    case 64: return launch_mma<64>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
