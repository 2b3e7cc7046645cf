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
// Design.  qkv is read from device memory once, and the chunk summaries never
// leave the chip.  A thread-block cluster of CS blocks takes one (image, head);
// each block loads the q/k/v rows of its own windows (whole 7x7 windows, in
// window order) into shared memory.  Chunks (j x j tokens) do not line up with
// windows, so phase 1 reads a chunk's member rows wherever they are in the
// cluster, through distributed shared memory:
//   phase 1  block r summarises chunks c with c % CS == r: means of q and k,
//            the adaptive Dense (+LN) into rf_q, rf_k, mu = (rf_q + rf_k)/2,
//            and the per-chunk softmax of <mu,k>/sqrt(d) - |k|^2/(2 sqrt(d))
//            over the chunk's members, shifted by its true maximum, weighting
//            their values into beta.  One warp per chunk.
//   gather   every block copies all chunks' rf_k and beta into its own memory.
//   phase 2  one thread per query: an online softmax over its window's keys
//            (+ RPE bias) and the C chunk keys, values [window v | beta].
//            Phase 2's exponentials use the fast __expf (about 2 ulp near 0).
// All arithmetic is f32; the output is written in the input dtype.  This first
// version uses CUDA cores only: no wgmma, TMA or pipelining.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

}  // namespace

extern "C" {

// Shared memory of one block, for the wrapper's gate to check its own copy
// of the layout against.
int eva_single_smem_bytes(int tokens, int d, int esize, int chunks, int own_chunks,
                          int ws) {
  return (int)make_layout(tokens, d, esize, chunks, own_chunks, ws * ws).total;
}

const char* eva_single_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
int eva_single_launch(const void* qkv, void* out, const float* wq, const float* bq,
                      const float* wk, const float* bk, const float* lnq_s,
                      const float* lnq_b, const float* lnk_s, const float* lnk_b,
                      const float* bias, int B, int N, int gw, int ws, int j, int nh,
                      int d, int cluster, int use_ln, int is_bf16, float scale,
                      void* stream) {
  if (B <= 0 || N <= 0 || gw <= 0 || ws <= 0 || j <= 0 || nh <= 0 || cluster <= 0 ||
      N % gw)
    return cudaErrorInvalidValue;
  const int gh = N / gw;
  if (gh % ws || gw % ws || gh % j || gw % j) return cudaErrorInvalidValue;
  if (use_ln && (!lnq_s || !lnq_b || !lnk_s || !lnk_b)) return cudaErrorInvalidValue;
  Params p;
  p.qkv = qkv; p.out = out;
  p.wq = wq; p.bq = bq; p.wk = wk; p.bk = bk;
  p.lnq_s = lnq_s; p.lnq_b = lnq_b; p.lnk_s = lnk_s; p.lnk_b = lnk_b;
  p.bias = bias;
  p.B = B; p.N = N; p.gw = gw; p.ws = ws; p.j = j; p.nh = nh;
  p.wc = gw / j;
  p.C = (gh / j) * p.wc;
  p.S = ws * ws;
  p.nww = gw / ws;
  const int n_win = (gh / ws) * p.nww;
  if (n_win % cluster) return cudaErrorInvalidValue;
  p.CS = cluster;
  p.wpb = n_win / cluster;
  p.T = p.wpb * p.S;
  p.CO = (p.C + cluster - 1) / cluster;
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

}  // extern "C"
