// K6 performer_fused: FAVOR+ linear attention of the eval forward, one kernel.
//
// Replaces efficient_attention_tpu/ops/pallas/performer_fused.py::
// performer_attention_fused (_fwd, _kernel).  Plain version and wrapper:
// efficient_attention_torch/ops/kernels/performer_fused.py.
//
// Function.  qkv [B, N, 3*H*D] holds q, k, v side by side; w [H, m, D] is the
// random-feature projection.  For each (image, head): one key stabiliser s_k =
// max over (n, j) of <w_j, k_n>/d^1/4; key features k'[n, j] = m^-1/2
// exp(<w_j, k_n>/d^1/4 - |k_n|^2/(2 sqrt d) - s_k) + 1e-4; kv = k'^T v [m, D],
// z = sum_n k'; then per token the query features q' (stabilised by the
// token's own max over j) and out = q' kv / max(q' z, 1e-2).
//
// What bounds it: bytes.  At the DeiT-tiny-p8 serving shape (B=128, 28x28
// tokens, 3 heads of 64, m=64, bf16) it must read qkv (115.6 MB) and write the
// output (38.5 MB): ~46 us at 3.35 TB/s, against ~7.5 us for its 7.4 GFLOP
// (three products of N x m x D per image and head) at the bf16 tensor-core
// peak.
//
// Design.  The key stabiliser needs every key of a (image, head) before any
// feature, and kv and z need every feature before any query: one block takes
// one (image, head) and walks its tokens three times in tiles of 32 rows held
// in shared memory (f32): pass A finds s_k, pass B accumulates kv and z in
// shared memory, pass C combines the queries.  So k is read twice (pass A and
// B) and the feature tiles never leave the SM.  Products run on CUDA cores
// through smem_tile::tile_gemm (4x4 register tiles over rows padded to odd
// strides).  Roundings follow the TPU kernel: both operands of every product
// in the input type (the projection, k', q' and kv rounded first), z and the
// denominators f32 sums of the unrounded features, the output cast last.  No
// tensor cores, TMA or pipelining.  In bf16 two more kernels take the
// geometries whose head dims are multiples of 16: the ring route below
// (head dims 16, 32, 64; m % 16 == 0 up to 128) and, where it does not,
// the wmma kernel.
//
// Built with -DPERFORMER_PHASES (scripts/torch_performer_fused_check.py),
// the bf16 kernels sum, in thread 0 of each block, the SM cycles spent in
// each phase (kPhase*: each pass's staging, logits and the steps after them,
// and the kv reduction) and store them into g_performer_phases[0..12][block],
// the items the block took into [13] and the global timer at the block's
// start and end into [14] and [15]; performer_fused_phases_copy reads them
// back.  Without it the marks compile to nothing.
#include "mma_frag.cuh"
#include "smem_tile.cuh"

namespace {

using namespace smem_tile;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // token rows a block holds at once (TOKEN_TILE)
constexpr int kMaxAcc = 4;  // kv accumulator tiles a warp holds (MMA_MAX_ACC)
constexpr float kFeatEps = 1e-4f;
constexpr float kDenEps = 1e-2f;

enum Phase {
  kPhaseAStage, kPhaseALogits, kPhaseAMax,
  kPhaseBStage, kPhaseBLogits, kPhaseBFeatures, kPhaseBProducts,
  kPhaseCStage, kPhaseCLogits, kPhaseCFeatures, kPhaseCProducts, kPhaseCWrites,
  kPhaseReduce, kPhases
};

#ifdef PERFORMER_PHASES
constexpr int kPhaseBlocks = 16384;
__device__ unsigned long long g_performer_phases[kPhases + 3][kPhaseBlocks];
struct PhaseClock {
  unsigned acc[kPhases];
  unsigned last;
  unsigned long long t0;
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < kPhases; ++i) acc[i] = 0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    last = (unsigned)clock();
  }
  __device__ __forceinline__ void mark(int k) {
    const unsigned t = (unsigned)clock();
    acc[k] += t - last;
    last = t;
  }
  __device__ __forceinline__ void finish(int items) {
    const unsigned blk = blockIdx.x + gridDim.x * blockIdx.y;
    if (threadIdx.x != 0 || blk >= kPhaseBlocks) return;
    unsigned long long t1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
#pragma unroll
    for (int i = 0; i < kPhases; ++i) g_performer_phases[i][blk] = acc[i];
    g_performer_phases[kPhases][blk] = items;
    g_performer_phases[kPhases + 1][blk] = t0;
    g_performer_phases[kPhases + 2][blk] = t1;
  }
};
#else
struct PhaseClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void finish(int) {}
};
#endif

struct Params {
  const void* qkv;  // [B, N, 3*nh*d], T
  const float* w;   // [nh, m, d]
  void* out;        // [B, N, nh*d], T
  int B, N, nh, d, m;
  float dn4;        // d^-1/4
  float half;       // 1 / (2 sqrt d)
  float ratio;      // m^-1/2
};

// Offsets (bytes) of the shared-memory regions; the same layout as
// smem_bytes() in ops/kernels/performer_fused.py.
struct Layout {
  size_t W, KV, X, V, F, z, diag, den, red, total;
};

__host__ __device__ inline Layout make_layout(int d, int m) {
  const size_t DP = d + 1, MP = m + 1;
  Layout L = {};
  size_t o = 0;
  L.W = o;    o += align16(m * DP * 4);
  L.KV = o;   o += align16(m * DP * 4);
  L.X = o;    o += align16(kTile * DP * 4);
  L.V = o;    o += align16(kTile * DP * 4);
  L.F = o;    o += align16(kTile * MP * 4);
  L.z = o;    o += align16((size_t)m * 4);
  L.diag = o; o += align16(kTile * 4);
  L.den = o;  o += align16(kTile * 4);
  L.red = o;  o += align16(32 * 4);
  L.total = o;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) performer_fused_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = p.d, m = p.m, DP = d + 1, MP = m + 1, HD = p.nh * d;
  const Layout L = make_layout(d, m);
  float* W = reinterpret_cast<float*>(smem + L.W);      // [m][DP]
  float* KV = reinterpret_cast<float*>(smem + L.KV);    // [m][DP]
  float* X = reinterpret_cast<float*>(smem + L.X);      // [kTile][DP]: k or q
  float* V = reinterpret_cast<float*>(smem + L.V);      // [kTile][DP]
  float* F = reinterpret_cast<float*>(smem + L.F);      // [kTile][MP]: features
  float* z = reinterpret_cast<float*>(smem + L.z);      // [m]
  float* diag = reinterpret_cast<float*>(smem + L.diag);  // [kTile]
  float* den = reinterpret_cast<float*>(smem + L.den);    // [kTile]
  float* red = reinterpret_cast<float*>(smem + L.red);    // [32]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const T* qkv = static_cast<const T*>(p.qkv) + (size_t)b * p.N * 3 * HD;
  T* out = static_cast<T*>(p.out) + (size_t)b * p.N * HD + h * d;

  for (int e = tid; e < m * d; e += blockDim.x) {
    W[(e / d) * DP + e % d] = round_to<T>(p.w[(size_t)h * m * d + e]);
    KV[(e / d) * DP + e % d] = 0.f;
  }
  for (int j = tid; j < m; j += blockDim.x) z[j] = 0.f;

  // pass A: the key stabiliser, max over (n, j) of <w_j, k_n> d^-1/4
  float s_k = -INFINITY;
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_rows<T>(qkv, 1, p.nh, h, d, n0, rows, X);
    __syncthreads();
    tile_gemm(X, DP, 1, W, 1, DP, rows, m, d,
              [&](int, int, float v) { s_k = fmaxf(s_k, p.dn4 * v); });
    __syncthreads();
  }
  s_k = warp_max(s_k);
  if (lane == 0) red[warp] = s_k;
  __syncthreads();
  s_k = -INFINITY;
  for (int i = 0; i < warps; ++i) s_k = fmaxf(s_k, red[i]);

  // pass B: kv += round(k')^T v and z += k' (unrounded), tile by tile
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_rows<T>(qkv, 1, p.nh, h, d, n0, rows, X);
    load_rows<T>(qkv, 2, p.nh, h, d, n0, rows, V);
    __syncthreads();
    row_norms(X, rows, d, p.half, diag);
    __syncthreads();
    tile_gemm(X, DP, 1, W, 1, DP, rows, m, d, [&](int r, int j, float v) {
      F[r * MP + j] = p.ratio * expf(p.dn4 * v - diag[r] - s_k) + kFeatEps;
    });
    __syncthreads();
    for (int j = tid; j < m; j += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float f = F[r * MP + j];
        s += f;
        F[r * MP + j] = round_to<T>(f);
      }
      z[j] += s;
    }
    __syncthreads();
    tile_gemm(F, 1, MP, V, DP, 1, m, d, rows,
              [&](int j, int e, float v) { KV[j * DP + e] += v; });
    __syncthreads();
  }
  for (int e = tid; e < m * d; e += blockDim.x)
    KV[(e / d) * DP + e % d] = round_to<T>(KV[(e / d) * DP + e % d]);
  __syncthreads();

  // pass C: per token q', num = round(q') kv, den = q' z
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_rows<T>(qkv, 0, p.nh, h, d, n0, rows, X);
    __syncthreads();
    row_norms(X, rows, d, p.half, diag);
    tile_gemm(X, DP, 1, W, 1, DP, rows, m, d,
              [&](int r, int j, float v) { F[r * MP + j] = p.dn4 * v; });
    __syncthreads();
    for (int r = warp; r < rows; r += warps) {
      float* row = F + r * MP;
      float mx = -INFINITY;
      for (int j = lane; j < m; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      float dsum = 0.f;
      for (int j = lane; j < m; j += 32) {
        const float qp = p.ratio * expf(row[j] - diag[r] - mx) + kFeatEps;
        dsum = fmaf(qp, z[j], dsum);
        row[j] = round_to<T>(qp);
      }
      dsum = warp_sum(dsum);
      if (lane == 0) den[r] = fmaxf(dsum, kDenEps);
    }
    __syncthreads();
    tile_gemm(F, MP, 1, KV, DP, 1, rows, d, m, [&](int r, int e, float v) {
      out[(size_t)(n0 + r) * HD + e] = from_f<T>(v / den[r]);
    });
    __syncthreads();  // X, F and den are rewritten by the next tile
  }
}

// ---- the bf16 route: the same passes with every product on tensor cores ----
//
// For bf16 inputs whose head dim and feature count are multiples of 16, the
// products run as warp-level bf16 MMA (16x16x16 tiles, f32 accumulation):
// their operands are values of bf16 already (k, q, v, and the projection,
// k', q' and kv rounded as above), so only the summation order differs from
// the CUDA-core route.  The projection, the tiles, kv and the features live
// in shared memory in bf16 (rows padded by 8), the logits in f32; kv is
// summed in accumulator fragments that stay in registers through pass B.

// Whether the bf16 route takes (d, m) (uses_mma() in the wrapper).
__host__ __device__ inline bool uses_mma(int d, int m) {
  return d % 16 == 0 && m % 16 == 0 && (m / 16) * (d / 16) <= kWarps * kMaxAcc;
}

struct MmaLayout {
  size_t W, KV, X, V, F, P, z, diag, den, red, total;
};

// The bf16 route's shared memory (smem_bytes(..., itemsize=2) in the
// wrapper): the projection and the rounded kv [m][d + 8] and the k (or q)
// and v tiles [kTile][d + 8] in bf16; F, f32, holds the logits [kTile][m + 4],
// the kv sums [m][d + 4] between passes B and C, or the output tile
// [kTile][d + 4]; P, bf16, the rounded features [kTile][m + 8].
__host__ __device__ inline MmaLayout make_mma_layout(int d, int m) {
  const size_t DB = d + 8;
  size_t FS = kTile * (m + 4);
  if ((size_t)m * (d + 4) > FS) FS = (size_t)m * (d + 4);
  if ((size_t)kTile * (d + 4) > FS) FS = (size_t)kTile * (d + 4);
  MmaLayout L = {};
  size_t o = 0;
  L.W = o;    o += align128(m * DB * 2);
  L.KV = o;   o += align128(m * DB * 2);
  L.X = o;    o += align128(kTile * DB * 2);
  L.V = o;    o += align128(kTile * DB * 2);
  L.F = o;    o += align128(FS * 4);
  L.P = o;    o += align128((size_t)kTile * (m + 8) * 2);
  L.z = o;    o += align128((size_t)m * 4);
  L.diag = o; o += align128(kTile * 4);
  L.den = o;  o += align128(kTile * 4);
  L.red = o;  o += align128(32 * 4);
  L.total = o;
  return L;
}

using FragAc = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major>;

__global__ void __launch_bounds__(kThreads, 3) performer_fused_mma_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = p.d, m = p.m, DB = d + 8, LM = m + 4, KD = d + 4, PM = m + 8;
  const int HD = p.nh * d;
  const MmaLayout L = make_mma_layout(d, m);
  bf16* W = reinterpret_cast<bf16*>(smem + L.W);     // [m][DB]
  bf16* KVb = reinterpret_cast<bf16*>(smem + L.KV);  // [m][DB]
  bf16* X = reinterpret_cast<bf16*>(smem + L.X);     // [kTile][DB]: k or q
  bf16* V = reinterpret_cast<bf16*>(smem + L.V);     // [kTile][DB]
  float* F = reinterpret_cast<float*>(smem + L.F);
  bf16* P = reinterpret_cast<bf16*>(smem + L.P);     // [kTile][PM]: features
  float* z = reinterpret_cast<float*>(smem + L.z);
  float* diag = reinterpret_cast<float*>(smem + L.diag);
  float* den = reinterpret_cast<float*>(smem + L.den);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* qkv = static_cast<const bf16*>(p.qkv) + (size_t)b * p.N * 3 * HD;
  bf16* out = static_cast<bf16*>(p.out) + (size_t)b * p.N * HD + h * d;
  PhaseClock ph;
  ph.start();

  for (int e = tid; e < m * d; e += blockDim.x)
    W[(e / d) * DB + e % d] = __float2bfloat16(p.w[(size_t)h * m * d + e]);
  for (int j = tid; j < m; j += blockDim.x) z[j] = 0.f;

  // pass A: the key stabiliser
  float s_k = -INFINITY;
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_tile_bf16(qkv, 1, p.nh, h, d, n0, rows, kTile, X, DB);
    __syncthreads();
    ph.mark(kPhaseAStage);
    mma_nt2(X, W, F, nullptr, nullptr, nullptr, DB, kTile, m, d, LM);
    __syncthreads();
    ph.mark(kPhaseALogits);
    for (int e = tid; e < rows * m; e += blockDim.x)
      s_k = fmaxf(s_k, p.dn4 * F[(e / m) * LM + e % m]);
    __syncthreads();
    ph.mark(kPhaseAMax);
  }
  s_k = warp_max(s_k);
  if (lane == 0) red[warp] = s_k;
  __syncthreads();
  s_k = -INFINITY;
  for (int i = 0; i < kWarps; ++i) s_k = fmaxf(s_k, red[i]);
  ph.mark(kPhaseAMax);

  // pass B: kv += round(k')^T v in fragments, z += k' (unrounded)
  const int kv_tiles = (m / 16) * (d / 16), dt = d / 16;
  FragC acc[kMaxAcc];
#pragma unroll
  for (int s = 0; s < kMaxAcc; ++s) wm::fill_fragment(acc[s], 0.f);
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_tile_bf16(qkv, 1, p.nh, h, d, n0, rows, kTile, X, DB);
    load_tile_bf16(qkv, 2, p.nh, h, d, n0, rows, kTile, V, DB);
    __syncthreads();
    ph.mark(kPhaseBStage);
    row_norms_bf16(X, DB, rows, d, p.half, diag);
    mma_nt2(X, W, F, nullptr, nullptr, nullptr, DB, kTile, m, d, LM);
    __syncthreads();
    ph.mark(kPhaseBLogits);
    for (int j = tid; j < m; j += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < kTile; ++r) {
        float f = 0.f;
        if (r < rows) {
          f = p.ratio * expf(p.dn4 * F[r * LM + j] - diag[r] - s_k) + kFeatEps;
          s += f;
        }
        P[r * PM + j] = __float2bfloat16(f);
      }
      z[j] += s;
    }
    __syncthreads();
    ph.mark(kPhaseBFeatures);
#pragma unroll
    for (int s = 0; s < kMaxAcc; ++s) {
      const int f = warp + kWarps * s;
      if (f < kv_tiles) {
        const int i = f / dt, j = f % dt;
        FragAc a;
        FragBr bv;
        for (int k = 0; k < kTile; k += 16) {
          wm::load_matrix_sync(a, P + k * PM + 16 * i, PM);
          wm::load_matrix_sync(bv, V + k * DB + 16 * j, DB);
          wm::mma_sync(acc[s], a, bv, acc[s]);
        }
      }
    }
    __syncthreads();
    ph.mark(kPhaseBProducts);
  }
#pragma unroll
  for (int s = 0; s < kMaxAcc; ++s) {
    const int f = warp + kWarps * s;
    if (f < kv_tiles)
      wm::store_matrix_sync(F + 16 * (f / dt) * KD + 16 * (f % dt), acc[s], KD,
                            wm::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < m * d; e += blockDim.x)
    KVb[(e / d) * DB + e % d] = __float2bfloat16(F[(e / d) * KD + e % d]);
  __syncthreads();
  ph.mark(kPhaseReduce);

  // pass C: per token q', num = round(q') kv, den = q' z
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_tile_bf16(qkv, 0, p.nh, h, d, n0, rows, kTile, X, DB);
    __syncthreads();
    ph.mark(kPhaseCStage);
    row_norms_bf16(X, DB, rows, d, p.half, diag);
    mma_nt2(X, W, F, nullptr, nullptr, nullptr, DB, kTile, m, d, LM);
    __syncthreads();
    ph.mark(kPhaseCLogits);
    for (int r = warp; r < rows; r += kWarps) {
      const float* row = F + r * LM;
      float mx = -INFINITY;
      for (int j = lane; j < m; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      float dsum = 0.f;
      for (int j = lane; j < m; j += 32) {
        const float qp = p.ratio * expf(p.dn4 * row[j] - diag[r] - p.dn4 * mx) + kFeatEps;
        dsum = fmaf(qp, z[j], dsum);
        P[r * PM + j] = __float2bfloat16(qp);
      }
      dsum = warp_sum(dsum);
      if (lane == 0) den[r] = fmaxf(dsum, kDenEps);
    }
    __syncthreads();
    ph.mark(kPhaseCFeatures);
    for (int f = warp; f < (kTile / 16) * dt; f += kWarps) {
      const int i = f / dt, j = f % dt;
      FragA a;
      FragBr bk;
      FragC c;
      wm::fill_fragment(c, 0.f);
      for (int k = 0; k < m; k += 16) {
        wm::load_matrix_sync(a, P + 16 * i * PM + k, PM);
        wm::load_matrix_sync(bk, KVb + k * DB + 16 * j, DB);
        wm::mma_sync(c, a, bk, c);
      }
      wm::store_matrix_sync(F + 16 * i * KD + 16 * j, c, KD, wm::mem_row_major);
    }
    __syncthreads();
    ph.mark(kPhaseCProducts);
    for (int e = tid; e < rows * d; e += blockDim.x) {
      const int r = e / d, x = e % d;
      out[(size_t)(n0 + r) * HD + x] = __float2bfloat16(F[r * KD + x] / den[r]);
    }
    __syncthreads();  // X, F, P and den are rewritten by the next tile
    ph.mark(kPhaseCWrites);
  }
  ph.finish(1);
}

// ---- the bf16 ring route: persistent blocks, every product on mma.sync ----
//
// For bf16 at head dims 16, 32 and 64 with m % 16 == 0 and m <= 128, the
// wrapper's plan() sends the launch here (warps > 0 at the C interface)
// with a layout: warps a block, token-tile rows, ring slots and blocks an
// SM.  What held the wmma kernel back:
// a block an (image, head), every tile loaded synchronously behind 3-4
// barriers, the logits and features through shared memory in f32, pass B's
// features one serial chain a feature, kv twice through shared memory and
// the output written 2 bytes at a time.  Here:
//  * blocks are persistent: the grid is a multiple of the heads, block blk
//    keeps head blk % nh (its projection, rounded to bf16, stays in shared
//    memory for the block's life) and takes images blk / nh, blk / nh +
//    grid / nh, ...; so the heads of one image run side by side and read
//    its rows from DRAM together;
//  * every tile (k in pass A, k and v in pass B, q in pass C) comes through
//    a ring of `stages` one-tile slots by 16-byte cp.async, issued up to
//    stages - 1 steps ahead across passes and items as its slots free up;
//    pass B's k comes again from L2 (a layout that kept an item's k in
//    shared memory instead lost at every shape timed, PERF.md);
//  * every product is mma.sync m16n8k16, the logits and features stay in
//    registers.  Pass A: a warp per 16-token strip against every feature,
//    the max in registers, one block reduction an item; the strip's norms
//    |k|^2 / (2 sqrt d) go to shared memory for pass B.  Pass B, the
//    transposed product L^T = W K^T: a warp per 16-feature strip (W's rows
//    as A fragments) and two 16-token chunks at a time; k' is formed,
//    summed into z (unrounded) and rounded in registers, repacked as the A
//    fragment of k'^T and multiplied by the v chunk into kv [16 x D],
//    which stays in registers through the pass.  Warps beyond m / 16 split
//    the chunks; their kv and z partials are summed in f32 through shared
//    memory once an item and kv is rounded once, where the TPU kernel
//    rounds it.  Pass C, on K1's strip design: a warp per 16-token strip,
//    q W^T, the row max by quad shuffles, q', den = q' z (unrounded), q'
//    rounded into A fragments against kv in shared memory, out / den staged
//    in the strip's own q rows and written 16 bytes a lane.
// Token norms are taken in f32 from the bf16 operands already in registers;
// the features as 2^(l d^-1/4 log2 e + offset) on the special-function
// unit (feature()).  At the cell's shape the plan is 4 warps, 64-row tiles,
// 4 slots and 3 blocks an SM: one item a block, all at once (PERF.md).

constexpr int kRingMaxWarps = 8;
constexpr int kSmemLimit = 232448;

struct RingParams {
  const bf16* qkv;  // [B, N, 3*nh*D]
  const float* w;   // [nh, m, D]
  bf16* out;        // [B, N, nh*D]
  int B, N, nh, m;
  float dn4, half;
  float c1, lr;     // d^-1/4 log2 e and log2 m^-1/2: features in base 2
  int warps, tile, stages, nt;
};

// The ring route's shared memory, each region 128-byte aligned
// (ring_smem_bytes() in the wrapper): the head's projection and the rounded
// kv [m][d + 8] in bf16; the ring's `stages` slots, each one k, q or v tile
// [tile][d + 8] in bf16; the kv partials of the token splits past the
// first, f32 [m][d + 4] each; every split's z partial, z, the item's token
// norms |k_n|^2 / (2 sqrt d) [N rounded up to tiles] and the warps' maxima
// in f32.
struct RingLayout {
  size_t W, KV, ring, stage, part, zpart, z, kn, red, total;
};

__host__ __device__ inline RingLayout make_ring_layout(int d, int m, int N, int warps,
                                                       int tile, int stages) {
  const size_t DB = d + 8;
  const int splits = warps / (m / 16), nt = (N + tile - 1) / tile;
  RingLayout L = {};
  size_t o = 0;
  L.W = o;     o += align128((size_t)m * DB * 2);
  L.KV = o;    o += align128((size_t)m * DB * 2);
  L.stage = align128((size_t)tile * DB * 2);
  L.ring = o;  o += (size_t)stages * L.stage;
  L.part = o;  o += align128((size_t)(splits - 1) * m * (d + 4) * 4);
  L.zpart = o; o += align128((size_t)splits * m * 4);
  L.z = o;     o += align128((size_t)m * 4);
  L.kn = o;    o += align128((size_t)nt * tile * 4);
  L.red = o;   o += align128(kRingMaxWarps * 4);
  L.total = o;
  return L;
}

// Whether the ring route takes this geometry and layout (ring_config_ok()
// in the wrapper).  Pass B takes two slots a step (k and v) and passes A
// and C one, so 4 slots let every step's tiles be issued a step ahead.
__host__ __device__ inline bool ring_config_ok(int d, int m, int N, int warps, int tile,
                                               int stages) {
  if (!(d == 16 || d == 32 || d == 64) || m < 16 || m > 128 || m % 16 || N < 1) return false;
  if (warps < 1 || warps > kRingMaxWarps || warps % (m / 16)) return false;
  if (tile < 16 || tile > 128 || tile % 16 || stages < 4 || stages > 8) return false;
  return make_ring_layout(d, m, N, warps, tile, stages).total <= (size_t)kSmemLimit;
}

// Blocks of a launch (ring_blocks() in the wrapper): a multiple of the
// heads, about bps an SM, no more than the items.
__host__ __device__ inline int ring_blocks(int B, int nh, int bps, int sms) {
  return nh * max(1, min(B, sms * bps / nh));
}

// The sum of squares of the two bf16 values in u.
__device__ __forceinline__ float sq2(uint32_t u) {
  const float lo = __uint_as_float(u << 16), hi = __uint_as_float(u & 0xffff0000u);
  return fmaf(lo, lo, hi * hi);
}

// Waits until at most `pending` (0 to 7) of this thread's cp.async groups
// are in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// The base-2 offset of a token's features: log2 m^-1/2 - (diag + stab) log2 e,
// so that k' (or q') = m^-1/2 exp(l d^-1/4 - diag - stab) + eps is
// 2^(l d^-1/4 log2 e + offset) + eps: one FFMA and the special-function
// unit's 2^x (relative error about 2^-22; the argument's rounding costs a
// few units of 2^-24 of |l d^-1/4|, far below bf16's 2^-8 rounding of k').
__device__ __forceinline__ float feature_offset(const RingParams& p, float diag, float stab) {
  return fmaf(-(diag + stab), kLog2e, p.lr);
}
__device__ __forceinline__ float feature(const RingParams& p, float l, float offset) {
  return mma_frag::exp2_approx(fmaf(l, p.c1, offset)) + kFeatEps;
}

// ldmatrix and cp.async on 32-bit shared addresses, so that a fragment's
// address is a lane's base register plus a constant (mma_frag.cuh's take
// generic pointers).
__device__ __forceinline__ void lds_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void lds_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// The A fragments of a 16-token strip (lane address xa: the strip's first
// row plus the lane's A offset) and |row|^2 of its rows g (ng) and g + 8
// (ng8), summed in f32 from the same fragments.
template <int D>
__device__ __forceinline__ void strip_rows(uint32_t xa, uint32_t (&qa)[D / 16][4], float& ng,
                                           float& ng8) {
  using namespace mma_frag;
  ng = ng8 = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    lds_x4(qa[ks], xa + ks * 32);
    ng += sq2(qa[ks][0]) + sq2(qa[ks][2]);
    ng8 += sq2(qa[ks][1]) + sq2(qa[ks][3]);
  }
  ng = quad_sum(ng);
  ng8 = quad_sum(ng8);
}

// The strip's logits against the features of groups j0 .. j0 + 3 (16 each,
// those below MF) in registers: lg[i] is the accumulator tile of features
// 16 j0 + 8i .. + 7, every chain independent of the others.  wc: the
// projection's first row plus the lane's B offset.
template <int D>
__device__ __forceinline__ void strip_logits(const uint32_t (&qa)[D / 16][4], uint32_t wc,
                                             int j0, int MF, float (&lg)[8][4]) {
  using namespace mma_frag;
  constexpr int RB = (D + 8) * 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j0 + j < MF) {
#pragma unroll
      for (int i = 0; i < 4; ++i) lg[2 * j][i] = lg[2 * j + 1][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t wb[4];
        lds_x4(wb, wc + 16 * (j0 + j) * RB + ks * 32);
        mma_bf16(lg[2 * j], qa[ks], wb[0], wb[1]);
        mma_bf16(lg[2 * j + 1], qa[ks], wb[2], wb[3]);
      }
    }
  }
}

// Pass B's 16-token chunks a warp takes at once (independent chains).
constexpr int kChunks = 2;

// Built for blocks of at most W warps: W = 4 at three blocks an SM (up to
// 168 registers a thread), W = 8 at one (up to 255).
template <int D, int MT, int W>
__global__ void __launch_bounds__(W * 32, W == 4 ? 3 : 1)
    performer_fused_ring_kernel(const RingParams p) {
  using namespace mma_frag;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DB = D + 8, RB = DB * 2, KS = D / 16, DT = D / 8;
  const int m = p.m, MF = m / 16, NW = p.warps, TS = NW / MF, T = p.tile, R = p.stages;
  const int nt = p.nt, HD = p.nh * D, row3 = 3 * HD, nthr = NW * 32;
  const RingLayout L = make_ring_layout(D, m, p.N, NW, T, R);
  const uint32_t s0 = smem_addr(smem);
  bf16* KVb = reinterpret_cast<bf16*>(smem + L.KV);   // [m][DB]
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* zpart = reinterpret_cast<float*>(smem + L.zpart);
  float* zf = reinterpret_cast<float*>(smem + L.z);
  float* kn = reinterpret_cast<float*>(smem + L.kn);  // [nt * T]
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, c = lane & 3;
  // the lane's byte offsets into a [rows][DB] array for A (and .trans B)
  // fragments and for B fragments
  const uint32_t offr = (row_r(lane) * DB + col_r(lane)) * 2;
  const uint32_t offc = (row_c(lane) * DB + col_c(lane)) * 2;
  const uint32_t sWr = s0 + L.W + offr, sWc = s0 + L.W + offc, sKVr = s0 + L.KV + offr;
  const int h = blockIdx.x % p.nh, img0 = blockIdx.x / p.nh, img_step = gridDim.x / p.nh;
  const int items = img0 < p.B ? (p.B - 1 - img0) / img_step + 1 : 0;
  const int steps = items * 3 * nt;
  PhaseClock ph;
  ph.start();

  for (int e = tid; e < m * D; e += nthr)
    reinterpret_cast<bf16*>(smem + L.W)[(e / D) * DB + e % D] =
        __float2bfloat16(p.w[(size_t)h * m * D + e]);

  // The block's steps: for each item, pass A's nt tiles, pass B's, pass
  // C's.  A step takes uses(pass) consecutive slots of the ring (mod R):
  // pass A k, pass B k and v, pass C q.  The producer (issue_next) and the
  // consumer (begin) walk the steps with counters, no division.
  auto uses = [&](int pass) { return pass == 1 ? 2 : 1; };
  auto slot_off = [&](int i) { return (uint32_t)(L.ring + i * L.stage); };  // i < R
  auto next_slot = [&](int i) { return i + 1 < R ? i + 1 : 0; };
  // a thread copies 16-byte column cv of rows cr, cr + rstep, ...
  const int cv = tid % DT, cr = tid / DT, rstep = nthr / DT;
  const size_t src_step = (size_t)rstep * row3;
  int issued = 0, pk = 0, ppass = 0, pt = 0, pslot = 0, pcum = 0;
  auto issue_next = [&]() {
    const int u = uses(ppass);
    // pass A: k into x; pass C: q into x; pass B: k into x and v into v
    const uint32_t x = slot_off(pslot), v = slot_off(next_slot(pslot));
    const bool with_v = ppass == 1;
    const int sec = ppass == 2 ? 0 : 1, rows = min(T, p.N - pt * T);
    const bf16* src = p.qkv +
                      ((size_t)(img0 + pk * img_step) * p.N + (size_t)pt * T + cr) * row3 +
                      sec * HD + h * D + 8 * cv;
    for (int r = cr; r < T; r += rstep, src += src_step) {
      const uint32_t o = r * RB + 16 * cv;
      if (r < rows) {
        cp16(s0 + x + o, src);
        if (with_v) cp16(s0 + v + o, src + (2 - sec) * HD);
      } else {  // past the last token: zeros, so no stale value reaches a product
        *reinterpret_cast<uint4*>(smem + x + o) = make_uint4(0u, 0u, 0u, 0u);
        if (with_v) *reinterpret_cast<uint4*>(smem + v + o) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
    pcum += u;
    pslot += u;
    if (pslot >= R) pslot -= R;
    if (++pt == nt) {
      pt = 0;
      if (++ppass == 3) ppass = 0, ++pk;
    }
    ++issued;
  };
  // issues the steps after the last issued one whose slots are free once
  // the steps before `from` (which took `from_cum` slots) are done, at most
  // R - 1 steps ahead of `from`
  auto issue_ahead = [&](int from, int from_cum) {
    while (issued < steps && issued - from < R && pcum + uses(ppass) - from_cum <= R)
      issue_next();
  };
  issue_ahead(0, 0);
  // the consumer: the current step, the slots the steps before it took, its
  // first slot, and the slots of the step before it
  int step = 0, ccum = 0, cslot = 0, cuse = 0;
  // step `step` (of pass `pass`) has landed and every warp is done with the
  // steps before it, whose slots are refilled
  auto begin = [&](int phase, int pass) {
    ccum += cuse;
    cslot += cuse;
    if (cslot >= R) cslot -= R;
    cuse = uses(pass);
    cp_async_wait_pending(issued - step - 1);
    __syncthreads();
    issue_ahead(step, ccum);
    ph.mark(phase);
    ++step;
  };
  // the current step's k (or q) tile and v tile
  auto x_off = [&]() { return slot_off(cslot); };
  auto v_off = [&]() { return slot_off(next_slot(cslot)); };

  for (int it = 0; it < items; ++it) {
    const int b = img0 + it * img_step;
    // pass A: the largest logit <w_j, k_n> over the item's tokens and
    // features, a warp per 16-token strip; the strip's norms into kn
    float smax = -INFINITY;
    for (int t = 0; t < nt; ++t) {
      begin(kPhaseAStage, 0);
      const uint32_t xs = s0 + x_off() + offr;
      const int n0 = t * T;
      for (int sp = warp; sp < T / 16; sp += NW) {
        const int r0 = sp * 16;
        if (n0 + r0 >= p.N) break;
        uint32_t qa[KS][4];
        float ng, ng8;
        strip_rows<D>(xs + r0 * RB, qa, ng, ng8);
        if (c == 0) {
          kn[n0 + r0 + g] = p.half * ng;
          kn[n0 + r0 + g + 8] = p.half * ng8;
        }
        const bool vg = n0 + r0 + g < p.N, vg8 = n0 + r0 + g + 8 < p.N;
        for (int j0 = 0; j0 < MF; j0 += 4) {
          float lg[8][4], mx[8];
          strip_logits<D>(qa, sWc, j0, MF, lg);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            mx[j] = -INFINITY;
            if (2 * j0 + j < 2 * MF) {
              if (vg) mx[j] = fmaxf(lg[j][0], lg[j][1]);
              if (vg8) mx[j] = fmaxf(mx[j], fmaxf(lg[j][2], lg[j][3]));
            }
          }
          smax = fmaxf(smax, fmaxf(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])),
                                   fmaxf(fmaxf(mx[4], mx[5]), fmaxf(mx[6], mx[7]))));
        }
      }
      ph.mark(kPhaseALogits);
    }
    smax = warp_max(smax);
    if (lane == 0) red[warp] = smax;
    ph.mark(kPhaseAMax);

    // pass B: warp (fs, tq) takes features fs*16.. of chunks tq, tq + TS, ...
    const int fs = warp % MF, tq = warp / MF, f0 = fs * 16;
    float kv[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j) kv[j][0] = kv[j][1] = kv[j][2] = kv[j][3] = 0.f;
    float zg = 0.f, zg8 = 0.f, s_k = 0.f;
    for (int t = 0; t < nt; ++t) {
      begin(kPhaseBStage, 1);
      if (t == 0) {
        float mx = -INFINITY;
        for (int i = 0; i < NW; ++i) mx = fmaxf(mx, red[i]);
        s_k = p.dn4 * mx;
      }
      const uint32_t kc = s0 + x_off() + offc;
      const uint32_t vr = s0 + v_off() + offr;
      const int n0 = t * T;
      // this warp's chunks tq, tq + TS, ..., kChunks at a time, in order
      for (int ch0 = tq; ch0 < T / 16; ch0 += kChunks * TS) {
        if (n0 + ch0 * 16 >= p.N) break;
        // L^T [16 features x 16 tokens] of each chunk
        float l[2 * kChunks][4];
#pragma unroll
        for (int i = 0; i < 2 * kChunks; ++i) l[i][0] = l[i][1] = l[i][2] = l[i][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t wa[4];
          lds_x4(wa, sWr + f0 * RB + ks * 32);
#pragma unroll
          for (int i = 0; i < kChunks; ++i) {
            const int ch = ch0 + i * TS;
            if (ch < T / 16 && n0 + ch * 16 < p.N) {
              uint32_t kb[4];
              lds_x4(kb, kc + ch * 16 * RB + ks * 32);
              mma_bf16(l[2 * i], wa, kb[0], kb[1]);
              mma_bf16(l[2 * i + 1], wa, kb[2], kb[3]);
            }
          }
        }
        ph.mark(kPhaseBLogits);
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
          const int ch = ch0 + i * TS;
          if (ch < T / 16 && n0 + ch * 16 < p.N) {
            // the accumulators hold tokens 2c, 2c + 1 (l[2i]) and 2c + 8,
            // 2c + 9 (l[2i + 1]) of the chunk
            const int tok = n0 + ch * 16 + 2 * c;
            const float2 d01 = *reinterpret_cast<const float2*>(kn + tok);
            const float2 d23 = *reinterpret_cast<const float2*>(kn + tok + 8);
            const float e0 = feature_offset(p, d01.x, s_k), e1 = feature_offset(p, d01.y, s_k);
            const float e2 = feature_offset(p, d23.x, s_k), e3 = feature_offset(p, d23.y, s_k);
            float* l0 = l[2 * i];
            float* l1 = l[2 * i + 1];
            l0[0] = feature(p, l0[0], e0);
            l0[1] = feature(p, l0[1], e1);
            l0[2] = feature(p, l0[2], e0);
            l0[3] = feature(p, l0[3], e1);
            l1[0] = feature(p, l1[0], e2);
            l1[1] = feature(p, l1[1], e3);
            l1[2] = feature(p, l1[2], e2);
            l1[3] = feature(p, l1[3], e3);
            if (n0 + ch * 16 + 16 > p.N) {  // the last chunk: no feature past the last token
              if (tok >= p.N) l0[0] = l0[2] = 0.f;
              if (tok + 1 >= p.N) l0[1] = l0[3] = 0.f;
              if (tok + 8 >= p.N) l1[0] = l1[2] = 0.f;
              if (tok + 9 >= p.N) l1[1] = l1[3] = 0.f;
            }
            zg += (l0[0] + l0[1]) + (l1[0] + l1[1]);
            zg8 += (l0[2] + l0[3]) + (l1[2] + l1[3]);
          }
        }
        ph.mark(kPhaseBFeatures);
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
          const int ch = ch0 + i * TS;
          if (ch < T / 16 && n0 + ch * 16 < p.N) {
            uint32_t a[4];
            c_to_a(l[2 * i], l[2 * i + 1], a);  // round(k')^T, features x tokens
#pragma unroll
            for (int j = 0; j < D; j += 16) {
              uint32_t vb[4];
              lds_x4_trans(vb, vr + ch * 16 * RB + j * 2);
              mma_bf16(kv[j / 8], a, vb[0], vb[1]);
              mma_bf16(kv[j / 8 + 1], a, vb[2], vb[3]);
            }
          }
        }
        ph.mark(kPhaseBProducts);
      }
    }
    zg = quad_sum(zg);
    zg8 = quad_sum(zg8);
    if (c == 0) {
      zpart[tq * m + f0 + g] = zg;
      zpart[tq * m + f0 + g + 8] = zg8;
    }
    if (tq > 0) {
      float* P = part + (size_t)(tq - 1) * m * (D + 4);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        *reinterpret_cast<float2*>(P + (f0 + g) * (D + 4) + j * 8 + 2 * c) =
            make_float2(kv[j][0], kv[j][1]);
        *reinterpret_cast<float2*>(P + (f0 + g + 8) * (D + 4) + j * 8 + 2 * c) =
            make_float2(kv[j][2], kv[j][3]);
      }
    }
    // pass C's first tile; meanwhile kv and z summed over the splits in
    // order, in f32, and kv rounded once
    begin(kPhaseCStage, 2);
    if (tq == 0) {
      for (int i = 1; i < TS; ++i) {
        const float* P = part + (size_t)(i - 1) * m * (D + 4);
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const float2 x = *reinterpret_cast<const float2*>(P + (f0 + g) * (D + 4) + j * 8 + 2 * c);
          const float2 y =
              *reinterpret_cast<const float2*>(P + (f0 + g + 8) * (D + 4) + j * 8 + 2 * c);
          kv[j][0] += x.x;
          kv[j][1] += x.y;
          kv[j][2] += y.x;
          kv[j][3] += y.y;
        }
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        *reinterpret_cast<uint32_t*>(KVb + (f0 + g) * DB + j * 8 + 2 * c) =
            pack_bf16(kv[j][0], kv[j][1]);
        *reinterpret_cast<uint32_t*>(KVb + (f0 + g + 8) * DB + j * 8 + 2 * c) =
            pack_bf16(kv[j][2], kv[j][3]);
      }
    }
    for (int j = tid; j < m; j += nthr) {
      float z = 0.f;
      for (int i = 0; i < TS; ++i) z += zpart[i * m + j];
      zf[j] = z;
    }
    __syncthreads();
    ph.mark(kPhaseReduce);

    // pass C: a warp per 16-token strip
    bf16* outb = p.out + (size_t)b * p.N * HD + h * D;
    for (int t = 0; t < nt; ++t) {
      if (t > 0) begin(kPhaseCStage, 2);
      const int n0 = t * T;
      for (int sp = warp; sp < T / 16; sp += NW) {
        const int r0 = sp * 16;
        if (n0 + r0 >= p.N) break;
        const uint32_t xo = x_off() + r0 * RB;  // the strip's q rows
        uint32_t qa[KS][4];
        float ng, ng8, lg[8][4];
        strip_rows<D>(s0 + xo + offr, qa, ng, ng8);
        const float dg = p.half * ng, dg8 = p.half * ng8;
        // the row max over every feature; up to 64 features the logits stay
        // in registers for what follows, above that each block of 64 is
        // taken again
        constexpr int kBlocks = MT / 8;
        float mg = -INFINITY, mg8 = -INFINITY;
        for (int j0 = 0; j0 < (kBlocks > 1 ? MF : 1); j0 += 4) {
          strip_logits<D>(qa, sWc, j0, MF, lg);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (2 * j0 + j < 2 * MF) {
              mg = fmaxf(mg, fmaxf(lg[j][0], lg[j][1]));
              mg8 = fmaxf(mg8, fmaxf(lg[j][2], lg[j][3]));
            }
          }
        }
        ph.mark(kPhaseCLogits);
        const float eg = feature_offset(p, dg, p.dn4 * quad_max(mg));
        const float eg8 = feature_offset(p, dg8, p.dn4 * quad_max(mg8));
        float den = 0.f, den8 = 0.f;
        float o[DT][4];
        for (int j0 = 0; j0 < (kBlocks > 1 ? MF : 1); j0 += 4) {
          if (kBlocks > 1) strip_logits<D>(qa, sWc, j0, MF, lg);
          // q' (den from the unrounded values), then rounded into A fragments
          uint32_t qp[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j0 + j < MF) {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                float* x = lg[2 * j + u];
                const float2 zz =
                    *reinterpret_cast<const float2*>(zf + (2 * (j0 + j) + u) * 8 + 2 * c);
                x[0] = feature(p, x[0], eg);
                x[1] = feature(p, x[1], eg);
                x[2] = feature(p, x[2], eg8);
                x[3] = feature(p, x[3], eg8);
                den = fmaf(x[1], zz.y, fmaf(x[0], zz.x, den));
                den8 = fmaf(x[3], zz.y, fmaf(x[2], zz.x, den8));
              }
              c_to_a(lg[2 * j], lg[2 * j + 1], qp[j]);
            }
          }
          ph.mark(kPhaseCFeatures);
          if (j0 == 0) {
#pragma unroll
            for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j0 + j < MF) {
#pragma unroll
              for (int e = 0; e < D; e += 16) {
                uint32_t kb[4];
                lds_x4_trans(kb, sKVr + 16 * (j0 + j) * RB + e * 2);
                mma_bf16(o[e / 8], qp[j], kb[0], kb[1]);
                mma_bf16(o[e / 8 + 1], qp[j], kb[2], kb[3]);
              }
            }
          }
          ph.mark(kPhaseCProducts);
        }
        // out = num / den, as num times 1 / den (within an f32 rounding),
        // rounded, staged in the strip's own q rows (no other warp reads
        // them), then written 16 bytes a lane
        const float rden = 1.f / fmaxf(quad_sum(den), kDenEps);
        const float rden8 = 1.f / fmaxf(quad_sum(den8), kDenEps);
        bf16* S = reinterpret_cast<bf16*>(smem + xo);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          *reinterpret_cast<uint32_t*>(S + g * DB + j * 8 + 2 * c) =
              pack_bf16(o[j][0] * rden, o[j][1] * rden);
          *reinterpret_cast<uint32_t*>(S + (g + 8) * DB + j * 8 + 2 * c) =
              pack_bf16(o[j][2] * rden8, o[j][3] * rden8);
        }
        __syncwarp();
        for (int e = lane; e < 16 * DT; e += 32) {
          const int r = e / DT, v = e % DT;
          if (n0 + r0 + r < p.N)
            *reinterpret_cast<uint4*>(outb + (size_t)(n0 + r0 + r) * HD + 8 * v) =
                *reinterpret_cast<const uint4*>(S + r * DB + 8 * v);
        }
        ph.mark(kPhaseCWrites);
      }
    }
  }
  cp_async_wait_pending(0);  // the groups past the last step are empty
  ph.finish(items);
}

// The ring kernel that a layout runs on: the 4-warp build for blocks of 4
// warps at up to 64 features, else the 8-warp build; MT, the feature tiles
// of 8 its registers hold, is 8 up to 64 features and 16 up to 128.
template <int D, typename F>
auto with_ring_kernel(int m, int warps, F&& f) {
  if (m > 64) return f(performer_fused_ring_kernel<D, 16, kRingMaxWarps>);
  if (warps <= 4) return f(performer_fused_ring_kernel<D, 8, 4>);
  return f(performer_fused_ring_kernel<D, 8, kRingMaxWarps>);
}

template <typename F>
auto with_ring_kernel(int d, int m, int warps, F&& f)
    -> decltype(f(performer_fused_ring_kernel<16, 8, 4>)) {
  switch (d) {
    case 16: return with_ring_kernel<16>(m, warps, f);
    case 32: return with_ring_kernel<32>(m, warps, f);
    case 64: return with_ring_kernel<64>(m, warps, f);
    default: return f(nullptr);
  }
}

cudaError_t launch_ring(const RingParams& p, int d, int bps, cudaStream_t stream) {
  const RingLayout L = make_ring_layout(d, p.m, p.N, p.warps, p.tile, p.stages);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return with_ring_kernel(d, p.m, p.warps, [&](void (*kernel)(RingParams)) {
    if (kernel == nullptr) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return e;
    kernel<<<ring_blocks(p.B, p.nh, bps, sms), p.warps * 32, L.total, stream>>>(p);
    return cudaGetLastError();
  });
}

// Blocks of the ring kernel for (d, m, warps) that fit an SM at `smem`
// bytes (the occupancy calculator), or -1.
int ring_blocks_per_sm(int d, int m, int warps, int smem) {
  return with_ring_kernel(d, m, warps, [&](void (*kernel)(RingParams)) {
    int n = -1;
    if (kernel == nullptr ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, warps * 32, smem) !=
            cudaSuccess)
      return -1;
    return n;
  });
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (sizeof(T) == 2 && uses_mma(p.d, p.m)) {
    const MmaLayout L = make_mma_layout(p.d, p.m);
    cudaError_t err = cudaFuncSetAttribute(performer_fused_mma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L.total);
    if (err != cudaSuccess) return err;
    performer_fused_mma_kernel<<<dim3(p.nh, p.B), kThreads, L.total, stream>>>(p);
    return cudaGetLastError();
  }
  const Layout L = make_layout(p.d, p.m);
  auto kernel = performer_fused_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.nh, p.B), kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one block of the route that (d, m, is_bf16) takes.
int performer_fused_smem_bytes(int d, int m, int is_bf16) {
  return (int)(is_bf16 && uses_mma(d, m) ? make_mma_layout(d, m).total
                                         : make_layout(d, m).total);
}

// Shared memory of one block of the ring route at this layout, or -1 where
// the route does not take it (ring_config_ok).
int performer_fused_ring_smem_bytes(int d, int m, int N, int warps, int tile, int stages) {
  if (!ring_config_ok(d, m, N, warps, tile, stages)) return -1;
  return (int)make_ring_layout(d, m, N, warps, tile, stages).total;
}

// Blocks of a ring launch on the current device (ring_blocks).
int performer_fused_ring_blocks(int B, int nh, int bps) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return ring_blocks(B, nh, bps, sms);
}

// Blocks of the ring kernel for (d, m) that fit an SM at `warps` warps and
// `smem` bytes (the occupancy calculator), or -1.
int performer_fused_ring_blocks_per_sm(int d, int m, int warps, int smem) {
  return ring_blocks_per_sm(d, m, warps, smem);
}

#ifdef PERFORMER_PHASES
// Copies g_performer_phases ([16][16384] uint64) to host memory at dst; a
// cudaError_t.
int performer_fused_phases_copy(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_performer_phases, sizeof(g_performer_phases));
}
#endif

const char* performer_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: out [B, N, nh*d] from qkv (float32 or bfloat16) and the
// projection w (f32 [nh, m, d]).  warps > 0 launches the ring route (bf16)
// at the layout (warps, tile, stages, bps) that the wrapper's
// plan() picks, and fails where that route does not take it; warps == 0
// the kernel that took the geometry before it (wmma where uses_mma, else
// CUDA cores).  qkv and out 16-byte aligned on the ring route.  Returns a
// cudaError_t (0 on success).
int performer_fused_launch(const void* qkv, const float* w, void* out, int B, int N,
                           int nh, int d, int m, int is_bf16, float dn4, float half,
                           float ratio, int warps, int tile, int stages, int bps,
                           void* stream) {
  if (B <= 0 || N <= 0 || nh <= 0 || d <= 0 || m <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warps != 0) {
    if (!is_bf16 || bps < 1 || !ring_config_ok(d, m, N, warps, tile, stages))
      return cudaErrorInvalidValue;
    RingParams r = {};
    r.qkv = static_cast<const bf16*>(qkv); r.w = w; r.out = static_cast<bf16*>(out);
    r.B = B; r.N = N; r.nh = nh; r.m = m;
    r.dn4 = dn4; r.half = half;
    r.c1 = dn4 * kLog2e; r.lr = log2f(ratio);
    r.warps = warps; r.tile = tile; r.stages = stages;
    r.nt = (N + tile - 1) / tile;
    return launch_ring(r, d, bps, s);
  }
  Params p = {};
  p.qkv = qkv; p.w = w; p.out = out;
  p.B = B; p.N = N; p.nh = nh; p.d = d; p.m = m;
  p.dn4 = dn4; p.half = half; p.ratio = ratio;
  return is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // extern "C"
