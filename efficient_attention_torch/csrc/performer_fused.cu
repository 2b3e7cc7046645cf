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
// tensor cores, TMA or pipelining.
#include "smem_tile.cuh"

namespace {

using namespace smem_tile;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // token rows a block holds at once (TOKEN_TILE)
constexpr int kMaxAcc = 4;  // kv accumulator tiles a warp holds (MMA_MAX_ACC)
constexpr float kFeatEps = 1e-4f;
constexpr float kDenEps = 1e-2f;

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

  for (int e = tid; e < m * d; e += blockDim.x)
    W[(e / d) * DB + e % d] = __float2bfloat16(p.w[(size_t)h * m * d + e]);
  for (int j = tid; j < m; j += blockDim.x) z[j] = 0.f;

  // pass A: the key stabiliser
  float s_k = -INFINITY;
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_tile_bf16(qkv, 1, p.nh, h, d, n0, rows, kTile, X, DB);
    __syncthreads();
    mma_nt2(X, W, F, nullptr, nullptr, nullptr, DB, kTile, m, d, LM);
    __syncthreads();
    for (int e = tid; e < rows * m; e += blockDim.x)
      s_k = fmaxf(s_k, p.dn4 * F[(e / m) * LM + e % m]);
    __syncthreads();
  }
  s_k = warp_max(s_k);
  if (lane == 0) red[warp] = s_k;
  __syncthreads();
  s_k = -INFINITY;
  for (int i = 0; i < kWarps; ++i) s_k = fmaxf(s_k, red[i]);

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
    row_norms_bf16(X, DB, rows, d, p.half, diag);
    mma_nt2(X, W, F, nullptr, nullptr, nullptr, DB, kTile, m, d, LM);
    __syncthreads();
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

  // pass C: per token q', num = round(q') kv, den = q' z
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    const int rows = min(kTile, p.N - n0);
    load_tile_bf16(qkv, 0, p.nh, h, d, n0, rows, kTile, X, DB);
    __syncthreads();
    row_norms_bf16(X, DB, rows, d, p.half, diag);
    mma_nt2(X, W, F, nullptr, nullptr, nullptr, DB, kTile, m, d, LM);
    __syncthreads();
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
    for (int e = tid; e < rows * d; e += blockDim.x) {
      const int r = e / d, x = e % d;
      out[(size_t)(n0 + r) * HD + x] = __float2bfloat16(F[r * KD + x] / den[r]);
    }
    __syncthreads();  // X, F, P and den are rewritten by the next tile
  }
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

const char* performer_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: out [B, N, nh*d] from qkv (float32 or bfloat16) and the
// projection w (f32 [nh, m, d]).  Returns a cudaError_t (0 on success).
int performer_fused_launch(const void* qkv, const float* w, void* out, int B, int N,
                           int nh, int d, int m, int is_bf16, float dn4, float half,
                           float ratio, void* stream) {
  if (B <= 0 || N <= 0 || nh <= 0 || d <= 0 || m <= 0) return cudaErrorInvalidValue;
  Params p = {};
  p.qkv = qkv; p.w = w; p.out = out;
  p.B = B; p.N = N; p.nh = nh; p.d = d; p.m = m;
  p.dn4 = dn4; p.half = half; p.ratio = ratio;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // extern "C"
