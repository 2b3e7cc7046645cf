// K4 eva_1d: the 1-D EVA joint softmax of the WMT encoder (forward, eval only).
//
// Replaces efficient_attention_tpu/ops/pallas/eva_1d.py::eva_attention_1d
// (_kernel).  Plain version and wrapper: efficient_attention_torch/ops/kernels/
// eva_1d.py.
//
// Function.  qkv [B, N, 3*H*D] holds q, k, v side by side, N a multiple of
// the window ws.  A query at position n of head h, in window g = n / ws at row
// r = n % ws, attends in one softmax over
//   * the ws + 2*ext halo'd keys of its window, at positions g*ws - ext + u
//     for u < ws + 2*ext: logit scale <q, k> + bias[h, r, u], plus MASK_VAL
//     where the key is padding (mask [B, N], 1 = pad) and MASK_VAL with k = v
//     = 0 where the position lies outside [0, N);
//   * the C chunk keys rf_k_bar [B, C, H*D] with values beta [B, C, H*D],
//     logit scale <q, rf>, never masked.
// Roundings follow the TPU kernel: f32 logits, p = exp(logit - max) in f32,
// p rounded to qkv's type before its product with [v | beta], the product
// summed in f32 and divided by the f32 sum of the unrounded p last; out
// [B, N, H*D] in qkv's type.
//
// What bounds it: bytes.  At the WMT encoder's shape (B=64 sentences, N=32,
// 8 heads of 64, ws 8, ext 4, C=8, f32) it reads qkv (12.6 MB) and writes
// the output (4.2 MB): ~5 us at 3.35 TB/s, against ~0.4 us for its 25 MFLOP
// (two products over 24 columns of 64 per query and head) at the f32 peak.
//
// Design.  Only each query's own ws + 2*ext + C columns are computed (the
// TPU kernel builds a dense masked [TGS, TGS + 2*ext] table per strip).  A
// block takes a run of wpb whole windows (16 query rows at ws = 8, the
// wrapper's choice) of one (sentence, head) and stages in shared memory, in
// 16-byte loads converted to f32 (bf16 converts exactly): the
// run's q rows, its k and v rows with ext halo rows on each side (zero
// outside [0, N)), the head's C chunk keys and values, the bias table and the
// run's additive key mask.  A warp takes one query row at a time: each lane
// computes logits of its columns (a dot product of D over shared-memory rows
// at an odd stride, so the 32 lanes hit 32 banks, in four independent
// partial sums), the warp reduces the max and the sum, and each lane then
// sums p times [v | beta] for its own output columns.  CUDA cores only, in
// both types.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskVal = -5e4f;

struct Params {
  const void* qkv;      // [B, N, 3*nh*D], T
  const void* rf;       // [B, C, nh*D], T
  const void* beta;     // [B, C, nh*D], T
  const uint8_t* mask;  // [B, N] (1 = pad) or null
  const float* bias;    // [nh, ws, ws + 2*ext] or null
  void* out;            // [B, N, nh*D], T
  int B, N, nh, ws, ext, C;
  int wpb;              // windows per block
  float scale;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Offsets (bytes) of the shared-memory regions; the same layout as
// smem_bytes() in ops/kernels/eva_1d.py.  Rows of D floats sit at the odd
// stride D + 1.
struct Layout {
  size_t q, keys, vals, rf, beta, bias, add, P, total;
};

__host__ __device__ inline Layout make_layout(int D, int ws, int ext, int C, int wpb) {
  const size_t DP = D + 1, R = (size_t)wpb * ws, KR = R + 2 * ext, L = ws + 2 * ext;
  Layout l = {};
  size_t o = 0;
  l.q = o;     o += align16(R * DP * 4);
  l.keys = o;  o += align16(KR * DP * 4);
  l.vals = o;  o += align16(KR * DP * 4);
  l.rf = o;    o += align16(C * DP * 4);
  l.beta = o;  o += align16(C * DP * 4);
  l.bias = o;  o += align16(ws * L * 4);
  l.add = o;   o += align16(KR * 4);
  l.P = o;     o += align16(kWarps * (L + C) * 4);
  l.total = o;
  return l;
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

// Elements of T in 16 bytes.
template <typename T> constexpr int kVec = 16 / sizeof(T);

// dst[i*V .. i*V + V) = src[i*V ..) as f32 (V = kVec<T>), one 16-byte load;
// zeros where src is null.  dst rows sit at an odd stride: scalar stores.
template <typename T>
__device__ __forceinline__ void stage(const T* src, int i, float* dst) {
  constexpr int V = kVec<T>;
  if (src == nullptr) {
#pragma unroll
    for (int k = 0; k < V; ++k) dst[i * V + k] = 0.f;
    return;
  }
  const uint4 raw = *reinterpret_cast<const uint4*>(src + i * V);
  const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) dst[i * V + k] = to_f(x[k]);
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

// <a, b> over D (a multiple of 4) in four independent partial sums, so the
// FMAs of one lane do not wait on each other.
template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int k = 0; k < D; k += 4) {
    s0 = fmaf(a[k], b[k], s0);
    s1 = fmaf(a[k + 1], b[k + 1], s1);
    s2 = fmaf(a[k + 2], b[k + 2], s2);
    s3 = fmaf(a[k + 3], b[k + 3], s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// sum_j w[j] rows[j * DP + c] for j < n, in two independent partial sums.
template <int DP>
__device__ __forceinline__ float weighted_sum(const float* w, const float* rows, int n,
                                              int c) {
  float s0 = 0.f, s1 = 0.f;
  int j = 0;
  for (; j + 1 < n; j += 2) {
    s0 = fmaf(w[j], rows[j * DP + c], s0);
    s1 = fmaf(w[j + 1], rows[(j + 1) * DP + c], s1);
  }
  if (j < n) s0 = fmaf(w[j], rows[j * DP + c], s0);
  return s0 + s1;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) eva_1d_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int DP = D + 1;
  const int ws = p.ws, ext = p.ext, C = p.C, L = ws + 2 * ext, LC = L + C;
  const int R = p.wpb * ws, KR = R + 2 * ext;
  const Layout lay = make_layout(D, ws, ext, C, p.wpb);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);        // [R][DP]
  float* k_s = reinterpret_cast<float*>(smem + lay.keys);     // [KR][DP]
  float* v_s = reinterpret_cast<float*>(smem + lay.vals);     // [KR][DP]
  float* rf_s = reinterpret_cast<float*>(smem + lay.rf);      // [C][DP]
  float* beta_s = reinterpret_cast<float*>(smem + lay.beta);  // [C][DP]
  float* bias_s = reinterpret_cast<float*>(smem + lay.bias);  // [ws][L]
  float* add_s = reinterpret_cast<float*>(smem + lay.add);    // [KR]
  float* P = reinterpret_cast<float*>(smem + lay.P);          // [kWarps][LC]
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int HD = p.nh * D;
  const int start = blockIdx.x * R;  // first query position of the run
  const T* qkv = static_cast<const T*>(p.qkv) + (size_t)b * p.N * 3 * HD + h * D;
  const T* rf = static_cast<const T*>(p.rf) + (size_t)b * C * HD + h * D;
  const T* beta = static_cast<const T*>(p.beta) + (size_t)b * C * HD + h * D;
  T* out = static_cast<T*>(p.out) + (size_t)b * p.N * HD + h * D;

  // stage the run in 16-byte loads, several in flight a thread: q rows,
  // halo'd k/v rows (zero outside [0, N)), chunks, the bias table and the
  // additive key mask
  constexpr int DV = D / kVec<T>;  // 16-byte pieces a row
#pragma unroll 4
  for (int e = threadIdx.x; e < R * DV; e += kThreads) {
    const int t = e / DV, i = e % DV, n = start + t;
    stage<T>(n < p.N ? qkv + (size_t)n * 3 * HD : nullptr, i, q_s + t * DP);
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < 2 * KR * DV; e += kThreads) {
    const int part = e / (KR * DV), t = (e / DV) % KR, i = e % DV;
    const int n = start - ext + t;
    stage<T>(n >= 0 && n < p.N ? qkv + (size_t)n * 3 * HD + (1 + part) * HD : nullptr,
             i, (part ? v_s : k_s) + t * DP);
  }
  for (int e = threadIdx.x; e < 2 * C * DV; e += kThreads) {
    const int part = e / (C * DV), c = (e / DV) % C, i = e % DV;
    stage<T>((part ? beta : rf) + (size_t)c * HD, i, (part ? beta_s : rf_s) + c * DP);
  }
  const float* bh = p.bias != nullptr ? p.bias + (size_t)h * ws * L : nullptr;
  for (int e = threadIdx.x; e < ws * L; e += kThreads) bias_s[e] = bh != nullptr ? bh[e] : 0.f;
  for (int t = threadIdx.x; t < KR; t += kThreads) {
    const int n = start - ext + t;
    float a = kMaskVal;
    if (n >= 0 && n < p.N)
      a = (p.mask != nullptr && p.mask[(size_t)b * p.N + n]) ? kMaskVal : 0.f;
    add_s[t] = a;
  }
  __syncthreads();

  float* Pw = P + warp * LC;
  for (int r = warp; r < R; r += kWarps) {
    const int n = start + r;
    if (n >= p.N) break;  // rows are taken in order: the rest are past N too
    const float* qr = q_s + r * DP;
    const int k0 = (r / ws) * ws;  // the window's first halo'd key row
    const float* br = bias_s + (r % ws) * L;
    float mx = -INFINITY;
    for (int j = lane; j < LC; j += 32) {
      float s;
      if (j < L) {
        s = dot<D>(qr, k_s + (k0 + j) * DP) * p.scale + br[j] + add_s[k0 + j];
      } else {
        s = dot<D>(qr, rf_s + (j - L) * DP) * p.scale;
      }
      Pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float den = 0.f;
    for (int j = lane; j < LC; j += 32) {
      const float e = expf(Pw[j] - mx);
      den += e;
      Pw[j] = round_to<T>(e);
    }
    den = warp_sum(den);
    __syncwarp();
    for (int c = lane; c < D; c += 32) {
      const float acc = weighted_sum<DP>(Pw, v_s + k0 * DP, L, c)
                        + weighted_sum<DP>(Pw + L, beta_s, C, c);
      out[(size_t)n * HD + c] = from_f<T>(acc / den);
    }
    __syncwarp();  // Pw is rewritten by the warp's next row
  }
}

template <int D, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const Layout lay = make_layout(D, p.ws, p.ext, p.C, p.wpb);
  auto kernel = eva_1d_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return err;
  const int runs = (p.N / p.ws + p.wpb - 1) / p.wpb;
  kernel<<<dim3(runs, p.nh, p.B), kThreads, lay.total, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const Params& p, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch<D, __nv_bfloat16>(p, stream) : launch<D, float>(p, stream);
}

}  // namespace

extern "C" {

// Shared memory of one block.
int eva_1d_smem_bytes(int d, int ws, int ext, int C, int wpb) {
  return (int)make_layout(d, ws, ext, C, wpb).total;
}

const char* eva_1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: out [B, N, nh*d] from qkv, rf, beta (float32 or
// bfloat16, one type, 16-byte aligned), mask (one byte a token [B, N], 1 =
// pad, or null) and bias (f32 [nh, ws, ws + 2*ext] or null).  Returns a
// cudaError_t (0 on success).
int eva_1d_launch(const void* qkv, const void* rf, const void* beta,
                  const uint8_t* mask, const float* bias, void* out, int B, int N,
                  int nh, int d, int ws, int ext, int C, int wpb, int is_bf16,
                  float scale, void* stream) {
  if (B <= 0 || N <= 0 || nh <= 0 || ws <= 0 || ext < 0 || C <= 0 || wpb <= 0 || N % ws)
    return cudaErrorInvalidValue;
  Params p = {};
  p.qkv = qkv; p.rf = rf; p.beta = beta; p.mask = mask; p.bias = bias; p.out = out;
  p.B = B; p.N = N; p.nh = nh; p.ws = ws; p.ext = ext; p.C = C; p.wpb = wpb;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_dtype<16>(p, is_bf16, s);
    case 32: return launch_dtype<32>(p, is_bf16, s);
    case 64: return launch_dtype<64>(p, is_bf16, s);
    case 128: return launch_dtype<128>(p, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
