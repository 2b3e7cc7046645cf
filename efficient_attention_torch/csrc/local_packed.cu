// K7 local_packed: exact 2-D window attention over the packed qkv (forward).
//
// Replaces efficient_attention_tpu/ops/pallas/local_packed.py::local_attention_packed
// (_fwd, _kernel).  Plain version and wrapper:
// efficient_attention_torch/ops/kernels/local_packed.py.
//
// Function.  qkv [B, N, 3*H*D] holds q, k, v side by side.  Each query of head
// h attends over the keys of its own ws x ws window, plus the RPE bias
// [H, S, S], in one softmax scaled by `scale`; out [B, N, H*D].  It is K1
// (eva_packed.cu) without chunk columns, and its device code is K1's forward
// with those columns taken out.
//
// What bounds it: bytes.  At the DeiT-tiny-p8 serving shape (B=128, 28x28
// tokens, 3 heads of 64, bf16) it must read qkv (115.6 MB) and write the
// output (38.5 MB): ~46 us at 3.35 TB/s, against ~4.8 us for its 4.7 GFLOP
// (two products of N x S x D per image and head) at the bf16 tensor-core
// peak.
//
// Design (CUDA-core route, f32 inputs or head dims not a multiple of 16; the
// bf16 route below runs both products on tensor cores).  A block takes `wpb`
// windows of one (image, head) in turn and keeps
// a window in shared memory in f32 (bf16 inputs convert exactly): its S query,
// key and value rows and its S x S logits, plus the head's bias.  Each product
// is a loop over shared memory in which a thread holds a register tile of
// outputs (7x4 logits, or 4 rows by 4 columns of the D-wide output), so a
// 16-byte load feeds 4 to 7 FMAs; rows of D are padded to a stride of 4
// (mod 8) floats, so the 8 threads of a quarter-warp reading 8 rows hit all
// 32 banks.  Roundings follow the TPU kernel: logits and softmax in f32, the
// normalised probabilities rounded to the input type before their product
// with v, the product summed in f32, the output cast last.  CUDA cores only:
// no wgmma, TMA or pipelining.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_tile.cuh"

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

// ---- the bf16 route: both products of a window on tensor cores ----
//
// For bf16 inputs whose head dim is a multiple of 16, the window's q, k, v
// rows are held in bf16 (padded with zero rows to SP, a multiple of 16: 49 ->
// 64) and both products run as warp-level bf16 MMA (16x16x16 tiles, f32
// accumulation).  Their operands are values of bf16 already (q, k, v, and P
// rounded as above), so only the summation order differs from the CUDA-core
// route; the padded columns are left out of the softmax and get P = 0.

using smem_tile::bf16;
using smem_tile::round16;
using smem_tile::align128;

__host__ __device__ inline bool uses_mma(int d) { return d % 16 == 0; }

struct MmaLayout {
  size_t q, keys, vals, F, P, bias, total;
};

// The bf16 route's shared memory (smem_bytes(..., itemsize=2) in the
// wrapper): q, k, v [SP][d + 8] and P [SP][SP + 8] in bf16, an f32 region for
// the logits [SP][SP + 4] or the output tile [SP][d + 4], and the bias.
__host__ __device__ inline MmaLayout make_mma_layout(int D, int S) {
  const size_t SP = round16(S), DB = D + 8;
  const size_t FS = SP * (SP + 4) > SP * (D + 4) ? SP * (SP + 4) : SP * (D + 4);
  MmaLayout L = {};
  size_t o = 0;
  L.q = o;     o += align128(SP * DB * 2);
  L.keys = o;  o += align128(SP * DB * 2);
  L.vals = o;  o += align128(SP * DB * 2);
  L.F = o;     o += align128(FS * 4);
  L.P = o;     o += align128(SP * (SP + 8) * 2);
  L.bias = o;  o += align128((size_t)S * S * 4);
  L.total = o;
  return L;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3) local_packed_mma_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DB = D + 8, KD = D + 4, V8 = D / 8;
  const int S = p.S, SP = round16(S), LS = SP + 4, PS = SP + 8;
  const MmaLayout L = make_mma_layout(D, S);
  bf16* q = reinterpret_cast<bf16*>(smem + L.q);        // [SP][DB]
  bf16* keys = reinterpret_cast<bf16*>(smem + L.keys);  // [SP][DB]
  bf16* vals = reinterpret_cast<bf16*>(smem + L.vals);  // [SP][DB]
  float* F = reinterpret_cast<float*>(smem + L.F);      // [SP][LS] or [SP][KD]
  bf16* P = reinterpret_cast<bf16*>(smem + L.P);        // [SP][PS]
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);  // [S][S]
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int HD = p.nh * D;
  const bf16* qkv = static_cast<const bf16*>(p.qkv) + (size_t)b * p.N * 3 * HD + h * D;
  bf16* out = static_cast<bf16*>(p.out) + (size_t)b * p.N * HD + h * D;

  // the padded rows of q, k, v and the padded rows and columns of P stay 0
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < SP * DB; e += kThreads) q[e] = keys[e] = vals[e] = zero;
  for (int e = threadIdx.x; e < SP * PS; e += kThreads) P[e] = zero;
  const float* bh = p.bias != nullptr ? p.bias + (size_t)h * S * S : nullptr;
  for (int e = threadIdx.x; e < S * S; e += kThreads)
    bias_s[e] = bh != nullptr ? bh[e] : 0.f;
  for (int wi = 0; wi < p.wpb; ++wi) {
    const int w = blockIdx.x * p.wpb + wi;
    for (int e = threadIdx.x; e < S * 3 * V8; e += kThreads) {
      const int v = e % V8, part = (e / V8) % 3, l = e / (3 * V8);
      const uint4 x = *reinterpret_cast<const uint4*>(
          qkv + (size_t)window_token(p, w, l) * 3 * HD + part * HD + 8 * v);
      *reinterpret_cast<uint4*>((part == 0 ? q : part == 1 ? keys : vals) + l * DB + 8 * v) = x;
    }
    __syncthreads();
    smem_tile::mma_nt2(q, keys, F, nullptr, nullptr, nullptr, DB, SP, SP, D, LS);
    __syncthreads();
    // softmax in f32, normalised, then rounded to bf16 for the value product
    for (int i = warp; i < S; i += kWarps) {
      float* row = F + i * LS;
      float mx = -INFINITY;
      for (int j = lane; j < S; j += 32) {
        row[j] = row[j] * p.scale + bias_s[i * S + j];
        mx = fmaxf(mx, row[j]);
      }
      mx = warp_max(mx);
      float den = 0.f;
      for (int j = lane; j < S; j += 32) {
        row[j] = expf(row[j] - mx);
        den += row[j];
      }
      den = warp_sum(den);
      for (int j = lane; j < S; j += 32) P[i * PS + j] = __float2bfloat16(row[j] / den);
    }
    __syncthreads();
    for (int f = warp; f < (SP / 16) * (D / 16); f += kWarps) {
      const int i = f / (D / 16), j = f % (D / 16);
      smem_tile::FragA a;
      smem_tile::FragBr bv;
      smem_tile::FragC c;
      smem_tile::wm::fill_fragment(c, 0.f);
      for (int k = 0; k < SP; k += 16) {
        smem_tile::wm::load_matrix_sync(a, P + 16 * i * PS + k, PS);
        smem_tile::wm::load_matrix_sync(bv, vals + k * DB + 16 * j, DB);
        smem_tile::wm::mma_sync(c, a, bv, c);
      }
      smem_tile::wm::store_matrix_sync(F + 16 * i * KD + 16 * j, c, KD,
                                       smem_tile::wm::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < S * D; e += kThreads) {
      const int i = e / D, x = e % D;
      out[(size_t)window_token(p, w, i) * HD + x] = __float2bfloat16(F[i * KD + x]);
    }
    __syncthreads();  // q, k, v, F and P are rewritten by the next window
  }
}

template <int D, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int n_win = (p.N / p.gw / p.ws) * p.nww;
  if constexpr (D % 16 == 0) {  // uses_mma(D)
    if (sizeof(T) == 2) {
      const MmaLayout L = make_mma_layout(D, p.S);
      auto kernel = local_packed_mma_kernel<D>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
      if (err != cudaSuccess) return err;
      kernel<<<dim3(n_win / p.wpb, p.nh, p.B), kThreads, L.total, stream>>>(p);
      return cudaGetLastError();
    }
  }
  const Layout L = make_layout(D, p.S);
  auto kernel = local_packed_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_win / p.wpb, p.nh, p.B), kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const Params& p, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch<D, __nv_bfloat16>(p, stream) : launch<D, float>(p, stream);
}

}  // namespace

extern "C" {

// Shared memory of one block of the route that (d, S, is_bf16) takes.
int local_packed_smem_bytes(int d, int S, int is_bf16) {
  return (int)(is_bf16 && uses_mma(d) ? make_mma_layout(d, S).total
                                      : make_layout(d, S).total);
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
