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
// 8 heads of 64, ws 8, ext 4, C=8, f32) it reads qkv (12.6 MB) and the chunk
// keys and values (2.1 MB) and writes the output (4.2 MB): 18.9 MB, 5.64 us
// at 3.35 TB/s, against ~0.4 us for its 25 MFLOP (two products over 24
// columns of 64 per query and head) at the f32 peak.
//
// Two kernels.  f32 takes eva_1d_tf32x3_kernel (the route below, where the
// wrapper's plan() finds an item size: head dims 16, 32, 64, 128, any
// window, halo and C >= 1 whose block fits); bf16, and f32 where plan()
// finds none, the CUDA-core kernel eva_1d_kernel.
//
// The CUDA-core kernel.  Only each query's own ws + 2*ext + C columns are
// computed (the TPU kernel builds a dense masked [TGS, TGS + 2*ext] table
// per strip).  A block takes a run of wpb whole windows (16 query rows at
// ws = 8, the wrapper's choice) of one (sentence, head) and stages in shared
// memory, in 16-byte loads converted to f32 (bf16 converts exactly): the
// run's q rows, its k and v rows with ext halo rows on each side (zero
// outside [0, N)), the head's C chunk keys and values, the bias table and the
// run's additive key mask.  A warp takes one query row at a time: each lane
// computes logits of its columns (a dot product of D over shared-memory rows
// at an odd stride, so the 32 lanes hit 32 banks, in four independent
// partial sums), the warp reduces the max and the sum, and each lane then
// sums p times [v | beta] for its own output columns.  It costs two scalar
// shared loads an FMA, and no load overlaps compute.
//
// The f32 route keeps the bytes moving and the arithmetic off the CUDA
// cores:
//  * a block takes one item, a run of `rows` query rows (16 to 128; at the
//    recipe a whole sentence of one head) of one (sentence, head), a warp a
//    16-row strip.  Its q rows, the keys and values of its windows with
//    their halos (each row read once an item; rows outside [0, N) are
//    zero-filled in shared memory and never read), and the head's chunk
//    keys and values come into shared memory by 16-byte cp.async in qkv's
//    own layout, at padded strides (the fragment loads below are
//    conflict-free): no conversion pass, no scalar stores.  The heads of one
//    run are neighbours in the grid, so the blocks read a row's head slices
//    together.  A block an item keeps every strip of the launch resident at
//    the WMT shapes, and the products (not the loads) take most of the time:
//    a ring of slots in persistent blocks lost to it (PERF.md);
//  * the key mask of an item's key rows is written once into shared
//    memory; the bias is read from L2 into registers before the products;
//  * a warp owns 16 consecutive query rows.  Its columns are the union of
//    its rows' halo'd windows plus the C chunk keys, in tiles of 8; a local
//    column outside a row's own window, and a padding column of a tile,
//    gets exactly zero weight (as in the parent, which never computes
//    them).  Logits = Q K^T on split-TF32 mma.sync m16n8k8 (three products
//    a fragment pair, mma_frag.cuh: plain TF32 would miss the f32 limit);
//    bias, key mask and window mask are applied on the accumulator
//    fragments, max and sum over the quad; p = exp(logit - max) stays in
//    registers as the A fragments of P [v | beta], again in split TF32.  No
//    logit row in shared memory.  Columns come in groups of 4 tiles (32,
//    the recipe's 24 local + 8 chunk columns in one) with a running max
//    across groups, so any window and C fit the registers;
//  * out = O / (f32 sum of p), as O times the sum's reciprocal, two 16-byte
//    stores a row and 32 columns.
// In f32, rounding p to qkv's type is the identity.
#include "mma_frag.cuh"
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskVal = -5e4f;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

// Built with -DEVA1D_PHASES (scripts/torch_eva_1d_check.py), lane 0 of each
// warp sums the SM cycles it spends in each phase (the staging and its
// barrier, the logits, the softmax, the output product and its writes) and
// stores them into g_eva1d_phases[0..3][warp] and the global timer at its
// start and end into [4] and [5]; eva_1d_phases_copy reads them back.  A warp's slot is its
// block's linear index times the block's warps plus its own.  Without the
// flag the marks compile to nothing.
enum Phase { kPhaseStage, kPhaseLogits, kPhaseSoftmax, kPhaseOutput, kPhases };

#ifdef EVA1D_PHASES
constexpr int kPhaseSlots = 1 << 16;
__device__ unsigned long long g_eva1d_phases[kPhases + 2][kPhaseSlots];
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
  __device__ __forceinline__ void finish() {
    const unsigned blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    const unsigned slot = blk * (blockDim.x / 32) + threadIdx.x / 32;
    if ((threadIdx.x & 31) != 0 || slot >= kPhaseSlots) return;
    unsigned long long t1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
#pragma unroll
    for (int i = 0; i < kPhases; ++i) g_eva1d_phases[i][slot] = acc[i];
    g_eva1d_phases[kPhases][slot] = t0;
    g_eva1d_phases[kPhases + 1][slot] = t1;
  }
};
#else
struct PhaseClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void finish() {}
};
#endif

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
  PhaseClock ph;
  ph.start();

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
  ph.mark(kPhaseStage);

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
    ph.mark(kPhaseLogits);
    mx = warp_max(mx);
    float den = 0.f;
    for (int j = lane; j < LC; j += 32) {
      const float e = expf(Pw[j] - mx);
      den += e;
      Pw[j] = round_to<T>(e);
    }
    den = warp_sum(den);
    __syncwarp();
    ph.mark(kPhaseSoftmax);
    for (int c = lane; c < D; c += 32) {
      const float acc = weighted_sum<DP>(Pw, v_s + k0 * DP, L, c)
                        + weighted_sum<DP>(Pw + L, beta_s, C, c);
      out[(size_t)n * HD + c] = from_f<T>(acc / den);
    }
    __syncwarp();  // Pw is rewritten by the warp's next row
    ph.mark(kPhaseOutput);
  }
  ph.finish();
}

constexpr int kMaxDevices = 64;

// The device the calling thread works on, or -1.
inline int current_device() {
  int dev = -1;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kMaxDevices ? dev : -1;
}

// Raises `kernel`'s dynamic shared-memory limit to the most a block may use,
// once for each device (`done` is the instantiation's own record).
template <typename K>
cudaError_t allow_smem(K kernel, bool (&done)[kMaxDevices]) {
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <int D, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const Layout lay = make_layout(D, p.ws, p.ext, p.C, p.wpb);
  static bool done[kMaxDevices] = {};
  cudaError_t err = allow_smem(eva_1d_kernel<D, T>, done);
  if (err != cudaSuccess) return err;
  const int runs = (p.N / p.ws + p.wpb - 1) / p.wpb;
  eva_1d_kernel<D, T><<<dim3(runs, p.nh, p.B), kThreads, lay.total, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const Params& p, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch<D, __nv_bfloat16>(p, stream) : launch<D, float>(p, stream);
}

// ---- the f32 route: split-TF32 mma.sync strips fed by cp.async ----
// (the header comment says what it is for; the layout's twins are in
// ops/kernels/eva_1d.py)

constexpr int kTfMaxRows = 128;  // query rows an item: a warp a 16-row strip
constexpr int kTfGroup = 4;  // column tiles of 8 a strip holds in registers at once

// Row strides (floats) of the q, key and chunk-key rows (16 mod 32: a
// quarter warp reads 16 floats of each of two rows) and of the value and
// chunk-value rows (4 mod 32 for float4 loads at column 4g of rows 2c, g <
// 2, c < 4; 20 at head dim 16 for float2 loads at column 2g, g < 4).
__host__ __device__ constexpr int tf_k_stride(int D) { return D % 32 == 0 ? D + 16 : D + 32; }
__host__ __device__ constexpr int tf_v_stride(int D) { return D + 4; }

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Key rows of a block: the halo'd windows that a run of `rows` query rows
// (starting at a multiple of `rows`) touches, and 7 more for the strips'
// last column tile of 8.
__host__ __device__ inline int tf_key_rows(int rows, int ws, int ext) {
  const int windows = rows % ws == 0 ? rows / ws : (ws % rows == 0 ? 1 : rows / ws + 2);
  return round8(windows * ws + 2 * ext + 7);
}

// Offsets (bytes) of a block's regions and its total; the same layout as
// tf32_smem_bytes() in ops/kernels/eva_1d.py.  A block holds one item: its
// q rows [rows][KS], its key and value rows [KR][KS] and [KR][VS] (zero
// outside [0, N) and past its windows' halos), its chunk keys and values
// [round8(C)][KS] and [..][VS] (zero past C), and what each key row adds to
// its logits [KR] (MASK_VAL at padding and outside [0, N), else 0), all
// f32, each region 128-byte aligned.
struct TfLayout {
  size_t q, k, v, rf, beta, add, total;
};

__host__ __device__ inline TfLayout make_tf_layout(int D, int ws, int ext, int C, int rows) {
  const size_t KS = tf_k_stride(D), VS = tf_v_stride(D);
  const size_t KR = tf_key_rows(rows, ws, ext), CR = round8(C);
  TfLayout L = {};
  size_t o = 0;
  L.q = o;     o += align128(rows * KS * 4);
  L.k = o;     o += align128(KR * KS * 4);
  L.v = o;     o += align128(KR * VS * 4);
  L.rf = o;    o += align128(CR * KS * 4);
  L.beta = o;  o += align128(CR * VS * 4);
  L.add = o;   o += align128(KR * 4);
  L.total = o;
  return L;
}

// Whether the route takes this geometry and item size (tf32_config_ok() in
// the wrapper): head dim 16, 32, 64 or 128, a window, a halo >= 0 and a
// chunk; items of 16 to 128 query rows in steps of 16, and the block within
// Hopper's shared memory.
__host__ __device__ inline bool tf_config_ok(int D, int ws, int ext, int C, int rows) {
  if (!(D == 16 || D == 32 || D == 64 || D == 128) || ws < 1 || ext < 0 || C < 1) return false;
  if (rows < 16 || rows > kTfMaxRows || rows % 16) return false;
  return make_tf_layout(D, ws, ext, C, rows).total <= (size_t)kSmemLimit;
}

struct TfParams {
  const float* qkv;     // [B, N, 3*nh*D]
  const float* rf;      // [B, C, nh*D]
  const float* beta;    // [B, C, nh*D]
  const uint8_t* mask;  // [B, N] (1 = pad) or null
  const float* bias;    // [nh, ws, ws + 2*ext] or null
  float* out;           // [B, N, nh*D]
  int B, N, nh, ws, ext, C;
  int rows, runs;       // query rows an item, runs of `rows` rows a sentence
  float scale;
};

__device__ __forceinline__ void zero16(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// An item: query rows r0 .. r0 + nq - 1 of head h of sentence b, its key
// rows staged from position kp0.
struct TfItem {
  int b, h, r0, nq, kp0;
};

// The block's item: block i takes head i % nh of run (i / nh) % runs of
// sentence i / (nh runs), so the heads of one run are neighbours in the grid
// and read its rows together (tf32_walk() in the wrapper).
__device__ __forceinline__ TfItem tf_item(const TfParams& p) {
  const int i = blockIdx.x, rest = i / p.nh, run = rest % p.runs;
  TfItem it;
  it.h = i - rest * p.nh;
  it.b = rest / p.runs;
  it.r0 = run * p.rows;
  it.nq = min(p.rows, p.N - it.r0);
  it.kp0 = (it.r0 / p.ws) * p.ws - p.ext;
  return it;
}

// One 16-row strip of an item (rows r0 + s0 ..; its rows at `s`): logits
// over the union of its windows' halo'd keys and the chunk keys in groups of
// kTfGroup column tiles, each group's products on split TF32, the running
// max and sum, p in registers as the A fragments of the output product, and
// the rows below N written.
template <int D>
__device__ __forceinline__ void tf_strip(const TfParams& p, const TfItem& it,
                                         const unsigned char* s, const TfLayout& L, int s0,
                                         PhaseClock& ph) {
  using namespace mma_frag;
  constexpr int KS = tf_k_stride(D), VS = tf_v_stride(D), KP = D / 16;
  constexpr int VW = D % 32 == 0 ? 4 : 2;  // value columns a lane reads at once
  constexpr int NQ = D / (8 * VW);         // groups of VW output n-tiles
  const int lane = threadIdx.x & 31, gq = lane >> 2, cq = lane & 3;
  const int N = p.N, ws = p.ws, ext = p.ext, C = p.C, LW = ws + 2 * ext;
  // the strip's columns: local keys P0 .. P0 + nloc - 1 (its windows with
  // their halos) in nlt tiles, then the chunks in nct tiles
  const int n0 = it.r0 + s0, last = min(n0 + 16, N) - 1;
  const int P0 = (n0 / ws) * ws - ext;
  const int nloc = (last / ws + 1) * ws + ext - P0;
  const int nlt = (nloc + 7) >> 3, NT = nlt + (round8(C) >> 3);
  const float* qs = reinterpret_cast<const float*>(s + L.q) + s0 * KS;
  const float* kst = reinterpret_cast<const float*>(s + L.k) + (P0 - it.kp0) * KS;
  const float* vst = reinterpret_cast<const float*>(s + L.v) + (P0 - it.kp0) * VS;
  const float* rfs = reinterpret_cast<const float*>(s + L.rf);
  const float* bts = reinterpret_cast<const float*>(s + L.beta);
  const float* adds = reinterpret_cast<const float*>(s + L.add) + (P0 - it.kp0);
  // the thread's rows n0 + gq + 8r: the strip column where its window's
  // keys start, and its bias row (rows past N see no local column)
  int woff[2];
  const float* brow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + gq + 8 * r, w0 = (n / ws) * ws - ext;
    woff[r] = n < N ? w0 - P0 : nloc + 8;
    brow[r] = p.bias != nullptr && n < N
                  ? p.bias + ((size_t)it.h * ws + (n - w0 - ext)) * LW : nullptr;
  }

  // o[nq][tt]: output n-tile tt of group nq, its column g is d = 8 VW nq + VW g + tt
  float o[NQ][VW][4];
#pragma unroll
  for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
    for (int tt = 0; tt < VW; ++tt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nq][tt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t0 = 0; t0 < NT; t0 += kTfGroup) {
    // the bias of each logit of the group, read before the products so that
    // the loads overlap them: element e of tile i is row gq + 8(e / 2),
    // strip column 8 (t0 + i) + 2cq + e % 2; -inf where the column weighs
    // nothing (a local column outside the row's window or past the strip's
    // keys, a chunk column past C), 0 for the chunk columns
    float bv[kTfGroup][4];
#pragma unroll
    for (int i = 0; i < kTfGroup; ++i) {
      const int t = t0 + i;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = 8 * t + 2 * cq + (e & 1);
        float a = -INFINITY;
        if (t < nlt) {
          const int u = col - woff[r];
          if (u >= 0 && u < LW) a = brow[r] != nullptr ? __ldg(brow[r] + u) : 0.f;
        } else if (t < NT && col - 8 * nlt < C) {
          a = 0.f;
        }
        bv[i][e] = a;
      }
    }
    // the lane's key row (gq) of each tile of the group
    const float* kr[kTfGroup];
#pragma unroll
    for (int i = 0; i < kTfGroup; ++i) {
      const int t = t0 + i;
      kr[i] = (t < nlt ? kst + 8 * t * KS : rfs + 8 * (t - nlt) * KS) + gq * KS + 4 * cq;
    }
    // S = Q K^T: hi hi into sb, lo hi into sl, hi lo into sh (three
    // independent chains a tile)
    float sb[kTfGroup][4], sl[kTfGroup][4], sh[kTfGroup][4];
#pragma unroll
    for (int i = 0; i < kTfGroup; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[i][e] = sl[i][e] = sh[i][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      // rows gq and gq + 8, columns 16kp + 4cq .. + 3: k-step 2kp takes
      // .x (A column cq) and .y (column cq + 4), k-step 2kp + 1 .z, .w
      const float* qr = qs + gq * KS + 16 * kp + 4 * cq;
      const float4 qa0 = *reinterpret_cast<const float4*>(qr);
      const float4 qa1 = *reinterpret_cast<const float4*>(qr + 8 * KS);
      float4 kk[kTfGroup];
#pragma unroll
      for (int i = 0; i < kTfGroup; ++i)
        if (t0 + i < NT) kk[i] = *reinterpret_cast<const float4*>(kr[i] + 16 * kp);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float av[4] = {half ? qa0.z : qa0.x, half ? qa1.z : qa1.x,
                             half ? qa0.w : qa0.y, half ? qa1.w : qa1.y};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(av[e], ah[e], al[e]);
#pragma unroll
        for (int i = 0; i < kTfGroup; ++i) {
          if (t0 + i < NT) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(half ? kk[i].z : kk[i].x, bh0, bl0);
            split_tf32(half ? kk[i].w : kk[i].y, bh1, bl1);
            mma_tf32(sl[i], al, bh0, bh1);
            mma_tf32(sh[i], ah, bl0, bl1);
            mma_tf32(sb[i], ah, bh0, bh1);
          }
        }
      }
    }
    ph.mark(kPhaseLogits);

    // logits scale <q, k> + bias + the key row's mask, and the group's row
    // maxima
    float sv[kTfGroup][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kTfGroup; ++i) {
      const int t = t0 + i;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float acc = sb[i][e] + (sl[i][e] + sh[i][e]);
        const float key = t < nlt ? adds[8 * t + 2 * cq + (e & 1)] : 0.f;
        sv[i][e] = bv[i][e] == -INFINITY ? -INFINITY : fmaf(acc, p.scale, bv[i][e]) + key;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv[i][e]);
      }
    }
    // the running max (rows that see nothing yet keep -inf and weigh 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      const float mref = mn == -INFINITY ? 0.f : mn;
      const float alpha = expf(m[r] - mref);
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int nq = 0; nq < NQ; ++nq)
#pragma unroll
        for (int tt = 0; tt < VW; ++tt) {
          o[nq][tt][2 * r] *= alpha;
          o[nq][tt][2 * r + 1] *= alpha;
        }
      mx[r] = mref;
    }
#pragma unroll
    for (int i = 0; i < kTfGroup; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sv[i][e] = expf(sv[i][e] - mx[e >> 1]);
        l[e >> 1] += sv[i][e];
      }
    ph.mark(kPhaseSoftmax);

    // O += P [v | beta]: tile i is k-step i, A column cq as its key 2cq and
    // column cq + 4 as key 2cq + 1
#pragma unroll
    for (int i = 0; i < kTfGroup; ++i) {
      const int t = t0 + i;
      if (t < NT) {
        uint32_t ah[4], al[4];
        split_tf32(sv[i][0], ah[0], al[0]);
        split_tf32(sv[i][2], ah[1], al[1]);
        split_tf32(sv[i][1], ah[2], al[2]);
        split_tf32(sv[i][3], ah[3], al[3]);
        const float* vr =
            (t < nlt ? vst + 8 * t * VS : bts + 8 * (t - nlt) * VS) + 2 * cq * VS + VW * gq;
#pragma unroll
        for (int nq = 0; nq < NQ; ++nq) {
          float b0[VW], b1[VW];
          if constexpr (VW == 4) {
            const float4 x0 = *reinterpret_cast<const float4*>(vr + 32 * nq);
            const float4 x1 = *reinterpret_cast<const float4*>(vr + VS + 32 * nq);
            b0[0] = x0.x; b0[1] = x0.y; b0[2] = x0.z; b0[3] = x0.w;
            b1[0] = x1.x; b1[1] = x1.y; b1[2] = x1.z; b1[3] = x1.w;
          } else {
            const float2 x0 = *reinterpret_cast<const float2*>(vr + 16 * nq);
            const float2 x1 = *reinterpret_cast<const float2*>(vr + VS + 16 * nq);
            b0[0] = x0.x; b0[1] = x0.y;
            b1[0] = x1.x; b1[1] = x1.y;
          }
#pragma unroll
          for (int tt = 0; tt < VW; ++tt) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(b0[tt], bh0, bl0);
            split_tf32(b1[tt], bh1, bl1);
            mma_tf32(o[nq][tt], al, bh0, bh1);
            mma_tf32(o[nq][tt], ah, bl0, bl1);
            mma_tf32(o[nq][tt], ah, bh0, bh1);
          }
        }
      }
    }
  }

  // out = O / row sum in f32 (times its reciprocal: 32 divisions a thread
  // cost more than the products); a thread's 2 VW values of a row and group
  // are columns 8 VW nq + 2 VW cq .. + 2 VW - 1
  float* out = p.out + (size_t)it.b * N * p.nh * D + it.h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / quad_sum(l[r]);
    const int n = n0 + gq + 8 * r;
    if (n >= N) continue;
    float* orow = out + (size_t)n * p.nh * D + 2 * VW * cq;
#pragma unroll
    for (int nq = 0; nq < NQ; ++nq) {
      float v[2 * VW];
#pragma unroll
      for (int tt = 0; tt < VW; ++tt) {
        v[tt] = o[nq][tt][2 * r] * inv;
        v[VW + tt] = o[nq][tt][2 * r + 1] * inv;
      }
#pragma unroll
      for (int j = 0; j < 2 * VW; j += 4)
        *reinterpret_cast<float4*>(orow + 8 * VW * nq + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  }
  ph.mark(kPhaseOutput);
}

// A block an item: its rows come into shared memory by 16-byte cp.async,
// then each warp computes one 16-row strip.
template <int D>
__global__ void __launch_bounds__(kTfMaxRows / 16 * 32) eva_1d_tf32x3_kernel(const TfParams p) {
  using namespace mma_frag;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KS = tf_k_stride(D), VS = tf_v_stride(D), V4 = D / 4;
  const TfLayout L = make_tf_layout(D, p.ws, p.ext, p.C, p.rows);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int N = p.N, ws = p.ws, ext = p.ext, C = p.C;
  const int HD = p.nh * D, row3 = 3 * HD, KR = tf_key_rows(p.rows, ws, ext), CR = round8(C);
  const TfItem it = tf_item(p);
  PhaseClock ph;
  ph.start();

  // the item's q rows (zero past N), its key and value rows (zero outside
  // [0, N) and past its last window's halo) and the chunk rows (zero past
  // C), then its key rows' mask
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ks = reinterpret_cast<float*>(smem + L.k);
  float* vs = reinterpret_cast<float*>(smem + L.v);
  float* rfs = reinterpret_cast<float*>(smem + L.rf);
  float* bts = reinterpret_cast<float*>(smem + L.beta);
  const float* src = p.qkv + (size_t)it.b * N * row3 + it.h * D;
  for (int e = tid; e < p.rows * V4; e += nthr) {
    const int r = e / V4, c = 4 * (e % V4);
    if (r < it.nq) cp_async16(qs + r * KS + c, src + (size_t)(it.r0 + r) * row3 + c);
    else zero16(qs + r * KS + c);
  }
  const int kp1 = ((it.r0 + it.nq - 1) / ws + 1) * ws + ext;
  const size_t cb = (size_t)it.b * C * HD + it.h * D;
  for (int e = tid; e < KR * V4; e += nthr) {
    const int r = e / V4, c = 4 * (e % V4), n = it.kp0 + r;
    if (n >= 0 && n < N && n < kp1) {
      const float* row = src + (size_t)n * row3 + c;
      cp_async16(ks + r * KS + c, row + HD);
      cp_async16(vs + r * VS + c, row + 2 * HD);
    } else {
      zero16(ks + r * KS + c);
      zero16(vs + r * VS + c);
    }
  }
  for (int e = tid; e < CR * V4; e += nthr) {
    const int r = e / V4, c = 4 * (e % V4);
    if (r < C) {
      cp_async16(rfs + r * KS + c, p.rf + cb + (size_t)r * HD + c);
      cp_async16(bts + r * VS + c, p.beta + cb + (size_t)r * HD + c);
    } else {
      zero16(rfs + r * KS + c);
      zero16(bts + r * VS + c);
    }
  }
  cp_async_commit();
  float* adds = reinterpret_cast<float*>(smem + L.add);
  const uint8_t* mrow = p.mask != nullptr ? p.mask + (size_t)it.b * N : nullptr;
  for (int r = tid; r < KR; r += nthr) {
    const int n = it.kp0 + r;
    adds[r] = n < 0 || n >= N || (mrow != nullptr && mrow[n]) ? kMaskVal : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  ph.mark(kPhaseStage);
  const int s0 = 16 * (tid >> 5);
  if (s0 < it.nq) tf_strip<D>(p, it, smem, L, s0, ph);
  ph.finish();
}

template <typename F>
auto with_tf_kernel(int d, F&& f) -> decltype(f(eva_1d_tf32x3_kernel<16>)) {
  switch (d) {
    case 16: return f(eva_1d_tf32x3_kernel<16>);
    case 32: return f(eva_1d_tf32x3_kernel<32>);
    case 64: return f(eva_1d_tf32x3_kernel<64>);
    case 128: return f(eva_1d_tf32x3_kernel<128>);
    default: return f(nullptr);
  }
}

// Each head dim's kernel has its own record of the devices its shared-memory
// limit was raised on.
template <int D>
bool (&tf_done())[kMaxDevices] {
  static bool done[kMaxDevices] = {};
  return done;
}

cudaError_t allow_tf_smem(int d) {
  switch (d) {
    case 16: return allow_smem(eva_1d_tf32x3_kernel<16>, tf_done<16>());
    case 32: return allow_smem(eva_1d_tf32x3_kernel<32>, tf_done<32>());
    case 64: return allow_smem(eva_1d_tf32x3_kernel<64>, tf_done<64>());
    case 128: return allow_smem(eva_1d_tf32x3_kernel<128>, tf_done<128>());
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_tf32(const TfParams& p, int d, cudaStream_t stream) {
  const TfLayout L = make_tf_layout(d, p.ws, p.ext, p.C, p.rows);
  cudaError_t err = allow_tf_smem(d);
  if (err != cudaSuccess) return err;
  return with_tf_kernel(d, [&](void (*kernel)(TfParams)) {
    if (kernel == nullptr) return cudaErrorInvalidValue;
    kernel<<<p.B * p.nh * p.runs, p.rows / 16 * 32, L.total, stream>>>(p);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Shared memory of one block of the CUDA-core kernel.
int eva_1d_smem_bytes(int d, int ws, int ext, int C, int wpb) {
  return (int)make_layout(d, ws, ext, C, wpb).total;
}

// Shared memory of one block of the f32 route at items of `rows` query
// rows, or -1 where the route does not take it (tf_config_ok).
int eva_1d_tf32_smem_bytes(int d, int ws, int ext, int C, int rows) {
  if (!tf_config_ok(d, ws, ext, C, rows)) return -1;
  return (int)make_tf_layout(d, ws, ext, C, rows).total;
}

#ifdef EVA1D_PHASES
// Copies g_eva1d_phases ([6][65536] uint64) to host memory at dst; a
// cudaError_t.
int eva_1d_phases_copy(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_eva1d_phases, sizeof(g_eva1d_phases));
}
#endif

const char* eva_1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: out [B, N, nh*d] from qkv, rf, beta (float32 or
// bfloat16, one type, 16-byte aligned), mask (one byte a token [B, N], 1 =
// pad, or null) and bias (f32 [nh, ws, ws + 2*ext] or null).  rows > 0
// launches the f32 route, a block an item of `rows` query rows (the
// wrapper's plan()), and fails where that route does not take it; rows == 0
// the CUDA-core kernel at wpb windows a block.  Returns a cudaError_t (0 on
// success).
int eva_1d_launch(const void* qkv, const void* rf, const void* beta,
                  const uint8_t* mask, const float* bias, void* out, int B, int N,
                  int nh, int d, int ws, int ext, int C, int wpb, int is_bf16,
                  float scale, int rows, void* stream) {
  if (B <= 0 || N <= 0 || nh <= 0 || ws <= 0 || ext < 0 || C <= 0 || N % ws)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows != 0) {
    if (is_bf16 || !tf_config_ok(d, ws, ext, C, rows)) return cudaErrorInvalidValue;
    TfParams t = {};
    t.qkv = static_cast<const float*>(qkv);
    t.rf = static_cast<const float*>(rf);
    t.beta = static_cast<const float*>(beta);
    t.mask = mask; t.bias = bias; t.out = static_cast<float*>(out);
    t.B = B; t.N = N; t.nh = nh; t.ws = ws; t.ext = ext; t.C = C;
    t.rows = rows;
    t.runs = (N + rows - 1) / rows;
    if ((long long)B * nh * t.runs > 0x7fffffff) return cudaErrorInvalidValue;
    t.scale = scale;
    return launch_tf32(t, d, s);
  }
  if (wpb <= 0) return cudaErrorInvalidValue;
  Params p = {};
  p.qkv = qkv; p.rf = rf; p.beta = beta; p.mask = mask; p.bias = bias; p.out = out;
  p.B = B; p.N = N; p.nh = nh; p.ws = ws; p.ext = ext; p.C = C; p.wpb = wpb;
  p.scale = scale;
  switch (d) {
    case 16: return launch_dtype<16>(p, is_bf16, s);
    case 32: return launch_dtype<32>(p, is_bf16, s);
    case 64: return launch_dtype<64>(p, is_bf16, s);
    case 128: return launch_dtype<128>(p, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
