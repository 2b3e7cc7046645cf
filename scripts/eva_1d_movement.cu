// The data movement of K4's f32 route alone, at head dim 64, to time against
// the kernel (scripts/torch_eva_1d_check.py): the same grid of a block an
// item, each item's q rows, halo'd key and value rows (zero outside [0, N))
// and chunk rows by 16-byte cp.async, one barrier, and the item's output
// rows written from its q rows; no arithmetic, and no key mask (a byte a
// token).  mode 0: all of it; 1: without the output writes.
// Built by the script with nvcc; not part of the port.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64, KS = D + 16, VS = D + 4, V4 = D / 4;

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline int key_rows(int rows, int ws, int ext) {
  const int windows = rows % ws == 0 ? rows / ws : (ws % rows == 0 ? 1 : rows / ws + 2);
  return round8(windows * ws + 2 * ext + 7);
}

struct Slot {
  size_t q, k, v, rf, beta, size;
};

__host__ __device__ inline Slot make_slot(int ws, int ext, int C, int rows) {
  const size_t KR = key_rows(rows, ws, ext), CR = round8(C);
  Slot s = {};
  size_t o = 0;
  s.q = o;     o += align128((size_t)rows * KS * 4);
  s.k = o;     o += align128(KR * KS * 4);
  s.v = o;     o += align128(KR * VS * 4);
  s.rf = o;    o += align128(CR * KS * 4);
  s.beta = o;  o += align128(CR * VS * 4);
  s.size = o;
  return s;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

struct Args {
  const float *qkv, *rf, *beta;
  float* out;
  int B, N, nh, ws, ext, C, rows, runs, mode;
};

__global__ void __launch_bounds__(256) movement_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Slot L = make_slot(a.ws, a.ext, a.C, a.rows);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int HD = a.nh * D, row3 = 3 * HD, KR = key_rows(a.rows, a.ws, a.ext), CR = round8(a.C);
  const int i = blockIdx.x, rest = i / a.nh;
  const int h = i - rest * a.nh, b = rest / a.runs, r0 = (rest % a.runs) * a.rows;
  const int nq = min(a.rows, a.N - r0), kp0 = (r0 / a.ws) * a.ws - a.ext;
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ks = reinterpret_cast<float*>(smem + L.k);
  float* vs = reinterpret_cast<float*>(smem + L.v);
  float* rfs = reinterpret_cast<float*>(smem + L.rf);
  float* bts = reinterpret_cast<float*>(smem + L.beta);
  const float* src = a.qkv + (size_t)b * a.N * row3 + h * D;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < a.rows * V4; e += nthr) {
    const int r = e / V4, c = 4 * (e % V4);
    if (r < nq) cp16(qs + r * KS + c, src + (size_t)(r0 + r) * row3 + c);
    else *reinterpret_cast<float4*>(qs + r * KS + c) = z;
  }
  const int kp1 = ((r0 + nq - 1) / a.ws + 1) * a.ws + a.ext;
  for (int e = tid; e < KR * V4; e += nthr) {
    const int r = e / V4, c = 4 * (e % V4), n = kp0 + r;
    if (n >= 0 && n < a.N && n < kp1) {
      cp16(ks + r * KS + c, src + (size_t)n * row3 + HD + c);
      cp16(vs + r * VS + c, src + (size_t)n * row3 + 2 * HD + c);
    } else {
      *reinterpret_cast<float4*>(ks + r * KS + c) = z;
      *reinterpret_cast<float4*>(vs + r * VS + c) = z;
    }
  }
  const size_t cb = (size_t)b * a.C * HD + h * D;
  for (int e = tid; e < CR * V4; e += nthr) {
    const int r = e / V4, c = 4 * (e % V4);
    if (r < a.C) {
      cp16(rfs + r * KS + c, a.rf + cb + (size_t)r * HD + c);
      cp16(bts + r * VS + c, a.beta + cb + (size_t)r * HD + c);
    } else {
      *reinterpret_cast<float4*>(rfs + r * KS + c) = z;
      *reinterpret_cast<float4*>(bts + r * VS + c) = z;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (a.mode == 0) {
    for (int e = tid; e < nq * V4; e += nthr) {
      const int r = e / V4, c = 4 * (e % V4);
      *reinterpret_cast<float4*>(a.out + ((size_t)b * a.N + r0 + r) * HD + h * D + c) =
          *reinterpret_cast<const float4*>(qs + r * KS + c);
    }
  }
}

}  // namespace

// out [B, N, nh*64] from qkv [B, N, 3*nh*64], rf and beta [B, C, nh*64]
// (f32) on `stream`, a block of rows / 16 warps an item of `rows` query
// rows; a cudaError_t.
extern "C" int eva_1d_movement_launch(const void* qkv, const void* rf, const void* beta,
                                      void* out, int B, int N, int nh, int ws, int ext, int C,
                                      int rows, int mode, void* stream) {
  Args a = {static_cast<const float*>(qkv), static_cast<const float*>(rf),
            static_cast<const float*>(beta), static_cast<float*>(out),
            B, N, nh, ws, ext, C, rows, (N + rows - 1) / rows, mode};
  const size_t smem = make_slot(ws, ext, C, rows).size;
  cudaError_t err = cudaFuncSetAttribute(movement_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  movement_kernel<<<B * nh * a.runs, rows / 16 * 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
