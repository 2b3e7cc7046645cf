// The data movement of K6's ring route alone, at its plan's layout for head
// dim 64 (4 warps, 64-row tiles, 4 slots, three blocks an SM), to time
// against the kernel (scripts/torch_performer_fused_check.py): a block an
// (image, head), pass A's k tiles, pass B's k and v tiles and pass C's q
// tiles through the same cp.async slot ring, one barrier a step, and pass
// C's output rows written from the q slot; no arithmetic.  mode 0: all of
// it; 1: pass A only; 2: passes A-C without the output writes.  Built by the
// script with nvcc; not part of the port.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64, T = 64, R = 4, RB = (D + 8) * 2, kThreads = 128;

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
    movement_kernel(const __nv_bfloat16* qkv, __nv_bfloat16* out, int N, int nh, int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, h = blockIdx.x % nh, b = blockIdx.x / nh;
  const int HD = nh * D, row3 = 3 * HD, nt = (N + T - 1) / T;
  const int steps = (mode == 1 ? 1 : 3) * nt;
  const int cv = tid % 8, cr = tid / 8, rstep = kThreads / 8;
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  auto uses = [](int pass) { return pass == 1 ? 2 : 1; };
  int issued = 0, ppass = 0, pt = 0, pslot = 0, pcum = 0;
  auto issue_next = [&]() {
    const int sec = ppass == 2 ? 0 : 1, rows = min(T, N - pt * T);
    const uint32_t x = pslot * T * RB, v = (pslot + 1 < R ? pslot + 1 : 0) * T * RB;
    const __nv_bfloat16* src =
        qkv + ((size_t)b * N + (size_t)pt * T + cr) * row3 + sec * HD + h * D + 8 * cv;
    for (int r = cr; r < rows; r += rstep, src += (size_t)rstep * row3) {
      cp16(s0 + x + r * RB + 16 * cv, src);
      if (ppass == 1) cp16(s0 + v + r * RB + 16 * cv, src + HD);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    pcum += uses(ppass);
    pslot += uses(ppass);
    if (pslot >= R) pslot -= R;
    if (++pt == nt) pt = 0, ++ppass;
    ++issued;
  };
  auto issue_ahead = [&](int from, int from_cum) {
    while (issued < steps && issued - from < R && pcum + uses(ppass) - from_cum <= R)
      issue_next();
  };
  issue_ahead(0, 0);
  int ccum = 0, cslot = 0, cuse = 0;
  for (int s = 0; s < steps; ++s) {
    const int pass = s / nt, t = s % nt;
    ccum += cuse;
    cslot += cuse;
    if (cslot >= R) cslot -= R;
    cuse = uses(pass);
    wait_pending(issued - s - 1);
    __syncthreads();
    issue_ahead(s, ccum);
    if (pass == 2 && mode == 0) {
      const int rows = min(T, N - t * T);
      for (int e = tid; e < rows * 8; e += kThreads) {
        const int r = e / 8, c = e % 8;
        *reinterpret_cast<uint4*>(out + ((size_t)b * N + t * T + r) * HD + h * D + 8 * c) =
            *reinterpret_cast<const uint4*>(smem + cslot * T * RB + r * RB + 16 * c);
      }
    }
  }
  wait_pending(0);
}

}  // namespace

// out [B, N, nh*64] from qkv [B, N, 3*nh*64] (bf16) on `stream`; a cudaError_t.
extern "C" int performer_fused_movement_launch(const void* qkv, void* out, int B, int N, int nh,
                                               int mode, void* stream) {
  const int smem = R * T * RB;
  cudaError_t err = cudaFuncSetAttribute(movement_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  movement_kernel<<<B * nh, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), N, nh, mode);
  return cudaGetLastError();
}
