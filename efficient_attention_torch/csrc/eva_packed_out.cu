// K9 eva_packed_out: the 2-D EVA joint softmax with the output projection in
// the kernel.
//
// Replaces efficient_attention_tpu/ops/pallas/eva_packed.py::eva_attention_packed_out
// (_fwd_fused_out, _kernel_fused_out: the eval forward behind EVA's
// fuse_output_proj).  Plain version and wrapper: eva_attention_packed_out in
// efficient_attention_torch/ops/kernels/eva_packed.py.  Device code:
// eva_out_kernel in eva_eval.cuh.
//
// Function.  K1's forward (eva_packed.cu): each query of head h attends over
// its own 7x7 window's keys (plus the RPE bias [H, S, S]) and the C chunk keys
// rf, with values [window v | beta], in one softmax; then, where K1 writes the
// [B, N, H*D] heads' output, this kernel rounds it to the input type and
// multiplies it by Wo [H*D, H*D] (+ bo, f32 sums), as the TPU kernel does, so
// that intermediate never reaches device memory.
//
// What bounds it: bytes.  At the DeiT-tiny-p8 cell (B=128, 28x28 tokens, 3
// heads of 64, bf16) it reads qkv (115.6 MB) and the summaries (4.8 MB) and
// writes the output (38.5 MB): ~47 us at 3.35 TB/s, against ~15 us for its
// 15 GFLOP (7.5 of attention, 7.4 of projection) at the bf16 tensor-core peak.
//
// Design.  A token's projection needs every head's output, so a block owns a
// window of one image for all heads: it runs K1's per-window forward for each
// head in turn (CUDA cores, f32, K1's rounding points) into the window's
// output rows in shared memory (49 x 192 in the input type), then the
// projection of those rows.  In bf16 with head dims that are multiples of 16
// the projection runs on tensor cores (wmma 16x16x16, f32 accumulation; its
// operands are bf16 values already, so only the order of the sums differs from
// the plain version); otherwise on CUDA cores in f32.  Wo (74 KB in bf16) is
// read from L2, which every block shares, rather than staged beside the tiles.
#include "eva_eval.cuh"

using namespace eva_eval;

extern "C" {

// Shared memory of one block (xdim = 0), for the wrapper's gate to check its
// own copy of the layout against.
int eva_packed_out_smem_bytes(int d, int S, int C, int nh, int esize, int xdim) {
  return (int)out_smem_bytes(d, S, C, nh, esize, xdim);
}

const char* eva_packed_out_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out [B, N, nh*d] from qkv, rf, beta, wo (all float32 or all bfloat16), bias
// (f32 [nh, S, S] or null) and bo (f32 [nh*d]), on `stream`.  Returns a
// cudaError_t (0 on success).
int eva_packed_out_launch(const void* qkv, const void* rf, const void* beta,
                          const float* bias, const void* wo, const float* bo, void* out,
                          int B, int N, int gw, int ws, int nh, int d, int C, int is_bf16,
                          float scale, void* stream) {
  OutParams p = {};
  p.qkv = qkv; p.rf = rf; p.beta = beta; p.bias = bias; p.wo = wo; p.bo = bo; p.out = out;
  if (!out_geometry(p, B, N, gw, ws, nh, C, 0, scale)) return cudaErrorInvalidValue;
  return launch_out<false>(p, d, is_bf16, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
