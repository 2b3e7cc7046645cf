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
// Design.  A token's projection needs every head's output, so a block owns
// windows of one image, every head of each (eva_out_kernel and
// eva_out_mma_kernel in eva_eval.cuh, where the design is set out).  In bf16
// with head dims that are multiples of 16 (out_uses_mma) a block of 12 warps
// takes up to 8 windows in turn and runs on tensor cores (mma.sync
// m16n8k16, f32 sums): the window's q, k and v rows are staged with
// cp.async, the chunk rows and the bias once a block where every head fits;
// a warp runs K1's forward strip (eva_strip.cuh) for one (head, 16-row
// strip) with the logits in registers and writes o / l, rounded, to the
// window's attention rows, a buffer of their own (so that the next window's
// rows load during this window's output projection); then the projection
// of those rows, Wo held whole in shared memory where it fits (else
// streamed through a ring of two slabs), the sums written from the
// fragments with bo to the tokens.  Wider models stage the window's rows,
// chunk rows and bias a few heads at a time (out_mma_plan picks the layout;
// its bytes a block are in PERF.md).  Otherwise one window a block on CUDA
// cores in f32 (K1's CUDA-core forward per head, then the projection, Wo
// read from L2).
#include "eva_eval.cuh"

using namespace eva_eval;

extern "C" {

// Shared memory of one block (xdim = 0), for the wrapper's gate to check its
// own copy of the layout against.
int eva_packed_out_smem_bytes(int d, int S, int C, int nh, int esize, int xdim) {
  return (int)out_smem_bytes(d, S, C, nh, esize, xdim);
}

// Blocks of the tensor-core route that fit one SM, or -1.
int eva_packed_out_mma_blocks_per_sm(int d, int S, int C, int nh) {
  return out_mma_blocks_per_sm<false>(d, S, C, nh, 0);
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

#ifdef EVA_OUT_PHASES
// Copies g_out_phases ([6][16384] uint64) to host memory at dst; a
// cudaError_t.
int eva_packed_out_phases_copy(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_out_phases, sizeof(g_out_phases));
}
#endif

}  // extern "C"
