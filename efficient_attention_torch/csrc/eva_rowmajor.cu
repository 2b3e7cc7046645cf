// K12 eva_rowmajor: the 2-D EVA joint softmax on row-major tokens.
//
// Replaces efficient_attention_tpu/ops/pallas/eva_rowmajor.py::
// eva_attention_rowmajor (_fwd, _kernel).  Plain version and wrapper:
// efficient_attention_torch/ops/kernels/eva_rowmajor.py.
//
// Function.  q, k, v [B, H, N, D] hold the tokens of an N/W x W grid in token
// order; rf, beta [B, H, C, D] are the chunk summaries; out [B, H, N, D] in
// token order.  Each query attends over the keys of its own ws x ws window
// (plus the bias [H, S, S], S = ws*ws, indexed by the in-window positions)
// and all C chunk keys, with values [window v | beta], in one softmax.  The
// kernel finds each window's tokens from their indices (token_row in
// eva_window.cuh, the inverse of the TPU kernel's rowmajor_bias_index), so
// neither the window partition and merge copies of K11's route nor the TPU
// kernel's [H, TGS, TGS + C] permuted bias exist.  What bounds it, the design
// and the roundings: eva_window.cuh, whose device code K11 (eva_kernel.cu)
// shares.
#include "eva_window.cuh"

extern "C" {

// Shared memory of one block of the route that (d, S, C, is_bf16) takes.
int eva_rowmajor_smem_bytes(int d, int S, int C, int is_bf16) {
  return eva_window::smem_bytes(d, S, C, is_bf16);
}

// Whether head dim d at element size itemsize takes the tensor-core route
// (uses_mma in ops/kernels/eva_kernel.py).
int eva_rowmajor_uses_mma(int d, int itemsize) {
  return eva_window::uses_mma(d, itemsize == 2) ? 1 : 0;
}

// Blocks of the tensor-core kernel that fit one SM at (d, S, C), or -1.
int eva_rowmajor_mma_blocks_per_sm(int d, int S, int C) {
  return eva_window::mma_blocks_per_sm(d, S, C);
}

const char* eva_rowmajor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: out [B, H, N, d] from q, k, v [B, H, N, d] of a grid W
// tokens wide, rf, beta [B, H, C, d] (all float32 or all bfloat16) and bias
// (f32 [H, ws*ws, ws*ws] or null).  Returns a cudaError_t (0 on success).
int eva_rowmajor_launch(const void* q, const void* k, const void* v, const void* rf,
                        const void* beta, const float* bias, void* out, int B, int H,
                        int N, int W, int ws, int C, int d, int wpb, int is_bf16,
                        float scale, void* stream) {
  if (W <= 0 || ws <= 0 || N % W || W % ws || (N / W) % ws) return cudaErrorInvalidValue;
  eva_window::Params p = {};
  p.q = q; p.k = k; p.v = v; p.rf = rf; p.beta = beta; p.bias = bias; p.out = out;
  p.B = B; p.H = H; p.S = ws * ws; p.G = N / p.S; p.C = C;
  p.W = W; p.ws = ws;
  p.wpb = wpb;
  p.scale = scale;
  return eva_window::launch_any(p, d, is_bf16, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
