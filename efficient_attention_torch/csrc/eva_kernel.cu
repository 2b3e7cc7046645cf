// K11 eva_kernel: the EVA joint softmax over Swin-partitioned windows.
//
// Replaces efficient_attention_tpu/ops/pallas/eva_kernel.py::eva_attention_fused
// (_eva_fused_fwd, _eva_kernel).  Plain version and wrapper:
// efficient_attention_torch/ops/kernels/eva_kernel.py.
//
// Function.  q, k, v [B, H, G, S, D] hold G windows of S tokens a (image,
// head), in 2-D (S = ws*ws, Swin order) or 1-D (S = ws); rf, beta
// [B, H, C, D] are the chunk summaries; out [B, H, G, S, D].  Each query
// attends over its own window's keys (plus the bias [H, S, S]) and all C chunk
// keys, with values [window v | beta], in one softmax.  What bounds it, the
// design and the roundings: eva_window.cuh, whose device code K12
// (eva_rowmajor.cu) shares; here window g's rows lie contiguous at g*S.
#include "eva_window.cuh"

extern "C" {

// Shared memory of one block of the route that (d, S, C, is_bf16) takes.
int eva_kernel_smem_bytes(int d, int S, int C, int is_bf16) {
  return eva_window::smem_bytes(d, S, C, is_bf16);
}

// Whether head dim d at element size itemsize takes the tensor-core route
// (uses_mma in ops/kernels/eva_kernel.py).
int eva_kernel_uses_mma(int d, int itemsize) {
  return eva_window::uses_mma(d, itemsize == 2) ? 1 : 0;
}

// Blocks of the tensor-core kernel that fit one SM at (d, S, C), or -1.
int eva_kernel_mma_blocks_per_sm(int d, int S, int C) {
  return eva_window::mma_blocks_per_sm(d, S, C);
}

const char* eva_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Forward on `stream`: out [B, H, G, S, d] from q, k, v [B, H, G, S, d], rf,
// beta [B, H, C, d] (all float32 or all bfloat16) and bias (f32 [H, S, S] or
// null).  Returns a cudaError_t (0 on success).
int eva_kernel_launch(const void* q, const void* k, const void* v, const void* rf,
                      const void* beta, const float* bias, void* out, int B, int H,
                      int G, int S, int C, int d, int wpb, int is_bf16, float scale,
                      void* stream) {
  eva_window::Params p = {};
  p.q = q; p.k = k; p.v = v; p.rf = rf; p.beta = beta; p.bias = bias; p.out = out;
  p.B = B; p.H = H; p.G = G; p.S = S; p.C = C;
  p.W = 0; p.ws = 0;
  p.wpb = wpb;
  p.scale = scale;
  return eva_window::launch_any(p, d, is_bf16, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
