// K10 eva_mega: the 2-D EVA eval kernels that read the tokens x, not qkv.
//
// Replaces efficient_attention_tpu/ops/pallas/eva_mega.py, two entry points
// (the eval path behind EVA's use_megakernel):
//   eva_summaries_from_x (_sum_kernel)   K8's chunk summaries, with the qkv
//                                        projection x Wqkv + bqkv inside;
//   eva_attention_from_x (_attn_kernel)  K9's joint softmax and output
//                                        projection, with the qkv projection
//                                        inside.
// Plain versions and wrappers: efficient_attention_torch/ops/kernels/eva_mega.py.
// Device code: eva_summaries_kernel and eva_out_kernel in eva_eval.cuh, in
// their FROM_X forms.
//
// Function.  As K8 and K9, on qkv = x Wqkv + bqkv rounded to x's type (JAX's
// order: project, round, then the means and the softmax).  Wqkv [XD, 3*H*D]
// is in [in, out] layout.
//
// What bounds it: operations.  qkv (115.6 MB at the DeiT-tiny-p8 cell, B=128,
// 28x28 tokens, dim 192, bf16) never reaches device memory: the summaries
// read x (38.5 MB, ~12 us at 3.35 TB/s) against 22 GFLOP of projection (~22 us
// at the bf16 tensor-core peak); the attention reads x and writes the output
// (77 MB, ~24 us) against 37 GFLOP (~38 us).  That is ~77 MB fewer bytes a
// layer than K8 + K9 after a separate projection, worth having only if the
// projections run on tensor cores.
//
// Design.  In bf16 where the wrapper's mma_plan takes the launch (head dims
// 16/32/64, XD a multiple of 16, the head's Wqkv columns within shared
// memory: up to XD = 320 at head dim 32, not the base ViT's 768), the
// summaries run eva_summaries_mma_kernel: persistent blocks, each keeping
// one head's Wqkv columns (192 x 192 bf16, 77 KB at the cell) in shared
// memory for its life, walk the (strip, image) pairs with the blocks of
// the other heads beside them (the strip's x rows then come from L2 for
// two of three); the next strip's x rows arrive by cp.async while this one
// is projected on mma.sync m16n8k16 (a warp two 16-row tiles by 48
// columns, f32 sums + bqkv rounded to bf16 from the fragments into the
// strip's q, k, v rows) and summarised by K8's persistent chunk body (8
// warps, two blocks an SM at PVT-B3's and DeiT-tiny-p16's widths; 16 warps,
// one an SM, at PVT-B3's first stage).  At the cell, where two blocks do not
// fit, eva_summaries_ws_kernel: 16 warps in two teams, 8 projecting strip
// t (the next k-step's fragments loaded while this one's products run)
// while 8 summarise strip t - 1, with two buffers of projected rows and
// the x rows loaded in two halves.  Otherwise the first kernel: the summaries
// block (one chunk-row strip of one head and image) stages the strip's 112
// x rows, projects them to the head's q, k, v in the block (112 x 192
// outputs, K = 192), rounds them to the input type into K8's staged strip,
// and runs K8's per-chunk body; the projection runs on tensor cores in
// bf16 (wmma 16x16x16, f32 accumulation; rows padded to 16 with zeros)
// where the widths are multiples of 16, else on CUDA cores in f32, Wqkv
// (221 KB in bf16) read from L2 one 16x16 fragment at a time.  The
// attention runs K9's kernels (eva_eval.cuh) with the qkv projection in
// front.  On K9's tensor-core route (bf16, head dims and XD multiples of
// 16) a block of 12 warps takes up to 8 windows of one image in turn: it
// stages a window's x rows once (cp.async; the next window's while this
// one's attention runs), projects them to q, k, v on mma.sync m16n8k16 with
// Wqkv streamed through a ring of two 96-row slabs in shared memory that
// every warp reads (f32 sums, + bqkv, rounded to bf16 from the fragments
// into the window's rows), then runs K9's strips, each writing its
// attention rows over its own q columns, and the output projection, Wo
// loaded whole over the ring while the strips run.  Wider models project
// and attend a few heads at a time, with the attention rows in a buffer of
// their own (out_mma_plan picks the layout; its bytes a block are in
// PERF.md).  Otherwise one window a block on CUDA cores in f32.
#include "eva_eval.cuh"

using namespace eva_eval;

extern "C" {

// Shared memory of one summaries block and of one attention block, for the
// wrapper's gates to check their own copies of the layouts against.
int eva_mega_summaries_smem_bytes(int rows, int d, int esize, int xdim) {
  return (int)make_sum_layout(rows, d, esize, xdim).total;
}

int eva_mega_attention_smem_bytes(int d, int S, int C, int nh, int esize, int xdim) {
  return (int)out_smem_bytes(d, S, C, nh, esize, xdim);
}

// Blocks of the attention's tensor-core route that fit one SM, or -1.
int eva_mega_attention_mma_blocks_per_sm(int d, int S, int C, int nh, int xdim) {
  return out_mma_blocks_per_sm<true>(d, S, C, nh, xdim);
}

// Shared memory of one block of the persistent tensor-core route (rows and
// chunks of an item), and how many of its blocks of `warps` warps fit an SM
// at `smem` bytes (-1 where it cannot launch), for the wrapper's plan to
// check its own copy against.
int eva_mega_summaries_mma_smem_bytes(int rows, int d, int xdim, int wc, int jj, int stages,
                                      int teams) {
  return (int)sum_mma_layout(rows, d, xdim, wc, jj, stages, teams).total;
}

int eva_mega_summaries_mma_blocks_per_sm(int d, int warps, int teams, int smem) {
  return sum_mma_blocks_per_sm<true>(d, warps, teams, smem);
}

const char* eva_mega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rf, beta [B, C, nh*d] (x's type) from x [B, N, xd] and wqkv [xd, 3*nh*d]
// (both float32 or both bfloat16), bqkv (f32) and the f32 adaptive weights
// (ln* null unless use_ln), on `stream`, on the route (warps, stages, bps)
// names as in eva_summaries_launch.  Returns a cudaError_t.
int eva_mega_summaries_launch(const void* x, const void* wqkv, const float* bqkv,
                              const float* wq, const float* bq, const float* wk,
                              const float* bk, const float* lnq_s, const float* lnq_b,
                              const float* lnk_s, const float* lnk_b, void* rf, void* beta,
                              int B, int N, int xd, int gw, int j, int nh, int d,
                              int use_ln, int is_bf16, int warps, int stages, int bps,
                              int teams, void* stream) {
  SumParams p = {};
  p.x = x; p.wqkv = wqkv; p.bqkv = bqkv;
  p.wq = wq; p.bq = bq; p.wk = wk; p.bk = bk;
  p.lnq_s = lnq_s; p.lnq_b = lnq_b; p.lnk_s = lnk_s; p.lnk_b = lnk_b;
  p.rf = rf; p.beta = beta;
  if (xd <= 0 || !sum_geometry(p, B, N, gw, j, nh, xd, use_ln)) return cudaErrorInvalidValue;
  return launch_summaries<true>(p, d, is_bf16, SumConfig{warps, stages, bps, teams},
                                static_cast<cudaStream_t>(stream));
}

// out [B, N, nh*d] from x [B, N, xd], wqkv, rf, beta, wo (all float32 or all
// bfloat16), bqkv, bo (f32) and bias (f32 [nh, S, S] or null), on `stream`.
// Returns a cudaError_t.
int eva_mega_attention_launch(const void* x, const void* wqkv, const float* bqkv,
                              const void* rf, const void* beta, const float* bias,
                              const void* wo, const float* bo, void* out, int B, int N,
                              int xd, int gw, int ws, int nh, int d, int C, int is_bf16,
                              float scale, void* stream) {
  OutParams p = {};
  p.x = x; p.wqkv = wqkv; p.bqkv = bqkv;
  p.rf = rf; p.beta = beta; p.bias = bias; p.wo = wo; p.bo = bo; p.out = out;
  if (xd <= 0 || !out_geometry(p, B, N, gw, ws, nh, C, xd, scale))
    return cudaErrorInvalidValue;
  return launch_out<true>(p, d, is_bf16, static_cast<cudaStream_t>(stream));
}

#ifdef EVA_SUM_PHASES
// Copies g_sum_phases ([8][16384] uint64) to host memory at dst; a
// cudaError_t.
int eva_mega_sum_phases_copy(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_sum_phases, sizeof(g_sum_phases));
}
#endif

#ifdef EVA_OUT_PHASES
// Copies g_out_phases ([6][16384] uint64) to host memory at dst; a
// cudaError_t.
int eva_mega_phases_copy(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_out_phases, sizeof(g_out_phases));
}
#endif

}  // extern "C"
