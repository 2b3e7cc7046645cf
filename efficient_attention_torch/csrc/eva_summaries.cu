// K8 eva_summaries: the 2-D EVA chunk summaries (rf_k_bar, beta) in one read
// of qkv.
//
// Replaces efficient_attention_tpu/ops/pallas/eva_summaries.py::eva_summaries_packed
// (the eval summaries behind EVA's use_pallas_summaries).  Plain version and
// wrapper: efficient_attention_torch/ops/kernels/eva_summaries.py.  Device code:
// eva_summaries_kernel in eva_eval.cuh.
//
// Function.  From qkv [B, N, 3*H*D], per 2-D chunk of j x j tokens and head:
// the means of q and k (f32), rf_q = LN(mean_q Wq + bq) and rf_k = LN(mean_k
// Wk + bk) (the adaptive Dense and LN act on D and are shared by the heads; no
// LN for adaptive_proj='no-ln'), mu = (rf_q + rf_k)/2, and the softmax over
// the chunk's members of <mu, k_t>/sqrt(d) - |k_t|^2/(2 sqrt(d)), shifted by
// its true maximum, which weights their values into beta.  Returns rf_k_bar
// and beta, each [B, C, H*D] in qkv's type.  This is K2's phase 1
// (eva_single.cu) as a kernel of its own.
//
// What bounds it: bytes.  At the DeiT-tiny-p8 cell (B=128, 28x28 tokens, 3
// heads of 64, bf16) it reads qkv (115.6 MB) and writes 3.2 MB: ~36 us at
// 3.35 TB/s, against ~0.2 GFLOP of arithmetic.
//
// Design.  The TPU kernel reads a strip of j grid rows across the full packed
// width and expresses the heads with selector matmuls; here a block takes one
// (strip, head, image): the strip's j*gw tokens are contiguous, so its q, k, v
// rows of one head (112 x 192 values at the cell: 43 KB in bf16, 86 KB in f32)
// are staged with 16-byte loads, and each of the strip's chunks is one warp's
// work.  A block per strip of all heads would need 129 KB in bf16 and more
// than a block's shared memory in f32, and would give a third of the blocks
// (896 at the cell, against 132 SMs); a block per head keeps f32 inside the
// limit and gives 2688.  Everything after the loads is f32 on CUDA cores:
// the arithmetic is small, the read of qkv is the cost.
//
// bf16 with head dims 16/32/64, at most 64 members a chunk and strips of 56
// rows or more (the wrapper's mma_plan) takes eva_summaries_mma_kernel
// instead: two persistent blocks of 8 warps an SM, each keeping one head
// and walking the (strip, image) pairs with the blocks of the other heads
// of the same strip beside it; the next item's q, k, v rows arrive by
// cp.async while this one's chunks are summed (a ring of two buffers of
// 43 KB at the cell); the chunk body is K2's phase 1 (the sums a lane a
// dimension pair, the adaptive Dense a thread an output column with its
// slice of wq or wk in registers, the logits two lanes a member).  1-D bulk
// copies (cp.async.bulk, one a row's q, k or v columns) filled the ring
// 2.3x slower at the cell than 16-byte cp.async (PERF.md).  Shorter strips
// (PVT-B3's third stage, DeiT-tiny-p16: 28 rows) keep the first kernel,
// which was the faster there.
#include "eva_eval.cuh"

using namespace eva_eval;

extern "C" {

// Shared memory of one block (xdim = 0), for the wrapper's gate to check its
// own copy of the layout against.
int eva_summaries_smem_bytes(int rows, int d, int esize, int xdim) {
  return (int)make_sum_layout(rows, d, esize, xdim).total;
}

// Shared memory of one block of the persistent tensor-core route (rows and
// chunks of an item), and how many of its blocks of `warps` warps fit an SM
// at `smem` bytes (-1 where it cannot launch), for the wrapper's plan to
// check its own copy against.
int eva_summaries_mma_smem_bytes(int rows, int d, int xdim, int wc, int jj, int stages,
                                 int teams) {
  return (int)sum_mma_layout(rows, d, xdim, wc, jj, stages, teams).total;
}

int eva_summaries_mma_blocks_per_sm(int d, int warps, int teams, int smem) {
  return sum_mma_blocks_per_sm<false>(d, warps, teams, smem);
}

const char* eva_summaries_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rf, beta [B, C, nh*d] (qkv's type) from qkv [B, N, 3*nh*d] (float32 or
// bfloat16) and the f32 adaptive weights (ln* null unless use_ln), on
// `stream`: the first kernel where warps is 0, else the persistent route at
// (warps, stages, bps) (SumConfig), or an error where it cannot take the
// launch.  Returns a cudaError_t (0 on success).
int eva_summaries_launch(const void* qkv, const float* wq, const float* bq,
                         const float* wk, const float* bk, const float* lnq_s,
                         const float* lnq_b, const float* lnk_s, const float* lnk_b,
                         void* rf, void* beta, int B, int N, int gw, int j, int nh, int d,
                         int use_ln, int is_bf16, int warps, int stages, int bps,
                         int teams, void* stream) {
  SumParams p = {};
  p.qkv = qkv;
  p.wq = wq; p.bq = bq; p.wk = wk; p.bk = bk;
  p.lnq_s = lnq_s; p.lnq_b = lnq_b; p.lnk_s = lnk_s; p.lnk_b = lnk_b;
  p.rf = rf; p.beta = beta;
  if (!sum_geometry(p, B, N, gw, j, nh, 0, use_ln)) return cudaErrorInvalidValue;
  return launch_summaries<false>(p, d, is_bf16, SumConfig{warps, stages, bps, teams},
                                 static_cast<cudaStream_t>(stream));
}

#ifdef EVA_SUM_PHASES
// Copies g_sum_phases ([8][16384] uint64) to host memory at dst; a
// cudaError_t.
int eva_summaries_sum_phases_copy(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_sum_phases, sizeof(g_sum_phases));
}
#endif

}  // extern "C"
