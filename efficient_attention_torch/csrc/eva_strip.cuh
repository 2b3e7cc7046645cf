// Tiles of the EVA joint softmax's forward strip on bf16 tensor cores
// (mma.sync m16n8k16, f32 sums), shared by K1's tensor-core forward
// (eva_packed_fwd_mma_kernel, eva_packed.cu), K11/K12's tensor-core
// kernel (window_mma_kernel, eva_window.cuh) and K9/K10's
// (eva_out_mma_kernel, eva_eval.cuh), with the constants that K1's
// backward uses too.  Each kernel stages a window's q, k and v rows [S][D+8],
// the chunk rows rf and beta [C][D+8] and the bias [S][S] (f32, times
// log2 e) in shared memory; a warp owns a strip of 16 query rows and calls
// these tiles 16 key columns [k | rf] at a time.  The strip bodies around
// them (the row max, the passes, the stores) are each kernel's own: calling
// one shared body from K1's forward raised its register count.
//
// The logits are held in base 2 (scale and bias times log2 e, so that
// exp(s - max) is one ex2).  Key and value rows past S + C read the last
// real row (their numerators are +0, ex2 of -inf); query rows past S read
// the bias of row S - 1 and are never stored.  A tile reads the kernel's
// parameter block p for its fields S, C and scale, so any kernel whose
// parameters have those fields can call it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace eva_strip {

using bf16 = __nv_bfloat16;

// Key-column tiles of 16 that the one-pass strip keeps in registers: the
// strips of geometries with S + C <= 16 * kResidentTiles (112; the
// DeiT-tiny-p8 and PVT-B3 shapes have 49 + 49) run in one pass, the others
// in two.  Eight tiles spilled registers at head dim 64.
constexpr int kResidentTiles = 7;

// The logits are held in base 2 (scale and bias times log2 e), so that
// exp(s - max) is one ex2 instruction.
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Whether a strip of S + C keys keeps its logits in registers (one pass).
__host__ __device__ inline bool one_pass(int S, int C) {
  return round16(S + C) <= 16 * kResidentTiles;
}

// Row j of a window's [k | rf] or [v | beta]: window row j < S from the
// window's buffer (rows ldw apart), chunk row j - S from the block's (rows
// D + 8 apart).
template <int D>
__device__ __forceinline__ const bf16* joint_row(const bf16* win, const bf16* chunk, int j,
                                                 int S, int ldw = D + 8) {
  return j < S ? win + j * ldw : chunk + (j - S) * (D + 8);
}

// One 16-column tile kt of a strip's logits in base 2 (scaled by p.scale,
// the bias added on the window's p.S columns, -inf past p.S + p.C) from the
// strip's q fragments qa.  Rows are the thread's row0 and row0 + 8; s[n][e]
// is column kt*16 + 8n + 2(lane%4) + e%2 of row row0 + 8 (e / 2).  The
// window's key rows are ldw apart (D + 8 unless the kernel keeps every
// head's q, k and v in one row, as K9 and K10's tensor-core kernel does).
template <int D, typename P>
__device__ __forceinline__ void fwd_logits_tile(const P& p, int kt, int row0,
                                                const uint32_t (&qa)[D / 16][4],
                                                const bf16* kw, const bf16* kc,
                                                const float* bias_s, float (&s)[2][4],
                                                int ldw = D + 8) {
  using namespace mma_frag;
  const int lane = threadIdx.x & 31, SC = p.S + p.C;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  const bf16* kr =
      joint_row<D>(kw, kc, min(kt * 16 + row_c(lane), SC - 1), p.S, ldw) + col_c(lane);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t bk[4];
    ldsm_x4(bk, kr + 16 * kd);
    mma_bf16(s[0], qa[kd], bk[0], bk[1]);
    mma_bf16(s[1], qa[kd], bk[2], bk[3]);
  }
  // the bias only on tiles with window columns, the mask only on the last
  // tile (both tests uniform over the warp); the padding rows past S read
  // the bias of row S - 1 and are never stored
  const bool window_cols = kt * 16 < p.S, masked = kt * 16 + 16 > SC;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = min(row0 + 8 * (e >> 1), p.S - 1);
      const int jj = kt * 16 + 8 * n + 2 * (threadIdx.x & 3) + (e & 1);
      float v = s[n][e] * (p.scale * kLog2e);
      if (window_cols && jj < p.S) v += bias_s[i * p.S + jj];
      if (masked && jj >= SC) v = -INFINITY;
      s[n][e] = v;
    }
}

// Tile kt of a strip from its logits s and row max m: the numerators
// x = exp(s - m) added into the f32 row sums l, then o += x [v | beta] with
// x rounded to bf16 as the product's A operand.  The window's value rows
// are ldw apart.
template <int D, typename P>
__device__ __forceinline__ void fwd_pv_tile(const P& p, int kt, float (&s)[2][4],
                                            const float (&m)[2], float (&l)[2],
                                            const bf16* vw, const bf16* vc,
                                            float (&o)[D / 8][4], int ldw = D + 8) {
  using namespace mma_frag;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = exp2_approx(s[n][e] - m[e >> 1]);
      l[e >> 1] += s[n][e];
    }
  uint32_t a[4];
  c_to_a(s[0], s[1], a);
  const bf16* vr =
      joint_row<D>(vw, vc, min(kt * 16 + row_r(lane), p.S + p.C - 1), p.S, ldw) +
      col_r(lane);
#pragma unroll
  for (int nd = 0; nd < D / 16; ++nd) {
    uint32_t bv[4];
    ldsm_x4_trans(bv, vr + 16 * nd);
    mma_bf16(o[2 * nd], a, bv[0], bv[1]);
    mma_bf16(o[2 * nd + 1], a, bv[2], bv[3]);
  }
}

}  // namespace eva_strip
