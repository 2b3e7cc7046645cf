// Warp-level tensor-core helpers for bf16 kernels on sm_90a: 16-byte
// asynchronous copies into shared memory, ldmatrix fragment loads, the
// mma.sync m16n8k16 bf16 product with f32 accumulation, the repacking of
// accumulator fragments into operand fragments, a fast 2^x, and reductions
// over the four threads that share an accumulator row.  K1's tensor-core
// backward (eva_packed.cu) uses them.  For f32 kernels: the mma.sync m16n8k8
// TF32 product and the split of an f32 value into two TF32 parts (K3's f32
// forward, causal_packed.cu).
//
// Fragments of mma.sync.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), for lane l with g = l / 4 and c = l % 4:
//  * A, 16 x 16 bf16, 4 registers of two values: a0 = (row g, cols 2c, 2c+1),
//    a1 = (row g+8, cols 2c, 2c+1), a2 = (row g, cols 2c+8, 2c+9),
//    a3 = (row g+8, cols 2c+8, 2c+9);
//  * B, 16 x 8 bf16, 2 registers: b0 = (rows 2c, 2c+1, col g),
//    b1 = (rows 2c+8, 2c+9, col g);
//  * C, 16 x 8 f32, 4 registers: c0, c1 = (row g, cols 2c, 2c+1),
//    c2, c3 = (row g+8, cols 2c, 2c+1).
// So the thread that holds C(i, j) is fixed by (i mod 16, j mod 8), and the
// four threads of a quad (same g) hold a row's columns between them.
//
// ldmatrix .x4 loads four 8 x 8 bf16 matrices; lanes 8q..8q+7 give the row
// addresses of matrix q, and register q of lane l receives row l / 4,
// columns 2(l%4), 2(l%4)+1 of matrix q (or, with .trans, of its transpose).
// Two lane patterns cover every operand these kernels load from a row-major
// array X in shared memory (each row 16-byte aligned):
//  * row_r(l) = l % 16, col_r(l) = 8 (l / 16): with X = [m][k] and no
//    transpose, the A fragment of rows m0.., cols k0..; with X = [k][n] and
//    .trans, the B fragments {b0, b1} of n-tile n0 and {b0, b1} of n-tile
//    n0 + 8 for k0..k0+15;
//  * row_c(l) = l % 8 + 8 (l / 16), col_c(l) = 8 ((l / 8) % 2): with
//    X = [n][k] and no transpose, the B fragments of n-tiles n0 and n0 + 8
//    (as above); with X = [k][m] and .trans, the A fragment of X^T.
//
// Fragments of mma.sync.m16n8k8 with .tf32 operands (PTX ISA, "Matrix
// Fragments for mma.m16n8k8"), lane l, g = l / 4, c = l % 4, one value a
// register:
//  * A, 16 x 8: a0 = (row g, col c), a1 = (row g+8, col c),
//    a2 = (row g, col c+4), a3 = (row g+8, col c+4);
//  * B, 8 x 8: b0 = (row c, col g), b1 = (row c+4, col g);
//  * C, 16 x 8 f32: as for m16n8k16 above.
// A product may number its k-index in any order that A and B share.  With
// A's column c taken as the C tile's column 2c and column c+4 as column
// 2c+1, an accumulator tile {c0, c1, c2, c3} is the A fragment
// {c0, c2, c1, c3} of the next product: no shuffle.
//
// Split TF32: x = hi + lo with hi = x rounded to TF32 and lo = x - hi
// (exact in f32), of which an mma reads the 11 high bits (truncation).  a b
// is taken as hi hi + hi lo + lo hi, which drops lo lo (2^-22 |a| |b|) and
// lo's truncated bits (under 2^-21 |a| |b| each): about 2^-20 |a| |b| a
// term at worst, against 2^-11 for one TF32 product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_frag {

__device__ __forceinline__ int row_r(int lane) { return lane & 15; }
__device__ __forceinline__ int col_r(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int row_c(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int col_c(int lane) { return ((lane >> 3) & 1) << 3; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; complete after cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += A B for one 16 x 8 tile: bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B for one 16 x 8 tile: TF32 operands (k = 8), f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo in TF32 (the split in the header comment): hi is x rounded
// to nearest, ties away from zero, by one integer add (the bits of
// cvt.rna.tf32.f32, which costs a compare-and-select sequence), its low bits
// cleared; lo is the exact x - hi, whose low 13 bits the mma ignores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Two f32 values rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment (16 x 16, bf16) of the accumulator tiles c0 (columns 0-7)
// and c1 (columns 8-15) of the same 16 rows: a product's output feeds the
// next product from registers.
__device__ __forceinline__ void c_to_a(const float (&c0)[4], const float (&c1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 2^x by the special-function unit (relative error about 2^-22; 0 for -inf).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reductions over the quad that holds one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace mma_frag
