// Warp-level tensor-core and async-copy helpers of the port's kernels
// (sm_80 instructions, compiled for sm_90a).
//
// The bf16 product is mma.sync m16n8k16, row.col, f32 accumulate: for
// groupID g = lane / 4 and t = lane % 4 the fragments are
//   A (16 x 16, 4 x bf16x2): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                            a3 (g+8, 2t+8..)
//   B (16 x 8,  2 x bf16x2): b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8,  4 x f32):    c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// so C's two n-tiles of one 16-column band are, pairwise packed to bf16,
// the A fragment of a k-step over those 16 columns.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace tt {

// 16-byte copy from global to shared memory that bypasses the registers;
// bytes < 16 zero-fills the rest (0: the destination becomes zeros and
// src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i .. 8i+7 give the
// row addresses (16 bytes each) of matrix i, which lands in r[i].  TRANS
// transposes each matrix: the B operand of a [K][N] matrix stored by row.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

// Two 8 x 8 bf16 matrices, as ldmatrix_x4: lanes 0 .. 15 give the row
// addresses, matrix i lands in r[i].
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(s));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(s));
}

// c += a . b, bf16 in, f32 accumulate (fragments as above).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b as mma_bf16, but the 16 products summed on their own and then
// added to c in one add rounded to nearest: mma.sync adds the products
// into the accumulator it is given without rounding to nearest.
__device__ __forceinline__ void mma_bf16_add(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(d, a, b0, b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

// x rounded to TF32 (10 mantissa bits kept, to nearest, ties away from
// zero), as the f32 bit pattern the tf32 mma.sync takes.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split: x = hi + lo + a remainder of at most 2^-22 |x|, hi and lo
// TF32; x - hi is exact in f32.  For an x whose TF32 rounding is finite.
__device__ __forceinline__ void tf32_split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Whether x's TF32 rounding is infinite: x = +-inf, or a finite x with |x|
// >= (2 - 2^-11) 2^127.
__device__ __forceinline__ bool tf32_big(float x) {
  return (tf32_rna(x) & 0x7fffffffu) == 0x7f800000u;
}

// tf32_split for any x.  Where hi would be infinite, the split is hi = 0
// and lo = x cut to TF32 (its low 13 bits cleared: inf stays inf, such a
// finite x becomes the largest TF32 below it), so of the products hi.lo',
// lo.hi' and hi.hi' only lo.hi' is not 0: x times the other operand's hi,
// which has that operand's sign and is 0 only for a 0.  An infinite input
// then gives an infinite score where f32 gives one (with hi = inf and lo =
// 0, hi.lo' would be inf times the other operand's lo, whose sign is that
// of a rounding error, and NaN where that lo is 0), and such a finite x
// keeps 11 bits of its products, not 24.  Only an infinite x meeting an
// infinite value in the same place gives NaN (0 . inf) where f32 gives
// +-inf.  NaN stays NaN.  Elsewhere the bits are tf32_split's.
__device__ __forceinline__ void tf32_split_any(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  const bool big = (hi & 0x7fffffffu) == 0x7f800000u;
  lo = big ? __float_as_uint(x) & 0xffffe000u : tf32_rna(x - __uint_as_float(hi));
  hi = big ? 0u : hi;
}

// c += a . b, mma.sync m16n8k8, row.col, TF32 in, f32 accumulate: for
// groupID g = lane / 4 and t = lane % 4
//   A (16 x 8, 4 x tf32): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8,  2 x tf32): b0 (k t, n g), b1 (k t+4, n g)
//   C (16 x 8, 4 x f32):  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// so ldmatrix (b16) of an [n][k] f32 tile by row gives B: lane L of an
// 8 x 8 b16 matrix gets the 32-bit word L % 4 of row L / 4.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest-even bf16, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace tt
