// Shared device routines of the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>

namespace tt {

// The canonical f32 inner product of the exact-MIPS kernels:
//   acc = +0.0f; for d = 0 .. D-1: acc = fmaf(q[d], c[d], acc)
// computed for an RQ x RC block of (query, row) pairs at once.  Element
// (i, j) reads q at qs[i*q_step + d*q_dstride] and the row at
// cs[j*c_step + d*c_dstride].
//
// tile_max_scores and gather_rescore both score through this routine, so a
// row's tile-max score is bit-identical to its rescore score.  The exact
// top-k argument (a row's tile max >= its own score, and the k selected
// tiles hold the true top k) relies on that equality: two accumulation
// orders could differ by an ulp at a near-tie and drop a true winner.
template <int RQ, int RC>
__device__ __forceinline__ void dot_block(float (&acc)[RQ][RC],
                                          const float* qs, int q_step, int q_dstride,
                                          const float* cs, int c_step, int c_dstride,
                                          int D) {
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[i][j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float qv[RQ], cv[RC];
#pragma unroll
    for (int i = 0; i < RQ; ++i) qv[i] = qs[i * q_step + d * q_dstride];
#pragma unroll
    for (int j = 0; j < RC; ++j) cv[j] = cs[j * c_step + d * c_dstride];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
  }
}

// Monotone int32 key of an f32 bit pattern (the JAX package's _f32_keys):
// the float total order (-0.0 below +0.0, NaN above +inf) becomes int32
// order.  Clamped to INT_MIN + 1 so the selection's mask value INT_MIN stays
// strictly below every input (only the full-payload negative NaN maps to
// INT_MIN itself).
__device__ __forceinline__ int f32_key(int bits) {
  int k = bits < 0 ? (bits ^ 0x7fffffff) : bits;
  return k < INT_MIN + 1 ? INT_MIN + 1 : k;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace tt
