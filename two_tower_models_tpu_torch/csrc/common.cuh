// Shared device routines of the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>

namespace tt {

// The canonical f32 inner product of the exact-MIPS kernels, per (query,
// row) element:
//   acc = +0.0f; for d = 0 .. D-1: acc = fmaf(q[d], c[d], acc)
// tile_max_kernel (csrc/tile_max.cu) and rescore_kernel
// (csrc/gather_rescore.cu) must both keep exactly this chain for every
// element, however they tile, vectorise or stage the operands (each does
// four d-steps of it per 16-byte load, in d order), so a row's tile-max
// score is bit-identical to its rescore score.  The exact top-k argument
// (a row's tile max >= its own score, and the k selected tiles hold the
// true top k) relies on that equality: two accumulation orders could
// differ by an ulp at a near-tie and drop a true winner.  No fast-math,
// no TF32, no split sums.

// Row stride in floats of rows of w floats in shared memory: an odd number
// of float4s, so the eight rows a quarter-warp reads with one 16-byte load
// each start in a distinct 4-bank group (the MIPS kernels).
__host__ __device__ constexpr int padded(int w) { return (w / 4) % 2 ? w : w + 4; }

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

// max(a, b), NaN if either is NaN (fmaxf drops a NaN beside a number).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

}  // namespace tt
