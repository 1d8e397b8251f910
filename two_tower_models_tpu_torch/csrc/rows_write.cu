// In-place write of touched rows with a lane-block bitmask blend: for each
// slot n whose bits[n] != 0 and 0 <= ids[n] < V, and each lane c of the
// W-wide row,
//   m = (bits[n] >> (c / D)) & 1
//   dst[ids[n], c] = dst[ids[n], c] * (1 - m) + vals[n, c] * m
// dst [V, W] f32, ids and bits [N] int32, vals [N, W] f32.  The lazy-Adam
// write-back of 128-lane-packed tables: P = W / D logical rows share a
// physical row, and a write must leave the lanes of untouched partners as
// they are.
//
// Replaces two_tower_models_tpu/ops/pallas/rows_write.py:rows_write (the
// pallas_call at :150).  The Pallas kernel copies every table tile through
// because Pallas outputs are functional; here the write is in place and
// touches only the live rows, O(N * W) whatever V.
//
// Slots that share a physical row: merge_lane_blocks leaves the later slots
// of each physical-row run with the same id and bits == 0.  The Pallas
// kernel applies them in order as blends with m = 0 everywhere; run in
// parallel they would race with the run's live slot.  So this kernel skips
// every slot with bits == 0 (and every id outside [0, V)), as the JAX
// package's rows_write_reference drops them: the live ids are then unique,
// and no atomics or ordering are needed.  On merge_lane_blocks' output a
// skipped blend old * 1 + new * 0 would only have changed the sign of a
// zero in a dead lane (-0 + +0 = +0), which compares equal.  Live slots blend exactly as
// the Pallas kernel writes it, so a NaN or an infinity in a live slot's old
// or new value propagates as it does there.
//
// Bound on the H100: bytes, 3 * N_live * W * 4 (read the old row and the
// new one, write the row) plus the ids and bits.  Design: one warp per
// slot, lanes over the row in float4s (W = 128: one float4 a lane).

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float blend(float old, float nv, int bits, int block) {
  const float m = (float)((bits >> block) & 1);
  return old * (1.0f - m) + nv * m;
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
rows_write_kernel(float* __restrict__ dst, const int* __restrict__ ids,
                  const int* __restrict__ bits, const float* __restrict__ vals,
                  int N, int V, int W, int D) {
  const int slot = blockIdx.x * WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (slot >= N) return;
  const int id = ids[slot], b = bits[slot];
  if (b == 0 || id < 0 || id >= V) return;
  float* row = dst + (size_t)id * W;
  const float* src = vals + (size_t)slot * W;
  if constexpr (VEC == 4) {
    float4* row4 = reinterpret_cast<float4*>(row);
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int c = lane; c < W / 4; c += 32) {
      const float4 o = row4[c], nv = src4[c];
      const int l = 4 * c;
      row4[c] = make_float4(blend(o.x, nv.x, b, l / D), blend(o.y, nv.y, b, (l + 1) / D),
                            blend(o.z, nv.z, b, (l + 2) / D), blend(o.w, nv.w, b, (l + 3) / D));
    }
  } else {
    for (int c = lane; c < W; c += 32) row[c] = blend(row[c], src[c], b, c / D);
  }
}

}  // namespace

extern "C" int tt_rows_write(void* dst, const void* ids, const void* bits,
                             const void* vals, int N, int V, int W, int D,
                             void* stream) {
  if (N < 0 || V < 0 || W < 1 || D < 1 || W % D) return (int)cudaErrorInvalidValue;
  if (N == 0 || V == 0) return (int)cudaSuccess;
  const int blocks = (N + WARPS - 1) / WARPS;
  cudaStream_t st = (cudaStream_t)stream;
  if (W % 4 == 0)
    rows_write_kernel<4><<<blocks, THREADS, 0, st>>>(
        (float*)dst, (const int*)ids, (const int*)bits, (const float*)vals, N, V, W, D);
  else
    rows_write_kernel<1><<<blocks, THREADS, 0, st>>>(
        (float*)dst, (const int*)ids, (const int*)bits, (const float*)vals, N, V, W, D);
  return (int)cudaGetLastError();
}
