// In-place write of touched rows with a lane-block bitmask blend, into one
// to three arrays that share the slots: for each slot n whose bits[n] != 0
// and 0 <= ids[n] < V, each array a and each lane c of the W-wide row,
//   m = (bits[n] >> (c / D)) & 1
//   dst_a[ids[n], c] = dst_a[ids[n], c] * (1 - m) + vals_a[n, c] * m
// dst_a [V, W] f32, ids [N] int64, bits [N] int32, vals_a [N, W] f32.  The
// lazy-Adam write-back of 128-lane-packed tables: P = W / D logical rows
// share a physical row, and a write must leave the lanes of untouched
// partners as they are.  The table and its two Adam moments share one
// lane-block plan (ids and bits), so one launch writes all three.
//
// Replaces two_tower_models_tpu/ops/pallas/rows_write.py:rows_write (the
// pallas_call at :150), called there once per array.  The Pallas kernel
// copies every table tile through because Pallas outputs are functional;
// here the write is in place and touches only the live rows, O(N * W)
// whatever V.
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
// Bound on the H100: bytes, 3 * N_live * W * 4 a array (read the old row
// and the new one, write the row) plus the ids and bits once.  Design: a
// warp per slot at a time, lanes over the row in float4s (W = 128: one
// float4 a lane and array), grid-stride over the slots so each warp takes
// several; a slot's id and bits are read once for all arrays, in the
// plan's own types (no cast launch), and the old and new rows of every
// array are loaded before the first store, so a warp has 2 * NA float4
// loads a lane in flight.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_ARRAYS = 3;
constexpr int BLOCKS_PER_SM = 8;  // 2048 threads an SM

struct Arrays {
  float* dst[MAX_ARRAYS];
  const float* vals[MAX_ARRAYS];
};

__device__ __forceinline__ float blend(float old, float nv, int bits, int block) {
  const float m = (float)((bits >> block) & 1);
  return old * (1.0f - m) + nv * m;
}

template <int NA, int VEC>
__global__ void __launch_bounds__(THREADS)
rows_write_kernel(Arrays a, const long long* __restrict__ ids, const int* __restrict__ bits,
                  int N, long long V, int W, int D) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * WARPS;
  for (int slot = blockIdx.x * WARPS + (threadIdx.x >> 5); slot < N; slot += warps) {
    const long long id = ids[slot];
    const int b = bits[slot];
    if (b == 0 || id < 0 || id >= V) continue;
    const size_t row = (size_t)id * W, src = (size_t)slot * W;
    if constexpr (VEC == 4) {
      for (int c = lane; c < W / 4; c += 32) {
        float4 o[NA], nv[NA];
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          o[j] = reinterpret_cast<const float4*>(a.dst[j] + row)[c];
          nv[j] = reinterpret_cast<const float4*>(a.vals[j] + src)[c];
        }
        const int l = 4 * c;
        const int b0 = l / D, b1 = (l + 1) / D, b2 = (l + 2) / D, b3 = (l + 3) / D;
#pragma unroll
        for (int j = 0; j < NA; ++j)
          reinterpret_cast<float4*>(a.dst[j] + row)[c] = make_float4(
              blend(o[j].x, nv[j].x, b, b0), blend(o[j].y, nv[j].y, b, b1),
              blend(o[j].z, nv[j].z, b, b2), blend(o[j].w, nv[j].w, b, b3));
      }
    } else {
      for (int c = lane; c < W; c += 32) {
        float o[NA], nv[NA];
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          o[j] = a.dst[j][row + c];
          nv[j] = a.vals[j][src + c];
        }
#pragma unroll
        for (int j = 0; j < NA; ++j) a.dst[j][row + c] = blend(o[j], nv[j], b, c / D);
      }
    }
  }
}

template <int NA>
void launch(const Arrays& a, const long long* ids, const int* bits, int N, long long V, int W,
            int D, int blocks, cudaStream_t st) {
  bool vec = W % 4 == 0;
  for (int j = 0; j < NA; ++j)
    vec = vec && (reinterpret_cast<size_t>(a.dst[j]) % 16 == 0) &&
          (reinterpret_cast<size_t>(a.vals[j]) % 16 == 0);
  if (vec)
    rows_write_kernel<NA, 4><<<blocks, THREADS, 0, st>>>(a, ids, bits, N, V, W, D);
  else
    rows_write_kernel<NA, 1><<<blocks, THREADS, 0, st>>>(a, ids, bits, N, V, W, D);
}

}  // namespace

// n_arrays in 1..3 of (dst, vals) pairs; the unused pointers are ignored.
extern "C" int tt_rows_write(void* dst0, void* dst1, void* dst2, const void* vals0,
                             const void* vals1, const void* vals2, const void* ids,
                             const void* bits, int n_arrays, int N, int V, int W, int D,
                             int sm_count, void* stream) {
  if (n_arrays < 1 || n_arrays > MAX_ARRAYS || N < 0 || V < 0 || W < 1 || D < 1 || W % D ||
      sm_count < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || V == 0) return (int)cudaSuccess;
  const Arrays a{{(float*)dst0, (float*)dst1, (float*)dst2},
                 {(const float*)vals0, (const float*)vals1, (const float*)vals2}};
  const int blocks = min((N + WARPS - 1) / WARPS, sm_count * BLOCKS_PER_SM);
  const long long* id = (const long long*)ids;
  const int* bt = (const int*)bits;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_arrays == 1) launch<1>(a, id, bt, N, V, W, D, blocks, st);
  else if (n_arrays == 2) launch<2>(a, id, bt, N, V, W, D, blocks, st);
  else launch<3>(a, id, bt, N, V, W, D, blocks, st);
  return (int)cudaGetLastError();
}
