// Row scatter-add whose cost follows the update count, not the table:
//   out[v] = sum over {n : ids[n] == v} of rows[n],  out [V, D] f32,
// every row of out written (zero where no id lands), ids outside [0, V)
// dropped.  The embedding-table backward (the gradient of a lookup).
//
// Replaces two_tower_models_tpu/ops/pallas/scatter_add.py:rows_scatter_add
// (the pallas_call at :130).  The Pallas kernel walks table tiles in order
// and adds each tile's sorted updates one row after another; its D is padded
// to 128 lanes only for Mosaic's DMAs, so this kernel takes any D.
//
// Input (prepared by the wrapper, ops/scatter_add.py): the ids sorted by a
// STABLE sort, with every out-of-range id replaced by V so it sorts last
// (s_ids [N] int32), the permutation (order [N] int64), the rows in their
// original order (rows [N, D] f32), and a scratch of partial sums
// (partial [N, D] f32, only its chunk-head rows are written).
//
// Bound on the H100: bytes.  The output is written once (V*D*4; 1 GiB for a
// 2^22-row table of 64 floats), each update row read once (N*D*4), each id
// read once.  Design, two launches, no atomics, sums in a fixed order:
//   1. chunk pass: one warp per chunk of CH sorted slots, lanes over
//      columns.  A warp sums each run of equal ids inside its chunk in slot
//      order (the stable sort keeps the original order).  A run that starts
//      and ends inside the chunk is complete: it is written to out.  A run
//      cut by a chunk edge leaves its piece in partial[row of its first slot
//      in this chunk].  Loads of U rows are issued together, then summed.
//   2. fill pass: one block per TV output rows.  A block finds its range of
//      the sorted stream by binary search, marks the first and last slot of
//      each run, writes zero to every row without a run, skips the rows the
//      chunk pass completed, and sums the pieces of each cut run in slot
//      order.
// A run of one id over half of N (the padding id of variable-length
// histories) costs (run / CH) pieces in the fill pass, not a serial walk of
// the run: the time stays near N / parallelism.  Repeated calls give
// bit-equal sums.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CH = 64;   // sorted slots per warp in the chunk pass
constexpr int U = 8;     // row loads in flight per lane
constexpr int TV = 512;  // output rows per block in the fill pass

__global__ void __launch_bounds__(THREADS)
chunk_kernel(const int* __restrict__ s_ids, const long long* __restrict__ order,
             const float* __restrict__ rows, float* __restrict__ partial,
             float* __restrict__ out, int N, int V, int D) {
  __shared__ int sid[WARPS][CH + 1];
  __shared__ long long sord[WARPS][CH];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * WARPS + w) * CH;
  if (c0 >= N) return;  // whole warps only; no block-wide barrier below
  const int n = min(CH, N - c0);
  for (int j = lane; j < n; j += 32) {
    sid[w][j] = s_ids[c0 + j];
    sord[w][j] = order[c0 + j];
  }
  if (lane == 0) sid[w][n] = c0 + n < N ? s_ids[c0 + n] : -1;  // -1: no id
  const int prev = c0 > 0 ? s_ids[c0 - 1] : -1;
  __syncwarp();
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool live = d < D;
    float acc = 0.0f;
    int head = 0;  // first slot of the current piece, within the chunk
    for (int j0 = 0; j0 < n; j0 += U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        v[u] = (live && j < n && sid[w][j] < V)
                   ? rows[(size_t)sord[w][j] * D + d] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        const int id = j < n ? sid[w][j] : V;
        if (id >= V) break;  // out-of-range ids sort last: dropped
        acc += v[u];
        const bool run_end = sid[w][j + 1] != id;
        if (run_end || j + 1 == n) {
          const bool run_start = head > 0 || prev != id;
          if (live) {
            if (run_start && run_end) out[(size_t)id * D + d] = acc;
            else partial[(size_t)(c0 + head) * D + d] = acc;
          }
          acc = 0.0f;
          head = j + 1;
        }
      }
    }
  }
}

// First index i in [0, n) with a[i] >= key (n if none).
__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add4(float a, float b) { return a + b; }

// VEC = 4 moves float4s (D % 4 == 0), VEC = 1 single floats.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
fill_kernel(const int* __restrict__ s_ids, const float* __restrict__ partial,
            float* __restrict__ out, int N, int V, int D) {
  using T = typename std::conditional<VEC == 4, float4, float>::type;
  __shared__ int first[TV], last[TV], seg[2];
  const int v0 = blockIdx.x * TV;
  const int rows_here = min(TV, V - v0);
  if (threadIdx.x < 2)
    seg[threadIdx.x] = lower_bound(s_ids, N, threadIdx.x ? v0 + rows_here : v0);
  for (int r = threadIdx.x; r < TV; r += THREADS) first[r] = -1;
  __syncthreads();
  const int lo = seg[0], hi = seg[1];
  for (int i = lo + threadIdx.x; i < hi; i += THREADS) {
    const int id = s_ids[i];
    if (i == lo || s_ids[i - 1] != id) first[id - v0] = i;
    if (i + 1 == hi || s_ids[i + 1] != id) last[id - v0] = i + 1;
  }
  __syncthreads();
  const int DV = D / VEC;
  const T* part = reinterpret_cast<const T*>(partial);
  T* o = reinterpret_cast<T*>(out);
  T zero;
  if constexpr (VEC == 4) zero = make_float4(0.f, 0.f, 0.f, 0.f); else zero = 0.f;
  for (int e = threadIdx.x; e < rows_here * DV; e += THREADS) {
    const int r = e / DV, c = e - r * DV;
    const int a = first[r];
    T val = zero;
    if (a >= 0) {
      const int b = last[r];
      if (a / CH == (b - 1) / CH) continue;  // completed by the chunk pass
      val = part[(size_t)a * DV + c];
#pragma unroll 8
      for (int h = (a / CH + 1) * CH; h < b; h += CH)
        val = add4(val, part[(size_t)h * DV + c]);
    }
    o[(size_t)(v0 + r) * DV + c] = val;
  }
}

}  // namespace

extern "C" int tt_rows_scatter_add(const void* s_ids, const void* order,
                                   const void* rows, void* partial, void* out,
                                   int N, int V, int D, void* stream) {
  if (N < 0 || V < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    const int warps = (N + CH - 1) / CH;
    chunk_kernel<<<(warps + WARPS - 1) / WARPS, THREADS, 0, st>>>(
        (const int*)s_ids, (const long long*)order, (const float*)rows,
        (float*)partial, (float*)out, N, V, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (V + TV - 1) / TV;
  if (D % 4 == 0)
    fill_kernel<4><<<blocks, THREADS, 0, st>>>((const int*)s_ids, (const float*)partial,
                                               (float*)out, N, V, D);
  else
    fill_kernel<1><<<blocks, THREADS, 0, st>>>((const int*)s_ids, (const float*)partial,
                                               (float*)out, N, V, D);
  return (int)cudaGetLastError();
}
