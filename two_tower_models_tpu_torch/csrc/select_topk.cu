// Tournament top-k select over rows, passes 2 and 4 of the exact MIPS
// pipeline.
//
// Replaces two_tower_models_tpu/ops/pallas/mips_topk.py:select_topk_t
// (_select_keys_t -> _select_topk_kernel): per row, k rounds of
// (max key -> lowest index among equal keys -> mask it with INT_MIN) over
// monotone int32 keys, which is lax.top_k's total order: descending, ties to
// the lowest index, -0.0 below +0.0, NaN above +inf.  Input is either f32
// scores (mapped to clamped keys on load, common.cuh) or int32 keys (the
// hierarchical merge of rows too long for shared memory).  Output keys and
// positions, [rows, k] each.
//
// Bound on the H100: memory, and in practice latency: the row is read once
// (32 KB at NT=8192, 50 KB at the 12,800-candidate pool) and the k rounds
// run in shared memory.  Design: one block per row, the row's keys in
// shared memory.  Thread t owns positions t, t+T, ... and caches the best
// (key, position) among them; a round is one block-wide lexicographic
// reduction of the cached bests, after which only the winner's owner
// rescans its own positions.  So a round costs one reduction and n/T reads,
// not a pass over the row.

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

struct Best {
  int key;
  int idx;
};

// (key desc, index asc): the better of two candidates.
__device__ __forceinline__ Best better(Best a, Best b) {
  return (a.key > b.key || (a.key == b.key && a.idx < b.idx)) ? a : b;
}

__device__ __forceinline__ Best scan_own(const int* keys, int n, int t) {
  Best best{INT_MIN, n};
  for (int i = t; i < n; i += THREADS)
    if (keys[i] > best.key || best.idx == n) best = Best{keys[i], i};
  return best;
}

__global__ void __launch_bounds__(THREADS)
select_topk_kernel(const int* __restrict__ in, int* __restrict__ out_key,
                   int* __restrict__ out_idx, int n, int k, int is_f32) {
  extern __shared__ int keys[];  // [n]
  __shared__ Best warp_best[WARPS];
  __shared__ Best winner;
  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const int* src = in + (size_t)blockIdx.x * n;
  for (int i = t; i < n; i += THREADS) {
    int v = src[i];
    keys[i] = is_f32 ? tt::f32_key(v) : v;
  }
  __syncthreads();
  Best mine = scan_own(keys, n, t);
  for (int j = 0; j < k; ++j) {
    Best b = mine;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Best o{__shfl_xor_sync(0xffffffffu, b.key, off),
             __shfl_xor_sync(0xffffffffu, b.idx, off)};
      b = better(b, o);
    }
    if (lane == 0) warp_best[warp] = b;
    __syncthreads();
    if (warp == 0) {
      b = lane < WARPS ? warp_best[lane] : Best{INT_MIN, n};
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        Best o{__shfl_xor_sync(0xffffffffu, b.key, off),
               __shfl_xor_sync(0xffffffffu, b.idx, off)};
        b = better(b, o);
      }
      if (lane == 0) {
        winner = b;
        out_key[(size_t)blockIdx.x * k + j] = b.key;
        out_idx[(size_t)blockIdx.x * k + j] = b.idx;
      }
    }
    __syncthreads();
    const Best w = winner;
    if (w.idx % THREADS == t) {
      keys[w.idx] = INT_MIN;
      mine = scan_own(keys, n, t);
    }
    // winner and warp_best are rewritten only after the next round's first
    // barrier, which every thread reaches after reading them here.
  }
}

}  // namespace

extern "C" int tt_select_topk_rows(const void* in, void* out_key,
                                   void* out_idx, int rows, int n, int k,
                                   int is_f32, void* stream) {
  if (k < 1 || k > n) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      select_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  select_topk_kernel<<<rows, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)in, (int*)out_key, (int*)out_idx, n, k, is_f32);
  return (int)cudaGetLastError();
}
