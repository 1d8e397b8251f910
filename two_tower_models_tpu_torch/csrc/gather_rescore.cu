// Candidate gather-rescore, the third pass of the exact MIPS pipeline.
//
// Replaces two_tower_models_tpu/ops/pallas/mips_topk.py:gather_rescore
// (_gather_rescore_kernel): cand[b, j*TILE + r] = <q_b, c[tile_idx[b, j]*TILE + r]>
// in f32.  Rows past the corpus end score as zero rows (so does every row
// of a tile index outside [0, NT)); the caller masks rows >= valid_count.
//
// Bound on the H100: memory.  The distinct selected tiles (about the whole
// 268 MB corpus at B=1024, k=100, C=2^20, D=64) read once and the
// [B, k*TILE] f32 output (52 MB) written once: 0.096 ms.  Reading every
// selected tile once per query that picked it, as one block per query
// does, moves B*k*TILE*D*4 = 3.4 GB, each tile about 12.5 times.
//
// Design: invert the selection, then score by tile.
//  - invert_count_kernel, invert_scan_kernel, invert_scatter_kernel: a
//    histogram of the B*k (query, slot) pairs over NT + 1 buckets (the last
//    takes indices outside [0, NT)), one block's exclusive scan of it, and
//    a scatter of each pair's flat index b*k + j into its bucket's list
//    (slot by atomics: each output is computed alone, so the order inside a
//    list changes no bit).  The scan also cuts each list into work items of
//    at most QW pairs and writes them, with their count, to device memory.
//  - rescore_kernel: one block a work item, on a grid of the plan's upper
//    bound on items (ops/mips_topk.py:_rescore_plan); blocks past the count
//    exit, so the host never reads a count back.  A block copies its tile
//    into shared memory once with 16-byte cp.async (zeros past C), copies
//    its pairs' queries beside it, and scores 128 rows x QW queries, a row
//    a thread and eight queries at a time in registers, with the canonical
//    fmaf chain of common.cuh.  Each pair's 128 scores are one contiguous
//    512-byte store.  A tile picked by many queries becomes many items that
//    read it from L2, so skew spreads over the card.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int TILE = 128;           // corpus rows per tile; threads of rescore_kernel
constexpr int QW = 32;              // pairs a work item at most
constexpr int QG = 8;               // queries a thread scores at once
constexpr int SCAN_THREADS = 1024;  // the one block of invert_scan_kernel
constexpr int PAIR_THREADS = 256;   // count and scatter blocks

__host__ __device__ constexpr size_t rescore_smem_bytes(int D) {
  return sizeof(float) * (size_t)(TILE + QW) * tt::padded(D) + sizeof(int) * QW;
}

// The scratch the wrapper allocates (int32; ops/mips_topk.py:_rescore_plan):
// items [bound] int4 {tile, first pair, pairs}, the item count (padded to
// an int4), counts [NT + 1], offsets [NT + 2], pairs [B * k].
struct Scratch {
  int4* items;
  int* n_items;
  int* counts;
  int* offsets;
  int* pairs;
};

inline Scratch scratch_of(int* s, int NT, int bound) {
  Scratch r;
  r.items = reinterpret_cast<int4*>(s);
  r.n_items = s + 4 * (size_t)bound;
  r.counts = r.n_items + 4;
  r.offsets = r.counts + NT + 1;
  r.pairs = r.offsets + NT + 2;
  return r;
}

__device__ __forceinline__ int bucket_of(int t, int NT) { return (t >= 0 && t < NT) ? t : NT; }

__global__ void __launch_bounds__(PAIR_THREADS)
invert_count_kernel(const int* __restrict__ tile_idx, int* __restrict__ counts, int n, int NT) {
  const int p = blockIdx.x * PAIR_THREADS + threadIdx.x;
  if (p < n) atomicAdd(&counts[bucket_of(tile_idx[p], NT)], 1);
}

// Exclusive scans of the pair counts and of the items per bucket; writes
// offsets, the items and their count, and zeroes counts (the scatter's
// cursors).  Each thread owns a contiguous run of buckets.
__global__ void __launch_bounds__(SCAN_THREADS)
invert_scan_kernel(int* __restrict__ counts, int* __restrict__ offsets, int4* __restrict__ items,
                   int* __restrict__ n_items, int buckets) {
  __shared__ int warp_pairs[SCAN_THREADS / 32], warp_items[SCAN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (buckets + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(tid * per, buckets), hi = min(lo + per, buckets);
  int pairs = 0, its = 0;
  for (int t = lo; t < hi; ++t) {
    const int n = counts[t];
    pairs += n;
    its += (n + QW - 1) / QW;
  }
  // inclusive warp scans, then the warps' totals
  int ip = pairs, ii = its;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, ip, off), b = __shfl_up_sync(0xffffffffu, ii, off);
    if (lane >= off) {
      ip += a;
      ii += b;
    }
  }
  if (lane == 31) {
    warp_pairs[warp] = ip;
    warp_items[warp] = ii;
  }
  __syncthreads();
  if (warp == 0) {
    int wp = warp_pairs[lane], wi = warp_items[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, wp, off), b = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) {
        wp += a;
        wi += b;
      }
    }
    warp_pairs[lane] = wp;  // inclusive over warps
    warp_items[lane] = wi;
  }
  __syncthreads();
  int p0 = ip - pairs + (warp ? warp_pairs[warp - 1] : 0);
  int i0 = ii - its + (warp ? warp_items[warp - 1] : 0);
  for (int t = lo; t < hi; ++t) {
    const int n = counts[t];
    offsets[t] = p0;
    for (int s = 0; s < n; s += QW) items[i0++] = make_int4(t, p0 + s, min(QW, n - s), 0);
    p0 += n;
    counts[t] = 0;
  }
  if (tid == SCAN_THREADS - 1) {
    offsets[buckets] = p0;
    *n_items = i0;
  }
}

__global__ void __launch_bounds__(PAIR_THREADS)
invert_scatter_kernel(const int* __restrict__ tile_idx, int* __restrict__ cursor,
                      const int* __restrict__ offsets, int* __restrict__ pairs, int n, int NT) {
  const int p = blockIdx.x * PAIR_THREADS + threadIdx.x;
  if (p < n) {
    const int t = bucket_of(tile_idx[p], NT);
    pairs[offsets[t] + atomicAdd(&cursor[t], 1)] = p;
  }
}

__global__ void __launch_bounds__(TILE)
rescore_kernel(const float* __restrict__ q, const float* __restrict__ c,
               const int4* __restrict__ items, const int* __restrict__ n_items,
               const int* __restrict__ pairs, float* __restrict__ out, int C, int D, int k,
               int NT) {
  const int n_it = *n_items;
  const int4 item = items[blockIdx.x];  // read beside the count: in bounds either way
  if ((int)blockIdx.x >= n_it) return;
  extern __shared__ float4 smem4[];
  const int S = tt::padded(D);
  float* cs = reinterpret_cast<float*>(smem4);  // [TILE][S]
  float* qs = cs + TILE * S;                    // [QW][S]
  int* ps = reinterpret_cast<int*>(qs + QW * S);  // [QW] flat pair indices
  const int r = threadIdx.x;
  const int t = item.x, first = item.y, n = item.z;
  const int d4 = D / 4;
  const long long row0 = (long long)t * TILE;
  for (int e = r; e < TILE * d4; e += TILE) {
    const int rr = e / d4, c4 = e % d4;
    const bool in = t < NT && row0 + rr < C;
    tt::cp_async16(cs + rr * S + c4 * 4, in ? c + (size_t)(row0 + rr) * D + c4 * 4 : c,
                   in ? 16 : 0);
  }
  for (int e = r; e < n * d4; e += TILE) {
    const int p = e / d4, c4 = e % d4;
    tt::cp_async16(qs + p * S + c4 * 4, q + (size_t)(pairs[first + p] / k) * D + c4 * 4, 16);
  }
  tt::cp_commit();
  if (r < n) ps[r] = pairs[first + r];
  tt::cp_wait<0>();
  __syncthreads();

  const float* cr = cs + r * S;
  for (int g = 0; g < n; g += QG) {  // slots past n score stale queries and are not stored
    float acc[QG];
#pragma unroll
    for (int i = 0; i < QG; ++i) acc[i] = 0.0f;
#pragma unroll 2
    for (int u = 0; u < d4; ++u) {
      const float4 cv = *reinterpret_cast<const float4*>(cr + 4 * u);
#pragma unroll
      for (int i = 0; i < QG; ++i) {  // d, d+1, d+2, d+3 in order: the canonical chain
        const float4 qv = *reinterpret_cast<const float4*>(qs + (g + i) * S + 4 * u);
        acc[i] = fmaf(qv.x, cv.x, acc[i]);
        acc[i] = fmaf(qv.y, cv.y, acc[i]);
        acc[i] = fmaf(qv.z, cv.z, acc[i]);
        acc[i] = fmaf(qv.w, cv.w, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < QG; ++i)
      if (g + i < n) out[(size_t)ps[g + i] * TILE + r] = acc[i];  // b*k + j: out[b, j*TILE + r]
  }
}

}  // namespace

// Inverts tile_idx [n = B*k] into `scratch` (ops/mips_topk.py:_rescore_plan
// sizes it for `bound` items).
extern "C" int tt_gather_rescore_invert(const void* tile_idx, void* scratch, int n, int NT,
                                        int bound, void* stream) {
  if (n < 1 || NT < 1 || bound < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Scratch s = scratch_of((int*)scratch, NT, bound);
  cudaError_t err = cudaMemsetAsync(s.counts, 0, sizeof(int) * (NT + 1), st);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + PAIR_THREADS - 1) / PAIR_THREADS;
  invert_count_kernel<<<blocks, PAIR_THREADS, 0, st>>>((const int*)tile_idx, s.counts, n, NT);
  invert_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(s.counts, s.offsets, s.items, s.n_items, NT + 1);
  invert_scatter_kernel<<<blocks, PAIR_THREADS, 0, st>>>((const int*)tile_idx, s.counts,
                                                         s.offsets, s.pairs, n, NT);
  return (int)cudaGetLastError();
}

// Scores the work items of an inverted selection into out [B, k*TILE].
extern "C" int tt_gather_rescore(const void* q, const void* c, const void* scratch, void* out,
                                 int C, int D, int k, int NT, int bound, int tile, void* stream) {
  if (tile != TILE || D % 4 != 0 || D <= 0 || D > 200 || k < 1 || bound < 1)
    return (int)cudaErrorInvalidValue;
  Scratch s = scratch_of((int*)scratch, NT, bound);
  const size_t smem = rescore_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      rescore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rescore_kernel<<<bound, TILE, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)c, s.items, s.n_items, s.pairs, (float*)out, C, D, k, NT);
  return (int)cudaGetLastError();
}
