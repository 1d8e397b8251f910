// Top-k select over rows, passes 2 and 4 of the exact MIPS pipeline: a
// radix select (select_radix_kernel, k <= K_MAX) and the tournament it
// replaced (select_topk_kernel, kept for larger k).
//
// Replaces two_tower_models_tpu/ops/pallas/mips_topk.py:select_topk_t
// (_select_keys_t -> _select_topk_kernel): per row, k rounds of
// (max key -> lowest index among equal keys -> mask it with INT_MIN) over
// monotone int32 keys, which is lax.top_k's total order: descending, ties to
// the lowest index, -0.0 below +0.0, NaN above +inf.  Input is either f32
// scores (mapped to clamped keys on load, common.cuh) or int32 keys (the
// hierarchical merge of rows too long for shared memory; INT_MIN pads and
// INT_MAX are ordinary keys there).  Output keys and positions, [rows, k]
// each, sorted by (key desc, position asc).
//
// Bound on the H100: memory: the row is read once (32 KB at NT=8192, 50 KB
// at the 12,800-candidate pool) and the outputs written once.  Both kernels
// keep one row in shared memory, one block of 512 threads a row.
//
// The radix select costs a fixed number of passes over the row in shared
// memory, whatever k.  Keys become unsigned (key ^ 0x80000000), so unsigned
// order is the key order.
//  1. From the top digit down, 8 bits a pass, at most 4 passes: a histogram
//     of the digit over the keys whose higher digits equal the prefix found
//     so far (one shared histogram, a shared atomicAdd a key; the top
//     digit's is counted while the row is loaded), then one warp sums the
//     bins from the top and finds the bin where the count reaches the
//     remaining k.  It stops early when that bin holds exactly the
//     remaining count: every key at or above the bin's floor survives
//     (most rows of the serving passes stop after 2-3 digits).  Otherwise
//     the last pass leaves the k-th key T, the count above it, and
//     need_eq = k - (count above T) keys equal to T to take.
//  2. Compaction, each warp over a contiguous run of positions: the keys
//     above the threshold in any order, each warp's ballot taking its slots
//     from a shared counter; then, only where T's ties are split, a second
//     walk keeps a key equal to T when its rank among the equal keys in
//     position order (a scan of the warps' counts, then ballots) is below
//     need_eq: the lowest-position tie rule, whichever warps the ties fall
//     in.  A survivor is stored as (ukey << 32) | (2^32 - 1 - position), as
//     select_keys_plain builds it; these are all distinct.
//  3. The k survivors (k <= K_MAX) are ranked by counting the larger ones,
//     a read of k broadcast values a survivor, and written to their rank.
// The histogram and the survivors share the shared memory behind the row.

// The tournament: thread t owns positions t, t+T, ... and caches the best
// (key, position) among them; a round is one block-wide lexicographic
// reduction of the cached bests, after which only the winner's owner
// flags the position taken (in its registers: a key masked with INT_MIN
// would tie with the INT_MIN keys of int32 input and be taken again) and
// rescans its own positions.  It costs k rounds of two barriers, so it
// stays only for k above K_MAX (or rows whose survivors would not fit).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int K_MAX = 1024;  // radix route's largest k (mips_topk.K_MAX)
constexpr int BINS = 256;
constexpr int TAKEN_WORDS = 4;  // tournament: 128 positions a thread, n <= 65,536
constexpr int WARPS = THREADS / 32;

struct Best {
  int key;
  int idx;
};

// (key desc, index asc): the better of two candidates.
__device__ __forceinline__ Best better(Best a, Best b) {
  return (a.key > b.key || (a.key == b.key && a.idx < b.idx)) ? a : b;
}

// The best of thread t's own positions not yet taken (bit j of taken:
// position t + j * THREADS).
__device__ __forceinline__ Best scan_own(const int* keys, const unsigned* taken, int n, int t) {
  Best best{INT_MIN, n};
  for (int i = t, j = 0; i < n; i += THREADS, ++j)
    if (!((taken[j >> 5] >> (j & 31)) & 1u) && (keys[i] > best.key || best.idx == n))
      best = Best{keys[i], i};
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
  unsigned taken[TAKEN_WORDS] = {};
  Best mine = scan_own(keys, taken, n, t);
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
      const int j = w.idx / THREADS;
      taken[j >> 5] |= 1u << (j & 31);
      mine = scan_own(keys, taken, n, t);
    }
    // winner and warp_best are rewritten only after the next round's first
    // barrier, which every thread reaches after reading them here.
  }
}


__global__ void __launch_bounds__(THREADS)
select_radix_kernel(const int* __restrict__ in, int* __restrict__ out_key,
                    int* __restrict__ out_idx, int n, int k, int is_f32) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* keys = reinterpret_cast<unsigned*>(smem);  // [n], padded to even
  int* hist = reinterpret_cast<int*>(keys + ((n + 1) & ~1));  // [BINS], then
  unsigned long long* surv = reinterpret_cast<unsigned long long*>(hist);  // [k]
  __shared__ int s_bin, s_above, s_cnt, s_fill;
  __shared__ int s_weq[WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int* src = in + (size_t)blockIdx.x * n;

  // the row into shared memory, counting the top digit on the way
  if (t < BINS) hist[t] = 0;
  __syncthreads();
#pragma unroll 4
  for (int i = t; i < n; i += THREADS) {
    const int v = src[i];
    const unsigned u = (unsigned)(is_f32 ? tt::f32_key(v) : v) ^ 0x80000000u;
    keys[i] = u;
    atomicAdd(&hist[u >> 24], 1);
  }

  // 1. radix select, top digit first
  unsigned prefix = 0;  // the digits found, at `shift` and above
  int krem = k;         // keys still to take inside the prefix's range
  bool exact = false;   // the last bin held exactly krem keys
  int shift = 24;
  for (;;) {
    __syncthreads();  // the histogram of the digit at `shift` is complete
    if (warp == 0) {  // lane l sums bins 255 - 8l down to 248 - 8l
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[BINS - 1 - 8 * lane - j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      int above = incl - sum;
      if (above < krem && krem <= incl) {  // one lane
        int pick = -1;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (pick < 0) {
            if (above + c[j] >= krem) {
              pick = j;
              s_cnt = c[j];
            } else {
              above += c[j];
            }
          }
        s_bin = BINS - 1 - 8 * lane - pick;
        s_above = above;
      }
    }
    __syncthreads();
    prefix |= (unsigned)s_bin << shift;
    krem -= s_above;
    exact = s_cnt == krem;
    if (exact || shift == 0) break;
    shift -= 8;
    if (t < BINS) hist[t] = 0;  // warp 0 read it before the barrier above
    __syncthreads();
    for (int i = t; i < n; i += THREADS) {
      const unsigned u = keys[i];
      if ((u ^ prefix) >> (shift + 8) == 0) atomicAdd(&hist[(u >> shift) & (BINS - 1)], 1);
    }
  }
  // survivors: ukey >= lo, and the first need_eq keys equal to teq
  const unsigned long long lo = exact ? prefix : (unsigned long long)prefix + 1;
  const int need_eq = exact ? 0 : krem;
  const unsigned teq = prefix;

  // 2. compaction over each warp's run of positions: the keys above the
  // threshold in any order (slots from a shared counter); where the
  // threshold's ties are split, a second walk takes the first need_eq of
  // them in position order (each warp's offset from a scan of the counts)
  if (t == 0) s_fill = 0;
  __syncthreads();  // every histogram read is done: surv may overwrite it
  const int seg = ((n + WARPS - 1) / WARPS + 31) & ~31;
  const int s0 = warp * seg, s1 = min(n, s0 + seg);
  const unsigned below = (1u << lane) - 1u;
  int n_eq = 0;
  for (int base = s0; base < s1; base += 32) {
    const int i = base + lane;
    const unsigned u = i < s1 ? keys[i] : 0u;
    const bool g = i < s1 && u >= lo;
    const unsigned bg = __ballot_sync(0xffffffffu, g);
    n_eq += __popc(__ballot_sync(0xffffffffu, i < s1 && need_eq > 0 && u == teq));
    if (bg) {
      int at = 0;
      if (lane == 0) at = atomicAdd(&s_fill, __popc(bg));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (g) surv[at + __popc(bg & below)] = ((unsigned long long)u << 32) | (0xffffffffu - i);
    }
  }
  if (need_eq > 0) {  // the same in every thread
    if (lane == 0) s_weq[warp] = n_eq;
    __syncthreads();
    const int n_gt = s_fill;
    int eq_at = 0;
    for (int w = 0; w < warp; ++w) eq_at += s_weq[w];
    for (int base = s0; base < s1 && eq_at < need_eq; base += 32) {
      const int i = base + lane;
      const bool e = i < s1 && keys[i] == teq;
      const unsigned be = __ballot_sync(0xffffffffu, e);
      const int r = eq_at + __popc(be & below);
      if (e && r < need_eq) surv[n_gt + r] = ((unsigned long long)teq << 32) | (0xffffffffu - i);
      eq_at += __popc(be);
    }
  }
  __syncthreads();

  // 3. rank the k survivors (all distinct) and write each at its rank
  int* ok = out_key + (size_t)blockIdx.x * k;
  int* oi = out_idx + (size_t)blockIdx.x * k;
  for (int i = t; i < k; i += THREADS) {
    const unsigned long long c = surv[i];
    int r = 0;
#pragma unroll 4
    for (int j = 0; j < k; ++j) r += surv[j] > c;
    ok[r] = (int)((unsigned)(c >> 32) ^ 0x80000000u);
    oi[r] = (int)(0xffffffffu - (unsigned)c);
  }
}

}  // namespace

extern "C" int tt_select_topk_rows(const void* in, void* out_key,
                                   void* out_idx, int rows, int n, int k,
                                   int is_f32, void* stream) {
  if (k < 1 || k > n || (n + THREADS - 1) / THREADS > 32 * TAKEN_WORDS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      select_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  select_topk_kernel<<<rows, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)in, (int*)out_key, (int*)out_idx, n, k, is_f32);
  return (int)cudaGetLastError();
}

// Radix route: k <= K_MAX, and the row (n int32 keys) plus the larger of
// the histogram and the k survivors (8 bytes each) in the block's shared
// memory.
extern "C" int tt_select_topk_radix(const void* in, void* out_key, void* out_idx, int rows,
                                    int n, int k, int is_f32, void* stream) {
  if (k < 1 || k > n || k > K_MAX) return (int)cudaErrorInvalidValue;
  // the dynamic shared memory a block may take: asked, and opted into, once
  static long long budget = -1;
  if (budget < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, select_radix_kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(select_radix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)attr.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    budget = (long long)optin - (long long)attr.sharedSizeBytes;
  }
  // the row, then the larger of the histogram and the k survivors
  const long long smem = (long long)((n + 1) & ~1) * 4 + std::max(BINS * 4LL, 8LL * k);
  if (smem > budget) return (int)cudaErrorInvalidValue;
  select_radix_kernel<<<rows, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int*)in, (int*)out_key, (int*)out_idx, n, k, is_f32);
  return (int)cudaGetLastError();
}
