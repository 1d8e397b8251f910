// Approximate-top-k bin max: the reduction of the approximate MIPS scan.
//
// Replaces no pl.pallas_call site.  The JAX package's approximate paths
// (two_tower_models_tpu/retrieval/mips.py:mips_topk_approx, retrieval/
// quant.py:quantized_shard_topk) score the whole [B, C] matrix with
// jnp.dot and hand it to lax.approx_max_k, which the TPU runs as XLA's
// PartialReduce.  Without a kernel the port would write those scores
// (4 GiB a batch at B = 1024, C = 2^20) only to reduce them, so this kernel
// scores and reduces in one pass: for query b and bin j < M
//   out[b, j] = max over rows r = j + w M < C of s(b, r),
//   s(b, r) = <q_b, c_r>            (f32 rows), or
//   s(b, r) = <q_b, q_r> * scale_r  (int8 rows with their f32 scale),
// rows r >= `valid` scoring -inf, the max in the select's int32 key order
// (ops/mips_topk.py f32_keys: -NaN below -inf, +NaN above +inf), a tie in
// key to the lowest row; rows[b, j] = the row that holds it.  Strided bins
// are the padded row axis seen as [W, M] and reduced over W, whose output
// size is XLA's (ops/approx_topk.py approx_bins).  Outputs [B, M] f32 and
// int32.
//
// Bound on the H100: operations.  2*B*C*D f32 multiply-adds (137 GFLOP at
// B = 1024, C = 2^20, D = 64: 2.05 ms at 67 TFLOP/s) on the CUDA cores; the
// corpus is read about once (256 MiB f32, 64 MiB int8).
//
// Design: B2's register-blocked SIMT product (csrc/tile_max.cu) with a
// running max where B2 reduces a tile.
//  - A block takes 64 queries (d-major in shared memory, loaded once) and
//    64 consecutive bins j0 .. j0 + 63, and walks the depths w = 0 .. W-1:
//    the rows w M + j0 .. + 63, consecutive in memory, arrive by cp.async
//    into a two-stage ring while the previous depth is scored.  Int8 rows
//    arrive as bytes and are widened to f32 in shared memory once a depth
//    (exact), so both instances run the same product.
//  - A thread holds 8 queries x 4 bins: 32 accumulators and, for each, its
//    running (key, depth) pair across the walk: 96 registers of state, so
//    no reduction across threads.  B2's 16 x 8 a thread would not fit
//    beside the pairs.  Per four d-steps a thread reads its 8 queries as 8
//    LDS.128 (the 16 lanes of a query group read one address) and its 4
//    rows as 4 LDS.128 at a stride whose float4 count is odd (tt::padded),
//    for 128 FFMA, each the chain fmaf(q[d], c[d], acc) in d order
//    (common.cuh: an f32 score is B2's and B4's bit for bit).
//  - The depth's epilogue: each of the thread's 32 scores (times the row's
//    scale for int8) to its key, -inf's key past `valid`; a strictly larger
//    key replaces the pair, so the lowest depth keeps a tie.  The pair
//    starts at (INT_MIN, depth 0): every bin has its depth-0 row (M <= C).
//  - Grid: ceil(B / 64) query blocks x ceil(M / 64) bin blocks, the query
//    block fastest, so the blocks that share bins start together and the
//    rows stream from HBM about once and from L2 for the others.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int RQ = 8;         // queries per thread: tq * RQ + i
constexpr int RC = 4;         // bins per thread: tr + 16 j
constexpr int THREADS = 128;  // 8 query groups x 16 bin groups
constexpr int TQ = RQ * THREADS / 16;  // queries per block
constexpr int NB = RC * 16;            // bins per block
constexpr int MAX_D = 128;

// Dynamic shared memory: TQ queries of D floats, d-major; f32 rows: a
// two-stage ring of NB rows of tt::padded(D) floats; int8 rows: one such
// stage of widened rows and a two-stage ring of NB rows of D bytes.
__host__ __device__ constexpr size_t smem_bytes(int D, bool int8) {
  return sizeof(float) * ((size_t)D * TQ + (int8 ? 1 : 2) * (size_t)NB * tt::padded(D)) +
         (int8 ? 2 * (size_t)NB * D : 0);
}

__device__ __forceinline__ float part(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The monotone int32 key of an f32 (f32_keys of ops/mips_topk.py) and back.
__device__ __forceinline__ int key_of(float x) {
  int b = __float_as_int(x);
  return b < 0 ? (b ^ 0x7fffffff) : b;
}
__device__ __forceinline__ float value_of(int k) {
  return __int_as_float(k < 0 ? (k ^ 0x7fffffff) : k);
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS, 3)
approx_scan_kernel(const float* __restrict__ q, const void* __restrict__ c,
                   const float* __restrict__ scale, float* __restrict__ vals,
                   int* __restrict__ rows, int B, int C, int D, int M, int lim, int QB) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int SC = tt::padded(D);
  float* qs = smem;           // [D][TQ]
  float* cs = smem + D * TQ;  // f32: [2][NB][SC]; int8: [NB][SC], then [2][NB][D] bytes
  unsigned char* cb = reinterpret_cast<unsigned char*>(cs + NB * SC);
  const int tid = threadIdx.x;
  const int tr = tid % 16;  // bin group: bins j0 + tr + 16 j
  const int tq = tid / 16;  // query group: queries q0 + tq * RQ + i
  const int q0 = (blockIdx.x % QB) * TQ;
  const int j0 = (blockIdx.x / QB) * NB;
  const int depths = (C - j0 + M - 1) / M;  // rows w M + j0 exist for w < depths
  const int d4 = D / 4;

  for (int e = tid; e < TQ * d4; e += THREADS) {  // once a block: transposed to d-major
    const int qi = e % TQ, c4 = e / TQ;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + qi < B) v = reinterpret_cast<const float4*>(q + (size_t)(q0 + qi) * D)[c4];
    qs[(4 * c4 + 0) * TQ + qi] = v.x;
    qs[(4 * c4 + 1) * TQ + qi] = v.y;
    qs[(4 * c4 + 2) * TQ + qi] = v.z;
    qs[(4 * c4 + 3) * TQ + qi] = v.w;
  }

  // depth w's rows w M + j0 + r for the block's bins r < NB, 16 bytes a
  // copy; rows past C and bins past M land as zeros (the epilogue skips them)
  auto load = [&](int w) {
    const long long row0 = (long long)w * M + j0;
    const int pieces = INT8 ? D / 16 : D / 4;  // 16-byte pieces of a row
    for (int e = tid; e < NB * pieces; e += THREADS) {
      const int r = e / pieces, p = e % pieces;
      const bool in = j0 + r < M && row0 + r < C;
      if (INT8) {
        const unsigned char* src = static_cast<const unsigned char*>(c) + (row0 + r) * D + 16 * p;
        tt::cp_async16(cb + ((size_t)(w & 1) * NB + r) * D + 16 * p,
                       in ? (const void*)src : c, in ? 16 : 0);
      } else {
        const float* src = static_cast<const float*>(c) + (row0 + r) * D + 4 * p;
        tt::cp_async16(cs + ((size_t)(w & 1) * NB + r) * SC + 4 * p,
                       in ? (const void*)src : c, in ? 16 : 0);
      }
    }
    tt::cp_commit();
  };

  int best[RQ][RC], depth[RQ][RC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      best[i][j] = INT_MIN;
      depth[i][j] = 0;
    }
  const int neg_inf = key_of(-INFINITY);

  if (depths > 0) load(0);
  for (int w = 0; w < depths; ++w) {
    if (w + 1 < depths) {  // the next depth streams in while this one is scored
      load(w + 1);
      tt::cp_wait<1>();
    } else {
      tt::cp_wait<0>();
    }
    __syncthreads();  // depth w (and, at w == 0, the queries) visible to all
    const float* rowbuf = cs;
    if (INT8) {  // widen the bytes once: int8 values are exact in f32
      const signed char* src = reinterpret_cast<const signed char*>(cb + (size_t)(w & 1) * NB * D);
      for (int e = tid; e < NB * d4; e += THREADS) {
        const int r = e / d4, k4 = e % d4;
        const char4 v = reinterpret_cast<const char4*>(src + (size_t)r * D)[k4];
        reinterpret_cast<float4*>(cs + r * SC)[k4] =
            make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
      }
      __syncthreads();
    } else {
      rowbuf = cs + (w & 1) * NB * SC;
    }

    float acc[RQ][RC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] = 0.0f;
    const float* cst = rowbuf + tr * SC;
    const float* qst = qs + tq * RQ;
#pragma unroll 1
    for (int u = 0; u < d4; ++u) {
      float4 cv[RC];  // bins tr + 16 j at d = 4u .. 4u + 3
#pragma unroll
      for (int j = 0; j < RC; ++j)
        cv[j] = *reinterpret_cast<const float4*>(cst + 16 * j * SC + 4 * u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // d in order: the canonical chain
        float qv[RQ];
#pragma unroll
        for (int i = 0; i < RQ; i += 4)
          *reinterpret_cast<float4*>(qv + i) =
              *reinterpret_cast<const float4*>(qst + (4 * u + k) * TQ + i);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(qv[i], part(cv[j], k), acc[i][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int bin = j0 + tr + 16 * j;
      const long long row = (long long)w * M + bin;
      const bool in = bin < M && row < C;
      const bool valid = row < lim;
      const float sc = (INT8 && in) ? __ldg(scale + row) : 1.0f;
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int key = valid ? key_of(INT8 ? acc[i][j] * sc : acc[i][j]) : neg_inf;
        if (in && key > best[i][j]) {
          best[i][j] = key;
          depth[i][j] = w;
        }
      }
    }
    __syncthreads();  // this depth's readers are done before its buffers are refilled
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int b = q0 + tq * RQ + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int bin = j0 + tr + 16 * j;
      if (bin >= M) continue;
      vals[(size_t)b * M + bin] = value_of(best[i][j]);
      rows[(size_t)b * M + bin] = depth[i][j] * M + bin;
    }
  }
}

}  // namespace

// q [B, D] f32; c [C, D] f32 (int8 == 0) or int8 with scale [C] f32
// (int8 == 1); vals [B, M] f32, rows [B, M] int32; rows >= valid score
// -inf.  Needs 1 <= M <= C, D % 4 == 0 (f32) or D % 16 == 0 (int8), D <= 128.
extern "C" int tt_approx_scan(const void* q, const void* c, const void* scale, void* vals,
                              void* rows, int B, int C, int D, int M, int valid, int int8,
                              void* stream) {
  if (D <= 0 || D > MAX_D || D % (int8 ? 16 : 4) != 0 || M < 1 || M > C || B < 1)
    return (int)cudaErrorInvalidValue;
  const int QB = (B + TQ - 1) / TQ;
  const int NBB = (M + NB - 1) / NB;
  const size_t smem = smem_bytes(D, int8 != 0);
  const int lim = valid < C ? valid : C;
  cudaError_t err;
  if (int8) {
    err = cudaFuncSetAttribute(approx_scan_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    approx_scan_kernel<true><<<dim3((unsigned)(QB * NBB)), THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)q, c, (const float*)scale, (float*)vals, (int*)rows, B, C, D, M, lim, QB);
  } else {
    err = cudaFuncSetAttribute(approx_scan_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    approx_scan_kernel<false><<<dim3((unsigned)(QB * NBB)), THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)q, c, nullptr, (float*)vals, (int*)rows, B, C, D, M, lim, QB);
  }
  return (int)cudaGetLastError();
}
