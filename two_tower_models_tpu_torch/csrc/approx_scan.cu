// Approximate-top-k bin max (N1): the reduction of the approximate MIPS scan.
//
// Replaces no pl.pallas_call site.  The JAX package's approximate paths
// (two_tower_models_tpu/retrieval/mips.py:mips_topk_approx, retrieval/
// quant.py:quantized_shard_topk) score the whole [B, C] matrix with
// jnp.dot and hand it to lax.approx_max_k, which the TPU runs as XLA's
// PartialReduce.  Without a kernel the port would write those scores
// (4 GiB a batch at B = 1024, C = 2^20) only to reduce them, so N1 scores
// and reduces in one pass: for query b and bin j < M
//   out[b, j] = max over rows r = j + w M < C of s(b, r),
//   s(b, r) = <q_b, c_r>            (f32 or bf16 rows), or
//   s(b, r) = <q_b, q_r> * scale_r  (int8 rows with their f32 scale),
// rows r >= `valid` scoring -inf, the max in the select's int32 key order
// (ops/mips_topk.py f32_keys: -NaN below -inf, +NaN above +inf), a tie in
// key to the lowest row; rows[b, j] = the row that holds it.  Strided bins
// are the padded row axis seen as [W, M] and reduced over W, whose output
// size is XLA's (ops/approx_topk.py approx_bins).  Outputs [B, M] f32 and
// int32.  Two kernels compute it; ops/approx_topk.py:scan_route picks one.
//
// approx_scan_tc_kernel<ROWS> (f32, int8 or bf16 rows; D % 8 == 0, int8
// D % 16 == 0, D <= 128): on the tensor cores with wgmma (csrc/wgmma.cuh).
//  - Bound on the H100: operations.  Int8 and bf16 values are exact in TF32,
//    so with the query split into TF32 hi and lo (tt::tf32_split_any) a
//    score is q_lo . c + q_hi . c, two TF32 products whose terms are exact:
//    4 B C D flops (275 G at B = 1024, C = 2^20, D = 64: 0.555 ms at 495
//    TFLOP/s).  F32 rows take 3xTF32, q_lo . c_hi + q_hi . c_lo + q_hi .
//    c_hi (0.833 ms).  The corpus is read about once (256 MiB f32, 128 MiB
//    bf16, 64 MiB int8: 0.08 ms at most).
//  - A block takes 64 consecutive bins j0 .. j0 + 63 and 64 queries for each
//    of its NWG consumer warpgroups (2 from B = 65 on where shared memory
//    allows, so two query tiles share every row tile), split once into TF32
//    hi and lo tiles in wgmma's K-major layout, and walks the depths.
//  - Warp-specialised: CV = 2 converter warpgroups (setmaxnreg down to 56
//    registers) and the consumers (up to 200), handing tiles over through
//    mbarriers.  A converter thread brings depth w's rows w M + j0 .. + 63,
//    one contiguous span of the corpus, with one 1-D bulk copy
//    (cp.async.bulk completing on an mbarrier's transaction count; no
//    tensor map, so no driver API) into a ring of S raw stages, S depths
//    ahead; the converters then write the depth's rows into one of TB row
//    tiles in wgmma's layout (f32 split into hi and lo; int8 widened to f32;
//    bf16 widened, and a copy with its non-finite values zeroed for the lo
//    product, so that a query's q_lo = 0 meets no inf), TB - 1 depths ahead
//    of the products.  A diagonal walk over (row, 16-byte chunk) keeps those
//    16-byte reads and writes free of bank conflicts.
//  - A consumer warpgroup issues the depth's products (m64n64k8, the small
//    ones first: q_lo products before q_hi . c_hi) into a fresh
//    accumulator, straight-line code for each D / 8 (a loop around them
//    made ptxas serialise every wgmma), waits for them, releases the row
//    tile, and runs the epilogue: per score + 0.0f (times the row's scale
//    for int8), which turns -0 into +0 and any NaN into the canonical NaN,
//    as the plain version's f32 sums give them; its key; a strictly larger
//    key replaces the running (key, depth) pair, 32 scores and 64 registers
//    of pairs a thread.  Issuing blocks until the tensor cores take the
//    products, so the two consumers take turns (named barriers): one's
//    epilogue runs while the other's products fill the tensor cores.
//  - Its values are the tensor cores' sums, not B2's and B4's fmaf chain:
//    within 1e-5 of each query's scale of the plain version.  On integer
//    grids every product and sum is exact, and every instance is bit-equal
//    to the plain version, non-finite scores included.
//  - Grid: ceil(B / (64 NWG)) query blocks x ceil(M / 64) bin blocks, the
//    query block fastest, so the blocks that share rows start together and
//    the rows stream from HBM about once and from L2 for the others; one
//    block an SM (229,456 bytes of shared memory for f32 rows at D = 64).
//
// approx_scan_kernel<INT8> (f32 rows with D % 4 == 0, or int8 rows with
// D % 16 == 0; D <= 128): on the CUDA cores, the route for f32 rows whose
// D % 8 != 0.  Bound: 2 B C D f32 multiply-adds (2.05 ms at 67 TFLOP/s at
// the shape above).  Design: B2's register-blocked SIMT product
// (csrc/tile_max.cu) with a running max where B2 reduces a tile.
//  - A block takes 64 queries (d-major in shared memory, loaded once) and
//    64 consecutive bins j0 .. j0 + 63, and walks the depths w = 0 .. W-1:
//    the rows w M + j0 .. + 63, consecutive in memory, arrive by cp.async
//    into a two-stage ring while the previous depth is scored.  Int8 rows
//    arrive as bytes and are widened to f32 in shared memory once a depth
//    (exact), so both instances run the same product.
//  - A thread holds 8 queries x 4 bins: 32 accumulators and, for each, its
//    running (key, depth) pair across the walk: 96 registers of state, so
//    no reduction across threads.  Per four d-steps a thread reads its 8
//    queries as 8 LDS.128 (the 16 lanes of a query group read one address)
//    and its 4 rows as 4 LDS.128 at a stride whose float4 count is odd
//    (tt::padded), for 128 FFMA, each the chain fmaf(q[d], c[d], acc) in d
//    order (common.cuh: an f32 score is B2's and B4's bit for bit).
//  - The depth's epilogue: each of the thread's 32 scores (times the row's
//    scale for int8) to its key, -inf's key past `valid`; a strictly larger
//    key replaces the pair, so the lowest depth keeps a tie.  The pair
//    starts at (INT_MIN, depth 0): every bin has its depth-0 row (M <= C).
//  - Grid: as the tensor-core kernel's, with 64 queries a query block.

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

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

namespace {
namespace tc {

constexpr int NB = 64;   // bins a block: the wgmma's N
constexpr int QW = 64;   // queries a consumer warpgroup: the wgmma's M
constexpr int WG = 128;  // threads a warpgroup
constexpr int MAX_STAGES = 4;
constexpr int MAX_TILES = 3;  // row tiles in flight: the int8 scales keep MAX_TILES + 1 depths
constexpr size_t SMEM_LIMIT = 232448;  // a block's dynamic shared memory on the H100
constexpr int CV = 2;  // converter warpgroups
// registers a thread after setmaxnreg: two consumer warpgroups at 200 and
// the two converters at 56 fill the 128 x 512 a block launches with
constexpr int CONSUMER_REGS = 200, CONVERTER_REGS = 56;
enum { F32 = 0, I8 = 1, BF16 = 2 };    // ROWS

__host__ __device__ constexpr int elsize(int rows) { return rows == F32 ? 4 : rows == I8 ? 1 : 2; }
// row tiles a depth: c_hi and c_lo (f32), c and c with non-finite values
// zeroed (bf16), c (int8)
__host__ __device__ constexpr int parts(int rows) { return rows == I8 ? 1 : 2; }

// Dynamic shared memory, in this order: the query tiles ([NWG][hi, lo][64 D]
// floats), TB depths' row tiles ([TB][parts][64 D] floats), S raw stages of
// 64 rows, the int8 rows' scales of four depths, S + 2 MAX_TILES mbarriers.
__host__ __device__ constexpr size_t smem_bytes(int D, int rows, int nwg, int tiles, int stages) {
  return sizeof(float) * ((size_t)nwg * 2 * QW * D + (size_t)tiles * parts(rows) * NB * D) +
         (size_t)stages * NB * D * elsize(rows) + (rows == I8 ? 4 * NB * sizeof(float) : 0) +
         sizeof(uint64_t) * ((size_t)stages + 2 * MAX_TILES);
}

__device__ __forceinline__ void split4(const float4& v, float4& hi, float4& lo) {
  unsigned h, l;
  tt::tf32_split_any(v.x, h, l);
  hi.x = __uint_as_float(h), lo.x = __uint_as_float(l);
  tt::tf32_split_any(v.y, h, l);
  hi.y = __uint_as_float(h), lo.y = __uint_as_float(l);
  tt::tf32_split_any(v.z, h, l);
  hi.z = __uint_as_float(h), lo.z = __uint_as_float(l);
  tt::tf32_split_any(v.w, h, l);
  hi.w = __uint_as_float(h), lo.w = __uint_as_float(l);
}

__device__ __forceinline__ float finite_or_0(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u ? 0.0f : x;
}

// The products of one depth into a fresh accumulator, KS k8 steps each,
// the small ones first (q_lo . c_hi, then q_hi . c_lo for f32 rows), q_hi .
// c_hi last: descriptors of the query tiles (al, ah) and the row tile's
// parts (bh: c_hi or c; bl: c_lo, c with non-finite values zeroed, or c) at
// k8 step 0.  Straight-line code: a wgmma sequence inside a loop whose trip
// count is not known makes ptxas serialize every wgmma of the kernel.
template <int ROWS, int KS>
__device__ __forceinline__ void products(float (&acc)[32], uint64_t al, uint64_t ah, uint64_t bh,
                                         uint64_t bl) {
#pragma unroll
  for (int s = 0; s < KS; ++s)
    tt::wgmma_m64n64k8_tf32(acc, al + 16 * s, (ROWS == F32 ? bh : bl) + 16 * s, s > 0);
  if (ROWS == F32) {
#pragma unroll
    for (int s = 0; s < KS; ++s) tt::wgmma_m64n64k8_tf32(acc, ah + 16 * s, bl + 16 * s, 1);
  }
#pragma unroll
  for (int s = 0; s < KS; ++s) tt::wgmma_m64n64k8_tf32(acc, ah + 16 * s, bh + 16 * s, 1);
}

// products<ROWS, ks> for the run-time ks = D / 8 in 1 .. MAX_D / 8
template <int ROWS, int KS = 1>
__device__ __forceinline__ void products_ks(int ks, float (&acc)[32], uint64_t al, uint64_t ah,
                                            uint64_t bh, uint64_t bl) {
  if (ks == KS) {
    products<ROWS, KS>(acc, al, ah, bh, bl);
  } else if constexpr (KS < MAX_D / 8) {
    products_ks<ROWS, KS + 1>(ks, acc, al, ah, bh, bl);
  }
}

}  // namespace tc

template <int ROWS>
__global__ void __launch_bounds__((2 + tc::CV) * tc::WG, 1)
approx_scan_tc_kernel(const float* __restrict__ q, const void* __restrict__ c,
                      const float* __restrict__ scale, float* __restrict__ vals,
                      int* __restrict__ rows, int B, int C, int D, int M, int lim, int QB, int TB,
                      int S) {
  constexpr int NB = tc::NB, QW = tc::QW, WG = tc::WG;
  constexpr int F32 = tc::F32, I8 = tc::I8;
  constexpr int P = tc::parts(ROWS);
  constexpr int EB = tc::elsize(ROWS);
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int NT = blockDim.x;
  const int nwg = NT / WG - tc::CV;  // consumer warpgroups; the last CV warpgroups convert
  float* qa = reinterpret_cast<float*>(smem_tc);  // [nwg][hi, lo][QW * D]
  float* ct = qa + (size_t)nwg * 2 * QW * D;      // [TB][P][NB * D]
  unsigned char* raw = reinterpret_cast<unsigned char*>(ct + TB * P * NB * D);  // [S][NB * D * EB]
  const size_t stage_bytes = (size_t)NB * D * EB;
  float* sc = reinterpret_cast<float*>(raw + S * stage_bytes);  // [4][NB], int8 rows
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(sc + (ROWS == I8 ? 4 * NB : 0));  // [S]
  uint64_t* t_full = raw_full + S;             // [TB]: row tile b written (converter threads)
  uint64_t* t_empty = t_full + tc::MAX_TILES;  // [TB]: row tile b's products done (consumer warps)

  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int q0 = (blockIdx.x % QB) * nwg * QW;
  const int j0 = (blockIdx.x / QB) * NB;
  const int depths = (C - j0 + M - 1) / M;  // rows w M + j0 exist for w < depths
  const int kcs = D / 4;                    // 16-byte chunks a row

  if (tid == 0) {
    for (int s = 0; s < S; ++s) tt::mbar_init(raw_full + s, 1);
    for (int b = 0; b < TB; ++b) {
      tt::mbar_init(t_full + b, tc::CV * WG);
      tt::mbar_init(t_empty + b, 4 * nwg);
    }
    tt::mbar_init_fence();
  }
  // the block's queries, once: TF32 hi and lo tiles (zeros past B)
  for (int e = tid; e < nwg * QW * kcs; e += NT) {
    const int r = e / kcs, kc = e % kcs;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < B) v = __ldg(reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * D) + kc);
    float4 hi, lo;
    tc::split4(v, hi, lo);
    float* t = qa + (size_t)(r / QW) * 2 * QW * D + tt::tile_off(r % QW, kc, D);
    *reinterpret_cast<float4*>(t) = hi;
    *reinterpret_cast<float4*>(t + QW * D) = lo;
  }
  tt::fence_proxy_async();
  __syncthreads();  // barriers set up, query tiles visible to wgmma; the roles part here

  if (wg >= nwg) {
    // ---- the converter warpgroups: raw rows in, wgmma's row tiles out ----
    tt::set_max_regs_dec<tc::CONVERTER_REGS>();
    const int cid = tid - nwg * WG;
    // depth w's rows w M + j0 .. (bins < M, rows < C) into raw stage w % S
    auto issue = [&](int w) {
      const long long row0 = (long long)w * M + j0;
      const long long n = min((long long)NB, min((long long)(M - j0), (long long)C - row0));
      const unsigned bytes = (unsigned)(n * D * EB);
      tt::mbar_arrive_expect_tx(raw_full + w % S, bytes);
      tt::bulk_g2s(raw + (size_t)(w % S) * stage_bytes,
                   static_cast<const unsigned char*>(c) + row0 * D * EB, bytes, raw_full + w % S);
    };
    if (cid == 0)
      for (int w = 0; w < S && w < depths; ++w) issue(w);
    // Lane p of each group of 8 takes row 8 ((cid / 8) % 8) + p and chunks
    // (cid / 64 + 2 CV i + p) % kcs: the eight 16-byte reads of a phase hit
    // distinct bank groups (raw rows are D * EB bytes), and so do the eight
    // writes (core-matrix rows 16 bytes apart).  Rows past the copied span
    // hold an earlier depth's rows; their scores are never taken.
    const int cv_p = cid & 7, cv_r = ((cid >> 3) & 7) * 8 + cv_p;
    const int cv_off = (cv_r >> 3) * 8 * D + (cv_r & 7) * 4;  // tt::tile_off(cv_r, 0, D)
    for (int w = 0; w < depths; ++w) {
      const int b = w % TB, k = w / TB;  // row tile, and its use
      const long long srow = (long long)w * M + j0 + cid;
      const float sv = (ROWS == I8 && cid < NB && j0 + cid < M && srow < C) ? __ldg(scale + srow)
                                                                           : 0.0f;
      if (k > 0) tt::mbar_wait(t_empty + b, (unsigned)((k - 1) & 1));
      tt::mbar_wait(raw_full + w % S, (unsigned)((w / S) & 1));
      const unsigned char* src = raw + (size_t)(w % S) * stage_bytes + (size_t)cv_r * D * EB;
      float* dst = ct + (size_t)b * P * NB * D + cv_off;
#pragma unroll 2
      for (int base = cid >> 6; base < kcs; base += tc::CV * WG / 64) {
        int kc = base + cv_p;
        while (kc >= kcs) kc -= kcs;
        if (ROWS == F32) {
          const float4 v = *reinterpret_cast<const float4*>(src + 16 * kc);
          float4 hi, lo;
          tc::split4(v, hi, lo);
          *reinterpret_cast<float4*>(dst + 32 * kc) = hi;
          *reinterpret_cast<float4*>(dst + NB * D + 32 * kc) = lo;
        } else if (ROWS == I8) {  // exact in TF32
          const char4 v = *reinterpret_cast<const char4*>(src + 4 * kc);
          *reinterpret_cast<float4*>(dst + 32 * kc) =
              make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
        } else {  // bf16: the high half of an f32, exact in TF32
          const uint2 v = *reinterpret_cast<const uint2*>(src + 8 * kc);
          const float4 f =
              make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                          __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
          *reinterpret_cast<float4*>(dst + 32 * kc) = f;
          *reinterpret_cast<float4*>(dst + NB * D + 32 * kc) =
              make_float4(tc::finite_or_0(f.x), tc::finite_or_0(f.y), tc::finite_or_0(f.z),
                          tc::finite_or_0(f.w));
        }
      }
      if (ROWS == I8 && cid < NB) sc[(w & 3) * NB + cid] = sv;
      tt::fence_proxy_async();
      tt::named_bar_sync(1, tc::CV * WG);  // every converter thread is done with raw stage w % S
      if (cid == 0 && w + S < depths) issue(w + S);
      tt::mbar_arrive(t_full + b);
    }
    return;
  }

  // ---- a consumer warpgroup: 64 queries, the products and the running max ----
  tt::set_max_regs_inc<tc::CONSUMER_REGS>();
  // descriptors of k8 step 0: this warpgroup's query tiles and row tile 0;
  // a k8 step lies 256 bytes on (16 in the address field), each part of a
  // row tile, and each row tile's parts, a tile's bytes on
  const uint64_t d_ah = tt::kmajor_desc(qa + (size_t)wg * 2 * QW * D, D);
  const uint64_t d_al = d_ah + ((QW * D * 4) >> 4);
  const uint64_t d_c0 = tt::kmajor_desc(ct, D);
  const int tile16 = (NB * D * 4) >> 4;
  // depth w's products into a fresh accumulator (tc::products)
  auto products = [&](int w, float(&acc)[32]) {
    const uint64_t bh = d_c0 + (uint64_t)((w % TB) * P * tile16);
    const uint64_t bl = bh + (uint64_t)((P - 1) * tile16);
    tt::reg_fence(acc);
    tt::wgmma_fence();
    tc::products_ks<ROWS>(D / 8, acc, d_al, d_ah, bh, bl);
    tt::wgmma_commit();
  };

  // accumulator register 4 i + 2 h + e: query 16 wi + g + 8 h of the
  // warpgroup's 64, bin j0 + 8 i + 2 t + e
  const int lane = tid % 32, wi = (tid % WG) / 32;
  const int g = lane / 4, t4 = lane % 4;
  int best[32], depth[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    best[x] = INT_MIN;
    depth[x] = 0;
  }
  const int neg_inf = key_of(-INFINITY);

  // depth w's scores into the running (key, depth) pairs: + 0.0f (times
  // the row's scale for int8), the key, a strictly larger key replaces
  auto epilogue = [&](int w, const float(&acc)[32]) {
    const long long row0 = (long long)w * M + j0;
    const float* s_sc = sc + (w & 3) * NB;
    if (j0 + NB <= M && row0 + NB <= lim) {  // every bin has a valid row at this depth
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float f = ROWS == I8 ? s_sc[8 * i + 2 * t4 + e] : 1.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * i + 2 * h + e;
            const float s = ROWS == I8 ? (acc[x] + 0.0f) * f : acc[x] + 0.0f;
            const int key = key_of(s);
            if (key > best[x]) {
              best[x] = key;
              depth[x] = w;
            }
          }
        }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + 2 * t4 + e;
          const long long row = row0 + col;
          const bool in = j0 + col < M && row < C;
          const bool valid = row < lim;
          const float f = ROWS == I8 ? s_sc[col] : 1.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * i + 2 * h + e;
            const float s = ROWS == I8 ? (acc[x] + 0.0f) * f : acc[x] + 0.0f;
            const int key = valid ? key_of(s) : neg_inf;
            if (in && key > best[x]) {
              best[x] = key;
              depth[x] = w;
            }
          }
        }
    }
  };

  float acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.0f;
  for (int w = 0; w < depths; ++w) {
    const int b = w % TB;
    // the two warpgroups issue their products in turns (named barriers 2 and
    // 3), so one's epilogue runs while the other's products fill the
    // tensor cores
    if (nwg == 2) {
      if (wg == 1) tt::named_bar_sync(3, 2 * WG);
      else if (w > 0) tt::named_bar_sync(2, 2 * WG);
    }
    tt::mbar_wait(t_full + b, (unsigned)((w / TB) & 1));
    products(w, acc);
    if (nwg == 2) {
      if (wg == 0) tt::named_bar_arrive(3, 2 * WG);
      else if (w + 1 < depths) tt::named_bar_arrive(2, 2 * WG);
    }
    tt::wgmma_wait<0>();
    tt::reg_fence(acc);
    if (lane == 0) tt::mbar_arrive(t_empty + b);  // this warp's reads of row tile b are done
    epilogue(w, acc);
  }

  const int qrow = q0 + wg * QW + 16 * wi + g;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * i + 2 * h + e;
        const int b = qrow + 8 * h, bin = j0 + 8 * i + 2 * t4 + e;
        if (b < B && bin < M) {
          vals[(size_t)b * M + bin] = value_of(best[x]);
          rows[(size_t)b * M + bin] = depth[x] * M + bin;
        }
      }
}

template <int ROWS>
int launch_tc(const void* q, const void* c, const void* scale, void* vals, void* rows, int B,
              int C, int D, int M, int lim, int nwg, int tiles, int stages, size_t smem,
              cudaStream_t stream) {
  const int QB = (B + nwg * tc::QW - 1) / (nwg * tc::QW);
  const int NBB = (M + tc::NB - 1) / tc::NB;
  cudaError_t err = cudaFuncSetAttribute(approx_scan_tc_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  approx_scan_tc_kernel<ROWS><<<dim3((unsigned)(QB * NBB)), (nwg + tc::CV) * tc::WG, smem,
                                stream>>>(
      (const float*)q, c, (const float*)scale, (float*)vals, (int*)rows, B, C, D, M, lim, QB,
      tiles, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// N1 on the tensor cores.  q [B, D] f32; c [C, D] f32 (rows == 0), int8 with
// scale [C] f32 (rows == 1) or bf16 (rows == 2); vals [B, M] f32, rows
// [B, M] int32; rows >= valid score -inf.  nwg consumer warpgroups of 64
// queries a block, `tiles` row tiles and `stages` raw stages
// (ops/approx_topk.py:tc_plan).
// Needs 1 <= M <= C, D % 8 == 0 (int8: D % 16 == 0), D <= 128, the shared
// memory within the H100's block limit; c and q 16-byte aligned.
extern "C" int tt_approx_scan_tc(const void* q, const void* c, const void* scale, void* vals,
                                 void* rows, int B, int C, int D, int M, int valid, int kind,
                                 int nwg, int tiles, int stages, void* stream) {
  if (D < 8 || D > MAX_D || D % (kind == tc::I8 ? 16 : 8) != 0 || M < 1 || M > C || B < 1 ||
      kind < tc::F32 || kind > tc::BF16 || nwg < 1 || nwg > 2 || tiles < 2 ||
      tiles > tc::MAX_TILES || stages < 1 || stages > tc::MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc::smem_bytes(D, kind, nwg, tiles, stages);
  if (smem > tc::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int lim = valid < C ? valid : C;
  cudaStream_t st = (cudaStream_t)stream;
  auto launch = kind == tc::F32 ? launch_tc<tc::F32> : kind == tc::I8 ? launch_tc<tc::I8>
                                                                     : launch_tc<tc::BF16>;
  return launch(q, c, scale, vals, rows, B, C, D, M, lim, nwg, tiles, stages, smem, st);
}
