// Tile-max scoring, the first pass of the exact MIPS pipeline.
//
// Replaces two_tower_models_tpu/ops/pallas/mips_topk.py:tile_max_scores
// (_tilemax_kernel): m[b, t] = max over the `tile` rows r of corpus tile t
// of <q_b, c_r>, in the select's int32 key order, rows >= valid (or >= C)
// giving -inf.  Output [B, NT] f32.
//
// Bound on the H100: operations.  2*B*C*D f32 multiply-adds (137 GFLOP at
// B=1024, C=2^20, D=64, 2.05 ms at 67 TFLOP/s) on the CUDA cores; TF32
// would change results and the scores must equal gather_rescore's bit for
// bit (common.cuh), so the tensor cores are not used.
//
// Design: a register-blocked SIMT product.  What bounds such a product on
// this card is feeding the FMA pipes: an SM issues four FFMA warp
// instructions a clock but moves 128 bytes a clock out of shared memory,
// and an LDS.128 of distinct 16-byte pieces costs four of those clocks.
//  - A thread holds 16 queries x 8 rows of accumulators (255 registers,
//    no spills).  Per d-step it reads its 16 queries as four LDS.128 from a
//    d-major copy (the 16 lanes of a query group read one address) and,
//    per four d-steps, its 8 rows as eight LDS.128 from row-major rows at a
//    stride whose float4 count is odd (tt::padded), so the rows a
//    quarter-warp reads fall in distinct bank groups: 24 LDS.128 for 512
//    FFMA, where the scalar design took 64 LDS.32 for 256.  Every element
//    keeps the chain fmaf(q[d], c[d], acc) in d order (common.cuh).
//  - A block (four warps, 128 queries) loads its queries once and walks a
//    run of corpus tiles; each tile (or 64-float slice of a tile, for
//    D > 64) arrives by cp.async into a two-stage ring while the previous
//    one is scored, with no transposing store.  Two blocks an SM where the
//    shared memory allows (D <= 88), so one block's barrier and epilogue
//    overlap the other's products.
//  - Persistent grid: runs x query blocks, the query block fastest, sized
//    by the launch plan (ops/mips_topk.py:_tile_max_plan) to the blocks
//    the card holds at once.  The query blocks that share a run start
//    together and walk it in step, so the corpus streams from HBM about
//    once and the others read it from L2.
//  - Epilogue: each tile's max in key order over rows < min(valid, C):
//    the numeric max (max.NaN) where it equals the key max, the key max
//    where a score is NaN, the max is a zero or the tile is cut by
//    `valid`; a transposed butterfly over the 16 lanes that share a query
//    (15 shuffles for 16 maxes), one store per (query, tile) from each
//    lane.  The [B, C] scores never leave registers.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int TILE = 128;     // corpus rows per tile (the only tile size taken)
constexpr int RQ = 16;        // queries per thread: tq * RQ + i
constexpr int RC = 8;         // rows per thread: tr + 16 j
constexpr int THREADS = 128;  // 8 query groups x 16 row groups
constexpr int TQ = RQ * THREADS / 16;  // queries per block
constexpr int DK = 64;        // floats of a row one ring stage holds

// TQ queries of D floats, d-major, and a two-stage ring of 128 rows of
// min(D, DK) floats.
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * TQ + 2 * (size_t)TILE * tt::padded(D < DK ? D : DK));
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

// One step of a transposed butterfly over the lanes `off` apart: a lane
// keeps the upper half of its N values where its `off` bit is set, the
// lower half elsewhere, each the max with its partner's copy.  After the
// steps at 8, 4, 2, 1 lane tr holds value tr of the 16.
template <int N>
__device__ __forceinline__ void halve(int (&v)[RQ], bool upper, int off) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int keep = upper ? v[i + N / 2] : v[i];
    const int send = upper ? v[i] : v[i + N / 2];
    v[i] = max(keep, __shfl_xor_sync(0xffffffffu, send, off));
  }
}

__global__ void __launch_bounds__(THREADS, 2)
tile_max_kernel(const float* __restrict__ q, const float* __restrict__ c,
                float* __restrict__ m, int B, int C, int D, int lim, int NT, int QB,
                int runs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int SC = tt::padded(D < DK ? D : DK);
  float* qs = smem;           // [D][TQ]
  float* cs = smem + D * TQ;  // [2][TILE][SC]
  const int tid = threadIdx.x;
  const int tr = tid % 16;  // row group: rows tr + 16 j
  const int tq = tid / 16;  // query group: queries tq * RQ + i
  const int q0 = (blockIdx.x % QB) * TQ;
  const int run = blockIdx.x / QB;
  const int t_begin = (int)((long long)run * NT / runs);
  const int t_end = (int)((long long)(run + 1) * NT / runs);
  const int nch = (D + DK - 1) / DK;  // d-slices of a tile
  const int n_items = (t_end - t_begin) * nch;
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

  // item `it` is d-slice it % nch of tile t_begin + it / nch, copied by
  // lane pairs, a row each; rows past C land as zeros (the epilogue skips
  // them)
  auto load = [&](int it) {
    const int ch = it % nch;
    const int k4 = min(DK, D - ch * DK) / 4;
    const long long row0 = (long long)(t_begin + it / nch) * TILE;
    float* dst = cs + (it & 1) * TILE * SC;
    for (int r = tid / 2; r < TILE; r += THREADS / 2) {
      const bool in = row0 + r < C;
      const float* src = in ? c + (size_t)(row0 + r) * D + ch * DK : c;
      for (int c4 = tid % 2; c4 < k4; c4 += 2)
        tt::cp_async16(dst + r * SC + c4 * 4, in ? src + c4 * 4 : c, in ? 16 : 0);
    }
    tt::cp_commit();
  };

  if (n_items > 0) load(0);
  float acc[RQ][RC];
  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) {  // the next item streams in while this one is scored
      load(it + 1);
      tt::cp_wait<1>();
    } else {
      tt::cp_wait<0>();
    }
    __syncthreads();  // item `it` (and, at it == 0, the queries) visible to all
    const int ch = it % nch;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RC; ++j) acc[i][j] = 0.0f;
    }
    const int k4 = min(DK, D - ch * DK) / 4;
    const float* cst = cs + (it & 1) * TILE * SC + tr * SC;
    const float* qst = qs + ch * DK * TQ + tq * RQ;
#pragma unroll 1
    for (int u = 0; u < k4; ++u) {
      float4 cv[RC];  // rows tr + 16 j at d = 4u .. 4u + 3 of the slice
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

    if (ch == nch - 1) {
      // max in the select's total order (the int32 key of f32_keys, not
      // clamped, so the max maps back to its own bits): -NaN below -inf,
      // +NaN above +inf, as the plain version takes it.  A tile's key is
      // then at least every row's key, whatever the scores hold.
      const int t = t_begin + it / nch;
      const long long row0 = (long long)t * TILE;
      const bool full = row0 + TILE <= lim;
      int best[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        // fast path: the numeric max, which is the key max unless a score
        // is NaN (max.NaN gives a NaN then) or the max is a zero (-0 < +0)
        float mf = acc[i][0];
#pragma unroll
        for (int j = 1; j < RC; ++j) mf = tt::max_nan(mf, acc[i][j]);
        best[i] = key_of(mf);
        if (!full || mf != mf || mf == 0.0f) {
          best[i] = key_of(-INFINITY);
#pragma unroll
          for (int j = 0; j < RC; ++j)
            if (full || row0 + tr + 16 * j < lim) best[i] = max(best[i], key_of(acc[i][j]));
        }
      }
      // the 16 row groups of one query group are 16 consecutive lanes
      halve<16>(best, tr & 8, 8);
      halve<8>(best, tr & 4, 4);
      halve<4>(best, tr & 2, 2);
      halve<2>(best, tr & 1, 1);
      const int b = q0 + tq * RQ + tr;
      if (b < B) m[(size_t)b * NT + t] = value_of(best[0]);
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
}

}  // namespace

// `runs`: the corpus runs of the launch plan (ops/mips_topk.py:_tile_max_plan);
// the grid is runs x ceil(B / TQ) blocks.
extern "C" int tt_tile_max_scores(const void* q, const void* c, void* m, int B,
                                  int C, int D, int valid, int tile, int runs,
                                  void* stream) {
  if (tile != TILE || D % 4 != 0 || D <= 0 || D > 200 || runs < 1)
    return (int)cudaErrorInvalidValue;
  const int NT = (C + TILE - 1) / TILE;
  const int QB = (B + TQ - 1) / TQ;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      tile_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tile_max_kernel<<<runs * QB, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)c, (float*)m, B, C, D, valid, NT, QB, runs);
  return (int)cudaGetLastError();
}
