// Tile-max scoring, the first pass of the exact MIPS pipeline.
//
// Replaces two_tower_models_tpu/ops/pallas/mips_topk.py:tile_max_scores
// (_tilemax_kernel): m[b, t] = max over the `tile` rows r of corpus tile t
// of <q_b, c_r>, rows >= valid (or >= C) giving -inf.  Output [B, NT] f32.
//
// Bound on the H100: operations.  2*B*C*D f32 multiply-adds (137 GFLOP at
// B=1024, C=2^20, D=64) on the CUDA cores; TF32 would change results and the
// scores must equal gather_rescore's bit for bit (common.cuh), so the tensor
// cores are not used.  Design: a block holds TQ=128 queries in shared memory
// and walks TPB corpus tiles; each thread keeps an 8x8 register tile of
// (query, row) accumulators, so every shared-memory load feeds 8 FMAs.
// The [B, C] score matrix never leaves registers: each tile is reduced to
// its max at once.  The corpus is read B/TQ times, mostly from L2.

#include "common.cuh"

namespace {

constexpr int TILE = 128;  // corpus rows per tile (the only tile size taken)
constexpr int TQ = 128;    // queries per block
constexpr int RQ = 8;      // queries per thread
constexpr int RC = 8;      // rows per thread
constexpr int THREADS = 256;  // 16 query groups x 16 row groups
constexpr int TPB = 8;     // corpus tiles per block
constexpr int CS = TILE + 1;  // padded row stride of the transposed tile

// The monotone int32 key of an f32 (f32_keys of ops/mips_topk.py) and back.
__device__ __forceinline__ int key_of(float x) {
  int b = __float_as_int(x);
  return b < 0 ? (b ^ 0x7fffffff) : b;
}
__device__ __forceinline__ float value_of(int k) {
  return __int_as_float(k < 0 ? (k ^ 0x7fffffff) : k);
}

__global__ void __launch_bounds__(THREADS)
tile_max_kernel(const float* __restrict__ q, const float* __restrict__ c,
                float* __restrict__ m, int B, int C, int D, int valid, int NT) {
  extern __shared__ float smem[];
  float* qs = smem;           // [D][TQ]
  float* cs = smem + D * TQ;  // [D][CS]
  const int tid = threadIdx.x;
  const int tr = tid % 16;  // row group: rows tr + 16*j
  const int tq = tid / 16;  // query group: queries tq*RQ + i
  const int q0 = blockIdx.y * TQ;
  const int lim = valid < C ? valid : C;

  for (int e = tid; e < TQ * D; e += THREADS) {
    int qi = e / D, d = e % D;
    qs[d * TQ + qi] = (q0 + qi < B) ? q[(size_t)(q0 + qi) * D + d] : 0.0f;
  }

  const int t_begin = blockIdx.x * TPB;
  const int t_end = min(t_begin + TPB, NT);
  const int d4 = D / 4;
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();  // previous tile's readers are done
    const size_t row0 = (size_t)t * TILE;
    for (int e = tid; e < TILE * d4; e += THREADS) {
      int r = e / d4, c4 = e % d4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < (size_t)C)
        v = reinterpret_cast<const float4*>(c + (row0 + r) * D)[c4];
      cs[(c4 * 4 + 0) * CS + r] = v.x;
      cs[(c4 * 4 + 1) * CS + r] = v.y;
      cs[(c4 * 4 + 2) * CS + r] = v.z;
      cs[(c4 * 4 + 3) * CS + r] = v.w;
    }
    __syncthreads();

    float acc[RQ][RC];
    tt::dot_block<RQ, RC>(acc, qs + tq * RQ, 1, TQ, cs + tr, 16, CS, D);

    // max in the select's total order (the int32 key of f32_keys, not
    // clamped, so the max maps back to its own bits): -NaN below -inf,
    // +NaN above +inf, as the plain version takes it.  A tile's key is then
    // at least every row's key, whatever the scores hold.
    int best[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      best[i] = key_of(-INFINITY);
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        long long row = (long long)row0 + tr + 16 * j;
        if (row < lim) best[i] = max(best[i], key_of(acc[i][j]));
      }
      // the 16 row groups of one query group are 16 consecutive lanes
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        best[i] = max(best[i], __shfl_xor_sync(0xffffffffu, best[i], off));
    }
    if (tr == 0) {
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        int b = q0 + tq * RQ + i;
        if (b < B) m[(size_t)b * NT + t] = value_of(best[i]);
      }
    }
  }
}

}  // namespace

extern "C" int tt_tile_max_scores(const void* q, const void* c, void* m, int B,
                                  int C, int D, int valid, int tile,
                                  void* stream) {
  if (tile != TILE || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const int NT = (C + TILE - 1) / TILE;
  const size_t smem = (size_t)D * (TQ + CS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((NT + TPB - 1) / TPB, (B + TQ - 1) / TQ);
  tile_max_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)c, (float*)m, B, C, D, valid, NT);
  return (int)cudaGetLastError();
}
