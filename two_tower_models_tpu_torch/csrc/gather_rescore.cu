// Candidate gather-rescore, the third pass of the exact MIPS pipeline.
//
// Replaces two_tower_models_tpu/ops/pallas/mips_topk.py:gather_rescore
// (_gather_rescore_kernel): cand[b, j*TILE + r] = <q_b, c[tile_idx[b, j]*TILE + r]>
// in f32.  Rows past the corpus end score as zero rows; the caller masks
// rows >= valid_count.
//
// Bound on the H100: memory.  Up to B*k*TILE*D*4 bytes of gathered rows
// (3.4 GB at B=1024, k=100, D=64) if nothing were shared, and the
// [B, k*TILE] f32 output; queries of one batch pick overlapping tiles, so
// much of the gather hits L2.  Design: one block per query, one thread per
// tile row.  A selected tile is one contiguous TILE*D*4-byte run, loaded
// with coalesced 16-byte loads into shared memory (row stride D+1, so the
// per-row reads below hit distinct banks); each thread then scores its row
// through the same dot routine as tile_max_scores (common.cuh).

#include "common.cuh"

namespace {

constexpr int TILE = 128;

__global__ void __launch_bounds__(TILE)
gather_rescore_kernel(const float* __restrict__ q, const float* __restrict__ c,
                      const int* __restrict__ tile_idx, float* __restrict__ out,
                      int C, int D, int k) {
  extern __shared__ float smem[];
  float* qs = smem;      // [D]
  float* cs = smem + D;  // [TILE][D + 1]
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const int stride = D + 1;
  const int d4 = D / 4;
  for (int d = r; d < D; d += TILE) qs[d] = q[(size_t)b * D + d];
  for (int j = 0; j < k; ++j) {
    const size_t row0 = (size_t)tile_idx[(size_t)b * k + j] * TILE;
    __syncthreads();  // previous tile's readers are done (and qs is loaded)
    for (int e = r; e < TILE * d4; e += TILE) {
      int rr = e / d4, c4 = e % d4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + rr < (size_t)C)
        v = reinterpret_cast<const float4*>(c + (row0 + rr) * D)[c4];
      float* dst = cs + rr * stride + c4 * 4;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    __syncthreads();
    float acc[1][1];
    tt::dot_block<1, 1>(acc, qs, 0, 1, cs + r * stride, 0, 1, D);
    out[(size_t)b * k * TILE + (size_t)j * TILE + r] = acc[0][0];
  }
}

}  // namespace

extern "C" int tt_gather_rescore(const void* q, const void* c,
                                 const void* tile_idx, void* out, int B, int C,
                                 int D, int k, int tile, void* stream) {
  if (tile != TILE || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(D + TILE * (D + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gather_rescore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gather_rescore_kernel<<<B, TILE, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)c, (const int*)tile_idx, (float*)out, C,
      D, k);
  return (int)cudaGetLastError();
}
