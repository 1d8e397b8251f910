// In-batch softmax cross-entropy over the score matrix S = U . I^T without
// ever storing S: the forward row logsumexp (with the diagonal positive)
// and the two backward products.
//
// Replaces two_tower_models_tpu/ops/pallas/fused_softmax.py:
//   ce_fwd_kernel   <- _fwd_kernel     (fused_in_batch_ce / fused_lse forward)
//   ce_bwd_kernel   <- _bwd_du_kernel  (dU_b = sum_j g_b p_bj i_j - g_b i_b)
//                   <- _bwd_di_kernel  (dI_j = sum_b g_b p_bj u_b - g_j u_j)
// with p_bj = exp(s_bj - lse_b); the diagonal terms only with_diag.
// U [B, D], I [C, D], lse and g [B]; all f32 (the two towers' outputs are
// f32 at every compute dtype), any D.
//
// Bound on the H100: operations.  At B = C = 4096, D = 64 the forward is
// 2.1 GFLOP of f32 FMA (0.032 ms at 67 TFLOP/s) against 2 MB of inputs;
// each backward does twice that.  Design: a block owns TR = 32 rows and
// walks over tiles of TC = 64 columns staged in shared memory (row stride
// D | 1, odd, so the 16 column rows a warp reads fall in 16 banks).  Each
// of the 256 threads holds a 2 x 4 register tile of scores
// (tt::dot_block).  The forward keeps a running (max, sum) per thread and
// row, starting from -1e30 as the Pallas kernel does, and merges the 16
// partials of a row with shuffles at the end; the diagonal score is taken
// from the same dot products.  The backward writes g * p for its tile to
// shared memory and accumulates it against the staged column rows, a 2 x 4
// register tile per thread again, into a [TR, D] f32 accumulator in shared
// memory; one kernel serves both dU
// (rows of U own the output) and dI (rows of I own it, lse and g indexed by
// the column).  Plain f32 FMA on the CUDA cores; tensor cores are later
// work.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RQ = 2, RC = 4;  // register tile per thread
constexpr int TR = 16 * RQ;    // rows a block owns
constexpr int TC = 16 * RC;    // columns per step
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int nrows, int n, int D, int SD) {
  for (int e = threadIdx.x; e < nrows * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    dst[r * SD + c] = (row0 + r < n) ? src[(size_t)(row0 + r) * D + c] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
ce_fwd_kernel(const float* __restrict__ U, const float* __restrict__ I,
              float* __restrict__ ce, float* __restrict__ lse, int B, int C,
              int D, int with_diag) {
  extern __shared__ float smem[];
  const int SD = D | 1;
  float* us = smem;            // [TR][SD]
  float* is = us + TR * SD;    // [TC][SD]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * TR;
  stage(us, U, r0, TR, B, D, SD);
  float m[RQ], l[RQ], dg[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) { m[i] = NEG_BIG; l[i] = 0.0f; dg[i] = 0.0f; }
  for (int c0 = 0; c0 < C; c0 += TC) {
    __syncthreads();  // readers of the previous column tile are done
    stage(is, I, c0, TC, C, D, SD);
    __syncthreads();
    float s[RQ][RC];
    tt::dot_block<RQ, RC>(s, us + ty * SD, 16 * SD, 1, is + tx * SD, 16 * SD, 1, D);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = r0 + ty + 16 * i;
      float tmax = NEG_BIG;
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < C) {
          tmax = fmaxf(tmax, s[i][j]);
          if (with_diag && col == row) dg[i] = s[i][j];
        }
      }
      const float mn = fmaxf(m[i], tmax);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < RC; ++j)
        if (c0 + tx + 16 * j < C) sum += expf(s[i][j] - mn);
      l[i] = l[i] * expf(m[i] - mn) + sum;
      m[i] = mn;
    }
  }
  // merge the 16 partials of each row (lanes tx = 0..15 of one half-warp)
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float mi = m[i], li = l[i], di = dg[i];
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mi, off);
      const float lo = __shfl_xor_sync(0xffffffffu, li, off);
      di += __shfl_xor_sync(0xffffffffu, di, off);
      const float mn = fmaxf(mi, mo);
      li = li * expf(mi - mn) + lo * expf(mo - mn);
      mi = mn;
    }
    const int row = r0 + ty + 16 * i;
    if (tx == 0 && row < B) {
      const float v = mi + logf(li);
      lse[row] = v;
      ce[row] = v - di;
    }
  }
}

// Rows of `own` [n_own, D] own the output rows; `other` [n_oth, D] is walked
// in tiles.  p = exp(own_r . other_c - lse[k]) * g[k], with k the U index:
// k = r for dU (lse_by_col = 0), k = c for dI (lse_by_col = 1).
__global__ void __launch_bounds__(THREADS)
ce_bwd_kernel(const float* __restrict__ own, const float* __restrict__ other,
              const float* __restrict__ lse, const float* __restrict__ g,
              float* __restrict__ out, int n_own, int n_oth, int D,
              int lse_by_col, int with_diag) {
  extern __shared__ float smem[];
  const int SD = D | 1;
  float* os = smem;             // [TR][SD]  own rows
  float* xs = os + TR * SD;     // [TC][SD]  a tile of other rows
  float* gp = xs + TC * SD;     // [TR][TC + 1]  g * p
  float* acc = gp + TR * (TC + 1);  // [TR][D]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * TR;
  stage(os, own, r0, TR, n_own, D, SD);
  for (int e = threadIdx.x; e < TR * D; e += THREADS) acc[e] = 0.0f;
  float row_lse[RQ], row_g[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = r0 + ty + 16 * i;
    const bool ok = !lse_by_col && row < n_own;
    row_lse[i] = ok ? lse[row] : 0.0f;
    row_g[i] = ok ? g[row] : 0.0f;
  }
  for (int c0 = 0; c0 < n_oth; c0 += TC) {
    __syncthreads();  // readers of the previous tile (xs, gp) are done
    stage(xs, other, c0, TC, n_oth, D, SD);
    __syncthreads();
    float s[RQ][RC];
    tt::dot_block<RQ, RC>(s, os + ty * SD, 16 * SD, 1, xs + tx * SD, 16 * SD, 1, D);
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int col = c0 + tx + 16 * j;
      const bool valid = col < n_oth;
      const float cl = (lse_by_col && valid) ? lse[col] : 0.0f;
      const float cg = (lse_by_col && valid) ? g[col] : 0.0f;
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        float p = 0.0f;
        if (valid) {
          p = lse_by_col ? expf(s[i][j] - cl) * cg
                         : expf(s[i][j] - row_lse[i]) * row_g[i];
        }
        gp[(ty + 16 * i) * (TC + 1) + tx + 16 * j] = p;
      }
    }
    __syncthreads();
    // acc[r][d] += sum_c gp[r][c] * other[c][d]: thread (ty, tx) owns rows
    // ty + 16 i and, in each 16 * RC wide chunk of D, columns tx + 16 k
    for (int d0 = 0; d0 < D; d0 += TC) {
      float part[RQ][RC];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int k = 0; k < RC; ++k) part[i][k] = 0.0f;
      for (int c = 0; c < TC; ++c) {
        float a[RQ], x[RC];
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = gp[(ty + 16 * i) * (TC + 1) + c];
#pragma unroll
        for (int k = 0; k < RC; ++k) {
          const int d = d0 + tx + 16 * k;
          x[k] = d < D ? xs[c * SD + d] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int k = 0; k < RC; ++k) part[i][k] = fmaf(a[i], x[k], part[i][k]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int k = 0; k < RC; ++k) {
          const int d = d0 + tx + 16 * k;
          if (d < D) acc[(ty + 16 * i) * D + d] += part[i][k];
        }
    }
  }
  __syncthreads();
  const int n_diag = min(n_own, n_oth);
  for (int e = threadIdx.x; e < TR * D; e += THREADS) {
    const int r = e / D, d = e - r * D;
    const int row = r0 + r;
    if (row >= n_own) continue;
    float a = acc[e];
    if (with_diag && row < n_diag) a -= g[row] * other[(size_t)row * D + d];
    out[(size_t)row * D + d] = a;
  }
}

size_t fwd_smem(int D) { return (size_t)(TR + TC) * (D | 1) * sizeof(float); }

size_t bwd_smem(int D) {
  return ((size_t)(TR + TC) * (D | 1) + (size_t)TR * (TC + 1) + (size_t)TR * D) *
         sizeof(float);
}

}  // namespace

extern "C" int tt_in_batch_ce_fwd(const void* u, const void* i, void* ce,
                                  void* lse, int B, int C, int D,
                                  int with_diag, void* stream) {
  if (B < 1 || C < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ce_fwd_kernel<<<(B + TR - 1) / TR, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)i, (float*)ce, (float*)lse, B, C, D,
      with_diag);
  return (int)cudaGetLastError();
}

// which = 0: dU [B, D] (own = U, other = I); which = 1: dI [C, D].
extern "C" int tt_in_batch_ce_bwd(const void* u, const void* i,
                                  const void* lse, const void* g, void* out,
                                  int B, int C, int D, int with_diag,
                                  int which, void* stream) {
  if (B < 1 || C < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      ce_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float* own = (const float*)(which ? i : u);
  const float* oth = (const float*)(which ? u : i);
  const int n_own = which ? C : B, n_oth = which ? B : C;
  ce_bwd_kernel<<<(n_own + TR - 1) / TR, THREADS, smem, (cudaStream_t)stream>>>(
      own, oth, (const float*)lse, (const float*)g, (float*)out, n_own, n_oth,
      D, which, with_diag);
  return (int)cudaGetLastError();
}
