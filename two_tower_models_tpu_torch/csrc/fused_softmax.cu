// In-batch softmax cross-entropy over the score matrix S = U . I^T without
// ever storing S: the forward row logsumexp (with the diagonal positive)
// and one backward pass that writes both gradients.
//
// Replaces two_tower_models_tpu/ops/pallas/fused_softmax.py:
//   ce_fwd_kernel   <- _fwd_kernel     (fused_in_batch_ce / fused_lse forward)
//   ce_bwd_kernel   <- _bwd_du_kernel  (dU_b = sum_j g_b p_bj i_j - g_b i_b)
//   + ce_bwd_reduce <- _bwd_di_kernel  (dI_j = sum_b g_b p_bj u_b - g_j u_j)
// with p_bj = exp(s_bj - lse_b); the diagonal terms only with_diag.
// U [B, D], I [C, D], lse and g [B]; all f32 (the two towers' outputs are
// f32 at every compute dtype), any D.
//
// Bound on the H100: operations.  At B = C = 4096, D = 64 the forward is
// 2.1 GFLOP of f32 FMA (0.032 ms at 67 TFLOP/s) against 2 MB of inputs;
// the backward 6.4 GFLOP (0.096 ms): S once, then (g p) . I and (g p)^T . U.
//
// Forward design: a block owns TR = 32 rows and walks over tiles of TC = 64
// columns staged in shared memory (row stride D | 1, odd, so the 16 column
// rows a warp reads fall in 16 banks).  Each of the 256 threads holds a
// 2 x 4 register tile of scores (tt::dot_block).  It keeps a running (max,
// sum) per thread and row, starting from -1e30 as the Pallas kernel does,
// and merges the 16 partials of a row with shuffles at the end; the
// diagonal score is taken from the same dot products.
//
// Backward design (ce_bwd_kernel, then ce_bwd_reduce): the grid is G_r x G_c
// blocks of 128 threads, two per SM (ops/fused_softmax.py:bwd_plan sizes it
// from the SM count); block (rb, cb) owns a rectangle of 128-row tiles of U
// and 64-column tiles of I and computes each tile pair's S once.  Its g p
// tile feeds both products: dU for the current row tile accumulates in
// registers across the column walk and is written once to the workspace
// slice cb, dI's partial for the column tile is added to slice rb (written
// on the block's first row tile, read and added by the same thread on the
// next).  ce_bwd_reduce sums the slices in slice order and subtracts the
// diagonal term: no atomics, the same bits on every run.  Each thread owns
// an 8 x 8 register tile of S (rows ty + 16 i, columns tx + 8 j) and of its
// dU rows (the same rows, d in two float4 groups), 4 x 8 of a dI tile; all
// operands are 16-byte shared loads, 4 FMAs per float loaded.  Row strides
// of 68 (U, I) and 72 floats (g p) keep the eight rows a quarter-warp reads
// in distinct banks.  The next column tile of I is staged with cp.async
// into the second buffer while the current one is computed.  g p goes
// through shared memory once: a row of it is spread over eight lanes, and
// the transposed product reads it by column.  A padded row or column is
// selected out of p (never multiplied by zero: exp(0 - lse) may be inf).
// D > 64 runs one grid slice per 64-wide chunk of the output's d
// (blockIdx.z), each recomputing S over all of D in 64-wide staged chunks.
// Plain f32 FMA on the CUDA cores; 3xTF32 on the tensor cores is later work.

#include "common.cuh"
#include "mma.cuh"

#include <algorithm>

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

// ---- backward: one pass over the tile pairs, then the reduce ----

namespace bwd {

constexpr int NT = 128;      // threads: tx = tid % 8, ty = tid / 8
constexpr int BM = 128;      // rows of U in a tile
constexpr int BN = 64;       // rows of I (columns of S) in a tile
constexpr int KC = 64;       // d staged at once, and d of one output slice
constexpr int SD = KC + 4;   // U, I row stride: 17 float4s
constexpr int SP = BN + 8;   // g p row stride
constexpr int SMEM_FLOATS = BM * SD + 2 * BN * SD + BM * SP + 2 * BM;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

// Rows row0 .. row0 + NROWS - 1 of src [n, D], d in [d0, d0 + KC), into
// dst [NROWS][SD] with cp.async; rows past n and d past D are zero-filled.
// vec: D % 4 == 0 and src 16-byte aligned, so a float4 is all in or all out.
template <int NROWS>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0, int n,
                                      int D, int d0, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < NROWS * (KC / 4); e += NT) {
      const int r = e / (KC / 4), q = (e % (KC / 4)) * 4;
      const int row = row0 + r, d = d0 + q;
      const bool ok = row < n && d < D;
      tt::cp_async16(dst + r * SD + q, ok ? src + (size_t)row * D + d : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < NROWS * KC; e += NT) {
      const int r = e / KC, q = e % KC;
      const int row = row0 + r, d = d0 + q;
      const bool ok = row < n && d < D;
      cp_async4(dst + r * SD + q, ok ? src + (size_t)row * D + d : src, ok ? 4 : 0);
    }
  }
}

// s[i][j] += us[ty + 16 i][:nd] . is[tx + 8 j][:nd]
__device__ __forceinline__ void scores(float (&s)[8][8], const float* us, const float* is,
                                       int tx, int ty, int nd) {
  for (int d = 0; d < nd; d += 4) {
    float4 b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = *(const float4*)&is[(tx + 8 * j) * SD + d];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = *(const float4*)&us[(ty + 16 * i) * SD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
      }
    }
  }
}

// acc[0..3] += a * lo, acc[4..7] += a * hi
__device__ __forceinline__ void fma8(float (&acc)[8], float a, float4 lo, float4 hi) {
  acc[0] = fmaf(a, lo.x, acc[0]); acc[1] = fmaf(a, lo.y, acc[1]);
  acc[2] = fmaf(a, lo.z, acc[2]); acc[3] = fmaf(a, lo.w, acc[3]);
  acc[4] = fmaf(a, hi.x, acc[4]); acc[5] = fmaf(a, hi.y, acc[5]);
  acc[6] = fmaf(a, hi.z, acc[6]); acc[7] = fmaf(a, hi.w, acc[7]);
}

// row[d .. d+3] and row[d+32 .. d+35] (those below D) = v, or += v with add
__device__ __forceinline__ void store8(float* row, int d, const float (&v)[8], int D,
                                       bool vec, bool add) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int dh = d + 32 * h;
    const float* w = v + 4 * h;
    if (vec) {
      if (dh < D) {
        float4 o = make_float4(w[0], w[1], w[2], w[3]);
        if (add) {
          const float4 a = *(const float4*)&row[dh];
          o = make_float4(a.x + o.x, a.y + o.y, a.z + o.z, a.w + o.w);
        }
        *(float4*)&row[dh] = o;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (dh + q < D) row[dh + q] = add ? row[dh + q] + w[q] : w[q];
    }
  }
}

// Block (rb, cb, z) walks the row tiles rt0..rt1-1 of its row group and,
// for each, the column tiles ct0..ct1-1 of its column group (even splits of
// the cdiv(B, BM) and cdiv(C, BN) tiles over G_r and G_c).  It writes dU's
// partial sum over its columns to ws_du[cb] and adds dI's partial sum over
// its rows into ws_di[rb], both for d in [z KC, z KC + KC).  A null
// workspace skips that gradient.
__global__ void __launch_bounds__(NT, 2)
ce_bwd_kernel(const float* __restrict__ U, const float* __restrict__ I,
              const float* __restrict__ lse, const float* __restrict__ g,
              float* __restrict__ ws_du, float* __restrict__ ws_di, int B, int C,
              int D, int G_r, int G_c, int vec) {
  extern __shared__ float4 bsm[];  // float4: 16-byte aligned
  float* us = (float*)bsm;       // [BM][SD]  a row tile of U
  float* is = us + BM * SD;      // 2 x [BN][SD]  column tiles of I
  float* ps = is + 2 * BN * SD;  // [BM][SP]  g p
  float* ls = ps + BM * SP;      // [BM] lse of the row tile
  float* gs = ls + BM;           // [BM] g of the row tile
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int rb = blockIdx.x, cb = blockIdx.y, z = blockIdx.z, dz = z * KC + tx * 4;
  const int n_rt = (B + BM - 1) / BM, n_ct = (C + BN - 1) / BN, nkc = (D + KC - 1) / KC;
  const int rt0 = rb * n_rt / G_r, rt1 = (rb + 1) * n_rt / G_r;
  const int ct0 = cb * n_ct / G_c, ct1 = (cb + 1) * n_ct / G_c;
  const bool want_du = ws_du != nullptr, want_di = ws_di != nullptr;
  for (int rt = rt0; rt < rt1; ++rt) {
    const int r0 = rt * BM;
    __syncthreads();  // the previous row tile's readers are done
    for (int e = threadIdx.x; e < BM; e += NT) {
      const bool ok = r0 + e < B;
      ls[e] = ok ? lse[r0 + e] : 0.0f;
      gs[e] = ok ? g[r0 + e] : 0.0f;
    }
    if (nkc == 1) {
      stage<BM>(us, U, r0, B, D, 0, vec);
      stage<BN>(is, I, ct0 * BN, C, D, 0, vec);
      tt::cp_commit();
    }
    float acc_u[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc_u[i][k] = 0.0f;
    for (int ct = ct0; ct < ct1; ++ct) {
      const int c0 = ct * BN, buf = (ct - ct0) & 1;
      float* ib = is + buf * BN * SD;
      float s[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
      if (nkc == 1) {
        if (ct + 1 < ct1) {  // stage the next column tile while this one is computed
          stage<BN>(is + (buf ^ 1) * BN * SD, I, c0 + BN, C, D, 0, vec);
          tt::cp_commit();
          tt::cp_wait<1>();
        } else {
          tt::cp_wait<0>();
        }
        __syncthreads();
        scores(s, us, ib, tx, ty, (min(D, KC) + 3) & ~3);
      } else {
        for (int k = 1; k <= nkc; ++k) {
          const int kc = (z + k) % nkc;  // chunk z last: it stays staged for the products
          __syncthreads();
          stage<BM>(us, U, r0, B, D, kc * KC, vec);
          stage<BN>(ib, I, c0, C, D, kc * KC, vec);
          tt::cp_commit();
          tt::cp_wait<0>();
          __syncthreads();
          scores(s, us, ib, tx, ty, (min(D - kc * KC, KC) + 3) & ~3);
        }
      }
      // g p, selected to 0 outside [B, C] (an exp of a padded score may be inf)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = ty + 16 * i;
        const bool row_ok = r0 + m < B;
        const float l = ls[m], gm = gs[m];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 8 * j;
          ps[m * SP + n] = (row_ok && c0 + n < C) ? expf(s[i][j] - l) * gm : 0.0f;
        }
      }
      __syncthreads();
      if (want_du) {  // acc_u[i][:] += g p[ty + 16 i][:] . I tile
        for (int n = 0; n < BN; n += 4) {
          float4 lo[4], hi[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            lo[q] = *(const float4*)&ib[(n + q) * SD + tx * 4];
            hi[q] = *(const float4*)&ib[(n + q) * SD + 32 + tx * 4];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 p = *(const float4*)&ps[(ty + 16 * i) * SP + n];
            fma8(acc_u[i], p.x, lo[0], hi[0]);
            fma8(acc_u[i], p.y, lo[1], hi[1]);
            fma8(acc_u[i], p.z, lo[2], hi[2]);
            fma8(acc_u[i], p.w, lo[3], hi[3]);
          }
        }
      }
      if (want_di) {  // this tile pair's dI rows ty*4 .. ty*4+3 = (g p)^T . U tile
        float acc_i[4][8];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc_i[j][k] = 0.0f;
#pragma unroll 4
        for (int m = 0; m < BM; ++m) {
          const float4 p = *(const float4*)&ps[m * SP + ty * 4];
          const float4 lo = *(const float4*)&us[m * SD + tx * 4];
          const float4 hi = *(const float4*)&us[m * SD + 32 + tx * 4];
          fma8(acc_i[0], p.x, lo, hi);
          fma8(acc_i[1], p.y, lo, hi);
          fma8(acc_i[2], p.z, lo, hi);
          fma8(acc_i[3], p.w, lo, hi);
        }
        float* w = ws_di + (size_t)rb * C * D;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + ty * 4 + j;
          if (col < C) store8(w + (size_t)col * D, dz, acc_i[j], D, vec, rt != rt0);
        }
      }
      __syncthreads();  // readers of ps and of this I buffer are done
    }
    if (want_du) {
      float* w = ws_du + (size_t)cb * B * D;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = r0 + ty + 16 * i;
        if (row < B) store8(w + (size_t)row * D, dz, acc_u[i], D, vec, false);
      }
    }
  }
}

// du = sum_k ws_du[k] (k < G_c) - g_b i_b, di = sum_k ws_di[k] (k < G_r) -
// g_j u_j, in slice order; the diagonal terms with_diag only.
__global__ void ce_bwd_reduce(const float* __restrict__ ws_du, const float* __restrict__ ws_di,
                              const float* __restrict__ U, const float* __restrict__ I,
                              const float* __restrict__ g, float* __restrict__ du,
                              float* __restrict__ di, int B, int C, int D, int G_r,
                              int G_c, int with_diag) {
  const size_t nu = du ? (size_t)B * D : 0, ni = di ? (size_t)C * D : 0;
  const int n_diag = with_diag ? min(B, C) : 0;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < nu + ni;
       e += (size_t)gridDim.x * blockDim.x) {
    const bool is_u = e < nu;
    const size_t f = is_u ? e : e - nu, n = is_u ? nu : ni;
    const float* ws = is_u ? ws_du : ws_di;
    const int G = is_u ? G_c : G_r;
    float a = 0.0f;
    for (int k = 0; k < G; ++k) a += ws[(size_t)k * n + f];
    const int r = (int)(f / D);
    if (r < n_diag) a -= __fmul_rn(g[r], is_u ? I[f] : U[f]);
    (is_u ? du : di)[f] = a;
  }
}

}  // namespace bwd

size_t fwd_smem(int D) { return (size_t)(TR + TC) * (D | 1) * sizeof(float); }

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

// The backward's pass over the tile pairs on a G_r x G_c grid (x cdiv(D, 64)
// output slices): ws_du [G_c, B, D] and ws_di [G_r, C, D] take the partial
// sums; a null one skips that gradient.  ops/fused_softmax.py:bwd_plan
// chooses G_r <= cdiv(B, 128) and G_c <= cdiv(C, 64).
extern "C" int tt_in_batch_ce_bwd(const void* u, const void* i, const void* lse,
                                  const void* g, void* ws_du, void* ws_di, int B,
                                  int C, int D, int G_r, int G_c, void* stream) {
  using namespace bwd;
  if (B < 1 || C < 1 || D < 1 || G_r < 1 || G_c < 1 || G_r > (B + BM - 1) / BM ||
      G_c > (C + BN - 1) / BN || (!ws_du && !ws_di))
    return (int)cudaErrorInvalidValue;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ce_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 4 == 0 && ((size_t)u % 16 | (size_t)i % 16) == 0;
  const dim3 grid(G_r, G_c, (D + KC - 1) / KC);
  ce_bwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)i, (const float*)lse, (const float*)g,
      (float*)ws_du, (float*)ws_di, B, C, D, G_r, G_c, vec);
  return (int)cudaGetLastError();
}

// dU [B, D] from ws_du and dI [C, D] from ws_di (a null output is skipped).
extern "C" int tt_in_batch_ce_bwd_reduce(const void* ws_du, const void* ws_di,
                                         const void* u, const void* i, const void* g,
                                         void* du, void* di, int B, int C, int D,
                                         int G_r, int G_c, int with_diag, void* stream) {
  if (B < 1 || C < 1 || D < 1 || (du && !ws_du) || (di && !ws_di))
    return (int)cudaErrorInvalidValue;
  const size_t n = (du ? (size_t)B * D : 0) + (di ? (size_t)C * D : 0);
  const int threads = 256;
  const int blocks = (int)std::min<size_t>((n + threads - 1) / threads, 8192);
  bwd::ce_bwd_reduce<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)ws_du, (const float*)ws_di, (const float*)u, (const float*)i,
      (const float*)g, (float*)du, (float*)di, B, C, D, G_r, G_c, with_diag);
  return (int)cudaGetLastError();
}
