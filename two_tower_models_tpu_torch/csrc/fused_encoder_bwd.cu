// Whole history encoder, backward: from the residuals the forward stored
// (B6), or rebuilding them in the kernel (B7 and B9).
//
// B6 replaces two_tower_models_tpu/ops/pallas/fused_encoder.py:
// _enc_bwd_res_kernel (call at :618) with _resid_from_stored, _layer_bwd
// and _thin_bwd (:232-432).  Inputs: the cotangent g [B, 2, D] in x's dtype
// (row 0: the last layer's row 0; row 1: the mean-pool), the residuals of
// fused_encoder.cu with RES (xs [L, B, H, D], ps [L-1, B, NH, H, H], p0
// [B, NH, H]), and the f32 weights.  Outputs: dx [B, H, D] in x's dtype,
// and f32 grads of W_in [L, D, 3D], b_in [L, 3D], W_out [L, D, D], b_out
// [L, D] and the PE [H, D], summed over the batch.
//
// B7 (MODE_ENC) replaces _enc_bwd_kernel (call at :700), the backward of the
// same encoder when the forward stores nothing (_RESIDUAL_BWD = False): the
// block first recomputes the forward of its examples from x [B, H, D] (+ PE)
// and keeps each layer's input and probabilities in an f32 scratch in device
// memory, then walks the layers as B6 does.  Same outputs as B6.
//
// B9 (MODE_STACK) replaces _stack_bwd_kernel (call at :893), the backward of
// the length-masked attention stack (fused_encoder.cu with STACK, B8): the
// recompute takes x as it is (no PE), masks key kj of example b when kj >=
// lens[b], and the cotangent is g [B, D] of the last layer's row 0.  Outputs:
// dx [B, H, D] and the four weight grads; no PE grad and no mean term.
//
// Rounding points are the Pallas kernels' (bf16 mode; none in f32 mode): q,
// k, v are rebuilt as round(round(x) @ round(W_in) + b_in) and the attention
// output as round(round(p) @ v); g2 = round(dy), do = round(g2 @
// round(W_out)^T), dp = do . v unrounded, dv = round(round(p)^T do), the
// per-head pdp sum adds round(dp * p), ds = round(p * (dp - pdp) * scale),
// dqkv = round([dq | dk | dv]).  dW_out = round(out)^T g2 and db_out sums
// the unrounded dy; dW_in = round(x)^T dqkv and db_in sums the rounded dqkv.
// The thin last layer has dq at row 0 only.  B6's p is the forward's
// rounded probability, so round(p) = p there; B7 and B9 rebuild p in f32
// and, as _layer_bwd does with the recomputed residuals, use it unrounded in
// dp * p and ds.  So at bf16, B9 on full lengths is not bit-equal to B6, by
// design.  In B6 and B7 dx = dy0 + gmean / H at every row and dPE sums dy0
// over the batch; in B9 dx = dy0.
//
// Bound on the H100: operations in principle (about 10 MFLOP per example
// at H = 32, D = 64, L = 3, bf16 operands, against 100 KB of residuals);
// shared-memory loads of FMA loops in this version.  Design: grid of G
// blocks (at most one per SM), block g owning a contiguous run of
// examples.  A block goes through the layers last to first; for each layer
// it stages that layer's pre-rounded W_in, b_in and W_out in shared memory
// (64 KB f32 at D = 64), zeroes f32 accumulators of that layer's weight
// grads in shared memory (65 KB), runs the layer backward for each of its
// examples with the example's working set in shared memory (80 KB), and
// writes the accumulators to its own slice of a [G, ...] f32 workspace.
// The rows of W_in, W_out and qkv in shared memory are one float longer
// than their width (3D+1, D+1), so a loop whose threads walk down a column
// (dx = dqkv @ W_in^T, do = g2 @ W_out^T, dp = do . v) reads 32 banks, not
// one.  A
// layer's dx goes to an f32 scratch [B, H, D] in device memory, where the
// next layer down reads it as its dy.  A second launch (reduce_kernel) sums
// the G slices in block order, so the grads are the same on every run; no
// float atomics.  B7 and B9 add a first pass over the layers, first to
// last, with the same staging: shared memory is full with B6's working set
// (223,616 of 232,448 bytes at H = 32, D = 64, NH = 4), so the rebuilt
// residuals, R = L*H*D + (L-1)*NH*H*H + NH*H floats per example (57,856
// bytes at the flagship's L = 3), go to an f32 scratch [B, R] in device
// memory, written once and read once.

#include "common.cuh"

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ float rnd(float x, bool bf) {
  return bf ? tt::round_bf16(x) : x;
}

__device__ __forceinline__ float load(const void* p, size_t i, bool bf) {
  return bf ? __bfloat162float(((const __nv_bfloat16*)p)[i]) : ((const float*)p)[i];
}

// C = A @ B for shared-memory operands, A(m, k) = A[m * sam + k * sak] and
// B(k, n) = B[k * sbk + n * sbn]; epi(m, n, c) takes each entry.  A thread
// computes a TM x TN tile: rows m0 .. m0+TM-1 and columns n0 + NT * j, so the
// threads of a warp read neighbouring columns of B and one row of A.
template <int TM, int TN, class Epi>
__device__ __forceinline__ void mm(int M, int N, int K, const float* A, int sam,
                                   int sak, const float* Bm, int sbk, int sbn,
                                   Epi epi) {
  const int NT = (N + TN - 1) / TN, MT = (M + TM - 1) / TM;
  for (int tile = threadIdx.x; tile < MT * NT; tile += THREADS) {
    const int m0 = (tile / NT) * TM, n0 = tile % NT;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = m0 + i < M ? A[(m0 + i) * sam + k * sak] : 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = n0 + NT * j < N ? Bm[k * sbk + (n0 + NT * j) * sbn] : 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (m0 + i < M && n0 + NT * j < N) epi(m0 + i, n0 + NT * j, acc[i][j]);
  }
}

// What a launch rebuilds and what it returns (see the top of the file).
constexpr int MODE_STORED = 0;  // B6: residuals from the forward
constexpr int MODE_ENC = 1;     // B7: recompute, with PE, mean term and dPE
constexpr int MODE_STACK = 2;   // B9: recompute, length mask, g [B, D]

template <int MODE>
__global__ void __launch_bounds__(THREADS)
encoder_bwd_kernel(const void* __restrict__ g_in, const void* __restrict__ xs_in,
                   const void* __restrict__ ps_in, const void* __restrict__ p0_in,
                   const void* __restrict__ x_in, const float* __restrict__ pe,
                   const int* __restrict__ lens,
                   const float* __restrict__ w_in, const float* __restrict__ b_in,
                   const float* __restrict__ w_out, const float* __restrict__ b_out,
                   void* __restrict__ dx_out, float* __restrict__ res,
                   float* __restrict__ dy_scratch, float* __restrict__ ws,
                   int B, int H, int D, int NH, int L, int bf, int epb,
                   float scale) {
  constexpr bool RECOMPUTE = MODE != MODE_STORED;
  constexpr bool ENC = MODE != MODE_STACK;  // PE, mean-pool term and dPE
  extern __shared__ float smem[];
  const int D3 = 3 * D, hd = D / NH;
  const int SW = D3 + 1, SO = D + 1;  // padded row strides of wi / QKV, wo
  float* wi = smem;                 // [D][SW] round(W_in)
  float* bi = wi + D * SW;          // [3D]
  float* wo = bi + D3;              // [D][SO] round(W_out)
  float* dwi = wo + D * SO;         // [D][3D] accumulators of this layer
  float* dbi = dwi + D * D3;        // [3D]
  float* dwo = dbi + D3;            // [D][D]
  float* dbo = dwo + D * D;         // [D]
  float* dpe = dbo + D;             // [H][D]
  float* X = dpe + H * D;           // [H][D]   round(x)
  float* QKV = X + H * D;           // [H][SW]  q | k | v, later q | k | dv
  float* P = QKV + H * SW;          // [NH][nq][H] probabilities
  float* A = P + NH * H * H;        // [H][D]   out -> do -> dq
  float* Bf = A + H * D;            // [H][D]   dy -> dk
  float* S = Bf + H * D;            // [NH][nq][H] dp -> ds
  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const int e0 = blockIdx.x * epb;
  const int ne = min(epb, B - e0);
  const size_t wsz = (size_t)L * (D * D3 + D3 + D * D + D) + (ENC ? (size_t)H * D : 0);
  float* wsb = ws + (size_t)blockIdx.x * wsz;
  const int GS = ENC ? 2 * D : D;  // row stride of g
  // rebuilt residuals of one example: layer inputs [L][H][D] (f32), then the
  // probabilities [L-1][NH][H][H] and the thin layer's [NH][H] (f32)
  const size_t R = (size_t)L * H * D + (size_t)(L - 1) * NH * H * H + (size_t)NH * H;
  const size_t p_off = (size_t)L * H * D;

  if (RECOMPUTE) {  // the forward, first layer to last, into res
    for (int l = 0; l < L; ++l) {
      const bool thin = l == L - 1;
      const int nq = thin ? 1 : H;
      __syncthreads();  // the previous layer is done with wi, wo
      for (int i = t; i < D * D3; i += THREADS)
        wi[(i / D3) * SW + i % D3] = rnd(w_in[(size_t)l * D * D3 + i], bf);
      for (int i = t; i < D3; i += THREADS) bi[i] = b_in[(size_t)l * D3 + i];
      for (int i = t; i < D * D; i += THREADS)
        wo[(i / D) * SO + i % D] = rnd(w_out[(size_t)l * D * D + i], bf);
      for (int e = 0; e < ne; ++e) {
        const size_t ex = (size_t)(e0 + e);
        float* rx = res + ex * R;  // this example's rebuilt residuals
        const int len = MODE == MODE_STACK ? lens[ex] : H;  // valid keys
        __syncthreads();  // wi staged / the previous example's readers done
        // this layer's input: x (+ PE) at layer 0, else the last output
        for (int i = t; i < H * D; i += THREADS) {
          float v;
          if (l == 0) {
            v = load(x_in, ex * H * D + i, bf);
            if (ENC) v += pe[i];
            rx[i] = v;
          } else {
            v = rx[(size_t)l * H * D + i];
          }
          X[i] = rnd(v, bf);
        }
        __syncthreads();
        mm<2, 6>(H, D3, D, X, D, 1, wi, SW, 1, [&](int rr, int j, float v) {
          QKV[rr * SW + j] = rnd(v + bi[j], bf);
        });
        __syncthreads();
        // scores, -1e30 at keys past the length
        for (int i = t; i < NH * nq * H; i += THREADS) {
          const int h = i / (nq * H), qi = (i / H) % nq, kj = i % H;
          const float* qp = QKV + qi * SW + h * hd;
          const float* kp = QKV + kj * SW + D + h * hd;
          float acc = 0.0f;
          for (int c = 0; c < hd; ++c) acc = fmaf(qp[c], kp[c], acc);
          S[i] = kj < len ? acc * scale : -1e30f;
        }
        __syncthreads();
        // per-head softmax, a warp a row; p stays f32 (unrounded)
        float* pr_out = rx + p_off + (size_t)l * NH * H * H;
        for (int row = warp; row < NH * nq; row += THREADS / 32) {
          float* sr = S + row * H;
          float m = -INFINITY;
          for (int kj = lane; kj < H; kj += 32) m = fmaxf(m, sr[kj]);
          for (int off = 16; off > 0; off >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
          float den = 0.0f;
          for (int kj = lane; kj < H; kj += 32) {
            const float ev = expf(sr[kj] - m);
            sr[kj] = ev;
            den += rnd(ev, bf);
          }
          for (int off = 16; off > 0; off >>= 1)
            den += __shfl_xor_sync(0xffffffffu, den, off);
          den = fmaxf(den, 1e-30f);
          for (int kj = lane; kj < H; kj += 32) {
            const float p = sr[kj] / den;
            sr[kj] = p;
            pr_out[row * H + kj] = p;
          }
        }
        if (thin) continue;  // the thin layer's output is not needed
        __syncthreads();
        // out = round(round(p) @ v) per head, then the next layer's input
        for (int i = t; i < H * D; i += THREADS) {
          const int qi = i / D, c = i - qi * D, h = c / hd;
          const float* pr = S + (h * H + qi) * H;
          float acc = 0.0f;
          for (int kj = 0; kj < H; ++kj)
            acc = fmaf(rnd(pr[kj], bf), QKV[kj * SW + 2 * D + c], acc);
          A[i] = rnd(acc, bf);
        }
        __syncthreads();
        float* xn = rx + (size_t)(l + 1) * H * D;
        const float* bo = b_out + (size_t)l * D;
        mm<2, 2>(H, D, D, A, D, 1, wo, SO, 1, [&](int qi, int j, float v) {
          xn[qi * D + j] = v + bo[j];
        });
      }
    }
  }

  for (int i = t; i < H * D; i += THREADS) dpe[i] = 0.0f;
  for (int l = L - 1; l >= 0; --l) {
    const bool thin = l == L - 1;
    const int nq = thin ? 1 : H;  // query rows of this layer
    __syncthreads();  // the previous layer is done with wi, wo, accumulators
    for (int i = t; i < D * D3; i += THREADS) {
      wi[(i / D3) * SW + i % D3] = rnd(w_in[(size_t)l * D * D3 + i], bf);
      dwi[i] = 0.0f;
    }
    for (int i = t; i < D3; i += THREADS) { bi[i] = b_in[(size_t)l * D3 + i]; dbi[i] = 0.0f; }
    for (int i = t; i < D * D; i += THREADS) {
      wo[(i / D) * SO + i % D] = rnd(w_out[(size_t)l * D * D + i], bf);
      dwo[i] = 0.0f;
    }
    for (int i = t; i < D; i += THREADS) dbo[i] = 0.0f;

    for (int e = 0; e < ne; ++e) {
      const size_t ex = (size_t)(e0 + e);
      __syncthreads();  // wi staged / the previous example's readers done
      // 1. load round(x), p and dy
      const float* rx = RECOMPUTE ? res + ex * R : nullptr;
      for (int i = t; i < H * D; i += THREADS)
        X[i] = RECOMPUTE ? rnd(rx[(size_t)l * H * D + i], bf)
                         : load(xs_in, ((size_t)l * B + ex) * H * D + i, bf);
      const int np = NH * nq * H;
      for (int i = t; i < np; i += THREADS)
        P[i] = RECOMPUTE ? rx[p_off + (size_t)l * NH * H * H + i]
               : thin    ? load(p0_in, ex * np + i, bf)
                         : load(ps_in, ((size_t)l * B + ex) * np + i, bf);
      for (int i = t; i < nq * D; i += THREADS)
        Bf[i] = thin ? load(g_in, ex * GS + i, bf) : dy_scratch[ex * H * D + i];
      __syncthreads();
      // 2. q, k, v = round(X @ wi + bi) (q rows >= nq are not used)
      mm<2, 6>(H, D3, D, X, D, 1, wi, SW, 1, [&](int r, int j, float v) {
        QKV[r * SW + j] = rnd(v + bi[j], bf);
      });
      __syncthreads();
      // 3. out = round(round(p) @ v) per head (rows < nq); a stored p is
      // already rounded
      for (int i = t; i < nq * D; i += THREADS) {
        const int qi = i / D, c = i - qi * D, h = c / hd;
        const float* pr = P + (h * nq + qi) * H;
        float acc = 0.0f;
        for (int kj = 0; kj < H; ++kj)
          acc = fmaf(RECOMPUTE ? rnd(pr[kj], bf) : pr[kj], QKV[kj * SW + 2 * D + c], acc);
        A[i] = rnd(acc, bf);
      }
      __syncthreads();
      // 4. db_out += dy (unrounded), then dy rounded in place (g2)
      for (int j = t; j < D; j += THREADS) {
        float acc = dbo[j];
        for (int qi = 0; qi < nq; ++qi) {
          const float v = Bf[qi * D + j];
          acc += v;
          Bf[qi * D + j] = rnd(v, bf);
        }
        dbo[j] = acc;
      }
      __syncthreads();
      // dW_out += out^T g2
      mm<2, 4>(D, D, nq, A, 1, D, Bf, D, 1, [&](int c, int j, float v) {
        dwo[c * D + j] += v;
      });
      __syncthreads();
      // 5. do = round(g2 @ wo^T) into A
      mm<2, 2>(nq, D, D, Bf, D, 1, wo, 1, SO, [&](int qi, int c, float v) {
        A[qi * D + c] = rnd(v, bf);
      });
      __syncthreads();
      // 6. dp[h][qi][kj] = do[qi] . v[kj] over head h's columns
      for (int i = t; i < NH * nq * H; i += THREADS) {
        const int h = i / (nq * H), qi = (i / H) % nq, kj = i % H;
        const float* dr = A + qi * D + h * hd;
        const float* vr = QKV + kj * SW + 2 * D + h * hd;
        float acc = 0.0f;
        for (int c = 0; c < hd; ++c) acc = fmaf(dr[c], vr[c], acc);
        S[i] = acc;
      }
      __syncthreads();
      // 7a. dv[kj][c] = round(sum_qi round(p[h(c)][qi][kj]) do[qi][c]) into v's slot
      for (int i = t; i < H * D; i += THREADS) {
        const int kj = i / D, c = i - kj * D, h = c / hd;
        float acc = 0.0f;
        for (int qi = 0; qi < nq; ++qi) {
          const float p = P[(h * nq + qi) * H + kj];
          acc = fmaf(RECOMPUTE ? rnd(p, bf) : p, A[qi * D + c], acc);
        }
        QKV[kj * SW + 2 * D + c] = rnd(acc, bf);
      }
      // 7b. ds = round(p * (dp - sum_kj round(dp * p)) * scale), a warp a row
      for (int row = warp; row < NH * nq; row += THREADS / 32) {
        float* sr = S + row * H;
        const float* pr = P + row * H;
        float pdp = 0.0f;
        for (int kj = lane; kj < H; kj += 32) pdp += rnd(sr[kj] * pr[kj], bf);
        for (int off = 16; off > 0; off >>= 1)
          pdp += __shfl_xor_sync(0xffffffffu, pdp, off);
        for (int kj = lane; kj < H; kj += 32)
          sr[kj] = rnd(pr[kj] * (sr[kj] - pdp) * scale, bf);
      }
      __syncthreads();
      // 8. dq[qi][c] = round(sum_kj ds k) into A; dk[kj][c] = round(sum_qi ds q) into Bf
      for (int i = t; i < nq * D; i += THREADS) {
        const int qi = i / D, c = i - qi * D, h = c / hd;
        const float* sr = S + (h * nq + qi) * H;
        float acc = 0.0f;
        for (int kj = 0; kj < H; ++kj) acc = fmaf(sr[kj], QKV[kj * SW + D + c], acc);
        A[i] = rnd(acc, bf);
      }
      for (int i = t; i < H * D; i += THREADS) {
        const int kj = i / D, c = i - kj * D, h = c / hd;
        float acc = 0.0f;
        for (int qi = 0; qi < nq; ++qi)
          acc = fmaf(S[(h * nq + qi) * H + kj], QKV[qi * SW + c], acc);
        Bf[i] = rnd(acc, bf);
      }
      __syncthreads();
      // dqkv = [dq (zero at rows >= nq) | dk | dv] in QKV's slots
      for (int i = t; i < H * D; i += THREADS) {
        const int r = i / D, c = i - r * D;
        QKV[r * SW + c] = r < nq ? A[i] : 0.0f;
        QKV[r * SW + D + c] = Bf[i];
      }
      __syncthreads();
      // 9. dx = dqkv @ wi^T; dW_in += X^T dqkv; db_in += sum dqkv
      mm<2, 2>(H, D, D3, QKV, SW, 1, wi, 1, SW, [&](int r, int d, float v) {
        const size_t o = ex * H * D + r * D + d;
        if (l > 0) {
          dy_scratch[o] = v;
        } else {
          float x = v;
          if (ENC) {
            dpe[r * D + d] += v;
            x += load(g_in, ex * 2 * D + D + d, bf) / (float)H;
          }
          if (bf) ((__nv_bfloat16*)dx_out)[o] = __float2bfloat16_rn(x);
          else ((float*)dx_out)[o] = x;
        }
      });
      mm<4, 6>(D, D3, H, X, 1, D, QKV, SW, 1, [&](int d, int j, float v) {
        dwi[d * D3 + j] += v;
      });
      for (int j = t; j < D3; j += THREADS) {
        float acc = dbi[j];
        for (int r = 0; r < H; ++r) acc += QKV[r * SW + j];
        dbi[j] = acc;
      }
    }
    __syncthreads();
    // this layer's partial grads to the block's workspace slice
    float* o = wsb;
    for (int i = t; i < D * D3; i += THREADS) o[(size_t)l * D * D3 + i] = dwi[i];
    o += (size_t)L * D * D3;
    for (int i = t; i < D3; i += THREADS) o[(size_t)l * D3 + i] = dbi[i];
    o += (size_t)L * D3;
    for (int i = t; i < D * D; i += THREADS) o[(size_t)l * D * D + i] = dwo[i];
    o += (size_t)L * D * D;
    for (int i = t; i < D; i += THREADS) o[(size_t)l * D + i] = dbo[i];
  }
  if (!ENC) return;
  __syncthreads();
  float* o = wsb + (size_t)L * (D * D3 + D3 + D * D + D);
  for (int i = t; i < H * D; i += THREADS) o[i] = dpe[i];
}

// out[k] = sum over g = 0 .. G-1, in that order, of ws[g][k].
__global__ void reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                              int G, size_t n) {
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float acc = 0.0f;
  for (int g = 0; g < G; ++g) acc += ws[(size_t)g * n + k];
  out[k] = acc;
}

size_t bwd_smem_bytes(int H, int D, int NH) {
  const size_t D3 = 3 * (size_t)D;
  const size_t floats = (size_t)D * (D3 + 1) + D3 + (size_t)D * (D + 1) +
                        (size_t)D * D3 + D3 + (size_t)D * D + D +
                        (size_t)H * D * 4 + (size_t)H * (D3 + 1) + 2 * (size_t)NH * H * H;
  return floats * sizeof(float);
}

template <int MODE>
int launch_bwd(const void* g, const void* xs, const void* ps, const void* p0,
               const void* x, const void* pe, const void* lens, const void* w_in,
               const void* b_in, const void* w_out, const void* b_out, void* dx,
               void* res, void* dy_scratch, void* ws, int B, int H, int D,
               int NH, int L, int bf, int epb, void* stream) {
  if (D % NH != 0 || epb < 1 || L < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(H, D, NH);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_bwd_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = (B + epb - 1) / epb;
  const float scale = (float)(1.0 / sqrt((double)(D / NH)));
  encoder_bwd_kernel<MODE><<<G, THREADS, smem, (cudaStream_t)stream>>>(
      g, xs, ps, p0, x, (const float*)pe, (const int*)lens, (const float*)w_in,
      (const float*)b_in, (const float*)w_out, (const float*)b_out, dx,
      (float*)res, (float*)dy_scratch, (float*)ws, B, H, D, NH, L, bf, epb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Each backward runs over G = ceil(B / epb) blocks, each writing its slice
// of ws [G, wsz]; tt_fused_history_encoder_bwd_reduce then sums the slices
// into grads [wsz]: dW_in, db_in, dW_out, db_out and (B6, B7) dPE, flat in
// that order.

// B6: from the stored residuals xs, ps (null when L == 1) and p0.
extern "C" int tt_fused_history_encoder_bwd(
    const void* g, const void* xs, const void* ps, const void* p0,
    const void* w_in, const void* b_in, const void* w_out, void* dx,
    void* dy_scratch, void* ws, int B, int H, int D, int NH, int L,
    int bf, int epb, void* stream) {
  return launch_bwd<MODE_STORED>(g, xs, ps, p0, nullptr, nullptr, nullptr, w_in,
                                 b_in, w_out, nullptr, dx, nullptr, dy_scratch,
                                 ws, B, H, D, NH, L, bf, epb, stream);
}

// B7: x [B, H, D], g [B, 2, D] and the PE; res is an f32 scratch [B, R].
extern "C" int tt_fused_history_encoder_bwd_recompute(
    const void* g, const void* x, const void* pe, const void* w_in,
    const void* b_in, const void* w_out, const void* b_out, void* dx, void* res,
    void* dy_scratch, void* ws, int B, int H, int D, int NH, int L, int bf,
    int epb, void* stream) {
  return launch_bwd<MODE_ENC>(g, nullptr, nullptr, nullptr, x, pe, nullptr, w_in,
                              b_in, w_out, b_out, dx, res, dy_scratch, ws, B, H,
                              D, NH, L, bf, epb, stream);
}

// B9: x [B, H, D], lens [B] int32 and g [B, D]; res is an f32 scratch [B, R].
extern "C" int tt_fused_attn_stack_bwd(
    const void* g, const void* x, const void* lens, const void* w_in,
    const void* b_in, const void* w_out, const void* b_out, void* dx, void* res,
    void* dy_scratch, void* ws, int B, int H, int D, int NH, int L, int bf,
    int epb, void* stream) {
  return launch_bwd<MODE_STACK>(g, nullptr, nullptr, nullptr, x, nullptr, lens,
                                w_in, b_in, w_out, b_out, dx, res, dy_scratch,
                                ws, B, H, D, NH, L, bf, epb, stream);
}

extern "C" int tt_fused_history_encoder_bwd_reduce(const void* ws, void* grads,
                                                   int G, int n, void* stream) {
  if (G < 1 || n < 1) return (int)cudaErrorInvalidValue;
  reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (float*)grads, G, (size_t)n);
  return (int)cudaGetLastError();
}
