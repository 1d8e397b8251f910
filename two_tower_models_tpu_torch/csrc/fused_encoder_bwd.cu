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

// B6, B7 and B9 on the tensor cores (encoder_bwd_tc_kernel<MODE, HPB, D>)
// replace the same three Pallas kernels (calls at :618, :700 and :893) for
// bf16 with D 32 or 64, the head width a multiple of 16 and Hp =
// round_up(H, 16) <= 64 (ops/fused_encoder.py:_enc_bwd_route; f32, head
// width 8, D = 128 and longer histories keep encoder_bwd_kernel above), at
// the rounding points listed above, every product on mma.sync m16n8k16
// with each k16 step of a projection added rounded (tt::mma_bf16_add).
// Bound on the H100: bytes, by a little (at B = 4096, H = 32, D = 64,
// L = 3, B6 reads 119 MB of residuals and writes 17 MB of dx, 0.041 ms at
// 3.35 TB/s, against 36 GFLOP, 0.036 ms at the bf16 tensor-core rate; B7
// and B9 have no residuals to read and recompute the forward: operations).
// Design: B14's tensor-core tile (csrc/fused_mha.cu, helpers in
// csrc/mha_tc.cuh) walked over the layers:
// - tiles of E examples of Hp rows (about 128 rows), one persistent block
//   an SM, block k owning tiles k, k + grid, ...  A layer's weight-grad
//   slices take 64 floats a lane at D = 64 beside a working set of about
//   200 registers, so the layers cannot all stay in registers: the block
//   goes through the layers last to first, and for each it stages that
//   layer's round(W_in), round(W_out) (bf16) and b_in, walks its tiles,
//   and writes its slices of the layer's grads to its own slice of ws
//   (the layout above), which reduce_kernel sums in block order.  dW_in's
//   slices (48 floats a lane) stay in registers across the tiles; each
//   tile's dW_out slice (16) is added to an f32 [D][D] in shared memory,
//   which kept the instances within 255 registers, no spills;
// - dy between layers stays in an f32 scratch [B, H, D] in device memory:
//   a layer's dx goes there as float2 stores straight from the
//   accumulators, and the layer below reads its rows back (plain loads:
//   the read-only path is not coherent with the block's own writes).  Only
//   the block that owns a tile writes and reads its rows, so a
//   __syncthreads between layers is all the ordering needed.  g2 =
//   round(dy) goes to shared memory.  db_out sums the unrounded dy over the
//   block's rows: g's row 0 in the thin layer; below it dy = dqkv
//   round(W_in)^T of the layer above, so by linearity the block's db_in of
//   that layer times round(W_in)^T, in f32 at its end (summing 10^5 f32 dy
//   rows would add up the tensor cores' product errors: 1.7x the plain
//   version's RMS error from f64 sums at H = 40);
// - B6 rebuilds q | k | v from the stored round(x) (xs) and takes p from
//   ps or p0: the forward's round(p), both round(p) and p there.  A warp's
//   slab of p is filled with cp.async, the first (example, head)'s behind
//   the tile's projections, the next one's behind the last one's dk and
//   dq.  No scores, no exponentials, no denominators;
// - B7 and B9 first run the forward over their tiles, first layer to last,
//   with B8's helpers (band_attention), and write each layer's input
//   round(x_l), l >= 1, to a bf16 scratch [L-1, B, H, D] (cp.async.cg reads
//   it back, through L2).  Their backward recomputes S and the softmax as
//   B14 does, p in f32 unrounded in dp p and ds.  B7's layer 0 input is
//   round(x + PE), the f32 sum rounded once as B1 makes it: the tile's x
//   lands and becomes that in place, in the first pass and again in the
//   backward's layer 0 (a pass over the tile in shared memory, the PE read
//   from device memory through L1), so its scratch is B9's; storing layer
//   0's input there too would write and read another B H D bf16;
// - a full layer is B14's tile: q | k | v and do by warp_gemm, a warp per
//   (example, head) with round(p) and ds in its slabs, dv, dk and dq from
//   them, the weight grads in each warp's register slices, dx =
//   dqkv round(W_in)^T.  The thin last layer runs the same code on one
//   query band: p is row 0's alone (B6: the slab's other rows are zeros;
//   B9: the other rows' p is set to 0), so ds and the output are zero
//   there and dq is zero past row 0, as in _thin_bwd;
// - layer 0 stages its f32 dx over g2 and do, then writes dx in x's dtype
//   16 bytes a store: B6 and B7 add gmean / H and add dPE, summed over the
//   tile's examples, to their slice of ws; B9 writes exact zeros past each
//   length (a select, never a product with 0).
// No float atomics and every sum in a fixed order: bit-equal on repeat.
// Shared memory at the cells (H = 32, D = 64, E = 4) 218,112 bytes, one
// block an SM.

#include <algorithm>
#include <type_traits>

#include "mha_tc.cuh"

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

// ---- B6, B7 and B9 on the tensor cores ---------------------------------------

namespace tc {

using namespace tt::tc;  // bf16, PAD, TILE_ROWS, warp_gemm, load_x, store_rows, the band helpers
constexpr int THREADS = 256;  // eight warps, one block an SM
constexpr int WARPS = THREADS / 32;

// Shared memory of one block in bytes (ops/fused_encoder.py:_enc_bwd_tc_smem_bytes):
// bf16 round(W_in) [D][3D] and round(W_out) [D][D] of one layer, x, g2, do
// and the attention output [rows][D] each, q | k | v [rows][3D], each row
// padded by 8 bf16; min(8, E * D / 16) warp slabs of round(p) and ds
// [Hp][Hp + 8] each; f32 b_in [3D], b_out [D] and the block's dW_out [D][D].
size_t smem_bytes(int rows, int Hp, int D) {
  const size_t slabs = std::min(WARPS, rows / Hp * (D / 16));
  return 2 * ((size_t)D * (3 * D + PAD) + (size_t)D * (D + PAD) + 4 * (size_t)rows * (D + PAD) +
              (size_t)rows * (3 * D + PAD) + slabs * 2 * Hp * (Hp + PAD)) +
         16 * (size_t)D + 4 * (size_t)D * D;
}

// The thread's index, opaque to the compiler: the addresses a loop derives
// from it are computed where the loop runs, not once for the whole kernel
// and kept in registers across the layers (at 255 registers a thread,
// those spilled).
__device__ __forceinline__ int fresh_tid() {
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));
  return t;
}

// MODE_STORED (B6), MODE_ENC (B7) or MODE_STACK (B9); HPB = Hp / 16; D 32 or
// 64, so that each warp's slice of a layer's weight grads has a fixed shape
// in registers.  x is B6's xs [L, B, H, D] or B7's and B9's x [B, H, D]; pe
// B7's [H, D]; xr (B7 and B9, L > 1) and dy are scratch in device memory
// that the block writes and reads again in this launch, so neither is read
// through the read-only path.
template <int MODE, int HPB, int D>
__global__ void __launch_bounds__(THREADS, 1)
encoder_bwd_tc_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
                      const bf16* __restrict__ ps, const bf16* __restrict__ p0,
                      const float* __restrict__ pe,
                      const int* __restrict__ lens, const float* __restrict__ w_in,
                      const float* __restrict__ b_in, const float* __restrict__ w_out,
                      const float* __restrict__ b_out, bf16* __restrict__ dx, bf16* xr,
                      float* dy, float* __restrict__ ws, int B, int H, int NH, int L, int E,
                      float scale) {
  constexpr bool STACK = MODE == MODE_STACK;
  constexpr bool RECOMPUTE = MODE != MODE_STORED;  // B7, B9: the forward rebuilt here
  constexpr int Hp = 16 * HPB, D3 = 3 * D;
  constexpr int SWI = D3 + PAD, SWO = D + PAD, SX = D + PAD, SQ = D3 + PAD, SP = Hp + PAD;
  constexpr int DS = D + 8;               // f32 row stride of layer 0's dx stage
  constexpr int RB = D / 16;              // 16-row blocks of dW_in and dW_out
  constexpr int NTI = 3 * D * D / 1024;   // n8 tiles of dW_in a warp owns
  constexpr int NTO = D * D / 1024;       // and of dW_out
  constexpr int NTG = D >= 64 ? 4 : 2;    // warp tile width / 8 of the D-wide products
  constexpr int CP = D / 2;               // column pairs of a row of dy
  constexpr int RSTEP = THREADS / CP;     // rows between a thread's rows of dy
  constexpr int NDY = TILE_ROWS / RSTEP;  // the most rows of dy a thread takes a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = D / NH, rows = E * Hp;
  bf16* Wi = (bf16*)smem_raw;   // [D][SWI] round(W_in) of the layer
  bf16* Wo = Wi + D * SWI;      // [D][SWO] round(W_out)
  bf16* X = Wo + D * SWO;       // [rows][SX] round(x), the layer's input
  bf16* G = X + rows * SX;      // [rows][SX] g2 = round(dy); the first pass: the other x buffer
  bf16* DO = G + rows * SX;     // [rows][SX] do; dk of each (example, head) after dv
  bf16* OUT = DO + rows * SX;   // [rows][SX] the attention output
  bf16* QKV = OUT + rows * SX;  // [rows][SQ] q | k | v, then dq | dk | dv
  bf16* SL = QKV + rows * SQ;   // [warp][2][Hp][SP] round(p), ds
  float* bi = (float*)(SL + min(WARPS, E * RB) * 2 * Hp * SP);  // [3D]
  float* bo = bi + D3;          // [D] (B7's and B9's first pass)
  float* GO = bo + D;           // [D][D] the block's dW_out of the layer
  float* STG = (float*)G;       // [rows][DS] layer 0's f32 dx, over g2 and do
  __shared__ int sl[TILE_ROWS / 16];  // the tile's lengths
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, gq = lane / 4, q4 = lane % 4;
  const int tiles = (B + E - 1) / E;
  const size_t lsz = (size_t)B * H * D;  // one layer of xs or xr
  const size_t wsz = (size_t)L * (4 * D * D + 4 * D) + (STACK ? 0 : (size_t)H * D);
  float* wsb = ws + (size_t)blockIdx.x * wsz;  // this block's slice of the partial grads
  float* dpe = wsb + (size_t)L * (4 * D * D + 4 * D);  // its dPE [H][D] (B6, B7)

  // layer l's round(W_in), round(W_out) as bf16 (16 bytes a load), b_in (and b_out) as f32
  auto stage = [&](int l) {
    const int t = fresh_tid();
    const float4* wi = (const float4*)(w_in + (size_t)l * D * D3);
    const float4* wo = (const float4*)(w_out + (size_t)l * D * D);
    for (int i = t; i < D * D3 / 4; i += THREADS) {
      const float4 v = wi[i];
      *(uint2*)(Wi + (4 * i / D3) * SWI + 4 * i % D3) =
          make_uint2(tt::pack_bf16x2(v.x, v.y), tt::pack_bf16x2(v.z, v.w));
    }
    for (int i = t; i < D * D / 4; i += THREADS) {
      const float4 v = wo[i];
      *(uint2*)(Wo + (4 * i / D) * SWO + 4 * i % D) =
          make_uint2(tt::pack_bf16x2(v.x, v.y), tt::pack_bf16x2(v.z, v.w));
    }
    for (int i = t; i < D3; i += THREADS) bi[i] = b_in[(size_t)l * D3 + i];
    if (RECOMPUTE)
      for (int i = t; i < D; i += THREADS) bo[i] = b_out[(size_t)l * D + i];
  };
  auto set_lens = [&](int tile) {
    const int ex = tile * E + t;
    if (t < E) sl[t] = STACK && ex < B ? lens[ex] : H;
  };
  // B7: the tile's x, landed in Xt, becomes layer 0's input round(x + PE)
  // in place at rows < H of examples < B (the rest stay zeros), 16 bytes a
  // thread at a time
  auto add_pe = [&](bf16* Xt, int tile) {
    for (int i = fresh_tid(); i < rows * (D / 8); i += THREADS) {
      const int r = i / (D / 8), c = 8 * (i - r * (D / 8)), e = r / Hp, hi = r - e * Hp;
      if (hi >= H || tile * E + e >= B) continue;
      uint4* p = (uint4*)(Xt + r * SX + c);
      uint4 v = *p;
      unsigned* u = (unsigned*)&v;
      const float4* q = (const float4*)(pe + (size_t)hi * D + c);
      const float4 a = q[0], b = q[1];
      const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 xv = __bfloat1622float2(*(const __nv_bfloat162*)&u[k]);
        u[k] = tt::pack_bf16x2(xv.x + f[2 * k], xv.y + f[2 * k + 1]);
      }
      *p = v;
    }
  };

  if constexpr (RECOMPUTE) {
    // the forward, first layer to last, over this block's tiles (B8's
    // layers on B8's helpers): round(x_l) of layers 1 .. L-1 into xr
    for (int l = 0; l + 1 < L; ++l) {
      const bf16* src = l == 0 ? x : xr + (size_t)(l - 1) * lsz;
      __syncthreads();  // the last layer's tiles are done with the weights and buffers
      stage(l);
      load_x(X, src, blockIdx.x, E, Hp, H, D, B);  // the plan gives every block a tile
      tt::cp_commit();
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += (int)gridDim.x, ++it) {
        bf16* Xc = it & 1 ? G : X;
        const int next = tile + (int)gridDim.x;
        set_lens(tile);
        tt::cp_wait<0>();
        __syncthreads();  // x landed, weights and lengths staged, the last tile's output stored
        if (next < tiles) load_x(it & 1 ? X : G, src, next, E, Hp, H, D, B);
        tt::cp_commit();
        if (MODE == MODE_ENC && l == 0) {
          add_pe(Xc, tile);
          __syncthreads();  // layer 0's input complete
        }
        warp_gemm<2>(rows, D3, D, Xc, SX, Wi, SWI, [&](int r, int c, float v0, float v1) {
          *(unsigned*)(QKV + r * SQ + c) = tt::pack_bf16x2(v0 + bi[c], v1 + bi[c + 1]);
        });
        __syncthreads();  // q | k | v complete
        for (int u = warp; u < E * NH * HPB; u += WARPS) {
          const int e = u / (NH * HPB), h = (u / HPB) % NH, qb = u % HPB;
          if (tile * E + e >= B) continue;
          const bf16* K = QKV + e * Hp * SQ + D + h * hd;
          band_attention<HPB>(QKV + (e * Hp + qb * 16) * SQ + h * hd, K, K + D, SQ, hd, H, sl[e],
                              scale, [](const unsigned (&)[HPB][4]) {});
        }
        __syncthreads();  // the attention output complete
        // the layer's output, rounded once: the next layer's input (padded rows stay 0)
        warp_gemm<2>(rows, D, D, QKV, SQ, Wo, SWO, [&](int r, int c, float v0, float v1) {
          *(unsigned*)(Xc + r * SX + c) =
              r % Hp < H ? tt::pack_bf16x2(v0 + bo[c], v1 + bo[c + 1]) : 0u;
        });
        __syncthreads();  // the output complete
        store_rows<THREADS>(xr + (size_t)l * lsz, Xc, tile, E, Hp, H, D, B);
      }
    }
  }
  if constexpr (!STACK)  // dPE [H][D], after the four grads in the block's slice: summed there at layer 0
    for (int i = t; i < H * D; i += THREADS) dpe[i] = 0.0f;

  // the backward, last layer to first
  const int m0 = 16 * (warp % RB), ni0 = (warp / RB) * 8 * NTI, no0 = (warp / RB) * 8 * NTO;
  for (int l = L - 1; l >= 0; --l) {
    const bool thin = l == L - 1;
    const bf16* src = !RECOMPUTE ? x + (size_t)l * lsz : l == 0 ? x : xr + (size_t)(l - 1) * lsz;
    // this warp's slice of dW_in in registers across the tiles: rows m0 ..
    // m0 + 15, columns ni0 ..; its slice of dW_out (columns no0 ..) in GO;
    // db_in column t (t < 3D)
    float gi[NTI][4], gbi = 0.0f;
#pragma unroll
    for (int j = 0; j < NTI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) gi[j][c] = 0.0f;
    __syncthreads();  // the last layer is done with the weights, buffers and its sums
    stage(l);
    for (int i = fresh_tid(); i < D * D; i += THREADS) GO[i] = 0.0f;
    load_x(X, src, blockIdx.x, E, Hp, H, D, B);
    tt::cp_commit();
    // B6: the stored round(p) of (example, head) u of `tile` into this
    // warp's slab with cp.async (rows < 16 in the thin layer, whose p is
    // row 0's alone); zeros at padded rows and keys
    auto load_probs = [&](int tile, int u) {
      const int e = u / NH, h = u - e * NH, ex = tile * E + e;
      bf16* P = SL + warp * 2 * Hp * SP;
      const int nr = thin ? 16 : Hp, pr = thin ? 1 : H;
      const bf16* from = thin ? p0 + ((size_t)ex * NH + h) * H
                              : ps + (((size_t)l * B + ex) * NH + h) * H * H;
      if (H % 8 == 0) {  // rows of 16-byte chunks
        for (int i = lane; i < nr * 2 * HPB; i += 32) {
          const int r = i / (2 * HPB), c = 8 * (i % (2 * HPB));
          const bool ok = ex < B && r < pr && c < H;
          tt::cp_async16(P + r * SP + c, ok ? from + r * H + c : p0, ok ? 16 : 0);
        }
      } else {
        for (int i = lane; i < nr * Hp; i += 32) {
          const int r = i / Hp, c = i - r * Hp;
          P[r * SP + c] = ex < B && r < pr && c < H ? from[r * H + c] : __float2bfloat16_rn(0.0f);
        }
      }
    };
    // a warp per (example, head) of the tile: every query band (one in
    // the thin layer, whose query is row 0 alone), then dv, dk and dq from
    // the warp's slabs
    auto attention = [&](int tile, auto thin_layer) {
      constexpr bool THIN = decltype(thin_layer)::value;
      constexpr int NQB = THIN ? 1 : HPB;
      for (int u = warp; u < E * NH; u += WARPS) {
        const int e = u / NH, h = u - e * NH;
        bf16* Qh = QKV + e * Hp * SQ + h * hd;
        bf16* Kh = Qh + D;
        bf16* Vh = Qh + 2 * D;
        bf16* Dh = DO + e * Hp * SX + h * hd;
        bf16* Oh = OUT + e * Hp * SX + h * hd;
        bf16* Ps = SL + warp * 2 * Hp * SP;  // round(p) [Hp][SP]
        bf16* Ss = Ps + Hp * SP;             // ds [Hp][SP]
        if constexpr (!RECOMPUTE) {  // this (example, head)'s probabilities landed
          tt::cp_wait<0>();
          __syncwarp();
        }
        for (int qb = 0; qb < NQB; ++qb) {
          float s[2 * HPB][4];  // p in f32 in the S accumulators' layout
          if constexpr (RECOMPUTE) {  // recomputed, as B1 and B8 compute it
            band_probs<HPB>(s, Qh + qb * 16 * SQ, Kh, SQ, hd, H, sl[e], scale);
            if constexpr (THIN)  // row 0 alone
#pragma unroll
              for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) s[j][c] = gq == 0 && c < 2 ? s[j][c] : 0.0f;
          } else {  // the forward's round(p), from the slab
#pragma unroll
            for (int j = 0; j < 2 * HPB; ++j) {
              const bf16* pr = Ps + (qb * 16 + gq) * SP + 8 * j + 2 * q4;
              const float2 a = __bfloat1622float2(*(const __nv_bfloat162*)pr);
              const float2 b = __bfloat1622float2(*(const __nv_bfloat162*)(pr + 8 * SP));
              s[j][0] = a.x;
              s[j][1] = a.y;
              s[j][2] = b.x;
              s[j][3] = b.y;
            }
          }
          unsigned pa[HPB][4];
          pack_probs<HPB>(pa, s, RECOMPUTE ? Ps + qb * 16 * SP : nullptr, SP);
          band_bwd<HPB>(s, pa, Vh, SQ, Dh + qb * 16 * SX, SX, Oh + qb * 16 * SX, SX,
                        Ss + qb * 16 * SP, SP, hd, scale);
        }
        if constexpr (THIN)  // the output rows past the first band: zeros for dW_out
          for (int i = lane; i < (Hp - 16) * (hd / 8); i += 32)
            *(uint4*)(Oh + (16 + i / (hd / 8)) * SX + 8 * (i % (hd / 8))) = make_uint4(0, 0, 0, 0);
        head_grads<HPB, NQB>(Ps, Ss, SP, Qh, Kh, Vh, SQ, Dh, SX, hd, [&] {
          if constexpr (!RECOMPUTE) {  // the next (example, head)'s probabilities, behind dk and dq
            if (u + WARPS < E * NH) load_probs(tile, u + WARPS);
            tt::cp_commit();
          }
        });
      }
    };

    for (int tile = blockIdx.x; tile < tiles; tile += (int)gridDim.x) {
      const int next = tile + (int)gridDim.x;
      set_lens(tile);
      if constexpr (!RECOMPUTE) {  // the first (example, head) of this warp, behind the projections
        if (warp < E * NH) load_probs(tile, warp);
        tt::cp_commit();
      }
      // g2 = round(dy) into G: the f32 dy of the layer above, or g's row 0
      // in the thin layer.  A thread takes rows r0, r0 + RSTEP, ... of each
      // example (Hp is a multiple of RSTEP), so the i-th is row r0 + (i %
      // NPE) RSTEP of example i / NPE; all loads first.
      {
        constexpr int NPE = Hp / RSTEP;
        const int cp = fresh_tid() % CP, r0 = fresh_tid() / CP;  // column pair, first row
        float2 v[NDY];
#pragma unroll
        for (int i = 0; i < NDY; ++i) {
          const int e = i / NPE, hi = r0 + (i % NPE) * RSTEP, ex = tile * E + e;
          v[i] = make_float2(0.0f, 0.0f);
          if (e < E && ex < B) {
            if (thin) {
              if (hi == 0)
                v[i] = __bfloat1622float2(
                    *(const __nv_bfloat162*)(g + (size_t)ex * (STACK ? D : 2 * D) + 2 * cp));
            } else if (hi < H) {
              v[i] = *(const float2*)(dy + ((size_t)ex * H + hi) * D + 2 * cp);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < NDY; ++i) {
          const int e = i / NPE, hi = r0 + (i % NPE) * RSTEP;
          if (e < E)
            *(unsigned*)(G + (e * Hp + hi) * SX + 2 * cp) = tt::pack_bf16x2(v[i].x, v[i].y);
        }
      }
      tt::cp_wait<RECOMPUTE ? 0 : 1>();
      __syncthreads();  // x landed, g2 complete, lengths and weights staged
      if (MODE == MODE_ENC && l == 0) {
        add_pe(X, tile);
        __syncthreads();  // layer 0's input complete
      }
      qkv_and_do<NTG>(rows, D, X, SX, Wi, SWI, bi, QKV, SQ, G, Wo, SWO, DO);
      __syncthreads();  // q | k | v and do complete
      if (thin)
        attention(tile, std::true_type());
      else
        attention(tile, std::false_type());
      __syncthreads();  // dq | dk | dv and the attention output complete

      // the weight grads: dW_in += round(x)^T dqkv (this warp's slice),
      // dW_out += out^T g2 (the tile's sum added to the warp's slice of
      // GO), db_in += sum dqkv (a column a thread)
      warp_gemm_tn<NTI>(gi, rows, X, SX, m0, QKV, SQ, ni0);
      {
        float go[NTO][4];
#pragma unroll
        for (int j = 0; j < NTO; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) go[j][c] = 0.0f;
        warp_gemm_tn<NTO>(go, rows, OUT, SX, m0, G, SX, no0);
        store_slice<NTO, true>(GO, D, go, m0, no0);
      }
      if (t < D3) gbi += col_sum(QKV + t, SQ, rows);
      __syncthreads();  // x, g2 and the attention output read
      if (next < tiles) load_x(X, src, next, E, Hp, H, D, B);
      tt::cp_commit();
      if (l > 0) {
        // dx = dqkv round(W_in)^T (depth 3D) in f32: the dy of the layer
        // below, straight from the accumulators
        warp_gemm<NTG, true>(rows, D, D3, QKV, SQ, Wi, SWI, [&](int r, int c, float v0, float v1) {
          const int e = r / Hp, hi = r - e * Hp, ex = tile * E + e;
          if (ex < B && hi < H)
            *(float2*)(dy + ((size_t)ex * H + hi) * D + c) = make_float2(v0, v1);
        });
        continue;
      }
      // layer 0: dx staged in f32 over g2 and do, then written in x's dtype
      // 16 bytes a store (B6, B7: + gmean / H; B9: zeros past each length),
      // and B6's and B7's dPE summed over the tile's examples in order
      warp_gemm<NTG, true>(rows, D, D3, QKV, SQ, Wi, SWI, [&](int r, int c, float v0, float v1) {
        *(float2*)(STG + r * DS + c) = make_float2(v0, v1);
      });
      __syncthreads();  // dx staged
      for (int i = fresh_tid(); i < rows * (D / 8); i += THREADS) {
        const int r = i / (D / 8), c = 8 * (i - r * (D / 8)), e = r / Hp, hi = r - e * Hp;
        const int ex = tile * E + e;
        if (ex >= B || hi >= H) continue;
        const float4 a = *(const float4*)(STG + r * DS + c);
        const float4 b = *(const float4*)(STG + r * DS + c + 4);
        float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        if constexpr (STACK) {
          if (hi >= sl[e])
#pragma unroll
            for (int k = 0; k < 8; ++k) v[k] = 0.0f;
        } else {
          const uint4 gm = *(const uint4*)(g + ((size_t)ex * 2 + 1) * D + c);
          const __nv_bfloat162* g2 = (const __nv_bfloat162*)&gm;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(g2[k]);
            v[2 * k] += f.x / (float)H;
            v[2 * k + 1] += f.y / (float)H;
          }
        }
        *(uint4*)(dx + ((size_t)ex * H + hi) * D + c) =
            make_uint4(tt::pack_bf16x2(v[0], v[1]), tt::pack_bf16x2(v[2], v[3]),
                       tt::pack_bf16x2(v[4], v[5]), tt::pack_bf16x2(v[6], v[7]));
      }
      if constexpr (!STACK)  // H <= 64: at most 64 D / THREADS elements a thread
#pragma unroll
        for (int k = 0; k < 64 * D / THREADS; ++k) {
          const int i = fresh_tid() + k * THREADS, hi = i / D, c = i - hi * D;
          if (hi < H) {
            float acc = 0.0f;
            for (int e = 0; e < E && tile * E + e < B; ++e) acc += STG[(e * Hp + hi) * DS + c];
            dpe[i] += acc;
          }
        }
      __syncthreads();  // the stage read: the next tile writes g2
    }
    tt::cp_wait<0>();

    // this layer's partials to the block's slice: dW_in [L][D][3D], db_in
    // [L][3D], dW_out [L][D][D], db_out [L][D]
    float* dbo = wsb + (size_t)L * (D * D3 + D3 + D * D);
    {
      const int w = fresh_tid() / 32;  // the slice's address, not kept from the kernel's start
      store_slice<NTI>(wsb + (size_t)l * D * D3, D3, gi, 16 * (w % RB), (w / RB) * 8 * NTI);
    }
    if (t < D3) {
      wsb[(size_t)L * D * D3 + (size_t)l * D3 + t] = gbi;
      bi[t] = gbi;  // b_in is dead: db_in to shared memory for the layer below's db_out
    }
    __syncthreads();  // GO and db_in complete
    for (int i = fresh_tid(); i < D * D; i += THREADS)
      wsb[(size_t)L * (D * D3 + D3) + (size_t)l * D * D + i] = GO[i];
    // db_out of the layer below sums its dy, dqkv round(W_in)^T, over the
    // block's rows: the block's db_in times round(W_in)^T, in f32, by
    // linearity, where summing 10^5 dy rows would add up the tensor cores'
    // product errors
    if (l > 0 && t < D) {
      float acc = 0.0f;
      for (int j = 0; j < D3; ++j) acc = fmaf(bi[j], __bfloat162float(Wi[t * SWI + j]), acc);
      dbo[(size_t)(l - 1) * D + t] = acc;
    }
    if (thin) {
      // db_out of the thin layer sums g's row 0 over the block's examples:
      // THREADS / D groups of a thread a column, each a share of the
      // tiles, then the groups in order (do is dead)
      constexpr int NG = THREADS / D;
      const int c = t % D, grp = t / D;
      float acc = 0.0f;
      for (int tile = blockIdx.x + grp * (int)gridDim.x; tile < tiles; tile += NG * (int)gridDim.x)
        for (int e = 0; e < E && tile * E + e < B; ++e)
          acc += __bfloat162float(g[(size_t)(tile * E + e) * (STACK ? D : 2 * D) + c]);
      float* red = (float*)DO;
      red[t] = acc;
      __syncthreads();
      if (t < D) {
        float sum = 0.0f;
        for (int k = 0; k < NG; ++k) sum += red[k * D + t];
        dbo[(size_t)l * D + t] = sum;
      }
    }
  }
}

template <int MODE, int HPB, int D>
int launch(const void* g, const void* x, const void* ps, const void* p0, const void* pe,
           const void* lens, const void* w_in, const void* b_in, const void* w_out,
           const void* b_out, void* dx, void* xr, void* dy, void* ws, int B, int H, int NH, int L,
           int E, int grid, void* stream) {
  const size_t smem = smem_bytes(E * 16 * HPB, 16 * HPB, D);
  cudaError_t err = cudaFuncSetAttribute(encoder_bwd_tc_kernel<MODE, HPB, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)(D / NH)));
  encoder_bwd_tc_kernel<MODE, HPB, D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)x, (const bf16*)ps, (const bf16*)p0, (const float*)pe,
      (const int*)lens, (const float*)w_in, (const float*)b_in, (const float*)w_out,
      (const float*)b_out,
      (bf16*)dx, (bf16*)xr, (float*)dy, (float*)ws, B, H, NH, L, E, scale);
  return (int)cudaGetLastError();
}

// Checks the shape and plan (ops/fused_encoder.py:_enc_bwd_tc_plan) and
// launches the instance of D and H's key bands.
template <int MODE>
int launch_shape(const void* g, const void* x, const void* ps, const void* p0, const void* pe,
                 const void* lens, const void* w_in, const void* b_in, const void* w_out,
                 const void* b_out, void* dx, void* xr, void* dy, void* ws, int B, int H, int D,
                 int NH, int L, int ept, int grid, void* stream) {
  const int hpb = (H + 15) / 16;
  // the full layers' inputs: stored (B6), or rebuilt into xr from layer 1 on (B7, B9)
  const bool deep = MODE == MODE_STORED ? ps != nullptr : xr != nullptr;
  if (B < 1 || H < 1 || NH < 1 || L < 1 || (D != 32 && D != 64) || D % NH != 0 ||
      (D / NH) % 16 != 0 || hpb > 4 || ept < 1 || (ept * 16 * hpb) % 32 != 0 ||
      ept * 16 * hpb > TILE_ROWS || grid < 1 || grid > (B + ept - 1) / ept || deep != (L > 1))
    return (int)cudaErrorInvalidValue;
#define TT_ARGS g, x, ps, p0, pe, lens, w_in, b_in, w_out, b_out, dx, xr, dy, ws, B, H, NH, L, ept, grid, stream
  switch (hpb + 4 * (D == 64)) {
    case 1: return launch<MODE, 1, 32>(TT_ARGS);
    case 2: return launch<MODE, 2, 32>(TT_ARGS);
    case 3: return launch<MODE, 3, 32>(TT_ARGS);
    case 4: return launch<MODE, 4, 32>(TT_ARGS);
    case 5: return launch<MODE, 1, 64>(TT_ARGS);
    case 6: return launch<MODE, 2, 64>(TT_ARGS);
    case 7: return launch<MODE, 3, 64>(TT_ARGS);
    default: return launch<MODE, 4, 64>(TT_ARGS);
  }
#undef TT_ARGS
}

}  // namespace tc

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

// B6 on the tensor cores: g [B, 2, D], xs [L, B, H, D], ps [L-1, B, NH, H, H]
// (null when L == 1) and p0 [B, NH, H] bf16, 16-byte aligned; the f32
// weights (W_in, W_out 16-byte aligned).  D 32 or 64, D / NH a multiple of
// 16, Hp = round_up(H, 16) <= 64; ept examples a tile, grid blocks
// (ops/fused_encoder.py:_enc_bwd_tc_plan).  dx [B, H, D] bf16, dy an f32
// scratch [B, H, D], ws [grid, L (4D^2 + 4D) + H D] as
// tt_fused_history_encoder_bwd's.
extern "C" int tt_fused_history_encoder_bwd_tc(
    const void* g, const void* xs, const void* ps, const void* p0, const void* w_in,
    const void* b_in, const void* w_out, void* dx, void* dy_scratch, void* ws, int B, int H,
    int D, int NH, int L, int ept, int grid, void* stream) {
  return tc::launch_shape<MODE_STORED>(g, xs, ps, p0, nullptr, nullptr, w_in, b_in, w_out, nullptr,
                                       dx, nullptr, dy_scratch, ws, B, H, D, NH, L, ept, grid,
                                       stream);
}

// B7 on the tensor cores: g [B, 2, D] and x [B, H, D] bf16, pe [H, D] and
// the weights f32 (x, g, pe, W_in and W_out 16-byte aligned); xr, dy and ws
// as B9's (xr [L-1, B, H, D] bf16, null when L == 1; ws [grid, L (4D^2 +
// 4D) + H D] as B6's).
extern "C" int tt_fused_history_encoder_bwd_recompute_tc(
    const void* g, const void* x, const void* pe, const void* w_in, const void* b_in,
    const void* w_out, const void* b_out, void* dx, void* xr, void* dy_scratch, void* ws, int B,
    int H, int D, int NH, int L, int ept, int grid, void* stream) {
  return tc::launch_shape<MODE_ENC>(g, x, nullptr, nullptr, pe, nullptr, w_in, b_in, w_out, b_out,
                                    dx, xr, dy_scratch, ws, B, H, D, NH, L, ept, grid, stream);
}

// B9 on the tensor cores: g [B, D], x [B, H, D] bf16 (16-byte aligned),
// lens [B] int32 and the f32 weights; xr a bf16 scratch [L-1, B, H, D]
// (null when L == 1), dy and ws as B6's (ws [grid, L (4D^2 + 4D)]).
extern "C" int tt_fused_attn_stack_bwd_tc(
    const void* g, const void* x, const void* lens, const void* w_in, const void* b_in,
    const void* w_out, const void* b_out, void* dx, void* xr, void* dy_scratch, void* ws, int B,
    int H, int D, int NH, int L, int ept, int grid, void* stream) {
  return tc::launch_shape<MODE_STACK>(g, x, nullptr, nullptr, nullptr, lens, w_in, b_in, w_out,
                                      b_out, dx, xr, dy_scratch, ws, B, H, D, NH, L, ept, grid,
                                      stream);
}
