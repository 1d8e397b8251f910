// One multi-head self-attention layer: forward (B13) and its recompute
// backward (B14), the per-layer attention tier.
//
// B13 replaces two_tower_models_tpu/ops/pallas/fused_mha.py: _fwd_kernel
// with _attend (pallas_call at :297).  x [B, H, D] (bf16 or f32) -> y
// [B, H, D] in x's dtype: qkv = x @ W_in + b_in, per-head softmax attention
// over the keys valid for the example (kj < lens[b]; every key when lens is
// null), then the output projection, for every query row.
//
// B14 replaces _bwd_kernel (pallas_call at :369) and the reduction over its
// sequential grid: from the cotangent g [B, H, D] (x's dtype) it recomputes
// the example's forward and writes dx [B, H, D] in x's dtype and, per
// block, partial f32 grads of W_in [D, 3D], b_in [3D], W_out [D, D] and
// b_out [D]; a second launch (reduce_kernel) sums the partials in block
// order, so the grads are the same on every run.  No float atomics.
//
// Rounding points are the Pallas kernel's (bf16 mode; none in f32 mode):
// round(x) @ round(W_in) + b_in in f32, then q, k, v rounded; a score is
// (q . k) * scale in f32, -1e30 at an invalid key (after the scale, before
// the per-head max); the denominator sums round(e) in f32 and p = e /
// max(denom, 1e-30); round(p) @ v, rounded before round(W_out); y = ... +
// b_out in f32, written in x's dtype.  Backward: g2 = round(g) (g arrives
// in x's dtype, so g2 = g); dW_out += round(out)^T g2, db_out += sum g2;
// do = round(g2 @ round(W_out)^T); dp = do . v; dv = round(round(p)^T do);
// the per-head pdp sum adds round(dp * p) with p unrounded; ds = round(p *
// (dp - pdp) * scale); dq = ds k, dk = ds^T q, all three rounded (dqkv);
// dx = dqkv @ round(W_in)^T; dW_in += round(x)^T dqkv, db_in += sum dqkv.
//
// Bound on the H100: operations in principle (at H = 32, D = 64, NH = 4 an
// example's forward is 1.3 MFLOP against 8 KB of bf16 input and output;
// its backward about twice the forward again), shared-memory loads of FMA
// loops on the CUDA cores in this version; wgmma is later work.  Design: a
// block owns a contiguous run of examples and walks them one at a time,
// every intermediate of an example in shared memory, so x is read and y (or
// dx) written once.  With WSM the layer's weights (and, in B14, f32
// accumulators of the weight grads) are staged in shared memory once per
// block; when they do not fit beside the working set (D = 128: the f32
// W_in alone is 192 KB), the kernel reads the weights from device memory
// (L1/L2-resident), rounding them on load, and B14 accumulates its grads
// in its own slice of the workspace.  The forward's grid is as many blocks
// as fit on the card at once (occupancy times the SM count, at most B);
// the backward's is at most one block per SM (the wrapper picks it, as it
// sizes the workspace).  The rows of qkv in shared memory are 3D+1 floats
// (and, in B14, those of W_in and W_out 3D+1 and D+1), so the loops whose
// threads walk down a column (scores k[kj], dp v[kj], dx = dqkv @ W_in^T,
// do = g2 @ W_out^T) read 32 banks, not one.
//
// B13 on the tensor cores (mha_fwd_tc_kernel) replaces the same
// _fwd_kernel (pallas_call at :297) for bf16 x with D a multiple of 32,
// the head width a multiple of 16 and Hp = round_up(H, 16) <= 64;
// ops/fused_mha.py:_fwd_route sends every other case (f32, head width 8,
// other widths, longer histories) to mha_fwd_kernel above.  The Pallas
// kernel's dots are bf16 x bf16 with f32 accumulation, which is what
// mma.sync m16n8k16 computes, so every product of the layer runs on it at
// the rounding points listed above.
// Bound on the H100: bytes (at B = 4096, H = 32, D = 64 x in and y out are
// 33.5 MB, 0.0100 ms at 3.35 TB/s; the 5.4 GFLOP take 0.0055 ms at the
// bf16 tensor-core rate).  Design:
// - a tile is E examples of Hp rows each (E * Hp = 128 rows at H = 32:
//   E = 4; the Pallas kernel pads H to 16 for bf16 too).  Padded rows are
//   loaded as zeros and never written; a padded key scores -inf, so its
//   p is exactly 0 whatever len is.  The grid is at most the blocks
//   resident at once (the wrapper's plan: two per SM at the cell's
//   shape), each walking its tiles in a persistent loop;
// - round(W_in) [D][3D] and round(W_out) [D][D] are staged as bf16 once
//   per block, b_in and b_out as f32.  Every bf16 row in shared memory is
//   padded by 16 bytes, so the eight rows an ldmatrix reads fall in eight
//   distinct bank groups;
// - x [E*Hp][D] goes to shared memory with cp.async.  One buffer: it is
//   dead once the QKV projection has read it, so the next tile's x is
//   loaded into it then, behind the attention and the output projection
//   (a second buffer would cost 18 KB and the second block per SM);
// - QKV projection [E*Hp, D] x [D, 3D]: each warp owns 32 x 32 tiles; the
//   epilogue adds b_in in f32 and stores q | k | v as bf16.  Each k16
//   step of a projection is summed on its own and added to the running
//   f32 sum in one rounded add: mma.sync adds its products into the
//   accumulator it is given without rounding to nearest, and over D = 64
//   steps of that y had 1.7 times the plain version's values beyond one
//   bf16 step from f64 sums (1.9 times at D = 128; an H100), where the
//   rounded add gives 0.9-1.0 times;
// - attention: a warp takes one (example, head, 16-query band) at a time.
//   S = Q_h K_h^T [16, Hp] over the head width stays in registers (scaled,
//   then -1e30 at keys >= len); the row max and the sum of round(e) are
//   taken across the quad of lanes that share a row; p = e / max(den,
//   1e-30) is rounded and packed from the S accumulators straight into
//   the A operand of P.V (the m16n8 C layout is the k16 A layout), and
//   round(P.V_h) goes over q's slot;
// - output projection [E*Hp, D] x [D, D]: the epilogue adds b_out in f32
//   and stages y as bf16 in k's slot, dead by then, and the block writes
//   the rows < H of each example with 16-byte stores.
// Four barriers a tile (the FMA kernel has six an example); no atomics and
// a fixed order of every sum, so y is the same on every run.
//
// B14 on the tensor cores (mha_bwd_tc_kernel) replaces the same _bwd_kernel
// (pallas_call at :369) for bf16 x with D 32 or 64, the head width a
// multiple of 16 and Hp <= 64 (ops/fused_mha.py:_bwd_route; every other
// case, f32 and D = 128 among them, keeps mha_bwd_kernel), at the rounding
// points listed above, every product on mma.sync m16n8k16.
// Bound on the H100: operations (at B = 4096, H = 32, D = 64, NH = 4 the
// recompute backward is 15.0 GFLOP, 0.0152 ms at the bf16 tensor-core
// rate; g, x and dx are 50 MB, about as long at 3.35 TB/s).  Design:
// - tiles as B13's: E examples of Hp rows, about 128 rows (E = 4 at the
//   cells), padded rows zeros and never written, a padded key -inf; the
//   grid is one block an SM, each walking its tiles in a persistent loop
//   fixed by the plan, so every sum runs in one order;
// - round(W_in), round(W_out) staged as bf16 once per block (rows padded
//   by 16 bytes), b_in as f32; x and g come with cp.async, the next tile's
//   behind dx;
// - a tile: q | k | v as B13 computes them and do = round(g2 round(W_out)^T)
//   (warp_gemm, each k16 step added rounded); then a warp per (example,
//   head) takes every 16-query band: S in registers, the softmax over the
//   quad of lanes that share a row (p kept in f32), round(p) packed
//   straight into P.V's A operand (out = round(P.V_h)), dp = do_h V_h^T,
//   pdp from quad shuffles in the FMA kernel's order, ds = round(p (dp -
//   pdp) scale); round(p) and ds go to the warp's bf16 slabs [Hp][Hp + 8].
//   Then dv = round(round(P)^T do_h) over v, dk = round(dS^T Q_h) over
//   do_h (dead by then), dq = round(dS K_h) over q, dk over k: P^T and dS^T
//   through ldmatrix.trans, each head's columns the warp's own, so no
//   block barrier between heads.  S, dp, P.V, dv, dk and dq are 16-64 deep
//   and accumulate in place;
// - the weight grads sum over all of a block's rows (about 1,000 at the
//   cells): each warp keeps a fixed 16-row slice of dW_in and of dW_out in
//   registers across the tile loop (12 + 4 m16n8 tiles, 64 floats a lane
//   at D = 64; 256 at D = 128, which is why D = 128 stays on the FMA
//   kernel), summing round(x)^T dqkv and out^T g2 a k16 step at a time,
//   each added rounded (tt::mma_bf16_add: mma.sync's own accumulation is
//   not round-to-nearest), A^T through ldmatrix.trans; db_in and db_out a
//   column a thread in f32.  The slices go to ws[block] once, at the end;
//   reduce_kernel sums the blocks in order (no float atomics);
// - dx = dqkv round(W_in)^T (depth 3D), staged as bf16 over the attention
//   output and written with 16-byte stores, rows < H only.
// Shared memory at the cells 201,472 bytes (W 34 KB; x, g2, do, out 18 KB
// each; q | k | v 51 KB; eight slabs 41 KB), so one block an SM and 255
// registers a thread allowed: ptxas gives 199-244 at D = 64 (205 at the
// cells' Hp = 32) and 154-199 at D = 32, no spills.
// The accumulators in shared memory instead (65 KB at D = 64) would have
// needed tiles of 64 rows and a read-modify-write per k16 step.  Five
// barriers a tile.

#include <algorithm>

#include "common.cuh"
#include "mha_tc.cuh"

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ float rnd(float x, bool bf) {
  return bf ? tt::round_bf16(x) : x;
}

__device__ __forceinline__ float load(const void* p, size_t i, bool bf) {
  return bf ? __bfloat162float(((const __nv_bfloat16*)p)[i]) : ((const float*)p)[i];
}

__device__ __forceinline__ void store(void* p, size_t i, float v, bool bf) {
  if (bf) ((__nv_bfloat16*)p)[i] = __float2bfloat16_rn(v);
  else ((float*)p)[i] = v;
}

// C = A @ B, A(m, k) = A[m * sam + k * sak] and B(k, n) = B[k * sbk + n * sbn];
// epi(m, n, c) takes each entry.  A thread computes a TM x TN tile: rows
// m0 .. m0+TM-1 and columns n0 + NT * j, so the threads of a warp read
// neighbouring columns of B and one row of A.  With RB each B operand is
// rounded to bf16 (under bf) as it is loaded: weights read from device
// memory, not staged pre-rounded.
template <int TM, int TN, bool RB, class Epi>
__device__ __forceinline__ void mm(int M, int N, int K, const float* A, int sam,
                                   int sak, const float* Bm, int sbk, int sbn,
                                   bool bf, Epi epi) {
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
      for (int j = 0; j < TN; ++j) {
        const float v = n0 + NT * j < N ? Bm[k * sbk + (n0 + NT * j) * sbn] : 0.0f;
        b[j] = RB ? rnd(v, bf) : v;
      }
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

// s[h][qi][kj] = (q_qi . k_kj over head h) * scale, -1e30 at keys >= len;
// q at QKV[qi * SW], k at QKV[kj * SW + D].
__device__ __forceinline__ void scores(float* s, const float* QKV, int SW, int H,
                                       int D, int NH, int len, float scale) {
  const int hd = D / NH;
  for (int i = threadIdx.x; i < NH * H * H; i += THREADS) {
    const int h = i / (H * H), qi = (i / H) % H, kj = i % H;
    const float* qp = QKV + qi * SW + h * hd;
    const float* kp = QKV + kj * SW + D + h * hd;
    float acc = 0.0f;
    for (int c = 0; c < hd; ++c) acc = fmaf(qp[c], kp[c], acc);
    s[i] = kj < len ? acc * scale : -1e30f;
  }
}

// Per-head softmax of each row of s [NH*H][H], a warp a row, into p: p =
// e / max(sum round(e), 1e-30), rounded (RP) or f32.  p may be s.
template <bool RP>
__device__ __forceinline__ void softmax(float* p, float* s, int rows, int H, bool bf) {
  const int lane = threadIdx.x % 32;
  for (int row = threadIdx.x / 32; row < rows; row += THREADS / 32) {
    float* sr = s + row * H;
    float* pr = p + row * H;
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
      const float v = sr[kj] / den;
      pr[kj] = RP ? rnd(v, bf) : v;
    }
  }
}

template <bool WSM>
__global__ void __launch_bounds__(THREADS)
mha_fwd_kernel(const void* __restrict__ x_in, const int* __restrict__ lens,
               const float* __restrict__ w_in, const float* __restrict__ b_in,
               const float* __restrict__ w_out, const float* __restrict__ b_out,
               void* __restrict__ y_out, int B, int H, int D, int NH, int bf,
               int epb, float scale) {
  extern __shared__ float smem[];
  const int D3 = 3 * D, hd = D / NH, SW = D3 + 1;
  const int t = threadIdx.x;
  // WSM: round(W_in) [D][3D], b_in [3D], round(W_out) [D][D], b_out [D]
  const size_t wfl = WSM ? (size_t)D * D3 + D3 + (size_t)D * D + D : 0;
  if (WSM) {
    float* sw = smem;
    for (int i = t; i < D * D3; i += THREADS) sw[i] = rnd(w_in[i], bf);
    for (int i = t; i < D3; i += THREADS) sw[D * D3 + i] = b_in[i];
    for (int i = t; i < D * D; i += THREADS) sw[D * D3 + D3 + i] = rnd(w_out[i], bf);
    for (int i = t; i < D; i += THREADS) sw[D * D3 + D3 + D * D + i] = b_out[i];
  }
  const float* wi = WSM ? smem : w_in;
  const float* bi = WSM ? smem + D * D3 : b_in;
  const float* wo = WSM ? smem + D * D3 + D3 : w_out;
  const float* bo = WSM ? smem + D * D3 + D3 + D * D : b_out;
  float* QKV = smem + wfl;   // [H][SW] q | k | v; the attention output over q
  float* XS = QKV + H * SW;  // [max(H*D, NH*H*H)] round(x), then scores -> p
  const int e0 = blockIdx.x * epb;
  const int ne = min(epb, B - e0);

  for (int e = 0; e < ne; ++e) {
    const size_t ex = (size_t)(e0 + e);
    const int len = lens ? lens[ex] : H;
    __syncthreads();  // weights staged / the previous example's readers done
    for (int i = t; i < H * D; i += THREADS) XS[i] = load(x_in, ex * H * D + i, bf);
    __syncthreads();
    mm<2, 6, !WSM>(H, D3, D, XS, D, 1, wi, D3, 1, bf, [&](int r, int j, float v) {
      QKV[r * SW + j] = rnd(v + bi[j], bf);
    });
    __syncthreads();
    scores(XS, QKV, SW, H, D, NH, len, scale);
    __syncthreads();
    softmax<true>(XS, XS, NH * H, H, bf);
    __syncthreads();
    // out[qi][c] = round(sum_kj p[h(c)][qi][kj] * v[kj][c]) into q's slot
    // (q is dead once the scores are taken)
    for (int i = t; i < H * D; i += THREADS) {
      const int qi = i / D, c = i - qi * D, h = c / hd;
      const float* pr = XS + (h * H + qi) * H;
      float acc = 0.0f;
      for (int kj = 0; kj < H; ++kj) acc = fmaf(pr[kj], QKV[kj * SW + 2 * D + c], acc);
      QKV[qi * SW + c] = rnd(acc, bf);
    }
    __syncthreads();
    mm<2, 2, !WSM>(H, D, D, QKV, SW, 1, wo, D, 1, bf, [&](int qi, int j, float v) {
      store(y_out, ex * H * D + qi * D + j, v + bo[j], bf);
    });
  }
}

template <bool WSM>
__global__ void __launch_bounds__(THREADS)
mha_bwd_kernel(const void* __restrict__ g_in, const void* __restrict__ x_in,
               const int* __restrict__ lens, const float* __restrict__ w_in,
               const float* __restrict__ b_in, const float* __restrict__ w_out,
               void* __restrict__ dx_out, float* __restrict__ ws, int B, int H,
               int D, int NH, int bf, int epb, float scale) {
  extern __shared__ float smem[];
  const int D3 = 3 * D, hd = D / NH, SW = D3 + 1;
  const int SWI = WSM ? D3 + 1 : D3, SWO = WSM ? D + 1 : D;  // W_in, W_out row strides
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const size_t n_grads = (size_t)D * D3 + D3 + (size_t)D * D + D;
  float* wsb = ws + (size_t)blockIdx.x * n_grads;  // this block's partial grads
  // WSM: round(W_in) [D][SWI], b_in [3D], round(W_out) [D][SWO], then the
  // accumulators dW_in [D][3D], db_in [3D], dW_out [D][D], db_out [D]
  float* acc = smem + (size_t)D * SWI + D3 + (size_t)D * SWO;
  if (WSM) {
    for (int i = t; i < D * D3; i += THREADS) smem[(i / D3) * SWI + i % D3] = rnd(w_in[i], bf);
    for (int i = t; i < D3; i += THREADS) smem[D * SWI + i] = b_in[i];
    for (int i = t; i < D * D; i += THREADS)
      smem[D * SWI + D3 + (i / D) * SWO + i % D] = rnd(w_out[i], bf);
  }
  const float* wi = WSM ? smem : w_in;
  const float* bi = WSM ? smem + D * SWI : b_in;
  const float* wo = WSM ? smem + D * SWI + D3 : w_out;
  float* dwi = WSM ? acc : wsb;
  float* dbi = dwi + D * D3;
  float* dwo = dbi + D3;
  float* dbo = dwo + D * D;
  for (size_t i = t; i < n_grads; i += THREADS) dwi[i] = 0.0f;
  float* X = WSM ? acc + n_grads : smem;  // [H][D]  round(x)
  float* QKV = X + H * D;                 // [H][SW] q | k | v, later dq | dk | dv
  float* P = QKV + H * SW;                // [NH][H][H] probabilities, f32
  float* S = P + NH * H * H;              // [NH][H][H] scores -> dp -> ds
  float* A = S + NH * H * H;              // [H][D]  out -> do -> dq
  float* G = A + H * D;                   // [H][D]  g2 -> dk
  const int e0 = blockIdx.x * epb;
  const int ne = min(epb, B - e0);

  for (int e = 0; e < ne; ++e) {
    const size_t ex = (size_t)(e0 + e);
    const int len = lens ? lens[ex] : H;
    __syncthreads();  // staging and zeroing done / the previous example's readers done
    for (int i = t; i < H * D; i += THREADS) {
      X[i] = load(x_in, ex * H * D + i, bf);
      G[i] = load(g_in, ex * H * D + i, bf);
    }
    __syncthreads();
    // the forward: qkv, scores, p (f32), out = round(round(p) @ v)
    mm<2, 6, !WSM>(H, D3, D, X, D, 1, wi, SWI, 1, bf, [&](int r, int j, float v) {
      QKV[r * SW + j] = rnd(v + bi[j], bf);
    });
    __syncthreads();
    scores(S, QKV, SW, H, D, NH, len, scale);
    __syncthreads();
    softmax<false>(P, S, NH * H, H, bf);
    __syncthreads();
    for (int i = t; i < H * D; i += THREADS) {
      const int qi = i / D, c = i - qi * D, h = c / hd;
      const float* pr = P + (h * H + qi) * H;
      float s = 0.0f;
      for (int kj = 0; kj < H; ++kj) s = fmaf(rnd(pr[kj], bf), QKV[kj * SW + 2 * D + c], s);
      A[i] = rnd(s, bf);
    }
    __syncthreads();
    // output projection: db_out += sum g2; dW_out += out^T g2
    for (int j = t; j < D; j += THREADS) {
      float s = dbo[j];
      for (int qi = 0; qi < H; ++qi) s += G[qi * D + j];
      dbo[j] = s;
    }
    mm<2, 4, false>(D, D, H, A, 1, D, G, D, 1, bf, [&](int c, int j, float v) {
      dwo[c * D + j] += v;
    });
    __syncthreads();
    // do = round(g2 @ round(W_out)^T) into A
    mm<2, 2, !WSM>(H, D, D, G, D, 1, wo, 1, SWO, bf, [&](int qi, int c, float v) {
      A[qi * D + c] = rnd(v, bf);
    });
    __syncthreads();
    // dp[h][qi][kj] = do[qi] . v[kj] over head h's columns
    for (int i = t; i < NH * H * H; i += THREADS) {
      const int h = i / (H * H), qi = (i / H) % H, kj = i % H;
      const float* dr = A + qi * D + h * hd;
      const float* vr = QKV + kj * SW + 2 * D + h * hd;
      float s = 0.0f;
      for (int c = 0; c < hd; ++c) s = fmaf(dr[c], vr[c], s);
      S[i] = s;
    }
    __syncthreads();
    // dv[kj][c] = round(sum_qi round(p[h(c)][qi][kj]) do[qi][c]) into v's slot
    for (int i = t; i < H * D; i += THREADS) {
      const int kj = i / D, c = i - kj * D, h = c / hd;
      float s = 0.0f;
      for (int qi = 0; qi < H; ++qi)
        s = fmaf(rnd(P[(h * H + qi) * H + kj], bf), A[qi * D + c], s);
      QKV[kj * SW + 2 * D + c] = rnd(s, bf);
    }
    // ds = round(p * (dp - sum_kj round(dp * p)) * scale), a warp a row
    for (int row = warp; row < NH * H; row += THREADS / 32) {
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
    // dq[qi][c] = round(sum_kj ds k) into A; dk[kj][c] = round(sum_qi ds q) into G
    for (int i = t; i < H * D; i += THREADS) {
      const int r = i / D, c = i - r * D, h = c / hd;
      const float* sr = S + (h * H + r) * H;
      float sq = 0.0f, sk = 0.0f;
      for (int j = 0; j < H; ++j) {
        sq = fmaf(sr[j], QKV[j * SW + D + c], sq);
        sk = fmaf(S[(h * H + j) * H + r], QKV[j * SW + c], sk);
      }
      A[i] = rnd(sq, bf);
      G[i] = rnd(sk, bf);
    }
    __syncthreads();
    for (int i = t; i < H * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      QKV[r * SW + c] = A[i];
      QKV[r * SW + D + c] = G[i];
    }
    __syncthreads();
    // dx = dqkv @ round(W_in)^T; dW_in += round(x)^T dqkv; db_in += sum dqkv
    mm<2, 2, !WSM>(H, D, D3, QKV, SW, 1, wi, 1, SWI, bf, [&](int r, int d, float v) {
      store(dx_out, ex * H * D + r * D + d, v, bf);
    });
    mm<4, 6, false>(D, D3, H, X, 1, D, QKV, SW, 1, bf, [&](int d, int j, float v) {
      dwi[d * D3 + j] += v;
    });
    for (int j = t; j < D3; j += THREADS) {
      float s = dbi[j];
      for (int r = 0; r < H; ++r) s += QKV[r * SW + j];
      dbi[j] = s;
    }
  }
  if (!WSM) return;
  __syncthreads();
  for (size_t i = t; i < n_grads; i += THREADS) wsb[i] = dwi[i];
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

namespace tc {

// bf16, PAD, TILE_ROWS, warp_gemm, load_x, row_den and band_attention
using namespace tt::tc;
constexpr int THREADS = 256;  // eight warps; two blocks per SM at the cell's shape
constexpr int WARPS = THREADS / 32;

// HPB = Hp / 16: the key bands of one example, and the S accumulators a
// lane holds (8 HPB floats).
template <int HPB>
__global__ void __launch_bounds__(THREADS, 2)
mha_fwd_tc_kernel(const bf16* __restrict__ x, const int* __restrict__ lens,
                  const float* __restrict__ w_in, const float* __restrict__ b_in,
                  const float* __restrict__ w_out, const float* __restrict__ b_out,
                  bf16* __restrict__ y, int B, int H, int D, int NH, int E, float scale) {
  constexpr int Hp = 16 * HPB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D3 = 3 * D, hd = D / NH, rows = E * Hp;
  const int SWI = D3 + PAD, SWO = D + PAD, SX = D + PAD, SQ = D3 + PAD;
  bf16* Wi = (bf16*)smem_raw;              // [D][SWI] round(W_in)
  bf16* Wo = Wi + D * SWI;                 // [D][SWO] round(W_out)
  bf16* X = Wo + D * SWO;                  // [rows][SX] x of the tile
  bf16* QKV = X + rows * SX;               // [rows][SQ] q | k | v; attention out over q, y over k
  float* bi = (float*)(QKV + rows * SQ);   // [3D]
  float* bo = bi + D3;                     // [D]
  __shared__ int sl[TILE_ROWS / 16];  // the tile's lengths
  const int t = threadIdx.x, warp = t / 32;
  const int tiles = (B + E - 1) / E;
  // thread t < E holds the length of example t of the next tile in len_next,
  // loaded beside that tile's x so its latency hides behind the compute
  auto tile_len = [&](int tile) {
    const int ex = tile * E + t;
    return t < E && lens && ex < B ? lens[ex] : H;
  };

  int len_next = tile_len(blockIdx.x);
  if ((int)blockIdx.x < tiles) load_x(X, x, blockIdx.x, E, Hp, H, D, B);
  tt::cp_commit();
  // the weights as bf16, 16 bytes a load (rows of 3D and D floats, both
  // multiples of 4; the wrapper passes 16-byte aligned weights)
  for (int i = t; i < D * D3 / 4; i += THREADS) {
    const float4 v = ((const float4*)w_in)[i];
    *(uint2*)(Wi + (4 * i / D3) * SWI + 4 * i % D3) =
        make_uint2(tt::pack_bf16x2(v.x, v.y), tt::pack_bf16x2(v.z, v.w));
  }
  for (int i = t; i < D * D / 4; i += THREADS) {
    const float4 v = ((const float4*)w_out)[i];
    *(uint2*)(Wo + (4 * i / D) * SWO + 4 * i % D) =
        make_uint2(tt::pack_bf16x2(v.x, v.y), tt::pack_bf16x2(v.z, v.w));
  }
  for (int i = t; i < D3; i += THREADS) bi[i] = b_in[i];
  for (int i = t; i < D; i += THREADS) bo[i] = b_out[i];

  for (int tile = blockIdx.x; tile < tiles; tile += (int)gridDim.x) {
    if (t < E) sl[t] = len_next;
    tt::cp_wait<0>();
    __syncthreads();  // x landed, lengths and weights staged, the previous tile's y written out
    warp_gemm<4>(rows, D3, D, X, SX, Wi, SWI, [&](int r, int c, float v0, float v1) {
      *(unsigned*)(QKV + r * SQ + c) = tt::pack_bf16x2(v0 + bi[c], v1 + bi[c + 1]);
    });
    __syncthreads();  // qkv complete; x is dead
    if (tile + (int)gridDim.x < tiles) {
      load_x(X, x, tile + gridDim.x, E, Hp, H, D, B);
      len_next = tile_len(tile + gridDim.x);
    }
    tt::cp_commit();

    // attention, a warp per (example, head, band of 16 queries)
    for (int u = warp; u < E * NH * HPB; u += WARPS) {
      const int e = u / (NH * HPB), h = (u / HPB) % NH, qb = u % HPB;
      const int ex = tile * E + e;
      if (ex >= B) continue;
      const int len = sl[e];
      bf16* QO = QKV + (e * Hp + qb * 16) * SQ + h * hd;
      const bf16* K = QKV + e * Hp * SQ + D + h * hd;
      band_attention<HPB>(QO, K, K + D, SQ, hd, H, len, scale, [](const unsigned(&)[HPB][4]) {});
    }
    __syncthreads();  // the attention output is complete; k and v are dead

    warp_gemm<2>(rows, D, D, QKV, SQ, Wo, SWO, [&](int r, int c, float v0, float v1) {
      *(unsigned*)(QKV + r * SQ + D + c) = tt::pack_bf16x2(v0 + bo[c], v1 + bo[c + 1]);
    });
    __syncthreads();  // y staged
    const int cpr = D / 8;
    for (int i = t; i < rows * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      const int ex = tile * E + r / Hp, hi = r % Hp;
      if (ex < B && hi < H)
        *(uint4*)(y + ((size_t)ex * H + hi) * D + c * 8) = *(const uint4*)(QKV + r * SQ + D + c * 8);
    }
  }
  tt::cp_wait<0>();
}

// Shared memory of one block in bytes (ops/fused_mha.py:_fwd_tc_smem_bytes).
size_t smem_bytes(int rows, int D) {
  return 2 * ((size_t)D * (3 * D + PAD) + (size_t)D * (D + PAD) + (size_t)rows * (D + PAD) +
              (size_t)rows * (3 * D + PAD)) +
         16 * (size_t)D;
}

template <int HPB>
int launch(const void* x, const void* lens, const void* w_in, const void* b_in,
           const void* w_out, const void* b_out, void* y, int B, int H, int D, int NH, int E,
           int grid, float scale, void* stream) {
  const size_t smem = smem_bytes(E * 16 * HPB, D);
  cudaError_t err = cudaFuncSetAttribute(mha_fwd_tc_kernel<HPB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mha_fwd_tc_kernel<HPB><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const int*)lens, (const float*)w_in, (const float*)b_in,
      (const float*)w_out, (const float*)b_out, (bf16*)y, B, H, D, NH, E, scale);
  return (int)cudaGetLastError();
}

// ---- B14 on the tensor cores ----------------------------------------------

// The sum over one row of a lane quad's values f(j, c) (c = 0, 1: the
// row's two columns of n-tile j) in row_den's order, so in the FMA
// kernel's: a lane per key kj < 32 holds f at kj and kj + 32, then a
// butterfly over the 32 lanes at offsets 16, 8, 4, 2, 1.
template <int HPB, class F>
__device__ __forceinline__ float row_sum(F f) {
  float a[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      a[j][c] = j < 2 * HPB ? f(j, c) : 0.0f;
      if (j + 4 < 2 * HPB) a[j][c] += f(j + 4, c);
    }
  float u[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    u[c] = (a[0][c] + a[2][c]) + (a[1][c] + a[3][c]);
    u[c] += __shfl_xor_sync(0xffffffffu, u[c], 2);
    u[c] += __shfl_xor_sync(0xffffffffu, u[c], 1);
  }
  return u[0] + u[1];
}

// The two m16n8 accumulators of a 16 x 16 product, rounded to bf16, at dst
// (row stride ld): rows g and g + 8, columns 8j + 2q4 and the next.
__device__ __forceinline__ void store_c16(bf16* dst, int ld, const float (&o)[2][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    *(unsigned*)(dst + g * ld + 8 * j + 2 * q4) = tt::pack_bf16x2(o[j][0], o[j][1]);
    *(unsigned*)(dst + (g + 8) * ld + 8 * j + 2 * q4) = tt::pack_bf16x2(o[j][2], o[j][3]);
  }
}

// acc [16, 8 NTT] += A[0 : rows, m0 : m0 + 16]^T . Bm[0 : rows, n0 : n0 + 8 NTT],
// A and Bm bf16 by row in shared memory (strides sa, sb), rows a multiple
// of 16: a sum over rows, so A^T is read through ldmatrix.trans.  Each k16
// step (16 rows) is summed on its own and added rounded (tt::mma_bf16_add).
template <int NTT>
__device__ __forceinline__ void warp_gemm_tn(float (&acc)[NTT][4], int rows, const bf16* A,
                                             int sa, int m0, const bf16* Bm, int sb, int n0) {
  const int lane = threadIdx.x % 32;
#pragma unroll 1
  for (int k0 = 0; k0 < rows; k0 += 16) {
    unsigned a[4];  // a0 (m 0-7, k 0-7), a1 (m 8-15, k 0-7), a2 (m 0-7, k 8-15), a3
    tt::ldmatrix_x4<true>(a, A + (k0 + lane % 8 + (lane / 16) * 8) * sa + m0 + ((lane / 8) % 2) * 8);
    const bf16* brow = Bm + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * sb + n0;
#pragma unroll
    for (int j = 0; j + 1 < NTT; j += 2) {
      unsigned b[4];
      tt::ldmatrix_x4<true>(b, brow + 8 * j + (lane / 16) * 8);
      tt::mma_bf16_add(acc[j], a, b[0], b[1]);
      tt::mma_bf16_add(acc[j + 1], a, b[2], b[3]);
    }
    if constexpr (NTT % 2 == 1) {
      unsigned b[2];
      tt::ldmatrix_x2<true>(b, brow + 8 * (NTT - 1));
      tt::mma_bf16_add(acc[NTT - 1], a, b[0], b[1]);
    }
  }
}

// Shared memory of one backward block in bytes
// (ops/fused_mha.py:_bwd_tc_smem_bytes): bf16 round(W_in) [D][3D],
// round(W_out) [D][D], x, g2, do and the attention output [rows][D] each,
// q | k | v [rows][3D], each row padded by 8 bf16; min(8, E * D / 16) warp
// slabs of round(p) and ds [Hp][Hp + 8] each; f32 b_in [3D].
size_t bwd_smem_bytes(int rows, int Hp, int D) {
  const size_t slabs = std::min(WARPS, rows / Hp * (D / 16));
  return 2 * ((size_t)D * (3 * D + PAD) + (size_t)D * (D + PAD) + 4 * (size_t)rows * (D + PAD) +
              (size_t)rows * (3 * D + PAD) + slabs * 2 * Hp * (Hp + PAD)) +
         12 * (size_t)D;
}

// HPB = Hp / 16 as in the forward; D the width (32 or 64), so that each
// warp's slice of the weight grads has a fixed shape in registers.
template <int HPB, int D>
__global__ void __launch_bounds__(THREADS, 1)
mha_bwd_tc_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
                  const int* __restrict__ lens, const float* __restrict__ w_in,
                  const float* __restrict__ b_in, const float* __restrict__ w_out,
                  bf16* __restrict__ dx, float* __restrict__ ws, int B, int H, int NH, int E,
                  float scale) {
  constexpr int Hp = 16 * HPB, D3 = 3 * D;
  constexpr int SWI = D3 + PAD, SWO = D + PAD, SX = D + PAD, SQ = D3 + PAD, SP = Hp + PAD;
  constexpr int RB = D / 16;                   // 16-row blocks of dW_in and dW_out
  constexpr int NTI = 3 * D * D / 1024;        // n8 tiles of dW_in a warp owns
  constexpr int NTO = D * D / 1024;            // and of dW_out
  constexpr int NTG = D >= 64 ? 4 : 2;         // warp tile width / 8 of the D-wide products
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = D / NH, rows = E * Hp;
  bf16* Wi = (bf16*)smem_raw;         // [D][SWI] round(W_in)
  bf16* Wo = Wi + D * SWI;            // [D][SWO] round(W_out)
  bf16* X = Wo + D * SWO;             // [rows][SX] x of the tile
  bf16* G = X + rows * SX;            // [rows][SX] g2
  bf16* DO = G + rows * SX;           // [rows][SX] do; dk of each (example, head) after dv
  bf16* OUT = DO + rows * SX;         // [rows][SX] the attention output; dx staged after
  bf16* QKV = OUT + rows * SX;        // [rows][SQ] q | k | v, then dq | dk | dv
  bf16* SL = QKV + rows * SQ;         // [warp][2][Hp][SP] round(p), ds
  float* bi = (float*)(SL + min(WARPS, E * RB) * 2 * Hp * SP);  // [3D]
  __shared__ int sl[TILE_ROWS / 16];  // the tile's lengths
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, gq = lane / 4, q4 = lane % 4;
  const int tiles = (B + E - 1) / E;
  auto tile_len = [&](int tile) {
    const int ex = tile * E + t;
    return t < E && lens && ex < B ? lens[ex] : H;
  };

  int len_next = tile_len(blockIdx.x);
  load_x(X, x, blockIdx.x, E, Hp, H, D, B);  // the plan gives every block a tile
  load_x(G, g, blockIdx.x, E, Hp, H, D, B);
  tt::cp_commit();
  for (int i = t; i < D * D3 / 4; i += THREADS) {
    const float4 v = ((const float4*)w_in)[i];
    *(uint2*)(Wi + (4 * i / D3) * SWI + 4 * i % D3) =
        make_uint2(tt::pack_bf16x2(v.x, v.y), tt::pack_bf16x2(v.z, v.w));
  }
  for (int i = t; i < D * D / 4; i += THREADS) {
    const float4 v = ((const float4*)w_out)[i];
    *(uint2*)(Wo + (4 * i / D) * SWO + 4 * i % D) =
        make_uint2(tt::pack_bf16x2(v.x, v.y), tt::pack_bf16x2(v.z, v.w));
  }
  for (int i = t; i < D3; i += THREADS) bi[i] = b_in[i];

  // this warp's slice of the weight grads, in registers across the tiles:
  // rows m0 .. m0 + 15 of dW_in (columns ni0 ..) and of dW_out (no0 ..)
  const int m0 = 16 * (warp % RB), ni0 = (warp / RB) * 8 * NTI, no0 = (warp / RB) * 8 * NTO;
  float gi[NTI][4], go[NTO][4];
#pragma unroll
  for (int j = 0; j < NTI; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) gi[j][c] = 0.0f;
#pragma unroll
  for (int j = 0; j < NTO; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) go[j][c] = 0.0f;
  float gb = 0.0f;  // thread t < 4D: column t of [db_in | db_out]

  for (int tile = blockIdx.x; tile < tiles; tile += (int)gridDim.x) {
    const int next = tile + (int)gridDim.x;
    if (t < E) sl[t] = len_next;
    tt::cp_wait<0>();
    __syncthreads();  // x and g landed, lengths and weights staged, the previous dx written out
    warp_gemm<4>(rows, D3, D, X, SX, Wi, SWI, [&](int r, int c, float v0, float v1) {
      *(unsigned*)(QKV + r * SQ + c) = tt::pack_bf16x2(v0 + bi[c], v1 + bi[c + 1]);
    });
    warp_gemm<NTG, true>(rows, D, D, G, SX, Wo, SWO, [&](int r, int c, float v0, float v1) {
      *(unsigned*)(DO + r * SX + c) = tt::pack_bf16x2(v0, v1);
    });
    if (next < tiles) len_next = tile_len(next);
    __syncthreads();  // q | k | v and do complete

    // attention, a warp per (example, head): every query band, then dv,
    // dk and dq from the warp's slabs
    for (int u = warp; u < E * NH; u += WARPS) {
      const int e = u / NH, h = u - e * NH, len = sl[e];
      bf16* Qh = QKV + e * Hp * SQ + h * hd;
      bf16* Kh = Qh + D;
      bf16* Vh = Qh + 2 * D;
      bf16* Dh = DO + e * Hp * SX + h * hd;
      bf16* Oh = OUT + e * Hp * SX + h * hd;
      bf16* Ps = SL + warp * 2 * Hp * SP;  // round(p) [Hp][SP]
      bf16* Ss = Ps + Hp * SP;             // ds [Hp][SP]
      for (int qb = 0; qb < HPB; ++qb) {
        float s[2 * HPB][4];
#pragma unroll
        for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
        for (int c0 = 0; c0 < hd; c0 += 16) {
          unsigned a[4];
          tt::ldmatrix_x4<false>(a, Qh + (qb * 16 + lane % 16) * SQ + c0 + (lane / 16) * 8);
#pragma unroll
          for (int jp = 0; jp < HPB; ++jp) {
            unsigned b[4];
            tt::ldmatrix_x4<false>(
                b, Kh + (jp * 16 + lane % 8 + (lane / 16) * 8) * SQ + c0 + ((lane / 8) % 2) * 8);
            tt::mma_bf16(s[2 * jp], a, b[0], b[1]);
            tt::mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
          }
        }
        // the forward's softmax, as mha_fwd_tc_kernel computes it; p stays f32
        float m0r = -INFINITY, m1r = -INFINITY;
#pragma unroll
        for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = 8 * j + 2 * q4 + (c & 1);
            s[j][c] = key >= H ? -INFINITY : key < len ? s[j][c] * scale : -1e30f;
            if (c < 2) m0r = fmaxf(m0r, s[j][c]);
            else m1r = fmaxf(m1r, s[j][c]);
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          m0r = fmaxf(m0r, __shfl_xor_sync(0xffffffffu, m0r, off));
          m1r = fmaxf(m1r, __shfl_xor_sync(0xffffffffu, m1r, off));
        }
#pragma unroll
        for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = expf(s[j][c] - (c < 2 ? m0r : m1r));
        const float d0 = fmaxf(row_den<HPB>(s, 0), 1e-30f);
        const float d1 = fmaxf(row_den<HPB>(s, 2), 1e-30f);
#pragma unroll
        for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float ev = s[j][c];  // a masked key's e is 0: skip the slow division
            s[j][c] = ev == 0.0f ? 0.0f : ev / (c < 2 ? d0 : d1);
          }
        // round(p): P.V's A operand, and its band of the slab for dv
        unsigned pa[HPB][4];
#pragma unroll
        for (int kk = 0; kk < HPB; ++kk) {
          pa[kk][0] = tt::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
          pa[kk][1] = tt::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
          pa[kk][2] = tt::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[kk][3] = tt::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          bf16* pr = Ps + (qb * 16 + gq) * SP + 16 * kk + 2 * q4;
          *(unsigned*)pr = pa[kk][0];
          *(unsigned*)(pr + 8 * SP) = pa[kk][1];
          *(unsigned*)(pr + 8) = pa[kk][2];
          *(unsigned*)(pr + 8 * SP + 8) = pa[kk][3];
        }
        // out = round(P.V_h)
        for (int c0 = 0; c0 < hd; c0 += 16) {
          float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int kk = 0; kk < HPB; ++kk) {
            unsigned b[4];
            tt::ldmatrix_x4<true>(
                b, Vh + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * SQ + c0 + (lane / 16) * 8);
            tt::mma_bf16(o[0], pa[kk], b[0], b[1]);
            tt::mma_bf16(o[1], pa[kk], b[2], b[3]);
          }
          store_c16(Oh + qb * 16 * SX + c0, SX, o);
        }
        // dp = do_h V_h^T, f32
        float dp[2 * HPB][4];
#pragma unroll
        for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) dp[j][c] = 0.0f;
        for (int c0 = 0; c0 < hd; c0 += 16) {
          unsigned a[4];
          tt::ldmatrix_x4<false>(a, Dh + (qb * 16 + lane % 16) * SX + c0 + (lane / 16) * 8);
#pragma unroll
          for (int jp = 0; jp < HPB; ++jp) {
            unsigned b[4];
            tt::ldmatrix_x4<false>(
                b, Vh + (jp * 16 + lane % 8 + (lane / 16) * 8) * SQ + c0 + ((lane / 8) % 2) * 8);
            tt::mma_bf16(dp[2 * jp], a, b[0], b[1]);
            tt::mma_bf16(dp[2 * jp + 1], a, b[2], b[3]);
          }
        }
        // pdp, the row sums of round(dp p); ds = round(p (dp - pdp) scale) to the slab
        const float r0 = row_sum<HPB>(
            [&](int j, int c) { return tt::round_bf16(dp[j][c] * s[j][c]); });
        const float r1 = row_sum<HPB>(
            [&](int j, int c) { return tt::round_bf16(dp[j][2 + c] * s[j][2 + c]); });
#pragma unroll
        for (int j = 0; j < 2 * HPB; ++j) {
          bf16* sr = Ss + (qb * 16 + gq) * SP + 8 * j + 2 * q4;
          *(unsigned*)sr = tt::pack_bf16x2(s[j][0] * (dp[j][0] - r0) * scale,
                                          s[j][1] * (dp[j][1] - r0) * scale);
          *(unsigned*)(sr + 8 * SP) = tt::pack_bf16x2(s[j][2] * (dp[j][2] - r1) * scale,
                                                     s[j][3] * (dp[j][3] - r1) * scale);
        }
      }
      __syncwarp();
      // dv_h = round(round(P)^T do_h) over v's columns (v is dead); P^T and
      // dS^T are read from the slabs through ldmatrix.trans
      for (int kb = 0; kb < HPB; ++kb)
        for (int c0 = 0; c0 < hd; c0 += 16) {
          float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int qb = 0; qb < HPB; ++qb) {
            unsigned a[4], b[4];
            tt::ldmatrix_x4<true>(
                a, Ps + (qb * 16 + lane % 8 + (lane / 16) * 8) * SP + kb * 16 + ((lane / 8) % 2) * 8);
            tt::ldmatrix_x4<true>(
                b, Dh + (qb * 16 + lane % 8 + ((lane / 8) % 2) * 8) * SX + c0 + (lane / 16) * 8);
            tt::mma_bf16(o[0], a, b[0], b[1]);
            tt::mma_bf16(o[1], a, b[2], b[3]);
          }
          store_c16(Vh + kb * 16 * SQ + c0, SQ, o);
        }
      __syncwarp();
      // dk_h = round(dS^T Q_h) over do_h (dead once dv is taken)
      for (int kb = 0; kb < HPB; ++kb)
        for (int c0 = 0; c0 < hd; c0 += 16) {
          float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int qb = 0; qb < HPB; ++qb) {
            unsigned a[4], b[4];
            tt::ldmatrix_x4<true>(
                a, Ss + (qb * 16 + lane % 8 + (lane / 16) * 8) * SP + kb * 16 + ((lane / 8) % 2) * 8);
            tt::ldmatrix_x4<true>(
                b, Qh + (qb * 16 + lane % 8 + ((lane / 8) % 2) * 8) * SQ + c0 + (lane / 16) * 8);
            tt::mma_bf16(o[0], a, b[0], b[1]);
            tt::mma_bf16(o[1], a, b[2], b[3]);
          }
          store_c16(Dh + kb * 16 * SX + c0, SX, o);
        }
      __syncwarp();
      // dq_h = round(dS K_h) over q's columns (q is dead once dk is taken)
      for (int qb = 0; qb < HPB; ++qb)
        for (int c0 = 0; c0 < hd; c0 += 16) {
          float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int kk = 0; kk < HPB; ++kk) {
            unsigned a[4], b[4];
            tt::ldmatrix_x4<false>(a, Ss + (qb * 16 + lane % 16) * SP + kk * 16 + (lane / 16) * 8);
            tt::ldmatrix_x4<true>(
                b, Kh + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * SQ + c0 + (lane / 16) * 8);
            tt::mma_bf16(o[0], a, b[0], b[1]);
            tt::mma_bf16(o[1], a, b[2], b[3]);
          }
          store_c16(Qh + qb * 16 * SQ + c0, SQ, o);
        }
      __syncwarp();
      // dk over k's columns (k is dead once dq is taken)
      for (int i = lane; i < Hp * hd / 8; i += 32) {
        const int r = i / (hd / 8), c = 8 * (i - r * (hd / 8));
        *(uint4*)(Kh + r * SQ + c) = *(const uint4*)(Dh + r * SX + c);
      }
      __syncwarp();  // the slabs are free for this warp's next (example, head)
    }
    __syncthreads();  // dq | dk | dv and the attention output complete

    // the weight grads: dW_in += round(x)^T dqkv, dW_out += out^T g2 (this
    // warp's slices), db_in += sum dqkv, db_out += sum g2 (a column a thread)
    warp_gemm_tn<NTI>(gi, rows, X, SX, m0, QKV, SQ, ni0);
    warp_gemm_tn<NTO>(go, rows, OUT, SX, m0, G, SX, no0);
    if (t < 4 * D) {
      const bf16* col = t < D3 ? QKV + t : G + (t - D3);
      const int ld = t < D3 ? SQ : SX;
      float c4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int r = 0; r < rows; r += 4)
#pragma unroll
        for (int i = 0; i < 4; ++i) c4[i] += __bfloat162float(col[(r + i) * ld]);
      gb += (c4[0] + c4[1]) + (c4[2] + c4[3]);
    }
    __syncthreads();  // x, g2 and the attention output read
    if (next < tiles) {
      load_x(X, x, next, E, Hp, H, D, B);
      load_x(G, g, next, E, Hp, H, D, B);
    }
    tt::cp_commit();
    // dx = dqkv round(W_in)^T (depth 3D), staged as bf16 over the attention output
    warp_gemm<NTG, true>(rows, D, D3, QKV, SQ, Wi, SWI, [&](int r, int c, float v0, float v1) {
      *(unsigned*)(OUT + r * SX + c) = tt::pack_bf16x2(v0, v1);
    });
    __syncthreads();  // dx staged
    const int cpr = D / 8;
    for (int i = t; i < rows * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      const int ex = tile * E + r / Hp, hi = r % Hp;
      if (ex < B && hi < H)
        *(uint4*)(dx + ((size_t)ex * H + hi) * D + c * 8) = *(const uint4*)(OUT + r * SX + c * 8);
    }
  }
  tt::cp_wait<0>();

  // this block's partials: dW_in [D][3D], db_in [3D], dW_out [D][D], db_out [D]
  float* wsb = ws + (size_t)blockIdx.x * (4 * D * D + 4 * D);
#pragma unroll
  for (int j = 0; j < NTI; ++j) {
    float* p = wsb + (m0 + gq) * D3 + ni0 + 8 * j + 2 * q4;
    *(float2*)p = make_float2(gi[j][0], gi[j][1]);
    *(float2*)(p + 8 * D3) = make_float2(gi[j][2], gi[j][3]);
  }
  float* wo = wsb + D * D3 + D3;
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
    float* p = wo + (m0 + gq) * D + no0 + 8 * j + 2 * q4;
    *(float2*)p = make_float2(go[j][0], go[j][1]);
    *(float2*)(p + 8 * D) = make_float2(go[j][2], go[j][3]);
  }
  if (t < D3) wsb[D * D3 + t] = gb;
  else if (t < 4 * D) wo[D * D + t - D3] = gb;
}

template <int HPB, int D>
int launch_bwd(const void* g, const void* x, const void* lens, const void* w_in,
               const void* b_in, const void* w_out, void* dx, void* ws, int B, int H, int NH,
               int E, int grid, float scale, void* stream) {
  const size_t smem = bwd_smem_bytes(E * 16 * HPB, 16 * HPB, D);
  cudaError_t err = cudaFuncSetAttribute(mha_bwd_tc_kernel<HPB, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_tc_kernel<HPB, D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)x, (const int*)lens, (const float*)w_in,
      (const float*)b_in, (const float*)w_out, (bf16*)dx, (float*)ws, B, H, NH, E, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_hpb(int hpb, const void* g, const void* x, const void* lens, const void* w_in,
                   const void* b_in, const void* w_out, void* dx, void* ws, int B, int H,
                   int NH, int E, int grid, float scale, void* stream) {
  switch (hpb) {
    case 1: return launch_bwd<1, D>(g, x, lens, w_in, b_in, w_out, dx, ws, B, H, NH, E, grid, scale, stream);
    case 2: return launch_bwd<2, D>(g, x, lens, w_in, b_in, w_out, dx, ws, B, H, NH, E, grid, scale, stream);
    case 3: return launch_bwd<3, D>(g, x, lens, w_in, b_in, w_out, dx, ws, B, H, NH, E, grid, scale, stream);
    default: return launch_bwd<4, D>(g, x, lens, w_in, b_in, w_out, dx, ws, B, H, NH, E, grid, scale, stream);
  }
}

}  // namespace tc

// Shared memory, in floats; ops/fused_mha.py:_fwd_smem_bytes and
// _bwd_smem_bytes compute the same to choose WSM and to refuse a shape.
size_t fwd_smem_floats(int H, int D, int NH, bool wsm) {
  const size_t D3 = 3 * (size_t)D;
  const size_t w = wsm ? (size_t)D * D3 + D3 + (size_t)D * D + D : 0;
  const size_t xs = std::max((size_t)H * D, (size_t)NH * H * H);
  return w + (size_t)H * (D3 + 1) + xs;
}

size_t bwd_smem_floats(int H, int D, int NH, bool wsm) {
  const size_t D3 = 3 * (size_t)D;
  const size_t w = wsm ? (size_t)D * (D3 + 1) + D3 + (size_t)D * (D + 1) +
                             (size_t)D * D3 + D3 + (size_t)D * D + D
                       : 0;
  return w + 3 * (size_t)H * D + (size_t)H * (D3 + 1) + 2 * (size_t)NH * H * H;
}

float head_scale(int D, int NH) { return (float)(1.0 / sqrt((double)(D / NH))); }

template <bool WSM>
int launch_fwd(const void* x, const void* lens, const void* w_in, const void* b_in,
               const void* w_out, const void* b_out, void* y, int B, int H, int D,
               int NH, int bf, void* stream) {
  const size_t smem = fwd_smem_floats(H, D, NH, WSM) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<WSM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mha_fwd_kernel<WSM>,
                                                           THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // as many blocks as are resident at once, each a contiguous run of examples
  const int epb = (B + std::min(B, sms * per_sm) - 1) / std::min(B, sms * per_sm);
  const int blocks = (B + epb - 1) / epb;
  mha_fwd_kernel<WSM><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, (const int*)lens, (const float*)w_in, (const float*)b_in, (const float*)w_out,
      (const float*)b_out, y, B, H, D, NH, bf, epb, head_scale(D, NH));
  return (int)cudaGetLastError();
}

template <bool WSM>
int launch_bwd(const void* g, const void* x, const void* lens, const void* w_in,
               const void* b_in, const void* w_out, void* dx, void* ws, int B, int H,
               int D, int NH, int bf, int epb, void* stream) {
  const size_t smem = bwd_smem_floats(H, D, NH, WSM) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_kernel<WSM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + epb - 1) / epb;
  mha_bwd_kernel<WSM><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      g, x, (const int*)lens, (const float*)w_in, (const float*)b_in, (const float*)w_out,
      dx, (float*)ws, B, H, D, NH, bf, epb, head_scale(D, NH));
  return (int)cudaGetLastError();
}

}  // namespace

// B13: x [B, H, D], lens [B] int32 or null (every key valid), f32 weights
// -> y [B, H, D] in x's dtype.  wsm: stage the weights in shared memory.
extern "C" int tt_fused_mha_fwd(const void* x, const void* lens, const void* w_in,
                                const void* b_in, const void* w_out, const void* b_out,
                                void* y, int B, int H, int D, int NH, int bf, int wsm,
                                void* stream) {
  if (B < 1 || H < 1 || NH < 1 || D % NH != 0) return (int)cudaErrorInvalidValue;
  return wsm ? launch_fwd<true>(x, lens, w_in, b_in, w_out, b_out, y, B, H, D, NH, bf, stream)
             : launch_fwd<false>(x, lens, w_in, b_in, w_out, b_out, y, B, H, D, NH, bf, stream);
}

// B13 on the tensor cores: x [B, H, D] bf16, lens as tt_fused_mha_fwd,
// f32 weights -> y [B, H, D] bf16; x, W_in and W_out 16-byte aligned.  D and D / NH
// multiples of 16, Hp = round_up(H, 16) <= 64; ept examples a tile (ept *
// Hp a multiple of 32), grid blocks (ops/fused_mha.py:_fwd_tc_plan).
extern "C" int tt_fused_mha_fwd_tc(const void* x, const void* lens, const void* w_in,
                                   const void* b_in, const void* w_out, const void* b_out,
                                   void* y, int B, int H, int D, int NH, int ept, int grid,
                                   void* stream) {
  const int hpb = (H + 15) / 16;
  if (B < 1 || H < 1 || NH < 1 || D % NH != 0 || D % 32 != 0 || (D / NH) % 16 != 0 ||
      hpb > 4 || ept < 1 || (ept * 16 * hpb) % 32 != 0 || ept * 16 * hpb > tc::TILE_ROWS ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  const float scale = head_scale(D, NH);
  switch (hpb) {
    case 1: return tc::launch<1>(x, lens, w_in, b_in, w_out, b_out, y, B, H, D, NH, ept, grid, scale, stream);
    case 2: return tc::launch<2>(x, lens, w_in, b_in, w_out, b_out, y, B, H, D, NH, ept, grid, scale, stream);
    case 3: return tc::launch<3>(x, lens, w_in, b_in, w_out, b_out, y, B, H, D, NH, ept, grid, scale, stream);
    default: return tc::launch<4>(x, lens, w_in, b_in, w_out, b_out, y, B, H, D, NH, ept, grid, scale, stream);
  }
}

// B14: g and x [B, H, D] in x's dtype, lens as B13 -> dx [B, H, D] in x's
// dtype and ws [ceil(B / epb), n] f32 partials of dW_in, db_in, dW_out,
// db_out (n = 3D^2 + 3D + D^2 + D, flat in that order), one slice per
// block of epb examples; tt_fused_mha_bwd_reduce sums them.
extern "C" int tt_fused_mha_bwd(const void* g, const void* x, const void* lens,
                                const void* w_in, const void* b_in, const void* w_out,
                                void* dx, void* ws, int B, int H, int D, int NH, int bf,
                                int wsm, int epb, void* stream) {
  if (B < 1 || H < 1 || NH < 1 || D % NH != 0 || epb < 1) return (int)cudaErrorInvalidValue;
  return wsm ? launch_bwd<true>(g, x, lens, w_in, b_in, w_out, dx, ws, B, H, D, NH, bf, epb,
                                stream)
             : launch_bwd<false>(g, x, lens, w_in, b_in, w_out, dx, ws, B, H, D, NH, bf, epb,
                                 stream);
}

// B14 on the tensor cores: g and x [B, H, D] bf16, lens as tt_fused_mha_fwd,
// f32 weights -> dx [B, H, D] bf16 and ws [grid, n] f32 partials as
// tt_fused_mha_bwd's, one slice per block; g, x, W_in and W_out 16-byte
// aligned.  D 32 or 64, D / NH a multiple of 16, Hp = round_up(H, 16) <=
// 64; ept examples a tile (ept * Hp a multiple of 32, at most 128), grid
// blocks, at most one a tile (ops/fused_mha.py:_bwd_tc_plan).
extern "C" int tt_fused_mha_bwd_tc(const void* g, const void* x, const void* lens,
                                   const void* w_in, const void* b_in, const void* w_out,
                                   void* dx, void* ws, int B, int H, int D, int NH, int ept,
                                   int grid, void* stream) {
  const int hpb = (H + 15) / 16;
  if (B < 1 || H < 1 || NH < 1 || (D != 32 && D != 64) || D % NH != 0 || (D / NH) % 16 != 0 ||
      hpb > 4 || ept < 1 || (ept * 16 * hpb) % 32 != 0 || ept * 16 * hpb > tc::TILE_ROWS ||
      grid < 1 || grid > (B + ept - 1) / ept)
    return (int)cudaErrorInvalidValue;
  const float scale = head_scale(D, NH);
  return D == 32 ? tc::launch_bwd_hpb<32>(hpb, g, x, lens, w_in, b_in, w_out, dx, ws, B, H, NH,
                                          ept, grid, scale, stream)
                 : tc::launch_bwd_hpb<64>(hpb, g, x, lens, w_in, b_in, w_out, dx, ws, B, H, NH,
                                          ept, grid, scale, stream);
}

extern "C" int tt_fused_mha_bwd_reduce(const void* ws, void* grads, int G, int n,
                                       void* stream) {
  if (G < 1 || n < 1) return (int)cudaErrorInvalidValue;
  reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (float*)grads, G, (size_t)n);
  return (int)cudaGetLastError();
}
