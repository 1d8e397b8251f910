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

#include <algorithm>

#include "common.cuh"

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

extern "C" int tt_fused_mha_bwd_reduce(const void* ws, void* grads, int G, int n,
                                       void* stream) {
  if (G < 1 || n < 1) return (int)cudaErrorInvalidValue;
  reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (float*)grads, G, (size_t)n);
  return (int)cudaGetLastError();
}
