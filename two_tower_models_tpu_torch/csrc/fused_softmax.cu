// In-batch softmax cross-entropy over the score matrix S = U . I^T without
// ever storing S: the forward row logsumexp (with the diagonal positive)
// and one backward pass that writes both gradients.
//
// Replaces two_tower_models_tpu/ops/pallas/fused_softmax.py:
//   ce_fwd_tc_kernel <- _fwd_kernel    (fused_in_batch_ce / fused_lse forward)
//   ce_bwd_kernel    <- _bwd_du_kernel (dU_b = sum_j g_b p_bj i_j - g_b i_b)
//   + ce_bwd_reduce  <- _bwd_di_kernel (dI_j = sum_b g_b p_bj u_b - g_j u_j)
// with p_bj = exp(s_bj - lse_b); the diagonal terms only with_diag.
// U [B, D], I [C, D], lse and g [B]; all f32 (the two towers' outputs are
// f32 at every compute dtype), any D.
//
// Bound on the H100: operations.  At B = C = 4096, D = 64 the forward's
// three TF32 products are 6.4 GFLOP on the tensor cores (0.0130 ms at 495
// TFLOP/s; one f32 product on the CUDA cores would be 2.1 GFLOP, 0.032 ms
// at 67) against 2 MB of inputs; the backward 6.4 GFLOP of f32 FMA (0.096
// ms): S once, then (g p) . I and (g p)^T . U.
//
// Forward design (ce_fwd_tc_kernel<MULTI>, MULTI for D > 64): the scores on
// the tensor cores in 3xTF32.  Each operand is split into TF32 hi and lo
// (cvt.rna; x - hi is exact), and s = hi_u.lo_i + lo_u.hi_i + hi_u.hi_i,
// per k8 step in that order, by mma.sync m16n8k8 into a fresh accumulator
// that is then added to the score rounded to nearest (chunk_products says
// why).  Its lse lies within 2e-7 of max |lse| of an f64 logsumexp at the
// flagship step, as the plain f32 version's does; one TF32 product would
// miss 1e-6 (tests/test_torch_ce_forward.py).  Four limits of a row-tile
// kernel on the CUDA cores, and what this design does about each:
//  - A block per 32-row tile is under one wave (128 blocks at B = 4096).
//    Here the grid is cdiv(B, 128) row tiles x S column splits
//    (ops/fused_softmax.py:fwd_plan), S filling the blocks the card holds
//    (two an SM: 32 x 8 at the cell, each block walking 8 of the 64 column
//    tiles).  Each block writes its rows' partial (max, sum, diagonal) to a
//    workspace; the last block of a row tile to finish (an int atomic
//    ticket, set back to 0 for the next launch) merges the S partials in
//    split order.  One launch a call, no float atomics, the same bits on
//    every call.
//  - Scalar shared loads give 8 FMAs per 6 loads.  Here a warp owns 16
//    rows, its A fragments read with ldmatrix from the row tile of U staged
//    once (f32, split at the load: 4 values feed 24 products), and every B
//    fragment (hi, lo) feeds three products; per k8 step a warp issues four
//    column bands' hi.lo, then lo.hi, then hi.hi, four chains of three,
//    twice.
//  - Tile copies that block the compute.  Here the column tiles of I (64
//    rows x 64 d, and for MULTI the row tile of U's d chunk beside them)
//    arrive by cp.async in a three-stage ring; once a stage lands, the
//    block splits it in place into TF32 hi and a lo buffer, once for all
//    eight warps.  Row stride 68 floats (4 banks mod 32): the eight 16-byte
//    rows of each ldmatrix matrix fall in distinct banks.
//  - Whole rows at a D | 1 stride do not fit shared memory from D = 606.
//    Here d is staged 64 at a time, zero-filled up to the chunk's last k8
//    step (D = 1 .. 7 take one step).  16-byte copies where D % 4 == 0 and
//    both inputs are 16-byte aligned (the wrapper copies an input that is
//    not), 4-byte copies else.
//  - The online softmax from the accumulators: a thread holds rows g and
//    g + 8 of its warp's 16 and columns 8 nt + 2t + e of each tile; per
//    tile its max over its 16 valid columns (fmaxf drops a NaN score), then
//    the sum of __expf(s - max) (the MUFU ex2; a NaN score carries into the
//    sum, so the row's lse and ce are NaN as the plain version's), padded
//    columns selected out, the diagonal score taken from the same
//    accumulators; (max, sum) start at (-1e30, 0) as the Pallas kernel's.
//    An infinite max is replaced by 0 where it is subtracted, as
//    torch.logsumexp does (base below), and tt::tf32_split_any gives an
//    infinite input an infinite score: a row with a +inf score has lse
//    +inf and a row of -inf scores -inf, as the plain version, where the
//    Pallas kernel gives NaN for the first.  I's chunks are split by it,
//    once for the block, U's fragments only where the block's U holds a
//    value whose TF32 rounding is infinite (found as U lands), so that
//    elsewhere the inner loop is the finite split's.
//    The four lanes of a quad merge by shuffles, each merge rescaling both
//    sums with expf and adding them rounded (the same bits either way).
// At the cell: 256 threads, 128 registers and 104,448 bytes of shared
// memory a block (two blocks an SM), no spills; MULTI 127 registers,
// 174,080 bytes (one).
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

#include "mma.cuh"

#include <algorithm>

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

// ---- forward: 3xTF32 on the tensor cores ----

namespace fwd {

constexpr int NW = 8;       // warps a block, 16 rows each
constexpr int NT = 32 * NW;
constexpr int BM = 16 * NW; // rows of U a block owns
constexpr int BN = 64;      // columns of S (rows of I) in a tile: eight n8 bands
constexpr int DK = 64;      // d of a staged chunk: eight k8 steps
constexpr int SD = DK + 4;  // staged row stride, 68 floats = 4 banks mod 32
constexpr int NS = 3;       // ring stages
constexpr float NEG_BIG = -1e30f;

// A ring stage holds a column tile of I's d chunk and, with MULTI, the row
// tile of U's; then I's TF32 lo, then (not MULTI) the row tile of U.
template <bool MULTI>
__host__ __device__ constexpr int stage_floats() { return (BN + (MULTI ? BM : 0)) * SD; }

template <bool MULTI>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)NS * stage_floats<MULTI>() + BN * SD + (MULTI ? 0 : BM * SD));
}

// Rows row0 .. row0 + NROWS - 1 of src [n, D], d in [d0, d0 + DK), into dst
// [NROWS][SD] by cp.async; rows past n and d past D are zero-filled up to
// the chunk's last k8 step, d beyond it is not written.  vec: D % 4 == 0 and
// src 16-byte aligned, so a float4 is all in or all out.
template <int NROWS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0, int n, int D,
                                           int d0, int vec) {
  const int dw = min(D - d0, DK), dw8 = (dw + 7) & ~7;
  if (vec) {
    for (int e = threadIdx.x; e < NROWS * (DK / 4); e += NT) {
      const int r = e / (DK / 4), q = (e % (DK / 4)) * 4;
      if (q >= dw8) continue;
      const bool ok = row0 + r < n && q < dw;
      tt::cp_async16(dst + r * SD + q, ok ? src + (size_t)(row0 + r) * D + d0 + q : src,
                     ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < NROWS * DK; e += NT) {
      const int r = e / DK, q = e % DK;
      if (q >= dw8) continue;
      const bool ok = row0 + r < n && q < dw;
      cp_async4(dst + r * SD + q, ok ? src + (size_t)(row0 + r) * D + d0 + q : src, ok ? 4 : 0);
    }
  }
}

// c[nt] += the chunk's scores of the 16 rows at a (f32, split here, by
// tt::tf32_split_any with ANY: the block's U holds a value whose TF32
// rounding is infinite) against column band nt of the staged tile (TF32 hi
// at b, lo at bl).  Per k8 step the three products hi.lo, lo.hi, hi.hi of
// four bands at a time go into fresh accumulators, which are then added to
// c rounded to nearest: mma.sync adds into the accumulator it is given
// without rounding to nearest, which over a chain of 24 products would bias
// a score toward zero by up to 24 of its ulps, and the gradients read
// exp(s - lse).
template <bool ANY>
__device__ __forceinline__ void chunk_products(float (&c)[8][4], const float* a, const float* b,
                                               const float* bl, int nks, int lane) {
  // ldmatrix.x4, lane L giving a row address of matrix L / 8.  A: row
  // L % 8 + 8 ((L / 8) % 2), k half L / 16, landing as a0 .. a3.  B: band
  // 2p + L / 16, row L % 8 of it, k half (L / 8) % 2, landing as b0, b1 of
  // band 2p, then of band 2p + 1.
  const int offa = ((lane & 7) + 8 * ((lane >> 3) & 1)) * SD + 4 * (lane >> 4);
  const int offb = ((lane >> 4) * 8 + (lane & 7)) * SD + ((lane >> 3) & 1) * 4;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    if (ks >= nks) continue;
    unsigned ar[4], ahi[4], alo[4];
    tt::ldmatrix_x4<false>(ar, a + offa + ks * 8);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (ANY)
        tt::tf32_split_any(__uint_as_float(ar[q]), ahi[q], alo[q]);
      else
        tt::tf32_split(__uint_as_float(ar[q]), ahi[q], alo[q]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      unsigned hi[2][4], lo[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int o = offb + (2 * half + p) * 16 * SD + ks * 8;
        tt::ldmatrix_x4<false>(hi[p], b + o);
        tt::ldmatrix_x4<false>(lo[p], bl + o);
      }
      float d[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[n][q] = 0.0f;
#pragma unroll
      for (int n = 0; n < 4; ++n) tt::mma_tf32(d[n], ahi, lo[n / 2][2 * (n % 2)], lo[n / 2][2 * (n % 2) + 1]);
#pragma unroll
      for (int n = 0; n < 4; ++n) tt::mma_tf32(d[n], alo, hi[n / 2][2 * (n % 2)], hi[n / 2][2 * (n % 2) + 1]);
#pragma unroll
      for (int n = 0; n < 4; ++n) tt::mma_tf32(d[n], ahi, hi[n / 2][2 * (n % 2)], hi[n / 2][2 * (n % 2) + 1]);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[4 * half + n][q] += d[n][q];
    }
  }
}

// The max a part's sum of exps is taken against: its max m, or 0 where m
// is infinite, as torch.logsumexp takes it.  A part (m, l) stands for the
// sum exp(base(m)) l, so a row whose max is +inf sums exp(+inf) = +inf (its
// lse +inf, the plain version's) and not exp(inf - inf) = NaN; m is never
// -inf (it starts at NEG_BIG), and at a finite m nothing changes, bit for
// bit.
__device__ __forceinline__ float base(float m) { return isinf(m) ? 0.0f : m; }

// One tile's scores into the running (m, l) of the thread's rows row and
// row + 8: its columns c0 + 8 nt + 2t + e below C, max first, then the sum
// of exps in (nt, e) order; the diagonal score where a column is the row.
__device__ __forceinline__ void softmax_tile(const float (&c)[8][4], int c0, int C, int row,
                                             int with_diag, int t, float (&m)[2], float (&l)[2],
                                             float (&dg)[2]) {
  const bool full = c0 + BN <= C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tmax = NEG_BIG;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (full || c0 + 8 * nt + 2 * t + e < C) tmax = fmaxf(tmax, c[nt][2 * h + e]);
    const float mn = fmaxf(m[h], tmax), bn = base(mn);
    float sum = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (full || c0 + 8 * nt + 2 * t + e < C) sum += __expf(c[nt][2 * h + e] - bn);
    l[h] = __fadd_rn(__fmul_rn(l[h], expf(base(m[h]) - bn)), sum);
    m[h] = mn;
    const int r = row + 8 * h;
    if (with_diag && r >= c0 && r < c0 + BN) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c0 + 8 * nt + 2 * t + e == r) dg[h] = c[nt][2 * h + e];
    }
  }
}

// (m, l) of one part merged into (M, L): the two sums rescaled to the
// larger max's base, each product rounded, then added (the same bits
// whichever part is which).
__device__ __forceinline__ void merge(float& M, float& L, float m, float l) {
  const float mn = fmaxf(M, m), bn = base(mn);
  L = __fadd_rn(__fmul_rn(L, expf(base(M) - bn)), __fmul_rn(l, expf(base(m) - bn)));
  M = mn;
}

// Block (rt, sp): rows rt BM .. rt BM + BM - 1 against the column tiles of
// split sp (an even split of the cdiv(C, BN) tiles over S), each tile's d
// in chunks of DK through the ring.  With S > 1 each block writes its rows'
// partial (m, l, diagonal) to ws [3][S][B], and the last block of the row
// tile to finish merges the S partials in split order.
template <bool MULTI>
__global__ void __launch_bounds__(NT, MULTI ? 1 : 2)
ce_fwd_tc_kernel(const float* __restrict__ U, const float* __restrict__ I,
                 float* __restrict__ ce, float* __restrict__ lse, float* __restrict__ ws,
                 int* __restrict__ tickets, int B, int C, int D, int S, int with_diag,
                 int vec) {
  constexpr int STAGE = stage_floats<MULTI>();
  extern __shared__ float4 fsm[];  // float4: 16-byte aligned
  float* ring = (float*)fsm;        // NS x STAGE
  float* lo_s = ring + NS * STAGE;  // [BN][SD]: TF32 lo of the current I chunk
  float* u_s = lo_s + BN * SD;      // [BM][SD]: the row tile of U (not MULTI)
  __shared__ int last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * BM, rw = r0 + 16 * warp, sp = blockIdx.y;
  const int n_ct = (C + BN - 1) / BN, nkc = MULTI ? (D + DK - 1) / DK : 1;
  const int ct0 = sp * n_ct / S, ct1 = (sp + 1) * n_ct / S, J = (ct1 - ct0) * nkc;
  const bool active = rw < B;  // warp-uniform
  auto issue = [&](int j) {     // work item j (column tile, d chunk) into its ring stage
    float* dst = ring + (j % NS) * STAGE;
    const int d0 = (j % nkc) * DK;
    stage_rows<BN>(dst, I, (ct0 + j / nkc) * BN, C, D, d0, vec);
    if (MULTI) stage_rows<BM>(dst + BN * SD, U, r0, B, D, d0, vec);
  };
  if (!MULTI) stage_rows<BM>(u_s, U, r0, B, D, 0, vec);  // joins the first group
  for (int s = 0; s < NS - 1; ++s) {
    if (s < J) issue(s);
    tt::cp_commit();
  }
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.0f, 0.0f}, dg[2] = {0.0f, 0.0f};
  float acc[8][4];
  bool any = false;  // the block's U holds a value whose TF32 rounding is infinite
  for (int j = 0; j < J; ++j) {
    tt::cp_wait<NS - 2>();
    __syncthreads();  // item j has landed; every warp is done with item j - 1's stage
    if (j + NS - 1 < J) issue(j + NS - 1);
    tt::cp_commit();
    float* b = ring + (j % NS) * STAGE;
    const int ct = ct0 + j / nkc, kc = j % nkc;
    const int nks = (min(D - kc * DK, DK) + 7) / 8;
#pragma unroll 4  // a thread's four items (unrolled by 2 or not at all: 12 bytes spilled)
    for (int e = threadIdx.x; e < BN * DK / 4; e += NT) {  // I's chunk to TF32 hi in place, lo beside
      const int r = e / (DK / 4), q = 4 * (e % (DK / 4));
      if (q < 8 * nks) {
        float4* p = (float4*)(b + r * SD + q);
        const float4 v = *p;
        uint4 hi, lo;
        tt::tf32_split_any(v.x, hi.x, lo.x);
        tt::tf32_split_any(v.y, hi.y, lo.y);
        tt::tf32_split_any(v.z, hi.z, lo.z);
        tt::tf32_split_any(v.w, hi.w, lo.w);
        *(uint4*)p = hi;
        *(uint4*)(lo_s + r * SD + q) = lo;
      }
    }
    if (MULTI || j == 0) {  // the U this item brings: MULTI's chunk, else the row tile
      const float* us = MULTI ? b + BN * SD : u_s;
      int big = 0;
#pragma unroll 1
      for (int e = threadIdx.x; e < BM * DK / 4; e += NT) {
        const int r = e / (DK / 4), q = 4 * (e % (DK / 4));
        if (q >= 8 * nks) continue;  // not staged
        const float4 v = *(const float4*)(us + r * SD + q);
        big |= tt::tf32_big(v.x) | tt::tf32_big(v.y) | tt::tf32_big(v.z) | tt::tf32_big(v.w);
      }
      any = __syncthreads_or(big);
    } else {
      __syncthreads();
    }
    if (!active) continue;
    if (kc == 0) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
    }
    const float* a = (MULTI ? b + BN * SD : u_s) + 16 * warp * SD;
    if (any)
      chunk_products<true>(acc, a, b, lo_s, nks, lane);
    else
      chunk_products<false>(acc, a, b, lo_s, nks, lane);
    if (kc == nkc - 1) softmax_tile(acc, ct * BN, C, rw + g, with_diag, t, m, l, dg);
  }
  // the four lanes of a quad hold parts of the same two rows
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
      dg[h] += __shfl_xor_sync(0xffffffffu, dg[h], off);
      merge(m[h], l[h], mo, lo);
    }
  if (active && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rw + g + 8 * h;
      if (row >= B) continue;
      if (S == 1) {
        const float v = base(m[h]) + logf(l[h]);
        lse[row] = v;
        ce[row] = with_diag ? v - dg[h] : v;
      } else {
        ws[(size_t)sp * B + row] = m[h];
        ws[(size_t)(S + sp) * B + row] = l[h];
        ws[(size_t)(2 * S + sp) * B + row] = dg[h];
      }
    }
  }
  if (S == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + blockIdx.x, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r = threadIdx.x; r < BM && r0 + r < B; r += NT) {
    const int row = r0 + r;
    float M = __ldcg(ws + row), L = __ldcg(ws + (size_t)S * B + row);
    float G = __ldcg(ws + (size_t)2 * S * B + row);
    for (int s = 1; s < S; ++s) {
      merge(M, L, __ldcg(ws + (size_t)s * B + row), __ldcg(ws + (size_t)(S + s) * B + row));
      G += __ldcg(ws + (size_t)(2 * S + s) * B + row);
    }
    const float v = base(M) + logf(L);
    lse[row] = v;
    ce[row] = with_diag ? v - G : v;
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
}

template <bool MULTI>
int launch_fwd(const float* u, const float* i, float* ce, float* lse, float* ws, int* tickets,
               int B, int C, int D, int with_diag, int S, cudaStream_t stream) {
  const size_t smem = smem_bytes<MULTI>();
  cudaError_t err = cudaFuncSetAttribute(ce_fwd_tc_kernel<MULTI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 4 == 0 && ((size_t)u % 16 | (size_t)i % 16) == 0;
  ce_fwd_tc_kernel<MULTI><<<dim3((B + BM - 1) / BM, S), NT, smem, stream>>>(
      u, i, ce, lse, ws, tickets, B, C, D, S, with_diag, vec);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// ---- backward: one pass over the tile pairs, then the reduce ----

namespace bwd {

constexpr int NT = 128;      // threads: tx = tid % 8, ty = tid / 8
constexpr int BM = 128;      // rows of U in a tile
constexpr int BN = 64;       // rows of I (columns of S) in a tile
constexpr int KC = 64;       // d staged at once, and d of one output slice
constexpr int SD = KC + 4;   // U, I row stride: 17 float4s
constexpr int SP = BN + 8;   // g p row stride
constexpr int SMEM_FLOATS = BM * SD + 2 * BN * SD + BM * SP + 2 * BM;

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

}  // namespace

// ce [B] and lse [B] of U [B, D] against I [C, D] on a cdiv(B, 128) x S grid
// (ops/fused_softmax.py:fwd_plan chooses S <= cdiv(C, 64)); with S > 1, ws
// [3, S, B] f32 takes the partials and tickets [cdiv(B, 128)] int32, all
// zero, the row tiles' counts (left zero).
extern "C" int tt_in_batch_ce_fwd(const void* u, const void* i, void* ce, void* lse, void* ws,
                                  void* tickets, int B, int C, int D, int with_diag, int S,
                                  void* stream) {
  using namespace fwd;
  if (B < 1 || C < 1 || D < 1 || S < 1 || S > (C + BN - 1) / BN || (S > 1 && (!ws || !tickets)))
    return (int)cudaErrorInvalidValue;
  auto launch = D <= DK ? launch_fwd<false> : launch_fwd<true>;
  return launch((const float*)u, (const float*)i, (float*)ce, (float*)lse, (float*)ws,
                (int*)tickets, B, C, D, with_diag, S, (cudaStream_t)stream);
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
