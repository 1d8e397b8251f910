// Blockwise (flash) self-attention over the history axis: the forward (B15)
// and its two backward kernels (B16: dq; B17: dk and dv).
//
// Replaces two_tower_models_tpu/ops/pallas/history_attention.py:
//   B15 _attn_kernel (pallas_call at :144): out = softmax(s) v with
//       s = q k^T * scale, keys c >= lens[n] scored -1e30 (so exp gives
//       exactly 0), and lse = m + log l per query row;
//   B16 _dq_kernel (:277): dq = scale * sum_c ds[r, c] k[c];
//   B17 _dkv_kernel (:295): dv[c] = sum_r p[r, c] do[r] and
//       dk[c] = scale * sum_r ds[r, c] q[r], zero for masked keys;
//   with p = exp(s - lse), ds = p (do . v - delta), and delta =
//   rowsum(do * out) taken outside the kernels (ops/history_attention.py).
// Layout: q, k, v, out, do, dq, dk, dv [N, H, Dh] f32 with the heads folded
// into N; lse, delta [N, H] f32; lens [N] int32 in [1, H]; Dh in {16, 32, 64};
// every [N, H, Dh] tensor 16-byte aligned (the wrappers copy one that is
// not).
//
// Bound on the H100: at the flagship shape (H = 32, Dh = 16, N = 4096 or
// 16384) bytes: each kernel reads and writes a few [N, H, Dh] tensors and
// does 32 x 16 multiply-adds per element pair (B15 ~0.04 ms at N = 16384).
// At a long history (H = 4096) operations: 4-8 N H^2 Dh f32 FLOP.
//
// B15 runs on the tensor cores (attn_fwd_tc_kernel, below) for histories of
// 64 keys or more, and on its FMA kernel (attn_fwd_kernel) for shorter
// ones, the cells' H = 32 among them (ops/history_attention.py _fwd_route:
// there the two were measured within 3% of each other, the FMA kernel 15%
// ahead with lengths); B16 and B17 likewise (attn_bwd_tc_kernel, its MODE 0
// and 1, on _bwd_route's histories; attn_dq_kernel and attn_dkv_kernel
// below them).  The FMA kernels (attn_fwd_kernel, attn_dq_kernel,
// attn_dkv_kernel) are a first version that is simple and right:
// one warp owns 32 consecutive rows of one n (query rows in B15 and B16, key
// rows in B17), one row per lane, with the row and its f32 accumulators in
// registers.  The other side's rows (k and v; or q, do, lse and delta) are
// staged 32 at a time in the warp's own slice of shared memory by 16-byte
// loads, and every lane reads the same staged row: a broadcast, free of bank
// conflicts.  So the [H, H] scores never exist, each input row is read
// once per warp, a warp needs no barrier but its own, and with H = 32 one
// warp covers a whole n (several n per block: 4 warps).  Keys past
// lens[n] are neither staged nor scored: the Pallas kernels add exactly 0
// for them.  No atomics: every sum is taken in one fixed order, so the
// results are bit-equal on repeat.  B16's and B17's register rows spill at
// Dh = 64, which no cell uses (theirs is 16).
//
// B15 on the tensor cores (attn_fwd_tc_kernel<DH, QW, BK, NS>).  What
// held the FMA kernel: one lane a row does Dh FMAs per key per product on the
// CUDA cores, its copies do not overlap its math, and at H = 4096, N = 4 only
// 512 warps exist (about 4 an SM, each walking 128 tiles in series). Here a
// warp owns 16 query rows of one n and both products are mma.sync m16n8k8 in
// 3xTF32: each operand split into TF32 hi + lo (V by tt::tf32_split_any; P, in
// [0, 1], and q and k, which reach the tensor cores only below the guard's
// bound, by split_fin), and per k8 step hi.lo', lo.hi', hi.hi' into a fresh
// accumulator that is then added to the running sum rounded to nearest
// (mma.sync adds into its accumulator without rounding to nearest; B10 in
// csrc/fused_softmax.cu does the same).  S's accumulator feeds P.V's A operand
// without shuffles: inside a k8 step the order of the keys is free, so k-slot
// t takes key 2t and slot t + 4 key 2t + 1; then the C fragment (c0 (g, 2t),
// c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)) is the A fragment (a0 (g, t), a1
// (g+8, t), a2 (g, t+4), a3 (g+8, t+4)) as c0, c2, c1, c3, and V is stored
// transposed with each k8 step's keys in the order 0 2 4 6 1 3 5 7, so that
// ldmatrix hands every lane b0 = V[2t][g] and b1 = V[2t+1][g].  The online
// softmax runs in registers: a thread holds rows g and g + 8 of its warp's 16,
// the tile max is reduced over the quad by two shuffles, each lane keeps its
// own partial sum (against the quad's common max) until the end, where the
// quad adds them in butterfly order. A key at or past lens[n] gets -1e30 by
// select, so exp gives exactly 0, and the first tile's rescale exp(-1e30 - m)
// is 0.
//   Blocks: QW warps on one leading index n (an item: its RQ = 16 QW query
// rows), one launch plan for each length (ops/history_attention.py
// _fwd_tc_plan): 64 rows up to H = 64, 128 beyond, as at a long history (H =
// 4096, N = 4), walking the keys in 64-key tiles (32 at Dh = 64).  The grid
// is the blocks the card holds at once, each walking items b, b + grid, ...;
// a block's key tiles of all its items are one sequence of steps through a
// cp.async ring of three stages (as many slots for the items' Q tiles), so
// that the next two steps' copies land while step u is split and scored.
// Keys are never split across blocks (no merge pass).  Each tile lands raw (rows past lens[n] zero-filled by 16-byte
// cp.async of source size 0, so 0 * garbage never reaches O; a tile wholly
// past the length is neither loaded nor scored); then the block splits it once
// for all its warps into K hi, K lo, V^T hi and V^T lo, and each key's |k|^2.
// Query rows past H are zero-filled, not stored; rows past lens[n] are
// computed like the others.  Row strides of DH + 4 and BK + 4 floats put the
// eight rows of every ldmatrix matrix, and the FMA path's rows 2t, in distinct
// banks.
//   Large scores: any order of the score's sum other than the plain version's
// (the d-ordered f32 FMA chain that the FMA kernel and the matmul compute)
// moves exp(s - m) by the score's rounding, and at scores of some thousands (q
// and k at 30 sigma) even the correctly rounded score misses the plain version
// by 2.7 times the 1e-3 / 1e-4 tolerance of the extreme-score test
// (tests/test_torch_blockwise_tc.py).  So a warp scores a tile in 3xTF32 only
// where scale |q| |k| <= SCORE_BOUND for its rows and the tile's keys (|s| <=
// 32, the 3xTF32 error below 2^-15 of a score), and otherwise takes that
// tile's scores by the plain version's f32 FMA chain from the raw tile; P.V
// stays on the tensor cores.  The guard's maxima keep a NaN (tt::max_nan), so
// a NaN or an infinity in q or k takes the FMA chain too, and the output has
// NaN where the plain version's has.  No atomics; every sum in one fixed
// order, bit-equal on repeat.
//   What a step costs: its split, the Q fragments, the guard's reductions, the
// softmax's shuffles, two barriers and the output take about as many
// instructions as the products they feed at 32 keys of Dh = 16, where one f32
// FMA chain per score is only 32 multiply-adds; the tensor cores gain only
// where a query meets many keys (1.1 times the FMA kernel at H = 64, 3.0 at
// H = 4096), so the route leaves shorter histories to the FMA kernel.
//
// B16 and B17 on the tensor cores (attn_bwd_tc_kernel<MODE, DH, W, BT, NS>:
// MODE 0 B16, 1 B17).  What held the FMA kernels: one lane a row does Dh
// FMAs per pair for each of three products (B16) or four (B17) on the CUDA
// cores, its copies do not overlap its math, and at N = 4, H = 4096 only 512
// warps exist.  Built from B15's machinery: a warp owns 16 rows of one n
// (query rows in B16, key rows in B17) and walks the other side's rows in
// 64-row tiles (16 at Dh = 64) through B15's cp.async ring; every product
// is mma.sync m16n8k8 in
// 3xTF32 with a fresh accumulator per k8 step added rounded to nearest.  B16
// per key tile: S = Q K^T, P = exp(S scale - lse), dP = dO V^T, dS = P (dP -
// delta), dQ += dS K.  B17 per query tile: S^T = K Q^T, P^T = exp(S^T scale -
// lse[col]) (lse and delta staged per tile), dV += P^T dO, dP^T = V dO^T,
// dS^T = P^T (dP^T - delta[col]), dK += dS^T Q.  S goes through B15's guard
// (3xTF32 only where scale |a1| |b1| <= SCORE_BOUND, else the plain
// version's d-ordered f32 FMA chain from the raw tile; the maxima keep a
// NaN), and s scale, - lse, exp, dP - delta and P (..) are each rounded as
// the plain version's.  The score and dS accumulators feed the next
// product's A operand without shuffles (keys 2t and 2t + 1 in k-slots t and
// t + 4); its B operand (K, dO or Q) is stored transposed in the order 0 2 4
// 6 1 3 5 7.  Every operand that meets the tensor cores unguarded (dS, dO,
// V, and K or Q as the accumulation's B operand) is split as
// tt::tf32_split_any splits it, by integer operations (split_all; P, at
// least 0, by split_pos), so infinities and NaN reach the sums as in f32.  Two
// launches (no dq by atomics from the dkv pass), no atomics, every sum in
// one fixed order: bit-equal on repeat.

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int WARPS = 4;   // warps per block, each on its own rows
constexpr int ROWS = 32;   // rows a warp owns, and rows it stages per step
constexpr float NEG_INF = -1e30f;  // the Pallas kernels' _NEG_INF

// The warp copies `count` floats (a multiple of 4, 16-byte aligned) from
// device memory into its shared-memory slice.
__device__ __forceinline__ void stage(float* dst, const float* src, int count, int lane) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = lane; i < count / 4; i += 32) d4[i] = s4[i];
}

template <int DH>
__device__ __forceinline__ void load_row(float (&r)[DH], const float* src, bool live) {
#pragma unroll
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    float4 x = live ? reinterpret_cast<const float4*>(src)[d4] : make_float4(0.f, 0.f, 0.f, 0.f);
    r[4 * d4] = x.x;
    r[4 * d4 + 1] = x.y;
    r[4 * d4 + 2] = x.z;
    r[4 * d4 + 3] = x.w;
  }
}

template <int DH>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[DH], float mul) {
#pragma unroll
  for (int d4 = 0; d4 < DH / 4; ++d4)
    reinterpret_cast<float4*>(dst)[d4] =
        make_float4(r[4 * d4] * mul, r[4 * d4 + 1] * mul, r[4 * d4 + 2] * mul, r[4 * d4 + 3] * mul);
}

// a . b with b a staged row of shared memory (read as float4 broadcasts)
template <int DH>
__device__ __forceinline__ float dot(const float (&a)[DH], const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    float4 x = reinterpret_cast<const float4*>(b)[d4];
    acc = fmaf(a[4 * d4], x.x, acc);
    acc = fmaf(a[4 * d4 + 1], x.y, acc);
    acc = fmaf(a[4 * d4 + 2], x.z, acc);
    acc = fmaf(a[4 * d4 + 3], x.w, acc);
  }
  return acc;
}

// acc += w * b with b a staged row
template <int DH>
__device__ __forceinline__ void axpy(float (&acc)[DH], float w, const float* b) {
#pragma unroll
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    float4 x = reinterpret_cast<const float4*>(b)[d4];
    acc[4 * d4] = fmaf(w, x.x, acc[4 * d4]);
    acc[4 * d4 + 1] = fmaf(w, x.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(w, x.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(w, x.w, acc[4 * d4 + 3]);
  }
}

// B15.  A warp's task: (n, query rows r0 .. r0+31).
template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ lens,
                float* __restrict__ out, float* __restrict__ lse, int N, int H, int tiles,
                float scale) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long task = (long long)blockIdx.x * WARPS + warp;
  if (task >= (long long)N * tiles) return;  // the whole warp: no block barrier is used
  const int n = (int)(task / tiles), row = (int)(task % tiles) * ROWS + lane;
  float* ks = reinterpret_cast<float*>(smem4) + warp * 2 * ROWS * DH;
  float* vs = ks + ROWS * DH;
  const int len = lens[n];
  const size_t base = (size_t)n * H * DH;
  const bool live = row < H;

  float qr[DH], acc[DH];
  load_row(qr, q + base + (size_t)row * DH, live);
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = NEG_INF, l = 0.f;
  for (int c0 = 0; c0 < len; c0 += ROWS) {
    const int nc = min(ROWS, len - c0);
    __syncwarp();  // the previous tile's readers are done
    stage(ks, k + base + (size_t)c0 * DH, nc * DH, lane);
    stage(vs, v + base + (size_t)c0 * DH, nc * DH, lane);
    __syncwarp();
    float s[ROWS];
    float mt = m;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (j < nc) {
        s[j] = dot(qr, ks + j * DH) * scale;
        mt = fmaxf(mt, s[j]);
      }
    }
    const float alpha = expf(m - mt);
    float lt = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (j < nc) {
        const float p = expf(s[j] - mt);
        lt += p;
        axpy(acc, p, vs + j * DH);
      }
    }
    l = l * alpha + lt;
    m = mt;
  }
  if (live) {
    const size_t r = (size_t)n * H + row;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] /= l;
    store_row(out + r * DH, acc, 1.f);
    lse[r] = m + logf(l);
  }
}

// B16.  A warp's task: (n, query rows r0 .. r0+31).
template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
attn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ lens, float* __restrict__ dq, int N, int H, int tiles,
               float scale) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long task = (long long)blockIdx.x * WARPS + warp;
  if (task >= (long long)N * tiles) return;
  const int n = (int)(task / tiles), row = (int)(task % tiles) * ROWS + lane;
  float* ks = reinterpret_cast<float*>(smem4) + warp * 2 * ROWS * DH;
  float* vs = ks + ROWS * DH;
  const int len = lens[n];
  const size_t base = (size_t)n * H * DH;
  const bool live = row < H;
  const size_t r = (size_t)n * H + row;

  float qr[DH], dor[DH], acc[DH];
  load_row(qr, q + base + (size_t)row * DH, live);
  load_row(dor, dout + base + (size_t)row * DH, live);
  const float lse_r = live ? lse[r] : 0.f, delta_r = live ? delta[r] : 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int c0 = 0; c0 < len; c0 += ROWS) {
    const int nc = min(ROWS, len - c0);
    __syncwarp();
    stage(ks, k + base + (size_t)c0 * DH, nc * DH, lane);
    stage(vs, v + base + (size_t)c0 * DH, nc * DH, lane);
    __syncwarp();
    for (int j = 0; j < nc; ++j) {
      const float p = expf(dot(qr, ks + j * DH) * scale - lse_r);
      const float ds = p * (dot(dor, vs + j * DH) - delta_r);
      axpy(acc, ds, ks + j * DH);
    }
  }
  if (live) store_row(dq + r * DH, acc, scale);
}

// B17.  A warp's task: (n, key rows c0 .. c0+31); it walks every query row.
template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
attn_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ lens, float* __restrict__ dk, float* __restrict__ dv,
                int N, int H, int tiles, float scale) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long task = (long long)blockIdx.x * WARPS + warp;
  if (task >= (long long)N * tiles) return;
  const int n = (int)(task / tiles), c0 = (int)(task % tiles) * ROWS, col = c0 + lane;
  float* qs = reinterpret_cast<float*>(smem4) + warp * (2 * ROWS * DH + 2 * ROWS);
  float* dos = qs + ROWS * DH;
  float* ls = dos + ROWS * DH;
  float* des = ls + ROWS;
  const int len = lens[n];
  const size_t base = (size_t)n * H * DH;
  const size_t c = (size_t)n * H + col;
  float dka[DH], dva[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) dka[d] = dva[d] = 0.f;
  if (c0 < len) {  // warp-uniform: a tile of masked keys only writes zeros
    float kr[DH], vr[DH];
    load_row(kr, k + base + (size_t)col * DH, col < H);
    load_row(vr, v + base + (size_t)col * DH, col < H);
    for (int r0 = 0; r0 < H; r0 += ROWS) {
      const int nr = min(ROWS, H - r0);
      __syncwarp();
      stage(qs, q + base + (size_t)r0 * DH, nr * DH, lane);
      stage(dos, dout + base + (size_t)r0 * DH, nr * DH, lane);
      if (lane < nr) {
        ls[lane] = lse[(size_t)n * H + r0 + lane];
        des[lane] = delta[(size_t)n * H + r0 + lane];
      }
      __syncwarp();
      for (int i = 0; i < nr; ++i) {
        const float p = expf(dot(kr, qs + i * DH) * scale - ls[i]);
        axpy(dva, p, dos + i * DH);
        const float ds = p * (dot(vr, dos + i * DH) - des[i]);
        axpy(dka, ds, qs + i * DH);
      }
    }
  }
  if (col < H) {
    // a masked key's lane scored its key all the same (exp may overflow
    // there): its dk and dv are exact zeros, not its sums times 0
    if (col >= len) {
#pragma unroll
      for (int d = 0; d < DH; ++d) dka[d] = dva[d] = 0.f;
    }
    store_row(dk + c * DH, dka, scale);
    store_row(dv + c * DH, dva, 1.f);
  }
}

// ---- B15 on the tensor cores ----

namespace tc {

constexpr float SCORE_BOUND = 32.0f;  // see the header: the 3xTF32 scores' range

// A launch plan's shape: QW warps on one leading index, 16 query rows a
// warp, key tiles of BK keys.  An item is one leading index's RQ query
// rows; a step one key tile of an item.  NS ring stages of K and V tiles,
// NS slots of Q tiles (a step's copies land NS - 1 steps ahead).
template <int DH, int QW, int BK, int NS>
struct Shape {
  static constexpr int NT = 32 * QW;
  static constexpr int RQ = 16 * QW;  // query rows an item holds
  static constexpr int SD = DH + 4;   // Q, K, V tile row stride (floats)
  static constexpr int SKV = BK + 4;  // V^T row stride
  static constexpr int KV = BK * SD;  // a K (or V) tile
  static constexpr int STAGE = 2 * KV;  // a ring stage: K, then V
  static constexpr int QF = RQ * SD;    // an item's Q tile
  // the split tile: K hi, K lo [BK][SD], V^T hi, V^T lo [DH][SKV], |k|^2 [BK]
  static constexpr int SPLIT = 2 * KV + 2 * DH * SKV + BK;
  static constexpr size_t SMEM = sizeof(float) * (NS * ((size_t)QF + STAGE) + SPLIT);
  static_assert((BK * DH / 4) % NT == 0 && (RQ * DH / 4) % NT == 0,
                "each thread copies and splits the same number of chunks");
};

// tt::tf32_split of a finite x by integer operations: rounding to TF32 to
// nearest, ties away from zero, is adding half of the 13 dropped bits' unit
// to the bit pattern and clearing them (a carry out of the mantissa steps
// the exponent; one past the largest finite value gives inf, as cvt.rna
// does).  The same bits as tt::tf32_split for every x but a NaN, in five
// operations.  A NaN's add may carry into the sign bit and give hi = lo =
// -0 (0x7fffffff, the card's NaN, does): q and k meet it only below the
// guard's bound, which a NaN fails; a NaN p makes its row's sum l NaN, and
// so the row's out and lse.
__device__ __forceinline__ void split_fin(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// split_fin (ANY: tt::tf32_split_any) of four values.
template <bool ANY>
__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  if constexpr (ANY) {
    tt::tf32_split_any(x.x, hi.x, lo.x);
    tt::tf32_split_any(x.y, hi.y, lo.y);
    tt::tf32_split_any(x.z, hi.z, lo.z);
    tt::tf32_split_any(x.w, hi.w, lo.w);
  } else {
    split_fin(x.x, hi.x, lo.x);
    split_fin(x.y, hi.y, lo.y);
    split_fin(x.z, hi.z, lo.z);
    split_fin(x.w, hi.w, lo.w);
  }
}

// Item it: leading index n, query rows r0 .. r0 + RQ - 1; T key tiles of
// its length (at least one).  Kept in registers: a length read from memory
// where a copy is issued would put a load's latency before every copy.
struct Item {
  int n, r0, T, len;
};

template <int BK>
__device__ __forceinline__ Item item_at(int it, int qtiles, int RQ, const int* lens) {
  Item r;
  r.n = it / qtiles;
  r.r0 = (it % qtiles) * RQ;
  r.len = __ldg(lens + r.n);
  r.T = max(1, (r.len + BK - 1) / BK);
  return r;
}

// Block b walks items b, b + gridDim.x, ... (the grid is what the card
// holds at once, so at a long history each block holds one), each item's
// key tiles in order, as one sequence of steps: the copies of steps u + 1
// .. u + NS - 1 (their K and V tiles, and at an item's first tile its Q
// tile) are in flight while step u is split and scored.  Warp w takes rows
// r0 + 16 w ...
template <int DH, int QW, int BK, int NS>
__global__ void __launch_bounds__(32 * QW, BK <= 32 ? 2 : 1)
attn_fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ lens,
                   float* __restrict__ out, float* __restrict__ lse, int H, int qtiles,
                   int items, float scale) {
  using S = Shape<DH, QW, BK, NS>;
  constexpr int SD = S::SD, SKV = S::SKV, NT = S::NT, RQ = S::RQ;
  constexpr int KS = DH / 8, NB = BK / 8, DB = DH / 8, C4 = DH / 4;
  // Q's split fragments stay in registers through an item's key tiles
  // where it has many (BK = 64) and they fit (DH <= 32: at 64, 64 more
  // registers would spill); else they are split from the staged tile where
  // they are used.  Q and K are split by split_fin: a tile reaches the
  // tensor cores only when the guard's |q|^2 and |k|^2 are finite (its
  // maxima keep a NaN), so every TF32 rounding there is finite; V by
  // tt::tf32_split_any.
  constexpr bool QREG = DH <= 32 && BK == 64;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // NS slots of [RQ][SD]
  float* ring = qs + NS * S::QF;                // NS stages
  float* split = ring + NS * S::STAGE;          // the split tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wq = 16 * warp;

  // the issue side: step `iu` is tile ij of the block's item number iq (ii)
  int ii = blockIdx.x, ij = 0, iq = 0, iu = 0;
  Item iI = item_at<BK>(ii, qtiles, RQ, lens);
  // Each thread copies and splits the 16-byte chunks tid, tid + NT, ... of
  // the tiles: loops of fixed trip counts, so that which tensor a copy
  // belongs to is known where it is compiled.
  auto issue = [&]() {  // one step's copies, one commit group; then the issue side moves on
    if (ii < items) {
      if (ij == 0) {  // the item's Q; rows past H zero-filled
        float* dst = qs + (iq % NS) * S::QF;
        const float* src = q + ((size_t)iI.n * H + iI.r0) * DH;
#pragma unroll
        for (int x = 0; x < RQ * C4 / NT; ++x) {
          const int e = threadIdx.x + x * NT, row = e / C4, c4 = e % C4;
          const bool ok = iI.r0 + row < H;
          tt::cp_async16(dst + row * SD + 4 * c4, src + (ok ? row * DH + 4 * c4 : 0), ok ? 16 : 0);
        }
      }
      float* st = ring + (iu % NS) * S::STAGE;
      if (ij * BK < iI.len) {  // else wholly past the length: not loaded
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const float* src = (kv ? v : k) + ((size_t)iI.n * H + ij * BK) * DH;
#pragma unroll
          for (int x = 0; x < BK * C4 / NT; ++x) {
            const int e = threadIdx.x + x * NT, row = e / C4, c4 = e % C4;
            const bool ok = ij * BK + row < iI.len;  // keys at or past the length zero-filled
            tt::cp_async16(st + kv * S::KV + row * SD + 4 * c4,
                           src + (ok ? row * DH + 4 * c4 : 0), ok ? 16 : 0);
          }
        }
      }
      if (++ij == iI.T) {
        ij = 0;
        ++iq;
        ii += gridDim.x;
        if (ii < items) iI = item_at<BK>(ii, qtiles, RQ, lens);
      }
    }
    tt::cp_commit();
    ++iu;
  };

  // the compute side: step u is tile j of item number cq (it); cN the next
  // item, read while this one is scored
  int it = blockIdx.x, j = 0, cq = 0;
  Item cI = iI, cN = iI;
  float m[2], l[2], o[DB][4];
  auto reset = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) m[h] = NEG_INF, l[h] = 0.f;
#pragma unroll
    for (int db = 0; db < DB; ++db)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[db][c] = 0.f;
  };
  reset();
  unsigned qhi[QREG ? KS : 1][4], qlo[QREG ? KS : 1][4];
  float qn2 = 0.f;  // the largest |q|^2 of the warp's rows (NaN if one is)
  // ldmatrix.x4 row addresses (B10's): A, lane L: row L % 8 + 8 ((L / 8) % 2),
  // k half L / 16, landing as a0 .. a3; B (K by row, or V^T), lane L: band
  // 2p + L / 16, row L % 8 of it, k half (L / 8) % 2, landing as b0, b1 of
  // band 2p, then of band 2p + 1
  const int offa = ((lane & 7) + 8 * ((lane >> 3) & 1)) * SD + 4 * (lane >> 4);
  const int offb = ((lane >> 4) * 8 + (lane & 7)) * SD + ((lane >> 3) & 1) * 4;
  const int offv = ((lane >> 4) * 8 + (lane & 7)) * SKV + ((lane >> 3) & 1) * 4;

#pragma unroll
  for (int x = 0; x < NS - 1; ++x) issue();
  for (int u = 0; it < items; ++u) {
    tt::cp_wait<NS - 2>();
    __syncthreads();  // step u landed; every warp is done with step u - 1
    issue();          // step u + NS - 1, into the stage step u - 1 left (its Q slot: an item done)
    const float* st = ring + (u % NS) * S::STAGE;
    const float* qa = qs + (cq % NS) * S::QF + wq * SD;
    const int n = cI.n, rw = cI.r0 + wq, len = cI.len;
    const bool active = rw < H;  // warp-uniform
    if (j == 0 && it + (int)gridDim.x < items) cN = item_at<BK>(it + gridDim.x, qtiles, RQ, lens);
    // the split, once for the block: the K tile into hi and lo, the V tile
    // into V^T hi and lo with each k8 step's keys in the order 0 2 4 6 1 3
    // 5 7, and each key's |k|^2 (the C4 lanes of a key summed)
    if (j * BK < len) {
#pragma unroll
      for (int x = 0; x < BK * C4 / NT; ++x) {
        const int e = threadIdx.x + x * NT, c = e / C4, c4 = e % C4;
        const float4 kx = *reinterpret_cast<const float4*>(st + c * SD + 4 * c4);
        const float4 vx = *reinterpret_cast<const float4*>(st + S::KV + c * SD + 4 * c4);
        uint4 hi, lo;
        split4<false>(kx, hi, lo);
        *reinterpret_cast<uint4*>(split + c * SD + 4 * c4) = hi;
        *reinterpret_cast<uint4*>(split + S::KV + c * SD + 4 * c4) = lo;
        split4<true>(vx, hi, lo);
        unsigned* vt = reinterpret_cast<unsigned*>(split + 2 * S::KV) + 4 * c4 * SKV +
                       ((c & ~7) | ((c & 1) << 2) | ((c & 7) >> 1));
        vt[0] = hi.x;
        vt[SKV] = hi.y;
        vt[2 * SKV] = hi.z;
        vt[3 * SKV] = hi.w;
        vt += DH * SKV;
        vt[0] = lo.x;
        vt[SKV] = lo.y;
        vt[2 * SKV] = lo.z;
        vt[3 * SKV] = lo.w;
        float k2 = kx.x * kx.x + kx.y * kx.y + kx.z * kx.z + kx.w * kx.w;
#pragma unroll
        for (int off = 1; off < C4; off <<= 1) k2 += __shfl_xor_sync(FULL, k2, off);
        if (c4 == 0) split[2 * S::KV + 2 * DH * SKV + c] = k2;
      }
    }
    if (j == 0 && active) {  // the warp's Q fragments, split, and its rows' largest |q|^2
      if constexpr (QREG) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          unsigned ar[4];
          tt::ldmatrix_x4<false>(ar, qa + offa + ks * 8);
#pragma unroll
          for (int c = 0; c < 4; ++c) split_fin(__uint_as_float(ar[c]), qhi[ks][c], qlo[ks][c]);
        }
      }
      const float4* qr = reinterpret_cast<const float4*>(qa + (lane & 15) * SD + (lane >> 4) * (DH / 2));
      qn2 = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 8; ++d4) {
        const float4 x = qr[d4];
        qn2 = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, qn2))));
      }
      qn2 += __shfl_xor_sync(FULL, qn2, 16);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) qn2 = tt::max_nan(qn2, __shfl_xor_sync(FULL, qn2, off));
    }
    __syncthreads();  // the split tile is written

    if (active && j * BK < len) {
      float k2 = 0.f;  // the tile's largest |k|^2 (NaN if one is)
#pragma unroll
      for (int c = lane; c < BK; c += 32) k2 = tt::max_nan(k2, split[2 * S::KV + 2 * DH * SKV + c]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) k2 = tt::max_nan(k2, __shfl_xor_sync(FULL, k2, off));
      // keys of the tile below the length: bands past them are neither
      // scored nor multiplied (their scores are -1e30 below, exp 0)
      const int live = len - j * BK;
      float s[NB][4];
      // false for a NaN or an infinite |q|^2 or |k|^2 (inf . 0 is NaN)
      if (scale * scale * qn2 * k2 <= SCORE_BOUND * SCORE_BOUND) {  // 3xTF32
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[nb][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {  // each score's k8 steps in d order
          unsigned ahi[4], alo[4];
          if constexpr (QREG) {
#pragma unroll
            for (int c = 0; c < 4; ++c) ahi[c] = qhi[ks][c], alo[c] = qlo[ks][c];
          } else {
            unsigned ar[4];
            tt::ldmatrix_x4<false>(ar, qa + offa + ks * 8);
#pragma unroll
            for (int c = 0; c < 4; ++c) split_fin(__uint_as_float(ar[c]), ahi[c], alo[c]);
          }
#pragma unroll
          for (int p = 0; p < NB / 2; ++p) {
            if (16 * p >= live) continue;
            unsigned bh[4], bl[4];
            tt::ldmatrix_x4<false>(bh, split + offb + p * 16 * SD + ks * 8);
            tt::ldmatrix_x4<false>(bl, split + S::KV + offb + p * 16 * SD + ks * 8);
            float f[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int b = 0; b < 2; ++b) tt::mma_tf32(f[b], ahi, bl[2 * b], bl[2 * b + 1]);
#pragma unroll
            for (int b = 0; b < 2; ++b) tt::mma_tf32(f[b], alo, bh[2 * b], bh[2 * b + 1]);
#pragma unroll
            for (int b = 0; b < 2; ++b) tt::mma_tf32(f[b], ahi, bh[2 * b], bh[2 * b + 1]);
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
              for (int c = 0; c < 4; ++c) s[2 * p + b][c] += f[b][c];
          }
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[nb][c] *= scale;
      } else {  // the plain version's f32 FMA chain in d order, from the raw tile
        const float4* q0 = reinterpret_cast<const float4*>(qa + g * SD);
        const float4* q1 = reinterpret_cast<const float4*>(qa + (g + 8) * SD);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if (8 * nb >= live) continue;
          const float4* k0 = reinterpret_cast<const float4*>(st + (8 * nb + 2 * t) * SD);
          const float4* k1 = reinterpret_cast<const float4*>(st + (8 * nb + 2 * t + 1) * SD);
          float a[4] = {0.f, 0.f, 0.f, 0.f};
          // not unrolled: unrolled, the two q rows would be held in registers across the bands
#pragma unroll 1
          for (int d4 = 0; d4 < C4; ++d4) {
            const float4 x0 = q0[d4], x1 = q1[d4], y0 = k0[d4], y1 = k1[d4];
            a[0] = fmaf(x0.x, y0.x, a[0]); a[0] = fmaf(x0.y, y0.y, a[0]);
            a[0] = fmaf(x0.z, y0.z, a[0]); a[0] = fmaf(x0.w, y0.w, a[0]);
            a[1] = fmaf(x0.x, y1.x, a[1]); a[1] = fmaf(x0.y, y1.y, a[1]);
            a[1] = fmaf(x0.z, y1.z, a[1]); a[1] = fmaf(x0.w, y1.w, a[1]);
            a[2] = fmaf(x1.x, y0.x, a[2]); a[2] = fmaf(x1.y, y0.y, a[2]);
            a[2] = fmaf(x1.z, y0.z, a[2]); a[2] = fmaf(x1.w, y0.w, a[2]);
            a[3] = fmaf(x1.x, y1.x, a[3]); a[3] = fmaf(x1.y, y1.y, a[3]);
            a[3] = fmaf(x1.z, y1.z, a[3]); a[3] = fmaf(x1.w, y1.w, a[3]);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) s[nb][c] = a[c] * scale;
        }
      }
      if ((j + 1) * BK > len) {  // keys at or past the length: -1e30 by select
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (j * BK + 8 * nb + 2 * t + e >= len) s[nb][e] = s[nb][2 + e] = NEG_INF;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the online softmax of rows g and g + 8
        float tm = NEG_INF;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) tm = fmaxf(tm, fmaxf(s[nb][2 * h], s[nb][2 * h + 1]));
        tm = fmaxf(tm, __shfl_xor_sync(FULL, tm, 1));
        tm = fmaxf(tm, __shfl_xor_sync(FULL, tm, 2));
        const float mn = fmaxf(m[h], tm);
        const float alpha = __expf(m[h] - mn);
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = __expf(s[nb][2 * h + e] - mn);
            s[nb][2 * h + e] = p;
            sum += p;
          }
        l[h] = __fadd_rn(__fmul_rn(l[h], alpha), sum);
        m[h] = mn;
#pragma unroll
        for (int db = 0; db < DB; ++db) {
          o[db][2 * h] *= alpha;
          o[db][2 * h + 1] *= alpha;
        }
      }
      const float* vh = split + 2 * S::KV;
      const float* vl = vh + DH * SKV;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {  // O += P V, key band nb as one k8 step
        if (8 * nb >= live) continue;
        unsigned ph[4], pl[4];
        split_fin(s[nb][0], ph[0], pl[0]);  // a0: row g, slot t = key 2t
        split_fin(s[nb][2], ph[1], pl[1]);  // a1: row g + 8, key 2t
        split_fin(s[nb][1], ph[2], pl[2]);  // a2: row g, slot t + 4 = key 2t + 1
        split_fin(s[nb][3], ph[3], pl[3]);  // a3: row g + 8, key 2t + 1
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          unsigned bh[4], bl[4];
          tt::ldmatrix_x4<false>(bh, vh + offv + dp * 16 * SKV + nb * 8);
          tt::ldmatrix_x4<false>(bl, vl + offv + dp * 16 * SKV + nb * 8);
          float f[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int b = 0; b < 2; ++b) tt::mma_tf32(f[b], ph, bl[2 * b], bl[2 * b + 1]);
#pragma unroll
          for (int b = 0; b < 2; ++b) tt::mma_tf32(f[b], pl, bh[2 * b], bh[2 * b + 1]);
#pragma unroll
          for (int b = 0; b < 2; ++b) tt::mma_tf32(f[b], ph, bh[2 * b], bh[2 * b + 1]);
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c) o[2 * dp + b][c] += f[b][c];
        }
      }
    }

    if (++j == cI.T) {  // the item's last tile: its rows out, then the next item
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the quad's partial sums, in butterfly order
          l[h] += __shfl_xor_sync(FULL, l[h], 1);
          l[h] += __shfl_xor_sync(FULL, l[h], 2);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + g + 8 * h;
          if (r >= H) continue;
          float* orow = out + ((size_t)n * H + r) * DH + 2 * t;
          const float inv = 1.0f / l[h];  // one division a row, then products
#pragma unroll
          for (int db = 0; db < DB; ++db)
            *reinterpret_cast<float2*>(orow + 8 * db) =
                make_float2(o[db][2 * h] * inv, o[db][2 * h + 1] * inv);
          if (t == 0) lse[(size_t)n * H + r] = m[h] + logf(l[h]);
        }
      }
      reset();
      j = 0;
      ++cq;
      it += gridDim.x;
      cI = cN;
    }
  }
}

// ---- B16 and B17 on the tensor cores ----

// cp.async of 4 bytes (bytes 0: the destination becomes 0 and src is not
// read): the lse and delta of a query tile, whose [N, H] rows start at any
// 4-byte boundary.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

// tt::tf32_split_any by integer operations (split_fin's rounding): where x's
// TF32 rounding is infinite (x infinite or NaN, or finite at or past (2 -
// 2^-11) 2^127) hi = 0 and lo = x cut to TF32, as tf32_split_any does for
// all but a NaN, which it keeps in hi; here lo keeps it, and a product of
// it is NaN all the same.
__device__ __forceinline__ void split_all(float x, unsigned& hi, unsigned& lo) {
  const unsigned b = __float_as_uint(x);
  const bool big = (b & 0x7fffffffu) >= 0x7f7ff000u;
  hi = big ? 0u : (b + 0x1000u) & 0xffffe000u;
  const unsigned r = __float_as_uint(x - __uint_as_float(hi));
  lo = big ? b & 0xffffe000u : (r + 0x1000u) & 0xffffe000u;
}

// split_fin of a probability p = exp(..) (at least 0, or NaN) that keeps a
// NaN in hi: a NaN's bits are clamped below the carry into the sign bit.
__device__ __forceinline__ void split_pos(float x, unsigned& hi, unsigned& lo) {
  hi = (min(__float_as_uint(x), 0x7fffefffu) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// d = a . b (mma.sync m16n8k8, TF32) with a zero accumulator: no register
// to clear.
__device__ __forceinline__ void mma_tf32_0(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                           unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// One k8 step of two n-tiles (an ldmatrix_x4's b0, b1 of each) in 3xTF32,
// each into a fresh accumulator: hi.lo', lo.hi', hi.hi', the two tiles'
// products interleaved.
__device__ __forceinline__ void mma3x2(float (&d)[2][4], const unsigned (&ah)[4],
                                       const unsigned (&al)[4], const unsigned (&bh)[4],
                                       const unsigned (&bl)[4]) {
#pragma unroll
  for (int b = 0; b < 2; ++b) mma_tf32_0(d[b], ah, bl[2 * b], bl[2 * b + 1]);
#pragma unroll
  for (int b = 0; b < 2; ++b) tt::mma_tf32(d[b], al, bh[2 * b], bh[2 * b + 1]);
#pragma unroll
  for (int b = 0; b < 2; ++b) tt::mma_tf32(d[b], ah, bh[2 * b], bh[2 * b + 1]);
}

// A backward launch plan's shape: W warps on one leading index, each
// owning 16 rows (query rows in MODE 0, B16; key rows in MODE 1, B17),
// walking the other side's rows in tiles of BT through a ring of NS stages.
// An item is one leading index's RO own rows; a step one tile of an item.
//   A ring stage holds the raw tiles B1 (K in MODE 0, Q in MODE 1) and B2
// (V; dO) [BT][SD], in MODE 1 also the tile's lse and delta [BT] each.  The
// split tile: B1 hi, lo and B2 hi, lo [BT][SD] (the B operands of S and dP),
// B1^T hi, lo [DH][SKV] (of dQ += dS K; dK += dS^T Q), in MODE 1 B2^T hi, lo
// (of dV += P^T dO), each k8 step's rows in the order 0 2 4 6 1 3 5 7, and
// each row's |b1|^2.
template <int MODE, int DH, int W, int BT, int NS>
struct BwdShape {
  static constexpr int NT = 32 * W;
  static constexpr int RO = 16 * W;
  static constexpr int SD = DH + 4;
  static constexpr int SKV = BT + 4;
  static constexpr int TILE = BT * SD;
  static constexpr int STAGE = 2 * TILE + (MODE == 1 ? 2 * BT : 0);
  static constexpr int NTR = MODE == 1 ? 2 : 1;  // transposed tiles
  static constexpr int SPLIT = 4 * TILE + 2 * NTR * DH * SKV + BT;
  // past DH = 16 each warp's own rows of a1 and a2 [16][SD] (read and
  // split where used: their fragments in registers would spill)
  static constexpr int OWN = DH > 16 ? W * 2 * 16 * SD : 0;
  static constexpr size_t SMEM = sizeof(float) * ((size_t)NS * STAGE + SPLIT + OWN);
  static_assert((BT * DH / 4) % NT == 0, "each thread copies and splits the same number of chunks");
};

// Item it: leading index n, own rows r0 .. r0 + RO - 1; T tiles of the
// other side (at least one): in MODE 0 the keys below the length, in MODE
// 1 every query row, or one tile that is neither loaded nor scored where
// every own key is at or past the length.
template <int MODE, int BT>
__device__ __forceinline__ Item bwd_item_at(int it, int otiles, int RO, int H, const int* lens) {
  Item r;
  r.n = it / otiles;
  r.r0 = (it % otiles) * RO;
  r.len = __ldg(lens + r.n);
  if constexpr (MODE == 0)
    r.T = max(1, (r.len + BT - 1) / BT);
  else
    r.T = r.r0 < r.len ? (H + BT - 1) / BT : 1;
  return r;
}

// B16 (MODE 0: a1 = q, a2 = dO, b1 = k, b2 = v; out1 = dq) and B17 (MODE 1:
// a1 = k, a2 = v, b1 = q, b2 = dO; out1 = dk, out2 = dv).  Block b walks
// items b, b + gridDim.x, ... and each item's tiles in order as one
// sequence of steps, the copies of steps u + 1 .. u + NS - 1 in flight
// while step u is split and multiplied (attn_fwd_tc_kernel's ring).  Warp w
// owns rows r0 + 16 w ..: its A fragments of a1 and a2 come from device
// memory at the item's first step (at DH = 16 in registers through the
// item's tiles; at 32 and 64, where 64 or 128 more registers would spill,
// its rows into its slice of shared memory, read and split where used),
// its row's lse and delta (MODE 0) too.  A step, by
// chunks of 16 other rows (two bands of 8): S = a1 b1^T (3xTF32 below the
// guard's bound, else the plain version's FMA chain), P = exp(S scale - lse)
// with masked keys at -1e30, dP = a2 b2^T (3xTF32), dS = P (dP - delta);
// then MODE 0 dQ += dS K, MODE 1 dV += P^T dO and dK += dS^T Q, each band
// one k8 step whose A operand is the C fragment of S as c0, c2, c1, c3.
template <int MODE, int DH, int W, int BT, int NS>
__global__ void __launch_bounds__(32 * W, DH == 16 && W == 4 ? 3 : 1)
attn_bwd_tc_kernel(const float* __restrict__ a1g, const float* __restrict__ a2g,
                   const float* __restrict__ b1g, const float* __restrict__ b2g,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const int* __restrict__ lens, float* __restrict__ out1,
                   float* __restrict__ out2, int H, int otiles, int items, float scale) {
  using S = BwdShape<MODE, DH, W, BT, NS>;
  constexpr int SD = S::SD, SKV = S::SKV, NT = S::NT, RO = S::RO, TILE = S::TILE;
  constexpr int KS = DH / 8, DB = DH / 8, C4 = DH / 4;
  constexpr bool AREG = DH == 16;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // NS stages
  float* split = ring + NS * S::STAGE;
  float* b1t = split + 4 * TILE;      // B1^T hi, then lo
  float* b2t = b1t + 2 * DH * SKV;    // B2^T hi, then lo (MODE 1)
  float* norm = split + S::SPLIT - BT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float* own = split + S::SPLIT + warp * 2 * 16 * SD;  // DH = 64: the warp's a1, then a2 rows

  // the issue side: step iu is tile ij of the block's item ii
  int ii = blockIdx.x, ij = 0, iu = 0;
  Item iI = bwd_item_at<MODE, BT>(ii, otiles, RO, H, lens);
  auto issue = [&]() {
    if (ii < items) {
      float* st = ring + (iu % NS) * S::STAGE;
      const int o0 = ij * BT, lim = MODE == 0 ? iI.len : H;  // other rows past lim zero-filled
      if (o0 < lim && (MODE == 0 || iI.r0 < iI.len)) {
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const float* src = (kv ? b2g : b1g) + ((size_t)iI.n * H + o0) * DH;
#pragma unroll
          for (int x = 0; x < BT * C4 / NT; ++x) {
            const int e = tid + x * NT, row = e / C4, c4 = e % C4;
            const bool ok = o0 + row < lim;
            tt::cp_async16(st + kv * TILE + row * SD + 4 * c4,
                           src + (ok ? row * DH + 4 * c4 : 0), ok ? 16 : 0);
          }
        }
        if constexpr (MODE == 1) {
          for (int e = tid; e < 2 * BT; e += NT) {
            const int row = e % BT;
            const bool ok = o0 + row < H;
            cp_async4(st + 2 * TILE + e,
                      (e < BT ? lse : delta) + (size_t)iI.n * H + (ok ? o0 + row : 0), ok ? 4 : 0);
          }
        }
      }
      if (++ij == iI.T) {
        ij = 0;
        ii += gridDim.x;
        if (ii < items) iI = bwd_item_at<MODE, BT>(ii, otiles, RO, H, lens);
      }
    }
    tt::cp_commit();
    ++iu;
  };

  // the compute side: step u is tile j of item it; cN the next item
  int it = blockIdx.x, j = 0;
  Item cI = iI, cN = iI;
  float acc1[DB][4], acc2[MODE == 1 ? DB : 1][4];
  auto reset = [&]() {
#pragma unroll
    for (int db = 0; db < DB; ++db)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc1[db][c] = 0.f;
    if constexpr (MODE == 1) {
#pragma unroll
      for (int db = 0; db < DB; ++db)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc2[db][c] = 0.f;
    }
  };
  reset();
  unsigned a1h[AREG ? KS : 1][4], a1l[AREG ? KS : 1][4], a2h[AREG ? KS : 1][4],
      a2l[AREG ? KS : 1][4];
  float an2 = 0.f;                      // the largest |a1|^2 of the warp's rows (NaN if one is)
  float lse_r[2] = {0.f, 0.f}, de_r[2] = {0.f, 0.f};  // MODE 0: rows g and g + 8
  const int offa = ((lane & 7) + 8 * ((lane >> 3) & 1)) * SD + 4 * (lane >> 4);
  const int offb = ((lane >> 4) * 8 + (lane & 7)) * SD + ((lane >> 3) & 1) * 4;
  const int offv = ((lane >> 4) * 8 + (lane & 7)) * SKV + ((lane >> 3) & 1) * 4;

#pragma unroll
  for (int x = 0; x < NS - 1; ++x) issue();
  for (int u = 0; it < items; ++u) {
    tt::cp_wait<NS - 2>();
    __syncthreads();  // step u landed; every warp is done with step u - 1
    issue();          // step u + NS - 1, into the stage step u - 1 left
    const float* st = ring + (u % NS) * S::STAGE;
    const int n = cI.n, len = cI.len, rw = cI.r0 + 16 * warp;
    const int o0 = j * BT, lim = MODE == 0 ? len : H;
    const bool loaded = o0 < lim && (MODE == 0 || cI.r0 < len);  // block-uniform
    const bool active = rw < H;                                  // warp-uniform
    const bool work = active && (MODE == 0 || rw < len);
    // the warp's rows g and g + 8 (clamped into [0, H): a row past H is not stored)
    const size_t base = (size_t)n * H;
    const int rg0 = min(rw + g, H - 1), rg1 = min(rw + g + 8, H - 1);
    // the A fragment of k8 step ks of the warp's rows of a1 (which = 0,
    // split by split_fin: it meets the tensor cores only below the guard's
    // bound) or a2 (split_all): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
    // (g + 8, t + 4); from device memory (DH = 16, once an item) or the
    // warp's own rows
    auto frag = [&](int which, int ks, unsigned (&hi)[4], unsigned (&lo)[4]) {
      float y[4];
      if constexpr (AREG) {
        const float* x = which ? a2g : a1g;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          y[c] = __ldg(x + (base + (c & 1 ? rg1 : rg0)) * DH + ks * 8 + t + 4 * (c >> 1));
      } else {
        unsigned r[4];
        tt::ldmatrix_x4<false>(r, own + which * 16 * SD + offa + ks * 8);
#pragma unroll
        for (int c = 0; c < 4; ++c) y[c] = __uint_as_float(r[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (which)
          split_all(y[c], hi[c], lo[c]);
        else
          split_fin(y[c], hi[c], lo[c]);
      }
    };
    if (j == 0 && it + (int)gridDim.x < items)
      cN = bwd_item_at<MODE, BT>(it + gridDim.x, otiles, RO, H, lens);
    // the split, once for the block: B1 and B2 into hi and lo by row and
    // (B1, and in MODE 1 B2) transposed with each k8 step's rows in the
    // order 0 2 4 6 1 3 5 7; each row's |b1|^2 (the C4 lanes of a row summed)
    if (loaded) {
#pragma unroll
      for (int x = 0; x < BT * C4 / NT; ++x) {
        const int e = tid + x * NT, c = e / C4, c4 = e % C4;
        const int pc = (c & ~7) | ((c & 1) << 2) | ((c & 7) >> 1);
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const float4 xv = *reinterpret_cast<const float4*>(st + kv * TILE + c * SD + 4 * c4);
          uint4 hi, lo;
          split_all(xv.x, hi.x, lo.x);
          split_all(xv.y, hi.y, lo.y);
          split_all(xv.z, hi.z, lo.z);
          split_all(xv.w, hi.w, lo.w);
          *reinterpret_cast<uint4*>(split + 2 * kv * TILE + c * SD + 4 * c4) = hi;
          *reinterpret_cast<uint4*>(split + (2 * kv + 1) * TILE + c * SD + 4 * c4) = lo;
          if (kv == 0 || MODE == 1) {
            unsigned* tp = reinterpret_cast<unsigned*>(kv ? b2t : b1t) + 4 * c4 * SKV + pc;
            tp[0] = hi.x;
            tp[SKV] = hi.y;
            tp[2 * SKV] = hi.z;
            tp[3 * SKV] = hi.w;
            tp += DH * SKV;
            tp[0] = lo.x;
            tp[SKV] = lo.y;
            tp[2 * SKV] = lo.z;
            tp[3 * SKV] = lo.w;
          }
          if (kv == 0) {
            float b2 = xv.x * xv.x + xv.y * xv.y + xv.z * xv.z + xv.w * xv.w;
#pragma unroll
            for (int off = 1; off < C4; off <<= 1) b2 += __shfl_xor_sync(FULL, b2, off);
            if (c4 == 0) norm[c] = b2;
          }
        }
      }
    }
    if (j == 0 && work) {  // the item's own rows: fragments, |a1|^2, lse and delta
      if constexpr (!AREG) {  // the warp's rows of a1 and a2 into its own slice
#pragma unroll
        for (int x = lane; x < 2 * 16 * C4; x += 32) {
          const int which = x / (16 * C4), row = (x / C4) % 16, c4 = x % C4;
          const float* src = (which ? a2g : a1g) + (base + min(rw + row, H - 1)) * DH + 4 * c4;
          *reinterpret_cast<float4*>(own + (which * 16 + row) * SD + 4 * c4) =
              __ldg(reinterpret_cast<const float4*>(src));
        }
        __syncwarp();
      } else {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          frag(0, ks, a1h[ks], a1l[ks]);
          frag(1, ks, a2h[ks], a2l[ks]);
        }
      }
      const float4* ar = reinterpret_cast<const float4*>(
          a1g + (base + min(rw + (lane & 15), H - 1)) * DH + (lane >> 4) * (DH / 2));
      an2 = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 8; ++d4) {
        const float4 x = __ldg(ar + d4);
        an2 = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, an2))));
      }
      an2 += __shfl_xor_sync(FULL, an2, 16);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) an2 = tt::max_nan(an2, __shfl_xor_sync(FULL, an2, off));
      if constexpr (MODE == 0) {
        lse_r[0] = __ldg(lse + base + rg0), lse_r[1] = __ldg(lse + base + rg1);
        de_r[0] = __ldg(delta + base + rg0), de_r[1] = __ldg(delta + base + rg1);
      }
    }
    __syncthreads();  // the split tile is written

    if (work && loaded) {
      float b2 = 0.f;  // the tile's largest |b1|^2 (NaN if one is)
#pragma unroll
      for (int c = lane; c < BT; c += 32) b2 = tt::max_nan(b2, norm[c]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) b2 = tt::max_nan(b2, __shfl_xor_sync(FULL, b2, off));
      // false for a NaN or an infinite |a1|^2 or |b1|^2
      const bool tcs = scale * scale * an2 * b2 <= SCORE_BOUND * SCORE_BOUND;
      const int live = lim - o0;  // the tile's rows below lim
      // the tile's rows at or past lim: MODE 0 keys at or past the length
      // (scored -1e30), MODE 1 query rows past H (P and dS exactly 0)
      const bool edge = o0 + BT > lim;
      // MODE 1: the warp's key rows at or past the length (scored -1e30)
      const bool medge = MODE == 1 && rw + 16 > len;
      const bool mrow0 = rw + g >= len, mrow1 = rw + g + 8 >= len;
      const float* ls = st + 2 * TILE;  // MODE 1: the tile's lse, then its delta
      // chunk p: the tile's rows 16 p .. 16 p + 15
      auto chunk = [&](int p) {
        if (16 * p >= live) return;  // rows past lim: neither scored nor multiplied
        float s[2][4];
        // k8 step ks of S = a1 b1^T (which = 0; B1 at split) or dP = a2
        // b2^T (1; B2 at split + 2 TILE) in 3xTF32 into acc, the k8 steps
        // in d order
        auto kstep = [&](int which, int ks, float (&acc)[2][4]) {
          unsigned ah[4], al[4];
          if constexpr (AREG) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              ah[c] = which ? a2h[ks][c] : a1h[ks][c], al[c] = which ? a2l[ks][c] : a1l[ks][c];
          } else {
            frag(which, ks, ah, al);
          }
          const float* bt0 = split + 2 * which * TILE + offb + p * 16 * SD + ks * 8;
          unsigned bh[4], bl[4];
          tt::ldmatrix_x4<false>(bh, bt0);
          tt::ldmatrix_x4<false>(bl, bt0 + TILE);
          float f[2][4];
          mma3x2(f, ah, al, bh, bl);
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[b][c] = ks ? acc[b][c] + f[b][c] : f[b][c];
        };
        // all k8 steps of one product; past DH = 16 one at a time (B17's spill)
        auto product = [&](int which, float (&acc)[2][4]) {
          if constexpr (AREG) {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) kstep(which, ks, acc);
          } else {
#pragma unroll 1
            for (int ks = 0; ks < KS; ++ks) kstep(which, ks, acc);
          }
        };
        if (tcs) {
          product(0, s);
        } else {  // the plain version's f32 FMA chain in d order
          const float4* x0 = reinterpret_cast<const float4*>(a1g + (base + rg0) * DH);
          const float4* x1 = reinterpret_cast<const float4*>(a1g + (base + rg1) * DH);
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const float4* y0 = reinterpret_cast<const float4*>(st + (16 * p + 8 * b + 2 * t) * SD);
            const float4* y1 = reinterpret_cast<const float4*>(st + (16 * p + 8 * b + 2 * t + 1) * SD);
            float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
            for (int d4 = 0; d4 < C4; ++d4) {
              const float4 u0 = __ldg(x0 + d4), u1 = __ldg(x1 + d4), v0 = y0[d4], v1 = y1[d4];
              a[0] = fmaf(u0.x, v0.x, a[0]); a[0] = fmaf(u0.y, v0.y, a[0]);
              a[0] = fmaf(u0.z, v0.z, a[0]); a[0] = fmaf(u0.w, v0.w, a[0]);
              a[1] = fmaf(u0.x, v1.x, a[1]); a[1] = fmaf(u0.y, v1.y, a[1]);
              a[1] = fmaf(u0.z, v1.z, a[1]); a[1] = fmaf(u0.w, v1.w, a[1]);
              a[2] = fmaf(u1.x, v0.x, a[2]); a[2] = fmaf(u1.y, v0.y, a[2]);
              a[2] = fmaf(u1.z, v0.z, a[2]); a[2] = fmaf(u1.w, v0.w, a[2]);
              a[3] = fmaf(u1.x, v1.x, a[3]); a[3] = fmaf(u1.y, v1.y, a[3]);
              a[3] = fmaf(u1.z, v1.z, a[3]); a[3] = fmaf(u1.w, v1.w, a[3]);
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) s[b][c] = a[c];
          }
        }
        // P = exp(S scale - lse), each operation rounded as the plain
        // version's; masked keys at -1e30 by select (exp gives 0), in the
        // tiles and warps that hold one only (uniform branches)
        float pr[2][4], lc[2][2] = {}, dc[2][2] = {};
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if constexpr (MODE == 1) {  // the tile's columns 16 p + 8 b + 2 t, + 1
            const float2 l2 = *reinterpret_cast<const float2*>(ls + 16 * p + 8 * b + 2 * t);
            const float2 d2 = *reinterpret_cast<const float2*>(ls + BT + 16 * p + 8 * b + 2 * t);
            lc[b][0] = l2.x, lc[b][1] = l2.y, dc[b][0] = d2.x, dc[b][1] = d2.y;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) s[b][c] = __fmul_rn(s[b][c], scale);
        }
        // the other side's row of value c of band b: 16 p + 8 b + 2 t + (c & 1)
        const int past = lim - o0 - 16 * p - 2 * t;  // it is at or past lim where 8 b + (c & 1) >= past
        if (MODE == 0 && edge) {
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (8 * b + (c & 1) >= past) s[b][c] = NEG_INF;
        }
        if (MODE == 1 && medge) {
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (c >> 1 ? mrow1 : mrow0) s[b][c] = NEG_INF;
        }
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            pr[b][c] = __expf(__fsub_rn(s[b][c], MODE == 0 ? lse_r[c >> 1] : lc[b][c & 1]));
        if (MODE == 1 && edge) {  // query rows past H: P exactly 0
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (8 * b + (c & 1) >= past) pr[b][c] = 0.f;
        }
        float dpv[2][4];
        product(1, dpv);
        // dS = P (dP - delta), then each band as one k8 step: acc1 += dS B1
        // (dQ += dS K; dK += dS^T Q), and after it in MODE 1 acc2 += P B2
        // (dV += P^T dO); the A operand from the C values c0, c2, c1, c3
        // (bt0: B1^T, or B2^T)
        auto band = [&](const unsigned (&xh)[4], const unsigned (&xl)[4], const float* bt0, int nb,
                        float (&acc)[DB][4]) {
#pragma unroll
          for (int dp = 0; dp < DH / 16; ++dp) {
            unsigned bh[4], bl[4];
            tt::ldmatrix_x4<false>(bh, bt0 + offv + dp * 16 * SKV + nb * 8);
            tt::ldmatrix_x4<false>(bl, bt0 + DH * SKV + offv + dp * 16 * SKV + nb * 8);
            float f[2][4];
            mma3x2(f, xh, xl, bh, bl);
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[2 * dp + e][c] += f[e][c];
          }
        };
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          unsigned xh[4], xl[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int ac = (c & 1) * 2 + (c >> 1);  // A slot c takes C value c0, c2, c1, c3
            const float de = MODE == 0 ? de_r[ac >> 1] : dc[b][ac & 1];
            float ds = __fmul_rn(pr[b][ac], __fsub_rn(dpv[b][ac], de));
            // MODE 1: a query row past H (a padded column) adds exactly 0
            if (MODE == 1 && edge && 8 * b + (ac & 1) >= past) ds = 0.f;
            split_all(ds, xh[c], xl[c]);
          }
          band(xh, xl, b1t, 2 * p + b, acc1);
        }
        if constexpr (MODE == 1) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            unsigned ph[4], pl[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) split_pos(pr[b][(c & 1) * 2 + (c >> 1)], ph[c], pl[c]);
            band(ph, pl, b2t, 2 * p + b, acc2);
          }
        }
      };
      if constexpr (AREG) {
#pragma unroll
        for (int p = 0; p < BT / 16; ++p) chunk(p);
      } else {  // past DH = 16: one chunk at a time (unrolled, B17's spill)
#pragma unroll 1
        for (int p = 0; p < BT / 16; ++p) chunk(p);
      }
    }

    if (++j == cI.T) {  // the item's last tile: its rows out, then the next item
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + g + 8 * h;
          if (r >= H) continue;
          const size_t o = (base + r) * DH + 2 * t;
          // MODE 1: a key at or past the length gets exact zeros
          const bool z = MODE == 1 && r >= len;
#pragma unroll
          for (int db = 0; db < DB; ++db) {
            *reinterpret_cast<float2*>(out1 + o + 8 * db) =
                z ? make_float2(0.f, 0.f)
                  : make_float2(acc1[db][2 * h] * scale, acc1[db][2 * h + 1] * scale);
            if constexpr (MODE == 1)
              *reinterpret_cast<float2*>(out2 + o + 8 * db) =
                  z ? make_float2(0.f, 0.f) : make_float2(acc2[db][2 * h], acc2[db][2 * h + 1]);
          }
        }
      }
      reset();
      j = 0;
      it += gridDim.x;
      cI = cN;
    }
  }
}

}  // namespace tc

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

float scale_of(int dh) { return (float)(1.0 / std::sqrt((double)dh)); }

int blocks_of(int N, int tiles) {
  return (int)(((long long)N * tiles + WARPS - 1) / WARPS);
}

template <int DH>
cudaError_t fwd(const float* q, const float* k, const float* v, const int* lens, float* out,
                float* lse, int N, int H, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * 2 * ROWS * DH * sizeof(float);
  cudaError_t err = prepare(attn_fwd_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (H + ROWS - 1) / ROWS;
  attn_fwd_kernel<DH><<<blocks_of(N, tiles), WARPS * 32, smem, stream>>>(
      q, k, v, lens, out, lse, N, H, tiles, scale_of(DH));
  return cudaGetLastError();
}

// A persistent kernel's grid: its dynamic shared memory set, and the blocks
// the card holds at once (asked once a device, into ``cache``).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int (&cache)[64], int& out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!cache[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = per_sm * sms;
  }
  out = cache[dev];
  return cudaSuccess;
}

template <int DH, int QW, int BK, int NS>
cudaError_t fwd_tc(const float* q, const float* k, const float* v, const int* lens, float* out,
                   float* lse, int N, int H, cudaStream_t stream) {
  using S = tc::Shape<DH, QW, BK, NS>;
  const auto kernel = tc::attn_fwd_tc_kernel<DH, QW, BK, NS>;
  static int grid_max[64] = {};
  int grid = 0;
  cudaError_t err = resident_blocks(kernel, S::NT, S::SMEM, grid_max, grid);
  if (err != cudaSuccess) return err;
  const int qtiles = (H + S::RQ - 1) / S::RQ;
  const long long items = (long long)N * qtiles;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)std::min<long long>(items, grid), S::NT, S::SMEM, stream>>>(
      q, k, v, lens, out, lse, H, qtiles, (int)items, scale_of(DH));
  return cudaGetLastError();
}

// B16 (MODE 0) or B17 (MODE 1) on the tensor cores: a1, a2 the own side's
// tensors, b1, b2 the other side's (see attn_bwd_tc_kernel).
template <int MODE, int DH, int W, int BT, int NS>
cudaError_t bwd_tc(const float* a1, const float* a2, const float* b1, const float* b2,
                   const float* lse, const float* delta, const int* lens, float* o1, float* o2,
                   int N, int H, cudaStream_t stream) {
  using S = tc::BwdShape<MODE, DH, W, BT, NS>;
  const auto kernel = tc::attn_bwd_tc_kernel<MODE, DH, W, BT, NS>;
  static int grid_max[64] = {};
  int grid = 0;
  cudaError_t err = resident_blocks(kernel, S::NT, S::SMEM, grid_max, grid);
  if (err != cudaSuccess) return err;
  const int otiles = (H + S::RO - 1) / S::RO;
  const long long items = (long long)N * otiles;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)std::min<long long>(items, grid), S::NT, S::SMEM, stream>>>(
      a1, a2, b1, b2, lse, delta, lens, o1, o2, H, otiles, (int)items, scale_of(DH));
  return cudaGetLastError();
}

// The backward's launch plans (ops/history_attention.py _BWD_PLANS,
// bwd_tc_shape): <W, BT, NS>; at DH = 64 one plan for both, four warps on
// tiles of 16 rows (B17 spills with eight warps or 32-row tiles there).
template <int MODE, int DH>
cudaError_t bwd_tc_plan(int plan, const float* a1, const float* a2, const float* b1,
                        const float* b2, const float* lse, const float* delta, const int* lens,
                        float* o1, float* o2, int N, int H, cudaStream_t stream) {
  if (plan < 0 || plan > 1) return cudaErrorInvalidValue;
  if constexpr (DH == 64)
    return bwd_tc<MODE, DH, 4, 16, 3>(a1, a2, b1, b2, lse, delta, lens, o1, o2, N, H, stream);
  else if (plan == 0)
    return bwd_tc<MODE, DH, 4, 64, 3>(a1, a2, b1, b2, lse, delta, lens, o1, o2, N, H, stream);
  else
    return bwd_tc<MODE, DH, 8, 64, 3>(a1, a2, b1, b2, lse, delta, lens, o1, o2, N, H, stream);
}

// The launch plans (ops/history_attention.py _TC_PLANS, tc_shape): <QW, BK,
// NS>; at DH = 64 key tiles of at most 32 keys (64 spill).
template <int DH>
cudaError_t fwd_tc_plan(int plan, const float* q, const float* k, const float* v, const int* lens,
                        float* out, float* lse, int N, int H, cudaStream_t stream) {
  constexpr int BKL = DH == 64 ? 32 : 64;
  switch (plan) {
    case 0: return fwd_tc<DH, 4, BKL, 3>(q, k, v, lens, out, lse, N, H, stream);
    case 1: return fwd_tc<DH, 8, BKL, 3>(q, k, v, lens, out, lse, N, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int DH>
cudaError_t dq(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, const int* lens, float* dqo, int N, int H,
               cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * 2 * ROWS * DH * sizeof(float);
  cudaError_t err = prepare(attn_dq_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (H + ROWS - 1) / ROWS;
  attn_dq_kernel<DH><<<blocks_of(N, tiles), WARPS * 32, smem, stream>>>(
      q, k, v, dout, lse, delta, lens, dqo, N, H, tiles, scale_of(DH));
  return cudaGetLastError();
}

template <int DH>
cudaError_t dkv(const float* q, const float* k, const float* v, const float* dout,
                const float* lse, const float* delta, const int* lens, float* dko, float* dvo,
                int N, int H, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * (2 * ROWS * DH + 2 * ROWS) * sizeof(float);
  cudaError_t err = prepare(attn_dkv_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (H + ROWS - 1) / ROWS;
  attn_dkv_kernel<DH><<<blocks_of(N, tiles), WARPS * 32, smem, stream>>>(
      q, k, v, dout, lse, delta, lens, dko, dvo, N, H, tiles, scale_of(DH));
  return cudaGetLastError();
}

}  // namespace

extern "C" int tt_blockwise_attn_fwd(const void* q, const void* k, const void* v,
                                     const void* lens, void* out, void* lse, int N, int H,
                                     int Dh, void* stream) {
#define TT_CALL(D) fwd<D>((const float*)q, (const float*)k, (const float*)v, (const int*)lens, \
                          (float*)out, (float*)lse, N, H, (cudaStream_t)stream)
  switch (Dh) {
    case 16: return (int)TT_CALL(16);
    case 32: return (int)TT_CALL(32);
    case 64: return (int)TT_CALL(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TT_CALL
}

extern "C" int tt_blockwise_attn_fwd_tc(const void* q, const void* k, const void* v,
                                        const void* lens, void* out, void* lse, int N, int H,
                                        int Dh, int plan, void* stream) {
#define TT_CALL(D) fwd_tc_plan<D>(plan, (const float*)q, (const float*)k, (const float*)v, \
                                  (const int*)lens, (float*)out, (float*)lse, N, H,          \
                                  (cudaStream_t)stream)
  switch (Dh) {
    case 16: return (int)TT_CALL(16);
    case 32: return (int)TT_CALL(32);
    case 64: return (int)TT_CALL(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TT_CALL
}

extern "C" int tt_blockwise_attn_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* lens, void* dqo, int N, int H, int Dh,
                                    void* stream) {
#define TT_CALL(D) dq<D>((const float*)q, (const float*)k, (const float*)v, (const float*)dout, \
                         (const float*)lse, (const float*)delta, (const int*)lens, (float*)dqo, \
                         N, H, (cudaStream_t)stream)
  switch (Dh) {
    case 16: return (int)TT_CALL(16);
    case 32: return (int)TT_CALL(32);
    case 64: return (int)TT_CALL(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TT_CALL
}

extern "C" int tt_blockwise_attn_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* lens, void* dko, void* dvo, int N, int H,
                                     int Dh, void* stream) {
#define TT_CALL(D) dkv<D>((const float*)q, (const float*)k, (const float*)v, (const float*)dout, \
                          (const float*)lse, (const float*)delta, (const int*)lens, (float*)dko, \
                          (float*)dvo, N, H, (cudaStream_t)stream)
  switch (Dh) {
    case 16: return (int)TT_CALL(16);
    case 32: return (int)TT_CALL(32);
    case 64: return (int)TT_CALL(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TT_CALL
}

extern "C" int tt_blockwise_attn_dq_tc(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* lens, void* dqo, int N, int H, int Dh,
                                       int plan, void* stream) {
#define TT_CALL(D) bwd_tc_plan<0, D>(plan, (const float*)q, (const float*)dout, (const float*)k, \
                                     (const float*)v, (const float*)lse, (const float*)delta,   \
                                     (const int*)lens, (float*)dqo, nullptr, N, H,              \
                                     (cudaStream_t)stream)
  switch (Dh) {
    case 16: return (int)TT_CALL(16);
    case 32: return (int)TT_CALL(32);
    case 64: return (int)TT_CALL(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TT_CALL
}

extern "C" int tt_blockwise_attn_dkv_tc(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* lens, void* dko, void* dvo, int N, int H,
                                        int Dh, int plan, void* stream) {
#define TT_CALL(D) bwd_tc_plan<1, D>(plan, (const float*)k, (const float*)v, (const float*)q, \
                                     (const float*)dout, (const float*)lse,                   \
                                     (const float*)delta, (const int*)lens, (float*)dko,      \
                                     (float*)dvo, N, H, (cudaStream_t)stream)
  switch (Dh) {
    case 16: return (int)TT_CALL(16);
    case 32: return (int)TT_CALL(32);
    case 64: return (int)TT_CALL(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TT_CALL
}
