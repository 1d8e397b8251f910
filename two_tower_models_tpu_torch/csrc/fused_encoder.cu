// Whole history encoder, forward: PE add, L-1 full self-attention layers,
// a thin last layer (query row 0 only), and the mean-pool of the input.
//
// Replaces two_tower_models_tpu/ops/pallas/fused_encoder.py:
// fused_history_encoder primal (_enc_fwd_impl -> _enc_fwd_kernel) with the
// fused_mha.py helpers it calls (_attend, _merge_heads, _group_ones,
// _mm_dtype).  x [B, H, D] (bf16 or f32) -> y [B, 2, D] in x's dtype:
// y[:, 0] = the last layer's row 0, y[:, 1] = mean over H of the input.
//
// Rounding points are the Pallas kernel's (under bf16 input every matmul
// operand is rounded to bf16, weights included, and accumulated in f32):
// x + PE in f32; biases added in f32; q, k, v rounded; per-head softmax
// max; the denominator sums the bf16-rounded exponentials; p = e /
// max(denom, 1e-30) rounded before P.V; the attention output rounded
// before the out-projection; a layer's output stays f32 until the next
// layer rounds it as its matmul operand.  Under f32 input nothing rounds.
//
// Bound on the H100: memory in principle (x is 4 MB in bf16 at B=1024,
// H=32, D=64 and ~4 GFLOP of matmuls), latency in this version.  Design:
// a block takes EPB examples; per layer it stages that layer's weights
// (64 KB f32 at D=64, pre-rounded) in shared memory once, then runs the
// layer for each of its examples with all activations in shared memory:
// x [EPB][H][D] across layers, qkv [H][3D], scores [NH][H][H], out [H][D].
// Matmuls are plain f32 FMA loops on the CUDA cores; wgmma is later work.
//
// With STACK (B8, replacing fused_encoder.py: fused_attn_stack ->
// _stack_fwd_kernel, call at :853) the same layers run as the length-masked
// attention stack: x arrives with its PE already added and rows past each
// length zeroed, there is no PE add and no mean-pool, a key column kj of
// example b is valid iff kj < lens[b] (an invalid score is -1e30 after the
// scale, before the per-head max, so its exponential is exactly 0), and the
// output is the last layer's row 0, y [B, D] in x's dtype.  Query rows at or
// past the length are still computed; their keys are masked, so they never
// reach row 0.  Without STACK every key is valid (lens is not read), and B1
// and B5 compute what they computed before the flag.
//
// With RES (B5, replacing _enc_fwd_res_kernel, fused_encoder.py:199-229,
// call at :561) the same forward also stores, in x's dtype, what the
// backward (fused_encoder_bwd.cu) rebuilds a layer from: each layer's input
// xs [L, B, H, D] and the probabilities of the full layers
// ps [L-1, B, NH, H, H] and of the thin last layer p0 [B, NH, H].  The
// probabilities are the rounded values P.V used, so the backward sees the
// forward's numbers.  Per head [NH, H, H] holds the values of the Pallas
// kernel's merged [H, NH*H] layout, without its padding.  B1 (RES = false)
// compiles to the code it had before the flag.
//
// B1, B5 and B8 on the tensor cores (encoder_tc_kernel<RES, STACK, HPB>)
// replace the same three Pallas kernels (pallas_calls at :506, :561 and
// :853) for bf16 x with D a multiple of 32, the head width a multiple of
// 16, Hp = round_up(H, 16) <= 64 and every layer's weights in shared memory
// beside one tile (ops/fused_encoder.py:_enc_route; f32, head width 8,
// longer histories and deeper or wider encoders keep encoder_kernel above).
// The Pallas dots are bf16 x bf16 with f32 sums, which is what mma.sync
// m16n8k16 computes, so every projection and every product of a full layer
// runs on it at the rounding points listed above; the sums run in another
// order than encoder_kernel's, so a bf16 rounding can flip where that
// kernel equals the plain version.
// Bound on the H100: operations for B1 and B8 (at B = 1024, H = 32, D = 64,
// three layers: 3.2 GFLOP, 0.0033 ms at the bf16 tensor-core rate, against
// 4.2 MB of x), bytes for B5 (at B = 4096 its residuals are 118 MB, 0.041
// ms at 3.35 TB/s, against 0.013 ms of operations).  Design, from B13's tensor-core kernel
// (csrc/fused_mha.cu, helpers in csrc/mha_tc.cuh), with the tile kept on
// chip across the layers:
// - a tile is E examples of Hp rows (E * Hp = 128 rows at H = 32: E = 4);
//   padded rows load as zeros and are never written, a padded key scores
//   -inf.  One block an SM (sixteen warps; eight for Hp = 48 and 64, whose
//   S bands need more registers), each walking its tiles in a persistent
//   loop;
// - round(W_in) and round(W_out) of every layer are staged as bf16 once a
//   block (34 KB a layer at D = 64, rows padded by 16 bytes), b_in and b_out
//   as f32;
// - two x buffers: the tile's activations, and the next tile's x, loaded
//   with cp.async behind the whole tile's compute.  Without STACK a pass
//   takes the mean-pool of the input column by column in encoder_kernel's
//   order and turns x into round(x + PE) in place;
// - a full layer is B13's: q | k | v by warp_gemm with each k16 step added
//   rounded, a warp per (example, head, band of 16 queries) with S in
//   registers and round(p) packed straight into P.V's A operand, then the
//   output projection, whose f32 output is rounded once into the
//   activation buffer: its only reader is the next layer's projection
//   (these layers have no residual and no norm), which is where
//   encoder_kernel rounds it too.  No round trip to device memory between
//   layers;
// - the thin last layer: k | v for every row; q of row 0 of each example,
//   E rows gathered into one 16-row band; the E x NH single-query
//   attentions on the CUDA cores in encoder_kernel's order (a lane a key);
//   one 16-row band of the output projection, written as y;
// - RES: each layer's input rows < H go to xs with 16-byte stores, round(p)
//   to ps and p0 from the registers that feed P.V (4-byte stores, pairs of
//   keys);
// - no float atomics and a fixed order of every sum: bit-equal on repeat.
// Shared memory at the cells (L = 3): 104 KB of weights, 36 KB of x
// buffers, 51 KB of q | k | v: 195,584 bytes.

#include "mha_tc.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float rnd(float x, bool bf) {
  return bf ? tt::round_bf16(x) : x;
}

__device__ __forceinline__ void store(void* dst, size_t i, float v, bool bf) {
  if (bf) ((__nv_bfloat16*)dst)[i] = __float2bfloat16_rn(v);
  else ((float*)dst)[i] = v;
}

template <bool RES, bool STACK>
__global__ void __launch_bounds__(THREADS)
encoder_kernel(const void* __restrict__ x_in, const float* __restrict__ pe,
               const int* __restrict__ lens,
               const float* __restrict__ w_in, const float* __restrict__ b_in,
               const float* __restrict__ w_out, const float* __restrict__ b_out,
               void* __restrict__ y_out, void* __restrict__ xs_out,
               void* __restrict__ ps_out, void* __restrict__ p0_out, int B,
               int H, int D, int NH, int L, int bf, int epb, float scale) {
  extern __shared__ float smem[];
  const int D3 = 3 * D;
  const int hd = D / NH;
  float* wi = smem;                // [D][3D]
  float* bi = wi + D * D3;         // [3D]
  float* wo = bi + D3;             // [D][D]
  float* bo = wo + D * D;          // [D]
  float* xs = bo + D;              // [EPB][H][D]
  float* qkv = xs + epb * H * D;   // [H][3D]
  float* s = qkv + H * D3;         // [NH][H][H] (row-0 only in the last layer)
  float* o = s + NH * H * H;       // [H][D]
  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const int e0 = blockIdx.x * epb;
  const int ne = min(epb, B - e0);
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x_in;
  const float* xf = (const float*)x_in;
  __nv_bfloat16* yb = (__nv_bfloat16*)y_out;
  float* yf = (float*)y_out;

  // layer-0 input (x + PE, or x alone in the stack) and the mean-pool
  for (int e = 0; e < ne; ++e) {
    const size_t base = (size_t)(e0 + e) * H * D;
    for (int i = t; i < H * D; i += THREADS) {
      float v = bf ? __bfloat162float(xb[base + i]) : xf[base + i];
      xs[e * H * D + i] = STACK ? v : v + pe[i];
    }
    if (STACK) continue;
    for (int c = t; c < D; c += THREADS) {
      float sum = 0.0f;
      for (int r = 0; r < H; ++r)
        sum += bf ? __bfloat162float(xb[base + r * D + c]) : xf[base + r * D + c];
      float mean = sum / (float)H;
      size_t oi = (size_t)(e0 + e) * 2 * D + D + c;
      if (bf) yb[oi] = __float2bfloat16_rn(mean); else yf[oi] = mean;
    }
  }

  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    const int nq = last ? 1 : H;  // query rows this layer computes
    __syncthreads();  // the previous layer's readers of wi/wo are done
    for (int i = t; i < D * D3; i += THREADS)
      wi[i] = rnd(w_in[(size_t)l * D * D3 + i], bf);
    for (int i = t; i < D3; i += THREADS) bi[i] = b_in[(size_t)l * D3 + i];
    for (int i = t; i < D * D; i += THREADS)
      wo[i] = rnd(w_out[(size_t)l * D * D + i], bf);
    for (int i = t; i < D; i += THREADS) bo[i] = b_out[(size_t)l * D + i];
    __syncthreads();

    for (int e = 0; e < ne; ++e) {
      float* x = xs + e * H * D;
      const int len = STACK ? lens[e0 + e] : H;  // valid keys of this example
      if (RES) {  // this layer's input, in x's dtype
        const size_t base = ((size_t)l * B + e0 + e) * H * D;
        for (int i = t; i < H * D; i += THREADS) store(xs_out, base + i, x[i], bf);
      }
      // qkv = round(round(x) @ round(W_in) + b_in); q for row 0 only when last
      for (int i = t; i < H * D3; i += THREADS) {
        int r = i / D3, j = i % D3;
        if (last && r > 0 && j < D) continue;
        float acc = 0.0f;
        for (int d = 0; d < D; ++d) acc = fmaf(rnd(x[r * D + d], bf), wi[d * D3 + j], acc);
        qkv[i] = rnd(acc + bi[j], bf);
      }
      __syncthreads();
      // scores s[h][qi][kj] = (q_qi . k_kj over head h) * scale, -1e30 at
      // keys past the length
      for (int i = t; i < NH * nq * H; i += THREADS) {
        int h = i / (nq * H), qi = (i / H) % nq, kj = i % H;
        const float* qp = qkv + qi * D3 + h * hd;
        const float* kp = qkv + kj * D3 + D + h * hd;
        float acc = 0.0f;
        for (int dd = 0; dd < hd; ++dd) acc = fmaf(qp[dd], kp[dd], acc);
        s[i] = kj < len ? acc * scale : -1e30f;
      }
      __syncthreads();
      // per-head softmax, one warp per (head, query row)
      for (int row = warp; row < NH * nq; row += THREADS / 32) {
        float* sr = s + row * H;
        float m = -INFINITY;
        for (int kj = lane; kj < H; kj += 32) m = fmaxf(m, sr[kj]);
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        float den = 0.0f;
        for (int kj = lane; kj < H; kj += 32) {
          float ev = expf(sr[kj] - m);
          sr[kj] = ev;
          den += rnd(ev, bf);
        }
        for (int off = 16; off > 0; off >>= 1)
          den += __shfl_xor_sync(0xffffffffu, den, off);
        den = fmaxf(den, 1e-30f);
        for (int kj = lane; kj < H; kj += 32) sr[kj] = rnd(sr[kj] / den, bf);
      }
      __syncthreads();
      if (RES) {  // the probabilities: [NH][H][H] per example, [NH][H] when last
        const int n = NH * nq * H;
        void* dst = last ? p0_out : ps_out;
        const size_t base = last ? (size_t)(e0 + e) * n
                                 : ((size_t)l * B + e0 + e) * n;
        for (int i = t; i < n; i += THREADS) store(dst, base + i, s[i], bf);
      }
      // o[qi][c] = round(sum_kj p[h(c)][qi][kj] * v[kj][c])
      for (int i = t; i < nq * D; i += THREADS) {
        int qi = i / D, c = i % D, h = c / hd;
        const float* pr = s + (h * nq + qi) * H;
        float acc = 0.0f;
        for (int kj = 0; kj < H; ++kj) acc = fmaf(pr[kj], qkv[kj * D3 + 2 * D + c], acc);
        o[i] = rnd(acc, bf);
      }
      __syncthreads();
      // y = o @ round(W_out) + b_out: the next layer's input, or the output
      for (int i = t; i < nq * D; i += THREADS) {
        int qi = i / D, j = i % D;
        float acc = 0.0f;
        for (int c = 0; c < D; ++c) acc = fmaf(o[qi * D + c], wo[c * D + j], acc);
        float y = acc + bo[j];
        if (!last) {
          x[i] = y;
        } else {
          size_t oi = (size_t)(e0 + e) * (STACK ? 1 : 2) * D + j;
          if (bf) yb[oi] = __float2bfloat16_rn(y); else yf[oi] = y;
        }
      }
      __syncthreads();
    }
  }
}

template <bool RES, bool STACK>
int launch(const void* x, const void* pe, const int* lens, const void* w_in,
           const void* b_in, const void* w_out, const void* b_out, void* y,
           void* xs, void* ps, void* p0, int B, int H, int D, int NH, int L,
           int bf, int epb, void* stream) {
  if (D % NH != 0 || epb < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)D * 3 * D + 3 * D + (size_t)D * D + D +
                        (size_t)epb * H * D + (size_t)H * 3 * D +
                        (size_t)NH * H * H + (size_t)H * D;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_kernel<RES, STACK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)(D / NH)));
  const int blocks = (B + epb - 1) / epb;
  encoder_kernel<RES, STACK><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, (const float*)pe, lens, (const float*)w_in, (const float*)b_in,
      (const float*)w_out, (const float*)b_out, y, xs, ps, p0, B, H, D, NH, L,
      bf, epb, scale);
  return (int)cudaGetLastError();
}

// ---- B1, B5 and B8 on the tensor cores -------------------------------------

namespace tc {

using namespace tt::tc;  // bf16, PAD, TILE_ROWS, warp_gemm, load_x, band_attention

// Threads of a block of the instance of HPB key bands: sixteen warps (128
// registers a thread) up to Hp = 32, eight (255) for Hp = 48 and 64, whose
// S bands spilled in 128.  One block an SM.
template <int HPB>
__host__ __device__ constexpr int threads_of() { return HPB <= 2 ? 512 : 256; }

// C [16, N] = A [16, K] . B [K, N] for one band of 16 rows: A's row i at
// arow(i) in shared memory, B by row (stride sb), N and K multiples of 16.
// Warp WARPS - 1 - w takes the columns 16 w .. 16 w + 15, so the band's
// few items land on the warps a warp_gemm of the same phase gives the
// fewest; each k16 step is added rounded, as in warp_gemm.
template <int WARPS, class Row, class Epi>
__device__ __forceinline__ void band_gemm(int N, int K, Row arow, const bf16* Bm, int sb, Epi epi) {
  const int warp = WARPS - 1 - (int)threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* a_row = arow(lane % 16);
  for (int n0 = 16 * warp; n0 < N; n0 += 16 * WARPS) {
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += 16) {
      unsigned a[4], b[4];
      tt::ldmatrix_x4<false>(a, a_row + k0 + (lane / 16) * 8);
      tt::ldmatrix_x4<true>(b, Bm + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * sb + n0 + (lane / 16) * 8);
      tt::mma_bf16_add(acc[0], a, b[0], b[1]);
      tt::mma_bf16_add(acc[1], a, b[2], b[3]);
    }
    const int g = lane / 4, q4 = lane % 4;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      epi(g, n0 + 8 * j + 2 * q4, acc[j][0], acc[j][1]);
      epi(g + 8, n0 + 8 * j + 2 * q4, acc[j][2], acc[j][3]);
    }
  }
}

// Rows < H of the tile's examples < B, from a tile [E*Hp][D+PAD] in shared
// memory to dst [B, H, D] in device memory, 16 bytes a store.
template <int THREADS>
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* X, int tile, int E, int Hp,
                                           int H, int D, int B) {
  const int cpr = D / 8;
  for (int i = threadIdx.x; i < E * Hp * cpr; i += THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    const int ex = tile * E + r / Hp, hi = r % Hp;
    if (ex < B && hi < H)
      *(uint4*)(dst + ((size_t)ex * H + hi) * D + c * 8) = *(const uint4*)(X + r * (D + PAD) + c * 8);
  }
}

// round(p) of one band attention, as band_attention hands it over (pa[kk]:
// keys 16 kk .. 16 kk + 15 of rows q0 + g and q0 + g + 8), into one head's
// probabilities dst [H, H]: rows and keys < H, a pair of keys a store
// where the pair is whole and 4-byte aligned, one key a store elsewhere.
template <int HPB>
__device__ __forceinline__ void store_probs(bf16* dst, const unsigned (&pa)[HPB][4], int q0,
                                            int H) {
  const int lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
#pragma unroll
  for (int kk = 0; kk < HPB; ++kk)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = q0 + g + (v & 1) * 8, k = 16 * kk + (v >> 1) * 8 + 2 * q4;
      if (r >= H || k >= H) continue;
      unsigned short* d = (unsigned short*)(dst + r * H + k);
      if (k + 1 < H && ((size_t)d & 3) == 0) {
        *(unsigned*)d = pa[kk][v];
      } else {
        d[0] = (unsigned short)(pa[kk][v] & 0xffffu);
        if (k + 1 < H) d[1] = (unsigned short)(pa[kk][v] >> 16);
      }
    }
}

// The thin last layer's attention of example e, head h, on the CUDA cores
// in encoder_kernel's order: a lane per key kj (and kj + 32), the score
// q0 . k_kj summed over the head width in order; the softmax's max and sum
// of round(e) by a butterfly over the lanes; p = round(e / max(den,
// 1e-30)); then a lane per column, o = round(sum over kj in order of p_kj
// v_kj), written to O [hd].  T (the tile's q | k | v, stride sq) holds q0
// at the example's first row; p0 (RES) takes round(p) [H].
template <bool RES>
__device__ __forceinline__ void thin_attention(const bf16* T, int sq, int D, int hd, int H,
                                               int len, float scale, bf16* O, bf16* p0) {
  const int lane = threadIdx.x % 32;
  const bf16* q = T;
  const bf16* K = T + D;
  const bf16* V = T + 2 * D;
  float e[2];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = lane + 32 * i;
    e[i] = -INFINITY;
    if (kj < H) {
      float acc = 0.0f;
      for (int d0 = 0; d0 < hd; d0 += 8) {
        const uint4 kv = *(const uint4*)(K + kj * sq + d0);
        const uint4 qv = *(const uint4*)(q + d0);
        const __nv_bfloat162* k2 = (const __nv_bfloat162*)&kv;
        const __nv_bfloat162* q2 = (const __nv_bfloat162*)&qv;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 kf = __bfloat1622float2(k2[j]), qf = __bfloat1622float2(q2[j]);
          acc = fmaf(qf.x, kf.x, acc);
          acc = fmaf(qf.y, kf.y, acc);
        }
      }
      e[i] = kj < len ? acc * scale : -1e30f;
    }
    m = fmaxf(m, e[i]);
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float den = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    e[i] = expf(e[i] - m);  // a padded key (-inf) gives 0, which adds nothing
    den += tt::round_bf16(e[i]);
  }
  for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
  den = fmaxf(den, 1e-30f);
  float p[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    p[i] = tt::round_bf16(e[i] == 0.0f ? 0.0f : e[i] / den);
    if (RES && lane + 32 * i < H) p0[lane + 32 * i] = __float2bfloat16_rn(p[i]);
  }
  for (int c0 = 0; c0 < hd; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < hd;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i)  // keys 32 i .. 32 i + 31 from the lanes' p[i]
      for (int kj = 32 * i; kj < min(H, 32 * i + 32); ++kj) {
        const float pk = __shfl_sync(0xffffffffu, p[i], kj - 32 * i);
        if (on) acc = fmaf(pk, __bfloat162float(V[kj * sq + c]), acc);
      }
    if (on) O[c] = __float2bfloat16_rn(acc);
  }
}

// HPB = Hp / 16: the key bands of one example.  RES: B5 (xs, ps, p0 too);
// STACK: B8 (lens, no PE, no pool, y [B, D]); neither: B1.
template <bool RES, bool STACK, int HPB>
__global__ void __launch_bounds__(threads_of<HPB>(), 1)
encoder_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ pe,
                  const int* __restrict__ lens, const float* __restrict__ w_in,
                  const float* __restrict__ b_in, const float* __restrict__ w_out,
                  const float* __restrict__ b_out, bf16* __restrict__ y, bf16* __restrict__ xs,
                  bf16* __restrict__ ps, bf16* __restrict__ p0, int B, int H, int D, int NH,
                  int L, int E, float scale) {
  constexpr int Hp = 16 * HPB, THREADS = threads_of<HPB>(), WARPS = THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D3 = 3 * D, hd = D / NH, rows = E * Hp;
  const int SWI = D3 + PAD, SWO = D + PAD, SX = D + PAD, SQ = D3 + PAD;
  bf16* Wi = (bf16*)smem_raw;             // [L][D][SWI] round(W_in)
  bf16* Wo = Wi + L * D * SWI;            // [L][D][SWO] round(W_out)
  bf16* Xb = Wo + L * D * SWO;            // [2][rows][SX] the tile's activations, the next tile's x
  bf16* QKV = Xb + 2 * rows * SX;         // [rows][SQ] q | k | v; attention out over q
  float* bi = (float*)(QKV + rows * SQ);  // [L][3D]
  float* bo = bi + L * D3;                // [L][D]
  __shared__ int sl[TILE_ROWS / 16];      // the tile's lengths
  const int t = threadIdx.x, warp = t / 32;
  const int tiles = (B + E - 1) / E;
  // thread t < E holds the length of example t of the next tile in len_next,
  // loaded beside that tile's x
  auto tile_len = [&](int tile) {
    const int ex = tile * E + t;
    return STACK && t < E && ex < B ? lens[ex] : H;
  };

  int len_next = tile_len(blockIdx.x);
  if ((int)blockIdx.x < tiles) load_x<THREADS>(Xb, x, blockIdx.x, E, Hp, H, D, B);
  tt::cp_commit();
  // every layer's weights as bf16, 16 bytes a load (the wrapper passes
  // 16-byte aligned weights; [L][D] rows of 3D and D floats)
  for (int i = t; i < L * D * D3 / 4; i += THREADS) {
    const float4 v = ((const float4*)w_in)[i];
    *(uint2*)(Wi + (4 * i / D3) * SWI + 4 * i % D3) =
        make_uint2(tt::pack_bf16x2(v.x, v.y), tt::pack_bf16x2(v.z, v.w));
  }
  for (int i = t; i < L * D * D / 4; i += THREADS) {
    const float4 v = ((const float4*)w_out)[i];
    *(uint2*)(Wo + (4 * i / D) * SWO + 4 * i % D) =
        make_uint2(tt::pack_bf16x2(v.x, v.y), tt::pack_bf16x2(v.z, v.w));
  }
  for (int i = t; i < L * D3; i += THREADS) bi[i] = b_in[i];
  for (int i = t; i < L * D; i += THREADS) bo[i] = b_out[i];

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += (int)gridDim.x, ++it) {
    bf16* X = Xb + (it & 1) * rows * SX;
    if (t < E) sl[t] = len_next;
    tt::cp_wait<0>();
    __syncthreads();  // x landed, weights and lengths staged, the previous tile done
    const int next = tile + (int)gridDim.x;
    if (next < tiles) {  // into the other buffer, behind this tile's layers
      load_x<THREADS>(Xb + ((it + 1) & 1) * rows * SX, x, next, E, Hp, H, D, B);
      len_next = tile_len(next);
    }
    tt::cp_commit();
    if (!STACK) {
      // the mean-pool of the input, a column at a time in encoder_kernel's
      // order; x becomes round(x + PE), layer 0's input, in place
      for (int i = t; i < E * D; i += THREADS) {
        const int e = i / D, c = i % D, ex = tile * E + e;
        bf16* col = X + e * Hp * SX + c;
        float sum = 0.0f;
        for (int r = 0; r < H; ++r) {
          const float v = __bfloat162float(col[r * SX]);
          sum += v;
          col[r * SX] = __float2bfloat16_rn(v + pe[r * D + c]);
        }
        if (ex < B) y[(size_t)ex * 2 * D + D + c] = __float2bfloat16_rn(sum / (float)H);
      }
      __syncthreads();  // layer 0's input complete
    }

    for (int l = 0; l < L; ++l) {
      const bf16* wi = Wi + l * D * SWI;
      const bf16* wo = Wo + l * D * SWO;
      const float* bil = bi + l * D3;
      const float* bol = bo + l * D;
      if constexpr (RES) store_rows<THREADS>(xs + (size_t)l * B * H * D, X, tile, E, Hp, H, D, B);
      if (l < L - 1) {
        warp_gemm<2, false, WARPS>(rows, D3, D, X, SX, wi, SWI, [&](int r, int c, float v0, float v1) {
          *(unsigned*)(QKV + r * SQ + c) = tt::pack_bf16x2(v0 + bil[c], v1 + bil[c + 1]);
        });
        __syncthreads();  // q | k | v complete; X is dead
        for (int u = warp; u < E * NH * HPB; u += WARPS) {
          const int e = u / (NH * HPB), h = (u / HPB) % NH, qb = u % HPB;
          const int ex = tile * E + e;
          if (ex >= B) continue;
          bf16* QO = QKV + (e * Hp + qb * 16) * SQ + h * hd;
          const bf16* K = QKV + e * Hp * SQ + D + h * hd;
          band_attention<HPB>(QO, K, K + D, SQ, hd, H, sl[e], scale,
                              [&](const unsigned (&pa)[HPB][4]) {
            if constexpr (RES)
              store_probs<HPB>(ps + (((size_t)l * B + ex) * NH + h) * H * H, pa, qb * 16, H);
          });
        }
        __syncthreads();  // the attention output is complete
        // the layer's output, rounded once: the next layer's input (padded rows stay 0)
        warp_gemm<2, false, WARPS>(rows, D, D, QKV, SQ, wo, SWO, [&](int r, int c, float v0, float v1) {
          *(unsigned*)(X + r * SX + c) =
              r % Hp < H ? tt::pack_bf16x2(v0 + bol[c], v1 + bol[c + 1]) : 0u;
        });
        __syncthreads();  // the next layer's input complete
      } else {
        // the thin last layer: k | v for every row, q for row 0 of each
        // example (rows e Hp of X as one band; rows past E repeat row 0)
        warp_gemm<2, false, WARPS>(rows, 2 * D, D, X, SX, wi + D, SWI,
                                   [&](int r, int c, float v0, float v1) {
          *(unsigned*)(QKV + r * SQ + D + c) = tt::pack_bf16x2(v0 + bil[D + c], v1 + bil[D + c + 1]);
        });
        band_gemm<WARPS>(D, D, [&](int i) { return X + (i < E ? i * Hp : 0) * SX; }, wi, SWI,
                  [&](int r, int c, float v0, float v1) {
          if (r < E) *(unsigned*)(QKV + r * Hp * SQ + c) = tt::pack_bf16x2(v0 + bil[c], v1 + bil[c + 1]);
        });
        __syncthreads();  // k | v and the q0 band complete; X is dead
        for (int u = warp; u < E * NH; u += WARPS) {  // round(o) of example e into X's row e
          const int e = u / NH, h = u % NH, ex = tile * E + e;
          if (ex >= B) continue;
          thin_attention<RES>(QKV + e * Hp * SQ + h * hd, SQ, D, hd, H, sl[e], scale,
                              X + e * SX + h * hd, RES ? p0 + ((size_t)ex * NH + h) * H : nullptr);
        }
        __syncthreads();  // the attention outputs of row 0 complete
        band_gemm<WARPS>(D, D, [&](int i) { return X + i * SX; }, wo, SWO,
                  [&](int r, int c, float v0, float v1) {
          const int ex = tile * E + r;
          if (r < E && ex < B)
            *(unsigned*)(y + (size_t)ex * (STACK ? 1 : 2) * D + c) =
                tt::pack_bf16x2(v0 + bol[c], v1 + bol[c + 1]);
        });
      }
    }
  }
  tt::cp_wait<0>();
}

// Shared memory of one block in bytes (ops/fused_encoder.py:_enc_tc_smem_bytes).
size_t smem_bytes(int rows, int D, int L) {
  return 2 * ((size_t)L * D * (3 * D + PAD) + (size_t)L * D * (D + PAD) +
              2 * (size_t)rows * (D + PAD) + (size_t)rows * (3 * D + PAD)) +
         16 * (size_t)L * D;
}

template <bool RES, bool STACK, int HPB>
int launch(const void* x, const void* pe, const void* lens, const void* w_in, const void* b_in,
           const void* w_out, const void* b_out, void* y, void* xs, void* ps, void* p0, int B,
           int H, int D, int NH, int L, int E, int grid, void* stream) {
  const size_t smem = smem_bytes(E * 16 * HPB, D, L);
  cudaError_t err = cudaFuncSetAttribute(encoder_tc_kernel<RES, STACK, HPB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)(D / NH)));
  encoder_tc_kernel<RES, STACK, HPB><<<grid, threads_of<HPB>(), smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)pe, (const int*)lens, (const float*)w_in,
      (const float*)b_in, (const float*)w_out, (const float*)b_out, (bf16*)y, (bf16*)xs,
      (bf16*)ps, (bf16*)p0, B, H, D, NH, L, E, scale);
  return (int)cudaGetLastError();
}

// Checks the shape and plan (ops/fused_encoder.py:_enc_tc_plan) and
// launches the instance of H's key bands.
template <bool RES, bool STACK>
int launch_hpb(const void* x, const void* pe, const void* lens, const void* w_in,
               const void* b_in, const void* w_out, const void* b_out, void* y, void* xs,
               void* ps, void* p0, int B, int H, int D, int NH, int L, int ept, int grid,
               void* stream) {
  const int hpb = (H + 15) / 16;
  if (B < 1 || H < 1 || NH < 1 || L < 1 || D % NH != 0 || D % 32 != 0 || (D / NH) % 16 != 0 ||
      hpb > 4 || ept < 1 || (ept * 16 * hpb) % 32 != 0 || ept * 16 * hpb > TILE_ROWS || grid < 1)
    return (int)cudaErrorInvalidValue;
  switch (hpb) {
    case 1: return launch<RES, STACK, 1>(x, pe, lens, w_in, b_in, w_out, b_out, y, xs, ps, p0, B, H, D, NH, L, ept, grid, stream);
    case 2: return launch<RES, STACK, 2>(x, pe, lens, w_in, b_in, w_out, b_out, y, xs, ps, p0, B, H, D, NH, L, ept, grid, stream);
    case 3: return launch<RES, STACK, 3>(x, pe, lens, w_in, b_in, w_out, b_out, y, xs, ps, p0, B, H, D, NH, L, ept, grid, stream);
    default: return launch<RES, STACK, 4>(x, pe, lens, w_in, b_in, w_out, b_out, y, xs, ps, p0, B, H, D, NH, L, ept, grid, stream);
  }
}

}  // namespace tc

}  // namespace

extern "C" int tt_fused_history_encoder(const void* x, const void* pe,
                                        const void* w_in, const void* b_in,
                                        const void* w_out, const void* b_out,
                                        void* y, int B, int H, int D, int NH,
                                        int L, int bf, int epb, void* stream) {
  return launch<false, false>(x, pe, nullptr, w_in, b_in, w_out, b_out, y,
                              nullptr, nullptr, nullptr, B, H, D, NH, L, bf,
                              epb, stream);
}

// B5: the forward plus its residuals xs, ps (null when L == 1) and p0.
extern "C" int tt_fused_history_encoder_res(
    const void* x, const void* pe, const void* w_in, const void* b_in,
    const void* w_out, const void* b_out, void* y, void* xs, void* ps, void* p0,
    int B, int H, int D, int NH, int L, int bf, int epb, void* stream) {
  return launch<true, false>(x, pe, nullptr, w_in, b_in, w_out, b_out, y, xs,
                             ps, p0, B, H, D, NH, L, bf, epb, stream);
}

// B8: the length-masked stack; x [B, H, D], lens [B] int32 -> y [B, D].
extern "C" int tt_fused_attn_stack(const void* x, const void* lens,
                                   const void* w_in, const void* b_in,
                                   const void* w_out, const void* b_out,
                                   void* y, int B, int H, int D, int NH, int L,
                                   int bf, int epb, void* stream) {
  return launch<false, true>(x, nullptr, (const int*)lens, w_in, b_in, w_out,
                             b_out, y, nullptr, nullptr, nullptr, B, H, D, NH,
                             L, bf, epb, stream);
}

// B1 on the tensor cores: x [B, H, D] bf16, pe [H, D] f32, f32 weights
// [L, ...] -> y [B, 2, D] bf16; x, W_in and W_out 16-byte aligned.  D a
// multiple of 32, D / NH of 16, Hp = round_up(H, 16) <= 64; ept examples a
// tile (ept * Hp a multiple of 32, at most 128), grid blocks
// (ops/fused_encoder.py:_enc_tc_plan).
extern "C" int tt_fused_history_encoder_tc(const void* x, const void* pe, const void* w_in,
                                           const void* b_in, const void* w_out,
                                           const void* b_out, void* y, int B, int H, int D,
                                           int NH, int L, int ept, int grid, void* stream) {
  return tc::launch_hpb<false, false>(x, pe, nullptr, w_in, b_in, w_out, b_out, y, nullptr,
                                      nullptr, nullptr, B, H, D, NH, L, ept, grid, stream);
}

// B5 on the tensor cores: B1's and the residuals xs, ps (null when L == 1)
// and p0, bf16, in tt_fused_history_encoder_res's layouts.
extern "C" int tt_fused_history_encoder_res_tc(const void* x, const void* pe, const void* w_in,
                                               const void* b_in, const void* w_out,
                                               const void* b_out, void* y, void* xs, void* ps,
                                               void* p0, int B, int H, int D, int NH, int L,
                                               int ept, int grid, void* stream) {
  return tc::launch_hpb<true, false>(x, pe, nullptr, w_in, b_in, w_out, b_out, y, xs, ps, p0,
                                     B, H, D, NH, L, ept, grid, stream);
}

// B8 on the tensor cores: x [B, H, D] bf16, lens [B] int32 -> y [B, D] bf16.
extern "C" int tt_fused_attn_stack_tc(const void* x, const void* lens, const void* w_in,
                                      const void* b_in, const void* w_out, const void* b_out,
                                      void* y, int B, int H, int D, int NH, int L, int ept,
                                      int grid, void* stream) {
  return tc::launch_hpb<false, true>(x, nullptr, lens, w_in, b_in, w_out, b_out, y, nullptr,
                                     nullptr, nullptr, B, H, D, NH, L, ept, grid, stream);
}
