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

#include "common.cuh"

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
