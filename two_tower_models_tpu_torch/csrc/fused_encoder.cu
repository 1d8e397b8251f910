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

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float rnd(float x, bool bf) {
  return bf ? tt::round_bf16(x) : x;
}

__global__ void __launch_bounds__(THREADS)
encoder_kernel(const void* __restrict__ x_in, const float* __restrict__ pe,
               const float* __restrict__ w_in, const float* __restrict__ b_in,
               const float* __restrict__ w_out, const float* __restrict__ b_out,
               void* __restrict__ y_out, int B, int H, int D, int NH, int L,
               int bf, int epb, float scale) {
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

  // layer-0 input (x + PE) and the mean-pool of the input
  for (int e = 0; e < ne; ++e) {
    const size_t base = (size_t)(e0 + e) * H * D;
    for (int i = t; i < H * D; i += THREADS) {
      float v = bf ? __bfloat162float(xb[base + i]) : xf[base + i];
      xs[e * H * D + i] = v + pe[i];
    }
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
      // qkv = round(round(x) @ round(W_in) + b_in); q for row 0 only when last
      for (int i = t; i < H * D3; i += THREADS) {
        int r = i / D3, j = i % D3;
        if (last && r > 0 && j < D) continue;
        float acc = 0.0f;
        for (int d = 0; d < D; ++d) acc = fmaf(rnd(x[r * D + d], bf), wi[d * D3 + j], acc);
        qkv[i] = rnd(acc + bi[j], bf);
      }
      __syncthreads();
      // scores s[h][qi][kj] = (q_qi . k_kj over head h) * scale
      for (int i = t; i < NH * nq * H; i += THREADS) {
        int h = i / (nq * H), qi = (i / H) % nq, kj = i % H;
        const float* qp = qkv + qi * D3 + h * hd;
        const float* kp = qkv + kj * D3 + D + h * hd;
        float acc = 0.0f;
        for (int dd = 0; dd < hd; ++dd) acc = fmaf(qp[dd], kp[dd], acc);
        s[i] = acc * scale;
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
          size_t oi = (size_t)(e0 + e) * 2 * D + j;
          if (bf) yb[oi] = __float2bfloat16_rn(y); else yf[oi] = y;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int tt_fused_history_encoder(const void* x, const void* pe,
                                        const void* w_in, const void* b_in,
                                        const void* w_out, const void* b_out,
                                        void* y, int B, int H, int D, int NH,
                                        int L, int bf, int epb, void* stream) {
  if (D % NH != 0 || epb < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)D * 3 * D + 3 * D + (size_t)D * D + D +
                        (size_t)epb * H * D + (size_t)H * 3 * D +
                        (size_t)NH * H * H + (size_t)H * D;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)(D / NH)));
  const int blocks = (B + epb - 1) / epb;
  encoder_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, (const float*)pe, (const float*)w_in, (const float*)b_in,
      (const float*)w_out, (const float*)b_out, y, B, H, D, NH, L, bf, epb,
      scale);
  return (int)cudaGetLastError();
}
