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
// into N; lse, delta [N, H] f32; lens [N] int32 in [1, H]; Dh in {16, 32, 64}.
//
// Bound on the H100: at the flagship shape (H = 32, Dh = 16, N = 4096 or
// 16384) bytes: each kernel reads and writes a few [N, H, Dh] tensors and
// does 32 x 16 multiply-adds per element pair (B15 ~0.04 ms at N = 16384).
// At a long history (H = 4096) operations: 4-8 N H^2 Dh f32 FLOP.  Design
// for a first version that is simple and right: one warp owns 32
// consecutive rows of one n (query rows in B15 and B16, key rows in B17),
// one row per lane, with the row and its f32 accumulators in registers.
// The other side's rows (k and v; or q, do, lse and delta) are staged 32 at
// a time in the warp's own slice of shared memory by 16-byte loads, and
// every lane reads the same staged row: a broadcast, free of bank
// conflicts.  So the [H, H] scores never exist, each input row is read
// once per warp, a warp needs no barrier but its own, and with H = 32 one
// warp covers a whole n (several n per block: 4 warps).  Keys past
// lens[n] are neither staged nor scored: the Pallas kernels add exactly 0
// for them.  No atomics: every sum is taken in one fixed order, so the
// results are bit-equal on repeat.  Left for later: tensor cores (wgmma),
// TMA staging, and more than one lane per row at long H (B17's four
// register rows spill at Dh = 64).

#include "common.cuh"

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
