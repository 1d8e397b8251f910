// One-pass Adam on one parameter leaf (B20), in place.
//
// Replaces two_tower_models_tpu/ops/pallas/fused_adam.py:_adam_leaf_kernel
// (pallas_call at :84, its body _adam_kernel at :43-55):
//   m <- b1 m + (1 - b1) g;  v <- b2 v + ((1 - b2) g) g
//   p <- p - (lr (m c0)) / (sqrt(v c1) + eps)
// with c = [1 / (1 - b1^t), 1 / (1 - b2^t)] in f32, read from device
// memory (computed on the device from the step count: no host sync), g
// cast to f32, m and v f32, p f32 or bf16 (computed in f32, rounded once).
// Every operation is rounded on its own (__fmul_rn, __fadd_rn,
// __fsqrt_rn, __fdiv_rn): nvcc would otherwise contract a multiply and an
// add into one FMA, and the plain version in ops/fused_adam.py, which
// rounds each operation, would differ in the last bit.
//
// Bound on the H100: bytes.  Each element reads p, m, v and g and writes p,
// m and v: 28 bytes an f32 element, 2^28-element tables ~2.2 ms each at
// 3.35 TB/s; 3 operations a byte would be needed to reach the f32 rate.
// Design: one grid-stride pass over the leaf's flat storage, four elements
// a thread per step with 16-byte loads and stores (8-byte for bf16) where
// every pointer is 16-byte aligned, a scalar loop otherwise and for the
// tail; a grid of a few blocks per SM, so the loads of one step overlap
// the arithmetic of another.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// the update of one element; p is read and written through the pointers
template <typename PT, typename GT>
__device__ __forceinline__ void adam_one(PT* p, float* m, float* v, const GT* g,
                                         const Hyper& h, float c0, float c1) {
  const float gf = to_f32(*g);
  const float mn = __fadd_rn(__fmul_rn(h.b1, *m), __fmul_rn(h.omb1, gf));
  const float vn = __fadd_rn(__fmul_rn(h.b2, *v), __fmul_rn(__fmul_rn(h.omb2, gf), gf));
  *m = mn;
  *v = vn;
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(vn, c1)), h.eps);
  const float upd = __fdiv_rn(__fmul_rn(h.lr, __fmul_rn(mn, c0)), den);
  from_f32(p, __fsub_rn(to_f32(*p), upd));
}

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { struct alignas(8) type { __nv_bfloat16 x[4]; }; };

template <typename T>
__device__ __forceinline__ void unpack(const typename Vec4<T>::type& w, T (&e)[4]) {
  static_assert(sizeof(w) == 4 * sizeof(T), "packed vector");
  memcpy(e, &w, sizeof(w));
}

template <typename PT, typename GT, bool VEC>
__global__ void __launch_bounds__(THREADS)
adam_kernel(PT* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
            const GT* __restrict__ g, const float* __restrict__ c, Hyper h, long long n) {
  const float c0 = c[0], c1 = c[1];
  const long long stride = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long n4 = n / 4;
    using PV = typename Vec4<PT>::type;
    using GV = typename Vec4<GT>::type;
    for (long long j = i; j < n4; j += stride) {
      float4 mv = reinterpret_cast<float4*>(m)[j], vv = reinterpret_cast<float4*>(v)[j];
      PT pe[4];
      GT ge[4];
      unpack<PT>(reinterpret_cast<const PV*>(p)[j], pe);
      unpack<GT>(reinterpret_cast<const GV*>(g)[j], ge);
      float me[4] = {mv.x, mv.y, mv.z, mv.w}, ve[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) adam_one(&pe[e], &me[e], &ve[e], &ge[e], h, c0, c1);
      reinterpret_cast<float4*>(m)[j] = make_float4(me[0], me[1], me[2], me[3]);
      reinterpret_cast<float4*>(v)[j] = make_float4(ve[0], ve[1], ve[2], ve[3]);
      PV pw;
      memcpy(&pw, pe, sizeof(pw));
      reinterpret_cast<PV*>(p)[j] = pw;
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride) adam_one(p + j, m + j, v + j, g + j, h, c0, c1);
}

template <typename PT, typename GT>
cudaError_t launch(void* p, void* m, void* v, const void* g, const void* c, const Hyper& h,
                   long long n, bool vec, cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = ((vec ? n / 4 : n) + THREADS - 1) / THREADS;
  const int blocks = (int)max(1LL, min(want, (long long)sms * 8));
  if (vec)
    adam_kernel<PT, GT, true><<<blocks, THREADS, 0, stream>>>(
        (PT*)p, (float*)m, (float*)v, (const GT*)g, (const float*)c, h, n);
  else
    adam_kernel<PT, GT, false><<<blocks, THREADS, 0, stream>>>(
        (PT*)p, (float*)m, (float*)v, (const GT*)g, (const float*)c, h, n);
  return cudaGetLastError();
}

}  // namespace

// p_bf16 / g_bf16: the leaf's and the gradient's type (0 f32, 1 bf16);
// vec: every pointer 16-byte aligned (the wrapper checks).  The constants
// come from the caller already rounded to f32, as PyTorch rounds a Python
// scalar in the plain version: 1 - b1 and 1 - b2 are taken in double first.
extern "C" int tt_fused_adam(void* p, void* m, void* v, const void* g, const void* c,
                             float lr, float b1, float omb1, float b2, float omb2, float eps,
                             int p_bf16, int g_bf16, int vec, long long n, void* stream) {
  const Hyper h{lr, b1, omb1, b2, omb2, eps};
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaSuccess;
  if (!p_bf16 && !g_bf16) return (int)launch<float, float>(p, m, v, g, c, h, n, vec, st);
  if (!p_bf16 && g_bf16) return (int)launch<float, __nv_bfloat16>(p, m, v, g, c, h, n, vec, st);
  if (p_bf16 && !g_bf16) return (int)launch<__nv_bfloat16, float>(p, m, v, g, c, h, n, vec, st);
  return (int)launch<__nv_bfloat16, __nv_bfloat16>(p, m, v, g, c, h, n, vec, st);
}
