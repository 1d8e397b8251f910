// Warpgroup-level tensor-core and bulk-copy helpers of the port's Hopper
// kernels (sm_90a only: wgmma, mbarrier transaction counts, 1-D bulk
// copies).
//
// Operand layout.  A wgmma operand in shared memory is read through a 64-bit
// descriptor.  The helpers use the K-major layout without swizzle: the
// matrix is cut into core matrices of 8 rows x 16 bytes (8 x 4 TF32), each
// stored as 128 contiguous bytes, row after row.  In a tile of R rows and D
// TF32 columns (D % 8 == 0), core matrix (r / 8, k / 4) starts at float
//   (r / 8) * 8 D + (k / 4) * 32,
// so the next core matrix along k lies 128 bytes on (the descriptor's
// leading byte offset, LBO) and the next 8 rows 32 D bytes on (its stride
// byte offset, SBO).  A k8 step of the product reads two core matrices along
// k: its descriptor starts 256 bytes further for each step.  tile_off gives
// the float offset of (row r, columns 4 kc .. 4 kc + 3): 16 bytes a thread
// write at once.  TF32 wgmma has no transpose: both A and B are K-major
// (A [M][K], B [N][K]).
//
// Accumulator (m64nNk8, f32): warp w of the warpgroup holds rows 16 w ..
// 16 w + 15; for g = lane / 4, t = lane % 4, register 4 i + 2 h + e holds
// row 16 w + g + 8 h, column 8 i + 2 t + e.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tt {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Float offset of (row r, columns 4 kc .. 4 kc + 3) in a K-major tile of D
// TF32 columns (layout above).
__device__ __forceinline__ int tile_off(int r, int kc, int D) {
  return (r >> 3) * 8 * D + kc * 32 + (r & 7) * 4;
}

// Descriptor of a K-major tile of D columns at p (16-byte aligned shared
// memory), for the k8 step that starts at p: no swizzle, base offset 0.
__device__ __forceinline__ uint64_t kmajor_desc(const float* p, int D) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)(128 >> 4) << 16;             // LBO: the next core matrix along k
  d |= (uint64_t)((32 * D) >> 4) << 32;        // SBO: the next 8 rows
  return d;
}

// Make this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma's operand reads, bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across a
// wgmma fence, commit or wait (its registers change under an async wgmma).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a . b (accumulate == 0) or d += a . b: m64n64k8, TF32 in, f32
// accumulate, A and B K-major in shared memory.  The tensor cores do not
// round the sum to nearest.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// mbarrier with an arrival count; completes a phase when the arrivals and
// the expected transaction bytes are in.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` more transaction bytes this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// One arrival (release: this thread's earlier writes are seen by the waiters).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on `bar` as transaction bytes: one thread issues it.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads, a
// multiple of 32: sync waits for all of them, arrive only counts this warp.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Move registers between the warpgroups of a block (warp-specialised
// kernels): every thread of the warpgroup executes it; N a multiple of 8 in
// 24 .. 256.
template <int N>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace tt
