"""The rate of the warp-level tensor-core product (mma.sync) on the card, the
ceiling of the port's mma.sync kernels, for TF32 (m16n8k8, B10's 3xTF32
forward) and bf16 (m16n8k16, the encoder and attention kernels):

    python3 scripts/torch_mma_rate.py

A kernel of 256 threads issues, in every warp, ``chains`` independent
accumulator chains of mma.sync ``iters`` times over (``tt::mma_tf32`` and
``tt::mma_bf16`` of csrc/mma.cuh, built here with nvcc beside the port's
build); the grid holds 2 or 4 blocks an SM, so 16 or 32 warps an SM.
TFLOP/s = 2 m n k x products / (CUDA-event time of one launch, mean of 5
after a warm-up).  Prints the card's name and power limit, then one JSON
line.  Needs a GPU and nvcc.
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

SOURCE = r"""
#include "mma.cuh"

template <int KIND, int CH>
__global__ void bench(float* out, int iters) {
  unsigned a[4], b0 = threadIdx.x * 3u + 0x3f800000u, b1 = threadIdx.x + 0x3f000000u;
  for (int q = 0; q < 4; ++q) a[q] = 0x3f800000u + threadIdx.x * (q + 1);
  float c[CH][4];
  for (int n = 0; n < CH; ++n)
    for (int q = 0; q < 4; ++q) c[n][q] = 0.0f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      if (KIND == 0) tt::mma_tf32(c[n], a, b0, b1);
      else tt::mma_bf16(c[n], a, b0, b1);
    }
  }
  float s = 0.0f;
  for (int n = 0; n < CH; ++n)
    for (int q = 0; q < 4; ++q) s += c[n][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run_bench(int kind, int chains, int blocks, int iters, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0 && chains == 8) bench<0, 8><<<blocks, 256, 0, st>>>((float*)out, iters);
  else if (kind == 0 && chains == 2) bench<0, 2><<<blocks, 256, 0, st>>>((float*)out, iters);
  else if (kind == 1 && chains == 8) bench<1, 8><<<blocks, 256, 0, st>>>((float*)out, iters);
  else return 1;
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from two_tower_models_tpu_torch.ops import _lib

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, so = _lib.BUILD_DIR / "mma_rate.cu", _lib.BUILD_DIR / "mma_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC), "-shared", str(src),
                    "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.run_bench.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows, iters = [], 256
    for kind, chains, per_sm in ((0, 8, 2), (0, 8, 4), (0, 2, 4), (1, 8, 4)):
        launch = lambda: lib.run_bench(kind, chains, sms * per_sm, iters, out.data_ptr(), stream)
        if launch() != 0:
            raise RuntimeError("mma_rate launch failed")
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            launch()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5
        k = 8 if kind == 0 else 16
        flops = sms * per_sm * 8 * iters * chains * 2 * 16 * 8 * k
        rows.append({"type": "tf32 m16n8k8" if kind == 0 else "bf16 m16n8k16",
                     "chains_a_warp": chains, "warps_an_sm": 8 * per_sm, "ms": ms,
                     "tflops": flops / ms / 1e9})
    print(json.dumps({"device": torch.cuda.get_device_name(0), "mma_sync": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
