#!/usr/bin/env python3
"""The rate and latency of mma.sync m16n8k8 TF32 on one CUDA card.

    python3 scripts/mma_sync_peak.py

The decode kernel (miso_tpu_torch/csrc/mtt_mma.cuh) runs on mma.sync, not
Hopper's warpgroup wgmma, so its tensor-core ceiling is what mma.sync reaches,
not the data sheet's dense TF32 peak.  This builds a kernel in which every
warp runs C independent accumulator chains of back-to-back mma.sync on
register operands, launches it with several warps per SM sub-partition and
chain counts, and prints the card, then one line per launch: TFLOP/s and
clocks per mma on each SM sub-partition, counted at the card's maximum SM
clock.  One chain on one warp per sub-partition shows the latency of a
dependent mma.
Imports torch and miso_tpu_torch only; the kernel builds into
miso_tpu_torch/_build/ with the port's nvcc flags.
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int CHAINS>
__global__ void chains(float* out, int iters) {
  float acc[CHAINS][4] = {};
  uint32_t a[4];
  for (int r = 0; r < 4; ++r) a[r] = __float_as_uint(1e-3f * (threadIdx.x + r)) & 0xffffe000u;
  const uint32_t b = __float_as_uint(1e-3f) & 0xffffe000u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                   : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(b));
    }
  }
  float s = 0.f;
  for (int j = 0; j < CHAINS; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run(float* out, int n_chains, int blocks, int threads, int iters) {
  switch (n_chains) {
    case 1: chains<1><<<blocks, threads>>>(out, iters); break;
    case 2: chains<2><<<blocks, threads>>>(out, iters); break;
    case 4: chains<4><<<blocks, threads>>>(out, iters); break;
    case 8: chains<8><<<blocks, threads>>>(out, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""

ITERS = 4096


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_sync_peak: no CUDA card", file=sys.stderr)
        return 1
    from miso_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "mma_sync_peak.cu"
    lib = _build.BUILD_DIR / "libmma_sync_peak.so"
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    props = torch.cuda.get_device_properties(0)
    sub_partitions = props.multi_processor_count * 4
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]) * 1e6
    out = torch.empty(props.multi_processor_count * 16 * 128, device="cuda")
    # (chains per warp, warps per sub-partition): the rate, then the latency.
    for n_chains, warps_per_sp in ((8, 4), (4, 8), (2, 16), (4, 1), (2, 1), (1, 1)):
        threads = 128 if warps_per_sp >= 4 else 32
        blocks = sub_partitions * warps_per_sp * 32 // threads
        for _ in range(2):
            assert run(out.data_ptr(), n_chains, blocks, threads, ITERS) == 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            assert run(out.data_ptr(), n_chains, blocks, threads, ITERS) == 0
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5
        mmas = n_chains * ITERS * blocks * threads // 32
        clocks = ms * 1e-3 * clock_hz / (mmas / sub_partitions)
        print(f"{n_chains} chains x {warps_per_sp} warps per sub-partition: {ms:.4f} ms, "
              f"{mmas * 2 * 16 * 8 * 8 / ms / 1e9:.1f} TFLOP/s, {clocks:.2f} clocks per mma "
              f"per sub-partition")
    return 0


if __name__ == "__main__":
    sys.exit(main())
