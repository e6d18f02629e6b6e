#!/usr/bin/env python3
"""Measure the warp-level tensor-core rate (``mma.sync``) of one NVIDIA GPU.

    python3 scripts/mma_rate.py

Builds a small CUDA library with ``nvcc`` (into ``build/mma_rate/``, for
``sm_90a``) whose kernels issue long runs of independent ``mma.sync``
instructions from every warp of a full grid: ``m16n8k16`` bf16 (the flash
kernels' product) and ``m16n8k8`` tf32 (the SSD kernels' product; a 3xTF32
product issues three).  Each warp keeps ``CHAINS`` accumulators, so the
rate is the pipe's, not one chain's latency.  Prints, per shape, the
achieved TFLOP/s (from CUDA events) beside the card's dense peak for that
type, and the card's name and power limit.  Needs one card; imports
neither jax nor the JAX package.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mma_rate"
PEAK = {"bf16_m16n8k16": 989e12, "tf32_m16n8k8": 495e12}
SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int CHAINS>
__global__ void __launch_bounds__(256) bf16_kernel(float* out, int iters) {
  float c[CHAINS][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                   threadIdx.x + 3};
  uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (s == 12345.f) out[0] = s;
}

template <int CHAINS>
__global__ void __launch_bounds__(256) tf32_kernel(float* out, int iters) {
  float c[CHAINS][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                   threadIdx.x + 3};
  uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (s == 12345.f) out[0] = s;
}

extern "C" float run(int kind, int chains, int blocks, int iters) {
  float* out;
  cudaMalloc(&out, 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  auto launch = [&]() {
    if (kind == 0) {
      if (chains == 4) bf16_kernel<4><<<blocks, 256>>>(out, iters);
      else bf16_kernel<8><<<blocks, 256>>>(out, iters);
    } else {
      if (chains == 4) tf32_kernel<4><<<blocks, 256>>>(out, iters);
      else tf32_kernel<8><<<blocks, 256>>>(out, iters);
    }
  };
  launch();
  cudaEventRecord(e0);
  launch();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "mma_rate.cu"
    lib = OUT / "libmma_rate.so"
    src.write_text(SRC)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import nvcc_path
    subprocess.run([nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    dll.run.argtypes = [ctypes.c_int] * 4
    dll.run.restype = ctypes.c_float
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    blocks, iters = 132 * 8, 4096
    rows = {}
    for kind, name, flop in ((0, "bf16_m16n8k16", 2 * 16 * 8 * 16),
                             (1, "tf32_m16n8k8", 2 * 16 * 8 * 8)):
        for chains in (4, 8):
            ms = dll.run(kind, chains, blocks, iters)
            if ms <= 0:
                print(f"mma_rate: {name} launch failed", file=sys.stderr)
                return 1
            n = blocks * 8 * iters * chains  # mma.sync issued
            rate = n * flop / (ms / 1e3)
            rows[f"{name} chains={chains}"] = dict(
                ms=ms, tflops=rate / 1e12, share_of_dense_peak=rate /
                PEAK[name])
    print(json.dumps({"card": smi, "blocks": blocks, "warps_per_block": 8,
                      "iters": iters, "rates": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
