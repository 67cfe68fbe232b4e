"""Measure the card's `mma.sync` m16n8k8 .tf32 rate: the ceiling of the port's
3xTF32 cores (`csrc/mma_tf32.cuh`), which use this instruction and not wgmma.

    python -m denseclip_vit_multimodal_tpu_torch.tools.mma_tf32_peak [--chains 8]

Builds a small kernel (its source below) with the port's nvcc flags into
`build/mma_tf32_peak/`: every warp issues a long run of HMMAs into `chains`
independent accumulators (8 warps a block, 8 blocks an SM), and the kernel
is timed by CUDA events.  Prints one JSON line: TFLOP/s counted as 2 * 16 *
8 * 8 a HMMA, for one product a step (`1x`) and for the 3xTF32 pattern of
`mma_3xtf32` (three dependent HMMAs into one accumulator a step), beside
the card's name.  Nothing of the port calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int kChains, int kPerStep>
__global__ void __launch_bounds__(256) mma_loop(float* out, int steps) {
  float c[kChains][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  b[0] = 0x3f800000u + threadIdx.x;
  b[1] = b[0] + 1;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int p = 0; p < kPerStep; ++p)
#pragma unroll
      for (int j = 0; j < kChains; ++j)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float sum = 0.f;
  for (int j = 0; j < kChains; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <int kChains, int kPerStep>
int run(float* out, int blocks, int steps) {
  mma_loop<kChains, kPerStep><<<blocks, 256>>>(out, steps);
  return (int)cudaGetLastError();
}

extern "C" int mma_tf32_loop(void* out, int blocks, int steps, int chains, int per_step) {
  float* o = static_cast<float*>(out);
  if (per_step == 1) {
    if (chains == 1) return run<1, 1>(o, blocks, steps);
    if (chains == 4) return run<4, 1>(o, blocks, steps);
    if (chains == 8) return run<8, 1>(o, blocks, steps);
    if (chains == 16) return run<16, 1>(o, blocks, steps);
  } else if (per_step == 3) {
    if (chains == 1) return run<1, 3>(o, blocks, steps);
    if (chains == 4) return run<4, 3>(o, blocks, steps);
    if (chains == 8) return run<8, 3>(o, blocks, steps);
    if (chains == 16) return run<16, 3>(o, blocks, steps);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def build(out_dir: Path) -> ctypes.CDLL:
    from denseclip_vit_multimodal_tpu_torch.ops._build import NVCC_FLAGS, _nvcc

    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "mma_tf32_peak.cu", out_dir / "libmma_tf32_peak.so"
    src.write_text(SOURCE)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).mma_tf32_loop
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=4096)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mma_tf32_peak: needs a CUDA device")
    root = Path(__file__).resolve().parents[2]
    fn = build(root / "build" / "mma_tf32_peak")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 8 * sms
    out = torch.empty(blocks * 256, device="cuda")
    res = {"device": torch.cuda.get_device_name(0), "sms": sms, "blocks": blocks,
           "warps_per_sm": 64}
    for per_step in (1, 3):
        for chains in (1, 4, 8, 16):
            call = lambda: fn(out.data_ptr(), blocks, args.steps, chains, per_step)
            if call() != 0:
                raise RuntimeError("launch failed")
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(3):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 3
            hmma = blocks * 8 * args.steps * chains * per_step
            res[f"{per_step}x_chains{chains}_tflops"] = hmma * 2048 / (ms * 1e-3) / 1e12
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
