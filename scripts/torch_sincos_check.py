#!/usr/bin/env python3
"""Check on the card that CUDA's sincosf gives sinf's and cosf's bits for
every float32.

usage: python scripts/torch_sincos_check.py

The rollout kernels (q1physrl_torch/ops/csrc/env_rollout.cu) take the sine
and cosine of one angle with sincosf, which shares one range reduction,
where their plain versions call torch.sin and torch.cos (sinf and cosf on
the card).  This builds a small check with the rollout library's nvcc
flags, runs sinf, cosf and sincosf on all 2^32 bit patterns, and prints the
card's name and power limit (nvidia-smi), then one JSON line: the count of
patterns whose results differ (NaNs of either kind count as equal), the
first such pattern, and the seconds taken.  Exits 1 if any differ.  Needs a
card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from q1physrl_torch.ops import env_rollout  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void check(unsigned long long base, unsigned long long* bad,
                      unsigned int* first) {
  const unsigned long long idx =
      base + blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
  const float x = __uint_as_float((unsigned int)idx);
  const float s1 = sinf(x), c1 = cosf(x);
  float s2, c2;
  sincosf(x, &s2, &c2);
  const bool same_s = __float_as_uint(s1) == __float_as_uint(s2) ||
                      (isnan(s1) && isnan(s2));
  const bool same_c = __float_as_uint(c1) == __float_as_uint(c2) ||
                      (isnan(c1) && isnan(c2));
  if (!(same_s && same_c)) {
    atomicAdd(bad, 1ull);
    atomicMin(first, (unsigned int)idx);
  }
}

extern "C" int run(unsigned long long* bad, unsigned int* first) {
  const unsigned long long chunk = 1ull << 28;
  for (unsigned long long base = 0; base < (1ull << 32); base += chunk) {
    check<<<(unsigned int)(chunk / 256), 256>>>(base, bad, first);
  }
  return (int)cudaDeviceSynchronize();
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="q1_sincos_") as work:
        src, lib = Path(work) / "check.cu", Path(work) / "check.so"
        src.write_text(SOURCE)
        env_rollout.compile_library(src, lib)
        fn = ctypes.CDLL(str(lib)).run
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bad = torch.zeros(1, dtype=torch.int64, device="cuda")
        first = torch.full((1,), -1, dtype=torch.int32, device="cuda")
        t0 = time.perf_counter()
        err = fn(bad.data_ptr(), first.data_ptr())
        seconds = time.perf_counter() - t0
    out = {"sincosf_vs_sinf_cosf": "all 2^32 float32 bit patterns",
           "cuda_error": err, "mismatches": int(bad),
           "first_mismatch": (hex(int(first) & 0xFFFFFFFF) if int(bad)
                              else None),
           "seconds": seconds, "device": torch.cuda.get_device_name(0)}
    print(json.dumps(out), flush=True)
    return 0 if err == 0 and int(bad) == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
