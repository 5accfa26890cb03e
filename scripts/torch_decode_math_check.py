#!/usr/bin/env python3
"""Check on the card that the kernels' logf, expf, erff and ndtri give
torch.log's, torch.exp's, torch.erf's and torch.special.ndtri's bits for
every float32.

usage: python scripts/torch_decode_math_check.py

The decoded form of rollout_actions_kernel (q1physrl_torch/ops/csrc/
env_rollout.cu) samples the policy's actions in the kernel with logf (the
Gumbel-max), expf (the yaw's standard deviation) and erff (the squash's
ndtr), where the composed frame calls torch's own kernels; the PPO loss
head (q1physrl_torch/ops/csrc/ppo_head.cu) unsquashes the stored yaw action
with ndtri_like_torch (csrc/ndtri.cuh) where the composed head calls
torch.special.ndtri.  This builds a small kernel with the library's nvcc
flags that evaluates the four functions on all 2^32 bit patterns, 2^28 at
a time, compares each
chunk with torch's result on the card, and prints the card's name and
power limit (nvidia-smi), then one JSON line: per function the count of
patterns whose results differ (NaNs of either kind count as equal) and the
first such pattern, and the seconds taken.  Exits 1 if any differ.  Needs
a card and nvcc.
"""

from __future__ import annotations

import ctypes
import functools
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

#include "ndtri.cuh"

__global__ void eval(int fn, unsigned int base, float* out) {
  const unsigned int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float x = __uint_as_float(base + i);
  out[i] = fn == 0 ? logf(x)
         : fn == 1 ? expf(x)
         : fn == 2 ? erff(x) : ndtri_like_torch(x);
}

extern "C" int run(int fn, unsigned int base, unsigned int m, float* out,
                   void* stream) {
  eval<<<m / 256, 256, 0, (cudaStream_t)stream>>>(fn, base, out);
  return (int)cudaGetLastError();
}
"""

FUNCTIONS = {"logf": "log", "expf": "exp", "erff": "erf",
             "ndtri": "special.ndtri"}
CHUNK = 1 << 28


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    out = {"patterns": "all 2^32 float32 bit patterns", "cuda_error": 0,
           "device": torch.cuda.get_device_name(0)}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="q1_decode_math_") as work:
        src, lib = Path(work) / "check.cu", Path(work) / "check.so"
        src.write_text(SOURCE)
        env_rollout.compile_library(src, lib, include=env_rollout._CSRC)
        fn = ctypes.CDLL(str(lib)).run
        fn.argtypes = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        mine = torch.empty(CHUNK, dtype=torch.float32, device="cuda")
        offsets = torch.arange(CHUNK, dtype=torch.int64, device="cuda")
        for f_id, (name, op) in enumerate(FUNCTIONS.items()):
            bad, first = 0, None
            for base in range(0, 1 << 32, CHUNK):
                x = ((offsets + base) & 0xFFFFFFFF).to(torch.int32) \
                    .view(torch.float32)
                err = fn(f_id, base, CHUNK, mine.data_ptr(), stream)
                out["cuda_error"] = out["cuda_error"] or err
                theirs = functools.reduce(getattr, op.split("."), torch)(x)
                differ = ((mine.view(torch.int32) != theirs.view(torch.int32))
                          & ~(torch.isnan(mine) & torch.isnan(theirs)))
                n = int(differ.sum())
                if n and first is None:
                    idx = int(differ.nonzero()[0, 0])
                    first = hex((base + idx) & 0xFFFFFFFF)
                bad += n
            out[name] = {"mismatches": bad, "first_mismatch": first}
        torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    ok = out["cuda_error"] == 0 and all(out[f]["mismatches"] == 0
                                        for f in FUNCTIONS)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
