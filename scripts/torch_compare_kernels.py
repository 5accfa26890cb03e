#!/usr/bin/env python3
"""Time the rollout kernels of this tree against those of another copy of
``q1physrl_torch/ops/csrc`` (an earlier commit's), on one card, in turns.

usage: python scripts/torch_compare_kernels.py --other-csrc DIR
                                               [--label NAME] [--rounds R]

Builds the other sources with this tree's nvcc flags into a temporary
directory, then, at each kernel's main-path shapes (as ``chip_smoke.py``
names them: ``rollout_random`` at the bench and throughput shapes,
``rollout_actions`` at the scoring, analysis and throughput shapes,
``rollout_actions_autoreset`` at the training shape), times one launch of
each library's kernel through this tree's wrapper, from a CUDA-graph
replay, in the order other, this, this, other (``--rounds`` times), on the
same inputs.  The two libraries share the C interface, so only the
library under the wrapper changes; the other kernel may draw other random
bits, so only its time is compared.  Prints the card's name and power
limit, its SM clocks (maximum and at rest), then one JSON line per kernel
and shape with every time and the ratio of the means.  Needs a card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from q1physrl_torch.algo.config import load_run_config  # noqa: E402
from q1physrl_torch.ops import env_rollout  # noqa: E402

GRAPH_REPS = {"bench": 3, "throughput": 20, "scoring": 100, "analysis": 100,
              "training": 100}


class _Library:
    """A loaded library with this tree's argument types on its launchers."""

    def __init__(self, path, like):
        dll = ctypes.CDLL(str(path))
        for name in ("q1_rollout_actions", "q1_rollout_actions_autoreset",
                     "q1_rollout_random"):
            fn = getattr(dll, name)
            fn.argtypes = getattr(like, name).argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


def _cases(run, device):
    """{(kernel, shape): launch()} at the shapes chip_smoke.py times."""
    cases = {}
    for shape, (n, t, _, _) in chip_smoke.RANDOM_SHAPES.items():
        state, _, _ = chip_smoke.rollout_inputs(run.env, n, 1, 102, device)
        cases["rollout_random", shape] = (
            lambda s=state, t=t: env_rollout.rollout_random(run.env, s, t,
                                                            seed=3))
    for shape, (n, t, _, _) in chip_smoke.ACTIONS_SHAPES.items():
        state, ka, ya = chip_smoke.rollout_inputs(run.env, n, t, 100, device)
        cases["rollout_actions", shape] = (
            lambda s=state, ka=ka, ya=ya: env_rollout.rollout_actions(
                run.env, s, ka, ya))
    for shape, (n, t, _, _) in chip_smoke.AUTORESET_SHAPES.items():
        state, ka, ya = chip_smoke.rollout_inputs(run.env, n, t, 101, device)
        ru = chip_smoke._reset_uniforms(n, t, 101, device)
        cases["rollout_actions_autoreset", shape] = (
            lambda s=state, ka=ka, ya=ya, ru=ru:
            env_rollout.rollout_actions_autoreset(run.env, s, ka, ya, ru))
    return cases


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other-csrc", required=True)
    parser.add_argument("--label", default="other")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    clocks = subprocess.run(["nvidia-smi", "--id=0",
                             "--query-gpu=clocks.max.sm,clocks.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, check=True)
    print(json.dumps({"clocks_max_sm_and_sm": clocks.stdout.strip()}),
          flush=True)
    device = torch.device("cuda", 0)
    run = load_run_config(str(chip_smoke.RUN_YAML))
    this = env_rollout._library()
    with tempfile.TemporaryDirectory(prefix="q1_compare_") as work:
        libs = {"this": this,
                args.label: _Library(env_rollout.compile_library(
                    Path(args.other_csrc) / "env_rollout.cu",
                    Path(work) / "other_env_rollout.so"), this)}
        use = lambda name: setattr(env_rollout, "_library",
                                   lambda: libs[name])
        cases = _cases(run, device)
        for (kernel, shape), launch in cases.items():
            times = {name: [] for name in libs}
            for _ in range(args.rounds):
                for name in (args.label, "this", "this", args.label):
                    use(name)
                    times[name].append(chip_smoke._graph_ms(
                        launch, GRAPH_REPS[shape]))
            use("this")
            mean = {k: statistics.mean(v) for k, v in times.items()}
            print(json.dumps({"compare": kernel, "shape": shape,
                              "graph_ms": times, "mean_graph_ms": mean,
                              "this_over_" + args.label:
                              mean["this"] / mean[args.label]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
