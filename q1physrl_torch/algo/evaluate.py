"""Checkpoint evaluation CLI.

usage: python -m q1physrl_torch.algo.evaluate <run.yaml> <checkpoint>
           [num_episodes] [--device cuda|cpu]

Reads the run config and an RLLib checkpoint pickle (the format both
packages share), and prints stochastic and deterministic zero-start
statistics — the low-variance measurement of the training north-star
metric.  Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import pickle

from .. import analyse
from ..models.import_rllib import import_policy_params
from ..models.policy import Policy
from .config import load_run_config

__all__ = ("main",)


def _describe(path: str) -> str:
    """``path``, plus iteration and env steps from its ``.tune_metadata``
    when that file exists."""
    meta_path = path + ".tune_metadata"
    if not os.path.exists(meta_path):
        return path
    with open(meta_path, "rb") as f:
        meta = pickle.load(f)
    return (f"{path} (iteration {int(meta['iteration'])}, "
            f"{int(meta['timesteps_total']):,} env steps)")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m q1physrl_torch.algo.evaluate",
        description="Score a checkpoint on zero-start episodes.")
    parser.add_argument("run_yaml")
    parser.add_argument("checkpoint", help="RLLib checkpoint pickle")
    parser.add_argument("num_episodes", nargs="?", type=int, default=512)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = analyse.resolve_device(args.device)
    run = load_run_config(args.run_yaml)
    policy = Policy(run.env, device=device)
    policy.load_state_dict(import_policy_params(args.checkpoint))
    print(f"checkpoint: {_describe(args.checkpoint)}")

    sto = analyse.eval_zero_start(policy, run.env,
                                  num_episodes=args.num_episodes,
                                  device=device)
    det = analyse.eval_zero_start(policy, run.env, num_episodes=2,
                                  deterministic=True, device=device)
    print(f"zero-start stochastic ({args.num_episodes} episodes): "
          f"mean {sto['mean']:.0f}  median {sto['median']:.0f}  "
          f"std {sto['std']:.0f}  max {sto['max']:.0f}")
    print(f"zero-start deterministic: {det['mean']:.0f}")
    return sto, det


if __name__ == "__main__":
    main()
