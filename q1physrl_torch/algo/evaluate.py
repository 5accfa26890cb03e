"""Checkpoint evaluation CLI.

usage: python -m q1physrl_torch.algo.evaluate <run.yaml> <checkpoint>
           [num_episodes] [--device cuda|cpu]
       torchrun --standalone --nproc_per_node=W -m q1physrl_torch.algo.evaluate
           <run.yaml> <checkpoint> [num_episodes] [--backend nccl|gloo]

Reads the run config and an RLLib checkpoint pickle (the format both
packages share), and prints stochastic and deterministic zero-start
statistics — the low-variance measurement of the training north-star
metric.  ``<checkpoint>`` is the pickle itself, a directory holding it
(an ``iter_%07d`` directory of the trainer, or an exported one), or the
trainer's ``checkpoint_dir``, whose latest ``iter_*`` is scored.  Runs on
the card unless ``--device cpu`` is given.  Under torchrun (or inside a
process group the caller joined) each of the W ranks plays num_episodes /
W of the stochastic and 2 / W of the deterministic episodes (so W divides
both), on ``cuda:LOCAL_RANK`` unless ``--device`` names a device; rank 0
prints.
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch

from .. import analyse
from ..parallel import distributed
from ..parallel.mesh import env_shard
from ..models.import_rllib import import_policy_params
from ..models.policy import Policy
from .checkpoint import POLICY_FILE, latest_checkpoint
from .config import load_run_config

__all__ = ("main", "resolve_checkpoint")


def resolve_checkpoint(path: str) -> str:
    """The policy pickle that ``path`` names: ``path`` itself if it is a
    file; else the ``checkpoint`` pickle inside the latest ``iter_*`` of
    ``path`` or, when it has none, inside ``path``."""
    if os.path.isfile(path):
        return path
    return os.path.join(latest_checkpoint(path) or path, POLICY_FILE)


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
    parser.add_argument("checkpoint",
                        help="RLLib checkpoint pickle, a directory holding "
                             "one, or a training run's checkpoint_dir "
                             "(its latest iter_*)")
    parser.add_argument("num_episodes", nargs="?", type=int, default=512)
    parser.add_argument("--device",
                        help="default: cuda, or cuda:LOCAL_RANK under "
                             "torchrun")
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        help="process-group backend under torchrun (default: "
                             "nccl on cards, gloo on the CPU)")
    args = parser.parse_args(argv)

    under_torchrun = "WORLD_SIZE" in os.environ
    device = analyse.resolve_device(args.device or (
        f"cuda:{distributed.local_rank()}" if under_torchrun else "cuda"))
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    joined = distributed.is_initialized()
    distributed.initialize(backend=args.backend or (
        "nccl" if device.type == "cuda" else "gloo"))
    try:
        return _score(args, device)
    finally:
        if not joined:
            distributed.shutdown()


def _score(args, device):
    run = load_run_config(args.run_yaml)
    policy = Policy(run.env, device=device)
    path = resolve_checkpoint(args.checkpoint)
    policy.load_state_dict(import_policy_params(path))
    say = print if distributed.rank() == 0 else (lambda *a: None)
    say(f"checkpoint: {_describe(path)}")

    multi = distributed.is_initialized()
    sto = analyse.eval_zero_start(
        policy, run.env, num_episodes=args.num_episodes, device=device,
        shard=env_shard(args.num_episodes) if multi else None)
    det = analyse.eval_zero_start(
        policy, run.env, num_episodes=2, deterministic=True, device=device,
        shard=env_shard(2) if multi else None)
    say(f"zero-start stochastic ({args.num_episodes} episodes): "
        f"mean {sto['mean']:.0f}  median {sto['median']:.0f}  "
        f"std {sto['std']:.0f}  max {sto['max']:.0f}")
    say(f"zero-start deterministic: {det['mean']:.0f}")
    return sto, det


if __name__ == "__main__":
    main()
