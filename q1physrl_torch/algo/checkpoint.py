"""Checkpoint save/restore.

A checkpoint is a directory ``iter_%07d`` holding

- ``train_state.pt``: ``torch.save`` of {params (the policy's state dict),
  opt_state (Adam's moments and count), kl_coeff, generator (the state of
  the run's ``torch.Generator``), iteration, env_steps};
- ``checkpoint`` and ``checkpoint.tune_metadata``: the policy as an RLLib
  pickle (models/export_rllib.py), the format the evaluate CLI scores.

Env state is left out: episodes restart on resume.  So the format does
not depend on how many ranks trained: a checkpoint of a multi-rank run
restores into one process, and the other way round.  In a process group
rank 0 alone writes, and every rank waits for it; every rank restores from
the same files.  The generator's state does bind a checkpoint to the
device kind it was trained on (CPU or CUDA).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from ..models.export_rllib import export_policy_params
from ..parallel import distributed

__all__ = ("save_checkpoint", "restore_checkpoint", "latest_checkpoint")

STATE_FILE = "train_state.pt"
POLICY_FILE = "checkpoint"


def save_checkpoint(directory: str, ts, iteration: int) -> str:
    """Write ``ts`` under ``directory/iter_%07d`` (replacing what is there);
    return that path.  In a process group only rank 0 writes, and every
    rank returns once it has."""
    path = os.path.abspath(os.path.join(directory, f"iter_{iteration:07d}"))
    if distributed.rank() == 0:
        _write(path, ts)
    distributed.barrier(ts.kl_coeff.device)
    return path


def _write(path: str, ts):
    os.makedirs(path, exist_ok=True)
    params = ts.policy.state_dict()
    tree = {
        "params": params,
        "opt_state": {"mu": ts.opt_state.mu, "nu": ts.opt_state.nu,
                      "count": ts.opt_state.count},
        "kl_coeff": ts.kl_coeff,
        "generator": ts.generator.get_state(),
        "iteration": ts.iteration,
        "env_steps": ts.env_steps,
    }
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    export_policy_params(params, os.path.join(path, POLICY_FILE),
                         iteration=ts.iteration,
                         timesteps_total=int(ts.env_steps))


def _generator_kind(state: torch.Tensor) -> str:
    """The kind of generator a stored state came from, by its size: a CUDA
    generator's is 16 bytes (seed and offset), a CPU generator's MT19937
    state about 5 KB."""
    return "cuda" if state.numel() == 16 else "cpu"


def restore_checkpoint(path: str, ts):
    """Restore into an existing TrainState (shapes must match); its env
    state and episode accumulators stay as they are.

    The run's generator resumes only on the device kind it was saved from:
    a CPU and a CUDA generator cannot carry each other's state, and
    reseeding would change the run, so a mismatch raises ValueError."""
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    saved = tree["generator"]
    live = ts.generator.get_state()
    if saved.numel() != live.numel():
        raise ValueError(
            f"{path}: the checkpoint's generator state was saved from a "
            f"{_generator_kind(saved)} generator, restoring into a "
            f"{ts.generator.device.type} one; resume on the device kind "
            f"the run was trained on")
    device = ts.kl_coeff.device
    ts.policy.load_state_dict(tree["params"])
    opt = tree["opt_state"]
    ts.generator.set_state(saved)
    return dataclasses.replace(
        ts,
        opt_state=dataclasses.replace(
            ts.opt_state,
            mu={k: v.to(device) for k, v in opt["mu"].items()},
            nu={k: v.to(device) for k, v in opt["nu"].items()},
            count=int(opt["count"])),
        kl_coeff=tree["kl_coeff"].to(device),
        iteration=int(tree["iteration"]),
        env_steps=float(tree["env_steps"]),
    )


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    entries = sorted(e for e in os.listdir(directory)
                     if e.startswith("iter_"))
    return os.path.join(directory, entries[-1]) if entries else None
