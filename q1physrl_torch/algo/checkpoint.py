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

A population (``algo/population.py``) writes

- each member's best snapshot in the single-run format above, at a path
  of its own (``save_member_checkpoint``: a sweep's ``best_member_XX/``),
  which ``restore_checkpoint`` and the evaluate CLI take as they take an
  ``iter_*`` directory;
- its resume point as ``iter_%07d/population.pt`` (``save_population``):
  the stacked parameters and moments, the per-member counts, KL
  coefficients, iterations and env steps, and all P generator states.

``warm_start`` starts a run from a single-run checkpoint with a generator
of its own seed, so a checkpoint of either device kind warm-starts a run
on either.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Optional

import torch

from ..models.export_rllib import export_policy_params
from ..parallel import distributed

__all__ = ("save_checkpoint", "restore_checkpoint", "latest_checkpoint",
           "save_member_checkpoint", "warm_start", "save_population",
           "restore_population")

STATE_FILE = "train_state.pt"
POLICY_FILE = "checkpoint"
POPULATION_FILE = "population.pt"
# The stream a warm-started run draws from: its seed folded with this, as
# the JAX package's sweep reseeds with fold_in(key(seed), 17).
WARM_START_STREAM = 17


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


def _check_generator(path: str, saved, generator):
    """A CPU and a CUDA generator cannot carry each other's state, and
    reseeding would change the run: a mismatch raises ValueError, as does a
    checkpoint without a generator state (one exported from the JAX
    package, which a run can only warm-start from)."""
    if saved is None:
        raise ValueError(f"{path}: the checkpoint holds no generator state; "
                         f"warm-start from it (a sweep member's init_from)")
    if saved.numel() != generator.get_state().numel():
        raise ValueError(
            f"{path}: the checkpoint's generator state was saved from a "
            f"{_generator_kind(saved)} generator, restoring into a "
            f"{generator.device.type} one; resume on the device kind "
            f"the run was trained on")


def restore_checkpoint(path: str, ts, generator: bool = True):
    """Restore into an existing TrainState (shapes must match); its env
    state and episode accumulators stay as they are.

    The run's generator resumes only on the device kind it was saved from
    (a mismatch raises ValueError); ``generator=False`` leaves the live
    generator as it is and reads no saved one."""
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    if generator:
        _check_generator(path, tree.get("generator"), ts.generator)
    device = ts.kl_coeff.device
    ts.policy.load_state_dict(tree["params"])
    opt = tree["opt_state"]
    if generator:
        ts.generator.set_state(tree["generator"])
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


def save_member_checkpoint(path: str, ts) -> str:
    """Write a single-run TrainState (a population member's,
    ``population.member_train_state``) in the format of
    :func:`save_checkpoint` at ``path`` itself, replacing what is there
    only once the new files are complete; return the absolute path."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    _write(tmp, ts)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    return path


def warm_start(path: str, ts, seed: int):
    """``ts`` with the params, Adam's moments and count, KL coefficient,
    iteration and env steps of the checkpoint at ``path``, and its
    generator reseeded to ``seed`` folded with WARM_START_STREAM (SplitMix64,
    ``parallel/spmd.py:_fold_in``): the run's own stream, whatever device
    kind the checkpoint was trained on."""
    from ..parallel.spmd import _fold_in

    ts = restore_checkpoint(path, ts, generator=False)
    ts.generator.manual_seed(_fold_in(seed, WARM_START_STREAM))
    return ts


def save_population(directory: str, ps) -> str:
    """Write a PopulationState's resume point under
    ``directory/iter_%07d`` (member 0's iteration); return that path."""
    path = os.path.abspath(os.path.join(directory,
                                        f"iter_{ps.iteration[0]:07d}"))
    os.makedirs(path, exist_ok=True)
    cpu = lambda x: x.detach().cpu()
    tree = {"params": cpu(ps.policy.flat), "mu": cpu(ps.mu),
            "nu": cpu(ps.nu), "count": list(ps.count),
            "kl_coeff": cpu(ps.kl_coeff),
            "generators": [g.get_state() for g in ps.generators],
            "iteration": list(ps.iteration),
            "env_steps": list(ps.env_steps)}
    tmp = os.path.join(path, f"{POPULATION_FILE}.{os.getpid()}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, POPULATION_FILE))
    return path


def restore_population(path: str, ps):
    """Restore a population's resume point into ``ps`` (of the same
    members and layout); its env state and live episodes stay as they
    are.  Each generator resumes only on its saved device kind."""
    tree = torch.load(os.path.join(path, POPULATION_FILE),
                      map_location="cpu", weights_only=True)
    if len(tree["generators"]) != ps.members:
        raise ValueError(f"{path}: {len(tree['generators'])} members saved, "
                         f"restoring into {ps.members}")
    for saved, generator in zip(tree["generators"], ps.generators):
        _check_generator(path, saved, generator)
    with torch.no_grad():
        ps.policy.flat.copy_(tree["params"])
        ps.mu.copy_(tree["mu"])
        ps.nu.copy_(tree["nu"])
    for saved, generator in zip(tree["generators"], ps.generators):
        generator.set_state(saved)
    return dataclasses.replace(
        ps, count=[int(c) for c in tree["count"]],
        kl_coeff=tree["kl_coeff"].to(ps.kl_coeff.device),
        iteration=[int(i) for i in tree["iteration"]],
        env_steps=[float(s) for s in tree["env_steps"]])
