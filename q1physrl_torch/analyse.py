"""Evaluation: the 512-episode zero-start instrument.

:func:`eval_zero_start` scores a policy on full zero-start episodes run in
lockstep: a Python loop over frames with a device-resident alive mask and
return accumulator.  Each frame samples the policy from the observation and
advances the env through ``ops.env_rollout.rollout_actions`` with T=1, so
on the card every env step is one launch of the CUDA rollout kernel.  Given
an env shard, each rank of a process group plays its share of the episodes
through ``ops.sharded_rollout.sharded_rollout_actions``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .env import core as env_core
from .env.config import Config
from .models.policy import Policy, action_dist
from .ops.env_rollout import rollout_actions
from .ops.sharded_rollout import sharded_rollout_actions
from .parallel import distributed
from .parallel.mesh import shard_env_axis

__all__ = ("eval_zero_start", "resolve_device")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


def _policy_from(policy, env_cfg: Config, deterministic: bool, shard=None):
    """Normalize a policy spec (:class:`Policy` | callable) to
    fn(obs, generator) -> (key_actions (K, N) int32, yaw_action (N,))."""
    if not isinstance(policy, Policy):
        return policy

    def fn(obs, generator):
        dist = action_dist(env_cfg, policy.pi(obs.to(torch.float32)))
        return dist.mode() if deterministic else dist.sample(generator, shard)

    return fn


def eval_zero_start(policy, env_config: Config, *, num_episodes: int = 512,
                    deterministic: bool = False, seed: int = 0,
                    device="cuda", shard=None) -> dict:
    """Batch-evaluate zero-start performance: the low-variance measurement
    of the training north-star.

    ``policy`` is a :class:`Policy` on ``device`` or a callable
    ``fn(obs, generator) -> (key_actions, yaw_action)``.  Runs
    ``num_episodes`` full zero-start episodes in lockstep and returns
    summary stats.  Float32 matrix products run in full float32 (TF32 off).

    ``shard``: a ``parallel.mesh.EnvShard`` of the ``num_episodes``
    episodes; this rank plays its share, drawing what one process would
    for those episodes from the generator every rank seeds alike, and the
    returns are gathered, so every rank returns the same summary.
    """
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(env_config, num_envs=None, zero_start_prob=1.0)
    n = num_episodes
    steps = int(np.ceil(cfg.time_limit / cfg.time_delta)) + 2
    policy_fn = _policy_from(policy, cfg, deterministic, shard)
    generator = torch.Generator(device).manual_seed(seed)
    step = rollout_actions if shard is None else sharded_rollout_actions

    with torch.inference_mode():
        state = env_core.reset(cfg, generator, n, device=device)
        if shard is not None:
            state = shard_env_axis(state, shard)
            n = shard.local
        ret = torch.zeros(n, dtype=torch.float32, device=device)
        alive = torch.ones(n, dtype=torch.bool, device=device)
        for _ in range(steps):
            obs = env_core.compute_obs(cfg, state.player, state.yaw,
                                       state.time_remaining)
            ka, ya = policy_fn(obs, generator)
            state, rewards, dones = step(
                cfg, state, ka.unsqueeze(0), ya.unsqueeze(0))
            ret += rewards[0] * alive
            alive &= ~dones[0]
        if shard is not None:
            ret = distributed.gather_env_axis(ret, shard)
        ret = ret.cpu().numpy()
    return {
        "mean": float(ret.mean()), "median": float(np.median(ret)),
        "std": float(ret.std()), "min": float(ret.min()),
        "max": float(ret.max()), "num_episodes": num_episodes,
    }
