"""The explicit data-parallel training iteration (``use_shard_map: true``).

Each rank rolls out its own envs with its own random stream, shuffles and
minibatches locally (minibatches of ``sgd_minibatch_size / W`` rows), and
the ranks meet only to sum the advantage moments, to average the gradients
and the loss statistics at every Adam step (one all-reduce per step), and
to sum the episode metrics (their max for ``episode_reward_max``).  The
minibatches are thus equal local slices of a global one, the standard
large-scale PPO layout; the gradient's expectation is that of one process.
``algo/ppo.py`` with an env shard is the other multi-rank mode, with the
semantics of one process.

The run's generator stays alike on every rank: at the top of an iteration
each rank draws one seed from it and folds in its rank to seed the stream
of its rollout and shuffles (:func:`rank_generator`): one generator per
rank, reseeded every iteration, so the rollout captured against it stays
bound to it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..algo.config import PPOConfig
from ..algo.ppo import (Batch, Coeffs, TrainState, Trajectory, adam_update,
                        aux_from_stats, compute_gae, episode_metrics,
                        flat_batch, iteration_coeffs, loss_and_stats,
                        next_state, rollout, standardize, update_kl_coeff)
from ..env.config import Config as EnvConfig
from ..utils.cuda_graph import LoopCache
from . import distributed

__all__ = ("make_spmd_train_iter", "rank_generator", "local_config", "learn")

_MASK64 = (1 << 64) - 1
# The rank generators that rank_generator reseeds, by (id of the run
# generator, rank), each kept beside the run generator it serves so that
# the id stays that generator's.
_RANK_GENERATORS = LoopCache(8)


def _fold_in(seed: int, rank: int) -> int:
    """SplitMix64 of ``seed`` and ``rank``: a 63-bit seed per rank."""
    z = (seed + (rank + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def rank_generator(generator: torch.Generator,
                   rank: Optional[int] = None) -> torch.Generator:
    """This rank's stream for one iteration: a seed drawn from the run's
    ``generator`` (advancing it alike on every rank), folded with the
    rank.  Every call for one run generator and rank reseeds and returns
    the same generator, to which a rollout captured as a CUDA graph stays
    bound."""
    rank = distributed.rank() if rank is None else rank
    seed = int(torch.randint(0, 1 << 62, (), generator=generator,
                             device=generator.device))
    _, kept = _RANK_GENERATORS.get(
        (id(generator), rank),
        lambda: (generator, torch.Generator(generator.device)))
    return kept.manual_seed(_fold_in(seed, rank))


def local_config(ppo: PPOConfig, world_size: int) -> PPOConfig:
    """One rank's share: num_envs / W envs, minibatches of
    sgd_minibatch_size / W rows."""
    if ppo.num_envs % world_size or ppo.sgd_minibatch_size % world_size:
        raise ValueError(f"num_envs={ppo.num_envs} and sgd_minibatch_size="
                         f"{ppo.sgd_minibatch_size} must split evenly over "
                         f"{world_size} ranks")
    return dataclasses.replace(
        ppo, num_envs=ppo.num_envs // world_size,
        sgd_minibatch_size=max(1, ppo.sgd_minibatch_size // world_size))


def _mean_over_ranks(grads, aux):
    """One all-reduce per Adam step: the gradients and the (5,) loss
    statistics averaged over the ranks."""
    flat = distributed.all_reduce_mean(
        torch.cat([g.reshape(-1) for g in grads] + [aux]))
    parts = torch.split(flat, [g.numel() for g in grads] + [aux.numel()])
    return [p.view_as(g) for p, g in zip(parts, grads)], parts[-1]


def learn(env_cfg: EnvConfig, ppo: PPOConfig, ts: TrainState,
          traj: Trajectory, bootstrap_value, generator: torch.Generator,
          coeffs: Optional[Coeffs] = None, perms=None):
    """The learning half of one rank's iteration on its local trajectory.

    ``generator``: this rank's stream (:func:`rank_generator`), which draws
    each epoch's local permutation; ``perms``: (num_sgd_iter, local batch)
    permutations to use instead.  Returns (TrainState, metrics), the
    metrics alike on every rank.
    """
    w = distributed.world_size()
    local = local_config(ppo, w)
    total = distributed.all_reduce_sum
    t, n = traj.reward.shape
    advantages, value_targets = compute_gae(local, traj.reward, traj.done,
                                            traj.value, bootstrap_value)
    advantages = standardize(advantages, t * n * w, total)
    batch = flat_batch(traj, advantages, value_targets)
    entropy_coeff, lr, kl_target = iteration_coeffs(ppo, ts, coeffs)

    n_mb = local.num_minibatches
    mb_size = local.batch_size // n_mb
    params = [dict(ts.policy.named_parameters())[k] for k in ts.opt_state.mu]
    opt_state = ts.opt_state
    keys = None
    for epoch in range(ppo.num_sgd_iter):
        if perms is None:
            perm = torch.randperm(local.batch_size, generator=generator,
                                  device=batch.obs.device)
        else:
            perm = torch.as_tensor(perms[epoch], device=batch.obs.device)
        shuffled = Batch(*(x[perm[:n_mb * mb_size]] for x in batch))
        stats = []
        for j in range(n_mb):
            mb = Batch(*(x[j * mb_size:(j + 1) * mb_size] for x in shuffled))
            loss, mb_stats = loss_and_stats(env_cfg, ppo, ts.policy, mb,
                                            ts.kl_coeff, entropy_coeff)
            grads = torch.autograd.grad(loss, params)
            mb_aux = aux_from_stats(mb_stats[None])
            keys = list(mb_aux)
            grads, mb_aux = _mean_over_ranks(
                grads, torch.stack([mb_aux[k] for k in keys]))
            opt_state = adam_update(ppo, params, grads, opt_state, lr)
            stats.append(mb_aux)
        aux = dict(zip(keys, torch.stack(stats).mean(0)))
    kl_coeff = update_kl_coeff(ppo, ts.kl_coeff, aux["kl"], kl_target)
    metrics = {**episode_metrics(ts.stats, traj.reward.sum(), t * n * w,
                                 total, distributed.all_reduce_max),
               "kl_coeff": kl_coeff, **aux}
    return next_state(ts, opt_state, kl_coeff, t * n * w), metrics


def make_spmd_train_iter(env_cfg: EnvConfig, ppo: PPOConfig,
                         with_coeffs: bool = False):
    """One rank's training iteration: ``fn(ts) -> (ts, metrics)``, or
    ``fn(ts, coeffs)`` with ``with_coeffs=True``, where entropy, lr and KL
    target come in at run time (as population sweeps drive them).  ``ts``
    holds this rank's envs (``parallel.mesh``)."""
    local_config(ppo, distributed.world_size())
    if with_coeffs and ppo.lr_schedule is not None:
        raise ValueError("with_coeffs=True requires ppo.lr_schedule=None "
                         "(a configured lr schedule would override "
                         "Coeffs.lr)")

    def fn(ts: TrainState, coeffs: Optional[Coeffs] = None):
        if with_coeffs != (coeffs is not None):
            raise TypeError("pass coeffs exactly when built with_coeffs")
        generator = rank_generator(ts.generator)
        env_state, stats, traj, bootstrap_value = rollout(
            env_cfg, ppo, ts.policy, ts.env_state, ts.stats, generator)
        ts = dataclasses.replace(ts, env_state=env_state, stats=stats)
        return learn(env_cfg, ppo, ts, traj, bootstrap_value, generator,
                     coeffs)

    return fn
