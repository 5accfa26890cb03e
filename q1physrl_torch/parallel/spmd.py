"""The explicit data-parallel layout (``use_shard_map: true``).

Each rank rolls out its own envs with its own random stream, shuffles and
minibatches locally (minibatches of ``sgd_minibatch_size / W`` rows), and
the ranks meet only to sum the advantage moments, to average the gradients
and the loss statistics at every Adam step (one all-reduce per step), and
to sum the episode metrics (their max for ``episode_reward_max``).  The
minibatches are thus equal local slices of a global one, the standard
large-scale PPO layout; the gradient's expectation is that of one process.
:class:`SpmdLayout` says so to the one learning half, ``algo/ppo.py``'s
``learn``; ``ppo.GlobalLayout`` is the other multi-rank layout, with the
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
from ..algo.ppo import (AUX_KEYS, Coeffs, OneProcess, TrainState,
                        aux_from_stats, train_iter)
from ..env.config import Config as EnvConfig
from ..utils.cuda_graph import LoopCache
from . import distributed

__all__ = ("make_spmd_train_iter", "rank_generator", "local_config",
           "SpmdLayout")

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


class SpmdLayout(OneProcess):
    """One rank of the explicit data-parallel iteration: this rank's stream
    (:func:`rank_generator`), its local batch and minibatches
    (:func:`local_config`), each step's gradients and five aux values
    averaged over the ranks."""

    name = "spmd"
    total = staticmethod(distributed.all_reduce_sum)
    maximum = staticmethod(distributed.all_reduce_max)

    def __init__(self, ppo: PPOConfig):
        self.world_size = distributed.world_size()
        local_config(ppo, self.world_size)  # raises unless ppo splits

    def generator(self, ts: TrainState) -> torch.Generator:
        return rank_generator(ts.generator)

    def local(self, ppo: PPOConfig) -> PPOConfig:
        return local_config(ppo, self.world_size)

    def reduce(self, grads, stats):
        aux = aux_from_stats(stats[None])
        return _mean_over_ranks(grads,
                                torch.stack([aux[k] for k in AUX_KEYS]))

    def epoch_aux(self, stats) -> dict:
        return dict(zip(AUX_KEYS, torch.stack(stats).mean(0)))


def make_spmd_train_iter(env_cfg: EnvConfig, ppo: PPOConfig,
                         with_coeffs: bool = False):
    """One rank's training iteration: ``fn(ts) -> (ts, metrics)``, or
    ``fn(ts, coeffs)`` with ``with_coeffs=True``, where entropy, lr and KL
    target come in at run time (as population sweeps drive them).  ``ts``
    holds this rank's envs (``parallel.mesh``)."""
    layout = SpmdLayout(ppo)
    if with_coeffs and ppo.lr_schedule is not None:
        raise ValueError("with_coeffs=True requires ppo.lr_schedule=None "
                         "(a configured lr schedule would override "
                         "Coeffs.lr)")

    def fn(ts: TrainState, coeffs: Optional[Coeffs] = None):
        if with_coeffs != (coeffs is not None):
            raise TypeError("pass coeffs exactly when built with_coeffs")
        return train_iter(env_cfg, ppo, ts, coeffs, layout)

    return fn
