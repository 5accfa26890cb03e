"""P independent PPO runs advanced in lockstep on one device.

The JAX package maps its whole iteration over a member axis in one
compiled program.  Here the P members share each launch instead:

- the env state holds the members' P * N envs, member-major (member i's
  envs are rows ``[i * N, (i + 1) * N)`` of every leaf's env axis), so a
  rollout frame is one stacked policy forward (``models.StackedPolicy``)
  and one launch of ``rollout_actions_autoreset`` on all P * N envs (on a
  card, of its decoded form, as ``ppo.RolloutLoop``'s fused frame);
- the learning half takes every member's minibatch together: one forward
  and backward of the stacked towers per minibatch, whose loss is the sum
  over members of each member's mean loss (so member gradients stay
  apart), and one Adam step on the stacked ``(P, D)`` parameters, with
  each member's global-norm clip, learning rate, bias corrections and
  update count (on a card, unclipped, one kernel: ``ops/adam.py``).

Member i draws from its own ``torch.Generator`` what a run of its seed
(``ppo.init_train_state``) would, in the same order and shapes: its policy
weights and first env states, then per frame its four key draws, its yaw
draw and its five reset uniforms, and one permutation per epoch.  So a
member's generator stays bitwise equal to its solo run's, and its numbers
agree with that run's to float32 rounding (the stacked products sum in
another order).

The learning half records spans (``utils.profiling``), as ``ppo.learn``
does: ``population.learn`` around :func:`learn`, ``population.update`` per
stacked step of :func:`sgd_epochs`, with ``population.loss``,
``population.grad`` and ``population.adam`` inside :func:`minibatch_step`;
the counter ``population.updates`` counts the stacked steps run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..env import core as env_core
from ..env.config import Config as EnvConfig
from ..models.policy import StackedPolicy
from ..ops import adam as adam_ops
from ..ops.env_rollout import rollout_actions_autoreset
from ..parallel.mesh import EnvShard, shard_env_axis
from ..utils.cuda_graph import LoopCache, param_addresses
from ..utils.profiling import count, span
from . import ppo as ppo_mod
from .config import PPOConfig
from .ppo import (ADAM_B1, ADAM_B2, ADAM_EPS, AdamState, Batch, Coeffs,
                  EpisodeStats, TrainState, Trajectory)

__all__ = ("PopulationState", "init_population", "stack_train_states",
           "member_train_state", "PopulationRolloutLoop", "rollout",
           "standardize", "member_batch", "population_loss_and_stats",
           "adam_step", "bias_corrections", "minibatch_step", "sgd_epochs",
           "learn", "next_state", "train_iter")


@dataclasses.dataclass
class PopulationState:
    """The stacked state of P members."""

    policy: StackedPolicy
    mu: torch.Tensor               # (P, D) Adam's first moments
    nu: torch.Tensor               # (P, D) Adam's second moments
    count: list                    # P Adam update counts (warm starts differ)
    env_state: env_core.EnvState   # P * N envs, member-major
    stats: EpisodeStats            # sums per member, (P,)
    kl_coeff: torch.Tensor         # (P,) float32
    generators: tuple              # P torch.Generators
    iteration: list                # P iterations (warm starts may differ)
    env_steps: list                # P float32 values, as a run keeps them

    @property
    def members(self) -> int:
        return len(self.generators)

    @property
    def num_envs(self) -> int:
        """N, each member's envs."""
        return self.env_state.num_envs // self.members


def _join(trees, fn):
    """``fn`` on the list of every leaf tensor of equal dataclasses."""
    changes = {}
    for f in dataclasses.fields(trees[0]):
        values = [getattr(t, f.name) for t in trees]
        if dataclasses.is_dataclass(values[0]):
            changes[f.name] = _join(values, fn)
        elif isinstance(values[0], torch.Tensor):
            changes[f.name] = fn(values)
    return dataclasses.replace(trees[0], **changes)


def stack_train_states(env_cfg: EnvConfig, states) -> PopulationState:
    """P single-run TrainStates (of N envs each) as one population, in the
    order given: the values are copied, the generators kept."""
    members = len(states)
    device = states[0].kl_coeff.device
    policy = StackedPolicy.from_policies(env_cfg,
                                         [ts.policy for ts in states])
    moments = [policy.flatten([torch.stack([getattr(ts.opt_state, m)[k]
                                            for ts in states])
                               for k in policy.shapes])
               for m in ("mu", "nu")]
    env_state = _join([ts.env_state for ts in states],
                      lambda xs: torch.cat(xs, -1))
    n = states[0].env_state.num_envs
    stats = EpisodeStats.zeros(
        members * n, device,
        ep_return=torch.cat([ts.stats.ep_return for ts in states]),
        ep_len=torch.cat([ts.stats.ep_len for ts in states]),
        members=members)
    return PopulationState(
        policy=policy, mu=moments[0], nu=moments[1],
        count=[ts.opt_state.count for ts in states], env_state=env_state,
        stats=stats, kl_coeff=torch.stack([ts.kl_coeff for ts in states]),
        generators=tuple(ts.generator for ts in states),
        iteration=[ts.iteration for ts in states],
        env_steps=[ts.env_steps for ts in states])


def init_population(seeds, env_cfg: EnvConfig, ppo: PPOConfig,
                    device="cuda", init_from=None) -> PopulationState:
    """One member per seed: ``ppo.init_train_state(seed)`` for each, so its
    weights, env states and generator equal a solo run's to the bit, then
    stacked.  ``init_from``: per member, None or a single-run checkpoint to
    warm-start from (``checkpoint.warm_start``)."""
    from .checkpoint import warm_start

    states = []
    for i, seed in enumerate(seeds):
        ts = ppo_mod.init_train_state(seed, env_cfg, ppo, device)
        if init_from is not None and init_from[i]:
            ts = warm_start(init_from[i], ts, seed)
        states.append(ts)
    return stack_train_states(env_cfg, states)


def member_train_state(env_cfg: EnvConfig, ps: PopulationState,
                       i: int) -> TrainState:
    """Member ``i`` as a single-run TrainState (copies of its weights,
    moments, env state and live episodes; its own generator)."""
    shard = EnvShard(i, ps.members, ps.env_state.num_envs)
    n = ps.num_envs
    mu, nu = ps.policy.views(ps.mu), ps.policy.views(ps.nu)
    return TrainState(
        policy=ps.policy.member_policy(env_cfg, i),
        opt_state=AdamState(mu={k: v[i].clone() for k, v in mu.items()},
                            nu={k: v[i].clone() for k, v in nu.items()},
                            count=ps.count[i]),
        env_state=shard_env_axis(ps.env_state, shard),
        stats=EpisodeStats.zeros(
            n, ps.kl_coeff.device,
            ep_return=shard.take(ps.stats.ep_return),
            ep_len=shard.take(ps.stats.ep_len)),
        kl_coeff=ps.kl_coeff[i].clone(), generator=ps.generators[i],
        iteration=ps.iteration[i], env_steps=ps.env_steps[i])


# The population rollout loops of recent calls of :func:`rollout`.
_LOOPS = LoopCache(2)


class PopulationRolloutLoop(ppo_mod.RolloutLoop):
    """``ppo.RolloutLoop`` over P members' P * N envs with the stacked
    policy and all P generators (each registered with the frame's CUDA
    graph): per frame one stacked forward, each member's key, yaw and
    reset draws from its own generator, and one launch on all P * N envs:
    of ``rollout_actions_autoreset`` (with ``out=``) in the composed frame,
    of its decoded form in the fused one (``fused``), which reads each
    member's draws from its own block."""

    def __init__(self, env_cfg: EnvConfig, ppo: PPOConfig,
                 policy: StackedPolicy, generators: tuple, device,
                 fused: bool = False):
        if len(generators) != policy.members:
            raise ValueError(f"{len(generators)} generators for "
                             f"{policy.members} members")
        super().__init__(env_cfg, ppo, policy, tuple(generators),
                         policy.members * ppo.num_envs, device, fused=fused)
        self.env_step = rollout_actions_autoreset  # one device, no group


def rollout(env_cfg: EnvConfig, ppo: PPOConfig, policy: StackedPolicy,
            env_state: env_core.EnvState, stats: EpisodeStats,
            generators: tuple, driver=None):
    """``ppo.rollout`` for a population: T frames of P * N envs
    (``ppo.num_envs`` per member).  ``driver`` as there; the loop is kept
    in ``_LOOPS`` by what its capture is bound to.  Returns (env_state',
    stats', trajectory (T, P * N, ...), bootstrap_value (P * N,))."""
    device = env_state.yaw.device
    fused = ppo_mod._takes_fused_rollout(policy, env_cfg, None, device)
    key = (env_cfg, ppo, env_state.num_envs, device, fused, id(policy),
           param_addresses(policy), ppo_mod.generator_ids(tuple(generators)))
    loop = _LOOPS.get(key, lambda: PopulationRolloutLoop(
        env_cfg, ppo, policy, tuple(generators), device, fused))
    return loop.rollout(env_state, stats, driver)


def standardize(advantages, members: int):
    """``ppo.standardize`` for each member over its own (T, N) advantages
    of a (T, P * N) tensor, as a run of its own standardizes its batch."""
    t = advantages.shape[0]
    a = advantages.view(t, members, -1)
    count = t * a.shape[-1]
    mean = a.sum((0, 2), keepdim=True) / count
    var = torch.square(a - mean).sum((0, 2), keepdim=True) / count
    return ((a - mean) / torch.clamp(torch.sqrt(var), min=1e-4)).view(
        advantages.shape)


def member_batch(traj: Trajectory, advantages, value_targets,
                 members: int) -> Batch:
    """Each member's (T * N, ...) training batch, stacked: (P, T * N, ...),
    member i's rows in its solo run's order t * N + env."""
    columns = [traj.obs, traj.key_actions.transpose(1, 2),  # (T, P*N, K)
               traj.yaw_actions, traj.logits, traj.logp, traj.value,
               advantages, value_targets]
    t = traj.reward.shape[0]

    def stacked(x):
        x = x.reshape((t, members, -1) + tuple(x.shape[2:]))
        return x.transpose(0, 1).reshape((members, -1) + tuple(x.shape[3:]))

    return Batch(*(stacked(x) for x in columns))


def population_loss_and_stats(env_cfg: EnvConfig, ppo: PPOConfig,
                              policy: StackedPolicy, batch: Batch, kl_coeff,
                              entropy_coeff):
    """``ppo.loss_and_stats`` on a (P, B, ...) batch: the sum over members of
    each member's mean loss, and the (P, 8) statistics.  ``kl_coeff`` and
    ``entropy_coeff``: (P, 1)."""
    row_total, policy_loss, action_kl, vf_loss, entropy, value = (
        ppo_mod.head_terms(env_cfg, ppo, policy, batch, kl_coeff,
                           entropy_coeff))
    total = torch.mean(row_total, -1).sum()
    with torch.no_grad():
        residual = batch.value_target - value
        stats = torch.stack([
            torch.mean(policy_loss, -1), torch.mean(vf_loss, -1),
            torch.mean(action_kl, -1), torch.mean(entropy, -1),
            torch.mean(batch.value_target, -1),
            torch.var(batch.value_target, -1, correction=0),
            torch.mean(residual, -1), torch.var(residual, -1, correction=0)],
            -1)
    return total, stats


def adam_step(ppo: PPOConfig, ps: PopulationState, grads, bc1, bc2,
              neg_lr):
    """One Adam step of every member on the stacked parameters, in place:
    ``ppo.adam_update``'s operations on (P, D) tensors, with each member's
    global-norm clip, bias corrections ``bc1``/``bc2`` (P, 1) and learning
    rate (``neg_lr``: (P, 1), negated).

    Where ``ppo._takes_fused_adam`` holds, the fused step (``ops.adam``,
    one kernel, each gradient read where autograd left it) runs; else the
    composed step on the flattened gradients.  The counters
    ``population.fused_adam`` and ``population.composed_adam`` count the
    steps of each."""
    flat = ps.policy.flat
    table = ppo_mod._takes_fused_adam(ppo, flat, grads, ps.mu, ps.nu, bc1)
    if table:
        count("population.fused_adam")
        adam_ops.adam(ppo_mod.ADAM, flat, grads, ps.mu, ps.nu, bc1, bc2,
                      neg_lr, table=table)
        return
    count("population.composed_adam")
    g = ps.policy.flatten(grads)
    if ppo.grad_clip is not None:
        norm = torch.sqrt(torch.sum(g * g, 1, keepdim=True))
        g = torch.where(norm < ppo.grad_clip, g, (g / norm) * ppo.grad_clip)
    with torch.no_grad():
        ps.mu.mul_(ADAM_B1).add_(g * (1 - ADAM_B1))
        ps.nu.mul_(ADAM_B2).add_((g * g) * (1 - ADAM_B2))
        denom = torch.sqrt(ps.nu / bc2).add_(ADAM_EPS)
        updates = (ps.mu / bc1) / denom
        updates.mul_(neg_lr)
        ps.policy.flat.add_(updates)


def bias_corrections(count, steps: int, device):
    """(steps, P, 1) tables of Adam's bias corrections for the next
    ``steps`` updates of members at update counts ``count``, each
    ``float32(1 - b ** count)`` as ``ppo.adam_update`` rounds it."""
    counts = (np.arange(1, steps + 1)[:, None]
              + np.asarray(count)[None, :]).astype(np.float64)
    table = lambda b: torch.from_numpy(
        (1 - b ** counts).astype(np.float32)[..., None]).to(device)
    return table(ADAM_B1), table(ADAM_B2)


def minibatch_step(env_cfg: EnvConfig, ppo: PPOConfig, ps: PopulationState,
                   mb: Batch, kl_coeff, entropy_coeff, bc1, bc2, neg_lr):
    """One minibatch of every member: the stacked towers' forward and
    backward on ``mb`` (P, rows, ...), then :func:`adam_step`.  Returns the
    (P, 8) loss statistics."""
    with span("population.loss"):
        total, stats = population_loss_and_stats(env_cfg, ppo, ps.policy,
                                                 mb, kl_coeff, entropy_coeff)
    with span("population.grad"):
        grads = torch.autograd.grad(total, list(ps.policy.parameters()))
    with span("population.adam"):
        adam_step(ppo, ps, grads, bc1, bc2, neg_lr)
    return stats


def sgd_epochs(env_cfg: EnvConfig, ppo: PPOConfig, ps: PopulationState,
               batch: Batch, entropy_coeff, lr, perms=None):
    """``ppo.sgd_epochs`` for every member at once on a (P, B, ...) batch:
    per epoch each member's permutation (from its generator, or ``perms``
    (P, num_sgd_iter, n_mb * mb_size)) gathered in one indexing per
    column, then per minibatch one forward and backward of the stacked
    towers and one :func:`adam_step`.  ``entropy_coeff`` and ``lr``: (P,)
    tensors.  The parameters and moments change in place; the caller
    advances the counts.  Returns aux: (P,) means of the last epoch's
    per-minibatch statistics."""
    n_mb = ppo.num_minibatches
    mb_size = ppo.batch_size // n_mb
    device = batch.obs.device
    members = ps.members
    bc1, bc2 = bias_corrections(ps.count, ppo.num_sgd_iter * n_mb, device)
    neg_lr = -lr[:, None]
    kl_coeff, entropy_coeff = ps.kl_coeff[:, None], entropy_coeff[:, None]
    rows = torch.arange(members, device=device)[:, None]
    aux, step = {}, 0
    for epoch in range(ppo.num_sgd_iter):
        if perms is None:
            perm = torch.stack([
                torch.randperm(ppo.batch_size, generator=g,
                               device=device)[:n_mb * mb_size]
                for g in ps.generators])
        else:
            perm = torch.as_tensor(perms[:, epoch], device=device)
        # (n_mb, P, mb_size, ...): each stacked minibatch one contiguous
        # block, as the fused head reads it.
        order = perm.view(members, n_mb, mb_size).transpose(0, 1)
        shuffled = Batch(*(x[rows, order] for x in batch))
        stats = []
        for j in range(n_mb):
            with span("population.update"):
                mb = Batch(*(x[j] for x in shuffled))
                stats.append(minibatch_step(env_cfg, ppo, ps, mb, kl_coeff,
                                            entropy_coeff, bc1[step],
                                            bc2[step], neg_lr))
            count("population.updates")
            step += 1
        aux = {k: v.mean(0) for k, v in ppo_mod.aux_from_stats(
            torch.stack(stats)[:, :, None]).items()}
    return aux


def _coeff_tensors(coeffs: Coeffs, device):
    return (torch.as_tensor(np.asarray(x, np.float32), device=device)
            for x in coeffs)


def learn(env_cfg: EnvConfig, ppo: PPOConfig, ps: PopulationState,
          traj: Trajectory, bootstrap_value, coeffs: Coeffs, perms=None):
    """The learning half of a population iteration on a (T, P * N)
    trajectory whose episode statistics are in ``ps.stats``: for each
    member GAE, its standardization, :func:`sgd_epochs` and its KL
    coefficient, with ``coeffs`` holding (P,) entropy coefficients,
    learning rates and KL targets.  Returns (PopulationState, metrics),
    each metric a (P,) tensor."""
    with span("population.learn"):
        t = traj.reward.shape[0]
        members, device = ps.members, traj.reward.device
        advantages, value_targets = ppo_mod.compute_gae(
            ppo, traj.reward, traj.done, traj.value, bootstrap_value)
        advantages = standardize(advantages, members)
        batch = member_batch(traj, advantages, value_targets, members)
        entropy_coeff, lr, kl_target = _coeff_tensors(coeffs, device)
        aux = sgd_epochs(env_cfg, ppo, ps, batch, entropy_coeff, lr, perms)
        steps = ppo.num_sgd_iter * ppo.num_minibatches
        ps = dataclasses.replace(ps, count=[c + steps for c in ps.count])
        kl_coeff = ppo_mod.update_kl_coeff(ppo, ps.kl_coeff, aux["kl"],
                                           kl_target)
        same = lambda x: x
        reward_sum = traj.reward.view(t, members, -1).sum((0, 2))
        metrics = {**ppo_mod.episode_metrics(ps.stats, reward_sum,
                                             t * ps.num_envs, same, same),
                   "kl_coeff": kl_coeff, **aux}
        return next_state(ps, kl_coeff, t * ps.num_envs), metrics


def next_state(ps: PopulationState, kl_coeff, env_steps: int):
    """``ppo.next_state`` for every member."""
    stats = ps.stats
    return dataclasses.replace(
        ps, stats=EpisodeStats.zeros(
            stats.ep_return.shape[0], stats.ep_return.device,
            ep_return=stats.ep_return, ep_len=stats.ep_len,
            members=ps.members),
        kl_coeff=kl_coeff, iteration=[i + 1 for i in ps.iteration],
        env_steps=[float(np.float32(s) + np.float32(env_steps))
                   for s in ps.env_steps])


def train_iter(env_cfg: EnvConfig, ppo: PPOConfig, ps: PopulationState,
               coeffs: Coeffs, driver: Optional[str] = None):
    """One population iteration: :func:`rollout`, then :func:`learn`."""
    env_state, stats, traj, bootstrap_value = rollout(
        env_cfg, ppo, ps.policy, ps.env_state, ps.stats, ps.generators,
        driver)
    ps = dataclasses.replace(ps, env_state=env_state, stats=stats)
    return learn(env_cfg, ppo, ps, traj, bootstrap_value, coeffs)
