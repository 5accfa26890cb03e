"""PPO actor-learner on torch tensors.

One iteration (:func:`train_iter`) is

    rollout (a loop over T frames: the policy, then one launch of the
             auto-reset env kernel, ops.env_rollout.rollout_actions_autoreset;
             on a card the towers, the draws and one launch of that
             kernel's decoded form, which samples, scores, steps, records
             and writes the next observation; the frame a CUDA graph
             replayed T times)
    -> GAE(lambda), a reverse loop over T
    -> advantage standardization over the whole batch
    -> num_sgd_iter epochs x minibatched Adam steps
    -> adaptive-KL coefficient update

and is split into :func:`rollout` and :func:`learn`, so that a caller can
time the halves or feed :func:`learn` a trajectory of its own.

A layout says how an iteration is laid over the ranks: :class:`OneProcess`
(one process), :class:`GlobalLayout` or ``parallel.spmd.SpmdLayout``; the
one learning half, :func:`learn`, asks it where the three differ.
:class:`GlobalLayout`, over an env shard
(``parallel.mesh.EnvShard``), has the semantics of one process: every rank
holds the run's generator alike and draws each random tensor for the whole
batch, keeping its envs' share; the learning half gathers the batch over
the ranks once, and each rank computes the gradient of its 1/W of every
minibatch, summed over the ranks before the (replicated) Adam step.
Advantage standardization and the metrics use sums over the ranks.  In one
process every such sum is over one rank, so the two run the same
operations.  ``SpmdLayout`` is the explicit data-parallel layout, with
local minibatches.

The loss is RLLib 0.8.4's PPOLoss (ppo_tf_policy.py): clipped surrogate,
adaptive KL penalty against the behaviour distribution, entropy bonus, and
the max-of-clipped/unclipped value loss with vf_clip_param.  Its per-row
terms come from :func:`head_terms`: on a card the fused head
(``ops/ppo_head.py``: one kernel forward, one backward), where the call's
tensors and action space allow it, else the composed head,
:func:`loss_terms`, of torch operations; both give the same bits.  Adam
follows the reference's optimizer to its rounding: moments as
``(1 - b1) * g + b1 * mu``, bias correction by division, ``eps`` added
outside the square root, global-norm clipping as
``(g / norm) * max_norm`` only when the norm reaches ``max_norm``, and the
learning-rate schedule read at the update count *before* the step.  On a
card an unclipped step is one kernel (``ops/adam.py``), else multi-tensor
operations; both give the same bits.

Episode metrics (episode_reward_mean/max, episode_len_mean, and the
north-star zero_start_total_reward_mean) are accumulated on the device in
:class:`EpisodeStats`.

The rollout's frame is fused or composed (:func:`_takes_fused_rollout`,
chosen from what the loop observes): on a card, unsharded and outside a
process group, for a policy with K Categorical(2) keys and a continuous
yaw, the frame after the towers is one launch of
``ops.env_rollout.rollout_autoreset_sampled``; everything else composes it
of torch operations and ``rollout_actions_autoreset``.  Both give the same
bits; the counters ``ppo.fused_frames`` and ``ppo.composed_frames`` count
the frames of each.

The policy's parameters and the Adam moments are updated in place;
:func:`learn` returns a new :class:`TrainState` that holds the same policy.

The learning half records spans (``utils.profiling``): ``ppo.learn``
around :func:`learn`, ``ppo.gae`` (GAE, standardization, the flat batch),
``ppo.epoch`` per epoch (attributes ``minibatches`` and ``rows``, this
rank's rows of each) and ``ppo.update`` per minibatch, with its
``ppo.loss``, ``ppo.grad`` (the gradient, reduced over the ranks by the
layout) and ``ppo.adam`` (the clip and the step), in every layout; the
counter ``ppo.updates`` counts the Adam steps run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..env import core as env_core
from ..env.config import Config as EnvConfig
from ..models.distributions import draw
from ..models.policy import Policy, StackedPolicy, action_dist
from ..ops import adam as adam_ops
from ..ops.env_rollout import (EPISODE_TERMS, RECORD_FIELDS,
                               record_dtype, record_shapes,
                               rollout_actions_autoreset,
                               rollout_autoreset_sampled)
from ..ops.ppo_head import HeadParams, ppo_head
from ..ops.sharded_rollout import sharded_rollout_actions_autoreset
from ..parallel import distributed
from ..utils.cuda_graph import (FrameLoop, LoopCache, param_addresses,
                                resolve_driver)
from ..utils.profiling import count, span
from .config import PPOConfig

__all__ = ("EpisodeStats", "AdamState", "TrainState", "Coeffs", "Batch",
           "Trajectory", "init_train_state", "RolloutLoop", "rollout",
           "generator_ids", "compute_gae", "ppo_loss", "loss_terms",
           "head_terms", "loss_and_stats", "AUX_KEYS", "aux_from_stats",
           "adam_update", "OneProcess", "ONE_PROCESS", "GlobalLayout",
           "sgd_epochs", "update_kl_coeff", "standardize", "flat_batch",
           "iteration_coeffs", "episode_metrics", "learn", "next_state",
           "train_iter")

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # TF AdamOptimizer defaults
ADAM = adam_ops.AdamParams(ADAM_B1, ADAM_B2, ADAM_EPS)


@dataclasses.dataclass
class EpisodeStats:
    """Running per-env episode accumulators + finished-episode scalars, all
    on the device.  A population's (``algo/population.py``) holds the
    scalars per member, (P,), over P members' envs, member-major."""

    ep_return: torch.Tensor    # (N,) running return of the live episode
    ep_len: torch.Tensor       # (N,) int32
    finished: torch.Tensor     # () float32 — episodes finished
    ret_sum: torch.Tensor      # () float32 — sum of finished returns
    ret_max: torch.Tensor      # () float32 — max finished return
    len_sum: torch.Tensor      # () float32
    zs_finished: torch.Tensor  # () float32 — finished zero-start episodes
    zs_ret_sum: torch.Tensor   # () float32

    @classmethod
    def zeros(cls, n: int, device="cpu", ep_return=None, ep_len=None,
              members: Optional[int] = None):
        """Fresh accumulators; ``ep_return``/``ep_len`` carry the live
        episodes over when given; ``members``: P, for a population's."""
        shape = () if members is None else (members,)
        z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
        return cls(
            ep_return=(torch.zeros(n, dtype=torch.float32, device=device)
                       if ep_return is None else ep_return),
            ep_len=(torch.zeros(n, dtype=torch.int32, device=device)
                    if ep_len is None else ep_len),
            finished=z(), ret_sum=z(),
            ret_max=torch.full(shape, -torch.inf, dtype=torch.float32,
                               device=device),
            len_sum=z(), zs_finished=z(), zs_ret_sum=z())

    def clone(self) -> "EpisodeStats":
        return EpisodeStats(**{f.name: getattr(self, f.name).clone()
                               for f in dataclasses.fields(self)})

    def copy_(self, other: "EpisodeStats") -> "EpisodeStats":
        """Copy ``other``'s values into these tensors, in place."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(getattr(other, f.name))
        return self

    def update(self, reward, done, zero_start) -> "EpisodeStats":
        ep_return = self.ep_return + reward
        ep_len = self.ep_len + 1
        d = done.to(torch.float32)
        zs = d * zero_start.to(torch.float32)
        terms = (d, torch.where(done, ep_return, 0.0),
                 torch.where(done, ep_return, -torch.inf), d * ep_len, zs,
                 zs * ep_return)
        return EpisodeStats(ep_return=torch.where(done, 0.0, ep_return),
                            ep_len=torch.where(done, 0, ep_len),
                            **self.accumulated(terms))

    def accumulated(self, terms, out: Optional["EpisodeStats"] = None):
        """The finished-episode scalars after a frame whose per-env terms
        are ``terms``, one (N,) tensor per scalar in the order of
        ``ops.env_rollout.EPISODE_TERMS``: each scalar plus the sum of its
        term (``ret_max``: the larger of it and its term's max), by member
        for a population's.  ``out``: stats to write them into.  Returns
        {name: scalar}."""
        if self.finished.dim():  # a population's: sums per member
            members = self.finished.shape[0]
            total = lambda x: x.view(members, -1).sum(-1)
            top = lambda x: x.view(members, -1).amax(-1)
        else:
            total, top = torch.sum, torch.max
        result = {}
        for name, x in zip(EPISODE_TERMS, terms):
            op, reduce = ((torch.maximum, top) if name == "ret_max"
                          else (torch.add, total))
            result[name] = op(getattr(self, name), reduce(x),
                              out=None if out is None else getattr(out, name))
        return result


@dataclasses.dataclass
class AdamState:
    """First and second moments by parameter name, and the update count."""

    mu: dict
    nu: dict
    count: int = 0

    @classmethod
    def zeros(cls, policy: Policy) -> "AdamState":
        named = dict(policy.named_parameters())
        return cls(mu={k: torch.zeros_like(p) for k, p in named.items()},
                   nu={k: torch.zeros_like(p) for k, p in named.items()})


@dataclasses.dataclass
class TrainState:
    policy: Policy
    opt_state: AdamState
    env_state: env_core.EnvState
    stats: EpisodeStats
    kl_coeff: torch.Tensor     # () float32, adaptive, on the device
    generator: torch.Generator
    iteration: int
    env_steps: float           # a float32 value, as the reference keeps it


class Coeffs(NamedTuple):
    """Runtime overrides of the schedules in :class:`PPOConfig`."""

    entropy_coeff: float
    lr: float
    kl_target: float


class Batch(NamedTuple):
    """Flattened (B, ...) training batch."""

    obs: torch.Tensor           # (B, 6)
    key_actions: torch.Tensor   # (B, K) int32
    yaw_actions: torch.Tensor   # (B,)
    logits: torch.Tensor        # (B, L) behaviour logits
    logp: torch.Tensor          # (B,) behaviour log-prob
    value: torch.Tensor         # (B,) behaviour value pred
    advantage: torch.Tensor     # (B,)
    value_target: torch.Tensor  # (B,)


class Trajectory(NamedTuple):
    """What :func:`rollout` collects, with leading axis T."""

    obs: torch.Tensor             # (T, N, 6)
    key_actions: torch.Tensor     # (T, K, N) int32
    yaw_actions: torch.Tensor     # (T, N)
    logits: torch.Tensor          # (T, N, L)
    logp: torch.Tensor            # (T, N)
    value: torch.Tensor           # (T, N)
    reward: torch.Tensor          # (T, N)
    done: torch.Tensor            # (T, N) bool
    reset_uniforms: torch.Tensor  # (T, 5, N): the re-draws, for replay


def _interp_schedule(schedule, x) -> float:
    """Piecewise-linear schedule ((x0, v0), (x1, v1), ...) -> value at x, in
    float32 as the reference's one-dimensional interpolation computes it
    (constant beyond the ends)."""
    xs = np.asarray([p[0] for p in schedule], np.float32)
    ys = np.asarray([p[1] for p in schedule], np.float32)
    x = np.float32(x)
    i = min(max(int(np.searchsorted(xs, x, side="right")), 1), len(xs) - 1)
    dx = xs[i] - xs[i - 1]
    if abs(dx) <= np.spacing(np.finfo(np.float32).eps):
        f = ys[i - 1]
    else:
        f = ys[i - 1] + ((x - xs[i - 1]) / dx) * (ys[i] - ys[i - 1])
    if x < xs[0]:
        f = ys[0]
    if x > xs[-1]:
        f = ys[-1]
    return float(f)


def _learning_rate(ppo: PPOConfig, count: int) -> float:
    """The learning rate of update ``count`` (counted from 0): the schedule
    maps update counts to env steps, as each iteration makes
    num_sgd_iter * num_minibatches updates per batch_size env steps."""
    if ppo.lr_schedule is None:
        return float(np.float32(ppo.lr))
    upd_per_iter = ppo.num_sgd_iter * ppo.num_minibatches
    env_per_update = ppo.batch_size / upd_per_iter
    return _interp_schedule(ppo.lr_schedule, count * env_per_update)


def init_train_state(seed: int, env_cfg: EnvConfig, ppo: PPOConfig,
                     device="cuda") -> TrainState:
    """Policy weights, the first env states, and every later draw of the
    run (actions, re-draws, minibatch permutations) come from one
    generator on ``device``, seeded with ``seed``."""
    device = torch.device(device)
    generator = torch.Generator(device).manual_seed(seed)
    policy = Policy(env_cfg, generator, device=device)
    env_state = env_core.reset(env_cfg, generator, ppo.num_envs,
                               device=device)
    return TrainState(
        policy=policy, opt_state=AdamState.zeros(policy),
        env_state=env_state,
        stats=EpisodeStats.zeros(ppo.num_envs, device),
        kl_coeff=torch.tensor(ppo.kl_coeff, dtype=torch.float32,
                              device=device),
        generator=generator, iteration=0, env_steps=0.0)


# The rollout loops of recent calls of :func:`rollout`.  A loop holds its
# policy and generator, so the ids in its key stay theirs while it is kept.
_LOOPS = LoopCache(4)


def _takes_fused_rollout(policy, env_cfg: EnvConfig, shard, device) -> bool:
    """Whether the rollout runs the fused frame: on a card, with no env
    shard and no process group, for a float32 ``Policy`` or
    ``StackedPolicy`` whose action space is K Categorical(2) keys and a
    continuous yaw.  Everything else (the CPU, the sharded, global and
    spmd layouts, a discrete or absent yaw) runs the composed frame."""
    return (torch.device(device).type == "cuda" and shard is None
            and not distributed.is_initialized()
            and isinstance(policy, (Policy, StackedPolicy))
            and all(p.dtype == torch.float32 for p in policy.parameters())
            and env_cfg.allow_yaw and env_cfg.discrete_yaw_steps == -1)


class RolloutLoop(FrameLoop):
    """:func:`rollout`'s frames on static buffers: the env state, the
    episode statistics, and the (T, ...) trajectory, written at a
    device-side index.

    Built for one policy, generator, env count and shard.  On a card the
    frame is captured once as a CUDA graph against the policy's parameters,
    which Adam and ``load_state_dict`` update in place, and replayed once
    per frame (``utils/cuda_graph.py``).  :func:`rollout` keeps its loops
    in ``_LOOPS``, so the iterations of a run reuse one capture.  A tuple
    of P generators with a ``StackedPolicy`` runs a population's envs
    (``algo/population.py``): member i's draws come from generator i.

    ``fused`` (:func:`_takes_fused_rollout`) picks the frame.  The composed
    frame builds the observation, samples ``ActionDist``, scores the
    log-probability, draws the reset uniforms, steps with
    ``rollout_actions_autoreset`` (``sharded_rollout_actions_autoreset`` in
    a process group), updates the statistics and records the row.  The
    fused frame runs the towers on the observation buffer, draws what the
    composed frame draws, in each generator's order and at the same shapes,
    into static buffers (a member's blocks from its own generator), and
    makes one launch of ``rollout_autoreset_sampled``, which does the rest
    but the statistics' sums, torch reductions over its per-env terms.
    Both give the same bits.
    """

    def __init__(self, env_cfg: EnvConfig, ppo: PPOConfig, policy: Policy,
                 generator, n: int, device, shard=None, fused: bool = False):
        generators = generator if isinstance(generator, tuple) else (
            generator,)
        super().__init__(device, generators,
                         (rollout_actions_autoreset,
                          rollout_autoreset_sampled,
                          sharded_rollout_actions_autoreset))
        self.env_cfg, self.ppo, self.policy = env_cfg, ppo, policy
        self.generator, self.n, self.shard = generator, n, shard
        self.fused = fused
        self.env_step = (sharded_rollout_actions_autoreset
                         if distributed.is_initialized()
                         else rollout_actions_autoreset)
        self.state = self.stats = None
        self.traj = {}
        self.idx = torch.zeros(1, dtype=torch.int64, device=device)
        if fused:
            self._fused_buffers()
        else:
            self.rewards = torch.empty((1, n), dtype=torch.float32,
                                       device=device)
            self.dones = torch.empty((1, n), dtype=torch.bool, device=device)
            self.zero_start = torch.empty(n, dtype=torch.bool, device=device)

    def _fused_buffers(self):
        """The fused frame's static buffers: the observation, the draws,
        the per-env statistics terms and the whole (T, ...) record."""
        cfg, n, device = self.env_cfg, self.n, self.device
        members = len(self.generators)
        f32 = dict(dtype=torch.float32, device=device)
        self.obs = torch.empty((n, 6), **f32)
        self.uniforms = torch.empty((members, cfg.num_keys, n // members, 2),
                                    **f32)
        self.normals = torch.empty(n, **f32)
        self.reset_uniforms = torch.empty((members, 5, n // members), **f32)
        self.terms = tuple(torch.empty(n, **f32) for _ in EPISODE_TERMS)
        self.traj = {k: torch.empty((self.ppo.rollout_length,) + shape,
                                    dtype=record_dtype(k), device=device)
                     for k, shape in record_shapes(cfg, n).items()}

    def _record(self, values):
        for k, v in zip(Trajectory._fields, values):
            if k not in self.traj:  # the first frame, never under capture
                self.traj[k] = torch.empty(
                    (self.ppo.rollout_length,) + tuple(v.shape),
                    dtype=v.dtype, device=self.device)
            self.traj[k].index_copy_(0, self.idx, v.unsqueeze(0))

    def frame(self):
        if self.fused:
            self._fused_frame()
        else:
            self._composed_frame()
        self.idx += 1

    def _composed_frame(self):
        cfg, state, n = self.env_cfg, self.state, self.n
        obs = env_core.compute_obs(cfg, state.player, state.yaw,
                                   state.time_remaining).to(torch.float32)
        logits, value = self.policy(obs)
        dist = action_dist(cfg, logits)
        ka, ya = dist.sample(self.generator, self.shard)
        logp = dist.logp(ka, ya)
        ru = draw(torch.rand, (5, n), self.generator, 1, self.shard,
                  dtype=torch.float32, device=self.device)
        self.zero_start.copy_(state.zero_start)
        self.env_step(cfg, state, ka[None], ya[None], ru[None],
                      out=(state, self.rewards, self.dones))
        self.stats.copy_(self.stats.update(self.rewards[0], self.dones[0],
                                           self.zero_start))
        self._record((obs, ka, ya, logits, logp, value, self.rewards[0],
                      self.dones[0], ru))

    def _fused_frame(self):
        logits, value = self.policy(self.obs)
        per = self.n // len(self.generators)
        for m, g in enumerate(self.generators):
            for u in self.uniforms[m]:
                torch.rand(u.shape, generator=g, out=u)
            torch.randn((per,), generator=g,
                        out=self.normals[m * per:(m + 1) * per])
            torch.rand((5, per), generator=g, out=self.reset_uniforms[m])
        stats = self.stats
        rollout_autoreset_sampled(
            self.env_cfg, self.state, logits, value, self.uniforms,
            self.normals, self.reset_uniforms, self.obs, stats.ep_return,
            stats.ep_len, self.terms,
            tuple(self.traj[k] for k in RECORD_FIELDS), self.idx)
        stats.accumulated(self.terms, out=stats)

    def rollout(self, env_state: env_core.EnvState, stats: EpisodeStats,
                driver=None):
        """:func:`rollout` from ``env_state`` and ``stats`` with this
        loop's policy and generator; ``driver`` as in :func:`rollout`."""
        driver = resolve_driver(driver, self.device)
        frames = self.ppo.rollout_length
        with torch.no_grad():
            if self.state is None:
                self.state, self.stats = env_state.clone(), stats.clone()
            else:
                self.state.copy_(env_state)
                self.stats.copy_(stats)
            self.idx.zero_()
            state = self.state
            if self.fused:
                self.obs.copy_(env_core.compute_obs(
                    self.env_cfg, state.player, state.yaw,
                    state.time_remaining))
            self.run(frames, driver)
            count("ppo.fused_frames" if self.fused else "ppo.composed_frames",
                  frames)
            # Bootstrap value of the state after the last frame (re-drawn
            # envs bootstrap their fresh episode; done-masking in GAE
            # handles the seam).
            final_obs = env_core.compute_obs(
                self.env_cfg, state.player, state.yaw,
                state.time_remaining).to(torch.float32)
            _, bootstrap_value = self.policy(final_obs)
            traj = Trajectory(*(self.traj[k].clone()
                                for k in Trajectory._fields))
        return state.clone(), self.stats.clone(), traj, bootstrap_value


def rollout(env_cfg: EnvConfig, ppo: PPOConfig, policy: Policy,
            env_state: env_core.EnvState, stats: EpisodeStats,
            generator: torch.Generator, shard=None, driver=None):
    """Collect T frames from N envs with the policy in the loop.

    Each frame samples the policy, draws the five reset uniforms from
    ``generator`` and advances the envs with one T=1 call of
    ``rollout_actions_autoreset`` (one kernel launch on the card; in a
    process group, ``sharded_rollout_actions_autoreset`` on the rank's
    envs).  With an env ``shard`` the draws are made for the whole batch
    and cut to the shard's envs.  Where :func:`_takes_fused_rollout` holds
    (a card, no shard, no process group, a continuous yaw), the frame after
    the towers and the draws is one launch of that kernel's decoded form
    (:class:`RolloutLoop`), with the same bits.

    ``driver``: ``"graph"`` (the default on a card) captures the frame as a
    CUDA graph and replays it once per frame, ``"eager"`` (the CPU's) calls
    it once per frame.  The :class:`RolloutLoop` is kept in ``_LOOPS`` by
    everything its capture is bound to, so a later call with the same
    policy (its parameters at the same addresses), generator, geometry and
    shard replays the same graph.

    Returns (env_state', stats', trajectory, bootstrap_value).
    """
    n, device = env_state.num_envs, env_state.yaw.device
    fused = _takes_fused_rollout(policy, env_cfg, shard, device)
    key = (env_cfg, ppo, n, shard, device, distributed.is_initialized(),
           fused, id(policy), param_addresses(policy),
           generator_ids(generator))
    loop = _LOOPS.get(key, lambda: RolloutLoop(env_cfg, ppo, policy,
                                               generator, n, device, shard,
                                               fused))
    return loop.rollout(env_state, stats, driver)


def generator_ids(generator) -> tuple:
    """The identities of a generator, or of a tuple of them (a loop's
    capture is bound to them)."""
    generators = generator if isinstance(generator, tuple) else (generator,)
    return tuple(id(g) for g in generators)


def compute_gae(ppo: PPOConfig, reward, done, value, bootstrap_value):
    """GAE(lambda) over (T, N) tensors; matches RLLib's per-episode
    advantages because the (1 - done) mask zeroes cross-episode flow.
    Returns (advantages, value_targets)."""
    not_done = 1.0 - done.to(torch.float32)
    next_values = torch.cat([value[1:], bootstrap_value[None]], dim=0)
    deltas = reward + ppo.gamma * next_values * not_done - value
    advantages = torch.empty_like(deltas)
    adv = torch.zeros_like(bootstrap_value)
    for t in reversed(range(deltas.shape[0])):
        adv = deltas[t] + ppo.gamma * ppo.lam * not_done[t] * adv
        advantages[t] = adv
    return advantages, advantages + value


# The means among the loss statistics of loss_and_stats, in its order, and
# the keys of aux_from_stats.
_AUX_MEANS = ("policy_loss", "vf_loss", "kl", "entropy")
AUX_KEYS = _AUX_MEANS + ("vf_explained_var",)


def loss_terms(env_cfg: EnvConfig, ppo: PPOConfig, policy: Policy,
               batch: Batch):
    """The per-row terms of RLLib's PPOLoss on a batch whose rows are its
    last axis (a population's: (P, B, ...)): (surrogate, action KL, value
    loss, entropy, value prediction)."""
    logits, value = policy(batch.obs)
    dist = action_dist(env_cfg, logits)
    behaviour_dist = action_dist(env_cfg, batch.logits)

    curr_logp = dist.logp(batch.key_actions.movedim(-1, 0),
                          batch.yaw_actions)
    logp_ratio = torch.exp(curr_logp - batch.logp)
    action_kl = behaviour_dist.kl(dist)
    entropy = dist.entropy()

    surrogate = torch.minimum(
        batch.advantage * logp_ratio,
        batch.advantage * torch.clamp(logp_ratio, 1.0 - ppo.clip_param,
                                      1.0 + ppo.clip_param))

    vf_loss1 = torch.square(value - batch.value_target)
    vf_clipped = batch.value + torch.clamp(value - batch.value,
                                           -ppo.vf_clip_param,
                                           ppo.vf_clip_param)
    vf_loss2 = torch.square(vf_clipped - batch.value_target)
    vf_loss = torch.maximum(vf_loss1, vf_loss2)
    return surrogate, action_kl, vf_loss, entropy, value


def _power_of_two(x) -> bool:
    return x > 0 and math.frexp(x)[0] == 0.5


def _takes_fused_head(env_cfg: EnvConfig, batch: Batch, scale) -> bool:
    """Whether :func:`head_terms` takes the fused head: float32 on a card,
    K Categorical(2) keys and a continuous yaw, and a gradient per row
    from the mean (``scale`` over the rows) that is a power of two, by
    which the kernel's saved gradient scales exactly.  Everything else
    (the CPU, a discrete or absent yaw) runs the composed head."""
    return (batch.obs.is_cuda and batch.logits.dtype == torch.float32
            and env_cfg.allow_yaw and env_cfg.discrete_yaw_steps == -1
            and _power_of_two(batch.value.shape[-1])
            and _power_of_two(scale))


def head_terms(env_cfg: EnvConfig, ppo: PPOConfig, policy: Policy,
               batch: Batch, kl_coeff, entropy_coeff, scale: float = 1.0):
    """The per-row terms of the loss on a batch whose rows are its last
    axis (a population's: (P, B, ...), with (P, 1) coefficients):
    (row_total, policy loss, action KL, value loss, entropy, value
    prediction), with the policy loss the negated surrogate and
    ``row_total = policy loss + kl_coeff * KL + vf_loss_coeff * value loss
    - entropy_coeff * entropy``, the row's share of a loss of ``scale``
    times the mean over the rows.

    Where :func:`_takes_fused_head` holds, the fused head
    (``ops.ppo_head``) computes them after the towers, and only row_total
    carries a gradient; else the composed head, :func:`loss_terms`.  The
    counters ``ppo.fused_heads`` and ``ppo.composed_heads`` count the
    calls of each."""
    if not _takes_fused_head(env_cfg, batch, scale):
        count("ppo.composed_heads")
        surrogate, action_kl, vf_loss, entropy, value = loss_terms(
            env_cfg, ppo, policy, batch)
        policy_loss = -surrogate
        row_total = (policy_loss + kl_coeff * action_kl
                     + ppo.vf_loss_coeff * vf_loss - entropy_coeff * entropy)
        return row_total, policy_loss, action_kl, vf_loss, entropy, value
    count("ppo.fused_heads")
    logits, value = policy(batch.obs)
    params = HeadParams(env_cfg.num_keys, env_cfg.action_range,
                        ppo.clip_param, ppo.vf_clip_param, ppo.vf_loss_coeff)
    kl_coeff = kl_coeff.reshape(-1)
    if isinstance(entropy_coeff, torch.Tensor):
        entropy_coeff = entropy_coeff.reshape(-1)
    # The kernel reads rows in order; a strided minibatch is copied.
    columns = (batch.logits, batch.key_actions, batch.yaw_actions, batch.logp,
               batch.advantage, batch.value, batch.value_target)
    terms = ppo_head(params, logits, value,
                     *(x.contiguous() for x in columns), kl_coeff,
                     entropy_coeff)
    return (*terms, value)


def loss_and_stats(env_cfg: EnvConfig, ppo: PPOConfig, policy: Policy,
                   batch: Batch, kl_coeff, entropy_coeff=None,
                   scale: float = 1.0):
    """The loss of :func:`ppo_loss` times ``scale``, and its statistics as
    one detached (8,) tensor: the means of -surrogate, the value loss, the
    KL and the entropy, then the mean and variance (over N) of the value
    targets and of the value residuals (see :func:`aux_from_stats`)."""
    if entropy_coeff is None:
        entropy_coeff = ppo.entropy_coeff
    row_total, policy_loss, action_kl, vf_loss, entropy, value = head_terms(
        env_cfg, ppo, policy, batch, kl_coeff, entropy_coeff, scale)
    total = torch.mean(row_total)
    if scale != 1.0:
        total = total * scale
    with torch.no_grad():
        # Variances divide by N, as the reference's do.
        residual = batch.value_target - value
        stats = torch.stack([
            torch.mean(policy_loss), torch.mean(vf_loss),
            torch.mean(action_kl), torch.mean(entropy),
            torch.mean(batch.value_target),
            torch.var(batch.value_target, correction=0),
            torch.mean(residual), torch.var(residual, correction=0)])
    return total, stats


def aux_from_stats(stats) -> dict:
    """(..., W, 8) loss statistics of W equal shares of a minibatch ->
    {name: (...) tensor}: the means over the shares, and
    ``vf_explained_var`` from the pooled variances.  With W=1 these are the
    one share's own values, exactly."""
    w = stats.shape[-2]
    mean = stats.sum(-2) / w

    def pooled_var(i):  # column i holds the shares' means, i + 1 variances
        spread = torch.square(stats[..., i] - mean[..., i, None]).sum(-1)
        return stats[..., i + 1].sum(-1) / w + spread / w

    aux = {k: mean[..., j] for j, k in enumerate(_AUX_MEANS)}
    aux["vf_explained_var"] = 1.0 - pooled_var(6) / (pooled_var(4) + 1e-8)
    return aux


def ppo_loss(env_cfg: EnvConfig, ppo: PPOConfig, policy: Policy,
             batch: Batch, kl_coeff, entropy_coeff=None):
    """RLLib 0.8.4 PPOLoss (ppo_tf_policy.py).  Returns (total, aux) with
    aux the detached per-batch means."""
    total, stats = loss_and_stats(env_cfg, ppo, policy, batch, kl_coeff,
                                  entropy_coeff)
    return total, aux_from_stats(stats[None])


def _clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by max_norm / (global norm) when that norm
    reaches max_norm, computed as ``(g / norm) * max_norm`` with no epsilon;
    on the device, without a host sync."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def _takes_fused_adam(ppo: PPOConfig, params, grads, mu, nu, bc1):
    """Whether an Adam step takes the fused step (``ops.adam``, one kernel):
    no global-norm clip (it needs the gradients' norm first), and float32
    leaves on a card laid out as the kernel reads them.  Returns the
    kernel's leaf table (``ops.adam.leaf_table``) where it does, else None:
    everything else (the CPU, float64, a clip) runs the composed step."""
    if ppo.grad_clip is not None:
        return None
    return adam_ops.leaf_table(params, grads, mu, nu, bc1)


def adam_update(ppo: PPOConfig, params, grads, state: AdamState,
                lr: Optional[float] = None) -> AdamState:
    """One Adam step (with the optional global-norm clip) on ``params`` in
    place; ``params`` and ``grads`` in the order of ``state.mu``.  ``lr``
    overrides the configured rate or schedule.

    Where :func:`_takes_fused_adam` holds, the fused step (``ops.adam``,
    one kernel) runs; else the composed step, multi-tensor (``_foreach``)
    operations.  The counters ``ppo.fused_adam`` and ``ppo.composed_adam``
    count the steps of each."""
    if lr is None:
        lr = _learning_rate(ppo, state.count)
    mu, nu = list(state.mu.values()), list(state.nu.values())
    steps = state.count + 1
    bc1 = float(np.float32(1 - ADAM_B1 ** steps))
    bc2 = float(np.float32(1 - ADAM_B2 ** steps))
    table = _takes_fused_adam(ppo, params, grads, mu, nu, bc1)
    if table:
        count("ppo.fused_adam")
        adam_ops.adam(ADAM, params, grads, mu, nu, bc1, bc2, -lr,
                      table=table)
    else:
        count("ppo.composed_adam")
        if ppo.grad_clip is not None:
            grads = _clip_by_global_norm(grads, ppo.grad_clip)
        with torch.no_grad():
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - ADAM_B1))
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - ADAM_B2))
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            torch._foreach_mul_(updates, -lr)
            torch._foreach_add_(params, updates)
    state.count = steps
    return state


def _sum_over_ranks(grads, stats, shard):
    """One all-reduce per Adam step: the gradients summed over the ranks,
    and the (W, 8) loss statistics of every rank (each writes its row of a
    zeroed block)."""
    block = torch.zeros((shard.world_size, stats.numel()), dtype=stats.dtype,
                        device=stats.device)
    block[shard.rank] = stats
    flat = distributed.all_reduce_sum(
        torch.cat([g.reshape(-1) for g in grads] + [block.reshape(-1)]))
    parts = torch.split(flat, [g.numel() for g in grads] + [block.numel()])
    return ([p.view_as(g) for p, g in zip(parts, grads)],
            parts[-1].view_as(block))


class OneProcess:
    """The layout of one process (see the module's docstring).
    ``generator``: the stream of an iteration's rollout and permutations;
    ``shard``: the env shard of :func:`rollout` and :func:`flat_batch`;
    ``local``: the config whose minibatches the epochs run; ``total``,
    ``maximum``: a sum, a max over the ranks; ``share``: this rank's rows
    of the (n_mb, mb_size) minibatch rows; ``scale``: the loss's factor;
    ``reduce``: a step's gradients and (8,) loss statistics over the
    ranks; ``epoch_aux``: an epoch's reduced statistics as its aux."""

    name, shard, world_size, scale = "single", None, 1, 1.0
    total = maximum = staticmethod(lambda x: x)

    def generator(self, ts: TrainState) -> torch.Generator:
        return ts.generator

    def local(self, ppo: PPOConfig) -> PPOConfig:
        return ppo

    def share(self, minibatches):
        return minibatches

    def reduce(self, grads, stats):
        return grads, stats[None]

    def epoch_aux(self, stats) -> dict:
        return {k: v.mean() for k, v in aux_from_stats(
            torch.stack(stats)).items()}


ONE_PROCESS = OneProcess()


class GlobalLayout(OneProcess):
    """One rank of an iteration with the semantics of one process (see the
    module's docstring): the batch gathered over the ranks, this rank's 1/W
    of every minibatch, the gradients and the (W, 8) statistics summed."""

    name = "global"
    total = staticmethod(distributed.all_reduce_sum)
    maximum = staticmethod(distributed.all_reduce_max)

    def __init__(self, shard):
        self.shard, self.world_size = shard, shard.world_size
        self.scale = 1.0 / shard.world_size

    def share(self, minibatches):
        mb_size = minibatches.shape[1]
        if mb_size % self.world_size:
            raise ValueError(f"minibatches of {mb_size} rows do not split "
                             f"evenly over {self.world_size} ranks")
        rows, r = mb_size // self.world_size, self.shard.rank
        return minibatches[:, r * rows:(r + 1) * rows]

    def reduce(self, grads, stats):
        return _sum_over_ranks(grads, stats, self.shard)


def sgd_epochs(env_cfg: EnvConfig, ppo: PPOConfig, policy: Policy,
               opt_state: AdamState, kl_coeff, batch: Batch,
               generator: torch.Generator, entropy_coeff=None, lr=None,
               perms=None, layout: OneProcess = ONE_PROCESS):
    """num_sgd_iter epochs of minibatched Adam over the flattened batch.

    The epochs run the batch and minibatches of ``layout.local(ppo)``;
    ``perms``: optional (num_sgd_iter, >= n_mb * mb_size) permutations of
    the batch indices; by default each epoch draws one from ``generator``.
    Either way an epoch uses its first n_mb * mb_size entries.

    ``layout`` (:class:`OneProcess`) picks this rank's rows of each
    minibatch, scales its loss, and reduces each step's gradients and
    statistics over the ranks before the step.

    Returns (opt_state, aux): aux holds the last epoch's means of the
    per-minibatch loss statistics (RLLib's update_kl reads that KL).
    """
    local = layout.local(ppo)
    n_mb = local.num_minibatches
    mb_size = local.batch_size // n_mb
    params = [dict(policy.named_parameters())[k] for k in opt_state.mu]
    device = batch.obs.device
    aux = {}
    for epoch in range(ppo.num_sgd_iter):
        with span("ppo.epoch", minibatches=n_mb) as epoch_span:
            if perms is None:
                perm = torch.randperm(local.batch_size, generator=generator,
                                      device=device)
            else:
                perm = torch.as_tensor(perms[epoch], device=device)
            # This rank's rows of each minibatch, minibatch after minibatch.
            mine = layout.share(perm[:n_mb * mb_size].view(n_mb, mb_size))
            rows = epoch_span.attrs["rows"] = mine.shape[1]
            shuffled = Batch(*(x[mine.reshape(-1)] for x in batch))
            stats = []
            for j in range(n_mb):
                with span("ppo.update"):
                    mb = Batch(*(x[j * rows:(j + 1) * rows]
                                 for x in shuffled))
                    with span("ppo.loss"):
                        total, mb_stats = loss_and_stats(
                            env_cfg, ppo, policy, mb, kl_coeff,
                            entropy_coeff, scale=layout.scale)
                    with span("ppo.grad"):
                        grads = torch.autograd.grad(total, params)
                        grads, mb_stats = layout.reduce(grads, mb_stats)
                    with span("ppo.adam"):
                        opt_state = adam_update(ppo, params, grads, opt_state,
                                                lr)
                    stats.append(mb_stats)
                count("ppo.updates")
            aux = layout.epoch_aux(stats)
    return opt_state, aux


def update_kl_coeff(ppo: PPOConfig, kl_coeff, sampled_kl, kl_target=None):
    """RLLib 0.8.4 KLCoeffMixin.update_kl."""
    if kl_target is None:
        kl_target = ppo.kl_target
    return torch.where(
        sampled_kl > 2.0 * kl_target, kl_coeff * 1.5,
        torch.where(sampled_kl < 0.5 * kl_target, kl_coeff * 0.5, kl_coeff))


def flat_batch(traj: Trajectory, advantages, value_targets, shard=None):
    """The (T * N, ...) training batch, in the order t * N + env; with an
    env shard, gathered over the ranks (one all-reduce of the columns
    joined in one float tensor), the same on every rank."""
    columns = [traj.obs, traj.key_actions.transpose(1, 2),  # (T, n, K)
               traj.yaw_actions, traj.logits, traj.logp, traj.value,
               advantages, value_targets]
    if shard is not None:
        t, n = traj.reward.shape
        dtype = traj.logits.dtype
        joined = [x.reshape(t, n, -1).to(dtype) for x in columns]
        gathered = distributed.gather_env_axis(torch.cat(joined, -1), shard,
                                               dim=1)
        parts = torch.split(gathered, [x.shape[-1] for x in joined], -1)
        columns = [p.reshape(p.shape[:2] + x.shape[2:]).to(x.dtype)
                   for p, x in zip(parts, columns)]
    t, n = columns[-1].shape
    return Batch(*(x.reshape((t * n,) + tuple(x.shape[2:]))
                   for x in columns))


def episode_metrics(stats: EpisodeStats, reward_sum, batch_size: int,
                    total, maximum) -> dict:
    """The episode metrics from the accumulators, with the scalar sums
    reduced by ``total`` and the max by ``maximum`` (over the ranks, or
    the identity in one process), and the mean reward of a batch of
    ``batch_size`` env steps whose rewards sum (here) to ``reward_sum``."""
    sums = total(torch.stack([stats.finished, stats.ret_sum, stats.len_sum,
                              stats.zs_finished, stats.zs_ret_sum,
                              reward_sum]))
    finished, ret_sum, len_sum, zs_finished, zs_ret_sum, reward = sums
    nan = float("nan")
    has_ep = finished > 0
    has_zs = zs_finished > 0
    return {
        "episode_reward_mean": torch.where(
            has_ep, ret_sum / torch.clamp(finished, min=1), nan),
        "episode_reward_max": torch.where(has_ep, maximum(stats.ret_max),
                                          nan),
        "episode_len_mean": torch.where(
            has_ep, len_sum / torch.clamp(finished, min=1), nan),
        "episodes_total": finished,
        "zero_start_total_reward_mean": torch.where(
            has_zs, zs_ret_sum / torch.clamp(zs_finished, min=1), nan),
        "zero_start_episodes": zs_finished,
        "mean_reward": reward / batch_size,
    }


def standardize(advantages, count: int, total):
    """RLLib standardizes advantages over the whole train batch: (a - mean)
    / max(std, 1e-4), the moments in two passes over sums of ``count``
    elements that ``total`` reduces (over the ranks, or the identity in one
    process)."""
    mean = total(advantages.sum()) / count
    var = total(torch.square(advantages - mean).sum()) / count
    return (advantages - mean) / torch.clamp(torch.sqrt(var), min=1e-4)


def iteration_coeffs(ppo: PPOConfig, ts: TrainState,
                     coeffs: Optional[Coeffs] = None):
    """(entropy_coeff, lr, kl_target) of an iteration: ``coeffs`` when
    given, else the entropy schedule read at the env steps before the
    iteration (or the fixed coefficient) and None for the configured lr and
    KL target."""
    if coeffs is not None:
        return tuple(coeffs)
    if ppo.entropy_coeff_schedule is not None:
        return (_interp_schedule(ppo.entropy_coeff_schedule, ts.env_steps),
                None, None)
    return ppo.entropy_coeff, None, None


def learn(env_cfg: EnvConfig, ppo: PPOConfig, ts: TrainState,
          traj: Trajectory, bootstrap_value, coeffs: Optional[Coeffs] = None,
          perms=None, layout: OneProcess = ONE_PROCESS, generator=None):
    """The learning half of an iteration on a trajectory whose episode
    statistics are already in ``ts.stats``: GAE, standardization,
    :func:`sgd_epochs`, the KL coefficient.  Returns (TrainState, metrics)
    with metrics as 0-dim tensors; ``perms`` as in :func:`sgd_epochs`.
    ``layout``: one rank's part of a multi-rank iteration (see the
    module's docstring); ``generator``: the stream the rollout drew from,
    ``layout.generator(ts)``, which draws the permutations (by default
    ``ts.generator``)."""
    with span("ppo.learn"):
        w = layout.world_size
        t, n = traj.reward.shape
        with span("ppo.gae"):
            advantages, value_targets = compute_gae(
                ppo, traj.reward, traj.done, traj.value, bootstrap_value)
            advantages = standardize(advantages, t * n * w, layout.total)
            batch = flat_batch(traj, advantages, value_targets, layout.shard)

        entropy_coeff, lr, kl_target = iteration_coeffs(ppo, ts, coeffs)
        opt_state, aux = sgd_epochs(
            env_cfg, ppo, ts.policy, ts.opt_state, ts.kl_coeff, batch,
            ts.generator if generator is None else generator, entropy_coeff,
            lr, perms, layout)
        kl_coeff = update_kl_coeff(ppo, ts.kl_coeff, aux["kl"], kl_target)
        metrics = {**episode_metrics(ts.stats, traj.reward.sum(), t * n * w,
                                     layout.total, layout.maximum),
                   "kl_coeff": kl_coeff, **aux}
        return next_state(ts, opt_state, kl_coeff, t * n * w), metrics


def next_state(ts: TrainState, opt_state: AdamState, kl_coeff,
               env_steps: int) -> TrainState:
    """The TrainState after an iteration of ``env_steps`` env steps:
    finished-episode accumulators restart; the live episodes' running return
    and length carry over."""
    stats = ts.stats
    return dataclasses.replace(
        ts, opt_state=opt_state,
        stats=EpisodeStats.zeros(stats.ep_return.shape[0],
                                 stats.ep_return.device,
                                 ep_return=stats.ep_return,
                                 ep_len=stats.ep_len),
        kl_coeff=kl_coeff, iteration=ts.iteration + 1,
        env_steps=float(np.float32(ts.env_steps) + np.float32(env_steps)))


def train_iter(env_cfg: EnvConfig, ppo: PPOConfig, ts: TrainState,
               coeffs: Optional[Coeffs] = None,
               layout: OneProcess = ONE_PROCESS):
    """One full PPO iteration: :func:`rollout`, then :func:`learn`, from
    the layout's generator.  Returns (TrainState, metrics)."""
    generator = layout.generator(ts)
    env_state, stats, traj, bootstrap_value = rollout(
        env_cfg, ppo, ts.policy, ts.env_state, ts.stats, generator,
        layout.shard)
    ts = dataclasses.replace(ts, env_state=env_state, stats=stats)
    return learn(env_cfg, ppo, ts, traj, bootstrap_value, coeffs,
                 layout=layout, generator=generator)
