"""The env-rollout kernels over the ranks of a process group.

The env batch is embarrassingly parallel over its env axis, so each rank
runs the kernel of :mod:`env_rollout` unchanged on the envs it holds
(:class:`parallel.mesh.EnvShard`), one launch per rank per call.  The
functions take and return the rank's shard; only
:func:`sharded_rollout_random` communicates, summing the done count over
the ranks.  On CPU tensors the kernels' plain versions run, and in a single
process (no process group) each function is its kernel on the whole batch.

Each function counts in ``.launches`` the calls in which its kernel
launched on the card (the kernel's own count rises alike); a replay of a
captured frame adds its launches as the kernels' counts do
(``utils/cuda_graph.py``).
"""

from __future__ import annotations

import math

from ..env import core as env_core
from ..env.config import Config
from ..parallel import distributed
from . import env_rollout

__all__ = ("SEED_STRIDE", "check_random_streams", "sharded_rollout_actions",
           "sharded_rollout_actions_autoreset", "sharded_rollout_random")

# Rank r's rollout_random seed is seed + r * SEED_STRIDE.
SEED_STRIDE = 100003
_WORD = 1 << 32


def _count(fn, state):
    if state.yaw.device.type == "cuda":
        fn.launches += 1


def sharded_rollout_actions(cfg: Config, state: env_core.EnvState,
                            key_actions, yaw_actions, out=None):
    """:func:`env_rollout.rollout_actions` on this rank's envs: (T, K, n)
    keys and (T, n) yaw for the n envs of ``state``; returns (EnvState,
    rewards (T, n), dones (T, n)), written into ``out`` where given.  No
    collectives."""
    out = env_rollout.rollout_actions(cfg, state, key_actions, yaw_actions,
                                      out)
    _count(sharded_rollout_actions, state)
    return out


def sharded_rollout_actions_autoreset(cfg: Config,
                                      state: env_core.EnvState,
                                      key_actions, yaw_actions,
                                      reset_uniforms, out=None):
    """:func:`env_rollout.rollout_actions_autoreset` on this rank's envs,
    with (T, 5, n) reset uniforms, written into ``out`` where given.  No
    collectives."""
    out = env_rollout.rollout_actions_autoreset(cfg, state, key_actions,
                                                yaw_actions, reset_uniforms,
                                                out)
    _count(sharded_rollout_actions_autoreset, state)
    return out


def check_random_streams(seed: int, world_size: int, n_local: int,
                         t_steps: int):
    """Raise unless the ranks' Philox streams cannot collide.

    Under key (seed & 0xFFFFFFFF, 0) the kernel draws env i's actions of
    frames 3m..3m+2 from counter (i, m, 0, 0) and its reset at frame t from
    counter (i, t, 1, 0) (``env_rollout.random_frame_inputs``).  Streams
    are distinct when the ranks' keys (``seed + r * SEED_STRIDE``) stay
    distinct in 32 bits and the env index and the frame index (so also m =
    t / 3) each fit their 32-bit counter word; the third word keeps action
    and reset calls apart.
    """
    # seed + r * SEED_STRIDE repeats mod 2^32 after this many ranks.
    period = _WORD // math.gcd(SEED_STRIDE, _WORD)
    if world_size > period:
        raise ValueError(f"{world_size} ranks at seed stride {SEED_STRIDE} "
                         f"repeat a 32-bit Philox key: streams would collide")
    if not (0 < n_local < _WORD and 0 < t_steps < _WORD):
        raise ValueError(f"{n_local} envs x {t_steps} frames do not fit the "
                         f"32-bit Philox counter words")


def sharded_rollout_random(cfg: Config, state: env_core.EnvState,
                           t_steps: int, seed: int = 0):
    """:func:`env_rollout.rollout_random` on this rank's envs, seeded with
    ``seed + rank * SEED_STRIDE``.

    Returns (EnvState, reward_sum (n,), done_count ()): the done count is
    summed over the ranks, the same on each.
    """
    rank, world = distributed.rank(), distributed.world_size()
    check_random_streams(seed, world, state.num_envs, t_steps)
    new, reward_sum, done_count = env_rollout.rollout_random(
        cfg, state, t_steps, seed=seed + rank * SEED_STRIDE)
    _count(sharded_rollout_random, state)
    return new, reward_sum, distributed.all_reduce_sum(done_count)


sharded_rollout_actions.launches = 0
sharded_rollout_actions_autoreset.launches = 0
sharded_rollout_random.launches = 0
