"""How training state is laid out over the ranks.

- The env axis (:data:`DATA_AXIS`) is split by rank: rank r holds envs
  ``[r * n / W, (r + 1) * n / W)`` of every per-env leaf of the env state
  and the episode statistics, on their trailing axis.  0-dim leaves are
  replicated.
- Params and Adam's state are replicated: broadcast from rank 0, then kept
  equal by applying the same reduced gradient on every rank.

An :class:`EnvShard` names one rank's slice.  Random draws of a rollout can
be made at the global shape from the generator every rank holds alike and
cut to the slice (:meth:`EnvShard.draw`), so that W ranks see the draws of
one process.
"""

from __future__ import annotations

import dataclasses

import torch

from . import distributed

__all__ = ("DATA_AXIS", "EnvShard", "env_shard", "shard_env_axis",
           "unshard_env_axis", "shard_train_state", "init_sharded_train_state")

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class EnvShard:
    """Envs ``[start, stop)`` of a batch of ``total``, held by ``rank`` of
    ``world_size``."""

    rank: int
    world_size: int
    total: int

    @property
    def local(self) -> int:
        return self.total // self.world_size

    @property
    def start(self) -> int:
        return self.rank * self.local

    @property
    def stop(self) -> int:
        return self.start + self.local

    def take(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This shard's slice of ``x``'s global env axis ``dim``."""
        return x.narrow(dim, self.start, self.local).contiguous()

    def draw(self, fn, shape, dim: int = -1, **kwargs) -> torch.Tensor:
        """``fn(shape, **kwargs)`` (``torch.rand``, ``torch.randn``) drawn
        with the env axis ``dim`` at its global size, cut to this shard."""
        shape = list(shape)
        if shape[dim] != self.local:
            raise ValueError(f"axis {dim} of {tuple(shape)} is not the "
                             f"shard's {self.local} envs")
        shape[dim] = self.total
        return self.take(fn(shape, **kwargs), dim)


def env_shard(num_envs: int, rank: int | None = None,
              world_size: int | None = None) -> EnvShard:
    """This process's shard of ``num_envs`` envs (rank and world size from
    the process group unless given); raises unless the ranks split the
    envs evenly."""
    rank = distributed.rank() if rank is None else rank
    world_size = distributed.world_size() if world_size is None else world_size
    if num_envs % world_size:
        raise ValueError(f"num_envs={num_envs} does not split evenly over "
                         f"{world_size} ranks")
    return EnvShard(rank, world_size, num_envs)


def _map_leaves(fn, tree):
    """``fn`` on every tensor of a (nested) dataclass, as a new one."""
    changes = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            changes[f.name] = _map_leaves(fn, v)
        elif isinstance(v, torch.Tensor):
            changes[f.name] = fn(v)
    return dataclasses.replace(tree, **changes)


def shard_env_axis(tree, shard: EnvShard):
    """This rank's slice of an env-state-like dataclass (``EnvState``,
    ``EpisodeStats``): every leaf of one or more dims is cut on its trailing
    (env) axis; 0-dim leaves are kept."""
    return _map_leaves(lambda x: shard.take(x) if x.dim() else x, tree)


def unshard_env_axis(tree, shard: EnvShard):
    """The inverse of :func:`shard_env_axis` on every rank: each leaf of one
    or more dims gathered over the ranks; 0-dim leaves are kept."""
    return _map_leaves(
        lambda x: distributed.gather_env_axis(x, shard) if x.dim() else x,
        tree)


def shard_train_state(ts, shard: EnvShard):
    """A global TrainState laid out for this rank: env state and episode
    statistics cut to the shard; params, Adam's moments and the KL
    coefficient broadcast from rank 0."""
    with torch.no_grad():
        for p in ts.policy.parameters():
            distributed.broadcast(p.data)
    for moments in (ts.opt_state.mu, ts.opt_state.nu):
        for x in moments.values():
            distributed.broadcast(x)
    distributed.broadcast(ts.kl_coeff)
    return dataclasses.replace(ts, env_state=shard_env_axis(ts.env_state,
                                                            shard),
                               stats=shard_env_axis(ts.stats, shard))


def init_sharded_train_state(seed: int, env_cfg, ppo, shard: EnvShard,
                             device="cuda"):
    """The TrainState of ``ppo.num_envs`` envs that one process would start
    from, drawn from the generator every rank seeds alike, then cut to this
    rank's shard."""
    from ..algo.ppo import init_train_state

    if ppo.num_envs != shard.total:
        raise ValueError(f"ppo.num_envs={ppo.num_envs} but the shard splits "
                         f"{shard.total}")
    return shard_train_state(init_train_state(seed, env_cfg, ppo, device),
                             shard)
