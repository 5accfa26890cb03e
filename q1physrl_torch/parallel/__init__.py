"""Data-parallel training over ``torch.distributed``: the process group and
its collectives (``distributed``), the layout of state over the ranks
(``mesh``), and the explicit data-parallel iteration (``spmd``, imported on
its own)."""

from . import distributed
from .mesh import (DATA_AXIS, EnvShard, env_shard, init_sharded_train_state,
                   shard_env_axis, shard_train_state, unshard_env_axis)

__all__ = ("DATA_AXIS", "EnvShard", "distributed", "env_shard",
           "init_sharded_train_state", "shard_env_axis", "shard_train_state",
           "unshard_env_axis")
