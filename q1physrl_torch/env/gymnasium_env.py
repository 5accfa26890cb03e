"""Gymnasium adapter + registration of ``q1physrl_torch/Q1PhysEnv-v0``.

The reference registers ``Q1PhysEnv-v0`` with classic gym on import
(reference env.py:516-521), and the JAX package registers that id with
gymnasium.  The port registers its env under the gymnasium namespace
``q1physrl_torch``, so both packages can be imported in one process and
each id makes its own package's env.  gymnasium is imported softly:
without it this module still imports and :func:`register` returns False.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from .config import Config
from .gym_compat import VectorPhysEnv

__all__ = ("GymnasiumPhysEnv", "register", "ENV_ID")

ENV_ID = "q1physrl_torch/Q1PhysEnv-v0"

try:
    import gymnasium
except ImportError:
    gymnasium = None


class GymnasiumPhysEnv(*([gymnasium.Env] if gymnasium else [object])):
    """Single-env gymnasium.Env over the functional core, its state on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    metadata = {"render_modes": []}

    def __init__(self, config: Union[Config, dict, None] = None,
                 render_mode: Optional[str] = None, device="cuda"):
        if config is None:
            config = Config.get_default()
        elif isinstance(config, dict):
            config = Config(**config)
        config = dataclasses.replace(config, num_envs=1)
        self._env = VectorPhysEnv(config, device=device)
        self.observation_space = self._env.observation_space
        self.action_space = self._env.action_space
        self.render_mode = render_mode

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._env._generator.manual_seed(seed)
        (obs,) = self._env.vector_reset()
        return np.asarray(obs, np.float32), {}

    def step(self, action):
        (obs,), (reward,), (done,), (info,) = self._env.vector_step([action])
        # The episode ends only by time limit -> truncation in gymnasium
        # terms; there is no terminal failure state.
        return (np.asarray(obs, np.float32), float(reward), False, bool(done),
                info)


def register():
    """Register :data:`ENV_ID` with gymnasium (idempotent)."""
    if gymnasium is None:
        return False
    if ENV_ID in gymnasium.registry:
        return True
    gymnasium.register(
        id=ENV_ID,
        entry_point="q1physrl_torch.env.gymnasium_env:GymnasiumPhysEnv",
        nondeterministic=False,
    )
    return True


register()
