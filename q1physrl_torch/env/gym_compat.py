"""Gym-style compatibility shims over the functional env core.

Mirrors the reference's ``PhysEnv`` / ``VectorPhysEnv`` classes
(reference env.py:299-513) for users coming from the reference API and for
parity tests.  These are host-facing conveniences: training never goes
through them.  The env state lives on ``device`` (``cuda`` unless the
caller asks for the CPU) and each step is the plain :func:`core.step`, as
the JAX package's shim steps with its plain ``core.step``; observations,
rewards and dones come back as numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from ..utils.device import resolve_device
from . import core
from .config import Config

__all__ = ("PhysEnv", "VectorPhysEnv", "encode_actions")


def encode_actions(actions, cfg: Config):
    """Reference-format actions -> (key_actions (K, N) i32, yaw_action (N,)).

    Accepts the ragged formats the reference's ``_fix_actions`` normalizes
    (env.py:221-223): a sequence over envs of sequences over action
    components, each component a scalar or length-1 array.
    """
    flat = np.array([[np.ravel(x)[0] for x in a] for a in actions])
    nk = cfg.num_keys
    key_actions = flat[:, :nk].astype(np.int32).T  # (K, N)
    if cfg.allow_yaw:
        yaw_action = flat[:, nk].astype(np.float64)
    else:
        yaw_action = np.zeros(flat.shape[0])
    return key_actions, yaw_action


def _spaces(cfg: Config):
    """(observation_space, action_space) via gymnasium, if available."""
    try:
        import gymnasium.spaces as sp
    except ImportError:
        return None, None
    obs_space = sp.Box(low=-np.inf, high=np.inf, shape=(6,), dtype=np.float32)
    parts = [sp.Discrete(2) for _ in range(cfg.num_keys)]
    if cfg.allow_yaw:
        if cfg.discrete_yaw_steps == -1:
            parts.append(sp.Box(low=-cfg.action_range, high=cfg.action_range,
                                shape=(1,), dtype=np.float32))
        else:
            parts.append(sp.Discrete(2 * cfg.discrete_yaw_steps + 1))
    return obs_space, sp.Tuple(parts)


class VectorPhysEnv:
    """Vectorized env with the reference's VectorEnv-style interface
    (env.py:369-513): ``vector_reset`` / ``reset_at`` / ``vector_step``.

    ``float_dtype=torch.float64`` keeps yaw, the clock and z in float64,
    the parity mode with the reference's mixed float32/float64
    arithmetic; float32 is the production mode.  Resets draw from a
    ``torch.Generator`` on ``device`` seeded with ``seed``.
    """

    def __init__(self, config: Union[Config, dict], seed: int = 0,
                 float_dtype=torch.float32, device="cuda"):
        if isinstance(config, dict):
            config = Config(**config)
        self._config = config
        self.num_envs = config.num_envs
        self.device = resolve_device(device)
        self._float_dtype = float_dtype
        self._generator = torch.Generator(self.device).manual_seed(seed)

        self.reward_range = (-1000 * config.time_delta, 1000 * config.time_delta)
        self.metadata = {}
        self.observation_space, self.action_space = _spaces(config)
        self._state = None
        self.vector_reset()

    # -- introspection used by analysis tools (mirrors reference attributes)
    @property
    def player_state(self):
        return self._state.player

    @property
    def _yaw(self):
        return self._state.yaw.cpu().numpy()

    @property
    def _time_remaining(self):
        return self._state.time_remaining.cpu().numpy()

    @property
    def _zero_start(self):
        return self._state.zero_start.cpu().numpy()

    def _reset(self, n: int) -> core.EnvState:
        return core.reset(self._config, self._generator, n,
                          dtype=self._float_dtype, device=self.device)

    def _get_obs(self):
        s = self._state
        return core.compute_obs(self._config, s.player, s.yaw,
                                s.time_remaining).cpu().numpy()

    def vector_reset(self):
        with torch.inference_mode():
            self._state = self._reset(self.num_envs)
            return self._get_obs()

    def reset_at(self, index: int):
        """Redraw env ``index`` alone, in place; return its observation."""
        with torch.inference_mode():
            fresh = self._reset(1)
            for mine, new in zip(self._state.leaves(), fresh.leaves()):
                mine[..., index] = new[..., 0]
            return self._get_obs()[index]

    def vector_step(self, actions):
        key_actions, yaw_action = encode_actions(actions, self._config)
        with torch.inference_mode():
            self._state, out = core.step(
                self._config, self._state,
                torch.tensor(key_actions, device=self.device),
                torch.tensor(yaw_action, dtype=self._float_dtype,
                             device=self.device))
            obs, reward, done, zero_start = (
                x.cpu().numpy() for x in (out.obs, out.reward, out.done,
                                          out.zero_start))
        infos = [{"zero_start": bool(z)} for z in zero_start]
        return obs, reward, done, infos

    def get_unwrapped(self):
        return []


class PhysEnv:
    """Single-env facade over :class:`VectorPhysEnv` (reference env.py:299-357)."""

    def __init__(self, config: Union[Config, dict], **kwargs):
        if isinstance(config, dict):
            config = Config(**config)
        if config.num_envs is not None:
            raise ValueError("num_envs must be None for PhysEnv")
        config = dataclasses.replace(config, num_envs=1)
        self._env = VectorPhysEnv(config, **kwargs)
        self.observation_space = self._env.observation_space
        self.action_space = self._env.action_space

    def step(self, action):
        (obs,), (reward,), (done,), (info,) = self._env.vector_step([action])
        return obs, reward, done, info

    def reset(self):
        (obs,) = self._env.vector_reset()
        return obs
