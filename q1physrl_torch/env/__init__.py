"""Batched Quake-movement environment (functional core + gym shims)."""

from .config import (INITIAL_STATE, INITIAL_YAW_ZERO, MAX_YAW_SPEED, Config,
                     Key, Obs, get_obs_scale)
from .core import (EnvState, StepResult, compute_obs, decode_actions,
                   merge_reset, reset, reset_from_uniforms, step,
                   step_autoreset)
from .gym_compat import PhysEnv, VectorPhysEnv, encode_actions

# Registers q1physrl_torch/Q1PhysEnv-v0 with gymnasium when it is installed.
from . import gymnasium_env  # noqa: F401,E402

__all__ = (
    "Config", "Key", "Obs", "INITIAL_STATE", "INITIAL_YAW_ZERO",
    "MAX_YAW_SPEED", "get_obs_scale",
    "EnvState", "StepResult", "compute_obs", "decode_actions", "reset",
    "reset_from_uniforms", "step", "merge_reset", "step_autoreset",
    "PhysEnv", "VectorPhysEnv", "encode_actions",
)
