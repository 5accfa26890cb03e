"""Hand-written CUDA kernels for the hot paths, with their plain versions."""

from . import env_rollout

__all__ = ("env_rollout",)
