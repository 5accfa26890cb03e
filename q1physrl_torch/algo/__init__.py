"""Run configuration, PPO, checkpoints, the training driver and the
evaluation CLI."""

from .config import PPOConfig, RunConfig, load_run_config

__all__ = ("PPOConfig", "RunConfig", "load_run_config")
