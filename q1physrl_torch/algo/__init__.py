"""Run configuration, PPO, checkpoints, the training driver, population
sweeps and the evaluation CLI."""

from .config import PPOConfig, RunConfig, load_run_config

__all__ = ("PPOConfig", "RunConfig", "load_run_config")
