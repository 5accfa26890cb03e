"""Training configuration and the run-YAML loader.

Mirrors the reference's PPO hyperparameters — data/params.yml plus Ray/RLLib
0.8.4 defaults for everything params.yml doesn't override (clip_param 0.3,
kl_coeff 0.2, num_sgd_iter 30, sgd_minibatch_size 128, use_gae True) — in
one frozen dataclass.

The reference's host-side data geometry (4 rollout workers x 100 envs
collecting 50,000-step train batches of 200-step fragments) is replaced by
on-device geometry: ``num_envs`` lockstep envs advanced ``rollout_length``
steps per iteration.  ``parity()`` gives the exact reference geometry;
``tpu()`` and ``tpu_fresh()`` the large-batch geometries that the configs
in ``configs/`` name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..env.config import Config as EnvConfig

__all__ = ("PPOConfig", "RunConfig", "load_run_config")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    # Data geometry (replaces num_workers/train_batch_size/fragment_length).
    num_envs: int = 4096
    rollout_length: int = 128

    # PPO hyperparameters (data/params.yml + RLLib 0.8.4 defaults).
    gamma: float = 0.99
    lam: float = 0.95
    clip_param: float = 0.3
    kl_coeff: float = 0.2          # initial adaptive-KL coefficient
    kl_target: float = 0.0036
    entropy_coeff: float = 0.01
    vf_loss_coeff: float = 1.0
    vf_clip_param: float = 100.0
    lr: float = 5e-6
    num_sgd_iter: int = 30
    sgd_minibatch_size: int = 128
    grad_clip: Optional[float] = None
    # Piecewise-linear schedules over env steps, as ((step, value), ...) —
    # RLLib's lr_schedule / entropy_coeff_schedule knobs.  None = constant.
    lr_schedule: Optional[tuple] = None
    entropy_coeff_schedule: Optional[tuple] = None

    def __post_init__(self):
        for f in ("lr_schedule", "entropy_coeff_schedule"):
            v = getattr(self, f)
            if isinstance(v, list):  # YAML gives lists; keep hashable
                object.__setattr__(self, f,
                                   tuple(tuple(p) for p in v))

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.rollout_length

    @property
    def num_minibatches(self) -> int:
        return max(1, self.batch_size // self.sgd_minibatch_size)

    @classmethod
    def parity(cls, **overrides):
        """Reference-like geometry: ~50k-sample batches, 128-minibatches."""
        d = dict(num_envs=400, rollout_length=125)  # 50,000 samples/iter
        d.update(overrides)
        return cls(**d)

    @classmethod
    def tpu(cls, **overrides):
        """Large-batch geometry: 8192 envs, 8192-sample minibatches, lr
        scaled with minibatch size (128 -> 8192 is 64x; sqrt scaling)."""
        d = dict(num_envs=8192, rollout_length=96,
                 sgd_minibatch_size=8192, num_sgd_iter=30, lr=4e-5)
        d.update(overrides)
        return cls(**d)

    @classmethod
    def tpu_fresh(cls, **overrides):
        """Fresh-data geometry: the reference recipe's per-update structure
        (minibatch 128, lr 5e-6), each sample revisited 3x instead of 30x,
        and 10x more data collected per iteration."""
        d = dict(num_envs=8192, rollout_length=96,
                 sgd_minibatch_size=128, num_sgd_iter=3, lr=5e-6)
        d.update(overrides)
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Top-level run settings (reference train.py:94-149 semantics)."""

    env: EnvConfig = dataclasses.field(default_factory=EnvConfig.get_default)
    ppo: PPOConfig = dataclasses.field(default_factory=PPOConfig)
    seed: int = 0
    # Multi-device: "auto" shards over all visible devices when >1;
    # use_shard_map selects the explicit-collective path over autosharding.
    use_shard_map: bool = False
    checkpoint_dir: str = "checkpoints"
    checkpoint_fname: Optional[str] = None   # explicit restore path
    auto_resume: bool = True                 # resume from latest checkpoint
    checkpoint_every: int = 100              # iterations (train.py:127)
    log_dir: Optional[str] = None            # default: <checkpoint_dir>/logs
    use_wandb: bool = False
    plot_frequency: int = 0                  # 0 = disabled
    max_iterations: Optional[int] = None     # None = run forever
    max_env_steps: Optional[int] = None


def load_run_config(path: str) -> RunConfig:
    """Load YAML — native RunConfig format or the reference params.yml."""
    import yaml

    with open(path) as f:
        params = yaml.safe_load(f)

    if "trainer_class" in params:  # reference format (data/params.yml)
        tc = dict(params["trainer_config"])
        env_cfg_d = dict(tc.pop("env_config"))
        num_workers = tc.pop("num_workers", 1)
        per_worker_envs = env_cfg_d.pop("num_envs", 100)
        num_envs = num_workers * per_worker_envs
        train_batch = tc.pop("train_batch_size", 50000)
        ppo_kwargs = dict(
            num_envs=num_envs,
            rollout_length=max(1, train_batch // num_envs),
            gamma=tc.pop("gamma", 0.99),
            lam=tc.pop("lambda", 0.95),
            kl_target=tc.pop("kl_target", 0.0036),
            entropy_coeff=tc.pop("entropy_coeff", 0.01),
            vf_clip_param=tc.pop("vf_clip_param", 100.0),
            lr=tc.pop("lr", 5e-6),
        )
        for k in ("clip_param", "kl_coeff", "num_sgd_iter",
                  "sgd_minibatch_size"):
            if k in tc:
                ppo_kwargs[k] = tc.pop(k)
        env_cfg_d["num_envs"] = None
        return RunConfig(
            env=EnvConfig(**env_cfg_d),
            ppo=PPOConfig(**ppo_kwargs),
            checkpoint_fname=params.get("checkpoint_fname"),
            plot_frequency=params.get("plot_frequency") or 0,
        )

    env_cfg = EnvConfig(**params.get("env", {}))
    ppo_cfg = PPOConfig(**params.get("ppo", {}))
    top = {k: v for k, v in params.items() if k not in ("env", "ppo")}
    return RunConfig(env=env_cfg, ppo=ppo_cfg, **top)
