"""Training driver CLI.

usage: python -m q1physrl_torch.algo.train <run.yml> [--seed N]
           [--device cuda|cpu]
       python -m q1physrl_torch.algo.train --smoke [--device cuda|cpu]
       torchrun --standalone --nproc_per_node=W -m q1physrl_torch.algo.train
           <run.yml> [--backend nccl|gloo] [--device DEVICE]

Reads a run config (the native YAML or the RLLib ``params.yml`` format,
``algo/config.py:load_run_config``), tracks the reference's stats,
checkpoints on a new best or every ``checkpoint_every`` iterations, resumes
from the latest checkpoint in ``checkpoint_dir``, prints per-iteration
stats, and every ``plot_frequency`` iterations (when above 0) draws the
wish-angle plot of one episode into the log dir.  Runs on the card unless
``--device cpu`` is given; ``--smoke`` runs three iterations of a tiny
geometry into a temporary directory.

Each iteration is ``ppo.rollout`` (one launch of the auto-reset env kernel
per frame on the card, the frame captured once as a CUDA graph and replayed
in every iteration) then ``ppo.learn``; the host loop times the two, prints
and checkpoints.

Under torchrun each of the W ranks trains on num_envs / W envs; the
layout follows ``use_shard_map`` as in the JAX package: false keeps the
semantics of one process (``ppo.GlobalLayout``, over an env shard), true
runs the explicit data-parallel iteration (``parallel.spmd.SpmdLayout``);
either way the iteration is ``ppo.rollout`` then ``ppo.learn``.  A rank's
device is ``cuda:LOCAL_RANK`` unless ``--device`` names one (``--device
cuda:0 --backend gloo`` puts several ranks on one card); the backend is
``nccl`` on cards and ``gloo`` on the CPU unless ``--backend`` says
otherwise.
Rank 0 alone prints, writes metrics and writes checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time
from typing import Optional

import torch

from ..parallel import distributed, spmd
from ..parallel.mesh import env_shard, init_sharded_train_state
from ..utils import profiling
from ..utils.device import resolve_device
from ..utils.metrics_io import MetricsWriter
from . import checkpoint as ckpt
from .config import PPOConfig, RunConfig, load_run_config
from .ppo import ONE_PROCESS, GlobalLayout, init_train_state, learn, rollout

__all__ = ("STATS_TO_TRACK", "Trainer", "main")

# Stats tracked for best-checkpointing (reference train.py:67-74).
STATS_TO_TRACK = (
    "episode_reward_mean",
    "episode_reward_max",
    "zero_start_total_reward_mean",
)
STATS_TO_PRINT = STATS_TO_TRACK + ("entropy", "episode_len_mean", "kl",
                                   "kl_coeff", "vf_explained_var")


@dataclasses.dataclass
class _Best:
    val: float
    fname: str


class Trainer:
    """Host-side training loop around :func:`ppo.rollout` and
    :func:`ppo.learn`.

    In a process group every rank builds its own Trainer, on its own
    ``device``.  ``layout`` is picked once: ``ppo.GlobalLayout`` over this
    rank's env shard or, with ``run.use_shard_map``, ``spmd.SpmdLayout``;
    in one process ``ppo.ONE_PROCESS``.  ``mode`` names it: ``"global"``,
    ``"spmd"`` or ``"single"``.
    """

    def __init__(self, run: RunConfig, device="cuda"):
        self.device = resolve_device(device)
        # Float32 products in full float32 on the card (TF32 off).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.run = run
        self.env_cfg = (dataclasses.replace(run.env, num_envs=None)
                        if run.env.num_envs is not None else run.env)
        self.ppo = run.ppo
        if not distributed.is_initialized():
            self.layout = ONE_PROCESS
            self.ts = init_train_state(run.seed, self.env_cfg, self.ppo,
                                       self.device)
        else:
            shard = env_shard(self.ppo.num_envs)
            self.layout = (spmd.SpmdLayout(self.ppo) if run.use_shard_map
                           else GlobalLayout(shard))
            self.ts = init_sharded_train_state(run.seed, self.env_cfg,
                                               self.ppo, shard, self.device)
        self.is_main = distributed.rank() == 0
        restore = run.checkpoint_fname
        if restore is None and run.auto_resume:
            restore = ckpt.latest_checkpoint(run.checkpoint_dir)
            if restore and self.is_main:
                print(f"Auto-resuming from {restore}", flush=True)
        if restore:
            self.ts = ckpt.restore_checkpoint(restore, self.ts)
        self.best: dict[str, _Best] = {}
        self.metrics_writer = None
        if self.is_main:
            self.metrics_writer = MetricsWriter(
                self._log_dir(), use_wandb=run.use_wandb,
                wandb_config=dataclasses.asdict(run))

    @property
    def mode(self) -> str:
        return self.layout.name

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> dict:
        """One iteration; returns its metrics as floats, with the seconds
        of the rollout and the learning halves, and the collectives' calls
        and seconds (the counter ``distributed.collectives`` and the span
        ``distributed.collective`` of ``utils.profiling``; the seconds only
        while ``distributed.time_collectives`` is on)."""
        calls = profiling.counter("distributed.collectives")
        _, seconds = profiling.total("distributed.collective")
        t0 = time.perf_counter()
        generator = self.layout.generator(self.ts)
        env_state, stats, traj, bootstrap_value = rollout(
            self.env_cfg, self.ppo, self.ts.policy, self.ts.env_state,
            self.ts.stats, generator, self.layout.shard)
        self._sync()
        t1 = time.perf_counter()
        ts = dataclasses.replace(self.ts, env_state=env_state, stats=stats)
        self.ts, metrics = learn(self.env_cfg, self.ppo, ts, traj,
                                 bootstrap_value, layout=self.layout,
                                 generator=generator)
        metrics = {k: float(v) for k, v in metrics.items()}
        t2 = time.perf_counter()
        return {**metrics, "rollout_seconds": t1 - t0,
                "learn_seconds": t2 - t1,
                "collectives":
                    profiling.counter("distributed.collectives") - calls,
                "collective_seconds":
                    profiling.total("distributed.collective")[1] - seconds}

    def maybe_checkpoint(self, i: int, metrics: dict) -> Optional[str]:
        """Reference checkpoint policy (train.py:119-133): save when any
        tracked stat beats its best, or every ``checkpoint_every`` iters."""
        to_save = [k for k in STATS_TO_TRACK
                   if not math.isnan(metrics.get(k, float("nan")))
                   and (k not in self.best or metrics[k] > self.best[k].val)]
        if i % self.run.checkpoint_every == 0 or to_save:
            fname = ckpt.save_checkpoint(self.run.checkpoint_dir, self.ts, i)
            for k in to_save:
                self.best[k] = _Best(metrics[k], fname)
            return fname
        return None

    def record_plot(self, i: int) -> str:
        """The wish-angle plot of one episode of the current policy
        (``analyse.eval_sim`` on the trainer's device), saved to the log
        dir as ``wish_angle_%07d.png`` (and to wandb when enabled); return
        its path.  The training loop calls it on rank 0 alone."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from .. import analyse

        t0 = time.time()
        r = analyse.eval_sim(self.ts.policy, self.env_cfg, device=self.device)
        r.wish_angle_yaw_plot()
        path = os.path.join(self._log_dir(), f"wish_angle_{i:07d}.png")
        plt.savefig(path)
        self.metrics_writer.log_figure(plt, i)
        plt.close()
        self._print(f"Took {time.time() - t0:.1f} seconds to record plot "
                    f"({path})")
        return path

    def _log_dir(self) -> str:
        return self.run.log_dir or f"{self.run.checkpoint_dir}/logs"

    def _finished(self, i: int) -> bool:
        if (self.run.max_iterations is not None
                and i >= self.run.max_iterations):
            return True
        return (self.run.max_env_steps is not None
                and self.ts.env_steps >= self.run.max_env_steps)

    def train(self):
        i = self.ts.iteration
        t_start = time.time()
        # Checked before every iteration: a resumed, already finished run
        # exits with a clean final save and no further iteration.
        saved_final = False
        while not self._finished(i):
            t0 = time.time()
            metrics = self.step()
            dt = time.time() - t0
            steps = self.ppo.batch_size
            self._print(f"Iteration: {i} "
                        f"steps/s: {steps / dt:,.0f} "
                        f"total_steps: {int(self.ts.env_steps):,} Current:",
                        {k: round(metrics.get(k, float('nan')), 2)
                         for k in STATS_TO_PRINT})
            if self.metrics_writer is not None:
                self.metrics_writer.write(
                    int(self.ts.env_steps),
                    {**metrics, "iteration": i, "steps_per_sec": steps / dt})
            fname = self.maybe_checkpoint(i, metrics)
            saved_final = fname is not None
            if fname:
                self._print("Best:", {k: (round(b.val, 2), b.fname)
                                      for k, b in self.best.items()})
            if (self.is_main and self.run.plot_frequency
                    and i % self.run.plot_frequency == 0):
                self.record_plot(i)
            i += 1
        if not saved_final:
            # Final save, so that auto-resume restarts exactly here.
            ckpt.save_checkpoint(self.run.checkpoint_dir, self.ts, i)
        self._print(f"Finished {i} iterations in "
                    f"{time.time() - t_start:.0f}s")
        return self.best

    def _print(self, *args):
        if self.is_main:
            print(*args, flush=True)


def smoke_run(seed: int = 0) -> RunConfig:
    """Three iterations of a tiny geometry into a temporary directory."""
    return RunConfig(
        ppo=PPOConfig(num_envs=64, rollout_length=16, num_sgd_iter=2,
                      sgd_minibatch_size=256),
        seed=seed, max_iterations=3,
        checkpoint_dir=tempfile.mkdtemp(prefix="q1_smoke_ckpt_"))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m q1physrl_torch.algo.train",
        description="Train the speedrun agent with PPO.")
    parser.add_argument("run_yaml", nargs="?")
    parser.add_argument("--smoke", action="store_true",
                        help="three iterations of a tiny geometry")
    parser.add_argument("--seed", type=int,
                        help="also moves the checkpoint dir to "
                             "<checkpoint_dir>_seed<N>")
    parser.add_argument("--device",
                        help="default: cuda, or cuda:LOCAL_RANK under "
                             "torchrun")
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        help="process-group backend under torchrun (default: "
                             "nccl on cards, gloo on the CPU)")
    args = parser.parse_args(argv)
    if args.smoke:
        run = smoke_run(args.seed or 0)
    elif args.run_yaml is None:
        parser.error("give a run config, or --smoke")
    else:
        run = load_run_config(args.run_yaml)
        if args.seed is not None:
            run = dataclasses.replace(
                run, seed=args.seed,
                checkpoint_dir=f"{run.checkpoint_dir}_seed{args.seed}")
    under_torchrun = "WORLD_SIZE" in os.environ
    device = torch.device(args.device or (
        f"cuda:{distributed.local_rank()}" if under_torchrun else "cuda"))
    if device.type == "cuda" and device.index is not None:
        resolve_device(device)
        torch.cuda.set_device(device)
    distributed.initialize(backend=args.backend or (
        "nccl" if device.type == "cuda" else "gloo"))
    try:
        return Trainer(run, device=device).train()
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
