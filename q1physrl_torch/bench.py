"""Throughput bench of the port on one card.

usage: python -m q1physrl_torch.bench [--reps N]

Prints one JSON line with the key names of the JAX package's bench
(``bench.py`` at the repo root):

- ``env_kernel_steps_per_sec``: the ``rollout_random`` CUDA kernel
  (in-kernel Philox actions and auto-reset) at N=2^20 envs x T=720 frames;
- ``env_xla_steps_per_sec``: the plain eager path, a loop of
  ``env.core.step_autoreset`` with actions drawn by torch, at N=2^19 x 256
  frames (the name is the JAX bench's; here no compiler fuses the step);
- ``train_steps_per_sec``: whole PPO iterations (rollout + learning) at
  ``configs/run_tpu_e3.yml`` (8,192 envs x 96 frames, minibatch 128,
  3 epochs), and ``train_mb8192_steps_per_sec`` at
  ``configs/params_tpu.yml`` (minibatch 8,192, 30 epochs);
- ``metric``/``value``/``vs_baseline``: the training rate against the
  reference's end-to-end 1,552 steps/s (BASELINE.md), and the ratios the
  JAX bench reports beside it.

Each rate is the median of ``--reps`` timed runs after one warm-up run,
on the host clock around work that ends in ``torch.cuda.synchronize()``.
The card's name and power limit ride along under ``device``.  It needs a
card: without one it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from .algo.config import load_run_config
from .algo.ppo import init_train_state, train_iter
from .analyse import resolve_device
from .env import core as env_core
from .ops.env_rollout import rollout_random
from .ops.sharded_rollout import sharded_rollout_random
from .parallel.mesh import shard_env_axis

__all__ = ("bench_env_kernel", "bench_env_eager", "bench_train", "main")

ROOT = Path(__file__).resolve().parents[1]
BASELINE_STEPS_PER_SEC = 1552.0  # reference end-to-end training (BASELINE.md)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _median_rate(run, work: int, reps: int, label: str) -> float:
    """Median of ``work`` / seconds over ``reps`` runs after a warm-up."""
    run()
    torch.cuda.synchronize()
    rates = []
    for i in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(work / dt)
        _log(f"{label} rep {i}: {dt * 1e3:.1f} ms -> "
             f"{rates[-1] / 1e6:.2f} M steps/s")
    rates.sort()
    return rates[len(rates) // 2]


def bench_env_kernel(n: int = 1 << 20, t: int = 720, reps: int = 5,
                     device="cuda", shard=None) -> float:
    """Env steps/s of the ``rollout_random`` kernel, from a fresh reset.

    ``shard``: a ``parallel.mesh.EnvShard`` of the n envs; each rank of the
    process group runs ``sharded_rollout_random`` on its share, whose done
    count all-reduce ends each call on every rank together, and the rate
    counts the env steps of all ranks."""
    cfg = dataclasses.replace(load_run_config(
        str(ROOT / "configs" / "run_tpu_e3.yml")).env, num_envs=None)
    device = resolve_device(device)
    state = env_core.reset(cfg, torch.Generator(device).manual_seed(0), n,
                           device=device)
    if shard is None:
        run = lambda: rollout_random(cfg, state, t, seed=7)
    else:
        state = shard_env_axis(state, shard)
        run = lambda: sharded_rollout_random(cfg, state, t, seed=7)
    return _median_rate(run, n * t, reps, f"env kernel n={n} t={t}")


def bench_env_eager(n: int = 1 << 19, t: int = 256, reps: int = 3,
                    device="cuda") -> float:
    """Env steps/s of the plain eager path: a loop of ``step_autoreset``
    with Bernoulli(0.5) keys and uniform yaw drawn by torch."""
    cfg = dataclasses.replace(load_run_config(
        str(ROOT / "configs" / "run_tpu_e3.yml")).env, num_envs=None)
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(0)
    state = env_core.reset(cfg, gen, n, device=device)

    def run():
        st = state
        for _ in range(t):
            ka = (torch.rand((cfg.num_keys, n), generator=gen, device=device)
                  < 0.5).to(torch.int32)
            ya = (torch.rand(n, generator=gen, device=device) * 2.0
                  - 1.0) * cfg.action_range
            st, _ = env_core.step_autoreset(cfg, st, ka, ya,
                                            compute_observation=False,
                                            generator=gen)

    return _median_rate(run, n * t, reps, f"env eager n={n} t={t}")


def bench_train(config_path: str, reps: int = 3, device="cuda") -> float:
    """Train steps/s (env steps of whole PPO iterations) at a config's
    geometry."""
    run = load_run_config(config_path)
    env_cfg = dataclasses.replace(run.env, num_envs=None)
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ts = [init_train_state(0, env_cfg, run.ppo, device)]

    def one():
        ts[0], metrics = train_iter(env_cfg, run.ppo, ts[0])
        float(metrics["kl"])

    return _median_rate(one, run.ppo.batch_size, reps,
                        f"train {Path(config_path).name}")


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    return smi.stdout.strip() or torch.cuda.get_device_name(0)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m q1physrl_torch.bench",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    resolve_device("cuda")
    env_kernel = bench_env_kernel(reps=args.reps)
    env_eager = bench_env_eager(reps=args.reps)
    train = bench_train(str(ROOT / "configs" / "run_tpu_e3.yml"), args.reps)
    train_mb8192 = bench_train(str(ROOT / "configs" / "params_tpu.yml"),
                               args.reps)
    env_best = max(env_kernel, env_eager)
    result = {
        "metric": "train_steps_per_sec",
        "value": round(train, 1),
        "unit": "steps/s",
        "vs_baseline": round(train / BASELINE_STEPS_PER_SEC, 1),
        "env_kernel_steps_per_sec": round(env_kernel, 1),
        "env_xla_steps_per_sec": round(env_eager, 1),
        "env_vs_10M_target": round(env_best / 1e7, 1),
        "env_kernel_vs_reference_full_loop": round(
            env_best / BASELINE_STEPS_PER_SEC, 1),
        "train_steps_per_sec": round(train, 1),
        "train_vs_baseline": round(train / BASELINE_STEPS_PER_SEC, 1),
        "train_mb8192_steps_per_sec": round(train_mb8192, 1),
        "device": _card(),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
