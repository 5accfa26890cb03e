#!/usr/bin/env python3
"""Where a training iteration of the PyTorch port spends its time, on a card.

usage: python scripts/torch_profile_train.py [config.yml] [--steps N]

Builds the train state at the config's geometry (default
``configs/run_tpu_e3.yml``), times one rollout, then runs ``--steps`` Adam
steps of the learning half (the inner loop of ``ppo.sgd_epochs``: one
minibatch's loss, its gradients, one Adam step) three times: a warm-up, a
run timed on the host clock, and a run under ``torch.profiler``.  Prints
one JSON line: wall seconds per rollout and per Adam step, the device time
per Adam step and its share of the wall time (the rest is the card idle
while the host issues work), the number of kernels launched per Adam step,
and the operations that take the most host time (inflated by the
profiler's own cost) and the kernels that take the most device time.
Needs a card.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from q1physrl_torch.algo import ppo  # noqa: E402
from q1physrl_torch.algo.config import load_run_config  # noqa: E402


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("config", nargs="?",
                        default=str(ROOT / "configs" / "run_tpu_e3.yml"))
    parser.add_argument("--steps", type=int, default=200)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = load_run_config(args.config)
    env_cfg = dataclasses.replace(run.env, num_envs=None)
    cfg = run.ppo
    ts = ppo.init_train_state(0, env_cfg, cfg, device)

    t0 = time.perf_counter()
    _, _, traj, boot = ppo.rollout(env_cfg, cfg, ts.policy, ts.env_state,
                                   ts.stats, ts.generator)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0

    # The learning half's batch, as ppo.learn builds it.
    adv, vt = ppo.compute_gae(cfg, traj.reward, traj.done, traj.value, boot)
    adv = (adv - adv.mean()) / torch.clamp(adv.std(correction=0), min=1e-4)
    t, n = traj.reward.shape
    flat = lambda x: x.reshape((t * n,) + tuple(x.shape[2:]))
    batch = ppo.Batch(flat(traj.obs), flat(traj.key_actions.transpose(1, 2)),
                      flat(traj.yaw_actions), flat(traj.logits),
                      flat(traj.logp), flat(traj.value), flat(adv), flat(vt))
    perm = torch.randperm(cfg.batch_size, generator=ts.generator,
                          device=device)
    shuffled = ppo.Batch(*(x[perm] for x in batch))
    mb_size = cfg.batch_size // cfg.num_minibatches
    params = [dict(ts.policy.named_parameters())[k] for k in ts.opt_state.mu]

    def adam_steps(first, count):
        for j in range(first, first + count):
            mb = ppo.Batch(*(x[j * mb_size:(j + 1) * mb_size]
                             for x in shuffled))
            total, _ = ppo.ppo_loss(env_cfg, cfg, ts.policy, mb, ts.kl_coeff,
                                    cfg.entropy_coeff)
            grads = torch.autograd.grad(total, params)
            ppo.adam_update(cfg, params, grads, ts.opt_state)

    adam_steps(0, args.steps)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the wall time, without the profiler's cost
    adam_steps(args.steps, args.steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        adam_steps(2 * args.steps, args.steps)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if _device_us(e) > 0]
    device_s = sum(_device_us(e) for e in kernels) * 1e-6
    launches = sum(e.count for e in kernels)
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:12]
    top_device = sorted(kernels, key=_device_us, reverse=True)[:8]
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    steps = args.steps
    print(json.dumps({
        "config": str(Path(args.config).resolve().relative_to(ROOT)),
        "device": smi, "rollout_seconds": rollout_s,
        "adam_steps_profiled": steps,
        "adam_steps_per_iteration": cfg.num_sgd_iter * cfg.num_minibatches,
        "wall_ms_per_adam_step": wall_s / steps * 1e3,
        "device_ms_per_adam_step": device_s / steps * 1e3,
        "device_busy_share": device_s / wall_s,
        "kernels_per_adam_step": launches / steps,
        "top_host_ops_ms_per_step": {
            e.key: e.self_cpu_time_total / steps * 1e-3 for e in top_host},
        "top_device_kernels_ms_per_step": {
            e.key[:80]: _device_us(e) / steps * 1e-3 for e in top_device},
    }), flush=True)


if __name__ == "__main__":
    main()
