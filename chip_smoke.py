#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

usage: python3 chip_smoke.py      (from the root of a checkout; needs one card)

Phases, each printing one JSON line:

1. device    — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build     — compiles the rollout library (kernels rollout_actions,
               rollout_actions_autoreset and rollout_random) and curand's
               Philox yardstick from the checkout, one nvcc each, together.
3. kernels   — holds each kernel against its plain PyTorch version on the
               card, for the run4 config and five probe configs (N=4,096,
               T=64, episodes ending inside the window), then compares and
               times kernel and plain version at the shapes the main paths
               launch beside each kernel's bound: rollout_actions at the
               scoring shape (N=512, T=1) and N=65,536, T=128;
               rollout_actions_autoreset at the training shape (N=8,192,
               T=1); rollout_random at N=65,536, T=128 and the bench shape
               (N=2^20, T=720).  rollout_random's Philox is held against
               its plain version and curand's, and the zero-start share of
               its resets against zero_start_prob.
4. scoring   — runs the evaluate CLI on the shipped ``tpu_pb`` checkpoint under
               ``configs/run4.yml`` (512 stochastic + 2 deterministic zero-start
               episodes), checks one kernel launch per env step and the scores
               against ``data/checkpoints/tpu_pb/eval.json``.
5. training  — the port's Trainer on ``configs/run_tpu_e3.yml`` (8,192 envs x
               96 frames, minibatch 128, 3 epochs, full-width towers) for one
               iteration into a temporary directory: one launch of
               rollout_actions_autoreset per frame, finite metrics, params
               moved, a checkpoint written that restores; seconds per
               iteration split into rollout and learning.
6. bench_env — the port bench's env metric: rollout_random at N=2^20, T=720.

Then the kernels line and, last, the result line.  Any failed build, launch,
comparison or check raises, and the script exits non-zero without printing
the result line.  Without a CUDA card it exits 1 at once.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RUN_YAML = ROOT / "configs" / "run4.yml"
TRAIN_YAML = ROOT / "configs" / "run_tpu_e3.yml"
CHECKPOINT = ROOT / "data" / "checkpoints" / "tpu_pb" / "checkpoint"

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float operations of one env step in csrc/env_rollout.cu for K=4, counting
# each add, multiply, divide, sqrt, sin and cos as one and leaving out the
# on-ground friction branch (10 more), which the data decides: a lower
# bound on the work.
OPS_PER_ENV_STEP = 47
# rollout_random's integer work (csrc/philox.cuh): one Philox4x32-10 call
# is 98 operations (10 rounds of 2 high and 2 low products and 4 xors, 9
# key bumps of 2 adds).  Each env-step makes one call and takes 4 key bits
# (shift, and: 8), the yaw uniform (shift, and, convert, scale: 4) and the
# yaw action (3 float operations); each reset makes a second call and
# converts 5 uniforms (4 each).  The card's float32 rate stands for its
# integer rate, which is no higher on Hopper: the bound stays a lower
# bound.
PHILOX_OPS = 98
OPS_PER_RANDOM_DRAW = PHILOX_OPS + 8 + 4 + 3
OPS_PER_RANDOM_RESET = PHILOX_OPS + 5 * 4

# Scores of tpu_pb under run4 (data/checkpoints/tpu_pb/eval.json) and the
# allowed distance: 10 is over 15 standard errors of a 512-episode mean
# (std 8.8); one deterministic trajectory can move about 8 points through
# one flipped rounding, so 30 leaves room for several.
STOCHASTIC_MEAN, STOCHASTIC_TOL = 5934.47216796875, 10.0
DETERMINISTIC, DETERMINISTIC_TOL = 5945.88232421875, 30.0

# Kernel vs plain version (as tests/test_pallas_rollout.py compares the
# Pallas kernel with its scan).
REWARD_RTOL, REWARD_ATOL = 1e-5, 1e-4
STATE_ATOL = 1e-3
YAW_RTOL = 1e-6

# Shapes: (N, T) of the probe-config comparisons, and {shape: (N, T, timed
# reps of the kernel, of its plain version)} of each kernel's timed shapes.
PROBE_SHAPE = (4096, 64)
ACTIONS_SHAPES = {"scoring": (512, 1, 1000, 100),
                  "throughput": (65536, 128, 20, 2)}
AUTORESET_SHAPES = {"training": (8192, 1, 1000, 100)}
RANDOM_SHAPES = {"throughput": (65536, 128, 20, 2),
                 "bench": (1 << 20, 720, 5, 1)}
ZERO_START_RESETS = 1 << 20
BENCH_ENV = dict(n=1 << 20, t=720, reps=3)
# One training iteration: at run_tpu_e3's 18,432 Adam steps of 128 rows an
# iteration took 187-197 s on an H100 (PERF.md, Findings), over the 150 s at
# which the smoke run keeps to one; the geometry and widths stay full.
TRAIN_ITERATIONS = 1


def _emit(obj):
    print(json.dumps(obj), flush=True)


def probe_configs(base):
    """The run4 config and the five variants that change the step program."""
    return {
        "run4": base,
        "allow_yaw=False": dataclasses.replace(base, allow_yaw=False),
        "auto_jump=True": dataclasses.replace(base, auto_jump=True),
        "hover=True": dataclasses.replace(base, hover=True),
        "discrete_yaw_steps=3": dataclasses.replace(base, discrete_yaw_steps=3),
        "speed_reward=True": dataclasses.replace(base, speed_reward=True),
    }


def random_actions(cfg, rng, steps, n):
    """(T, K, N) int32 keys in {0, 1} and (T, N) float32 yaw actions as numpy
    arrays: uniform on +-action_range, or step indices for a discrete yaw
    axis."""
    ka = rng.integers(0, 2, (steps, cfg.num_keys, n)).astype(np.int32)
    if cfg.discrete_yaw_steps == -1:
        ya = rng.uniform(-cfg.action_range, cfg.action_range, (steps, n))
    else:
        ya = rng.integers(0, 2 * cfg.discrete_yaw_steps + 1, (steps, n))
    return ka, ya.astype(np.float32)


def rollout_inputs(cfg, n, steps, seed, device, near_end=0.25):
    """A numpy-seeded start state and action stream for ``rollout_actions``:
    a third zero starts, a ``near_end`` share of the envs within a second of
    their time limit (so episodes end inside the stream), random keys and
    yaw."""
    import torch

    from q1physrl_torch.env import core

    rng = np.random.default_rng(seed)
    u = torch.tensor(rng.random((5, n)), dtype=torch.float32, device=device)
    state = core.reset_from_uniforms(
        dataclasses.replace(cfg, zero_start_prob=0.3), *u)
    ends = rng.random(n) < near_end
    tr = np.where(ends, rng.uniform(0.0, 1.0, n),
                  state.time_remaining.cpu().numpy())
    state.time_remaining = torch.tensor(tr, dtype=torch.float32, device=device)
    ka, ya = random_actions(cfg, rng, steps, n)
    return (state, torch.tensor(ka, device=device),
            torch.tensor(ya, device=device))


def _float_leaves(state):
    p = state.player
    return {"z_pos": p.z_pos, "vel_x": p.vel_x, "vel_y": p.vel_y,
            "vel_z": p.vel_z, "yaw": state.yaw,
            "time_remaining": state.time_remaining,
            "last_key_press_time": state.last_key_press_time}


def _compare_state(name, s, s0):
    """Assert the kernel's state equals the plain version's; return the
    largest absolute difference of a float leaf."""
    np_ = lambda x: x.cpu().numpy()
    for leaf in ("on_ground", "jump_released"):
        np.testing.assert_array_equal(np_(getattr(s.player, leaf)),
                                      np_(getattr(s0.player, leaf)),
                                      err_msg=f"{name}: {leaf}")
    # The clocks are a subtraction and a copy of it in both versions.
    for leaf in ("last_keys", "zero_start", "time_remaining",
                 "last_key_press_time"):
        np.testing.assert_array_equal(np_(getattr(s, leaf)),
                                      np_(getattr(s0, leaf)),
                                      err_msg=f"{name}: {leaf}")
    for leaf in ("vel_x", "vel_y", "vel_z", "z_pos"):
        np.testing.assert_allclose(np_(getattr(s.player, leaf)),
                                   np_(getattr(s0.player, leaf)),
                                   rtol=0, atol=STATE_ATOL,
                                   err_msg=f"{name}: {leaf}")
    np.testing.assert_allclose(np_(s.yaw), np_(s0.yaw), rtol=YAW_RTOL,
                               err_msg=f"{name}: yaw")
    a, b = _float_leaves(s), _float_leaves(s0)
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _compare(name, got, want):
    """Assert the kernel's (state, rewards, dones) equals the plain
    version's; return the largest absolute difference of a float output."""
    (s, r, d), (s0, r0, d0) = got, want
    np_ = lambda x: x.cpu().numpy()
    np.testing.assert_allclose(np_(r), np_(r0), rtol=REWARD_RTOL,
                               atol=REWARD_ATOL, err_msg=f"{name}: rewards")
    np.testing.assert_array_equal(np_(d), np_(d0), err_msg=f"{name}: dones")
    return max(float((r - r0).abs().max()), _compare_state(name, s, s0))


def _compare_random(name, got, want):
    """rollout_random's (state, reward sums, done count) against its plain
    version's: the state as in :func:`_compare`, the sums at the reward
    tolerances, the count exactly."""
    (s, r, d), (s0, r0, d0) = got, want
    np.testing.assert_allclose(r.cpu().numpy(), r0.cpu().numpy(),
                               rtol=REWARD_RTOL, atol=REWARD_ATOL,
                               err_msg=f"{name}: reward sums")
    if int(d) != int(d0):
        raise AssertionError(f"{name}: done count {int(d)} != {int(d0)}")
    return max(float((r - r0).abs().max()), _compare_state(name, s, s0))


def _time_ms(fn, reps):
    """Milliseconds per call: CUDA events around ``reps`` calls after a
    warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps):
    """Milliseconds per call of ``fn`` replayed from a CUDA graph of
    ``reps`` calls: the device time without the host's launch cost."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return _time_ms(graph.replay, 5) / reps


def _least_time(nbytes, ops):
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def _nbytes(tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def _bound(state, ka, ya):
    """Least time (ms) for one rollout_actions call on these inputs: the
    bytes it must move over HBM bandwidth, against its float operations
    over the float32 rate.  zero_start is neither read nor written."""
    from q1physrl_torch.ops.env_rollout import _state_leaves

    t, k, n = ka.shape
    step_bytes = (_nbytes((ka, ya))
                  + t * n * (4 + 1))  # rewards float32, dones bool
    return _least_time(2 * _nbytes(_state_leaves(state)) + step_bytes,
                       OPS_PER_ENV_STEP * n * t)


def _bound_autoreset(state, ka, ya, dones):
    """As :func:`_bound` for rollout_actions_autoreset: all 11 leaves, and
    the five reset uniforms of each env-step that ended an episode (the
    kernel reads no others)."""
    from q1physrl_torch.ops.env_rollout import _all_leaves

    t, k, n = ka.shape
    step_bytes = (_nbytes((ka, ya)) + t * n * (4 + 1)
                  + int(dones.sum()) * 5 * 4)
    return _least_time(2 * _nbytes(_all_leaves(state)) + step_bytes,
                       OPS_PER_ENV_STEP * n * t)


def _bound_random(state, t, done_count):
    """As :func:`_bound` for rollout_random: the state read and written,
    the per-env reward sum and done count written; its float operations
    and Philox's integer operations, with this run's resets."""
    from q1physrl_torch.ops.env_rollout import _all_leaves

    n = state.num_envs
    ops = ((OPS_PER_ENV_STEP + OPS_PER_RANDOM_DRAW) * n * t
           + OPS_PER_RANDOM_RESET * int(done_count))
    return _least_time(2 * _nbytes(_all_leaves(state)) + n * (4 + 4), ops)


def _reset_uniforms(n, steps, seed, device):
    import torch

    rng = np.random.default_rng(1000 + seed)
    return torch.tensor(rng.random((steps, 5, n)), dtype=torch.float32,
                        device=device)


def _timed(kernel, plain, reps, plain_reps):
    return {"ms": _time_ms(kernel, reps),
            "graph_ms": _graph_ms(kernel, min(reps, 100)),
            "plain_ms": _time_ms(plain, plain_reps)}


def _phase_rollout_actions(run, device):
    from q1physrl_torch.ops.env_rollout import (rollout_actions,
                                                rollout_actions_plain)

    max_err = 0.0
    n, t = PROBE_SHAPE
    for seed, (name, cfg) in enumerate(probe_configs(run.env).items()):
        state, ka, ya = rollout_inputs(cfg, n, t, seed, device)
        err = _compare(name, rollout_actions(cfg, state, ka, ya),
                       rollout_actions_plain(cfg, state, ka, ya))
        max_err = max(max_err, err)
        _emit({"phase": "kernel", "kernel": "rollout_actions",
               "config": name, "n": n, "t": t, "max_abs_err": err})

    # The timed shapes are compared too: the scoring shape is the one the
    # main path launches, and its error is the one the kernels line reports.
    timings = {}
    for shape, (n, t, reps, plain_reps) in ACTIONS_SHAPES.items():
        state, ka, ya = rollout_inputs(run.env, n, t, 100, device)
        kernel = lambda: rollout_actions(run.env, state, ka, ya)
        plain = lambda: rollout_actions_plain(run.env, state, ka, ya)
        err = _compare(f"run4 {shape} shape", kernel(), plain())
        max_err = max(max_err, err)
        timings[shape] = {"n": n, "t": t, "max_abs_err": err,
                          **_timed(kernel, plain, reps, plain_reps),
                          **_bound(state, ka, ya)}
        _emit({"phase": "kernel_timing", "kernel": "rollout_actions",
               "shape": shape, **timings[shape]})
    return timings, max_err


def _phase_autoreset(run, device):
    from q1physrl_torch.ops.env_rollout import (
        rollout_actions_autoreset, rollout_actions_autoreset_plain)

    max_err = 0.0
    n, t = PROBE_SHAPE
    for seed, (name, cfg) in enumerate(probe_configs(run.env).items()):
        # Both branches of the re-draw: a third of the resets zero-start.
        cfg = dataclasses.replace(cfg, zero_start_prob=0.3)
        state, ka, ya = rollout_inputs(cfg, n, t, seed, device)
        ru = _reset_uniforms(n, t, seed, device)
        want = rollout_actions_autoreset_plain(cfg, state, ka, ya, ru)
        err = _compare(name, rollout_actions_autoreset(cfg, state, ka, ya,
                                                       ru), want)
        max_err = max(max_err, err)
        _emit({"phase": "kernel", "kernel": "rollout_actions_autoreset",
               "config": name, "n": n, "t": t,
               "dones": int(want[2].sum()), "max_abs_err": err})

    # The training shape: one frame of 8,192 envs, as the PPO rollout
    # launches it.
    timings = {}
    for shape, (n, t, reps, plain_reps) in AUTORESET_SHAPES.items():
        state, ka, ya = rollout_inputs(run.env, n, t, 101, device)
        ru = _reset_uniforms(n, t, 101, device)
        kernel = lambda: rollout_actions_autoreset(run.env, state, ka, ya, ru)
        plain = lambda: rollout_actions_autoreset_plain(run.env, state, ka,
                                                        ya, ru)
        want = plain()
        err = _compare(f"run4 {shape} shape", kernel(), want)
        max_err = max(max_err, err)
        timings[shape] = {"n": n, "t": t, "max_abs_err": err,
                          "dones": int(want[2].sum()),
                          **_timed(kernel, plain, reps, plain_reps),
                          **_bound_autoreset(state, ka, ya, want[2])}
        _emit({"phase": "kernel_timing",
               "kernel": "rollout_actions_autoreset", "shape": shape,
               **timings[shape]})
    return timings, max_err


def _phase_random(run, device):
    import torch

    from q1physrl_torch.env import core
    from q1physrl_torch.ops.env_rollout import (philox4x32_10, philox_on_card,
                                                rollout_random,
                                                rollout_random_plain)

    # The kernels' Philox against its plain version and curand's.
    rng = np.random.default_rng(7)
    counters = torch.tensor(rng.integers(0, 1 << 32, (4, 65536)),
                            dtype=torch.int64, device=device)
    key = (int(rng.integers(1 << 32)), 0)
    plain_bits = torch.stack(philox4x32_10(*counters, *key))
    for name, bits in (("kernel", philox_on_card(counters, key)),
                       ("curand", philox_on_card(counters, key,
                                                 curand=True))):
        mismatches = int((bits != plain_bits).sum())
        if mismatches:
            raise AssertionError(f"Philox: {name} differs from the plain "
                                 f"version in {mismatches} words")
    _emit({"phase": "philox", "counters": counters.shape[1],
           "kernel_equals_plain": True, "curand_equals_plain": True})

    max_err = 0.0
    n, t = PROBE_SHAPE
    for seed, (name, cfg) in enumerate(probe_configs(run.env).items()):
        cfg = dataclasses.replace(cfg, zero_start_prob=0.3)
        state, _, _ = rollout_inputs(cfg, n, 1, seed, device)
        want = rollout_random_plain(cfg, state, t, seed)
        err = _compare_random(name, rollout_random(cfg, state, t, seed),
                              want)
        max_err = max(max_err, err)
        _emit({"phase": "kernel", "kernel": "rollout_random", "config": name,
               "n": n, "t": t, "dones": int(want[2]), "max_abs_err": err})

    # Every env ends on the first frame and re-draws once from its own
    # draws: the zero-start share of 2^20 resets.
    n = ZERO_START_RESETS
    p = run.env.zero_start_prob
    state = core.reset(run.env, torch.Generator(device).manual_seed(1), n,
                       device=device)
    state.time_remaining = torch.zeros(n, device=device)
    new, _, done_count = rollout_random(run.env, state, 1, seed=5)
    share = float(new.zero_start.float().mean())
    se = float(np.sqrt(p * (1 - p) / n))
    _emit({"phase": "zero_start_share", "resets": int(done_count),
           "share": share, "zero_start_prob": p, "standard_error": se})
    if int(done_count) != n or abs(share - p) > 5 * se:
        raise AssertionError(f"zero-start share {share} of "
                             f"{int(done_count)} resets is not within 5 "
                             f"standard errors of {p}")

    timings = {}
    for shape, (n, t, reps, plain_reps) in RANDOM_SHAPES.items():
        state, _, _ = rollout_inputs(run.env, n, 1, 102, device)
        kernel = lambda: rollout_random(run.env, state, t, seed=3)
        plain = lambda: rollout_random_plain(run.env, state, t, seed=3)
        want = plain()
        err = _compare_random(f"run4 {shape} shape", kernel(), want)
        max_err = max(max_err, err)
        timings[shape] = {"n": n, "t": t, "max_abs_err": err,
                          "dones": int(want[2]),
                          **_timed(kernel, plain, reps, plain_reps),
                          **_bound_random(state, t, want[2])}
        _emit({"phase": "kernel_timing", "kernel": "rollout_random",
               "shape": shape, **timings[shape]})
    return timings, max_err


def _phase_training(device):
    """The Trainer at the full run_tpu_e3 geometry for TRAIN_ITERATIONS
    iterations."""
    import torch

    from q1physrl_torch.algo import checkpoint as ckpt
    from q1physrl_torch.algo.config import load_run_config
    from q1physrl_torch.algo.ppo import init_train_state
    from q1physrl_torch.algo.train import Trainer
    from q1physrl_torch.ops.env_rollout import rollout_actions_autoreset

    iterations = TRAIN_ITERATIONS
    with tempfile.TemporaryDirectory(prefix="q1_chip_smoke_") as tmp:
        run = dataclasses.replace(
            load_run_config(str(TRAIN_YAML)), checkpoint_dir=tmp,
            auto_resume=False, max_iterations=iterations)
        trainer = Trainer(run, device=device)
        before = {k: v.clone() for k, v in
                  trainer.ts.policy.state_dict().items()}
        rollout_actions_autoreset.launches = 0
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = rollout_actions_autoreset.launches
        records = [json.loads(line) for line in
                   (Path(tmp) / "logs" / "metrics.jsonl").read_text()
                   .splitlines()]
        latest = ckpt.latest_checkpoint(tmp)
        restored = ckpt.restore_checkpoint(
            latest, init_train_state(1, trainer.env_cfg, run.ppo, device))
        after = trainer.ts.policy.state_dict()
        restores = all(torch.equal(v, restored.policy.state_dict()[k])
                       for k, v in after.items())
        moved = any(not torch.equal(before[k], v) for k, v in after.items())
    per_iter = [{"rollout_seconds": r["rollout_seconds"],
                 "learn_seconds": r["learn_seconds"],
                 "train_steps_per_sec": run.ppo.batch_size
                 / (r["rollout_seconds"] + r["learn_seconds"]),
                 **{k: r[k] for k in ("kl", "entropy", "vf_loss",
                                      "episode_reward_mean", "mean_reward")}}
                for r in records]
    result = {"phase": "training", "config": str(TRAIN_YAML.relative_to(ROOT)),
              "iterations": iterations, "seconds": seconds,
              "batch_size": run.ppo.batch_size,
              "adam_steps_per_iteration": run.ppo.num_sgd_iter
              * run.ppo.num_minibatches,
              "launches": launches, "per_iteration": per_iter,
              "checkpoint": Path(latest).name, "checkpoint_restores": restores,
              "params_moved": moved}
    _emit(result)
    expected = iterations * run.ppo.rollout_length
    if launches != expected:
        raise RuntimeError(f"expected one rollout_actions_autoreset launch "
                           f"per frame ({expected}), counted {launches}")
    for r in records:
        if not (np.isfinite(r["kl"]) and r["kl"] >= 0
                and np.isfinite(r["entropy"]) and np.isfinite(r["vf_loss"])):
            raise RuntimeError(f"training metrics not sane: {r}")
    if len(records) != iterations or not moved or not restores:
        raise RuntimeError("training: missing iterations, params did not "
                           "move, or the checkpoint does not restore")
    return result


def main(device=None) -> int:
    """``device``: the card to drive (default: card 0)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 1
    from q1physrl_torch import bench
    from q1physrl_torch.algo import evaluate
    from q1physrl_torch.algo.config import load_run_config
    from q1physrl_torch.ops import env_rollout
    from q1physrl_torch.ops.env_rollout import (rollout_actions,
                                                rollout_random)

    device = torch.device("cuda", 0) if device is None else device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    _emit({"phase": "device", "nvidia_smi": card,
           "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    libs = env_rollout.build_all()
    env_rollout._library()
    build_s = time.perf_counter() - t0
    for lib in libs.values():
        print(lib.with_suffix(".log").read_text(), file=sys.stderr)
    _emit({"phase": "build",
           "kernels": ["rollout_actions", "rollout_actions_autoreset",
                       "rollout_random"],
           "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
           "seconds": build_s})

    # 3. each kernel against its plain version, then timing
    run = load_run_config(str(RUN_YAML))
    actions_t, actions_err = _phase_rollout_actions(run, device)
    autoreset_t, autoreset_err = _phase_autoreset(run, device)
    random_t, random_err = _phase_random(run, device)

    # 4. scoring through the evaluate CLI
    steps = int(np.ceil(run.env.time_limit / run.env.time_delta)) + 2
    rollout_actions.launches = 0
    t0 = time.perf_counter()
    sto, det = evaluate.main([str(RUN_YAML), str(CHECKPOINT), "512",
                              "--device", str(device)])
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    actions_launches = rollout_actions.launches
    _emit({"phase": "scoring", "seconds": score_s, "env_steps_per_episode":
           steps, "launches": actions_launches, "stochastic": sto,
           "deterministic": det["mean"]})
    if actions_launches != 2 * steps:
        raise RuntimeError(f"expected one kernel launch per env step "
                           f"({2 * steps}), counted {actions_launches}")
    if not abs(sto["mean"] - STOCHASTIC_MEAN) <= STOCHASTIC_TOL:
        raise RuntimeError(f"stochastic mean {sto['mean']} is not within "
                           f"{STOCHASTIC_TOL} of {STOCHASTIC_MEAN}")
    if not abs(det["mean"] - DETERMINISTIC) <= DETERMINISTIC_TOL:
        raise RuntimeError(f"deterministic score {det['mean']} is not within "
                           f"{DETERMINISTIC_TOL} of {DETERMINISTIC}")

    # 5. training through the Trainer
    training = _phase_training(device)

    # 6. the bench's env metric through its entry point
    rollout_random.launches = 0
    env_rate = bench.bench_env_kernel(**BENCH_ENV, device=device)
    random_launches = rollout_random.launches
    _emit({"phase": "bench_env", **BENCH_ENV, "launches": random_launches,
           "env_steps_per_sec": env_rate})
    if random_launches != BENCH_ENV["reps"] + 1:  # a warm-up, then the reps
        raise RuntimeError(f"expected {BENCH_ENV['reps'] + 1} rollout_random "
                           f"launches, counted {random_launches}")

    # 7. kernels line, 8. result line
    source = "q1physrl_torch/ops/csrc/env_rollout.cu"
    pallas = "q1physrl_tpu/ops/env_rollout_pallas.py"

    def entry(name, line, launches, main, max_err, shapes):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": f"{pallas}:{line}", "launches": launches,
                "max_abs_err": main["max_abs_err"],
                "max_abs_err_all_shapes": max_err,
                "ms": main["ms"], "graph_ms": main["graph_ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None,
                "shapes": shapes}

    _emit({"kernels": [
        entry("rollout_actions", 177, actions_launches, actions_t["scoring"],
              actions_err, actions_t),
        entry("rollout_actions_autoreset", 248, training["launches"],
              autoreset_t["training"], autoreset_err, autoreset_t),
        entry("rollout_random", 343, random_launches, random_t["bench"],
              random_err, random_t),
    ]})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
