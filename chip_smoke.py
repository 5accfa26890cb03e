#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

usage: python3 chip_smoke.py      (from the root of a checkout; needs one card)

Phases, each printing one JSON line:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build   — compiles every kernel of the scoring path from the checkout.
3. kernel  — holds the ``rollout_actions`` CUDA kernel against its plain
             PyTorch version on the card, for the run4 config and five probe
             configs (N=4,096, T=64), then compares and times both at the
             scoring shape (N=512, T=1) and a throughput shape (N=65,536,
             T=128) beside the byte bound.
4. scoring — runs the evaluate CLI on the shipped ``tpu_pb`` checkpoint under
             ``configs/run4.yml`` (512 stochastic + 2 deterministic zero-start
             episodes), checks one kernel launch per env step and the scores
             against ``data/checkpoints/tpu_pb/eval.json``.

Then the kernels line and, last, the result line.  Any failed build, launch,
comparison or score check raises, and the script exits non-zero without
printing the result line.  Without a CUDA card it exits 1 at once.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RUN_YAML = ROOT / "configs" / "run4.yml"
CHECKPOINT = ROOT / "data" / "checkpoints" / "tpu_pb" / "checkpoint"

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float operations of one env step in csrc/env_rollout.cu for K=4, counting
# each add, multiply, divide, sqrt, sin and cos as one and leaving out the
# on-ground friction branch (10 more), which the data decides: a lower
# bound on the work, and the bytes bound is the larger one by far.
OPS_PER_ENV_STEP = 47

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


def _compare(name, got, want):
    """Assert the kernel's (state, rewards, dones) equals the plain
    version's; return the largest absolute difference of a float output."""
    (s, r, d), (s0, r0, d0) = got, want
    np_ = lambda x: x.cpu().numpy()
    np.testing.assert_allclose(np_(r), np_(r0), rtol=REWARD_RTOL,
                               atol=REWARD_ATOL, err_msg=f"{name}: rewards")
    np.testing.assert_array_equal(np_(d), np_(d0), err_msg=f"{name}: dones")
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
    errs = [float((r - r0).abs().max())]
    a, b = _float_leaves(s), _float_leaves(s0)
    errs += [float((a[k] - b[k]).abs().max()) for k in a]
    return max(errs)


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


def _bound(state, ka, ya):
    """Least time (ms) for one rollout_actions call on these inputs: the
    bytes it must move over HBM bandwidth, against its float operations
    over the float32 rate.  zero_start is neither read nor written."""
    from q1physrl_torch.ops.env_rollout import _state_leaves

    t, k, n = ka.shape
    state_bytes = sum(x.numel() * x.element_size()
                      for x in _state_leaves(state))
    step_bytes = (ka.numel() * ka.element_size() + ya.numel() * ya.element_size()
                  + t * n * (4 + 1))  # rewards float32, dones bool
    nbytes = 2 * state_bytes + step_bytes
    ops = OPS_PER_ENV_STEP * n * t
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 1
    from q1physrl_torch.algo import evaluate
    from q1physrl_torch.algo.config import load_run_config
    from q1physrl_torch.ops import env_rollout
    from q1physrl_torch.ops.env_rollout import (rollout_actions,
                                                rollout_actions_plain)

    device = torch.device("cuda", 0)
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

    # 2. build
    t0 = time.perf_counter()
    lib = env_rollout.build()
    env_rollout._library()
    build_s = time.perf_counter() - t0
    print(lib.with_suffix(".log").read_text(), file=sys.stderr)
    _emit({"phase": "build", "kernel": "rollout_actions",
           "library": str(lib.relative_to(ROOT)), "seconds": build_s})

    # 3. kernel vs plain version, then timing
    run = load_run_config(str(RUN_YAML))
    max_err = 0.0
    for seed, (name, cfg) in enumerate(probe_configs(run.env).items()):
        state, ka, ya = rollout_inputs(cfg, 4096, 64, seed, device)
        got = rollout_actions(cfg, state, ka, ya)
        want = rollout_actions_plain(cfg, state, ka, ya)
        torch.cuda.synchronize()
        err = _compare(name, got, want)
        max_err = max(max_err, err)
        _emit({"phase": "kernel", "config": name, "n": 4096, "t": 64,
               "dones": int(want[2].sum()), "max_abs_err": err})

    # The timed shapes are compared too: the scoring shape is the one the
    # main path launches, and its error is the one the kernels line reports.
    timings = {}
    for shape, (n, t, reps, plain_reps) in {
            "scoring": (512, 1, 1000, 100),
            "throughput": (65536, 128, 20, 2)}.items():
        state, ka, ya = rollout_inputs(run.env, n, t, 100, device)
        kernel = lambda: rollout_actions(run.env, state, ka, ya)
        plain = lambda: rollout_actions_plain(run.env, state, ka, ya)
        err = _compare(f"run4 {shape} shape", kernel(), plain())
        max_err = max(max_err, err)
        timings[shape] = {"n": n, "t": t, "max_abs_err": err,
                          "ms": _time_ms(kernel, reps),
                          "graph_ms": _graph_ms(kernel, min(reps, 100)),
                          "plain_ms": _time_ms(plain, plain_reps),
                          **_bound(state, ka, ya)}
        _emit({"phase": "kernel_timing", "shape": shape, **timings[shape]})

    # 4. scoring through the evaluate CLI
    steps = int(np.ceil(run.env.time_limit / run.env.time_delta)) + 2
    rollout_actions.launches = 0
    t0 = time.perf_counter()
    sto, det = evaluate.main([str(RUN_YAML), str(CHECKPOINT), "512"])
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    launches = rollout_actions.launches
    _emit({"phase": "scoring", "seconds": score_s, "env_steps_per_episode":
           steps, "launches": launches, "stochastic": sto,
           "deterministic": det["mean"]})
    if launches != 2 * steps:
        raise RuntimeError(f"expected one kernel launch per env step "
                           f"({2 * steps}), counted {launches}")
    if not abs(sto["mean"] - STOCHASTIC_MEAN) <= STOCHASTIC_TOL:
        raise RuntimeError(f"stochastic mean {sto['mean']} is not within "
                           f"{STOCHASTIC_TOL} of {STOCHASTIC_MEAN}")
    if not abs(det["mean"] - DETERMINISTIC) <= DETERMINISTIC_TOL:
        raise RuntimeError(f"deterministic score {det['mean']} is not within "
                           f"{DETERMINISTIC_TOL} of {DETERMINISTIC}")

    # 5. kernels line, 6. result line
    scoring = timings["scoring"]
    _emit({"kernels": [{
        "name": "rollout_actions", "route": "cuda",
        "source": "q1physrl_torch/ops/csrc/env_rollout.cu",
        "replaces": "q1physrl_tpu/ops/env_rollout_pallas.py:177",
        "launches": launches, "max_abs_err": scoring["max_abs_err"],
        "max_abs_err_all_shapes": max_err,
        "ms": scoring["ms"], "kernel_ms": scoring["ms"],
        "graph_ms": scoring["graph_ms"], "plain_ms": scoring["plain_ms"],
        "bound_ms": scoring["bound_ms"], "bound_by": scoring["bound_by"],
        "library_ms": None, "throughput": timings["throughput"]}]})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
