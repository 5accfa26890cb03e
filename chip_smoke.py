#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

usage: python3 chip_smoke.py      (from the root of a checkout; needs one card)

Phases, each printing one JSON line:

1. device    — the card's name and power limit (nvidia-smi), torch and CUDA.
2. build     — compiles the rollout library (kernels rollout_actions,
               rollout_actions_autoreset and rollout_random) and curand's
               Philox yardstick from the checkout, one nvcc each, together.
3. kernels   — prints how each kernel launches at its main path's shape
               (threads per block, blocks resident per SM, waves), then
               holds each kernel against its plain PyTorch version on the
               card, to the bit, for the run4 config and five probe
               configs (N=4,096, T=64, episodes ending inside the window),
               then compares and times kernel and plain version at the
               shapes the main paths launch beside each kernel's bound:
               rollout_actions at the scoring shape (N=512, T=1), the
               eval_sim shape (N=1, T=1) and N=65,536, T=128;
               rollout_actions_autoreset at the training shape (N=8,192,
               T=1), each of these also in the form the frame loops launch
               (``out=``: the state written over itself into given
               buffers); rollout_random at N=65,536, T=128 and
               the bench shape (N=2^20, T=720), and also at an odd T
               (N=4,096, T=67), and each kernel on run4 from a state whose
               key latches hold any int32 (ANY_LATCHES).  rollout_random's
               Philox is held against
               its plain version and curand's, and the zero-start share of
               its resets against zero_start_prob.
4. scoring   — runs the evaluate CLI on the shipped ``tpu_pb`` checkpoint under
               ``configs/run4.yml`` (512 stochastic + 2 deterministic zero-start
               episodes), checks one kernel launch per env step and the scores
               against ``data/checkpoints/tpu_pb/eval.json``.  The CLI's loop
               is a frame captured as a CUDA graph and replayed once per
               frame; beside it (``scoring_loops``) the eager driver runs on
               the card and the graphed returns are held to its, to the bit,
               in both modes, with ``eager_s``, ``graphed_s``, ``capture_s``,
               ``frame_ms`` (the card's time per replayed frame) and
               ``kernels_per_frame`` (torch.profiler).  Phases 4a, 4b and 5
               print the same for their loops.
4a. analysis — ``analyse.eval_sim`` of ``tpu_pb``, deterministic, under run4 at
               full width on the card: one rollout_actions launch per frame;
               the decoded yaw of each frame equal, to the bit, to the yaw
               the kernel wrote (a replay of the recorded actions through the
               kernel, each launch held against the plain version on the same
               state and actions to the bit, which also reproduces the
               recorded states and rewards to the bit); the return against
               eval.json's deterministic score and against the same
               eval_sim on the CPU; then the
               counterfactual sweep (``hypothetical_delta_speeds``, 360 x T
               states) on the card against the CPU; the graphed eval_sim
               held to the eager driver on the card, every recorded field to
               the bit.
4b. scoring_r5 — the evaluate CLI on round 5's winner,
               ``data/checkpoints/repl_r5/best_member_02_rllib`` given as a
               directory (512 + 2 episodes, run4): one launch per env step,
               the stochastic score against ``repl_r5/eval_summary.json``,
               the deterministic one against the JAX package's on the CPU;
               its loop reuses phase 4's capture, the weights copied in.
4c. demo     — the demo path, each line with the card's name and power
               limit: ``export``, the make-demo CLI (``mkdemo.main``) on
               tpu_pb under run4 into a temporary .dem: one rollout_actions
               launch per frame of its eval_sim, the demo read alike by
               the port's parser and its C++ binding, its records
               consistent with the EvalSimResult, the corrected finish
               within 2 frames of the JAX package's CPU export
               (DEMO_EXPORT_FINISH; behaviour.json's printed beside it);
               ``lockstep``, the CLI with ``--lockstep`` on round 5's winner
               against the port's LockstepServer on the card over UDP: one
               launch per policy frame, the frames and corrected finish
               within 2 frames of the JAX package's CPU run
               (DEMO_LOCKSTEP_*; winner_lockstep.json printed beside them),
               then the loop again with its launches recorded: the demo
               equal byte for byte, each launch replayed and held to the
               plain version to the bit, the yaw sent equal to the
               kernel's; ``engine``, ``mkdemo.make_demo`` against a stub
               engine (STUB) serving the port's server on the card on a
               free port: at least 700 frames at 1/72 s, stopped by
               SIGINT; ``gym``, ``VectorPhysEnv`` on the card (4,096 envs,
               100 steps), each step held to the same step on the CPU.
               Its ``finalize`` runs in phase 5, on that phase's
               checkpoint: ``scripts/torch_finalize_run.py``, every bundle
               file, finite scores, the demo read alike by both parsers,
               behaviour.json's keys.
5. training  — the port's Trainer on ``configs/run_tpu_e3.yml`` (8,192 envs x
               96 frames, minibatch 128, full-width towers; cut in depth to
               TRAIN_SGD_ITER of its 3 epochs) for one
               iteration into a temporary directory: one launch of
               rollout_actions_autoreset per frame, finite metrics, params
               moved, a checkpoint written that restores; seconds per
               iteration split into rollout and learning.  First the
               rollout at that geometry from one start through
               ``ppo.rollout``, graphed twice (the capture's run, then a
               replay of every frame on the kept loop) and eager on the
               card: trajectory, state, statistics, bootstrap value and
               generator to the bit.
5a. sweep    — round 5's gated cohort (``configs/sweep_r5_repl2.yml``: 4
               members of 400 envs x 125 frames, minibatch 128, 30 epochs,
               full-width towers): rollout_actions_autoreset at the
               population shape (N=1,600, T=1) against each member's own
               launch at (400, 1), to the bit (phase 3 holds it to its
               plain version in both forms and times it); the population
               rollout through ``population.rollout``, graphed twice and
               eager from one start, to the bit (trajectory, state,
               per-member statistics, bootstrap value, all 4 generators),
               with 125 launches per rollout; each member against a solo
               ``ppo.rollout`` of its seed (generator to the bit, the rest
               within MEMBER_TOL); the stacked Adam step
               (every member's minibatch of 128 rows) against the solo one,
               host ms, card-busy ms and kernels per step; then one
               iteration through the sweep CLI (cut in depth to
               SWEEP_SGD_ITER of its 30 epochs) into a temporary directory:
               125 launches, a finite log row per member, params moved, a
               stacked checkpoint that restores, seconds split into rollout
               and learning.
6. bench_env — the port bench's env metric: rollout_random at N=2^20, T=720.
7. reference — one process's Trainer at ``configs/params_tpu.yml`` (8,192
               envs x 96 frames, minibatch 8,192, full-width towers) for
               one iteration with one epoch: the iteration the data-parallel
               phases are held to; then one full iteration (30 epochs), the
               time the ranks' full iterations are set beside.
8. nccl_w1   — one rank of an NCCL process group: each sharded rollout
               function equals its kernel on the whole batch to the bit, and
               the Trainer's global-mode iteration equals phase 7's to the
               bit (metrics and params).
9. ranks     — two ranks of a gloo process group on this card (NCCL refuses
               two ranks on one card).  Each sharded function, on the
               rank's half of the envs, is held against one launch of its
               kernel on the whole batch (sharded_rollout_random against
               rollout_random on the shard with seed + rank * 100003, the
               done count summed exactly) at the probe shape and its main
               path's shape (the first two also in the ``out=`` form),
               then timed alone, beside the all-reduce.  Then
               the main paths across the two ranks: the evaluate CLI
               (sharded_rollout_actions; then each rank's graphed scoring
               loop and its global-mode rollout held to the eager driver to
               the bit), the bench's env metric
               (sharded_rollout_random), and the Trainer
               (sharded_rollout_actions_autoreset, one launch per frame per
               rank) at params_tpu.yml: one epoch in global mode, within
               rtol 1e-3 / atol 1e-5 of phase 7 with params equal across
               ranks to the bit; then one full iteration (30 epochs) in
               each of the global and spmd modes, seconds split into
               rollout, learning and collectives.

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
# key bumps of 2 adds).  One call draws the actions of FRAMES_PER_DRAW (3)
# frames (csrc/env_rollout.cu, the draw layout); each env-step then shifts
# the key word and takes its 4 key bits (shift, and: 9), the yaw uniform
# (shift, and, convert, scale: 4) and the yaw action (3 float operations).
# Each reset makes one call of its own and converts 4 uniforms from the top
# bits (4 each) and 1 from the low bytes (3 ands, 2 shifts, 2 ors, convert,
# scale: 9).  The card's float32 rate stands for its integer rate, which is
# half of it on Hopper (64 against 128 results per clock per SM): the bound
# stays a lower bound.
PHILOX_OPS = 98
OPS_PER_RANDOM_FRAME = 9 + 4 + 3
OPS_PER_RANDOM_RESET = PHILOX_OPS + 4 * 4 + 9

# Scores of tpu_pb under run4 (data/checkpoints/tpu_pb/eval.json) and the
# allowed distance: 10 is over 15 standard errors of a 512-episode mean
# (std 8.8); one deterministic trajectory can move about 8 points through
# one flipped rounding, so 30 leaves room for several.
STOCHASTIC_MEAN, STOCHASTIC_TOL = 5934.47216796875, 10.0
DETERMINISTIC, DETERMINISTIC_TOL = 5945.88232421875, 30.0
# eval_sim's deterministic episode on the card against the same on the CPU:
# the policy's products sum in another order (tests/test_torch_cuda.py,
# test_deterministic_score_on_card_matches_cpu).
ANALYSIS_CPU_TOL = 10.0
# The counterfactual sweep on the card against the CPU: sin/cos and hypot
# differ by an ulp or two between the card's and the CPU's libraries
# (tests/test_torch_phys.py:65-66), and a speed gain is the difference of
# two speeds near 300-700 ups, whose float32 ulp is 3-6e-5: 1e-3 is 16 of
# them.
SWEEP_ATOL = 1e-3
# Round 5's winner (gr7777) exported from its orbax checkpoint by
# scripts/torch_export_orbax.py, and its scores in
# data/checkpoints/repl_r5/eval_summary.json (std 26.9, max 5,834.2; the
# file has no min).  10 is about 8 standard errors of a 512-episode mean.
R5_CHECKPOINT = (ROOT / "data" / "checkpoints" / "repl_r5"
                 / "best_member_02_rllib")
R5_STOCHASTIC_MEAN, R5_STOCHASTIC_TOL = 5782.3662109375, 10.0
R5_STD, R5_MAX = 26.892921447753906, 5834.21875
# Its deterministic episode follows another trajectory on the TPU
# (eval_summary.json: 5,799.24, printed beside the card's) than on the CPU
# in both packages, so the card is held to the JAX package's deterministic
# score on the CPU (tests/test_torch_analyse.py,
# test_round5_winner_scores_match_jax, checks this constant), within 10
# as the port's CPU score is.
R5_TPU_DETERMINISTIC = 5799.24169921875
R5_DETERMINISTIC, R5_DETERMINISTIC_TOL = 5828.84716796875, 10.0

# Phase 4c, the demo path.  The corrected finish of the JAX package's
# export_sim_demo of tpu_pb on the CPU (data/checkpoints/tpu_pb/
# behaviour.json records 7.8833, printed beside the card's), and the frames
# and corrected finish of its lockstep run of round 5's winner on the CPU
# (repl_r5/winner_lockstep.json, printed beside them, records the same, on
# an unrecorded chip); tests/test_torch_mkdemo.py,
# test_chip_smoke_constants_are_the_jax_runs, checks these constants.  The
# card's demos are held to them within 2 frames: the policy's products
# round otherwise on the card, and the lockstep server's physics uses the
# card's sinf/cosf.
DEMO_EXPORT_FINISH = 7.883333333332915
DEMO_LOCKSTEP_FRAMES, DEMO_LOCKSTEP_FINISH = 723, 7.994444510671828
DEMO_FINISH_TOL = 2 / 72
# The stub engine's lockstep episode: at least this many frames.
DEMO_ENGINE_FRAMES = 700
# The gym shim on the card against the CPU: 4,096 envs for 100 steps.
GYM_SHAPE = (4096, 100)

# Kernel vs plain version (as tests/test_pallas_rollout.py compares the
# Pallas kernel with its scan).
REWARD_RTOL, REWARD_ATOL = 1e-5, 1e-4
STATE_ATOL = 1e-3
YAW_RTOL = 1e-6

# Shapes: (N, T) of the probe-config comparisons, and {shape: (N, T, timed
# reps of the kernel, of its plain version)} of each kernel's timed shapes.
PROBE_SHAPE = (4096, 64)
# rollout_random at a T that ends inside a Philox call's frames (odd, not a
# multiple of its FRAMES_PER_DRAW).
ODD_T_SHAPE = (4096, 67)
# Key latches a hand-made state may hold: a step leaves 0 or 1, and the
# kernels take an env with another latch through its first frame by the
# plain version's operations (csrc/env_rollout.cu, latches_are_bits).
ANY_LATCHES = (-5, -1, 0, 1, 2, 3, 7)
ACTIONS_SHAPES = {"scoring": (512, 1, 1000, 100),
                  "analysis": (1, 1, 1000, 100),
                  "throughput": (65536, 128, 20, 2)}
AUTORESET_SHAPES = {"training": (8192, 1, 1000, 100),
                    "population": (1600, 1, 1000, 100)}
RANDOM_SHAPES = {"throughput": (65536, 128, 20, 2),
                 "bench": (1 << 20, 720, 5, 1)}
ZERO_START_RESETS = 1 << 20
BENCH_ENV = dict(n=1 << 20, t=720, reps=3)
# One training iteration: at run_tpu_e3's 18,432 Adam steps of 128 rows an
# iteration took 115-280 s on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md,
# Findings), over the 150 s at which the smoke run keeps to one; the
# geometry and widths stay full, and the iteration is cut in depth to
# TRAIN_SGD_ITER epochs (6,144 Adam steps), since the Adam steps run on the
# host's clock and a slow host took the whole script to 910 s of its 1,200.
TRAIN_ITERATIONS = 1
TRAIN_SGD_ITER = 1

# The sweep phase: round 5's gated cohort (4 members of 400 envs x 125
# frames, minibatch 128, 30 epochs) at full width, one iteration through
# the sweep CLI; the stacked and the solo Adam step timed over
# ADAM_STEPS steps, profiled over ADAM_PROFILED.
SWEEP_YAML = ROOT / "configs" / "sweep_r5_repl2.yml"
SWEEP_ENV_STEPS = 50_000
# The sweep CLI's iteration cut in depth, for the reason TRAIN_SGD_ITER is:
# 3 of its 30 epochs (1,170 Adam steps on each member, not 11,700).
SWEEP_SGD_ITER = 3
ADAM_STEPS, ADAM_PROFILED = 200, 10
# A member's rollout against a solo run of its seed, (rtol, atol) by field:
# the stacked products sum in another order than a solo run's, so the
# tolerances are the CPU tests' for the port's rollout against the JAX
# package's (tests/test_torch_train.py, test_rollout_matches_jax_frame_by_
# frame; tests/_torch_common.py, assert_env_state_close); the draws, the
# clocks and every flag, action and latch exactly.
MEMBER_TOL = {"obs": (1e-5, 1e-5), "yaw_actions": (1e-5, 1e-5),
              "logits": (1e-5, 1e-6), "value": (1e-5, 1e-6),
              "logp": (1e-5, 1e-4), "reward": (1e-5, 1e-4),
              "reset_uniforms": (0.0, 0.0), "bootstrap": (1e-5, 1e-6),
              "z_pos": (1e-5, 1e-3), "vel_x": (1e-5, 1e-3),
              "vel_y": (1e-5, 1e-3), "vel_z": (1e-5, 1e-3),
              "yaw": (1e-6, 1e-4), "time_remaining": (0.0, 0.0),
              "last_key_press_time": (0.0, 0.0), "stats": (1e-5, 1e-4)}

# The data-parallel phases: params_tpu.yml, two gloo ranks on card 0.
PARAMS_YAML = ROOT / "configs" / "params_tpu.yml"
WORLD = 2
RANK_TIMEOUT_S = 900
# Global (N, T) of the shape each sharded function's main path gives it.
SHARDED_SHAPES = {"sharded_rollout_actions": (512, 1),
                  "sharded_rollout_actions_autoreset": (8192, 1),
                  "sharded_rollout_random": (1 << 20, 720)}
ALLREDUCE_REPS = 200
DP_FRAMES = 96  # params_tpu.yml's rollout_length: one env launch each
# One process against two ranks of one iteration (tests/test_parallel.py
# holds the JAX package's sharded iteration to one device so).
DP_RTOL, DP_ATOL = 1e-3, 1e-5
# Metrics of the host's clock and counters, not of the learning.
CLOCK_KEYS = ("rollout_seconds", "learn_seconds", "collectives",
              "collective_seconds", "steps_per_sec", "iteration", "step",
              "time")


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


def any_latches(state, seed):
    """``state`` with its key latches drawn from ANY_LATCHES."""
    import torch

    rng = np.random.default_rng(seed)
    last_keys = torch.tensor(rng.choice(ANY_LATCHES,
                                        tuple(state.last_keys.shape)),
                             dtype=torch.int32, device=state.last_keys.device)
    return dataclasses.replace(state, last_keys=last_keys)


def replay_eval_sim(env_config, result, seed, device):
    """Replay an ``analyse.eval_sim`` result's recorded actions through
    ``rollout_actions`` from the same zero start, one launch per frame, and
    hold each launch against ``rollout_actions_plain`` on the same state and
    actions, to the bit: the eval_sim shape (N=1, T=1, one partly filled
    block) along a real trajectory.  Returns the yaw the kernel wrote at
    each frame, as numpy, whether the replay met the recorded pre-step
    states and rewards to the bit, and the largest difference from the
    plain version (0.0; any other raises)."""
    import torch

    from q1physrl_torch.env import core
    from q1physrl_torch.ops.env_rollout import (rollout_actions,
                                                rollout_actions_plain)

    cfg = dataclasses.replace(env_config, num_envs=None, zero_start_prob=1.0)
    k = cfg.num_keys
    ka = torch.tensor(result.action[:, :k].astype(np.int32), device=device)
    ya = torch.tensor(result.action[:, k].astype(np.float32), device=device)
    fields = [f.name for f in dataclasses.fields(result.player_state)]
    err = 0.0
    with torch.inference_mode():
        state = core.reset(cfg, torch.Generator(device).manual_seed(seed), 1,
                           device=device)
        pre, yaws, rewards = [], [], []
        for t in range(len(result.reward)):
            pre.append([getattr(state.player, f) for f in fields])
            frame = (ka[t].view(1, k, 1), ya[t].view(1, 1))
            got = rollout_actions(cfg, state, *frame)
            err = max(err, _compare(f"eval_sim frame {t}", got,
                                    rollout_actions_plain(cfg, state,
                                                          *frame)))
            state, r, _ = got
            yaws.append(state.yaw)
            rewards.append(r[0])
        same = np.array_equal(torch.cat(rewards).cpu().numpy(), result.reward)
        for i, f in enumerate(fields):
            got = torch.cat([p[i] for p in pre]).cpu().numpy()
            same &= np.array_equal(got, getattr(result.player_state, f))
        return torch.cat(yaws).cpu().numpy(), bool(same), err


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


def _bitwise(name, err):
    """The kernels run their plain versions' float32 operations in the same
    order: past the tolerances above, any difference is a fault."""
    if err != 0.0:
        raise AssertionError(f"{name}: not bitwise equal to the plain "
                             f"version (largest difference {err})")
    return err


def _compare(name, got, want):
    """Assert the kernel's (state, rewards, dones) equals the plain
    version's, to the bit; return the largest absolute difference of a
    float output (0.0)."""
    (s, r, d), (s0, r0, d0) = got, want
    np_ = lambda x: x.cpu().numpy()
    np.testing.assert_allclose(np_(r), np_(r0), rtol=REWARD_RTOL,
                               atol=REWARD_ATOL, err_msg=f"{name}: rewards")
    np.testing.assert_array_equal(np_(d), np_(d0), err_msg=f"{name}: dones")
    return _bitwise(name, max(float((r - r0).abs().max()),
                              _compare_state(name, s, s0)))


def _compare_random(name, got, want):
    """rollout_random's (state, reward sums, done count) against its plain
    version's: the state as in :func:`_compare`, the sums at the reward
    tolerances, the count exactly, then all of it to the bit."""
    (s, r, d), (s0, r0, d0) = got, want
    np.testing.assert_allclose(r.cpu().numpy(), r0.cpu().numpy(),
                               rtol=REWARD_RTOL, atol=REWARD_ATOL,
                               err_msg=f"{name}: reward sums")
    if int(d) != int(d0):
        raise AssertionError(f"{name}: done count {int(d)} != {int(d0)}")
    return _bitwise(name, max(float((r - r0).abs().max()),
                              _compare_state(name, s, s0)))


def _time_ms(fn, reps, warmup=3):
    """Milliseconds per call: CUDA events around ``reps`` calls after
    ``warmup`` calls."""
    import torch

    for _ in range(warmup):
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
    t, k, n = ka.shape
    step_bytes = (_nbytes((ka, ya)) + t * n * (4 + 1)
                  + int(dones.sum()) * 5 * 4)
    return _least_time(2 * _nbytes(state.leaves()) + step_bytes,
                       OPS_PER_ENV_STEP * n * t)


def _bound_random(state, t, done_count):
    """As :func:`_bound` for rollout_random: the state read and written,
    the per-env reward sum and done count written; its float operations
    and Philox's integer operations: one call per FRAMES_PER_DRAW frames of
    each env, and one per reset of this run."""
    from q1physrl_torch.ops.env_rollout import FRAMES_PER_DRAW

    n = state.num_envs
    calls = -(-t // FRAMES_PER_DRAW)
    ops = ((OPS_PER_ENV_STEP + OPS_PER_RANDOM_FRAME) * n * t
           + PHILOX_OPS * n * calls
           + OPS_PER_RANDOM_RESET * int(done_count))
    return _least_time(2 * _nbytes(state.leaves()) + n * (4 + 4), ops)


def _reset_uniforms(n, steps, seed, device):
    import torch

    rng = np.random.default_rng(1000 + seed)
    return torch.tensor(rng.random((steps, 5, n)), dtype=torch.float32,
                        device=device)


def _timed(kernel, plain, reps, plain_reps):
    return {"ms": _time_ms(kernel, reps),
            "graph_ms": _graph_ms(kernel, min(reps, 100)),
            "plain_ms": _time_ms(plain, plain_reps)}


def _in_place(fn, cfg, state, *inputs):
    """``fn`` called as the frame loops call it: on a copy of ``state`` that
    is its own output, the rewards and dones written into buffers given to
    it.  ``inputs``: the keys, yaw and (for the auto-reset forms) reset
    uniforms.  Returns (state, rewards, dones)."""
    import torch

    t, n = inputs[1].shape
    device = inputs[1].device
    mine = state.clone()
    out = (mine, torch.empty((t, n), dtype=torch.float32, device=device),
           torch.empty((t, n), dtype=torch.bool, device=device))
    if fn(cfg, mine, *inputs, out=out) is not out:
        raise AssertionError(f"{fn.__name__}: out= not returned")
    return out


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
    state, ka, ya = rollout_inputs(run.env, n, t, 40, device)
    state = any_latches(state, 40)
    err = _compare("run4 any latches", rollout_actions(run.env, state, ka, ya),
                   rollout_actions_plain(run.env, state, ka, ya))
    max_err = max(max_err, err)
    _emit({"phase": "kernel", "kernel": "rollout_actions",
           "config": "run4 any latches", "n": n, "t": t, "max_abs_err": err})

    # The timed shapes are compared too, in both launch forms: a new result,
    # and the state written over itself into given buffers, as the frame
    # loops launch it.  The scoring shape is the one the main path
    # launches, and its error is the one the kernels line reports.
    timings = {}
    for shape, (n, t, reps, plain_reps) in ACTIONS_SHAPES.items():
        state, ka, ya = rollout_inputs(run.env, n, t, 100, device)
        kernel = lambda: rollout_actions(run.env, state, ka, ya)
        plain = lambda: rollout_actions_plain(run.env, state, ka, ya)
        want = plain()
        err = _compare(f"run4 {shape} shape", kernel(), want)
        in_place = _compare(f"run4 {shape} shape, in place", _in_place(
            rollout_actions, run.env, state, ka, ya), want)
        max_err = max(max_err, err, in_place)
        timings[shape] = {"n": n, "t": t, "max_abs_err": max(err, in_place),
                          "max_abs_err_in_place": in_place,
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
    state, ka, ya = rollout_inputs(run.env, n, t, 41, device)
    state = any_latches(state, 41)
    ru = _reset_uniforms(n, t, 41, device)
    err = _compare("run4 any latches",
                   rollout_actions_autoreset(run.env, state, ka, ya, ru),
                   rollout_actions_autoreset_plain(run.env, state, ka, ya, ru))
    max_err = max(max_err, err)
    _emit({"phase": "kernel", "kernel": "rollout_actions_autoreset",
           "config": "run4 any latches", "n": n, "t": t, "max_abs_err": err})

    # The training shape: one frame of 8,192 envs, as the PPO rollout
    # launches it (both forms, as above).
    timings = {}
    for shape, (n, t, reps, plain_reps) in AUTORESET_SHAPES.items():
        state, ka, ya = rollout_inputs(run.env, n, t, 101, device)
        ru = _reset_uniforms(n, t, 101, device)
        kernel = lambda: rollout_actions_autoreset(run.env, state, ka, ya, ru)
        plain = lambda: rollout_actions_autoreset_plain(run.env, state, ka,
                                                        ya, ru)
        want = plain()
        err = _compare(f"run4 {shape} shape", kernel(), want)
        in_place = _compare(f"run4 {shape} shape, in place", _in_place(
            rollout_actions_autoreset, run.env, state, ka, ya, ru), want)
        max_err = max(max_err, err, in_place)
        timings[shape] = {"n": n, "t": t, "max_abs_err": max(err, in_place),
                          "max_abs_err_in_place": in_place,
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
    state, _, _ = rollout_inputs(run.env, n, 1, 42, device)
    state = any_latches(state, 42)
    err = _compare_random("run4 any latches",
                          rollout_random(run.env, state, t, 42),
                          rollout_random_plain(run.env, state, t, 42))
    max_err = max(max_err, err)
    _emit({"phase": "kernel", "kernel": "rollout_random",
           "config": "run4 any latches", "n": n, "t": t, "max_abs_err": err})

    n, t = ODD_T_SHAPE
    for seed, name in enumerate(("run4", "hover=True")):
        cfg = dataclasses.replace(probe_configs(run.env)[name],
                                  zero_start_prob=0.3)
        state, _, _ = rollout_inputs(cfg, n, 1, 50 + seed, device)
        want = rollout_random_plain(cfg, state, t, 50 + seed)
        err = _compare_random(f"{name} odd T", rollout_random(
            cfg, state, t, 50 + seed), want)
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


def _phase_training(device, card):
    """The Trainer at the full run_tpu_e3 geometry for TRAIN_ITERATIONS
    iterations; then phase 4c's ``finalize`` on its checkpoint."""
    from q1physrl_torch.algo import checkpoint as ckpt
    from q1physrl_torch.algo.config import load_run_config

    iterations = TRAIN_ITERATIONS
    rollout = {"phase": "training_rollout",
               **_rollout_loops(device, TRAIN_YAML)}
    _emit(rollout)
    with tempfile.TemporaryDirectory(prefix="q1_chip_smoke_") as tmp:
        run = load_run_config(str(TRAIN_YAML))
        run = dataclasses.replace(
            run, ppo=dataclasses.replace(run.ppo,
                                         num_sgd_iter=TRAIN_SGD_ITER),
            checkpoint_dir=tmp, auto_resume=False, max_iterations=iterations)
        trained = _train_once(run, device)
        records = [json.loads(line) for line in
                   (Path(tmp) / "logs" / "metrics.jsonl").read_text()
                   .splitlines()]
        latest = Path(ckpt.latest_checkpoint(tmp)).name
        finalize = _demo_finalize(tmp, device, card)
    per_iter = [{"rollout_seconds": r["rollout_seconds"],
                 "learn_seconds": r["learn_seconds"],
                 "train_steps_per_sec": run.ppo.batch_size
                 / (r["rollout_seconds"] + r["learn_seconds"]),
                 **{k: r[k] for k in ("kl", "entropy", "vf_loss",
                                      "episode_reward_mean", "mean_reward")}}
                for r in records]
    launches = trained["launches"]["rollout_actions_autoreset"]
    result = {"phase": "training", "config": str(TRAIN_YAML.relative_to(ROOT)),
              "iterations": iterations, "seconds": trained["seconds"],
              "num_sgd_iter": run.ppo.num_sgd_iter,
              "batch_size": run.ppo.batch_size,
              "adam_steps_per_iteration": run.ppo.num_sgd_iter
              * run.ppo.num_minibatches,
              "launches": launches, "per_iteration": per_iter,
              "checkpoint": latest,
              "checkpoint_restores": trained["restores"],
              "params_moved": trained["moved"], "rollout_loops": rollout,
              "finalize_launches": finalize["launches"]}
    _emit(result)
    if len(records) != iterations:
        raise RuntimeError("training: missing iterations")
    for r in records:
        _check_training("training", trained, r, "rollout_actions_autoreset",
                        iterations * run.ppo.rollout_length)
    return result


def _sweep_yaml(out_dir, max_env_steps):
    """A copy of SWEEP_YAML writing to ``out_dir`` and stopping at
    ``max_env_steps``, its base a copy with SWEEP_SGD_ITER epochs; returns
    its path."""
    import yaml

    spec = yaml.safe_load(SWEEP_YAML.read_text())
    base = yaml.safe_load((ROOT / spec["base"]).read_text())
    base["ppo"]["num_sgd_iter"] = SWEEP_SGD_ITER
    base_path = Path(out_dir).parent / f"{Path(out_dir).name}_base.yml"
    base_path.parent.mkdir(parents=True, exist_ok=True)
    base_path.write_text(yaml.safe_dump(base))
    spec.update(base=str(base_path), out_dir=str(out_dir),
                max_env_steps=max_env_steps)
    path = Path(out_dir).parent / f"{Path(out_dir).name}.yml"
    path.write_text(yaml.safe_dump(spec))
    return path


def _population_start(env_cfg, ppo, members, device):
    from q1physrl_torch.algo import population

    return population.init_population([m.seed for m in members], env_cfg,
                                      ppo, device)


def _population_kernel(env_cfg, n, members, device):
    """#2 at the population shape (P * n envs, T=1) against P launches on
    each member's n envs: to the bit."""
    import torch

    from q1physrl_torch.ops.env_rollout import rollout_actions_autoreset
    from q1physrl_torch.parallel.mesh import EnvShard, shard_env_axis

    total = members * n
    state, ka, ya = rollout_inputs(env_cfg, total, 1, 102, device)
    ru = _reset_uniforms(total, 1, 102, device)
    whole = rollout_actions_autoreset(env_cfg, state, ka, ya, ru)
    err = 0.0
    for i in range(members):
        shard = EnvShard(i, members, total)
        part = rollout_actions_autoreset(
            env_cfg, shard_env_axis(state, shard), shard.take(ka),
            shard.take(ya), shard.take(ru))
        want = (shard_env_axis(whole[0], shard), shard.take(whole[1]),
                shard.take(whole[2]))
        err = max(err, _compare(f"member {i} of the population launch",
                                part, want))
    return {"n": total, "members": members, "dones": int(whole[2].sum()),
            "max_abs_err_against_member_launches": err}


def _population_rollouts(env_cfg, ppo, members, device):
    """The population rollout through ``population.rollout``: graphed from
    one start twice (the run that captures, then a replay of every frame on
    the kept loop, the generators set back in between) and eager from the
    same start, held equal to the bit (trajectory, state, per-member
    statistics, bootstrap value, every generator); the env kernel's
    launches in the first run.  Returns the eager run, the timings and the
    frame's cost."""
    import torch

    from q1physrl_torch.algo import population
    from q1physrl_torch.ops.env_rollout import rollout_actions_autoreset

    def rollout(ps, driver):
        out = population.rollout(env_cfg, ppo, ps.policy, ps.env_state,
                                 ps.stats, ps.generators, driver=driver)
        return out + ([g.get_state() for g in ps.generators],)

    ps = _population_start(env_cfg, ppo, members, device)
    seeds = [g.get_state() for g in ps.generators]
    runs = {}
    for name in ("first", "graphed"):
        for g, s in zip(ps.generators, seeds):
            g.set_state(s)
        before = _captures()
        rollout_actions_autoreset.launches = 0
        out, seconds = _seconds(lambda: rollout(ps, "graph"), device)
        runs[name] = (out, seconds, _capture_seconds(before),
                      rollout_actions_autoreset.launches)
    loop = next(reversed(population._LOOPS.loops.values()))
    eager, eager_s = _seconds(
        lambda: rollout(_population_start(env_cfg, ppo, members, device),
                        "eager"), device)
    for name, (out, _, _, _) in runs.items():
        (s, st, tr, b, g), (s0, st0, tr0, b0, g0) = out, eager
        same = (all(torch.equal(x, y) for x, y in zip(s.leaves(),
                                                      s0.leaves()))
                and all(torch.equal(getattr(st, f.name), getattr(st0, f.name))
                        for f in dataclasses.fields(st0))
                and all(torch.equal(x, y) for x, y in zip(tr, tr0))
                and torch.equal(b, b0)
                and all(torch.equal(x, y) for x, y in zip(g, g0)))
        if not same:
            raise AssertionError(f"population rollout: the graphed loop's "
                                 f"{name} run differs from the eager driver")
    launches = runs["first"][3]
    if launches != ppo.rollout_length or runs["graphed"][3] != launches:
        raise AssertionError(f"population rollout: expected "
                             f"{ppo.rollout_length} launches of the env "
                             f"kernel per rollout, counted "
                             f"{launches} and {runs['graphed'][3]}")
    if runs["graphed"][2]["captures"]:
        raise AssertionError("population rollout: a second call with the "
                             "same policy and generators captured again")
    return eager, {"launches": launches, "eager_s": eager_s,
                   "first_s": runs["first"][1],
                   "graphed_s": runs["graphed"][1], **runs["first"][2],
                   "graphed_equals_eager_bitwise": True,
                   **_frame_profile(loop, ppo.rollout_length)}


def _members_against_solo_runs(env_cfg, ppo, members, population_out,
                               device):
    """Each member's envs of the population rollout against a solo
    ``ppo.rollout`` of its seed (graphed): generators to the bit, flags,
    actions, latches and dones exactly, floats within MEMBER_TOL."""
    import torch

    from q1physrl_torch.algo import ppo as ppo_mod
    from q1physrl_torch.phys import PlayerState

    leaf_names = [f.name for f in dataclasses.fields(PlayerState)] + [
        "yaw", "time_remaining", "zero_start", "last_keys",
        "last_key_press_time"]
    state, stats, traj, boot, gens = population_out
    n = ppo.num_envs
    worst = {}
    for i, m in enumerate(members):
        ts = ppo_mod.init_train_state(m.seed, env_cfg, ppo, device)
        s_state, s_stats, s_traj, s_boot = ppo_mod.rollout(
            env_cfg, ppo, ts.policy, ts.env_state, ts.stats, ts.generator)
        if not torch.equal(ts.generator.get_state(), gens[i]):
            raise AssertionError(f"member {i}: its generator differs from "
                                 f"a solo run's of seed {m.seed}")
        envs = slice(i * n, (i + 1) * n)
        pairs = [(name, (x[..., envs] if name in ("key_actions",
                                                  "reset_uniforms")
                         else x[:, envs]), y)
                 for name, x, y in zip(ppo_mod.Trajectory._fields, traj,
                                       s_traj)]
        pairs += [(name, x[..., envs], y) for name, x, y in
                  zip(leaf_names, state.leaves(), s_state.leaves())]
        pairs += [("bootstrap", boot[envs], s_boot)]
        pairs += [(f"stats {f.name}", (x[envs] if x.dim() and x.shape[0]
                                       == stats.finished.shape[0] * n
                                       else x[i]), getattr(s_stats, f.name))
                  for f in dataclasses.fields(stats)
                  for x in [getattr(stats, f.name)]]
        for name, x, y in pairs:
            if x.dtype in (torch.bool, torch.int32):
                if not torch.equal(x, y):
                    raise AssertionError(f"member {i}: {name} differs from "
                                         f"the solo run's")
                continue
            x, y = x.double().cpu().numpy(), y.double().cpu().numpy()
            rtol, atol = MEMBER_TOL[name.split()[0]]
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                       err_msg=f"member {i}: {name}")
            # Equal entries (-inf ret_max included) differ by 0.
            diff = np.subtract(x, y, where=x != y, out=np.zeros_like(x))
            err = float(np.abs(diff).max()) if x.size else 0.0
            worst[name] = max(worst.get(name, 0.0), err)
    return {"members": len(members), "generators_equal_bitwise": True,
            "max_abs_err": worst}


def _adam_steps(env_cfg, ppo, members, population_out, device):
    """The stacked Adam step (``population.minibatch_step``: every member's
    minibatch of sgd_minibatch_size rows) against the solo one (member 0's
    minibatch through ``ppo.loss_and_stats`` and ``ppo.adam_update``, as
    ``ppo.sgd_epochs`` steps) over ADAM_STEPS steps each: host ms per step,
    and over ADAM_PROFILED steps the card's busy ms and operations per
    step."""
    import torch

    from q1physrl_torch.algo import population
    from q1physrl_torch.algo import ppo as ppo_mod

    state, stats, traj, boot, _ = population_out
    ps = _population_start(env_cfg, ppo, members, device)
    p = ps.members
    adv, vt = ppo_mod.compute_gae(ppo, traj.reward, traj.done, traj.value,
                                  boot)
    batch = population.member_batch(
        traj, population.standardize(adv, p), vt, p)
    rows = ppo.sgd_minibatch_size
    mb = ppo_mod.Batch(*(x[:, :rows] for x in batch))
    steps = ADAM_STEPS + ADAM_PROFILED + 3
    bc1, bc2 = population.bias_corrections(ps.count, steps, device)
    lr = torch.full((p, 1), -float(np.float32(ppo.lr)), device=device)
    kl = ps.kl_coeff[:, None]
    ent = torch.full((p, 1), float(np.float32(ppo.entropy_coeff)),
                     device=device)
    k = [0]

    def stacked():
        population.minibatch_step(env_cfg, ppo, ps, mb, kl, ent, bc1[k[0]],
                                  bc2[k[0]], lr)
        k[0] += 1

    ts = population.member_train_state(env_cfg, ps, 0)
    solo_mb = ppo_mod.Batch(*(x[0] for x in mb))
    params = [dict(ts.policy.named_parameters())[name]
              for name in ts.opt_state.mu]

    def solo():
        total, _ = ppo_mod.loss_and_stats(env_cfg, ppo, ts.policy, solo_mb,
                                          ts.kl_coeff, ppo.entropy_coeff)
        grads = torch.autograd.grad(total, params)
        ppo_mod.adam_update(ppo, params, grads, ts.opt_state)

    out = {"rows_per_member": rows, "members": p, "steps": ADAM_STEPS}
    for name, fn in (("stacked", stacked), ("solo", solo)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(ADAM_STEPS):
            fn()
        torch.cuda.synchronize(device)
        host_ms = (time.perf_counter() - t0) * 1e3 / ADAM_STEPS
        profile = _device_profile(fn, ADAM_PROFILED)
        out[name] = {"host_ms_per_step": host_ms,
                     "card_busy_ms_per_step": profile["device_ms"],
                     "kernels_per_step": profile["operations"],
                     "top": profile["top"]}
    out["stacked_over_solo_host"] = (out["stacked"]["host_ms_per_step"]
                                     / out["solo"]["host_ms_per_step"])
    return out


def _sweep_cli(env_cfg, ppo, members, device):
    """One population iteration through the sweep CLI on a copy of
    SWEEP_YAML (max_env_steps SWEEP_ENV_STEPS) in a temporary directory:
    the env kernel's launches, a log row of finite metrics per member, a
    stacked checkpoint that restores, every member's params moved; seconds
    split into rollout and learning."""
    import torch

    from q1physrl_torch.algo import checkpoint as ckpt
    from q1physrl_torch.algo import sweep
    from q1physrl_torch.ops.env_rollout import rollout_actions_autoreset

    with tempfile.TemporaryDirectory(prefix="q1_chip_sweep_") as tmp:
        out_dir = Path(tmp) / "out"
        spec = _sweep_yaml(out_dir, SWEEP_ENV_STEPS)
        rollout_actions_autoreset.launches = 0
        trainer, seconds = _seconds(
            lambda: sweep.main([str(spec), "--device", str(device)]), device)
        launches = rollout_actions_autoreset.launches
        rows = [[json.loads(line) for line in
                 (out_dir / "logs" / f"member_{i:02d}.jsonl").read_text()
                 .splitlines()] for i in range(len(members))]
        latest = ckpt.latest_checkpoint(str(out_dir / "stacked"))
        fresh = _population_start(env_cfg, ppo, members, device)
        start_flat = fresh.policy.flat.clone()
        restored = ckpt.restore_population(latest, fresh)
    ps = trainer.ps
    moved = [not torch.equal(ps.policy.flat[i], start_flat[i])
             for i in range(ps.members)]
    restores = (torch.equal(restored.policy.flat, ps.policy.flat)
                and torch.equal(restored.mu, ps.mu)
                and restored.count == ps.count
                and restored.env_steps == ps.env_steps)
    finite = all(len(r) == 1 and all(np.isfinite(r[0][k]) for k in
                                     ("entropy", "kl", "vf_loss", "kl_coeff",
                                      "mean_reward")) and r[0]["kl"] >= 0
                 for r in rows)
    result = {"config": str(SWEEP_YAML.relative_to(ROOT)),
              "max_env_steps": SWEEP_ENV_STEPS, "seconds": seconds,
              "num_sgd_iter": ppo.num_sgd_iter,
              **trainer.seconds, "iterations": ps.iteration,
              "env_steps": ps.env_steps,
              "adam_steps_per_iteration": ppo.num_sgd_iter
              * ppo.num_minibatches, "launches": launches,
              "checkpoint": Path(latest).name, "checkpoint_restores":
              restores, "params_moved": moved, "rows_finite": finite,
              "rows": [{k: r[0][k] for k in ("entropy", "kl", "vf_loss",
                                             "mean_reward", "entropy_coeff",
                                             "lr", "stage")} for r in rows]}
    if launches != ppo.rollout_length:
        raise RuntimeError(f"sweep: expected {ppo.rollout_length} launches "
                           f"of the env kernel, counted {launches}")
    if not (finite and restores and all(moved)
            and ps.iteration == [1] * len(members)):
        raise RuntimeError(f"sweep: the CLI's iteration is not sane: "
                           f"{result}")
    return result


def _phase_sweep(device):
    """5a: round 5's gated cohort (SWEEP_YAML) on the card: #2 at the
    population shape against the members' own launches, the population
    rollout graphed against eager and each member against a solo run of
    its seed, the stacked and the solo Adam step timed, and one iteration
    through the sweep CLI."""
    from q1physrl_torch.algo import sweep

    run, members, *_ = sweep.load_sweep(str(_sweep_yaml(
        Path(tempfile.mkdtemp(prefix="q1_chip_sweep_spec_")) / "spec",
        SWEEP_ENV_STEPS)))
    env_cfg = dataclasses.replace(run.env, num_envs=None)
    ppo = dataclasses.replace(run.ppo, lr_schedule=None,
                              entropy_coeff_schedule=None)
    kernel = _population_kernel(env_cfg, ppo.num_envs, len(members), device)
    _emit({"phase": "sweep_kernel", **kernel})
    eager, loops = _population_rollouts(env_cfg, ppo, members, device)
    _emit({"phase": "sweep_rollout", "n": len(members) * ppo.num_envs,
           "frames": ppo.rollout_length, **loops})
    solo = _members_against_solo_runs(env_cfg, ppo, members, eager, device)
    _emit({"phase": "sweep_members", **solo})
    adam = _adam_steps(env_cfg, ppo, members, eager, device)
    _emit({"phase": "sweep_adam", **adam})
    cli = _sweep_cli(env_cfg, ppo, members, device)
    result = {"phase": "sweep", **cli, "kernel": kernel, "rollout": loops,
              "members_against_solo": solo, "adam": adam}
    _emit(result)
    return result


def _seconds(fn, device):
    """``fn()`` and the host seconds it took, the card synchronized."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _captures():
    from q1physrl_torch.utils import cuda_graph

    return dict(cuda_graph.counters)


def _capture_seconds(before):
    """Seconds spent capturing frame graphs since ``before``
    (:func:`_captures`), and how many were captured."""
    now = _captures()
    return {"capture_s": now["capture_seconds"] - before["capture_seconds"],
            "captures": now["captures"] - before["captures"]}


def _device_profile(fn, calls, top=8):
    """What the card ran per call of ``fn``, from torch.profiler over
    ``calls`` calls: the operations (kernels, copies and fills), their
    summed device milliseconds, and the ``top`` names by device time with
    their microseconds and counts per call."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us, count = collections.Counter(), collections.Counter()
    for e in events:
        us[e.name[:80]] += e.time_range.elapsed_us()
        count[e.name[:80]] += 1
    return {"operations": len(events) / calls,
            "device_ms": sum(us.values()) / calls / 1e3,
            "top": [[name, t / calls, count[name] / calls]
                    for name, t in us.most_common(top)]}


def _frame_profile(loop, frames):
    """What a replayed frame of ``loop`` (a ``utils.cuda_graph.FrameLoop``
    whose frame is captured; ``frames`` per run) costs: ``frame_ms``, the
    card's time per replay (CUDA events over a run's replays back to back),
    the operations per frame the profiler sees in replays and in one eager
    frame, the replay's summed device time (``frame_busy_ms``: the rest of
    ``frame_ms`` is the gaps between its nodes) and its costliest kernels
    (``frame_top``: name, device microseconds and count per frame).  It
    replays the graph itself, so the launch counts do not move, and leaves
    the loop's buffers advanced (a loop that records rewinds its index
    first, staying inside its records): the next run starts them anew."""
    import torch

    graph = loop.graph.graph
    rewind = getattr(loop, "idx", None)
    rewind = rewind.zero_ if rewind is not None else (lambda: None)
    reps = min(frames, 200)
    with torch.inference_mode():  # the loops' buffers may be inference
        rewind()
        frame_ms = _time_ms(graph.replay, reps - 3)
        rewind()
        replayed = _device_profile(graph.replay, 5)
        rewind()
        eager = _device_profile(loop.frame, 1)
    return {"frame_ms": frame_ms, "kernels_per_frame": replayed["operations"],
            "kernels_per_eager_frame": eager["operations"],
            "frame_busy_ms": replayed["device_ms"],
            "frame_top": replayed["top"]}


def _cached_loop(name, size):
    """The captured loop that ``analyse`` keeps for the loop ``name`` on
    ``size`` envs (or frames)."""
    from q1physrl_torch import analyse

    (loop,) = [v for k, v in analyse._LOOPS.loops.items()
               if k[0] == name and k[4] == size]
    return loop


def _same_returns(name, graphed, eager):
    if not np.array_equal(graphed, eager):
        raise AssertionError(f"{name}: the graphed loop's returns differ "
                             f"from the eager driver's (largest difference "
                             f"{float(np.abs(graphed - eager).max())})")


def _scoring_loops(name, checkpoint, device, steps, cli_s, captures):
    """Beside a scoring phase's CLI run (graphed): the eager driver on the
    card for both of its modes, held to the graphed returns to the bit, the
    graphed loop timed again (its capture reused), and the frame's cost."""
    from q1physrl_torch import analyse
    from q1physrl_torch.algo.evaluate import resolve_checkpoint
    from q1physrl_torch.models import Policy, import_policy_params

    run_env = _run4_env()
    policy = Policy(run_env, device=device)
    policy.load_state_dict(import_policy_params(
        resolve_checkpoint(str(checkpoint))))
    out = {"phase": f"{name}_loops", "frames": steps, "cli_s": cli_s,
           **captures}
    for mode, n, deterministic in (("stochastic", 512, False),
                                   ("deterministic", 2, True)):
        run = lambda driver: analyse.zero_start_returns(
            policy, run_env, num_episodes=n, deterministic=deterministic,
            device=device, driver=driver)
        graphed, graphed_s = _seconds(lambda: run("graph"), device)
        eager, eager_s = _seconds(lambda: run("eager"), device)
        _same_returns(f"{name} {mode}", graphed, eager)
        out[mode] = {"n": n, "eager_s": eager_s, "graphed_s": graphed_s,
                     "graphed_equals_eager_bitwise": True}
    out.update(_frame_profile(_cached_loop("zero_start", 512), steps))
    _emit(out)
    return out


def _run4_env():
    from q1physrl_torch.algo.config import load_run_config

    return load_run_config(str(RUN_YAML)).env


def _rollout_loops(device, run_yaml, shard=None):
    """The PPO rollout at ``run_yaml``'s geometry through ``ppo.rollout``,
    as the Trainer, spmd and ``train_iter`` call it: graphed from one start
    twice (the run that captures, then one that replays every frame on the
    kept loop, the generator set back in between as spmd reseeds its rank
    generator), and eager from the same start on the card.  Trajectory,
    final state, episode statistics, bootstrap value and the generator's
    state are held equal to the bit; returns the seconds of each run, the
    capture's, and the frame's cost.  ``shard``: this rank's envs (global
    mode)."""
    import torch

    from q1physrl_torch.algo import ppo
    from q1physrl_torch.algo.config import load_run_config
    from q1physrl_torch.parallel.mesh import shard_env_axis

    run = load_run_config(str(run_yaml))
    cfg = dataclasses.replace(run.env, num_envs=None)

    def start():
        ts = ppo.init_train_state(run.seed, cfg, run.ppo, device)
        state, stats = ts.env_state, ts.stats
        if shard is not None:
            state, stats = (shard_env_axis(state, shard),
                            shard_env_axis(stats, shard))
        return ts, state, stats

    def rollout(ts, state, stats, driver):
        out = ppo.rollout(cfg, run.ppo, ts.policy, state, stats,
                          ts.generator, shard, driver=driver)
        return out + (ts.generator.get_state(),)

    ts, state, stats = start()
    seed_state = ts.generator.get_state()
    runs = {}
    for name in ("first", "graphed"):
        ts.generator.set_state(seed_state)
        before = _captures()
        out, seconds = _seconds(lambda: rollout(ts, state, stats, "graph"),
                                device)
        runs[name] = (out, seconds, _capture_seconds(before))
    loop = next(reversed(ppo._LOOPS.loops.values()))
    eager, eager_s = _seconds(lambda: rollout(*start(), "eager"), device)
    for name, (out, _, _) in runs.items():
        (s, st, tr, b, g), (s0, st0, tr0, b0, g0) = out, eager
        same = (all(torch.equal(x, y) for x, y in zip(s.leaves(),
                                                      s0.leaves()))
                and all(torch.equal(getattr(st, f.name), getattr(st0, f.name))
                        for f in dataclasses.fields(st0))
                and all(torch.equal(x, y) for x, y in zip(tr, tr0))
                and torch.equal(b, b0) and torch.equal(g, g0))
        if not same:
            raise AssertionError(f"rollout: the graphed loop's {name} run "
                                 f"differs from the eager driver")
    if runs["graphed"][2]["captures"]:
        raise AssertionError("rollout: a second call with the same policy "
                             "and generator captured again")
    return {"config": str(Path(run_yaml).relative_to(ROOT)),
            "n": state.num_envs, "frames": run.ppo.rollout_length,
            "eager_s": eager_s, "first_s": runs["first"][1],
            "graphed_s": runs["graphed"][1], **runs["first"][2],
            "graphed_equals_eager_bitwise": True,
            **_frame_profile(loop, run.ppo.rollout_length)}


def _phase_analysis(run, device, steps):
    """4a: eval_sim of tpu_pb on the card, its checks, and the sweep.
    Returns the launches of rollout_actions in the eval_sim on the card,
    and the largest difference of the replay's launches from the plain
    version."""
    import torch

    from q1physrl_torch import analyse
    from q1physrl_torch.models import Policy, import_policy_params
    from q1physrl_torch.ops.env_rollout import rollout_actions

    cpu = torch.device("cpu")
    policies = {}
    for dev in (device, cpu):
        policies[dev.type] = Policy(run.env, device=dev)
        policies[dev.type].load_state_dict(import_policy_params(
            str(CHECKPOINT)))
    sim = lambda dev: analyse.eval_sim(policies[dev.type], run.env,
                                       deterministic=True, device=dev)
    rollout_actions.launches = 0
    captures = _captures()
    card, card_s = _seconds(lambda: sim(device), device)
    launches = rollout_actions.launches
    captured = _capture_seconds(captures)
    host, host_s = _seconds(lambda: sim(cpu), cpu)
    # The graphed loop again (its capture reused) and the eager driver, on
    # the card: every recorded field to the bit.
    again, graphed_s = _seconds(lambda: sim(device), device)
    eager, eager_s = _seconds(lambda: analyse.eval_sim(
        policies[device.type], run.env, deterministic=True, device=device,
        driver="eager"), device)
    loops = {"phase": "analysis_loops", "frames": steps,
             "first_s": card_s, **captured, "graphed_s": graphed_s,
             "eager_s": eager_s,
             "graphed_equals_eager_bitwise": _same_sim(again, eager)
             and _same_sim(card, eager),
             **_frame_profile(_cached_loop("sim", steps), steps)}
    _emit(loops)
    if not loops["graphed_equals_eager_bitwise"]:
        raise AssertionError("analysis: the graphed eval_sim differs from "
                             "the eager driver's")

    kernel_yaw, replayed, replay_err = replay_eval_sim(run.env, card, 0,
                                                      device)
    yaw_bitwise = np.array_equal(kernel_yaw, card.yaw)
    sweep, sweep_s = _seconds(card.hypothetical_delta_speeds, device)
    sweep_cpu, sweep_cpu_s = _seconds(dataclasses.replace(
        card, device="cpu").hypothetical_delta_speeds, cpu)
    sweep_err = float(np.abs(sweep - sweep_cpu).max())
    returns = {"cuda": float(card.reward.sum()),
               "cpu": float(host.reward.sum())}
    _emit({"phase": "analysis", "config": str(RUN_YAML.relative_to(ROOT)),
           "frames": steps, "recorded_frames": len(card.reward),
           "launches": launches, "seconds": {"cuda": card_s, "cpu": host_s},
           "return": returns, "yaw_equals_kernel_bitwise": yaw_bitwise,
           "replay_equals_record_bitwise": replayed,
           "replay_max_abs_err_vs_plain": replay_err,
           "sweep": {"shape": list(sweep.shape), "max_abs_err": sweep_err,
                     "atol": SWEEP_ATOL,
                     "seconds": {"cuda": sweep_s, "cpu": sweep_cpu_s}}})
    if launches != steps:
        raise RuntimeError(f"analysis: expected one rollout_actions launch "
                           f"per frame ({steps}), counted {launches}")
    if not (yaw_bitwise and replayed):
        raise AssertionError("analysis: the recorded decoded yaw or the "
                             "replayed trajectory differs from the kernel's")
    if not abs(returns["cuda"] - DETERMINISTIC) <= DETERMINISTIC_TOL:
        raise RuntimeError(f"analysis: return {returns['cuda']} is not "
                           f"within {DETERMINISTIC_TOL} of {DETERMINISTIC}")
    if not abs(returns["cuda"] - returns["cpu"]) <= ANALYSIS_CPU_TOL:
        raise RuntimeError(f"analysis: the card's return is not within "
                           f"{ANALYSIS_CPU_TOL} of the CPU's: {returns}")
    if not (sweep.shape == (360, len(card.reward))
            and np.isfinite(sweep).all() and sweep_err <= SWEEP_ATOL):
        raise AssertionError(f"analysis: the sweep on the card differs from "
                             f"the CPU's by {sweep_err} (shape "
                             f"{sweep.shape})")
    return launches, replay_err


def _same_sim(a, b):
    """Whether two ``EvalSimResult``s hold the same record, to the bit."""
    fields = lambda r: [getattr(r.player_state, f.name) for f in
                        dataclasses.fields(r.player_state)] + [
        r.action, r.obs, r.reward, r.yaw, r.smove, r.fmove, r.jump]
    return all(np.array_equal(x, y) for x, y in zip(fields(a), fields(b)))


def _phase_scoring_r5(device, steps):
    """4b: the evaluate CLI on round 5's winner, given as a directory.
    Returns the launches of rollout_actions."""
    from q1physrl_torch.algo import evaluate
    from q1physrl_torch.ops.env_rollout import rollout_actions

    rollout_actions.launches = 0
    captures = _captures()
    (sto, det), seconds = _seconds(lambda: evaluate.main(
        [str(RUN_YAML), str(R5_CHECKPOINT), "512", "--device", str(device)]),
        device)
    launches = rollout_actions.launches
    _scoring_loops("scoring_r5", R5_CHECKPOINT, device, steps, seconds,
                   _capture_seconds(captures))
    _emit({"phase": "scoring_r5",
           "checkpoint": str(R5_CHECKPOINT.relative_to(ROOT)),
           "seconds": seconds, "launches": launches, "stochastic": sto,
           "deterministic": det["mean"],
           "jax_cpu_deterministic": R5_DETERMINISTIC,
           "eval_summary": {"stochastic_mean": R5_STOCHASTIC_MEAN,
                            "std": R5_STD, "max": R5_MAX,
                            "deterministic": R5_TPU_DETERMINISTIC}})
    if launches != 2 * steps:
        raise RuntimeError(f"scoring_r5: expected one kernel launch per env "
                           f"step ({2 * steps}), counted {launches}")
    if not abs(sto["mean"] - R5_STOCHASTIC_MEAN) <= R5_STOCHASTIC_TOL:
        raise RuntimeError(f"scoring_r5: stochastic mean {sto['mean']} is "
                           f"not within {R5_STOCHASTIC_TOL} of "
                           f"{R5_STOCHASTIC_MEAN}")
    if not abs(det["mean"] - R5_DETERMINISTIC) <= R5_DETERMINISTIC_TOL:
        raise RuntimeError(f"scoring_r5: deterministic score {det['mean']} "
                           f"is not within {R5_DETERMINISTIC_TOL} of the "
                           f"JAX package's on the CPU, {R5_DETERMINISTIC}")
    return launches


# --- phase 4c: the demo path ----------------------------------------------


# An executable stand-in for quakespasm: serves the port's lockstep server on
# the ``-port`` it is given (26000 without one) on ``device``, and on the
# SIGINT that stops it writes the frames it served to ``<stub>.stopped``.
STUB = """#!{python}
import asyncio, sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from q1physrl_torch.utils.lockstep_server import LockstepServer

async def main():
    argv = sys.argv[1:]
    port = int(argv[argv.index("-port") + 1]) if "-port" in argv else 26000
    server = LockstepServer(device={device!r})
    await server.start("127.0.0.1", port)
    try:
        await asyncio.sleep(3600)
    except asyncio.CancelledError:
        Path(sys.argv[0] + ".stopped").write_text(str(server.frames))
        raise

try:
    asyncio.run(main())
except KeyboardInterrupt:
    pass
"""


def write_stub(directory, device) -> Path:
    """:data:`STUB` as an executable ``quakespasm`` in ``directory``."""
    import stat

    stub = Path(directory) / "quakespasm"
    stub.write_text(STUB.format(python=sys.executable, repo=str(ROOT),
                                device=str(device)))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    return stub


def _free_udp_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _cross_parse(name, dem):
    """The .dem through the port's reader and its C++ binding: equal
    arrays and finish; returns the reader's (times, origins, yaws,
    finish)."""
    from q1physrl_torch import analyse, native

    parsed = analyse.parse_demo(dem)
    times, origins, yaws, finish = native.parse_demo(dem)
    same = (np.array_equal(times, parsed[0])
            and np.array_equal(origins, np.asarray(parsed[1], np.float32))
            and np.array_equal(yaws, np.asarray(parsed[2], np.float32))
            and finish == parsed[3])
    if not same:
        raise AssertionError(f"{name}: the two demo parsers disagree")
    return parsed


def _demo_export(device, card, steps, tmp):
    """``export``: the make-demo CLI's simulated export of tpu_pb."""
    from q1physrl_torch import mkdemo
    from q1physrl_torch.ops.env_rollout import rollout_actions

    dem = Path(tmp) / "tpu_pb.dem"
    rollout_actions.launches = 0
    (r, corrected), seconds = _seconds(lambda: mkdemo.main(
        [str(RUN_YAML), str(CHECKPOINT), str(dem), "--device", str(device)]),
        device)
    launches = rollout_actions.launches
    times, origins, yaws, _ = _cross_parse("export", dem)
    # The demo against the EvalSimResult it was written from: TIME blocks
    # at the trajectory's clock, origins in 13.3 fixed point (a 16-bit
    # field: the writer clamps them to [-4,096, 4,095.875]) one record
    # behind (record 0 carries the baseline), the view yaw as float32.
    t, o, y = mkdemo.trajectory_from_result(r)
    behind = np.clip(np.concatenate([o[:1], o[:-1]]), -4096, 4095.875)
    consistent = (len(times) == len(t)
                  and np.allclose(times, t, rtol=0, atol=1e-5)
                  and np.allclose(origins, behind, rtol=0,
                                  atol=1 / 16 + 1e-6)
                  and np.array_equal(np.asarray(yaws, np.float32),
                                     y.astype(np.float32)))
    behaviour = json.loads((CHECKPOINT.parent / "behaviour.json").read_text())
    out = {"phase": "demo_export", "card": card,
           "checkpoint": str(CHECKPOINT.relative_to(ROOT)),
           "export_s": seconds, "launches": launches, "frames": steps,
           "demo_frames": len(times), "return": float(r.reward.sum()),
           "corrected_finish": corrected,
           "jax_cpu_corrected_finish": DEMO_EXPORT_FINISH,
           "behaviour_json_corrected_finish":
               behaviour["corrected_finish_time"],
           "crossparse": True, "consistent_with_result": consistent}
    _emit(out)
    if launches != steps:
        raise RuntimeError(f"demo export: expected one rollout_actions "
                           f"launch per frame ({steps}), counted {launches}")
    if not consistent:
        raise AssertionError("demo export: the demo differs from the "
                             "trajectory it was written from")
    if corrected is None or not (abs(corrected - DEMO_EXPORT_FINISH)
                                 <= DEMO_FINISH_TOL):
        raise RuntimeError(f"demo export: corrected finish {corrected} is "
                           f"not within 2 frames of the JAX package's "
                           f"{DEMO_EXPORT_FINISH}")
    return out


def _replay_lockstep(run, record):
    """Each recorded launch of the lockstep loop again through the kernel
    and through its plain version on the same decoder state and actions,
    to the bit; returns the largest difference (0.0; any other raises) and
    whether every launch wrote the recorded yaw and the yaw sent equals
    it, to the bit."""
    import torch

    from q1physrl_torch.ops.env_rollout import (rollout_actions,
                                                rollout_actions_plain)

    cfg = dataclasses.replace(run.env, num_envs=None)
    err, yaw_sent = 0.0, True
    for t, frame in enumerate(record):
        args = (cfg, frame["state"], frame["key_actions"].unsqueeze(0),
                frame["yaw_action"].unsqueeze(0))
        got = rollout_actions(*args)
        err = max(err, _compare(f"lockstep frame {t}", got,
                                rollout_actions_plain(*args)))
        kernel_yaw = frame["kernel_yaw"]
        yaw_sent &= (torch.equal(got[0].yaw, kernel_yaw)
                     and frame["sent"][0] == float(kernel_yaw[0]))
    return err, yaw_sent


def _demo_lockstep(device, card, tmp):
    """``lockstep``: the make-demo CLI over the lockstep bridge on round
    5's winner, then the same loop again with its launches recorded and
    replayed."""
    import asyncio

    from q1physrl_torch import mkdemo
    from q1physrl_torch.algo.config import load_run_config
    from q1physrl_torch.ops.env_rollout import rollout_actions

    dem = Path(tmp) / "r5_lockstep.dem"
    rollout_actions.launches = 0
    _, seconds = _seconds(lambda: mkdemo.main(
        ["--lockstep", str(RUN_YAML), str(R5_CHECKPOINT), str(dem),
         "--device", str(device)]), device)
    launches = rollout_actions.launches
    times, _, _, finish = _cross_parse("lockstep", dem)
    corrected = (finish + mkdemo.DEMO_TIME_CORRECTION - times[0]
                 if finish is not None else None)

    record = []
    again = Path(tmp) / "r5_lockstep_again.dem"
    asyncio.run(mkdemo.make_demo_lockstep(str(R5_CHECKPOINT), str(RUN_YAML),
                                          str(again), device=device,
                                          record=record))
    rerun_same = again.read_bytes() == dem.read_bytes()
    replay_err, yaw_sent = _replay_lockstep(load_run_config(str(RUN_YAML)),
                                            record)
    committed = json.loads((R5_CHECKPOINT.parent / "winner_lockstep.json")
                           .read_text())
    out = {"phase": "demo_lockstep", "card": card,
           "checkpoint": str(R5_CHECKPOINT.relative_to(ROOT)),
           "lockstep_s": seconds, "launches": launches,
           "ms_per_frame": 1e3 * seconds / max(launches, 1),
           "frames": len(times), "corrected_finish": corrected,
           "jax_cpu": {"frames": DEMO_LOCKSTEP_FRAMES,
                       "corrected_finish": DEMO_LOCKSTEP_FINISH},
           "winner_lockstep_json": {
               "frames": committed["frames"],
               "corrected_finish": committed["corrected_finish"]},
           "crossparse": True, "rerun_equals_bitwise": rerun_same,
           "replayed_launches": len(record),
           "replay_max_abs_err_vs_plain": replay_err,
           "yaw_sent_equals_kernel_bitwise": yaw_sent}
    _emit(out)
    # One launch per policy frame: every TIME block but the spawn frame's.
    if launches != len(times) - 1 or len(record) != launches:
        raise RuntimeError(f"demo lockstep: expected one rollout_actions "
                           f"launch per policy frame ({len(times) - 1}), "
                           f"counted {launches} ({len(record)} recorded)")
    if not (rerun_same and yaw_sent):
        raise AssertionError("demo lockstep: a second run differs, or the "
                             "yaw sent differs from the kernel's")
    if (abs(len(times) - DEMO_LOCKSTEP_FRAMES) > 2 or corrected is None
            or abs(corrected - DEMO_LOCKSTEP_FINISH) > DEMO_FINISH_TOL):
        raise RuntimeError(f"demo lockstep: {len(times)} frames, corrected "
                           f"finish {corrected}: not within 2 frames of the "
                           f"JAX package's {DEMO_LOCKSTEP_FRAMES} and "
                           f"{DEMO_LOCKSTEP_FINISH}")
    return out


def _demo_engine(device, card, tmp):
    """``engine``: ``mkdemo.make_demo`` against the stub engine on a free
    port, the stub's server on the card."""
    import asyncio

    from q1physrl_torch import mkdemo
    from q1physrl_torch.ops.env_rollout import rollout_actions

    stub = write_stub(tmp, device)
    dem = Path(tmp) / "engine.dem"
    rollout_actions.launches = 0
    corrected, seconds = _seconds(lambda: asyncio.run(mkdemo.make_demo(
        str(CHECKPOINT), str(RUN_YAML), str(stub), str(tmp), str(dem),
        port=_free_udp_port(), device=device)), device)
    launches = rollout_actions.launches
    times, origins, _, finish = _cross_parse("engine", dem)
    stopped = Path(str(stub) + ".stopped")
    served = int(stopped.read_text()) if stopped.exists() else None
    rate = float(np.abs(np.diff(times) - 1 / 72).max())
    out = {"phase": "demo_engine", "card": card, "engine_s": seconds,
           "launches": launches, "frames": len(times),
           "frames_served": served, "max_frame_period_err_s": rate,
           "corrected_finish": corrected, "stopped_by_sigint":
           served is not None}
    _emit(out)
    if served is None:
        raise RuntimeError("demo engine: the stub engine was not stopped "
                           "by make_demo's SIGINT")
    if not (len(times) >= DEMO_ENGINE_FRAMES and served == len(times)
            and launches == len(times) - 1 and rate <= 1e-5
            and abs(origins[0][2] - 32.875) < 1e-4):
        raise RuntimeError(f"demo engine: {len(times)} frames (served "
                           f"{served}, {launches} launches), frame period "
                           f"off by {rate} s")
    if corrected is None or finish is None:
        raise RuntimeError("demo engine: tpu_pb did not finish")
    return out


def _state_on(state, device):
    """A copy of an ``EnvState`` on ``device``."""
    from q1physrl_torch.ops.env_rollout import _state_from

    return _state_from([x.to(device, copy=True) for x in state.leaves()])


def _gym_on_card(device, card):
    """``gym``: ``VectorPhysEnv`` on the card at GYM_SHAPE, each step held
    to the same step on the CPU from the card's state: rewards and the
    state at tests/test_pallas_rollout.py's tolerances, dones, flags and
    key latches exactly, the observation's quantized columns within one
    quantum (a velocity or z an ulp apart can round to the next one)."""
    import torch

    from q1physrl_torch.env import VectorPhysEnv, get_obs_scale

    n, steps = GYM_SHAPE
    cfg = dict(num_envs=n, zero_start_prob=0.5)
    card_env = VectorPhysEnv(cfg, seed=0, device=device)
    cpu_env = VectorPhysEnv(cfg, seed=0, device="cpu")
    scale = np.asarray(get_obs_scale(card_env._config), np.float64)
    quantum = np.array([0, 0, 1 / 8, 16, 16, 16]) / scale
    rng = np.random.default_rng(0)
    k = card_env._config.num_keys
    seconds = {"cuda": 0.0, "cpu": 0.0}
    flips, err = 0, 0.0
    for _ in range(steps):
        actions = np.concatenate(
            [rng.integers(0, 2, (n, k)),
             rng.uniform(-1, 1, (n, 1)) * card_env._config.action_range],
            axis=1)
        cpu_env._state = _state_on(card_env._state, "cpu")
        got, s = _seconds(lambda: card_env.vector_step(actions), device)
        seconds["cuda"] += s
        want, s = _seconds(lambda: cpu_env.vector_step(actions),
                           torch.device("cpu"))
        seconds["cpu"] += s
        (obs, rew, done, _), (obs0, rew0, done0, _) = got, want
        np.testing.assert_allclose(rew, rew0, rtol=REWARD_RTOL,
                                   atol=REWARD_ATOL, err_msg="gym rewards")
        np.testing.assert_array_equal(done, done0, err_msg="gym dones")
        diff = np.abs(obs.astype(np.float64) - obs0)
        np.testing.assert_allclose(obs[:, :2], obs0[:, :2], rtol=YAW_RTOL,
                                   err_msg="gym obs time, yaw")
        if not (diff[:, 2:] <= quantum[2:] * (1 + 1e-6)).all():
            raise AssertionError("gym: an observation differs by more than "
                                 "one quantum")
        flips += int((diff[:, 2:] > 0).sum())
        err = max(err, _compare_state(
            "gym", _state_on(card_env._state, "cpu"), cpu_env._state))
    out = {"phase": "demo_gym", "card": card, "n": n, "steps": steps,
           "seconds": seconds, "max_abs_err_state": err,
           "obs_quantum_flips": flips}
    _emit(out)
    return out


def _demo_finalize(checkpoint_dir, device, card):
    """``finalize`` (run from phase 5, inside its temporary directory):
    ``scripts/torch_finalize_run.py`` on the training run's checkpoint.
    Returns its line, with the launches of rollout_actions."""
    import importlib.util

    from q1physrl_torch.ops.env_rollout import rollout_actions

    spec = importlib.util.spec_from_file_location(
        "torch_finalize_run", ROOT / "scripts" / "torch_finalize_run.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out_dir = Path(checkpoint_dir) / "bundle"
    rollout_actions.launches = 0
    (evals, behaviour), seconds = _seconds(lambda: script.main(
        [str(TRAIN_YAML), str(checkpoint_dir), str(out_dir), "--device",
         str(device)]), device)
    launches = rollout_actions.launches
    files = ["eval.json", "run.dem", "checkpoint", "checkpoint.tune_metadata",
             "native/train_state.pt", "native_meta.json", "behaviour.json"]
    missing = [f for f in files if not (out_dir / f).is_file()]
    _cross_parse("finalize", out_dir / "run.dem")
    keys = list(json.loads((CHECKPOINT.parent / "behaviour.json")
                           .read_text()))
    scores = list(evals["stochastic"].values()) + [evals["deterministic"]]
    from q1physrl_torch.algo.config import load_run_config

    env = load_run_config(str(TRAIN_YAML)).env
    steps = int(np.ceil(env.time_limit / env.time_delta)) + 2
    out = {"phase": "demo_finalize", "card": card, "finalize_s": seconds,
           "launches": launches, "files": files, "missing": missing,
           "stochastic": evals["stochastic"],
           "deterministic": evals["deterministic"], "behaviour": behaviour}
    _emit(out)
    if missing or list(behaviour) != keys:
        raise RuntimeError(f"finalize: missing {missing}, behaviour keys "
                           f"{list(behaviour)}")
    if not np.isfinite(scores).all():
        raise RuntimeError(f"finalize: scores not finite: {evals}")
    # 512 + 2 episodes and the demo's eval_sim, one launch per frame each.
    if launches != 3 * steps:
        raise RuntimeError(f"finalize: expected {3 * steps} rollout_actions "
                           f"launches, counted {launches}")
    return out


def _phase_demo(device, card, steps):
    """4c: the demo path on the card (``export``, ``lockstep``, ``engine``,
    ``gym``; ``finalize`` runs in phase 5).  Returns the launches of
    rollout_actions on each path, and the largest difference of the
    lockstep loop's replayed launches from the plain version."""
    with tempfile.TemporaryDirectory(prefix="q1_chip_demo_") as tmp:
        export = _demo_export(device, card, steps, tmp)
        lockstep = _demo_lockstep(device, card, tmp)
        engine = _demo_engine(device, card, tmp)
    _gym_on_card(device, card)
    return ({"demo_export": export["launches"],
             "demo_lockstep": lockstep["launches"],
             "demo_engine": engine["launches"]},
            lockstep["replay_max_abs_err_vs_plain"])


# --- data-parallel phases ---------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawn(task, world, backend, **kwargs):
    """``task`` in ``world`` fresh processes on card 0, joined by
    ``backend``; returns what each rank returned.  A rank that fails fails
    the phase; all are stopped after RANK_TIMEOUT_S."""
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="q1_chip_ranks_") as tmp:
        init = f"tcp://localhost:{_free_port()}"
        ctx = mp.start_processes(_rank_main, args=(world, backend, init, task,
                                                   kwargs, tmp),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{task}: ranks still running after "
                                       f"{RANK_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        return [torch.load(Path(tmp) / f"rank{r}.pt", map_location="cpu",
                           weights_only=False) for r in range(world)]


def _rank_main(rank, world, backend, init, task, kwargs, outdir):
    import torch

    from q1physrl_torch.parallel import distributed

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(backend=backend, init_method=init,
                           world_size=world, rank=rank, timeout=300)
    distributed.time_collectives(True)
    try:
        out = RANK_TASKS[task](torch.device("cuda", 0), **kwargs)
    finally:
        distributed.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


def _params_tpu(ckpt_dir, **ppo_changes):
    from q1physrl_torch.algo.config import load_run_config

    run = load_run_config(str(PARAMS_YAML))
    return dataclasses.replace(
        run, ppo=dataclasses.replace(run.ppo, **ppo_changes),
        checkpoint_dir=str(ckpt_dir), auto_resume=False, max_iterations=1)


def _train_once(run, device):
    """The Trainer for ``run.max_iterations`` iterations, with the env
    kernel's launches counted from 0, the params after, whether they moved,
    and whether the checkpoint it wrote last restores.  Rank 0 writes the
    metrics to ``<checkpoint_dir>/logs/metrics.jsonl``."""
    import torch

    from q1physrl_torch.algo import checkpoint as ckpt
    from q1physrl_torch.algo.ppo import init_train_state
    from q1physrl_torch.algo.train import Trainer
    from q1physrl_torch.ops import env_rollout, sharded_rollout

    trainer = Trainer(run, device=device)
    before = {k: v.clone() for k, v in trainer.ts.policy.state_dict().items()}
    env_rollout.rollout_actions_autoreset.launches = 0
    sharded_rollout.sharded_rollout_actions_autoreset.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {
        "rollout_actions_autoreset":
            env_rollout.rollout_actions_autoreset.launches,
        "sharded_rollout_actions_autoreset":
            sharded_rollout.sharded_rollout_actions_autoreset.launches}
    after = {k: v.detach().cpu().clone()
             for k, v in trainer.ts.policy.state_dict().items()}
    restored = ckpt.restore_checkpoint(
        ckpt.latest_checkpoint(run.checkpoint_dir),
        init_train_state(1, trainer.env_cfg, run.ppo, device))
    return {"mode": trainer.mode, "seconds": seconds, "launches": launches,
            "params": after,
            "moved": any(not torch.equal(before[k].cpu(), v)
                         for k, v in after.items()),
            "restores": all(torch.equal(v, restored.policy.state_dict()[k]
                                        .cpu()) for k, v in after.items())}


def _metrics_record(ckpt_dir):
    lines = (Path(ckpt_dir) / "logs" / "metrics.jsonl").read_text()
    return json.loads(lines.splitlines()[-1])


def _learning_metrics(record):
    return {k: v for k, v in record.items() if k not in CLOCK_KEYS}


def _same_metrics(a, b):
    return set(a) == set(b) and all(
        a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])) for k in a)


def _check_training(name, result, record, counter, frames):
    """Sanity of a :func:`_train_once` result and one of its metrics
    records: one launch of the env kernel per frame (``frames`` counted by
    ``counter``), finite metrics, params moved, the checkpoint restores."""
    if result["launches"][counter] != frames:
        raise RuntimeError(f"{name}: expected {frames} launches of the env "
                           f"kernel, counted {result['launches']}")
    if not (np.isfinite(record["kl"]) and record["kl"] >= 0
            and np.isfinite(record["entropy"])
            and np.isfinite(record["vf_loss"])):
        raise RuntimeError(f"{name}: training metrics not sane: {record}")
    if not (result["moved"] and result["restores"]):
        raise RuntimeError(f"{name}: params did not move, or the checkpoint "
                           f"does not restore")


def _rank_nccl_w1(device, ckpt_root):
    """World size 1 on NCCL: the sharded functions against their kernels,
    and one global-mode iteration (compared in the parent)."""
    import torch

    from q1physrl_torch.algo.config import load_run_config
    from q1physrl_torch.ops import env_rollout as er
    from q1physrl_torch.ops import sharded_rollout as sr

    cfg = dataclasses.replace(load_run_config(str(RUN_YAML)).env,
                              zero_start_prob=0.3)
    n, t = PROBE_SHAPE
    state, ka, ya = rollout_inputs(cfg, n, t, 300, device)
    ru = _reset_uniforms(n, t, 300, device)
    pairs = {
        "sharded_rollout_actions": (sr.sharded_rollout_actions(cfg, state, ka,
                                                               ya),
                                    er.rollout_actions(cfg, state, ka, ya)),
        "sharded_rollout_actions in place": (
            _in_place(sr.sharded_rollout_actions, cfg, state, ka, ya),
            er.rollout_actions(cfg, state, ka, ya)),
        "sharded_rollout_actions_autoreset": (
            sr.sharded_rollout_actions_autoreset(cfg, state, ka, ya, ru),
            er.rollout_actions_autoreset(cfg, state, ka, ya, ru)),
        "sharded_rollout_actions_autoreset in place": (
            _in_place(sr.sharded_rollout_actions_autoreset, cfg, state, ka,
                      ya, ru),
            er.rollout_actions_autoreset(cfg, state, ka, ya, ru)),
        "sharded_rollout_random": (sr.sharded_rollout_random(cfg, state, t,
                                                             seed=9),
                                   er.rollout_random(cfg, state, t, seed=9)),
    }
    bitwise = {}
    for name, (got, want) in pairs.items():
        (s, r, d), (s0, r0, d0) = got, want
        leaves = [torch.equal(getattr(s, f), getattr(s0, f))
                  for f in ("yaw", "time_remaining", "zero_start",
                            "last_keys", "last_key_press_time")]
        leaves += [torch.equal(getattr(s.player, f), getattr(s0.player, f))
                   for f in ("z_pos", "vel_x", "vel_y", "vel_z", "on_ground",
                             "jump_released")]
        bitwise[name] = (all(leaves) and torch.equal(r, r0)
                         and torch.equal(d, d0))
    training = _train_once(_params_tpu(Path(ckpt_root) / "nccl_w1",
                                       num_sgd_iter=1), device)
    return {"bitwise": bitwise, "training": training}


def _alone(fn, device):
    """``fn()`` on each rank in turn, the others waiting, so that no other
    rank's work shares the card while it runs."""
    from q1physrl_torch.parallel import distributed

    out = None
    for r in range(distributed.world_size()):
        distributed.barrier(device)
        if distributed.rank() == r:
            out = fn()
    distributed.barrier(device)
    return out


def _allreduce_ms(x, reps):
    """Host milliseconds per all-reduce of ``x``, the card synchronized
    after each."""
    import torch

    from q1physrl_torch.parallel import distributed

    distributed.all_reduce_sum(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        distributed.all_reduce_sum(x)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _rank_sharded_kernels(run, device):
    """Each sharded function on this rank's envs, held against one launch on
    the whole batch at the probe shape and its main path's shape, then
    timed on its shard."""
    import torch

    from q1physrl_torch.models import Policy
    from q1physrl_torch.ops import env_rollout as er
    from q1physrl_torch.ops import sharded_rollout as sr
    from q1physrl_torch.parallel import distributed
    from q1physrl_torch.parallel.mesh import (env_shard, shard_env_axis,
                                              unshard_env_axis)

    cfg = dataclasses.replace(run.env, zero_start_prob=0.3)
    rank = distributed.rank()
    out = {}
    for name in ("sharded_rollout_actions",
                 "sharded_rollout_actions_autoreset"):
        autoreset = name.endswith("autoreset")
        checks = {}
        for shape, (n, t) in (("probe", PROBE_SHAPE),
                              ("main", SHARDED_SHAPES[name])):
            state, ka, ya = rollout_inputs(cfg, n, t, 200, device)
            ru = _reset_uniforms(n, t, 200, device)
            shard = env_shard(n)
            local = shard_env_axis(state, shard)
            lka, lya, lru = shard.take(ka), shard.take(ya), shard.take(ru)
            if autoreset:
                fn, inputs = sr.sharded_rollout_actions_autoreset, (lka, lya,
                                                                    lru)
                plain = lambda: er.rollout_actions_autoreset_plain(
                    cfg, local, *inputs)
                want = er.rollout_actions_autoreset(cfg, state, ka, ya, ru)
                dones = want[2]
            else:
                fn, inputs = sr.sharded_rollout_actions, (lka, lya)
                plain = lambda: er.rollout_actions_plain(cfg, local, *inputs)
                want = er.rollout_actions(cfg, state, ka, ya)
            sharded = lambda: fn(cfg, local, *inputs)
            in_place = lambda: _in_place(fn, cfg, local, *inputs)
            errs = {}
            # A new result, and the form the frame loops launch: the state
            # written over itself into given buffers.
            for form, launch in (("", sharded), (" in place", in_place)):
                s, r, d = launch()
                got = (unshard_env_axis(s, shard),
                       distributed.gather_env_axis(r, shard),
                       distributed.gather_env_axis(d, shard))
                errs[form] = _compare(f"{name} {shape}{form}", got, want)
            checks[shape] = {"n": n, "t": t, "max_abs_err": max(errs.values()),
                             "max_abs_err_in_place": errs[" in place"],
                             "dones": int(want[2].sum())}
        # Timed: the last pass's calls, at the main path's shape.
        bound = (_bound_autoreset(local, lka, lya, shard.take(dones))
                 if autoreset else _bound(local, lka, lya))
        timed = _alone(lambda: _timed(sharded, plain, 1000, 20), device)
        out[name] = {"checks": checks, "n_rank": shard.local, "t": t,
                     **timed, **bound}

    checks = {}
    for shape, (n, t) in (("probe", PROBE_SHAPE),
                          ("main", SHARDED_SHAPES["sharded_rollout_random"])):
        state, _, _ = rollout_inputs(cfg, n, 1, 201, device)
        shard = env_shard(n)
        local = shard_env_axis(state, shard)
        rank_seed = 3 + rank * sr.SEED_STRIDE
        s, r, d = sr.sharded_rollout_random(cfg, local, t, seed=3)
        want = er.rollout_random(cfg, local, t, seed=rank_seed)
        err = _compare_random(f"sharded_rollout_random {shape}", (s, r,
                                                                   want[2]),
                              want)
        checks[shape] = {"n": n, "t": t, "max_abs_err": err,
                         "done_count": int(d), "rank_done_count":
                         int(want[2])}
    # Timed at the main path's shape, the last pass's.
    sharded = lambda: sr.sharded_rollout_random(cfg, local, t, seed=3)
    kernel = lambda: er.rollout_random(cfg, local, t, seed=rank_seed)
    # The all-reduce couples the ranks: ms is timed on both at once.
    ms = _time_ms(sharded, 3)
    graph_ms = _alone(lambda: _graph_ms(kernel, 3), device)
    plain_ms = _alone(lambda: _time_ms(
        lambda: er.rollout_random_plain(cfg, local, t, seed=rank_seed), 1,
        warmup=0), device)
    out["sharded_rollout_random"] = {
        "checks": checks, "n_rank": shard.local, "t": t, "ms": ms,
        "graph_ms": graph_ms, "plain_ms": plain_ms,
        **_bound_random(local, t, want[2])}

    n_params = sum(p.numel() for p in Policy(run.env).parameters())
    out["allreduce_ms"] = {
        "done_count": _allreduce_ms(torch.zeros((), dtype=torch.int64,
                                                device=device),
                                    ALLREDUCE_REPS),
        "adam_step": _allreduce_ms(torch.zeros(n_params + WORLD * 8,
                                               device=device),
                                   ALLREDUCE_REPS),
        "adam_step_floats": n_params + WORLD * 8}
    return out


def _rank_loops(device):
    """The rank's scoring loop (512 episodes, sharded) and its rollout in
    global mode at params_tpu.yml, each graphed against the eager driver to
    the bit."""
    from q1physrl_torch import analyse
    from q1physrl_torch.models import Policy, import_policy_params
    from q1physrl_torch.parallel.mesh import env_shard

    run_env = _run4_env()
    policy = Policy(run_env, device=device)
    policy.load_state_dict(import_policy_params(str(CHECKPOINT)))
    shard = env_shard(512)
    run = lambda driver: analyse.zero_start_returns(
        policy, run_env, num_episodes=512, device=device, shard=shard,
        driver=driver)
    graphed, graphed_s = _seconds(lambda: run("graph"), device)
    eager, eager_s = _seconds(lambda: run("eager"), device)
    _same_returns("two-rank scoring", graphed, eager)
    from q1physrl_torch.algo.config import load_run_config

    num_envs = load_run_config(str(PARAMS_YAML)).ppo.num_envs
    rollout = _rollout_loops(device, PARAMS_YAML, env_shard(num_envs))
    return {"scoring": {"eager_s": eager_s, "graphed_s": graphed_s,
                        "graphed_equals_eager_bitwise": True},
            "rollout": rollout}


def _rank_gloo(device, ckpt_root):
    """The sharded kernels, then the main paths across the ranks."""
    from q1physrl_torch import bench
    from q1physrl_torch.algo import evaluate
    from q1physrl_torch.algo.config import load_run_config
    from q1physrl_torch.ops import sharded_rollout as sr
    from q1physrl_torch.parallel.mesh import env_shard

    out = {"kernels": _rank_sharded_kernels(load_run_config(str(RUN_YAML)),
                                            device)}

    sr.sharded_rollout_actions.launches = 0
    sto, det = evaluate.main([str(RUN_YAML), str(CHECKPOINT), "512",
                              "--device", str(device)])
    out["scoring"] = {"stochastic": sto, "deterministic": det,
                      "launches": sr.sharded_rollout_actions.launches}
    out["loops"] = _rank_loops(device)

    sr.sharded_rollout_random.launches = 0
    rate = bench.bench_env_kernel(**BENCH_ENV, device=device,
                                  shard=env_shard(BENCH_ENV["n"]))
    out["bench_env"] = {"env_steps_per_sec": rate,
                        "launches": sr.sharded_rollout_random.launches}

    root = Path(ckpt_root)
    out["one_epoch"] = _train_once(_params_tpu(root / "global_1epoch",
                                               num_sgd_iter=1), device)
    out["global"] = _train_once(_params_tpu(root / "global"), device)
    out["spmd"] = _train_once(dataclasses.replace(
        _params_tpu(root / "spmd"), use_shard_map=True), device)
    return out


RANK_TASKS = {"nccl_w1": _rank_nccl_w1, "gloo": _rank_gloo}


def _phase_data_parallel(device, scores, steps):
    """Phases 7-9: the reference iteration here, then NCCL at world size 1
    and two gloo ranks in fresh processes.  ``scores``: phase 4's
    (stochastic, deterministic) means; ``steps``: env steps per scoring
    episode.  Returns the kernels-line entries of the three sharded
    functions."""
    import torch

    from q1physrl_torch.ops.sharded_rollout import SEED_STRIDE

    with tempfile.TemporaryDirectory(prefix="q1_chip_dp_") as root:
        reference = _train_once(_params_tpu(Path(root) / "reference",
                                            num_sgd_iter=1), device)
        ref_record = _metrics_record(Path(root) / "reference")
        _emit({"phase": "reference", "config":
               str(PARAMS_YAML.relative_to(ROOT)), "num_sgd_iter": 1,
               "seconds": reference["seconds"],
               "launches": reference["launches"],
               "metrics": _learning_metrics(ref_record)})
        # One process's full iteration: what the two ranks' are timed
        # against.
        full = _train_once(_params_tpu(Path(root) / "reference_full"),
                           device)
        full_record = _metrics_record(Path(root) / "reference_full")
        _check_training("one process, full iteration", full, full_record,
                        "rollout_actions_autoreset", DP_FRAMES)
        _emit({"phase": "reference_full", "seconds": full["seconds"],
               "rollout_seconds": full_record["rollout_seconds"],
               "learn_seconds": full_record["learn_seconds"],
               "launches": full["launches"]})

        t0 = time.perf_counter()
        (w1,) = _spawn("nccl_w1", 1, "nccl", ckpt_root=root)
        w1_record = _metrics_record(Path(root) / "nccl_w1")
        same_params = all(torch.equal(v, reference["params"][k])
                          for k, v in w1["training"]["params"].items())
        same_metrics = _same_metrics(_learning_metrics(w1_record),
                                     _learning_metrics(ref_record))
        _emit({"phase": "nccl_w1", "seconds": time.perf_counter() - t0,
               "sharded_equals_kernel_bitwise": w1["bitwise"],
               "mode": w1["training"]["mode"],
               "launches": w1["training"]["launches"],
               "params_equal_one_process": same_params,
               "metrics_equal_one_process": same_metrics})
        if not all(w1["bitwise"].values()):
            raise AssertionError(f"NCCL world size 1: a sharded function "
                                 f"differs from its kernel: {w1['bitwise']}")
        if not (same_params and same_metrics
                and w1["training"]["mode"] == "global"):
            raise AssertionError("NCCL world size 1: the iteration differs "
                                 "from one process's")

        t0 = time.perf_counter()
        ranks = _spawn("gloo", WORLD, "gloo", ckpt_root=root)
        seconds = time.perf_counter() - t0
        records = {name: _metrics_record(Path(root) / sub) for name, sub in
                   (("one_epoch", "global_1epoch"), ("global", "global"),
                    ("spmd", "spmd"))}

    # The sharded kernels.
    kernels = [r["kernels"] for r in ranks]
    for name in SHARDED_SHAPES:
        for r, k in enumerate(kernels):
            _emit({"phase": "sharded_kernel", "kernel": name, "rank": r,
                   **k[name]})
    for shape in ("probe", "main"):
        checks = [k["sharded_rollout_random"]["checks"][shape]
                  for k in kernels]
        if any(c["done_count"] != sum(x["rank_done_count"] for x in checks)
               for c in checks):
            raise AssertionError(f"sharded_rollout_random {shape}: the "
                                 f"summed done count is not the ranks' "
                                 f"{checks}")
        if any(c["max_abs_err"] != 0.0 for c in checks):
            raise AssertionError(f"sharded_rollout_random {shape}: not "
                                 f"bitwise equal to rollout_random with seed "
                                 f"+ rank * {SEED_STRIDE}")
    _emit({"phase": "allreduce", "backend": "gloo", "world": WORLD,
           "per_rank": [k["allreduce_ms"] for k in kernels]})

    # The main paths across the ranks.
    for r in ranks:
        sto, det = r["scoring"]["stochastic"], r["scoring"]["deterministic"]
        if not (abs(sto["mean"] - STOCHASTIC_MEAN) <= STOCHASTIC_TOL
                and abs(det["mean"] - DETERMINISTIC) <= DETERMINISTIC_TOL):
            raise RuntimeError(f"two-rank scores out of range: {sto} {det}")
    _emit({"phase": "ranks_scoring", "world": WORLD,
           "stochastic": ranks[0]["scoring"]["stochastic"]["mean"],
           "deterministic": ranks[0]["scoring"]["deterministic"]["mean"],
           "one_process": scores,
           "equal_to_one_process": (
               ranks[0]["scoring"]["stochastic"]["mean"] == scores[0]
               and ranks[0]["scoring"]["deterministic"]["mean"] == scores[1]),
           "launches_per_rank": [r["scoring"]["launches"] for r in ranks]})
    _emit({"phase": "ranks_loops", "world": WORLD,
           "per_rank": [r["loops"] for r in ranks]})
    _emit({"phase": "ranks_bench_env", "world": WORLD, **BENCH_ENV,
           "env_steps_per_sec": ranks[0]["bench_env"]["env_steps_per_sec"],
           "launches_per_rank": [r["bench_env"]["launches"] for r in ranks]})
    for r in ranks:
        if r["scoring"]["launches"] != 2 * steps:
            raise RuntimeError(f"expected one sharded_rollout_actions launch "
                               f"per env step per rank ({2 * steps}), "
                               f"counted {r['scoring']['launches']}")
        if r["bench_env"]["launches"] != BENCH_ENV["reps"] + 1:
            raise RuntimeError(f"expected {BENCH_ENV['reps'] + 1} "
                               f"sharded_rollout_random launches per rank, "
                               f"counted {r['bench_env']['launches']}")

    for name in ("one_epoch", "global", "spmd"):
        for r in ranks:
            _check_training(f"{name} rank", r[name], records[name],
                            "sharded_rollout_actions_autoreset", DP_FRAMES)
        equal_params = all(torch.equal(v, ranks[1][name]["params"][k])
                           for k, v in ranks[0][name]["params"].items())
        rec = records[name]
        _emit({"phase": "ranks_training", "run": name, "world": WORLD,
               "mode": ranks[0][name]["mode"], "seconds":
               ranks[0][name]["seconds"],
               "rollout_seconds": rec["rollout_seconds"],
               "learn_seconds": rec["learn_seconds"],
               "collective_seconds": rec["collective_seconds"],
               "collectives": rec["collectives"],
               "launches_per_rank": [r[name]["launches"] for r in ranks],
               "params_equal_across_ranks": equal_params,
               "metrics": _learning_metrics(rec)})
        if not equal_params:
            raise AssertionError(f"{name}: params differ across ranks")
    got, want = (_learning_metrics(records["one_epoch"]),
                 _learning_metrics(ref_record))
    for k in want:
        if not (np.isnan(want[k]) and np.isnan(got[k])):
            np.testing.assert_allclose(got[k], want[k], rtol=DP_RTOL,
                                       atol=DP_ATOL, err_msg=f"two ranks, {k}")
    _emit({"phase": "ranks_vs_one_process", "rtol": DP_RTOL, "atol": DP_ATOL,
           "differences": {k: got[k] - want[k] for k in want},
           "seconds": seconds})

    def entry(name, line, launches):
        k = kernels[0][name]
        return {"name": name, "route": "cuda",
                "source": "q1physrl_torch/ops/sharded_rollout.py",
                "kernel_source": "q1physrl_torch/ops/csrc/env_rollout.cu",
                "collective": "all_reduce" if name.endswith("random")
                else "none",
                "replaces": f"q1physrl_tpu/ops/sharded_rollout.py:{line}",
                "launches": launches,
                "max_abs_err": max(kk[name]["checks"]["main"]["max_abs_err"]
                                   for kk in kernels),
                "max_abs_err_all_shapes": max(
                    c["max_abs_err"] for kk in kernels
                    for c in kk[name]["checks"].values()),
                "ms": max(kk[name]["ms"] for kk in kernels),
                "graph_ms": max(kk[name]["graph_ms"] for kk in kernels),
                "plain_ms": max(kk[name]["plain_ms"] for kk in kernels),
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": None, "world": WORLD, "n_rank": k["n_rank"],
                "t": k["t"], "allreduce_ms": (
                    kernels[0]["allreduce_ms"]["done_count"]
                    if name.endswith("random") else None)}

    return [entry("sharded_rollout_actions", 46, ranks[0]["scoring"]
                  ["launches"]),
            entry("sharded_rollout_actions_autoreset", 75,
                  ranks[0]["global"]["launches"]
                  ["sharded_rollout_actions_autoreset"]),
            entry("sharded_rollout_random", 98, ranks[0]["bench_env"]
                  ["launches"])]


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

    # 3. each kernel against its plain version, then timing; first how each
    # launches at its main path's shape: blocks resident per SM and waves
    run = load_run_config(str(RUN_YAML))
    shapes = {"rollout_actions": ACTIONS_SHAPES["scoring"][0],
              "rollout_actions_autoreset": AUTORESET_SHAPES["training"][0],
              "rollout_random": RANDOM_SHAPES["bench"][0]}
    _emit({"phase": "launch_shapes", "shapes": {
        name: {"n": n, **env_rollout.launch_shape(name, n,
                                                  run.env.num_keys)}
        for name, n in shapes.items()}})
    actions_t, actions_err = _phase_rollout_actions(run, device)
    autoreset_t, autoreset_err = _phase_autoreset(run, device)
    random_t, random_err = _phase_random(run, device)

    # 4. scoring through the evaluate CLI
    steps = int(np.ceil(run.env.time_limit / run.env.time_delta)) + 2
    rollout_actions.launches = 0
    captures = _captures()
    t0 = time.perf_counter()
    sto, det = evaluate.main([str(RUN_YAML), str(CHECKPOINT), "512",
                              "--device", str(device)])
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    actions_launches = rollout_actions.launches
    scoring_loops = _scoring_loops("scoring", CHECKPOINT, device, steps,
                                   score_s, _capture_seconds(captures))
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

    # 4a. the analysis path; 4b. round 5's winner through the evaluate CLI
    analysis_launches, analysis_err = _phase_analysis(run, device, steps)
    r5_launches = _phase_scoring_r5(device, steps)
    # 4c. the demo path (its finalize step runs in phase 5)
    demo_launches, demo_err = _phase_demo(device, card, steps)

    # 5. training through the Trainer; 5a. a population through the sweep
    training = _phase_training(device, card)
    sweep = _phase_sweep(device)

    # 6. the bench's env metric through its entry point
    rollout_random.launches = 0
    env_rate = bench.bench_env_kernel(**BENCH_ENV, device=device)
    random_launches = rollout_random.launches
    _emit({"phase": "bench_env", **BENCH_ENV, "launches": random_launches,
           "env_steps_per_sec": env_rate})
    if random_launches != BENCH_ENV["reps"] + 1:  # a warm-up, then the reps
        raise RuntimeError(f"expected {BENCH_ENV['reps'] + 1} rollout_random "
                           f"launches, counted {random_launches}")

    # 7-9. the data-parallel phases
    sharded_entries = _phase_data_parallel(device, (sto["mean"],
                                                    det["mean"]), steps)

    # the kernels line, then the result line
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

    by_path = {"scoring": actions_launches, "analysis": analysis_launches,
               "scoring_r5": r5_launches, **demo_launches,
               "finalize": training["finalize_launches"]}
    actions_entry = entry("rollout_actions", 177, sum(by_path.values()),
                          actions_t["scoring"],
                          max(actions_err, analysis_err, demo_err),
                          actions_t)
    actions_entry["launches_by_path"] = by_path
    # The frame that launches each kernel on its main path, replayed from
    # its CUDA graph: its time on the card and the capture's seconds.
    actions_entry.update(frame_ms=scoring_loops["frame_ms"],
                         capture_s=scoring_loops["capture_s"])
    autoreset_entry = entry("rollout_actions_autoreset", 248,
                            training["launches"], autoreset_t["training"],
                            autoreset_err, autoreset_t)
    autoreset_entry.update(
        frame_ms=training["rollout_loops"]["frame_ms"],
        capture_s=training["rollout_loops"]["capture_s"],
        launches_by_path={"training": training["launches"],
                          "sweep": sweep["launches"]},
        population_frame_ms=sweep["rollout"]["frame_ms"])
    _emit({"kernels": [
        actions_entry,
        autoreset_entry,
        entry("rollout_random", 343, random_launches, random_t["bench"],
              random_err, random_t),
        *sharded_entries,
    ]})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
