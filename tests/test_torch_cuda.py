"""The CUDA rollout kernels on the card: each held against its plain
version, their argument checks and launch counts, the kernels' Philox
against its plain version and curand's, scoring on the card against the
CPU, eval_sim and the counterfactual sweep on the card, a training
iteration on the card; and for data-parallel training, the generator's
bits in two processes and the sharded rollouts of two gloo ranks on one
card.

These tests need an NVIDIA card and nvcc; without them they skip (the
kernels have no CPU mode).  Run them on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from q1physrl_torch import analyse
from q1physrl_torch.algo import ppo
from q1physrl_torch.algo.config import PPOConfig, load_run_config
from q1physrl_torch.models import Policy, import_policy_params
from q1physrl_torch.ops import env_rollout

from _torch_common import run_ranks
from chip_smoke import (any_latches, probe_configs, replay_eval_sim,
                        rollout_inputs)

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
RUN4 = load_run_config(str(ROOT / "configs" / "run4.yml")).env
CHECKPOINT = str(ROOT / "data" / "checkpoints" / "tpu_pb" / "checkpoint")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(cfg, n, steps, seed, device):
    # Every env starts under 1 s from its limit: all episodes end inside
    # 100 frames (1.39 s).
    return rollout_inputs(cfg, n, steps, seed, device, near_end=1.0)


@pytest.mark.parametrize("n", [1, 1000])
@pytest.mark.parametrize("name", list(probe_configs(RUN4)))
def test_kernel_equals_plain_version(cuda, name, n):
    """The kernel runs the plain version's float32 operations in the same
    order, without fused multiply-adds: the results are bitwise equal.  N=1
    and N=1000 leave ragged blocks."""
    cfg = probe_configs(RUN4)[name]
    state, ka, ya = _case(cfg, n, 100, 0, cuda)
    got_state, got_r, got_d = env_rollout.rollout_actions(cfg, state, ka, ya)
    want_state, want_r, want_d = env_rollout.rollout_actions_plain(
        cfg, state, ka, ya)
    assert bool(want_d.any())
    assert torch.equal(got_r, want_r)
    assert torch.equal(got_d, want_d)
    for f in ("z_pos", "vel_x", "vel_y", "vel_z", "on_ground",
              "jump_released"):
        assert torch.equal(getattr(got_state.player, f),
                           getattr(want_state.player, f)), f
    for f in ("yaw", "time_remaining", "last_keys", "last_key_press_time",
              "zero_start"):
        assert torch.equal(getattr(got_state, f), getattr(want_state, f)), f


def _assert_states_equal(got, want):
    for f in ("z_pos", "vel_x", "vel_y", "vel_z", "on_ground",
              "jump_released"):
        assert torch.equal(getattr(got.player, f),
                           getattr(want.player, f)), f
    for f in ("yaw", "time_remaining", "last_keys", "last_key_press_time",
              "zero_start"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("n", [1, 1000])
@pytest.mark.parametrize("name", list(probe_configs(RUN4)))
def test_autoreset_kernel_equals_plain_version(cuda, name, n):
    """Every env ends inside the 100 frames and re-draws from the streamed
    uniforms (zero_start_prob 0.3, so both branches of the re-draw run):
    bitwise equal, as for rollout_actions."""
    cfg = dataclasses.replace(probe_configs(RUN4)[name], zero_start_prob=0.3)
    state, ka, ya = _case(cfg, n, 100, 3, cuda)
    ru = torch.tensor(np.random.default_rng(3).random((100, 5, n)),
                      dtype=torch.float32, device=cuda)
    got_state, got_r, got_d = env_rollout.rollout_actions_autoreset(
        cfg, state, ka, ya, ru)
    want_state, want_r, want_d = env_rollout.rollout_actions_autoreset_plain(
        cfg, state, ka, ya, ru)
    assert bool(want_d.any())
    assert torch.equal(got_r, want_r)
    assert torch.equal(got_d, want_d)
    _assert_states_equal(got_state, want_state)


@pytest.mark.parametrize("n", [1, 1000])
@pytest.mark.parametrize("name", list(probe_configs(RUN4)))
def test_random_kernel_equals_plain_version(cuda, name, n):
    """The kernel draws the plain version's Philox bits and runs its
    float32 operations: bitwise equal reward sums, done counts and
    states."""
    cfg = dataclasses.replace(probe_configs(RUN4)[name], zero_start_prob=0.3)
    state, _, _ = _case(cfg, n, 1, 4, cuda)
    got_state, got_r, got_d = env_rollout.rollout_random(cfg, state, 100,
                                                         seed=17)
    want_state, want_r, want_d = env_rollout.rollout_random_plain(
        cfg, state, 100, seed=17)
    assert int(want_d) > 0
    assert torch.equal(got_r, want_r)
    assert int(got_d) == int(want_d)
    _assert_states_equal(got_state, want_state)


@pytest.mark.parametrize("steps", [1, 2, 7, 101])
@pytest.mark.parametrize("name", ["run4", "allow_yaw=False", "hover=True"])
def test_random_kernel_equals_plain_version_at_odd_t(cuda, name, steps):
    """T that ends inside a Philox call's frames (1, 2, 7 and 101 are not
    multiples of FRAMES_PER_DRAW; 7 and 101 are odd): bitwise equal, the
    episodes ending in the first frames."""
    cfg = dataclasses.replace(probe_configs(RUN4)[name], zero_start_prob=0.3)
    state, _, _ = _case(cfg, 1000, 1, 6, cuda)
    state.time_remaining = state.time_remaining * 0.02
    got_state, got_r, got_d = env_rollout.rollout_random(cfg, state, steps,
                                                         seed=23)
    want_state, want_r, want_d = env_rollout.rollout_random_plain(
        cfg, state, steps, seed=23)
    assert int(want_d) > 0
    assert torch.equal(got_r, want_r)
    assert int(got_d) == int(want_d)
    _assert_states_equal(got_state, want_state)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("smooth_keys", [True, False])
@pytest.mark.parametrize("kernel", ["rollout_actions",
                                    "rollout_actions_autoreset",
                                    "rollout_random"])
def test_kernels_follow_plain_versions_on_any_key_latch(cuda, kernel,
                                                        smooth_keys, steps):
    """A hand-made state's key latches may hold any int32 (here -5 to 7):
    each kernel takes such an env's first frame by the plain version's
    operations, and stays bitwise equal to it."""
    cfg = dataclasses.replace(RUN4, smooth_keys=smooth_keys,
                              zero_start_prob=0.3)
    state, ka, ya = _case(cfg, 1000, steps, 8, cuda)
    state = any_latches(state, 8)
    if kernel == "rollout_random":
        got = env_rollout.rollout_random(cfg, state, steps, seed=29)
        want = env_rollout.rollout_random_plain(cfg, state, steps, seed=29)
    else:
        args = (cfg, state, ka, ya)
        if kernel == "rollout_actions_autoreset":
            args += (torch.rand((steps, 5, 1000), device=cuda),)
        got = getattr(env_rollout, kernel)(*args)
        want = getattr(env_rollout, kernel + "_plain")(*args)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    _assert_states_equal(got[0], want[0])


def test_launch_shape(cuda):
    for kernel in ("rollout_actions", "rollout_actions_autoreset",
                   "rollout_random"):
        shape = env_rollout.launch_shape(kernel, 1 << 20)
        assert shape["blocks"] * shape["threads_per_block"] == 1 << 20
        assert shape["blocks_per_sm"] >= 1 and shape["waves"] > 0


def test_philox_matches_plain_version_and_curand(cuda):
    rng = np.random.default_rng(5)
    counters = torch.tensor(rng.integers(0, 1 << 32, (4, 5000)),
                            dtype=torch.int64, device=cuda)
    key = (0x12345678, 0x9ABCDEF0)
    want = torch.stack(env_rollout.philox4x32_10(*counters, *key))
    assert torch.equal(env_rollout.philox_on_card(counters, key), want)
    assert torch.equal(env_rollout.philox_on_card(counters, key,
                                                  curand=True), want)


def test_training_iteration_on_card(cuda):
    """A small iteration on the card: one launch of the auto-reset kernel
    per frame, finite metrics, params moved."""
    cfg = dataclasses.replace(RUN4, num_envs=None)
    ppo_cfg = PPOConfig(num_envs=256, rollout_length=8, num_sgd_iter=2,
                        sgd_minibatch_size=256)
    ts = ppo.init_train_state(0, cfg, ppo_cfg, cuda)
    before = ts.policy.pi.layers[0].weight.clone()
    launches = env_rollout.rollout_actions_autoreset.launches
    ts, metrics = ppo.train_iter(cfg, ppo_cfg, ts)
    assert env_rollout.rollout_actions_autoreset.launches == launches + 8
    assert all(np.isfinite(float(metrics[k]))
               for k in ("kl", "entropy", "vf_loss"))
    assert not torch.equal(before, ts.policy.pi.layers[0].weight)


def test_one_launch_per_call(cuda):
    state, ka, ya = _case(RUN4, 300, 7, 1, cuda)
    before = env_rollout.rollout_actions.launches
    env_rollout.rollout_actions(RUN4, state, ka, ya)
    env_rollout.rollout_actions(RUN4, state, ka[:1], ya[:1])
    assert env_rollout.rollout_actions.launches == before + 2
    ru = torch.rand((7, 5, 300), device=cuda)
    before = env_rollout.rollout_actions_autoreset.launches
    env_rollout.rollout_actions_autoreset(RUN4, state, ka, ya, ru)
    assert env_rollout.rollout_actions_autoreset.launches == before + 1
    before = env_rollout.rollout_random.launches
    env_rollout.rollout_random(RUN4, state, 3)
    assert env_rollout.rollout_random.launches == before + 1


def test_wrapper_rejects_bad_cuda_arguments(cuda):
    state, ka, ya = _case(RUN4, 64, 2, 2, cuda)
    with pytest.raises(ValueError):
        env_rollout.rollout_actions(RUN4, state, ka, ya.double())
    with pytest.raises(ValueError):  # actions on the CPU, state on the card
        env_rollout.rollout_actions(RUN4, state, ka.cpu(), ya.cpu())
    with pytest.raises(ValueError):  # reset uniforms on the CPU
        env_rollout.rollout_actions_autoreset(
            RUN4, state, ka, ya, torch.rand((2, 5, 64)))
    with pytest.raises(ValueError):  # float64 state
        env_rollout.rollout_random(
            RUN4, dataclasses.replace(state, yaw=state.yaw.double()), 2)


def test_deterministic_score_on_card_matches_cpu(cuda):
    """The same trajectory on the card and the CPU; 10 points per episode
    as in test_torch_eval (the policy's products sum in another order)."""
    scores = {}
    for device in ("cpu", "cuda"):
        policy = Policy(RUN4, device=device)
        policy.load_state_dict(import_policy_params(CHECKPOINT))
        scores[device] = analyse.eval_zero_start(
            policy, RUN4, num_episodes=2, deterministic=True,
            device=device)["mean"]
    assert abs(scores["cuda"] - scores["cpu"]) <= 10.0, scores


def _tpu_pb_policy(device):
    policy = Policy(RUN4, device=device)
    policy.load_state_dict(import_policy_params(CHECKPOINT))
    return policy


def test_eval_sim_on_card_launches_once_per_frame(cuda):
    """eval_sim launches kernel #1 once per frame, and the decoded yaw it
    records equals, to the bit, the yaw the kernel writes when the recorded
    actions are replayed through it (the replay meets the recorded states
    and rewards to the bit, and each of its launches equals the plain
    version's to the bit)."""
    before = env_rollout.rollout_actions.launches
    result = analyse.eval_sim(_tpu_pb_policy(cuda), RUN4, deterministic=True,
                              max_steps=60, device=cuda)
    assert env_rollout.rollout_actions.launches == before + 60
    assert len(result.reward) == 60 and result.device == str(cuda)
    kernel_yaw, replayed, err = replay_eval_sim(RUN4, result, 0, cuda)
    assert replayed and err == 0.0
    np.testing.assert_array_equal(kernel_yaw, result.yaw)


def test_hypothetical_delta_speeds_card_matches_cpu(cuda):
    """The sweep on the card against the CPU's on one trajectory, at
    chip_smoke.SWEEP_ATOL (an ulp or two of sin/cos and hypot between the
    libraries, on speeds near 300-700 ups)."""
    from chip_smoke import SWEEP_ATOL

    result = analyse.eval_sim(_tpu_pb_policy(cuda), RUN4, deterministic=True,
                              max_steps=200, device=cuda)
    card = result.hypothetical_delta_speeds()
    cpu = dataclasses.replace(result,
                              device="cpu").hypothetical_delta_speeds()
    assert card.shape == cpu.shape == (360, 200)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=SWEEP_ATOL)


def test_two_processes_draw_the_same_bits_on_one_card(cuda, tmp_path):
    """Data-parallel training draws every random tensor for the whole batch
    on every rank: two processes seeding the card's generator alike must
    draw the same bits."""
    a, b = run_ranks("draws", tmp_path, {"seed": 1234, "n": 100003},
                     device="cuda:0")
    for k in ("rand", "randn", "perm"):
        assert torch.equal(a[k], b[k]), k


def test_two_gloo_ranks_sharded_rollouts_equal_single_launch(cuda, tmp_path):
    """Two gloo ranks on one card, each launching the kernels on its half of
    the envs: the halves joined equal one launch on the whole batch, and
    sharded_rollout_random equals the plain version with the rank's seed,
    to the bit."""
    from q1physrl_torch.ops import sharded_rollout

    cfg = dataclasses.replace(RUN4, zero_start_prob=0.3)
    state, ka, ya = _case(cfg, 512, 100, 5, cuda)
    ru = torch.rand((100, 5, 512), device=cuda)
    p = state.player
    inputs = {k: (getattr(p, k) if hasattr(p, k) else getattr(state, k)).cpu()
              for k in ("z_pos", "vel_x", "vel_y", "vel_z", "on_ground",
                        "jump_released", "yaw", "time_remaining",
                        "zero_start", "last_keys", "last_key_press_time")}
    inputs.update(ka=ka.cpu(), ya=ya.cpu(), ru=ru.cpu())
    ranks = run_ranks("rollouts", tmp_path,
                      {"cfg": dataclasses.asdict(cfg),
                       "reset_cfg": dataclasses.asdict(cfg), "seed": 11,
                       "t_random": 100}, inputs, device="cuda:0")
    wants = {"actions": env_rollout.rollout_actions(cfg, state, ka, ya),
             "autoreset": env_rollout.rollout_actions_autoreset(
                 cfg, state, ka, ya, ru)}
    for key, (want_state, want_r, want_d) in wants.items():
        assert bool(want_d.any()), key
        assert torch.equal(torch.cat([r[key][1] for r in ranks], -1),
                           want_r.cpu()), key
        assert torch.equal(torch.cat([r[key][2] for r in ranks], -1),
                           want_d.cpu()), key
        for f, want in ((f, getattr(want_state.player, f)
                         if hasattr(want_state.player, f)
                         else getattr(want_state, f))
                        for f in inputs if f not in ("ka", "ya", "ru")):
            got = torch.cat([r[key][0][f] for r in ranks], -1)
            assert torch.equal(got, want.cpu()), (key, f)
    total = sum(int(r["random_plain"][2]) for r in ranks)
    for r in ranks:
        assert torch.equal(r["random"][1], r["random_plain"][1])
        assert int(r["random"][2]) == total > 0
        assert all(v == 1 for v in r["launches"].values()), r["launches"]
    assert sharded_rollout.SEED_STRIDE == 100003
