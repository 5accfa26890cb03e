"""The CUDA rollout kernels on the card: each held against its plain
version, their argument checks and launch counts, the kernels' Philox
against its plain version and curand's, scoring on the card against the
CPU, eval_sim and the counterfactual sweep on the card, a training
iteration on the card; for data-parallel training, the generator's bits
in two processes and the sharded rollouts of two gloo ranks on one card;
the scoring, eval_sim and PPO-rollout loops replayed from CUDA graphs
against their eager drivers; a population's env launch, graphed
rollout and iterations; and the lockstep demo bridge and its oracle
server on the card.

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


@pytest.mark.parametrize("n,autoreset", [(1, False), (512, False),
                                          (8192, True), (1000, True)])
def test_kernels_write_the_state_over_itself(cuda, n, autoreset):
    """The form the frame loops launch (``out=``, the state its own output,
    rewards and dones into given buffers) at the main paths' shapes:
    bitwise equal to the plain version, over frames where episodes end."""
    cfg = dataclasses.replace(RUN4, zero_start_prob=0.3)
    state, ka, ya = _case(cfg, n, 100, 9, cuda)
    inputs = (ka, ya)
    if autoreset:
        inputs += (torch.rand((100, 5, n), device=cuda),)
    name = "rollout_actions" + ("_autoreset" if autoreset else "")
    want = getattr(env_rollout, name + "_plain")(cfg, state, *inputs)
    mine = state.clone()
    out = (mine, torch.empty((100, n), device=cuda),
           torch.empty((100, n), dtype=torch.bool, device=cuda))
    assert getattr(env_rollout, name)(cfg, mine, *inputs, out=out) is out
    assert bool(want[2].any())
    assert torch.equal(out[1], want[1]) and torch.equal(out[2], want[2])
    _assert_states_equal(mine, want[0])


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


# --- the loops captured as CUDA graphs ----------------------------------------

R5_CHECKPOINT = str(ROOT / "data" / "checkpoints" / "repl_r5"
                    / "best_member_02_rllib" / "checkpoint")


def _launches():
    from q1physrl_torch.ops import sharded_rollout

    return {f.__name__: f.launches for f in (
        env_rollout.rollout_actions, env_rollout.rollout_actions_autoreset,
        sharded_rollout.sharded_rollout_actions,
        sharded_rollout.sharded_rollout_actions_autoreset)}


def _rose(before, **expected):
    after = _launches()
    return {k: after[k] - before[k] for k in after} == {
        k: expected.get(k, 0) for k in after}


@pytest.mark.parametrize("deterministic", [False, True])
def test_graphed_zero_start_equals_eager(cuda, deterministic):
    """The scoring loop replayed from its CUDA graph gives the eager
    driver's returns to the bit, and one launch per env step."""
    policy = _tpu_pb_policy(cuda)
    n = 2 if deterministic else 96
    steps = analyse._episode_steps(RUN4)
    eager = analyse.zero_start_returns(policy, RUN4, num_episodes=n,
                                       deterministic=deterministic, seed=3,
                                       device=cuda, driver="eager")
    for _ in range(2):  # the capture's run, then a replay of every frame
        before = _launches()
        graphed = analyse.zero_start_returns(policy, RUN4, num_episodes=n,
                                             deterministic=deterministic,
                                             seed=3, device=cuda)
        assert _rose(before, rollout_actions=steps)
        np.testing.assert_array_equal(graphed, eager)


def test_two_checkpoints_reuse_one_capture(cuda):
    """Scoring two checkpoints copies each one's weights into one captured
    loop, and each gets its own eager bits."""
    from q1physrl_torch.utils import cuda_graph

    policies = [_tpu_pb_policy(cuda), Policy(RUN4, device=cuda)]
    policies[1].load_state_dict(import_policy_params(R5_CHECKPOINT))
    captures = cuda_graph.counters["captures"]
    for policy in policies + policies:
        eager = analyse.zero_start_returns(policy, RUN4, num_episodes=40,
                                           device=cuda, driver="eager")
        graphed = analyse.zero_start_returns(policy, RUN4, num_episodes=40,
                                             device=cuda)
        np.testing.assert_array_equal(graphed, eager)
    assert cuda_graph.counters["captures"] == captures + 1


def test_graphed_eval_sim_equals_eager(cuda):
    policy = _tpu_pb_policy(cuda)
    eager = analyse.eval_sim(policy, RUN4, max_steps=101, seed=5,
                             device=cuda, driver="eager")
    before = _launches()
    graphed = analyse.eval_sim(policy, RUN4, max_steps=101, seed=5,
                               device=cuda)
    assert _rose(before, rollout_actions=101)
    for f in dataclasses.fields(eager):
        a, b = getattr(graphed, f.name), getattr(eager, f.name)
        if f.name == "player_state":
            for g in dataclasses.fields(a):
                np.testing.assert_array_equal(getattr(a, g.name),
                                              getattr(b, g.name))
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("sharded", [False, True])
def test_graphed_rollout_equals_eager(cuda, sharded):
    """The PPO rollout replayed from its CUDA graph: trajectory, final
    state, episode statistics, bootstrap value and the generator's state
    equal the eager driver's to the bit; one launch per frame.  The shard
    draws for the whole batch and keeps its half."""
    from q1physrl_torch.parallel.mesh import EnvShard, shard_env_axis

    cfg = dataclasses.replace(RUN4, num_envs=None, zero_start_prob=0.3)
    ppo_cfg = PPOConfig(num_envs=512, rollout_length=9, num_sgd_iter=1,
                        sgd_minibatch_size=512)
    shard = EnvShard(1, 2, 512) if sharded else None
    outs = {}
    for driver in ("eager", "graph"):
        ts = ppo.init_train_state(7, cfg, ppo_cfg, cuda)
        state, stats = ts.env_state, ts.stats
        if sharded:
            state, stats = (shard_env_axis(state, shard),
                            shard_env_axis(stats, shard))
        state.time_remaining = state.time_remaining * 0.05
        before = _launches()
        out = ppo.rollout(cfg, ppo_cfg, ts.policy, state, stats,
                          ts.generator, shard, driver=driver)
        assert _rose(before, rollout_actions_autoreset=9)
        outs[driver] = out + (ts.generator.get_state(),)
    (s0, st0, tr0, b0, g0), (s1, st1, tr1, b1, g1) = (outs["eager"],
                                                       outs["graph"])
    assert bool(tr0.done.any())
    _assert_states_equal(s1, s0)
    for f in dataclasses.fields(st0):
        assert torch.equal(getattr(st1, f.name), getattr(st0, f.name)), f
    for k in tr0._fields:
        assert torch.equal(getattr(tr1, k), getattr(tr0, k)), k
    assert torch.equal(b1, b0) and torch.equal(g1, g0)


def test_trainer_recaptures_when_the_parameters_move(cuda, tmp_path):
    """The Trainer keeps its captured rollout across iterations, and builds
    a new one when a parameter's address changes."""
    from q1physrl_torch.algo.config import RunConfig
    from q1physrl_torch.algo.train import Trainer
    from q1physrl_torch.utils import cuda_graph

    run = RunConfig(ppo=PPOConfig(num_envs=256, rollout_length=8,
                                  num_sgd_iter=1, sgd_minibatch_size=256),
                    max_iterations=3, checkpoint_dir=str(tmp_path))
    trainer = Trainer(run, device=cuda)
    captures = cuda_graph.counters["captures"]
    before = _launches()
    trainer.step()
    trainer.step()
    assert cuda_graph.counters["captures"] == captures + 1
    assert _rose(before, rollout_actions_autoreset=16)
    layer = trainer.ts.policy.pi.layers[0]
    layer.weight = torch.nn.Parameter(layer.weight.detach().clone())
    trainer.step()
    assert cuda_graph.counters["captures"] == captures + 2


def test_train_iter_reuses_one_capture(cuda):
    """ppo.train_iter, the bench's iteration, replays the rollout it
    captured in its first call: one capture for three iterations, one
    launch per frame."""
    from q1physrl_torch.utils import cuda_graph

    cfg = dataclasses.replace(RUN4, num_envs=None)
    ppo_cfg = PPOConfig(num_envs=256, rollout_length=8, num_sgd_iter=1,
                        sgd_minibatch_size=256)
    ts = ppo.init_train_state(0, cfg, ppo_cfg, cuda)
    captures = cuda_graph.counters["captures"]
    before = _launches()
    for _ in range(3):
        ts, metrics = ppo.train_iter(cfg, ppo_cfg, ts)
    assert cuda_graph.counters["captures"] == captures + 1
    assert _rose(before, rollout_actions_autoreset=24)
    assert np.isfinite(float(metrics["kl"]))


def test_graphed_rollout_replays_after_a_reseed(cuda):
    """A kept rollout loop whose generator is reseeded between rollouts,
    as spmd reseeds its rank generator each iteration, replays what the
    eager driver draws from that seed, to the bit."""
    from q1physrl_torch.parallel import spmd

    cfg = dataclasses.replace(RUN4, num_envs=None, zero_start_prob=0.3)
    ppo_cfg = PPOConfig(num_envs=512, rollout_length=6, num_sgd_iter=1,
                        sgd_minibatch_size=512)
    runs = {}
    for driver in ("graph", "eager"):
        ts = ppo.init_train_state(3, cfg, ppo_cfg, cuda)
        state, stats = ts.env_state, ts.stats
        outs = []
        for _ in range(3):
            generator = spmd.rank_generator(ts.generator, rank=1)
            state, stats, traj, boot = ppo.rollout(
                cfg, ppo_cfg, ts.policy, state, stats, generator,
                driver=driver)
            outs.append((traj, boot))
        runs[driver] = (state, outs)
    (s1, graphed), (s0, eager) = runs["graph"], runs["eager"]
    _assert_states_equal(s1, s0)
    for (tr1, b1), (tr0, b0) in zip(graphed, eager):
        for k in tr0._fields:
            assert torch.equal(getattr(tr1, k), getattr(tr0, k)), k
        assert torch.equal(b1, b0)
    assert not torch.equal(graphed[0][0].obs, graphed[1][0].obs)


def test_a_failed_capture_raises(cuda):
    """A frame that syncs with the host cannot be captured: the capture
    raises, and nothing falls back to the eager loop."""
    from q1physrl_torch.utils.cuda_graph import FrameGraph

    x = torch.zeros(4, device=cuda)

    def frame():
        x.add_(1.0)
        if float(x.sum()) > 1e9:  # a host sync
            x.zero_()

    graph = FrameGraph(frame, cuda)
    with pytest.raises(RuntimeError):
        graph.run(3)
    assert graph.graph is None


# --- a population (algo/population.py) ---------------------------------------


@pytest.mark.parametrize("in_place", [False, True])
def test_autoreset_at_the_population_shape(cuda, in_place):
    """rollout_actions_autoreset at the population shape of
    configs/sweep_r5_repl2.yml (4 members x 400 envs, T=1), plain and
    ``out=`` forms: equal to the plain version and to each member's own
    launch on its 400 envs, to the bit, over frames where episodes end."""
    from q1physrl_torch.parallel.mesh import EnvShard, shard_env_axis

    cfg = dataclasses.replace(RUN4, zero_start_prob=0.3)
    members, n, steps = 4, 400, 100
    state, ka, ya = _case(cfg, members * n, steps, 11, cuda)
    ru = torch.rand((steps, 5, members * n), device=cuda)
    want = env_rollout.rollout_actions_autoreset_plain(cfg, state, ka, ya,
                                                       ru)
    if in_place:
        got = (state.clone(), torch.empty((steps, members * n), device=cuda),
               torch.empty((steps, members * n), dtype=torch.bool,
                           device=cuda))
        env_rollout.rollout_actions_autoreset(cfg, got[0], ka, ya, ru,
                                              out=got)
    else:
        got = env_rollout.rollout_actions_autoreset(cfg, state, ka, ya, ru)
    assert bool(want[2].any())
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    _assert_states_equal(got[0], want[0])
    for i in range(members):
        shard = EnvShard(i, members, members * n)
        part = env_rollout.rollout_actions_autoreset(
            cfg, shard_env_axis(state, shard), shard.take(ka),
            shard.take(ya), shard.take(ru))
        assert torch.equal(part[1], shard.take(got[1]))
        assert torch.equal(part[2], shard.take(got[2]))
        _assert_states_equal(part[0], shard_env_axis(got[0], shard))


def test_graphed_population_rollout_equals_eager(cuda):
    """A population's rollout replayed from its CUDA graph: trajectory,
    final state, per-member statistics, bootstrap value and every member's
    generator equal the eager driver's to the bit; one launch on all the
    members' envs per frame."""
    from q1physrl_torch.algo import population

    cfg = dataclasses.replace(RUN4, num_envs=None, zero_start_prob=0.3)
    ppo_cfg = PPOConfig(num_envs=256, rollout_length=9, num_sgd_iter=1,
                        sgd_minibatch_size=256)
    outs = {}
    for driver in ("eager", "graph"):
        ps = population.init_population((5, 6, 7), cfg, ppo_cfg, cuda)
        ps.env_state.time_remaining = ps.env_state.time_remaining * 0.05
        before = _launches()
        out = population.rollout(cfg, ppo_cfg, ps.policy, ps.env_state,
                                 ps.stats, ps.generators, driver=driver)
        assert _rose(before, rollout_actions_autoreset=9)
        outs[driver] = out + ([g.get_state() for g in ps.generators],)
    (s0, st0, tr0, b0, g0), (s1, st1, tr1, b1, g1) = (outs["eager"],
                                                       outs["graph"])
    assert bool(tr0.done.any()) and st0.finished.shape == (3,)
    _assert_states_equal(s1, s0)
    for f in dataclasses.fields(st0):
        assert torch.equal(getattr(st1, f.name), getattr(st0, f.name)), f
    for k in tr0._fields:
        assert torch.equal(getattr(tr1, k), getattr(tr0, k)), k
    assert torch.equal(b1, b0)
    assert all(torch.equal(x, y) for x, y in zip(g1, g0))


def test_population_iteration_on_card(cuda, tmp_path):
    """Two population iterations through the sweep's trainer on the card:
    finite metrics, params moved, the stacked checkpoint restores."""
    from q1physrl_torch.algo import checkpoint as ckpt
    from q1physrl_torch.algo import population
    from q1physrl_torch.algo.config import RunConfig
    from q1physrl_torch.algo.sweep import MemberSpec, PopulationTrainer

    run = RunConfig(env=dataclasses.replace(RUN4, num_envs=None),
                    ppo=PPOConfig(num_envs=64, rollout_length=16,
                                  num_sgd_iter=2, sgd_minibatch_size=256))
    members = [MemberSpec(seed=1), MemberSpec(seed=2, lr=((0, 1e-4),))]
    pt = PopulationTrainer(run, members, str(tmp_path), device=cuda)
    start = pt.ps.policy.flat.clone()
    pt.train(max_env_steps=2 * run.ppo.batch_size)
    assert pt.ps.iteration == [2, 2]
    assert all(not torch.equal(pt.ps.policy.flat[i], start[i])
               for i in range(2))
    fresh = population.init_population((1, 2), run.env, run.ppo, cuda)
    back = ckpt.restore_population(
        ckpt.latest_checkpoint(str(tmp_path / "stacked")), fresh)
    assert torch.equal(back.policy.flat, pt.ps.policy.flat)


def test_lockstep_demo_on_card(cuda, tmp_path):
    """Round 5's winner over the lockstep bridge with the policy, the
    decoder and the oracle server on the card: one kernel launch per
    policy frame, each replayed launch bitwise equal to the plain version,
    the yaw sent equal to the kernel's, the frames and corrected finish
    within 2 frames of the JAX package's CPU run (chip_smoke's
    constants)."""
    import asyncio

    from chip_smoke import (DEMO_FINISH_TOL, DEMO_LOCKSTEP_FINISH,
                            DEMO_LOCKSTEP_FRAMES)
    from q1physrl_torch import mkdemo

    r5 = ROOT / "data" / "checkpoints" / "repl_r5" / "best_member_02_rllib"
    record = []
    before = env_rollout.rollout_actions.launches
    times, _, _, finish = asyncio.run(mkdemo.make_demo_lockstep(
        str(r5), str(ROOT / "configs" / "run4.yml"), str(tmp_path / "r5.dem"),
        device=cuda, record=record))
    assert env_rollout.rollout_actions.launches - before == len(record) \
        == len(times) - 1
    cfg = dataclasses.replace(RUN4, num_envs=None)
    for frame in record:
        args = (cfg, frame["state"], frame["key_actions"].unsqueeze(0),
                frame["yaw_action"].unsqueeze(0))
        got = env_rollout.rollout_actions(*args)
        want = env_rollout.rollout_actions_plain(*args)
        _assert_states_equal(got[0], want[0])
        assert torch.equal(got[0].yaw, frame["kernel_yaw"])
        assert frame["sent"][0] == float(frame["kernel_yaw"][0])
    assert abs(len(times) - DEMO_LOCKSTEP_FRAMES) <= 2
    corrected = finish + mkdemo.DEMO_TIME_CORRECTION - times[0]
    assert abs(corrected - DEMO_LOCKSTEP_FINISH) <= DEMO_FINISH_TOL


def test_lockstep_server_physics_on_card(cuda):
    """The oracle server's frame on the card against the CPU's: the same
    move from the same state, within the rollout tolerances."""
    from q1physrl_torch.utils.lockstep_server import LockstepServer

    rng = np.random.default_rng(0)
    for _ in range(50):
        move = {"yaw": float(rng.integers(0, 256)) * 360 / 256,
                "forward": int(rng.integers(-800, 801)),
                "side": int(rng.integers(-1060, 1061)),
                "buttons": int(rng.integers(0, 4))}
        vel = np.array([*rng.uniform(-700, 700, 2), -12.0])
        servers = [LockstepServer(device=d) for d in (cuda, "cpu")]
        for s in servers:
            s.vel = vel.copy()
        got, want = (s._apply(move) for s in servers)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
