"""The port's analysis path against the JAX package: eval_sim along a
scripted and a trained trajectory, the counterfactual sweep in both
dtypes, the key overlay's pixels, demo parsing, the plots (the wish-angle
plot, the per-checkpoint CLI, the trainer's periodic plot), the orbax
export of round 5's winner and its scores, and the evaluate CLI on
directories.

Kernel #1 itself is held against its plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py; here its wrapper runs the plain
version on CPU tensors.
"""

import dataclasses
import importlib.util
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q1physrl_torch import analyse as tanalyse
from q1physrl_torch import phys as tphys
from q1physrl_torch.algo import evaluate as tevaluate
from q1physrl_torch.algo.config import PPOConfig as TPPOConfig
from q1physrl_torch.algo.config import RunConfig as TRunConfig
from q1physrl_torch.algo.config import load_run_config as tload
from q1physrl_torch.algo.train import Trainer
from q1physrl_torch.env import Config as TConfig
from q1physrl_torch.env import Key as TKey
from q1physrl_torch.env import Obs as TObs
from q1physrl_torch.models import Policy, import_policy_params
from q1physrl_torch.ops import env_rollout
from q1physrl_tpu import analyse as janalyse
from q1physrl_tpu import env as jenv
from q1physrl_tpu import models as jmodels
from q1physrl_tpu.algo.train import load_run_config as jload

from _torch_common import PLAYER_FIELDS
from chip_smoke import R5_DETERMINISTIC, R5_DETERMINISTIC_TOL

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN4 = str(ROOT / "configs" / "run4.yml")
CHECKPOINTS = ROOT / "data" / "checkpoints"
TPU_PB = str(CHECKPOINTS / "tpu_pb" / "checkpoint")
R5_ORBAX = CHECKPOINTS / "repl_r5" / "best_member_02"
R5_RLLIB = CHECKPOINTS / "repl_r5" / "best_member_02_rllib"
SMOKE_PPO = dict(num_envs=64, rollout_length=16, num_sgd_iter=2,
                 sgd_minibatch_size=256)

# tests/test_analyse.py's config: time_delta 1/72, the defaults otherwise.
PARAMS_CFG = dict(
    action_range=10.0, allow_jump=True, allow_yaw=True, auto_jump=False,
    discrete_yaw_steps=-1, fmove_max=800.0, smove_max=1060.0, hover=False,
    initial_yaw_range=(0.0, 360.0), key_press_delay=0.3,
    max_initial_speed=700.0, smooth_keys=True, speed_reward=False,
    time_delta=0.013888888888888, time_limit=10.0, zero_start_prob=1.0)


def _jax_scripted(num_keys):
    """tests/test_analyse.py:45-53: forward while the normalized time left
    is above 0.8, then strafe left with mouse -2 (float32 yaw, as the
    port's kernel takes)."""

    def fn(obs, rng):
        n = obs.shape[0]
        fwd = (obs[:, jenv.Obs.TIME_LEFT] > 0.8).astype(jnp.int32)
        keys = jnp.zeros((num_keys, n), jnp.int32)
        keys = keys.at[jenv.Key.FORWARD].set(fwd)
        keys = keys.at[jenv.Key.STRAFE_LEFT].set(1 - fwd)
        return keys, jnp.where(fwd > 0, 0.0, -2.0).astype(jnp.float32)

    return fn


def _port_scripted(num_keys):
    def fn(obs, generator):
        n = obs.shape[0]
        fwd = (obs[:, TObs.TIME_LEFT] > 0.8).to(torch.int32)
        keys = torch.zeros((num_keys, n), dtype=torch.int32)
        keys[TKey.FORWARD] = fwd
        keys[TKey.STRAFE_LEFT] = 1 - fwd
        return keys, torch.where(fwd > 0, 0.0, -2.0)

    return fn


def test_eval_sim_scripted_matches_jax():
    """The same scripted episode through both packages, elementwise.  The
    env runs the same float32 operations; under jit XLA folds the mouse
    step (ROADMAP §3), which for this config's mouse of -2 is exact, so
    yaw is held to an ulp of its 90-degree magnitude per frame anyway
    (atol 1e-3 over 720 frames: the bound tests/_torch_common.py sets out,
    far below one degree).  Velocities and z as the rollout kernels are
    held (rtol 1e-5, atol 1e-3)."""
    cfg = TConfig(**PARAMS_CFG)
    launches = env_rollout.rollout_actions.launches
    got = tanalyse.eval_sim(_port_scripted(cfg.num_keys), cfg, device="cpu")
    assert env_rollout.rollout_actions.launches == launches  # plain version
    want = janalyse.eval_sim(_jax_scripted(cfg.num_keys),
                             jenv.Config(**PARAMS_CFG))
    t_len = len(want.reward)
    assert len(got.reward) == t_len and 719 <= t_len <= 722
    assert got.obs.shape == (t_len, 6) and got.action.shape == (t_len, 5)
    for f in PLAYER_FIELDS:
        g, w = getattr(got.player_state, f), np.asarray(
            getattr(want.player_state, f))
        assert g.dtype == w.dtype, f
        if g.dtype == np.bool_:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-3,
                                       err_msg=f)
    np.testing.assert_allclose(got.obs, want.obs, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.action, want.action)
    np.testing.assert_allclose(got.reward, want.reward, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.yaw, want.yaw, rtol=0, atol=1e-3)
    for f in ("smove", "fmove", "jump"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    # The strafe turned the view; derived quantities are finite.
    assert got.yaw[-1] < 85 and np.all(np.isfinite(got.move_angle))
    assert np.isfinite(got.wish_angle[200]) and got.speed.max() > 300
    assert got.device == "cpu"


def test_eval_sim_tpu_pb_deterministic_matches_jax():
    """The trained agent's deterministic episode: the same length, and the
    returns within 10 (test_torch_eval.test_deterministic_score_matches_jax
    gives the reasoning: one observation across a quantization step moves a
    trajectory about 8 points)."""
    cfg = tload(RUN4).env
    policy = Policy(cfg, device="cpu")
    policy.load_state_dict(import_policy_params(TPU_PB))
    got = tanalyse.eval_sim(policy, cfg, deterministic=True, device="cpu")
    want = janalyse.eval_sim(jmodels.import_policy_params(TPU_PB),
                             jload(RUN4).env, deterministic=True)
    assert len(got.reward) == len(want.reward)
    assert abs(float(got.reward.sum()) - float(want.reward.sum())) <= 10.0
    assert 5900 < float(got.reward.sum()) < 5960


@pytest.fixture(scope="module")
def jax_trajectory():
    """One JAX EvalSimResult of a random-weights policy (a spread of move
    and wish angles), and the same arrays as the port's EvalSimResult."""
    cfg = jenv.Config(**PARAMS_CFG)
    want = janalyse.eval_sim(jmodels.init_params(jax.random.key(0), cfg),
                             cfg, seed=3, max_steps=200)
    fields = {f.name: getattr(want, f.name)
              for f in dataclasses.fields(want)}
    fields["player_state"] = tphys.PlayerState(**{
        f: np.asarray(getattr(want.player_state, f)) for f in PLAYER_FIELDS})
    return want, tanalyse.EvalSimResult(**fields, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hypothetical_delta_speeds_matches_jax(jax_trajectory, dtype):
    """JAX's sweep against the port's on the same trajectory.  Float32 (x64
    off on the JAX side): sin/cos and hypot differ by an ulp between the
    packages, and a speed gain is a difference of two speeds near 300-700
    ups, whose ulp is 3-6e-5; atol 1e-3 is 16 such ulps (measured: 1.8e-4
    on the trained trajectory).  Float64 (the velocities cast up, x64 on):
    the same operations in float64, measured 3.4e-13 apart; atol 1e-9."""
    want_r, got_r = jax_trajectory
    if dtype == np.float64:
        up = {f: np.asarray(getattr(want_r.player_state, f)).astype(dtype)
              for f in ("z_pos", "vel_x", "vel_y", "vel_z")}
        want_r = dataclasses.replace(want_r, player_state=(
            want_r.player_state.replace(**{k: jnp.asarray(v)
                                           for k, v in up.items()})))
        got_r = dataclasses.replace(got_r, player_state=dataclasses.replace(
            got_r.player_state, **up))
        want = want_r.hypothetical_delta_speeds()
    else:
        with jax.enable_x64(False):
            want = want_r.hypothetical_delta_speeds()
    got = got_r.hypothetical_delta_speeds()
    assert got.shape == want.shape == (360, len(want_r.reward))
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 if dtype == np.float32 else 1e-9)
    assert (got.max(axis=0) > 0).mean() > 0.8  # some angle gains speed


def test_draw_inputs_matches_jax_image_bits():
    keys_t = {TKey.FORWARD: True, TKey.STRAFE_LEFT: False,
              TKey.STRAFE_RIGHT: True}
    keys_j = {jenv.Key.FORWARD: True, jenv.Key.STRAFE_LEFT: False,
              jenv.Key.STRAFE_RIGHT: True}
    xform = np.array([[1.5, 0.2, 7.0], [-0.1, 1.2, 3.0], [0.0, 0.0, 1.0]])
    rng = np.random.default_rng(0)
    im = rng.integers(0, 256, (90, 130, 4)).astype(np.uint8)
    got, want = im.copy(), im.copy()
    tanalyse.draw_inputs(got, keys_t, 90.0, xform)
    janalyse.draw_inputs(want, keys_j, 90.0, xform)
    assert not np.array_equal(got, im)
    np.testing.assert_array_equal(got, want)


def test_wish_angle_yaw_plot_renders(jax_trajectory, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, r = jax_trajectory
    r.wish_angle_yaw_plot(figsize=(6, 5))
    out = tmp_path / "plot.png"
    plt.savefig(out)
    plt.close("all")
    assert out.stat().st_size > 1000


@pytest.mark.parametrize("demo", ["tpu_pb/run.dem",
                                  "repl_r5/winner_lockstep.dem"])
def test_parse_demo_matches_jax(demo):
    got = tanalyse.parse_demo(CHECKPOINTS / demo)
    want = janalyse.parse_demo(CHECKPOINTS / demo)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[3] == want[3] and got[3] is not None
    assert len(got[0]) > 500


def _smoke_run(tmp_path, **over):
    return TRunConfig(ppo=TPPOConfig(**SMOKE_PPO),
                      checkpoint_dir=str(tmp_path / "ckpt"), **over)


@pytest.fixture(scope="module")
def smoke_checkpoints(tmp_path_factory):
    """A --smoke sized run of 3 iterations that also plots every
    iteration; its checkpoint_dir."""
    tmp = tmp_path_factory.mktemp("smoke")
    trainer = Trainer(_smoke_run(tmp, max_iterations=3, plot_frequency=1),
                      device="cpu")
    trainer.train()
    return Path(trainer.run.checkpoint_dir)


def test_trainer_plot_frequency_writes_plots(smoke_checkpoints):
    plots = sorted(p.name for p in (smoke_checkpoints / "logs")
                   .glob("wish_angle_*.png"))
    assert plots == [f"wish_angle_{i:07d}.png" for i in range(3)]


def test_plot_all_checkpoints_writes_one_png_per_checkpoint(
        smoke_checkpoints, tmp_path, capsys):
    iters = sorted(smoke_checkpoints.glob("iter_*"))
    assert len(iters) >= 2
    tanalyse.plot_all_checkpoints([RUN4, str(smoke_checkpoints),
                                   str(tmp_path / "plots"), "--device",
                                   "cpu"])
    pngs = sorted((tmp_path / "plots").glob("*.png"))
    assert [p.name for p in pngs] == [f"{i:04d}.png"
                                      for i in range(len(iters))]
    assert all(p.stat().st_size > 1000 for p in pngs)
    assert capsys.readouterr().out.count("Wrote ") == len(iters)


@pytest.mark.parametrize("which", ["checkpoint_dir", "iter_dir"])
def test_evaluate_cli_takes_a_directory(smoke_checkpoints, which, capsys):
    """Fault 1: the CLI resolves a run's checkpoint_dir to its latest
    iter_* and a directory to the pickle in it, and still describes the
    checkpoint from the .tune_metadata beside it."""
    latest = sorted(smoke_checkpoints.glob("iter_*"))[-1]
    arg = smoke_checkpoints if which == "checkpoint_dir" else latest
    assert tevaluate.resolve_checkpoint(str(arg)) == str(latest /
                                                         "checkpoint")
    tevaluate.main([RUN4, str(arg), "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    iteration = int(latest.name.split("_")[1])
    assert out[0] == (f"checkpoint: {latest / 'checkpoint'} (iteration "
                      f"{iteration}, {iteration * 64 * 16:,} env steps)")
    assert out[2].startswith("zero-start deterministic: ")


def _load_export_script():
    spec = importlib.util.spec_from_file_location(
        "torch_export_orbax", ROOT / "scripts" / "torch_export_orbax.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def r5_jax_params():
    from q1physrl_tpu.algo import checkpoint as jckpt
    from q1physrl_tpu.algo.ppo import init_train_state

    run = jload(RUN4)
    template = init_train_state(jax.random.key(0), run.env, run.ppo)
    return jckpt.restore_checkpoint(str(R5_ORBAX), template).params


def test_export_orbax_reproduces_the_committed_pickle(tmp_path,
                                                      r5_jax_params):
    path = _load_export_script().export(str(R5_ORBAX), str(tmp_path))
    got = import_policy_params(path)
    committed = import_policy_params(str(R5_RLLIB / "checkpoint"))
    assert got.keys() == committed.keys()
    for k, v in got.items():
        assert torch.equal(v, committed[k]), k
    # ... and the committed pickle holds the orbax checkpoint's params.
    for g, w in zip(jax.tree.leaves(jmodels.import_policy_params(path)),
                    jax.tree.leaves(r5_jax_params)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with open(path + ".tune_metadata", "rb") as f:
        meta = pickle.load(f)
    assert (meta["iteration"], meta["timesteps_total"]) == (5151, 257550000)


@pytest.mark.parametrize("deterministic", [True, False])
def test_round5_winner_scores_match_jax(r5_jax_params, deterministic):
    """The port scores the committed pickle of repl_r5/best_member_02, the
    JAX package its orbax checkpoint.  Deterministic: within 10, as for
    tpu_pb.  Stochastic, 128 episodes each from independent generators:
    the score's std is 26.9 (eval_summary.json), so the difference of two
    128-episode means has a standard deviation of 3.4; 15 is over 4.
    chip_smoke.py holds the card's deterministic score to JAX's on the CPU
    through a constant: it is JAX's score, within the card's tolerance."""
    cfg = tload(RUN4).env
    policy = Policy(cfg, device="cpu")
    policy.load_state_dict(import_policy_params(str(R5_RLLIB /
                                                    "checkpoint")))
    n = 2 if deterministic else 128
    got = tanalyse.eval_zero_start(policy, cfg, num_episodes=n,
                                   deterministic=deterministic, device="cpu")
    want = janalyse.eval_zero_start(r5_jax_params, jload(RUN4).env,
                                    num_episodes=n,
                                    deterministic=deterministic)
    assert abs(got["mean"] - want["mean"]) <= (10.0 if deterministic
                                               else 15.0), (got, want)
    if deterministic:
        assert abs(want["mean"] - R5_DETERMINISTIC) <= R5_DETERMINISTIC_TOL
    assert 5700 < got["mean"] < 5850
