"""The port's training slice against the JAX package: step_autoreset, the
auto-reset rollout's plain version against the Pallas kernel in interpret
mode, the PPO pieces (GAE, KL rule, episode stats, schedules, loss and
gradients, Adam), the rollout frame by frame and the learning half as a
whole; then the training driver: checkpoints, resume, the best-stat policy,
learning, seeding, the RLLib export and the CLI.

The CUDA kernel itself is held against its plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""

import copy
import dataclasses
import functools
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from q1physrl_torch.algo import checkpoint as tckpt
from q1physrl_torch.algo import ppo as tppo
from q1physrl_torch.algo.config import PPOConfig as TPPOConfig
from q1physrl_torch.algo.config import RunConfig as TRunConfig
from q1physrl_torch.algo.config import load_run_config
from q1physrl_torch.algo.train import Trainer
from q1physrl_torch.env import Config as TConfig
from q1physrl_torch.env import core as tcore
from q1physrl_torch.models import (Policy, adam_state_from_jax,
                                   export_policy_params,
                                   import_policy_params, params_from_jax)
from q1physrl_torch.ops import env_rollout
from q1physrl_tpu import env as jenv
from q1physrl_tpu import models as jmodels
from q1physrl_tpu.algo import PPOConfig as JPPOConfig
from q1physrl_tpu.algo import ppo as jppo
from q1physrl_tpu.env import core as jcore
from q1physrl_tpu.ops.env_rollout_pallas import (
    rollout_actions_autoreset as jrollout_autoreset)

from _torch_common import (assert_env_state_close, probe_configs,
                           random_actions, t)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN4 = str(ROOT / "configs" / "run4.yml")
CONFIGS = probe_configs(dataclasses.replace(load_run_config(RUN4).env,
                                            zero_start_prob=0.3))
SMOKE_PPO = dict(num_envs=64, rollout_length=16, num_sgd_iter=2,
                 sgd_minibatch_size=256)


def _jax_cfg(cfg: TConfig) -> jenv.Config:
    return jenv.Config(**dataclasses.asdict(cfg))


def _jax_ppo(ppo: TPPOConfig) -> JPPOConfig:
    return JPPOConfig(**dataclasses.asdict(ppo))


def _env_state_to_jax(st: tcore.EnvState):
    a = lambda x: jnp.asarray(x.detach().numpy())
    p = st.player
    return jcore.EnvState(
        player=jcore.phys.PlayerState(
            z_pos=a(p.z_pos), vel_x=a(p.vel_x), vel_y=a(p.vel_y),
            vel_z=a(p.vel_z), on_ground=a(p.on_ground),
            jump_released=a(p.jump_released)),
        yaw=a(st.yaw), time_remaining=a(st.time_remaining),
        zero_start=a(st.zero_start), last_keys=a(st.last_keys),
        last_key_press_time=a(st.last_key_press_time), rng=None)


def _jax_params(policy: Policy):
    """A port policy's weights as the JAX package's params pytree."""
    sd = {k: v.detach().numpy() for k, v in policy.state_dict().items()}
    tower = lambda name: [(jnp.asarray(sd[f"{name}.layers.{i}.weight"].T),
                           jnp.asarray(sd[f"{name}.layers.{i}.bias"]))
                          for i in range(3)]
    return {"policy": tower("pi"), "value": tower("vf")}


def _port_grads(named: dict):
    """Port tensors keyed by parameter name -> the JAX params layout, as
    numpy (weights transposed to (in, out))."""
    tower = lambda name: [(named[f"{name}.layers.{i}.weight"].numpy().T,
                           named[f"{name}.layers.{i}.bias"].numpy())
                          for i in range(3)]
    return {"policy": tower("pi"), "value": tower("vf")}


def _assert_tree_close(got, want, rtol, atol, what):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=what)


# --- (a) step_autoreset ----------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["run4", "hover=True", "auto_jump=True"])
def test_step_autoreset_matches_jax(name, dtype):
    """300 frames across done seams (a third of the envs start within a
    second of their limit), the same numpy actions and reset uniforms
    through both packages, compared every frame.  Tolerances as in
    test_torch_env.test_step_matches_jax: the same operations in another
    order of rounding where XLA folds the mouse step."""
    cfg = CONFIGS[name]
    jcfg = _jax_cfg(cfg)
    n, steps = 64, 300
    rng = np.random.default_rng(7)
    u = rng.random((5, n)).astype(dtype)
    tr = np.where(rng.random(n) < 0.33, rng.uniform(0, 1, n), 5.0)
    ka, ya = random_actions(cfg, rng, steps, n)
    ya = ya.astype(dtype)
    ru = rng.random((steps, 5, n)).astype(dtype)

    jstate = jcore.reset_from_uniforms(jcfg, *jnp.asarray(u))
    jstate = jstate.replace(time_remaining=jnp.asarray(tr.astype(dtype)))
    tstate = tcore.reset_from_uniforms(cfg, *t(u))
    tstate.time_remaining = t(tr.astype(dtype))
    jstep = jax.jit(functools.partial(jcore.step_autoreset, jcfg))

    dones = 0
    for i in range(steps):
        jstate, jout = jstep(jstate, jnp.asarray(ka[i]), jnp.asarray(ya[i]),
                             reset_uniforms=jnp.asarray(ru[i]))
        tstate, tout = tcore.step_autoreset(cfg, tstate, t(ka[i]), t(ya[i]),
                                            reset_uniforms=t(ru[i]))
        np.testing.assert_allclose(tout.reward.numpy(),
                                   np.asarray(jout.reward), rtol=1e-5,
                                   atol=1e-4, err_msg=f"frame {i}")
        np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))
        np.testing.assert_array_equal(tout.zero_start.numpy(),
                                      np.asarray(jout.zero_start))
        np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs),
                                   rtol=1e-5, atol=1e-5, err_msg=f"frame {i}")
        dones += int(tout.done.sum())
    assert dones > n // 3  # every early env and more ended and re-drew
    assert tstate.yaw.dtype == torch.from_numpy(u).dtype
    # 300 frames: up to ~8 ulps of a 512-degree yaw (see yaw_atol).
    assert_env_state_close(tstate, jstate, yaw_atol=5e-4)


def test_step_autoreset_draws_from_the_generator():
    """Without uniforms the re-draw comes from the generator, seeded alike
    alike; the result carries the pre-reset done and zero_start."""
    cfg = CONFIGS["run4"]
    n = 500
    keys = torch.ones((cfg.num_keys, n), dtype=torch.int32)

    def run(seed):
        state = tcore.reset(cfg, torch.Generator().manual_seed(1), n,
                            device="cpu")
        state.time_remaining[:200] = 0.001  # these end on the first frame
        new, out = tcore.step_autoreset(
            cfg, state, keys, torch.zeros(n),
            generator=torch.Generator().manual_seed(seed))
        return state, new, out

    state, new, out = run(2)
    assert out.done[:200].all() and not out.done[200:].any()
    assert torch.equal(out.zero_start, state.zero_start)
    assert (new.time_remaining[:200] > 1.0).sum() > 150  # fresh clocks
    assert torch.equal(new.yaw, run(2)[1].yaw)
    assert not torch.equal(new.yaw[:200], run(3)[1].yaw[:200])
    with pytest.raises(ValueError):
        tcore.step_autoreset(cfg, state, keys, torch.zeros(n))


# --- (b) the auto-reset rollout against the Pallas kernel -------------------


def test_rollout_actions_autoreset_matches_pallas():
    """tests/test_pallas_rollout.py:72 with the port's wrapper on the CPU
    (its plain version) in place of the scan; the same tolerances."""
    cfg = dataclasses.replace(TConfig.get_default(), num_envs=None,
                              zero_start_prob=0.3)
    jcfg = _jax_cfg(cfg)
    n, steps = 256, 80
    state = jcore.reset(jcfg, jax.random.key(1), n, jnp.float32)
    rng = np.random.default_rng(1)
    ka = rng.integers(0, 2, (steps, cfg.num_keys, n)).astype(np.int32)
    ya = rng.uniform(-10, 10, (steps, n)).astype(np.float32)
    ru = rng.random((steps, 5, n)).astype(np.float32)

    want_state, want_r, want_d = jrollout_autoreset(
        jcfg, state, jnp.asarray(ka), jnp.asarray(ya), jnp.asarray(ru),
        block_envs=128, interpret=True)
    launches = env_rollout.rollout_actions_autoreset.launches
    from _torch_common import env_state_from_jax
    got_state, got_r, got_d = env_rollout.rollout_actions_autoreset(
        cfg, env_state_from_jax(state), t(ka), t(ya), t(ru))
    assert env_rollout.rollout_actions_autoreset.launches == launches
    assert int(np.asarray(want_d).sum()) > 0  # resets fired

    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert_env_state_close(got_state, want_state, yaw_atol=1e-4)


def test_autoreset_wrapper_rejects_bad_reset_uniforms():
    cfg = TConfig.get_default()
    state = tcore.reset(cfg, torch.Generator().manual_seed(0), 8,
                        device="cpu")
    ka = torch.zeros((2, cfg.num_keys, 8), dtype=torch.int32)
    ya = torch.zeros((2, 8))
    for ru in (torch.zeros((2, 4, 8)), torch.zeros((2, 5, 8),
                                                    dtype=torch.float64),
               torch.zeros((1, 5, 8))):
        with pytest.raises(ValueError):
            env_rollout.rollout_actions_autoreset(cfg, state, ka, ya, ru)
    bad = dataclasses.replace(state, zero_start=state.zero_start.int())
    with pytest.raises(ValueError):
        env_rollout.rollout_actions_autoreset(cfg, bad, ka, ya,
                                              torch.zeros((2, 5, 8)))


# --- (c) GAE, the KL rule, episode stats, schedules -------------------------


def test_compute_gae_matches_jax():
    rng = np.random.default_rng(0)
    T, N = 37, 11
    reward = rng.normal(size=(T, N)).astype(np.float32)
    done = rng.random((T, N)) < 0.1
    value = rng.normal(size=(T, N)).astype(np.float32)
    boot = rng.normal(size=N).astype(np.float32)
    ppo = TPPOConfig()
    adv, vt = tppo.compute_gae(ppo, t(reward), t(done), t(value), t(boot))
    jadv, jvt = jppo.compute_gae(_jax_ppo(ppo), jnp.asarray(reward),
                                 jnp.asarray(done), jnp.asarray(value),
                                 jnp.asarray(boot))
    # The same float32 operations in the same order.
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(jvt), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kl", [0.05, 0.001, 0.01, 0.02, 0.005])
def test_update_kl_coeff_matches_jax(kl):
    ppo = TPPOConfig(kl_target=0.01)
    got = tppo.update_kl_coeff(ppo, torch.tensor(0.2), torch.tensor(kl))
    want = jppo.update_kl_coeff(_jax_ppo(ppo), jnp.float32(0.2),
                                jnp.float32(kl))
    assert float(got) == float(want)


def test_episode_stats_update_matches_jax():
    rng = np.random.default_rng(3)
    n = 50
    tstats = tppo.EpisodeStats.zeros(n)
    jstats = jppo.EpisodeStats.zeros(n)
    for _ in range(40):
        r = rng.normal(size=n).astype(np.float32)
        d = rng.random(n) < 0.1
        zs = rng.random(n) < 0.3
        tstats = tstats.update(t(r), t(d), t(zs))
        jstats = jstats.update(jnp.asarray(r), jnp.asarray(d),
                               jnp.asarray(zs))
    for f in dataclasses.fields(tppo.EpisodeStats):
        # Float32 sums of up to 50 terms in another order.
        np.testing.assert_allclose(getattr(tstats, f.name).numpy(),
                                   np.asarray(getattr(jstats, f.name)),
                                   rtol=1e-5, atol=1e-5, err_msg=f.name)
    assert tstats.ep_len.dtype == torch.int32
    empty = tppo.EpisodeStats.zeros(3)
    assert float(empty.ret_max) == -math.inf


@pytest.mark.parametrize("x", [-5.0, 0.0, 123_456.0, 500_000.0, 999_999.0,
                               1_000_000.0, 2_500_000.0, 7e6])
def test_interp_schedule_matches_jax(x):
    """The same float32 formula; XLA may fuse its multiply-add, which moves
    the result by an ulp or two, hence rtol 1e-6 (8 float32 ulps)."""
    for sched in (((0, 0.01), (1_000_000, 0.001)),
                  ((0, 0.03), (40_000_000, 0.01), (150_000_000, 0.01),
                   (250_000_000, 0.002)),
                  ((0, 5e-6),)):
        got = tppo._interp_schedule(sched, x)
        want = float(jppo._interp_schedule(sched, x))
        assert got == pytest.approx(want, rel=1e-6, abs=0), (sched, x)


# --- (d) the loss and its gradients -----------------------------------------


def _loss_batch(jcfg, jparams, rng, b, dtype):
    """A batch whose behaviour logits, actions and logp come from the
    policy itself, with random advantages and value targets."""
    obs = rng.normal(size=(b, 6)).astype(dtype)
    logits, value = jmodels.forward(jparams, jnp.asarray(obs))
    # Perturbed, so that the ratio and the KL are not trivial.
    logits = np.asarray(logits) + rng.normal(0, 0.05, size=logits.shape)
    dist = jmodels.action_dist(jcfg, jnp.asarray(logits))
    ka, ya = dist.sample(jax.random.key(int(rng.integers(1 << 30))))
    logp = dist.logp(ka, ya)
    return dict(
        obs=obs, key_actions=np.asarray(ka).T.copy(), yaw_actions=np.asarray(
            ya, dtype), logits=np.asarray(logits, dtype),
        logp=np.asarray(logp, dtype),
        value=np.asarray(value, dtype) + rng.normal(0, 0.5, b).astype(dtype),
        advantage=rng.normal(size=b).astype(dtype),
        value_target=rng.normal(size=b).astype(dtype))


@pytest.mark.parametrize("overrides", [{}, {"discrete_yaw_steps": 3}])
def test_ppo_loss_and_grads_match_jax_float64(overrides):
    cfg = dataclasses.replace(TConfig.get_default(), num_envs=None,
                              **overrides)
    jcfg = _jax_cfg(cfg)
    ppo = TPPOConfig(vf_clip_param=0.5, clip_param=0.2)
    jparams = jmodels.init_params(jax.random.key(5), jcfg, dtype=jnp.float64)
    rng = np.random.default_rng(5)
    batch = _loss_batch(jcfg, jparams, rng, 200, np.float64)

    jbatch = jppo.Batch(**{k: jnp.asarray(v) for k, v in batch.items()})
    (jtotal, jaux), jgrads = jax.value_and_grad(
        lambda p: jppo.ppo_loss(jcfg, _jax_ppo(ppo), p, jbatch, 0.2, 0.01),
        has_aux=True)(jparams)

    policy = Policy(cfg, device="cpu").double()
    policy.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), dtype=torch.float64))
    tbatch = tppo.Batch(**{k: t(v) for k, v in batch.items()})
    total, aux = tppo.ppo_loss(cfg, ppo, policy, tbatch,
                               torch.tensor(0.2, dtype=torch.float64), 0.01)
    names = [k for k, _ in policy.named_parameters()]
    grads = torch.autograd.grad(total, list(policy.parameters()))

    # Float64 throughout: the same operations agree to many digits; the
    # squashed Gaussian's inverse normal CDF sets the floor.
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-10)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-9,
                                   atol=1e-12, err_msg=k)
    _assert_tree_close(_port_grads(dict(zip(names, grads))), jgrads,
                       rtol=1e-8, atol=1e-12, what="grads")


# --- (e) one optimizer step -------------------------------------------------


def _adam_case(ppo, steps, rng):
    """``steps`` updates through the reference's optimizer; then one more
    from the carried state through both packages."""
    cfg = TConfig.get_default()
    jparams = jmodels.init_params(jax.random.key(2), _jax_cfg(cfg))
    tx = jppo.make_optimizer(_jax_ppo(ppo))
    opt = tx.init(jparams)

    def grads_like(scale):
        return jax.tree.map(
            lambda x: jnp.asarray(rng.normal(0, scale, x.shape), jnp.float32),
            jparams)

    for _ in range(steps):
        updates, opt = tx.update(grads_like(0.3), opt, jparams)
        jparams = optax.apply_updates(jparams, updates)

    adam = [s for s in jax.tree.leaves(
        opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    policy = Policy(cfg, device="cpu")
    policy.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    state = tppo.AdamState(**adam_state_from_jax(
        jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
        adam.count))
    assert state.count == steps

    g = grads_like(0.3)
    updates, opt = tx.update(g, opt, jparams)
    jparams = optax.apply_updates(jparams, updates)
    params = list(policy.parameters())
    tg = [x for x in params_from_jax(jax.tree.map(np.asarray, g)).values()]
    state = tppo.adam_update(ppo, params, tg, state)
    adam = [s for s in jax.tree.leaves(
        opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    return policy, state, jparams, adam


@pytest.mark.parametrize("case", ["plain", "clip", "clip below the norm",
                                  "lr schedule"])
def test_adam_step_matches_reference(case):
    """One step from a carried optimizer state (3 steps in), against the
    reference's.  The same float32 operations: the moments agree exactly
    here (rtol 1e-7 leaves an ulp), the parameters to an ulp or two of
    their size (atol 3e-8 at |p| up to 0.3), as a division by a scalar may
    round by way of its reciprocal."""
    over = dict(num_envs=16, rollout_length=8, num_sgd_iter=2,
                sgd_minibatch_size=32, lr=1e-3)
    if case == "clip":
        over["grad_clip"] = 0.5       # the gradients' norm is about 10
    elif case == "clip below the norm":
        over["grad_clip"] = 1e6       # never triggers
    elif case == "lr schedule":
        over["lr_schedule"] = ((0, 1e-3), (64, 1e-4))
    ppo = TPPOConfig(**over)
    policy, state, jparams, adam = _adam_case(ppo, 3, np.random.default_rng(4))
    assert state.count == int(adam.count) == 4
    names = [k for k, _ in policy.named_parameters()]
    got = _port_grads({k: v.detach() for k, v in
                       zip(names, policy.parameters())})
    _assert_tree_close(got, jparams, rtol=1e-6, atol=3e-8, what="params")
    _assert_tree_close(_port_grads(state.mu), adam.mu, rtol=1e-7, atol=0,
                       what="mu")
    _assert_tree_close(_port_grads(state.nu), adam.nu, rtol=1e-7, atol=0,
                       what="nu")


def test_learning_rate_schedule_reads_the_count_before_the_step():
    ppo = TPPOConfig(num_envs=16, rollout_length=8, num_sgd_iter=2,
                     sgd_minibatch_size=32,
                     lr_schedule=((0, 1e-3), (64, 1e-4)))
    # 8 updates per 128 env steps: update 2 reads env step 32.
    assert tppo._learning_rate(ppo, 0) == float(np.float32(1e-3))
    assert tppo._learning_rate(ppo, 2) == tppo._interp_schedule(
        ppo.lr_schedule, 32)
    assert tppo._learning_rate(ppo, 100) == float(np.float32(1e-4))


# --- (f) the slice as a whole ------------------------------------------------


def _small_run(seed=3, num_envs=32, rollout_length=24, **ppo_over):
    cfg = dataclasses.replace(TConfig.get_default(), num_envs=None,
                              zero_start_prob=0.3)
    ppo = TPPOConfig(num_envs=num_envs, rollout_length=rollout_length,
                     num_sgd_iter=2, sgd_minibatch_size=64, **ppo_over)
    ts = tppo.init_train_state(seed, cfg, ppo, "cpu")
    # A third of the envs end their episode inside the rollout.
    rng = np.random.default_rng(seed)
    tr = ts.env_state.time_remaining.numpy()
    early = rng.random(num_envs) < 0.33
    ts.env_state.time_remaining = t(np.where(
        early, rng.uniform(0, 0.3, num_envs), tr).astype(np.float32))
    return cfg, ppo, ts


def test_rollout_matches_jax_frame_by_frame():
    """The port's rollout replayed through the JAX package on the port's
    own actions and re-draws: observations, policy outputs, log-probs,
    rewards and dones every frame, then the episode statistics, the final
    state and the bootstrap value.  Float32: policy outputs to a few ulps
    (products summed in another order), the env as in the env tests."""
    cfg, ppo, ts = _small_run()
    jcfg = _jax_cfg(cfg)
    jparams = _jax_params(ts.policy)
    jstate = _env_state_to_jax(ts.env_state)
    jstats = jppo.EpisodeStats.zeros(ppo.num_envs)
    env_state, stats, traj, boot = tppo.rollout(
        cfg, ppo, ts.policy, ts.env_state, ts.stats, ts.generator)
    assert traj.obs.shape == (ppo.rollout_length, ppo.num_envs, 6)
    assert bool(traj.done.any())

    jforward = jax.jit(jmodels.forward)
    jstep = jax.jit(functools.partial(jcore.step_autoreset, jcfg,
                                      compute_observation=False))
    for i in range(ppo.rollout_length):
        jobs = jcore.compute_obs(jcfg, jstate.player, jstate.yaw,
                                 jstate.time_remaining).astype(jnp.float32)
        np.testing.assert_allclose(traj.obs[i].numpy(), np.asarray(jobs),
                                   rtol=1e-5, atol=1e-5, err_msg=f"obs {i}")
        logits, value = jforward(jparams, jnp.asarray(traj.obs[i].numpy()))
        np.testing.assert_allclose(traj.logits[i].numpy(), np.asarray(logits),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(traj.value[i].numpy(), np.asarray(value),
                                   rtol=1e-5, atol=1e-6)
        ka = jnp.asarray(traj.key_actions[i].numpy())
        ya = jnp.asarray(traj.yaw_actions[i].numpy())
        dist = jmodels.action_dist(jcfg, jnp.asarray(traj.logits[i].numpy()))
        np.testing.assert_allclose(traj.logp[i].numpy(),
                                   np.asarray(dist.logp(ka, ya)), rtol=1e-5,
                                   atol=1e-4)
        jstate, out = jstep(jstate, ka, ya,
                            reset_uniforms=jnp.asarray(
                                traj.reset_uniforms[i].numpy()))
        np.testing.assert_allclose(traj.reward[i].numpy(),
                                   np.asarray(out.reward), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_array_equal(traj.done[i].numpy(),
                                      np.asarray(out.done))
        jstats = jstats.update(out.reward, out.done, out.zero_start)
    assert_env_state_close(env_state, jstate, yaw_atol=1e-4)
    for f in dataclasses.fields(tppo.EpisodeStats):
        np.testing.assert_allclose(getattr(stats, f.name).numpy(),
                                   np.asarray(getattr(jstats, f.name)),
                                   rtol=1e-5, atol=1e-4, err_msg=f.name)
    _, jboot = jforward(jparams, jcore.compute_obs(
        jcfg, jstate.player, jstate.yaw,
        jstate.time_remaining).astype(jnp.float32))
    np.testing.assert_allclose(boot.numpy(), np.asarray(jboot), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("schedules", [False, True])
def test_learn_matches_jax(schedules):
    """The learning half on one port trajectory and the JAX package's
    permutations, against the JAX package's compute_gae -> standardize ->
    sgd_epochs -> update_kl_coeff composed as train_iter composes them.
    Float32, 2 epochs x 12 minibatches of 64: the losses agree to float32
    rounding, but Adam scales each step to about lr per element whatever
    the gradient's size, so where a gradient element is at rounding level
    the two steps differ by a share of lr (measured: 0.015 lr at most);
    the parameters are held to lr / 10, the moments to 1e-3 relative above
    floors of 1e-5 (mu) and 1e-8 (nu), and the metrics to 1e-4."""
    over = {}
    if schedules:
        over = dict(lr_schedule=((0, 1e-3), (1000, 1e-4)),
                    entropy_coeff_schedule=((0, 0.05), (1000, 0.01)),
                    grad_clip=1.0)
    cfg, ppo, ts = _small_run(seed=4, lr=1e-4 if not schedules else 5e-6,
                              **over)
    ts.env_steps = 384.0  # the entropy schedule is read before the step
    jcfg, jppo_cfg = _jax_cfg(cfg), _jax_ppo(ppo)
    jparams0 = _jax_params(ts.policy)
    env_state, stats, traj, boot = tppo.rollout(
        cfg, ppo, ts.policy, ts.env_state, ts.stats, ts.generator)
    ts = dataclasses.replace(ts, env_state=env_state, stats=stats)

    # The JAX side, composed as train_iter L325-356.
    a = lambda x: jnp.asarray(x.numpy())
    adv, vt = jppo.compute_gae(jppo_cfg, a(traj.reward), a(traj.done),
                               a(traj.value), a(boot))
    adv = (adv - adv.mean()) / jnp.maximum(adv.std(), 1e-4)
    T, N = traj.reward.shape
    flat = lambda x: x.reshape((T * N,) + x.shape[2:])
    batch = jppo.Batch(
        obs=flat(a(traj.obs)),
        key_actions=flat(jnp.moveaxis(a(traj.key_actions), 1, 2)),
        yaw_actions=flat(a(traj.yaw_actions)), logits=flat(a(traj.logits)),
        logp=flat(a(traj.logp)), value=flat(a(traj.value)),
        advantage=flat(adv), value_target=flat(vt))
    entropy_coeff = (jppo._interp_schedule(ppo.entropy_coeff_schedule,
                                           jnp.float32(ts.env_steps))
                     if schedules else ppo.entropy_coeff)
    rng = jax.random.key(11)
    opt = jppo.make_optimizer(jppo_cfg).init(jparams0)
    jparams, opt, aux, _ = jppo.sgd_epochs(
        jcfg, jppo_cfg, jparams0, opt, jnp.float32(ppo.kl_coeff), batch, rng,
        entropy_coeff)
    kl_coeff = jppo.update_kl_coeff(jppo_cfg, jnp.float32(ppo.kl_coeff),
                                    aux["kl"])
    # The permutations sgd_epochs drew.
    _, k = jax.random.split(rng)
    n_mb = ppo.num_minibatches
    perms = np.stack([np.asarray(jax.random.permutation(
        key, ppo.batch_size))[:n_mb * (ppo.batch_size // n_mb)]
        for key in jax.random.split(k, ppo.num_sgd_iter)])

    new_ts, metrics = tppo.learn(cfg, ppo, ts, traj, boot,
                                 perms=torch.from_numpy(perms))
    assert new_ts.iteration == 1 and new_ts.env_steps == 384.0 + T * N
    assert new_ts.opt_state.count == ppo.num_sgd_iter * n_mb
    lr = 1e-3 if schedules else ppo.lr
    names = [k for k, _ in new_ts.policy.named_parameters()]
    got = _port_grads({k: v.detach() for k, v in
                       zip(names, new_ts.policy.parameters())})
    _assert_tree_close(got, jparams, rtol=1e-4, atol=lr / 10, what="params")
    adam = [s for s in jax.tree.leaves(
        opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    assert new_ts.opt_state.count == int(adam.count)
    _assert_tree_close(_port_grads(new_ts.opt_state.mu), adam.mu, rtol=1e-3,
                       atol=1e-5, what="mu")
    _assert_tree_close(_port_grads(new_ts.opt_state.nu), adam.nu, rtol=1e-3,
                       atol=1e-8, what="nu")
    assert float(new_ts.kl_coeff) == float(kl_coeff)
    for k in aux:
        np.testing.assert_allclose(float(metrics[k]), float(aux[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


# --- the driver ----------------------------------------------------------------


def _smoke_run(tmp_path, **over):
    return TRunConfig(ppo=TPPOConfig(**SMOKE_PPO),
                      checkpoint_dir=str(tmp_path), **over)


def test_train_iter_runs_and_metrics_sane():
    cfg = dataclasses.replace(TConfig.get_default(), num_envs=None)
    ppo = TPPOConfig(**SMOKE_PPO)
    ts = tppo.init_train_state(0, cfg, ppo, "cpu")
    before = copy.deepcopy(ts.policy.state_dict())
    ts2, metrics = tppo.train_iter(cfg, ppo, ts)
    assert ts2.iteration == 1 and ts2.env_steps == ppo.batch_size
    assert math.isfinite(metrics["entropy"])
    assert math.isfinite(metrics["vf_loss"])
    assert math.isfinite(metrics["kl"]) and float(metrics["kl"]) >= 0
    diff = sum(float((a - b).abs().sum())
               for a, b in zip(before.values(),
                               ts2.policy.state_dict().values()))
    assert diff > 0


def test_checkpoint_roundtrip(tmp_path):
    cfg = dataclasses.replace(TConfig.get_default(), num_envs=None)
    ppo = TPPOConfig(**SMOKE_PPO)
    ts, _ = tppo.train_iter(cfg, ppo, tppo.init_train_state(0, cfg, ppo,
                                                            "cpu"))
    path = tckpt.save_checkpoint(str(tmp_path), ts, 1)
    assert os.path.basename(path) == "iter_0000001"
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    fresh = tppo.init_train_state(5, cfg, ppo, "cpu")
    restored = tckpt.restore_checkpoint(path, fresh)
    for (k, a), b in zip(ts.policy.state_dict().items(),
                         restored.policy.state_dict().values()):
        assert torch.equal(a, b), k
    for k in ts.opt_state.mu:
        assert torch.equal(ts.opt_state.mu[k], restored.opt_state.mu[k])
        assert torch.equal(ts.opt_state.nu[k], restored.opt_state.nu[k])
    assert restored.opt_state.count == ts.opt_state.count
    assert restored.iteration == 1
    assert float(restored.kl_coeff) == float(ts.kl_coeff)
    assert restored.env_steps == ts.env_steps
    assert torch.equal(restored.generator.get_state(),
                       ts.generator.get_state())
    tppo.train_iter(cfg, ppo, restored)  # the restored state steps
    # The policy export beside it scores through the evaluate CLI's reader.
    sd = import_policy_params(os.path.join(path, "checkpoint"))
    for k, v in sd.items():
        assert torch.equal(v, ts.policy.state_dict()[k]), k
    assert tckpt.latest_checkpoint(str(tmp_path / "missing")) is None


def test_trainer_smoke_runs(tmp_path):
    t_ = Trainer(_smoke_run(tmp_path, max_iterations=2), device="cpu")
    t_.train()
    assert t_.ts.iteration == 2
    log = (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(log) == 2 and '"rollout_seconds"' in log[0]


def test_auto_resume_from_latest(tmp_path):
    run = _smoke_run(tmp_path, max_iterations=2)
    t1 = Trainer(run, device="cpu")
    t1.train()
    assert t1.ts.iteration == 2

    t2 = Trainer(run, device="cpu")  # auto_resume defaults True
    assert t2.ts.iteration == 2
    assert t2.ts.env_steps == t1.ts.env_steps
    for a, b in zip(t1.ts.policy.state_dict().values(),
                    t2.ts.policy.state_dict().values()):
        assert torch.equal(a, b)

    t3 = Trainer(dataclasses.replace(run, auto_resume=False), device="cpu")
    assert t3.ts.iteration == 0


def test_resume_of_finished_run_exits_cleanly(tmp_path):
    """A resumed run whose budget is spent exits with a final save and no
    further iteration, by max_iterations and by max_env_steps."""
    run = _smoke_run(tmp_path, max_iterations=2)
    Trainer(run, device="cpu").train()
    steps_done = Trainer(run, device="cpu").ts.env_steps

    def poisoned():
        raise AssertionError("an iteration ran on a finished run")

    t2 = Trainer(run, device="cpu")
    t2.step = poisoned
    t2.train()
    assert t2.ts.env_steps == steps_done

    run3 = dataclasses.replace(run, max_iterations=None,
                               max_env_steps=steps_done)
    t3 = Trainer(run3, device="cpu")
    t3.step = poisoned
    t3.train()
    assert t3.ts.env_steps == steps_done
    assert Trainer(run, device="cpu").ts.env_steps == steps_done


def test_best_stat_checkpoint_policy(tmp_path):
    """Save when any tracked stat beats its best or every N iterations;
    NaN stats never count."""
    t_ = Trainer(_smoke_run(tmp_path, auto_resume=False,
                            checkpoint_every=100), device="cpu")
    m = dict(episode_reward_mean=1.0, episode_reward_max=2.0,
             zero_start_total_reward_mean=float("nan"))
    assert t_.maybe_checkpoint(1, m) is not None          # first values
    assert "zero_start_total_reward_mean" not in t_.best  # NaN ignored
    assert t_.maybe_checkpoint(2, m) is None              # no improvement
    m2 = dict(m, episode_reward_max=3.0)
    assert t_.maybe_checkpoint(3, m2) is not None         # one improved
    assert t_.best["episode_reward_max"].val == 3.0
    assert t_.best["episode_reward_mean"].val == 1.0
    assert t_.maybe_checkpoint(100, m) is not None        # periodic save
    m3 = dict(m, zero_start_total_reward_mean=5.0)
    assert t_.maybe_checkpoint(101, m3) is not None       # NaN -> value
    assert t_.best["zero_start_total_reward_mean"].val == 5.0


def test_learning_improves_reward():
    """With a workable lr, the mean per-step reward (dt * vel_y) rises: the
    policy finds 'hold forward, face +y' within a few iterations."""
    cfg = dataclasses.replace(TConfig.get_default(), num_envs=None,
                              zero_start_prob=0.0)
    ppo = TPPOConfig(num_envs=128, rollout_length=32, num_sgd_iter=4,
                     sgd_minibatch_size=1024, lr=3e-3)
    ts = tppo.init_train_state(1, cfg, ppo, "cpu")
    first = None
    for _ in range(20):
        ts, metrics = tppo.train_iter(cfg, ppo, ts)
        if first is None:
            first = float(metrics["mean_reward"])
    last = float(metrics["mean_reward"])
    assert last > first + 0.5, (first, last)


def test_same_seed_same_run_bitwise():
    cfg = dataclasses.replace(TConfig.get_default(), num_envs=None)
    ppo = TPPOConfig(**SMOKE_PPO)

    def run(seed):
        ts = tppo.init_train_state(seed, cfg, ppo, "cpu")
        for _ in range(2):
            ts, metrics = tppo.train_iter(cfg, ppo, ts)
        return ts, {k: float(v) for k, v in metrics.items()}

    (a, ma), (b, mb), (c, mc) = run(0), run(0), run(1)
    for x, y in zip(a.policy.state_dict().values(),
                    b.policy.state_dict().values()):
        assert torch.equal(x, y)
    assert torch.equal(a.env_state.yaw, b.env_state.yaw)
    assert all(ma[k] == mb[k] or (math.isnan(ma[k]) and math.isnan(mb[k]))
               for k in ma)
    assert not torch.equal(a.policy.pi.layers[0].weight,
                           c.policy.pi.layers[0].weight)
    assert ma["entropy"] != mc["entropy"]


def test_export_reads_back_in_both_packages(tmp_path):
    cfg = TConfig.get_default()
    policy = Policy(cfg, generator=torch.Generator().manual_seed(9))
    path = export_policy_params(policy.state_dict(), str(tmp_path / "ckpt"),
                                iteration=7, timesteps_total=1234)
    assert os.path.exists(path + ".tune_metadata")
    port = import_policy_params(path)
    for k, v in policy.state_dict().items():
        assert torch.equal(port[k], v), k
    jparams = jmodels.import_policy_params(path)
    want = _jax_params(policy)
    for g, w in zip(jax.tree.leaves(jparams), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_trainer_defaults_to_cuda_and_refuses_plots(tmp_path):
    """The Trainer runs on the card unless told otherwise.  It refused
    plot_frequency > 0 until eval_sim was ported; now it takes it (the
    plots themselves: test_torch_analyse.py)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(_smoke_run(tmp_path))
    trainer = Trainer(_smoke_run(tmp_path, plot_frequency=10), device="cpu")
    assert trainer.run.plot_frequency == 10


@pytest.mark.parametrize("saved_kind", ["cpu", "cuda"])
def test_restore_names_both_generator_kinds(tmp_path, saved_kind):
    """A CPU generator's state (MT19937, about 5 KB) and a CUDA one's (16
    bytes) cannot stand in for each other: restoring across kinds raises a
    ValueError that names both, rather than reseeding."""
    cfg = dataclasses.replace(TConfig.get_default(), num_envs=None)
    ppo = TPPOConfig(**SMOKE_PPO)
    ts = tppo.init_train_state(0, cfg, ppo, "cpu")
    path = tckpt.save_checkpoint(str(tmp_path), ts, 1)
    live_kind = "cuda" if saved_kind == "cpu" else "cpu"
    if saved_kind == "cuda":  # the state a CUDA generator stores
        state_file = os.path.join(path, tckpt.STATE_FILE)
        tree = torch.load(state_file, weights_only=True)
        tree["generator"] = torch.zeros(16, dtype=torch.uint8)
        torch.save(tree, state_file)
        target = ts
    else:  # a live CUDA generator's state and kind
        cuda_like = type("CudaGenerator", (), {
            "device": torch.device("cuda"),
            "get_state": lambda self: torch.zeros(16, dtype=torch.uint8)})()
        target = dataclasses.replace(ts, generator=cuda_like)
    message = (f"saved from a {saved_kind} generator, restoring into a "
               f"{live_kind} one")
    with pytest.raises(ValueError, match=message):
        tckpt.restore_checkpoint(path, target)
    if saved_kind == "cpu":  # the same kind restores
        restored = tckpt.restore_checkpoint(
            path, tppo.init_train_state(1, cfg, ppo, "cpu"))
        assert torch.equal(restored.generator.get_state(),
                           ts.generator.get_state())


def test_train_cli_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "q1physrl_torch.algo.train", "--smoke",
         "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Iteration: 2 " in proc.stdout
    assert "Finished 3 iterations" in proc.stdout
