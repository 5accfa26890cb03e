"""The port's env core against the JAX package: step over 300 frames for
run4 and the five probe configs, reset_from_uniforms on injected uniforms,
the reset distribution, and the golden replay of a recorded episode."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q1physrl_torch import phys as tphys
from q1physrl_torch.algo.config import load_run_config
from q1physrl_torch.env import Config as TConfig
from q1physrl_torch.env import core as tcore
from q1physrl_tpu import env as jenv
from q1physrl_tpu.env import core as jcore

from _torch_common import (assert_env_state_close, probe_configs,
                           random_actions, t)

torch.set_num_threads(1)

RUN4 = os.path.join(os.path.dirname(__file__), "..", "configs", "run4.yml")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "scripted_episode.npz")
CONFIGS = probe_configs(dataclasses.replace(load_run_config(RUN4).env,
                                            zero_start_prob=0.3))


def _jax_cfg(cfg: TConfig) -> jenv.Config:
    return jenv.Config(**dataclasses.asdict(cfg))


def _uniforms(rng, n, dtype):
    return rng.random((5, n)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_matches_jax(name, dtype):
    """300 frames of numpy actions through both packages, compared every
    frame: reward, done, obs and the whole carried state."""
    cfg = CONFIGS[name]
    jcfg = _jax_cfg(cfg)
    n, steps = 64, 300
    rng = np.random.default_rng(1)
    u = _uniforms(rng, n, dtype)
    ka, ya = random_actions(cfg, rng, steps, n)
    ya = ya.astype(dtype)

    jstate = jcore.reset_from_uniforms(jcfg, *jnp.asarray(u))
    tstate = tcore.reset_from_uniforms(cfg, *t(u))
    assert_env_state_close(tstate, jstate)
    jstep = jax.jit(functools.partial(jcore.step, jcfg))

    done_seen = False
    for i in range(steps):
        jstate, jout = jstep(jstate, jnp.asarray(ka[i]), jnp.asarray(ya[i]))
        tstate, tout = tcore.step(cfg, tstate, t(ka[i]), t(ya[i]))
        np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward),
                                   rtol=1e-5, atol=1e-4, err_msg=f"step {i}")
        np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))
        np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs),
                                   rtol=1e-5, atol=1e-5, err_msg=f"step {i}")
        done_seen |= bool(tout.done.any())
    assert done_seen  # episodes end inside the window
    # 300 frames: up to ~8 ulps of a 512-degree yaw (see yaw_atol).
    assert_env_state_close(tstate, jstate, yaw_atol=5e-4)


@pytest.mark.parametrize("hover", [False, True])
def test_reset_from_uniforms_matches_jax(hover):
    cfg = dataclasses.replace(TConfig.get_default(), zero_start_prob=0.5,
                              hover=hover)
    rng = np.random.default_rng(2)
    for dtype in (np.float32, np.float64):
        u = _uniforms(rng, 1000, dtype)
        want = jcore.reset_from_uniforms(_jax_cfg(cfg), *jnp.asarray(u))
        got = tcore.reset_from_uniforms(cfg, *t(u))
        assert got.yaw.dtype == t(u).dtype
        assert got.player.vel_x.dtype == torch.float32
        assert_env_state_close(got, want, vel_rtol=1e-6, vel_atol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_actions_matches_jax(name):
    """The move command step() sends to the physics, from a state with key
    latches and press times mid-episode."""
    cfg = CONFIGS[name]
    jcfg = _jax_cfg(cfg)
    n = 256
    rng = np.random.default_rng(4)
    u = _uniforms(rng, n, np.float32)
    jstate = jcore.reset_from_uniforms(jcfg, *jnp.asarray(u))
    tstate = tcore.reset_from_uniforms(cfg, *t(u))
    k = cfg.num_keys
    last_keys = rng.integers(0, 2, (k, n)).astype(np.int32)
    press = rng.uniform(-0.3, 2.0, (k, n)).astype(np.float32)
    jstate = jstate.replace(last_keys=jnp.asarray(last_keys),
                            last_key_press_time=jnp.asarray(press))
    tstate = dataclasses.replace(tstate, last_keys=t(last_keys),
                                 last_key_press_time=t(press))
    ka, ya = random_actions(cfg, rng, 1, n)
    got = tcore.decode_actions(cfg, tstate, t(ka[0]), t(ya[0]))
    want = jcore.decode_actions(jcfg, jstate, jnp.asarray(ka[0]),
                                jnp.asarray(ya[0]))
    for name_, g, w in zip(("yaw", "smove", "fmove", "jump"), got, want):
        if name_ == "yaw":  # see yaw_atol in assert_env_state_close
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=6e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name_)


def test_reset_distribution():
    """reset draws through the generator; the (1, x] quirk holds."""
    cfg = dataclasses.replace(TConfig.get_default(), zero_start_prob=0.2)
    gen = torch.Generator("cpu").manual_seed(0)
    st = tcore.reset(cfg, gen, 20000, device="cpu")
    zs = st.zero_start.numpy()
    assert abs(zs.mean() - 0.2) < 0.015
    tr = st.time_remaining.numpy()[~zs]
    assert tr.min() > 1.0 and tr.max() <= cfg.time_limit
    speed = np.hypot(st.player.vel_x.numpy(), st.player.vel_y.numpy())
    assert np.all(speed[zs] == 0) and np.all(st.yaw.numpy()[zs] == 90.0)
    assert speed[~zs].min() > 0.99 and speed[~zs].max() <= 700.01
    assert abs(np.median(tr) - 5.5) < 0.2  # uniform on (1, 10]
    again = tcore.reset(cfg, torch.Generator("cpu").manual_seed(0), 20000,
                        device="cpu")
    assert torch.equal(again.yaw, st.yaw)


def test_golden_episode_replay():
    """tests/test_golden.py's replay of a recorded reference episode,
    through the port in float64 parity mode."""
    g = np.load(GOLDEN)
    cfg = TConfig(**dict(
        action_range=10.0, allow_jump=True, allow_yaw=True, auto_jump=False,
        discrete_yaw_steps=-1, fmove_max=800.0, smove_max=1060.0,
        hover=False, initial_yaw_range=(0.0, 360.0), key_press_delay=0.3,
        max_initial_speed=700.0, smooth_keys=True, speed_reward=False,
        time_delta=0.013888888888888, time_limit=10.0, zero_start_prob=1.0,
        num_envs=None))
    n = g["state0_yaw"].shape[0]
    f64 = torch.float64
    state = tcore.EnvState(
        player=tphys.PlayerState(
            z_pos=t(g["state0_z_pos"]).to(f64),
            vel_x=t(g["state0_vel"][:, 0]), vel_y=t(g["state0_vel"][:, 1]),
            vel_z=t(g["state0_vel"][:, 2]),
            on_ground=t(g["state0_on_ground"]),
            jump_released=t(g["state0_jump_released"])),
        yaw=t(g["state0_yaw"]).to(f64),
        time_remaining=t(g["state0_time_remaining"]).to(f64),
        zero_start=t(g["state0_zero_start"]),
        last_keys=torch.zeros((cfg.num_keys, n), dtype=torch.int32),
        last_key_press_time=torch.full((cfg.num_keys, n),
                                       -cfg.key_press_delay, dtype=f64))
    assert state.player.vel_x.dtype == torch.float32

    max_err = 0.0
    for i in range(g["obs"].shape[0]):
        state, out = tcore.step(cfg, state, t(g["key_actions"][i]),
                                t(g["yaw_actions"][i]).to(f64))
        max_err = max(max_err, float(np.abs(out.obs.numpy()
                                            - g["obs"][i]).max()))
        np.testing.assert_array_equal(out.done.numpy(), g["done"][i])
        np.testing.assert_allclose(out.reward.numpy(), g["reward"][i],
                                   rtol=0, atol=2e-5)
    assert max_err < 2e-5, max_err
