"""The port's rollout_actions on the CPU (its plain version) against the JAX
package's Pallas rollout_actions in interpret mode, and the wrapper's
argument checks.  The CUDA kernel itself is held against the plain version
on the card by chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q1physrl_torch.env import Config as TConfig
from q1physrl_torch.env import core as tcore
from q1physrl_torch.ops import env_rollout
from q1physrl_tpu import env as jenv
from q1physrl_tpu.env import core as jcore
from q1physrl_tpu.ops.env_rollout_pallas import rollout_actions as jrollout

from _torch_common import (assert_env_state_close, env_state_from_jax,
                           probe_configs, t)

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["run4", "hover=True"])
def test_rollout_actions_matches_pallas(name):
    cfg = probe_configs(dataclasses.replace(TConfig.get_default(),
                                            num_envs=None))[name]
    jcfg = jenv.Config(**dataclasses.asdict(cfg))
    n, steps = 256, 40
    state = jcore.reset(jcfg, jax.random.key(0), n, jnp.float32)

    rng = np.random.default_rng(0)
    ka = rng.integers(0, 2, (steps, cfg.num_keys, n)).astype(np.int32)
    ya = rng.uniform(-10, 10, (steps, n)).astype(np.float32)

    want_state, want_r, want_d = jrollout(jcfg, state, jnp.asarray(ka),
                                          jnp.asarray(ya), block_envs=128,
                                          interpret=True)
    launches = env_rollout.rollout_actions.launches
    got_state, got_r, got_d = env_rollout.rollout_actions(
        cfg, env_state_from_jax(state), t(ka), t(ya))
    assert env_rollout.rollout_actions.launches == launches  # no kernel here

    assert got_r.dtype == torch.float32 and got_d.dtype == torch.bool
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    # 40 frames: a few ulps of yaw (see assert_env_state_close).
    assert_env_state_close(got_state, want_state, yaw_atol=1e-4)


def _small_case(cfg, n=8, steps=3):
    gen = torch.Generator("cpu").manual_seed(0)
    state = tcore.reset(cfg, gen, n, device="cpu")
    ka = torch.zeros((steps, cfg.num_keys, n), dtype=torch.int32)
    ya = torch.zeros((steps, n), dtype=torch.float32)
    return state, ka, ya


def _bad_cases(cfg):
    """{description: (state, key_actions, yaw_actions)} the wrapper
    rejects."""
    state, ka, ya = _small_case(cfg)
    f64_state = dataclasses.replace(state, yaw=state.yaw.double())
    int_flags = dataclasses.replace(state, player=dataclasses.replace(
        state.player, on_ground=state.player.on_ground.int()))
    strided = torch.zeros((3, 16), dtype=torch.float32)[:, ::2]
    return {
        "float64 yaw actions": (state, ka, ya.double()),
        "int64 key actions": (state, ka.long(), ya),
        "float64 state": (f64_state, ka, ya),
        "int32 flags": (int_flags, ka, ya),
        "wrong key count": (state, ka[:, :-1], ya),
        "2-d key actions": (state, ka[0], ya),
        "T mismatch": (state, ka, ya[:-1]),
        "N mismatch": (state, ka[..., :-1], ya[..., :-1]),
        "no steps": (state, ka[:0], ya[:0]),
        "non-contiguous": (state, ka, strided),
    }


BAD_CASES = ("float64 yaw actions", "int64 key actions", "float64 state",
             "int32 flags", "wrong key count", "2-d key actions",
             "T mismatch", "N mismatch", "no steps", "non-contiguous")


@pytest.mark.parametrize("case", BAD_CASES)
def test_wrapper_rejects_bad_arguments(case):
    cfg = TConfig.get_default()
    cases = _bad_cases(cfg)
    assert set(cases) == set(BAD_CASES)
    state, ka, ya = cases[case]
    with pytest.raises(ValueError):
        env_rollout.rollout_actions(cfg, state, ka, ya)


def test_wrapper_accepts_its_own_output():
    """The returned state feeds the next call (T=1, as scoring runs it), and
    equals one multi-step call."""
    cfg = TConfig.get_default()
    state, _, _ = _small_case(cfg)
    rng = np.random.default_rng(3)
    ka = t(rng.integers(0, 2, (5, cfg.num_keys, 8)).astype(np.int32))
    ya = t(rng.uniform(-10, 10, (5, 8)).astype(np.float32))
    once, r_once, d_once = env_rollout.rollout_actions(cfg, state, ka, ya)
    st, rs = state, []
    for i in range(5):
        st, r, _ = env_rollout.rollout_actions(cfg, st, ka[i:i + 1],
                                               ya[i:i + 1])
        rs.append(r)
    assert torch.equal(torch.cat(rs), r_once)
    assert torch.equal(st.yaw, once.yaw)
    assert torch.equal(st.player.vel_y, once.player.vel_y)
