"""The port's gym shims against the JAX package's: ``encode_actions`` on the
reference's ragged formats, ``VectorPhysEnv`` and ``PhysEnv`` stepped from
one converted state with the same actions (float32, and float64 against
JAX's x64 mode), ``reset_at``, and the gymnasium registrations of both
packages side by side."""

import numpy as np
import pytest
import torch

from q1physrl_torch import env as tenv
from q1physrl_torch.env import gymnasium_env as tgym
from q1physrl_tpu import env as jenv

from _torch_common import env_state_from_jax

torch.set_num_threads(1)

N, STEPS = 64, 200


def _ragged(rng, n, cfg):
    """Actions in the shapes the reference's _fix_actions accepts: each
    component a scalar, a 0-d array or a length-1 array."""
    out = []
    for i in range(n):
        keys = [int(k) for k in rng.integers(0, 2, cfg.num_keys)]
        wrap = [lambda x: x, np.asarray, lambda x: np.asarray([x])][i % 3]
        a = [wrap(k) for k in keys]
        if cfg.allow_yaw:
            a.append(np.asarray([rng.uniform(-cfg.action_range,
                                             cfg.action_range)],
                                np.float32))
        out.append(a)
    return out


@pytest.mark.parametrize("allow_yaw", [True, False])
def test_encode_actions_matches_jax(allow_yaw):
    tcfg = tenv.Config(allow_yaw=allow_yaw)
    jcfg = jenv.Config(allow_yaw=allow_yaw)
    actions = _ragged(np.random.default_rng(0), 7, tcfg)
    got, want = tenv.encode_actions(actions, tcfg), jenv.encode_actions(
        actions, jcfg)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _pair(float_dtype, n=N):
    """Both packages' VectorPhysEnv on n envs, the port's state set to a
    conversion of the JAX env's start."""
    cfg = dict(num_envs=n, zero_start_prob=0.5)
    jvec = jenv.VectorPhysEnv(cfg, seed=3, float_dtype=np.dtype(float_dtype))
    tvec = tenv.VectorPhysEnv(cfg, seed=3, device="cpu",
                              float_dtype=getattr(torch, float_dtype))
    tvec._state = env_state_from_jax(jvec._state)
    return jvec, tvec


def _assert_step_close(got, want, float_dtype):
    (obs, rew, done, info), (jobs, jrew, jdone, jinfo) = got, want
    assert obs.dtype == np.asarray(jobs).dtype == np.dtype(
        np.promote_types(float_dtype, np.float32))
    # tests/test_pallas_rollout.py's tolerances for the kernel against the
    # scan: rewards rtol 1e-5 / atol 1e-4, the state's floats atol 1e-3
    # (here divided by the observation's scale, 1 or more).
    np.testing.assert_allclose(rew, jrew, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(obs, jobs, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(done, jdone)
    assert info == jinfo


@pytest.mark.parametrize("float_dtype", ["float32", "float64"])
def test_vector_env_matches_jax(float_dtype):
    """200 steps of random actions from one state: obs, reward and done
    within the rollout tolerances; the state then as the port's env tests
    hold it (float64: JAX's x64 mode, on in the tests' conftest)."""
    jvec, tvec = _pair(float_dtype)
    rng = np.random.default_rng(1)
    for _ in range(STEPS):
        actions = _ragged(rng, N, tvec._config)
        _assert_step_close(tvec.vector_step(actions),
                           jvec.vector_step(actions), float_dtype)
    assert tvec._yaw.dtype == np.dtype(float_dtype)
    np.testing.assert_allclose(tvec._yaw, jvec._yaw, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(tvec._zero_start, jvec._zero_start)
    np.testing.assert_allclose(tvec._time_remaining, jvec._time_remaining,
                               rtol=1e-6)


def test_phys_env_matches_jax():
    """The single-env facade, from one converted state, for 200 steps."""
    cfg = dict(num_envs=None, zero_start_prob=1.0)
    jone = jenv.PhysEnv(cfg, float_dtype=np.float32)
    tone = tenv.PhysEnv(cfg, device="cpu")
    np.testing.assert_array_equal(tone.reset(), jone.reset())
    tone._env._state = env_state_from_jax(jone._env._state)
    rng = np.random.default_rng(2)
    for _ in range(STEPS):
        (action,) = _ragged(rng, 1, tone._env._config)
        (obs, rew, done, info) = tone.step(action)
        (jobs, jrew, jdone, jinfo) = jone.step(action)
        _assert_step_close((obs, rew, done, info),
                           (jobs, jrew, jdone, jinfo), "float32")
    with pytest.raises(ValueError):
        tenv.PhysEnv(dict(num_envs=4), device="cpu")


def test_reset_at_touches_one_env():
    _, tvec = _pair("float32", n=8)
    tvec.vector_step(_ragged(np.random.default_rng(4), 8, tvec._config))
    before = [x.clone() for x in tvec._state.leaves()]
    obs = tvec.reset_at(5)
    after = tvec._state.leaves()
    for b, a in zip(before, after):
        keep = [i for i in range(8) if i != 5]
        assert torch.equal(b[..., keep], a[..., keep])
    assert float(tvec._state.time_remaining[5]) != float(before[7][5])
    np.testing.assert_array_equal(obs, tvec._get_obs()[5])


def test_gymnasium_ids_make_each_package_env():
    gymnasium = pytest.importorskip("gymnasium")
    import q1physrl_tpu.env.gymnasium_env  # noqa: F401  (registers its id)

    assert tgym.register() and tgym.ENV_ID == "q1physrl_torch/Q1PhysEnv-v0"
    ported = gymnasium.make(tgym.ENV_ID, device="cpu")
    assert isinstance(ported.unwrapped, tgym.GymnasiumPhysEnv)
    reference = gymnasium.make("Q1PhysEnv-v0")
    assert type(reference.unwrapped).__module__ == (
        "q1physrl_tpu.env.gymnasium_env")

    obs, info = ported.reset(seed=11)
    again, _ = ported.reset(seed=11)
    np.testing.assert_array_equal(obs, again)
    assert obs.dtype == np.float32 and obs.shape == (6,) and info == {}
    obs, reward, terminated, truncated, info = ported.step(
        ported.action_space.sample())
    assert obs.shape == (6,) and isinstance(reward, float)
    assert terminated is False and isinstance(truncated, bool)
    assert "zero_start" in info
