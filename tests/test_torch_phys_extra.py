"""The rest of the port's physics: the host-side helpers of Inputs and
PlayerState (vel3, from_vel3, the engine log's frames, concatenate)
against the JAX package's, and phys.apply against the independent C++
oracle (native/qphys.cpp), one step and a 720-frame trajectory, as
tests/test_native.py holds the JAX physics."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q1physrl_torch import phys as tphys
from q1physrl_tpu import native
from q1physrl_tpu import phys as jphys

from _torch_common import PLAYER_FIELDS, t

torch.set_num_threads(1)

INPUT_FIELDS = ("yaw", "pitch", "roll", "fmove", "smove", "button2")


def _case(n, seed):
    """tests/test_native.py's random state and inputs: z as float64 for
    the oracle, velocities and inputs float32."""
    rng = np.random.default_rng(seed)
    state = {
        "z_pos": rng.uniform(24.03125, 200, n),
        "vel_x": rng.uniform(-800, 800, n).astype(np.float32),
        "vel_y": rng.uniform(-800, 800, n).astype(np.float32),
        "vel_z": rng.uniform(-800, 800, n).astype(np.float32),
        "on_ground": rng.random(n) < 0.5,
        "jump_released": rng.random(n) < 0.5,
    }
    inputs = {
        "yaw": rng.uniform(-360, 720, n).astype(np.float32),
        "pitch": np.zeros(n, np.float32),
        "roll": np.zeros(n, np.float32),
        "fmove": rng.integers(-850, 851, n).astype(np.float32),
        "smove": rng.integers(-1100, 1101, n).astype(np.float32),
        "button2": rng.random(n) < 0.5,
        "time_delta": np.full(n, 1.0 / 72, np.float32),
    }
    return inputs, state


def _port_state(state):
    return tphys.PlayerState(**{
        k: t(np.asarray(v, np.float32) if k == "z_pos" else v)
        for k, v in state.items()})


def _jax_state(state):
    return jphys.PlayerState(**{
        k: jnp.asarray(np.asarray(v, np.float32) if k == "z_pos" else v)
        for k, v in state.items()})


def test_vel3_and_from_vel3_match_jax():
    _, state = _case(64, 0)
    got, want = _port_state(state), _jax_state(state)
    np.testing.assert_array_equal(got.vel3(), want.vel3())
    assert got.vel3().shape == (64, 3) and got.vel3().dtype == np.float32
    back = tphys.PlayerState.from_vel3(got.z_pos, got.vel3(), got.on_ground,
                                       got.jump_released)
    jback = jphys.PlayerState.from_vel3(want.z_pos, want.vel3(),
                                        want.on_ground, want.jump_released)
    for f in PLAYER_FIELDS:
        assert isinstance(getattr(back, f), torch.Tensor), f
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(jback, f)),
                                      err_msg=f)


def test_frames_round_trip_and_match_jax():
    """to_df gives the JAX package's frame column for column, and from_df
    reads it back to the same values."""
    inputs, state = _case(50, 1)
    tin = tphys.Inputs(**{k: t(inputs[k]) for k in INPUT_FIELDS},
                       time_delta=1.0 / 72)
    jin = jphys.Inputs(**{k: jnp.asarray(inputs[k]) for k in INPUT_FIELDS},
                       time_delta=np.float64(1.0 / 72))
    for got, want in ((tin.to_df(), jin.to_df()),
                      (_port_state(state).to_df(),
                       _jax_state(state).to_df())):
        assert list(got.columns) == list(want.columns)
        for c in got.columns:
            np.testing.assert_array_equal(got[c].to_numpy(),
                                          want[c].to_numpy(), err_msg=c)

    back = tphys.Inputs.from_df(tin.to_df())
    jback = jphys.Inputs.from_df(jin.to_df())
    for k in INPUT_FIELDS + ("time_delta",):
        np.testing.assert_array_equal(getattr(back, k).numpy(),
                                      np.asarray(getattr(jback, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(back.yaw.numpy(), inputs["yaw"])
    np.testing.assert_array_equal(back.time_delta.numpy(),
                                  np.full(50, 1.0 / 72))
    pstate = _port_state(state)
    sback = tphys.PlayerState.from_df(pstate.to_df())
    jsback = jphys.PlayerState.from_df(_jax_state(state).to_df())
    for f in PLAYER_FIELDS:
        np.testing.assert_array_equal(getattr(sback, f).numpy(),
                                      getattr(pstate, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(getattr(sback, f).numpy(),
                                      np.asarray(getattr(jsback, f)),
                                      err_msg=f)


def test_concatenate_matches_jax():
    parts = [_case(n, seed)[1] for n, seed in ((3, 2), (5, 3), (1, 4))]
    got = tphys.PlayerState.concatenate([_port_state(s) for s in parts])
    want = jphys.PlayerState.concatenate([_jax_state(s) for s in parts])
    for f in PLAYER_FIELDS:
        assert getattr(got, f).shape == (9,), f
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.fixture
def oracle():
    if not native.available():
        pytest.skip("C++ toolchain unavailable: the oracle cannot build")
    return native


def test_apply_matches_cpp_oracle_single_step(oracle):
    """tests/test_native.py's tolerances: float32 against the oracle's
    float64 z and its own libm (rtol 1e-5, atol 2e-3 on velocity); the
    ground flag may flip only within a hair of the floor."""
    inputs, state = _case(4096, 0)
    cpp = oracle.apply(inputs, state)
    out = tphys.apply(tphys.Inputs(**{k: t(v) for k, v in inputs.items()}),
                      _port_state(state))
    for f in ("vel_x", "vel_y", "vel_z"):
        np.testing.assert_allclose(getattr(out, f).numpy(), cpp[f],
                                   rtol=1e-5, atol=2e-3, err_msg=f)
    np.testing.assert_allclose(out.z_pos.numpy(), cpp["z_pos"], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(out.jump_released.numpy(),
                                  cpp["jump_released"])
    assert (out.on_ground.numpy() != cpp["on_ground"]).mean() < 1e-3


def test_apply_trajectory_matches_cpp_oracle(oracle):
    """720 frames of forward then strafe with jumps, fed back frame by
    frame: velocities within 0.5 ups of the oracle's over the whole run,
    as tests/test_native.py holds the JAX physics."""
    rng = np.random.default_rng(1)
    steps = 720
    inputs = {
        "yaw": (90 + np.cumsum(rng.uniform(-2, 2, steps))).astype(np.float32),
        "pitch": np.zeros(steps, np.float32),
        "roll": np.zeros(steps, np.float32),
        "fmove": np.where(np.arange(steps) < 100, 800, 0).astype(np.float32),
        "smove": np.where(np.arange(steps) < 100, 0,
                          -1060).astype(np.float32),
        "button2": (np.arange(steps) % 7 < 2),
        "time_delta": np.full(steps, 1.0 / 72, np.float32),
    }
    state0 = {"z_pos": 32.84320068359375, "vel_x": 0.0, "vel_y": 0.0,
              "vel_z": -12.0, "on_ground": False, "jump_released": True}
    cpp = oracle.trajectory(inputs, state0)

    st = tphys.PlayerState(
        z_pos=torch.tensor([state0["z_pos"]], dtype=torch.float32),
        vel_x=torch.zeros(1), vel_y=torch.zeros(1),
        vel_z=torch.tensor([-12.0]), on_ground=torch.tensor([False]),
        jump_released=torch.tensor([True]))
    vx, vy = [], []
    for i in range(steps):
        st = tphys.apply(tphys.Inputs(**{k: t(v[i:i + 1])
                                         for k, v in inputs.items()}), st)
        vx.append(float(st.vel_x[0]))
        vy.append(float(st.vel_y[0]))
    np.testing.assert_allclose(vy, cpp["vel_y"], atol=0.5)
    np.testing.assert_allclose(vx, cpp["vel_x"], atol=0.5)
    assert max(np.hypot(vx, vy)) > 320  # strafing passed the ground cap
