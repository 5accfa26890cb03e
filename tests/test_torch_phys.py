"""The port's phys.apply against q1physrl_tpu.phys.apply on random states, in
float32 and in the float64 parity mode (vel stays float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q1physrl_torch import phys as tphys
from q1physrl_tpu import phys as jphys

from _torch_common import PLAYER_FIELDS, t

torch.set_num_threads(1)

N = 512


def _random_case(rng, fdtype):
    """Inputs and state that cover the ground, air, jump-latch and
    zero-wish-speed branches."""
    inputs = dict(
        yaw=rng.uniform(0, 360, N).astype(fdtype),
        pitch=np.where(rng.random(N) < 0.5, 0.0,
                       rng.uniform(-30, 30, N)).astype(fdtype),
        roll=np.where(rng.random(N) < 0.5, 0.0,
                      rng.uniform(-10, 10, N)).astype(fdtype),
        fmove=(rng.integers(-1, 2, N) * 800.0).astype(fdtype),
        smove=(rng.integers(-2, 3, N) * 530.0).astype(fdtype),
        button2=rng.random(N) < 0.5,
    )
    state = dict(
        z_pos=rng.uniform(24.0, 60.0, N).astype(fdtype),
        vel_x=rng.uniform(-800, 800, N).astype(np.float32),
        vel_y=rng.uniform(-800, 800, N).astype(np.float32),
        vel_z=rng.uniform(-300, 300, N).astype(np.float32),
        on_ground=rng.random(N) < 0.5,
        jump_released=rng.random(N) < 0.5,
    )
    state["vel_x"][:8] = 0.0  # speed == 0: the friction guard
    state["vel_y"][:8] = 0.0
    return inputs, state


@pytest.mark.parametrize("fdtype", [np.float32, np.float64])
def test_apply_matches_jax(fdtype):
    rng = np.random.default_rng(0)
    td = 1.0 / 72
    for _ in range(5):
        inputs, state = _random_case(rng, fdtype)
        want = jphys.apply(
            jphys.Inputs(**{k: jnp.asarray(v) for k, v in inputs.items()},
                         time_delta=jnp.asarray(td, fdtype)),
            jphys.PlayerState(**{k: jnp.asarray(v) for k, v in state.items()}))
        got = tphys.apply(
            tphys.Inputs(**{k: t(v) for k, v in inputs.items()},
                         time_delta=torch.tensor(td, dtype=t(inputs["yaw"]).dtype)),
            tphys.PlayerState(**{k: t(v) for k, v in state.items()}))
        for f in PLAYER_FIELDS:
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
            if g.dtype == np.bool_:
                np.testing.assert_array_equal(g, w, err_msg=f)
            else:
                # sin/cos differ by an ulp between libms; z is exact.
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4,
                                           err_msg=f)


def test_parity_mode_promotes_a_0dim_time_delta():
    """A float64 0-dim time_delta promotes float32 velocities as it does in
    JAX (torch would otherwise treat it like a scalar and stay float32)."""
    z = torch.tensor([30.0], dtype=torch.float64)
    td = 0.013888888888888
    vz = torch.tensor([1.7], dtype=torch.float32)
    td64 = torch.tensor(td, dtype=torch.float64)
    state = tphys.PlayerState(z_pos=z, vel_x=vz, vel_y=vz, vel_z=vz,
                              on_ground=torch.tensor([False]),
                              jump_released=torch.tensor([True]))
    zero = torch.zeros(1, dtype=torch.float64)
    got = tphys.apply(tphys.Inputs(yaw=zero, pitch=zero, roll=zero,
                                   fmove=zero, smove=zero,
                                   button2=torch.tensor([False]),
                                   time_delta=td64), state)
    want_vz = np.float32(np.float64(np.float32(1.7)) - 800.0 * td)
    float32_vz = np.float32(1.7) - np.float32(800.0) * np.float32(td)
    assert want_vz != float32_vz  # the case tells the two modes apart
    assert got.vel_z.item() == want_vz
