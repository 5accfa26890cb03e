"""The port's rollout_random on the CPU (its plain version): its Philox
against the published known answers, its uniforms against the JAX
package's conversion, its draws replayed through the JAX package's
step_autoreset, its statistics against an XLA scan of random actions (as
scripts/tpu_checks.py:98 checks the Pallas kernel), and the share of
zero-start resets.  The CUDA kernel is held against this plain version on
the card by chip_smoke.py and tests/test_torch_cuda.py."""

import dataclasses
import functools

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
from q1physrl_tpu.ops.env_rollout_pallas import _uniform_from_bits

from _torch_common import (assert_env_state_close, env_state_from_jax,
                           probe_configs)
from chip_smoke import rollout_inputs

torch.set_num_threads(1)

CFG = dataclasses.replace(TConfig.get_default(), num_envs=None)


def _jax_cfg(cfg):
    return jenv.Config(**dataclasses.asdict(cfg))


# Philox4x32-10 known answers (Random123's kat_vectors): counter, key,
# output.
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answers(case):
    counter, key, want = KAT[case]
    got = env_rollout.philox4x32_10(
        *(torch.tensor([c], dtype=torch.int64) for c in counter), *key)
    assert tuple(int(x) for x in got) == want


def _philox_python(c, k):
    """Philox4x32-10 on Python ints, written from its definition."""
    m0, m1, w0, w1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
    mask = 0xFFFFFFFF
    c, k = [int(x) for x in c], [int(x) for x in k]
    for r in range(10):
        if r:
            k = [(k[0] + w0) & mask, (k[1] + w1) & mask]
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & mask, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & mask]
    return tuple(c)


def test_philox_matches_python_ints_on_random_counters():
    """The 16-bit-half products against Python's exact integers, on
    counters that reach every bit."""
    rng = np.random.default_rng(0)
    c = rng.integers(0, 1 << 32, (4, 300), dtype=np.int64)
    key = (int(rng.integers(1 << 32)), int(rng.integers(1 << 32)))
    got = env_rollout.philox4x32_10(*torch.from_numpy(c), *key)
    got = torch.stack(got).numpy()
    for j in range(c.shape[1]):
        assert tuple(got[:, j]) == _philox_python(c[:, j], key)


def test_uniform_from_bits_matches_jax():
    """The same 24 bits as the JAX package's conversion of the same words
    read as int32, and inside [0, 1)."""
    rng = np.random.default_rng(1)
    bits = np.concatenate([rng.integers(0, 1 << 32, 10000, dtype=np.int64),
                           [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]])
    got = env_rollout.uniform_from_bits(torch.from_numpy(bits)).numpy()
    want = np.asarray(_uniform_from_bits(jnp.asarray(
        bits.astype(np.uint32).view(np.int32))))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.min() >= 0 and got.max() < 1


def test_random_frame_inputs_shapes_and_spread():
    ka, ya, ru = env_rollout.random_frame_inputs(CFG, 5, 3, 20000)
    assert ka.shape == (CFG.num_keys, 20000) and ka.dtype == torch.int32
    assert ya.shape == (20000,) and ya.dtype == torch.float32
    assert ru.shape == (5, 20000) and ru.dtype == torch.float32
    # Bernoulli(0.5) keys, yaw uniform on +-action_range, uniform resets:
    # each within 5 standard errors.
    assert abs(float(ka.float().mean()) - 0.5) < 5 * 0.5 / np.sqrt(80000)
    assert float(ya.abs().max()) <= CFG.action_range
    assert abs(float(ya.mean())) < 5 * CFG.action_range / np.sqrt(3 * 20000)
    se = np.sqrt(1 / 12 / 20000)
    assert np.all(np.abs(ru.mean(dim=1).numpy() - 0.5) < 5 * se)
    a = env_rollout.random_frame_inputs(CFG, 5, 4, 100)
    b = env_rollout.random_frame_inputs(CFG, 6, 3, 100)
    c = env_rollout.random_frame_inputs(CFG, 5, 3, 100)
    assert not torch.equal(a[1], c[1]) and not torch.equal(b[1], c[1])
    assert torch.equal(c[1], ya[:100])  # env i's draws do not depend on N


@pytest.mark.parametrize("name", ["run4", "hover=True", "speed_reward=True"])
def test_rollout_random_replays_through_jax(name):
    """The plain rollout_random's own draws, fed to the JAX package's
    step_autoreset frame by frame, give its reward sums, done count and
    state (rollout-kernel tolerances; sums of 120 rewards to 1e-3)."""
    cfg = probe_configs(dataclasses.replace(CFG, zero_start_prob=0.3))[name]
    jcfg = _jax_cfg(cfg)
    n, steps, seed = 128, 120, 9
    state, _, _ = rollout_inputs(cfg, n, 1, seed, "cpu", near_end=0.5)
    launches = env_rollout.rollout_random.launches
    got_state, reward_sum, done_count = env_rollout.rollout_random(
        cfg, state, steps, seed=seed)
    assert env_rollout.rollout_random.launches == launches  # no kernel here

    jstate = jcore.EnvState(
        player=jcore.phys.PlayerState(**{
            f: jnp.asarray(getattr(state.player, f).numpy())
            for f in ("z_pos", "vel_x", "vel_y", "vel_z", "on_ground",
                      "jump_released")}),
        yaw=jnp.asarray(state.yaw.numpy()),
        time_remaining=jnp.asarray(state.time_remaining.numpy()),
        zero_start=jnp.asarray(state.zero_start.numpy()),
        last_keys=jnp.asarray(state.last_keys.numpy()),
        last_key_press_time=jnp.asarray(state.last_key_press_time.numpy()),
        rng=None)
    jstep = jax.jit(functools.partial(jcore.step_autoreset, jcfg,
                                      compute_observation=False))
    rsum = np.zeros(n, np.float32)
    dones = 0
    for i in range(steps):
        ka, ya, ru = env_rollout.random_frame_inputs(cfg, seed, i, n)
        jstate, out = jstep(jstate, jnp.asarray(ka.numpy()),
                            jnp.asarray(ya.numpy()),
                            reset_uniforms=jnp.asarray(ru.numpy()))
        rsum = rsum + np.asarray(out.reward)
        dones += int(np.asarray(out.done).sum())
    assert int(done_count) == dones and dones > n // 4
    np.testing.assert_allclose(reward_sum.numpy(), rsum, rtol=1e-5,
                               atol=1e-3)
    # 120 frames: a few ulps of yaw (see assert_env_state_close).
    assert_env_state_close(got_state, jstate, yaw_atol=2e-4)


def test_rollout_random_statistics_match_xla_scan():
    """scripts/tpu_checks.py:98 at a CPU size: the plain rollout_random and
    a jitted JAX scan of step_autoreset with jax.random actions, from one
    start state, over 720 frames (10 s: every env ends an episode).  The
    two draw different numbers, so they agree in distribution: dones per
    env within 2% (their spread across seeds is under 1%), and the mean
    reward per env within 5 standard errors of the difference (per-env
    sums spread by about 385, so 4,096 envs leave a standard error near 8;
    the chip check's 65,536 envs allow its fixed 5.0)."""
    n, steps = 4096, 720
    jcfg = _jax_cfg(CFG)
    state = jcore.reset(jcfg, jax.random.key(0), n, jnp.float32)
    key0 = jax.random.key(9)

    def body(st, x):
        kk, ky = jax.random.split(jax.random.fold_in(key0, x))
        ka = jax.random.bernoulli(kk, 0.5, (CFG.num_keys, n)).astype(
            jnp.int32)
        ya = jax.random.uniform(ky, (n,), jnp.float32, -CFG.action_range,
                                CFG.action_range)
        st, o = jcore.step_autoreset(jcfg, st, ka, ya,
                                     compute_observation=False)
        return st, (o.reward, o.done.sum())

    _, (r_x, d_x) = jax.jit(
        lambda s: jax.lax.scan(body, s, jnp.arange(steps)))(state)
    _, reward_sum, done_count = env_rollout.rollout_random(
        CFG, env_state_from_jax(state), steps, seed=3)
    r_x = np.asarray(r_x).sum(axis=0)
    r_p = reward_sum.numpy()
    done_p, done_x = int(done_count) / n, float(d_x.sum()) / n
    assert abs(done_p - done_x) < 0.02 * done_x, (done_p, done_x)
    assert done_p > 1.0
    se = np.sqrt((r_p.var() + r_x.var()) / n)
    assert abs(r_p.mean() - r_x.mean()) < 5 * se, (r_p.mean(), r_x.mean(),
                                                    se)


def test_zero_start_share_of_resets():
    """Every env ends on the first frame and re-draws once, from its own
    uniforms: the zero-start share must lie within 5 standard errors of
    zero_start_prob (the unsigned-bits check: a sign fault once made 51%
    of resets zero-starts)."""
    n = 100_000
    for p in (0.01, 0.3):
        cfg = dataclasses.replace(CFG, zero_start_prob=p)
        state = tcore.reset(cfg, torch.Generator().manual_seed(0), n,
                            device="cpu")
        state.time_remaining = torch.zeros(n)
        new, _, done_count = env_rollout.rollout_random(cfg, state, 1,
                                                        seed=11)
        assert int(done_count) == n
        share = float(new.zero_start.float().mean())
        assert abs(share - p) < 5 * np.sqrt(p * (1 - p) / n), (p, share)


def test_rollout_random_is_seeded_and_checks_arguments():
    state, _, _ = rollout_inputs(CFG, 64, 1, 0, "cpu", near_end=1.0)
    a = env_rollout.rollout_random(CFG, state, 80, seed=1)
    b = env_rollout.rollout_random(CFG, state, 80, seed=1)
    c = env_rollout.rollout_random(CFG, state, 80, seed=2)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0].yaw, b[0].yaw)
    assert not torch.equal(a[1], c[1])
    assert a[1].dtype == torch.float32 and a[2].dim() == 0
    with pytest.raises(ValueError):
        env_rollout.rollout_random(CFG, state, 0)
    with pytest.raises(ValueError):
        env_rollout.rollout_random(
            CFG, dataclasses.replace(state, yaw=state.yaw.double()), 4)
    with pytest.raises(ValueError):  # two key latches for four keys
        env_rollout.rollout_random(
            CFG, dataclasses.replace(state, last_keys=state.last_keys[:2]), 4)
