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


def _jax_state(state):
    return jcore.EnvState(
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


def _replay_through_jax(name, jit):
    """The plain rollout_random at 128 envs x 120 frames, and the JAX
    package's step_autoreset fed its draws frame by frame (under jax.jit
    or eagerly): (port's state, reward sums, done count), (JAX's state,
    reward sums, done count), the config."""
    cfg = probe_configs(dataclasses.replace(CFG, zero_start_prob=0.3))[name]
    jcfg = _jax_cfg(cfg)
    n, steps, seed = 128, 120, 9
    state, _, _ = rollout_inputs(cfg, n, 1, seed, "cpu", near_end=0.5)
    launches = env_rollout.rollout_random.launches
    got = env_rollout.rollout_random(cfg, state, steps, seed=seed)
    assert env_rollout.rollout_random.launches == launches  # no kernel here

    jstate = _jax_state(state)
    jstep = functools.partial(jcore.step_autoreset, jcfg,
                              compute_observation=False)
    if jit:
        jstep = jax.jit(jstep)
    rsum = np.zeros(n, np.float32)
    dones = 0
    for i in range(steps):
        ka, ya, ru = env_rollout.random_frame_inputs(cfg, seed, i, n)
        jstate, out = jstep(jstate, jnp.asarray(ka.numpy()),
                            jnp.asarray(ya.numpy()),
                            reset_uniforms=jnp.asarray(ru.numpy()))
        rsum = rsum + np.asarray(out.reward)
        dones += int(np.asarray(out.done).sum())
    assert int(got[2]) == dones and dones > n // 4
    np.testing.assert_allclose(got[1].numpy(), rsum, rtol=1e-5, atol=1e-3)
    return got[0], jstate, cfg


@pytest.mark.parametrize("name", ["run4", "hover=True", "speed_reward=True"])
def test_rollout_random_replays_through_jax(name):
    """The plain rollout_random's own draws, fed to the JAX package's
    jitted step_autoreset frame by frame, give its reward sums, done count
    and state (rollout-kernel tolerances; sums of 120 rewards to 1e-3).

    Two allowances are the jitted step's: 120 frames of yaw carry a few
    ulps (see assert_env_state_close), and the episode clock one ulp of
    time_limit, because XLA on the CPU fuses the reset's ``time_limit +
    (1 - time_limit) * u_time`` into one multiply-add for some draws
    (test_jitted_reset_fuses_the_time_draw); the decrement by time_delta
    then carries that ulp down towards 0."""
    got, jstate, cfg = _replay_through_jax(name, jit=True)
    assert_env_state_close(got, jstate, yaw_atol=2e-4, time_atol=float(
        np.spacing(np.float32(cfg.time_limit))))


@pytest.mark.parametrize("name", ["run4", "hover=True", "speed_reward=True"])
def test_rollout_random_replays_through_eager_jax(name):
    """As test_rollout_random_replays_through_jax with the JAX step run
    eagerly, as written: it divides the mouse step and rounds the reset's
    product before its add as the port does, so the state needs neither of
    the jitted step's allowances."""
    got, jstate, _ = _replay_through_jax(name, jit=False)
    assert_env_state_close(got, jstate)


def test_jitted_reset_fuses_the_time_draw():
    """Why the jitted replay allows an ulp of time_limit: on the CPU, XLA
    fuses reset_from_uniforms' ``time_limit + (1 - time_limit) * u_time``
    into one multiply-add rounded once, while the eager package (and the
    port) round the product and then the sum.  On 24-bit uniforms, some
    draws disagree, each by one ulp of time_limit at most (the product's
    rounding); the eager result is the two roundings, and the jitted one the
    exact value rounded once."""
    jcfg = _jax_cfg(CFG)
    rng = np.random.default_rng(4)
    u_time = ((rng.integers(0, 1 << 24, 4096) * 2.0 ** -24)
              .astype(np.float32))
    zeros = jnp.full(u_time.shape, 0.5, jnp.float32)  # never a zero start
    reset = functools.partial(jcore.reset_from_uniforms, jcfg)
    args = (zeros, zeros, jnp.asarray(u_time), zeros, zeros)
    eager = np.asarray(reset(*args).time_remaining)
    jitted = np.asarray(jax.jit(reset)(*args).time_remaining)
    limit, span = np.float32(CFG.time_limit), np.float32(1.0 - CFG.time_limit)
    np.testing.assert_array_equal(eager, limit + span * u_time)
    once = (np.float64(limit) + np.float64(span) * u_time.astype(np.float64)
            ).astype(np.float32)  # the product is exact in float64
    np.testing.assert_array_equal(jitted, once)
    differ = eager != jitted
    assert differ.any()
    assert np.all(np.abs(eager - jitted) <= np.spacing(limit))


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


# --- the draw layout: FRAMES_PER_DRAW frames of actions per Philox call ---


def _layout_draws(cfg, seed, t, n):
    """Frame t's keys, yaw and reset uniforms for envs 0..n-1, from the
    layout as the kernel's note states it, on Python ints: counter
    (i, t // F, 0, 0) for the actions (key j of frame f in bit 4f + j of
    word x, the yaw in word 1 + f), counter (i, t, 1, 0) for the reset."""
    frames = env_rollout.FRAMES_PER_DRAW
    call, f = divmod(t, frames)
    keys = np.zeros((cfg.num_keys, n), np.int32)
    yaw = np.zeros(n, np.float32)
    resets = np.zeros((5, n), np.float32)
    for i in range(n):
        w = _philox_python((i, call, 0, 0), (seed, 0))
        for j in range(cfg.num_keys):
            keys[j, i] = (w[0] >> (4 * f + j)) & 1
        u = np.float32((w[1 + f] >> 8) * 2.0 ** -24)
        yaw[i] = (u * np.float32(2) - np.float32(1)) * np.float32(
            cfg.action_range)
        r = _philox_python((i, t, 1, 0), (seed, 0))
        resets[:4, i] = [(x >> 8) * 2.0 ** -24 for x in r]
        resets[4, i] = ((r[0] & 0xFF) << 16 | (r[1] & 0xFF) << 8
                        | (r[2] & 0xFF)) * 2.0 ** -24
    return keys, yaw, resets


@pytest.mark.parametrize("t", [0, 1, 2, 3, 7, 8, 719])
def test_random_frame_inputs_follow_the_layout(t):
    """Each frame's draws are the bits the layout names, recomputed from
    Philox4x32-10 on Python ints, in each position of its call."""
    cfg = dataclasses.replace(CFG, num_envs=None)
    for seed in (0, 0xDEADBEEF):
        ka, ya, ru = env_rollout.random_frame_inputs(cfg, seed, t, 40)
        keys, yaw, resets = _layout_draws(cfg, seed, t, 40)
        np.testing.assert_array_equal(ka.numpy(), keys)
        np.testing.assert_array_equal(ya.numpy(), yaw)
        np.testing.assert_array_equal(ru.numpy(), resets)


def test_uniform_from_low_bytes_is_exact():
    """The fifth reset uniform: the three low bytes as one 24-bit integer,
    times 2^-24, with no rounding, inside [0, 1)."""
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, (3, 5000), dtype=np.int64)
    words[:, 0] = 0xFFFFFFFF
    words[:, 1] = 0xFFFFFF00
    got = env_rollout.uniform_from_low_bytes(
        *torch.from_numpy(words)).numpy()
    a, b, c = (words & 0xFF)
    want = ((a << 16) | (b << 8) | c) / 2.0 ** 24
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.astype(np.float64), want)
    assert got[0] == (2 ** 24 - 1) / 2 ** 24 and got[1] == 0.0
    assert got.min() >= 0 and got.max() < 1


@pytest.mark.parametrize("steps", [8, 9])
def test_rollout_random_plain_replays_the_layout(steps):
    """rollout_random at a T that is not a multiple of the frames per call
    (8) and at an odd T (9): a loop of step_autoreset on the layout's
    draws, recomputed by hand, gives its state, reward sums and done
    count exactly."""
    cfg = dataclasses.replace(CFG, zero_start_prob=0.3)
    n, seed = 48, 21
    state, _, _ = rollout_inputs(cfg, n, 1, 5, "cpu", near_end=1.0)
    state.time_remaining = state.time_remaining * 0.05  # ends inside T
    got_state, reward_sum, done_count = env_rollout.rollout_random(
        cfg, state, steps, seed=seed)
    want = state
    rsum = torch.zeros(n)
    dones = 0
    for t in range(steps):
        ka, ya, ru = (torch.from_numpy(x) for x in
                      _layout_draws(cfg, seed, t, n))
        want, out = tcore.step_autoreset(cfg, want, ka, ya,
                                         compute_observation=False,
                                         reset_uniforms=ru)
        rsum = rsum + out.reward
        dones += int(out.done.sum())
    assert int(done_count) == dones > 0
    assert torch.equal(reward_sum, rsum)
    for f in ("z_pos", "vel_x", "vel_y", "vel_z", "on_ground",
              "jump_released"):
        assert torch.equal(getattr(got_state.player, f),
                           getattr(want.player, f)), f
    for f in ("yaw", "time_remaining", "zero_start", "last_keys",
              "last_key_press_time"):
        assert torch.equal(getattr(got_state, f), getattr(want, f)), f


def test_layout_statistics():
    """Over 60,000 envs: each of the five reset uniforms and the keys of
    each frame position of a call keep their means within 5 standard errors
    of 0.5, and the keys of frames 3m and 3m+1, which share word x, are
    uncorrelated within 5 standard errors of 0 (1 / sqrt(n))."""
    n = 60_000
    cfg = dataclasses.replace(CFG, num_envs=None)
    draws = [env_rollout.random_frame_inputs(cfg, 77, t, n)
             for t in range(3)]
    se_u, se_k = np.sqrt(1 / 12 / n), 0.5 / np.sqrt(n)
    for _, _, ru in draws:
        assert np.all(np.abs(ru.double().mean(dim=1).numpy() - 0.5)
                      < 5 * se_u), ru.mean(dim=1)
    for ka, _, _ in draws:
        assert np.all(np.abs(ka.double().mean(dim=1).numpy() - 0.5)
                      < 5 * se_k), ka.double().mean(dim=1)
    for j in range(cfg.num_keys):
        a, b = draws[0][0][j].double(), draws[1][0][j].double()
        corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
        assert abs(corr) < 5 / np.sqrt(n), (j, corr)
