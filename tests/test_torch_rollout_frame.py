"""The PPO rollout's fused frame on the CPU: the plain version of
``rollout_actions_autoreset``'s decoded form
(``rollout_autoreset_sampled_plain``) held to the composed frame it stands
for, to the bit, solo and for a population; the wrapper's in-place writes
and argument checks; and the loop's choice of frame with its counters.  On
a card the kernel is held to the plain version, and the fused rollout to
the composed one (``tests/test_torch_cuda.py``)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from q1physrl_torch.algo import population, ppo
from q1physrl_torch.algo.config import PPOConfig, load_run_config
from q1physrl_torch.env import core
from q1physrl_torch.models import Policy
from q1physrl_torch.models.distributions import draw
from q1physrl_torch.models.policy import StackedPolicy, action_dist
from q1physrl_torch.ops import env_rollout
from q1physrl_torch.parallel.mesh import EnvShard
from q1physrl_torch.utils import profiling

from chip_smoke import autoreset_frame_inputs, rollout_inputs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN4 = dataclasses.replace(
    load_run_config(str(ROOT / "configs" / "run4.yml")).env, num_envs=None,
    zero_start_prob=0.3)
# K=4 (run4) and K=3 (no jump key); a third of the resets zero-start.
CONFIGS = {4: RUN4, 3: dataclasses.replace(RUN4, allow_jump=False)}
FRAMES = 12


def _policy(cfg, members, seed):
    """Seeded towers (stacked for members > 1) whose logits reach past the
    yaw's clamps and give both values of each key."""
    policies = []
    for i in range(members):
        policy = Policy(cfg, torch.Generator().manual_seed(seed + i),
                        device="cpu")
        with torch.no_grad():
            policy.pi.layers[-1].weight.mul_(400.0)
        policies.append(policy)
    if members == 1:
        return policies[0]
    return StackedPolicy.from_policies(cfg, policies)


def _start(cfg, members, per, seed):
    """A state whose episodes end within the frames, live episodes with
    returns and lengths, and the members' generators."""
    n = members * per
    state, _, _ = rollout_inputs(cfg, n, 1, seed, "cpu", near_end=0.5)
    rng = np.random.default_rng(seed)
    stats = ppo.EpisodeStats.zeros(
        n, ep_return=torch.tensor(rng.normal(0.0, 100.0, n),
                                  dtype=torch.float32),
        ep_len=torch.tensor(rng.integers(0, 500, n), dtype=torch.int32),
        members=None if members == 1 else members)
    generators = tuple(torch.Generator().manual_seed(seed * 10 + i)
                       for i in range(members))
    return state, stats, generators


def _composed_frame(cfg, policy, state, stats, generators):
    """One frame of ``ppo.RolloutLoop``'s composed frame, unsharded."""
    generator = generators if len(generators) > 1 else generators[0]
    n = state.num_envs
    obs = core.compute_obs(cfg, state.player, state.yaw,
                           state.time_remaining).to(torch.float32)
    logits, value = policy(obs)
    dist = action_dist(cfg, logits)
    ka, ya = dist.sample(generator)
    logp = dist.logp(ka, ya)
    ru = draw(torch.rand, (5, n), generator, 1, dtype=torch.float32)
    zero_start = state.zero_start
    state, rewards, dones = env_rollout.rollout_actions_autoreset(
        cfg, state, ka[None], ya[None], ru[None])
    stats = stats.update(rewards[0], dones[0], zero_start)
    return state, stats, (obs, ka, ya, logits, logp, value, rewards[0],
                          dones[0], ru)


def _draws(cfg, generators, n):
    """The fused frame's draws: each member's K key uniforms, its yaw
    normals and its reset uniforms, from its own generator, into its
    blocks."""
    members = len(generators)
    per = n // members
    uniforms = torch.empty((members, cfg.num_keys, per, 2))
    normals = torch.empty(n)
    ru = torch.empty((members, 5, per))
    for m, g in enumerate(generators):
        for u in uniforms[m]:
            torch.rand(u.shape, generator=g, out=u)
        torch.randn((per,), generator=g, out=normals[m * per:(m + 1) * per])
        torch.rand((5, per), generator=g, out=ru[m])
    return uniforms, normals, ru


def _assert_states_equal(got, want):
    for x, y in zip(got.leaves(), want.leaves()):
        assert torch.equal(x, y)


def _assert_stats_equal(got, want):
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), \
            f.name


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("per", [1, 7, 64])
@pytest.mark.parametrize("members", [1, 3])
@pytest.mark.parametrize("k", [3, 4])
def test_plain_version_equals_the_composed_frame(k, members, per, seed):
    """Twelve frames from a state with episodes ending inside, solo and for
    3 members with distinct generators: state, every record field (logp
    among them), the episode statistics and the next observation to the
    bit, and every generator left where the composed frames leave it."""
    cfg = CONFIGS[k]
    policy = _policy(cfg, members, seed)
    state, stats, generators = _start(cfg, members, per, seed)
    want = (state, stats)
    plain_gens = tuple(torch.Generator().manual_seed(seed * 10 + i)
                       for i in range(members))
    got_state, got_stats = state.clone(), stats.clone()
    obs = core.compute_obs(cfg, state.player, state.yaw, state.time_remaining)
    dones = 0
    with torch.no_grad():
        for _ in range(FRAMES):
            *want, want_row = _composed_frame(cfg, policy, *want, generators)
            logits, value = policy(obs)
            got_state, row, ep_return, ep_len, terms, obs = (
                env_rollout.rollout_autoreset_sampled_plain(
                    cfg, got_state, logits, value,
                    *_draws(cfg, plain_gens, state.num_envs), obs,
                    got_stats.ep_return, got_stats.ep_len))
            got_stats = ppo.EpisodeStats(ep_return=ep_return, ep_len=ep_len,
                                         **got_stats.accumulated(terms))
            _assert_states_equal(got_state, want[0])
            _assert_stats_equal(got_stats, want[1])
            for name, x, y in zip(env_rollout.RECORD_FIELDS, row, want_row):
                assert x.dtype == y.dtype and torch.equal(_bits(x),
                                                          _bits(y)), name
            assert torch.equal(obs, core.compute_obs(
                cfg, want[0].player, want[0].yaw, want[0].time_remaining))
            dones += int(want_row[7].sum())
    for g, g0 in zip(plain_gens, generators):
        assert torch.equal(g.get_state(), g0.get_state())
    if per == 64:
        assert dones > 0 and float(want[1].finished.sum()) == dones


def _loops(cfg, pc, members, seed):
    """The composed and the fused rollout loop (the fused one on the CPU
    runs the plain version) on equal starts."""
    runs = []
    for fused in (False, True):
        if members == 1:
            ts = ppo.init_train_state(seed, cfg, pc, "cpu")
            ts.env_state.time_remaining = ts.env_state.time_remaining * 0.05
            loop = ppo.RolloutLoop(cfg, pc, ts.policy, ts.generator,
                                   pc.num_envs, "cpu", fused=fused)
            runs.append((loop, ts.env_state, ts.stats, (ts.generator,)))
        else:
            ps = population.init_population(
                range(seed, seed + members), cfg, pc, "cpu")
            ps.env_state.time_remaining = ps.env_state.time_remaining * 0.05
            loop = population.PopulationRolloutLoop(
                cfg, pc, ps.policy, ps.generators, "cpu", fused=fused)
            runs.append((loop, ps.env_state, ps.stats, ps.generators))
    return runs


def _assert_rollouts_equal(got, want):
    (s1, st1, tr1, b1, g1), (s0, st0, tr0, b0, g0) = got, want
    _assert_states_equal(s1, s0)
    _assert_stats_equal(st1, st0)
    for name in tr0._fields:
        assert torch.equal(getattr(tr1, name), getattr(tr0, name)), name
    assert torch.equal(b1, b0)
    assert all(torch.equal(x, y) for x, y in zip(g1, g0))


@pytest.mark.parametrize("members", [1, 3])
@pytest.mark.parametrize("k", [3, 4])
def test_fused_loop_equals_the_composed_loop(k, members):
    """Whole rollouts of the two frames, twice on each kept loop (the
    second from the first's end): trajectory, final state, statistics,
    bootstrap value and generators to the bit; the index, the draws into
    static buffers and the statistics' sums in place as the card runs
    them."""
    cfg = CONFIGS[k]
    pc = PPOConfig(num_envs=32, rollout_length=10, num_sgd_iter=1,
                   sgd_minibatch_size=32)
    (loop0, state0, stats0, g0), (loop1, state1, stats1, g1) = _loops(
        cfg, pc, members, 4)
    for _ in range(2):
        want = loop0.rollout(state0, stats0) + ([g.get_state() for g in g0],)
        got = loop1.rollout(state1, stats1) + ([g.get_state() for g in g1],)
        _assert_rollouts_equal(got, want)
        assert bool(want[2].done.any())
        (state0, stats0), (state1, stats1) = want[:2], got[:2]


@pytest.mark.parametrize("members", [1, 4])
@pytest.mark.parametrize("k", [3, 4])
def test_wrapper_on_the_cpu_writes_the_plain_version_in_place(k, members):
    cfg = CONFIGS[k]
    n, t = 100 if members == 1 else 96, 5
    state, inputs, outputs = autoreset_frame_inputs(cfg, n, members, t, 7,
                                                    "cpu")
    want = env_rollout.rollout_autoreset_sampled_plain(
        cfg, state.clone(), **{k_: v.clone() for k_, v in inputs.items()})
    got = env_rollout.rollout_autoreset_sampled(cfg, state, **inputs,
                                                **outputs)
    written = (state, outputs["record"], inputs["ep_return"],
               inputs["ep_len"], outputs["terms"], inputs["obs"])
    assert all(g is w for g, w in zip(got, written))
    _assert_states_equal(state, want[0])
    row = t - 2
    for name, buf, x in zip(env_rollout.RECORD_FIELDS, outputs["record"],
                            want[1]):
        assert torch.equal(buf[row], x), name
        assert not buf[row + 1].any() and not buf[:row].any(), name
    for x, y in zip((inputs["ep_return"], inputs["ep_len"],
                     *outputs["terms"], inputs["obs"]), want[2:4]
                    + tuple(want[4]) + (want[5],)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("change,error", [
    (dict(logits=torch.zeros((8, 9))), "logits"),
    (dict(value=torch.zeros((8, 1))), "value"),
    (dict(uniforms=torch.zeros((4, 2, 2))), "uniforms"),
    (dict(uniforms=torch.zeros((3, 4, 2, 2))), "uniforms"),
    (dict(uniforms=torch.zeros((2, 4, 4, 2), dtype=torch.float64)),
     "uniforms"),
    (dict(reset_uniforms=torch.zeros((1, 5, 8))), "reset_uniforms"),
    (dict(obs=torch.zeros((8, 6))[:, :5]), "obs"),
    (dict(index=torch.zeros(1, dtype=torch.int32)), "index"),
    (dict(ep_len=torch.zeros(8)), "ep_len"),
    (dict(terms=(torch.zeros(8),) * 5), "terms"),
    (dict(terms=(torch.zeros(8),) * 5 + (torch.zeros(7),)), "zs_ret_sum"),
    (dict(record="short"), "record"),
    (dict(record="done"), "record done"),
    (dict(cfg=dataclasses.replace(RUN4, discrete_yaw_steps=3)),
     "continuous"),
])
def test_wrapper_rejects_bad_arguments(change, error):
    state, inputs, outputs = autoreset_frame_inputs(RUN4, 8, 2, 3, 0, "cpu")
    args = dict(cfg=RUN4, state=state, **inputs, **outputs)
    if change.get("record") == "short":
        change = dict(record=outputs["record"][:-1])
    elif change.get("record") == "done":
        record = list(outputs["record"])
        record[7] = torch.zeros(record[7].shape, dtype=torch.float32)
        change = dict(record=tuple(record))
    args.update(change)
    with pytest.raises(ValueError, match=error):
        env_rollout.rollout_autoreset_sampled(**args)


def test_the_record_is_the_trajectory():
    assert env_rollout.RECORD_FIELDS == ppo.Trajectory._fields
    assert set(env_rollout.EPISODE_TERMS) < {
        f.name for f in dataclasses.fields(ppo.EpisodeStats)}


# --- the loop's choice of frame -----------------------------------------------


def _fallbacks():
    """Each case the composed frame keeps: (policy, config, shard)."""
    discrete = dataclasses.replace(RUN4, discrete_yaw_steps=2)
    no_yaw = dataclasses.replace(RUN4, allow_yaw=False)
    return {
        "discrete yaw": (Policy(discrete, device="cpu"), discrete, None),
        "no yaw": (Policy(no_yaw, device="cpu"), no_yaw, None),
        "float64 policy": (Policy(RUN4, device="cpu").double(), RUN4, None),
        "shard": (Policy(RUN4, device="cpu"), RUN4, EnvShard(0, 2, 4)),
    }


@pytest.mark.parametrize("case", list(_fallbacks()) + ["process group"])
def test_the_composed_frame_stays_where_the_fused_one_does_not_apply(
        case, monkeypatch):
    """Discrete or absent yaw, a float64 policy, a shard and a process
    group keep the composed frame even on a card; a Policy or a
    StackedPolicy with a continuous yaw takes the fused one there, K=3 and
    K=4; the CPU always keeps the composed."""
    cuda = torch.device("cuda")
    if case == "process group":
        monkeypatch.setattr(ppo.distributed, "is_initialized", lambda: True)
        policy, cfg, shard = Policy(RUN4, device="cpu"), RUN4, None
    else:
        policy, cfg, shard = _fallbacks()[case]
    assert not ppo._takes_fused_rollout(policy, cfg, shard, cuda)
    for k, c in CONFIGS.items():
        for p in (Policy(c, device="cpu"), StackedPolicy(c, 3, "cpu")):
            if case != "process group":
                assert ppo._takes_fused_rollout(p, c, None, cuda), k
            assert not ppo._takes_fused_rollout(p, c, None, "cpu"), k


def _counted(fn):
    before = profiling.counters()
    fn()
    after = profiling.counters()
    return {name: after.get(name, 0) - before.get(name, 0)
            for name in ("ppo.fused_frames", "ppo.composed_frames")}


@pytest.mark.parametrize("case", ["cpu", "shard", "discrete yaw",
                                  "population"])
def test_rollout_counts_its_composed_frames(case):
    """Every frame of a rollout on the composed frame is counted in
    ``ppo.composed_frames``, none in ``ppo.fused_frames``."""
    cfg = (dataclasses.replace(RUN4, discrete_yaw_steps=2)
           if case == "discrete yaw" else RUN4)
    pc = PPOConfig(num_envs=16, rollout_length=6, num_sgd_iter=1,
                   sgd_minibatch_size=16)
    if case == "population":
        ps = population.init_population((1, 2), cfg, pc, "cpu")
        run = lambda: population.rollout(cfg, pc, ps.policy, ps.env_state,
                                         ps.stats, ps.generators)
        frames = pc.rollout_length
    else:
        ts = ppo.init_train_state(1, cfg, pc, "cpu")
        shard = EnvShard(1, 2, 16) if case == "shard" else None
        state, stats = ts.env_state, ts.stats
        if shard is not None:
            from q1physrl_torch.parallel.mesh import shard_env_axis
            state, stats = (shard_env_axis(state, shard),
                            shard_env_axis(stats, shard))
        run = lambda: ppo.rollout(cfg, pc, ts.policy, state, stats,
                                  ts.generator, shard)
        frames = pc.rollout_length
    assert _counted(run) == {"ppo.fused_frames": 0,
                             "ppo.composed_frames": frames}


@pytest.mark.parametrize("members", [1, 2])
def test_a_rollout_that_takes_the_fused_frame_counts_it(members, monkeypatch):
    """With the fused frame taken (forced here, where the wrapper runs the
    plain version), ``ppo.rollout`` and ``population.rollout`` keep a loop
    of their own for it, give the composed frame's bits and count their
    frames in ``ppo.fused_frames``."""
    pc = PPOConfig(num_envs=16, rollout_length=6, num_sgd_iter=1,
                   sgd_minibatch_size=16)
    outs = {}
    for fused in (False, True):
        monkeypatch.setattr(ppo, "_takes_fused_rollout",
                            lambda *args, fused=fused: fused)
        if members == 1:
            ts = ppo.init_train_state(2, RUN4, pc, "cpu")
            run = lambda: ppo.rollout(RUN4, pc, ts.policy, ts.env_state,
                                      ts.stats, ts.generator)
            loops = ppo._LOOPS
        else:
            ps = population.init_population((2, 3), RUN4, pc, "cpu")
            run = lambda: population.rollout(RUN4, pc, ps.policy,
                                             ps.env_state, ps.stats,
                                             ps.generators)
            loops = population._LOOPS
        counted = _counted(lambda: outs.__setitem__(fused, run()))
        frames = pc.rollout_length
        assert counted == {"ppo.fused_frames": frames if fused else 0,
                           "ppo.composed_frames": 0 if fused else frames}
        assert next(reversed(loops.loops.values())).fused == fused
    (s0, st0, tr0, b0), (s1, st1, tr1, b1) = outs[False], outs[True]
    _assert_states_equal(s1, s0)
    _assert_stats_equal(st1, st0)
    for name in tr0._fields:
        assert torch.equal(getattr(tr1, name), getattr(tr0, name)), name
    assert torch.equal(b1, b0)
