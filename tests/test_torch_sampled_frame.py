"""The scoring loop's fused frame on the CPU: the plain version of
``rollout_actions``' decoded form (``rollout_actions_sampled_plain``) held
to the composed frame it stands for, to the bit, and the loop's choice of
frame with its counters.  On a card the kernel is held to the plain
version, and the fused loop to the composed one
(``tests/test_torch_cuda.py``)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from q1physrl_torch import analyse
from q1physrl_torch.algo.config import load_run_config
from q1physrl_torch.env import core
from q1physrl_torch.models import Policy
from q1physrl_torch.ops import env_rollout
from q1physrl_torch.parallel.mesh import EnvShard
from q1physrl_torch.utils import profiling

from chip_smoke import rollout_inputs, sampled_frame_inputs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN4 = load_run_config(str(ROOT / "configs" / "run4.yml")).env
# K=4 (run4) and K=3 (no jump key).
CONFIGS = {4: RUN4, 3: dataclasses.replace(RUN4, allow_jump=False)}
FRAMES = 12


def _policy(cfg, seed):
    """A seeded policy whose logits reach past the yaw's clamps and give
    both values of each key."""
    policy = Policy(cfg, torch.Generator().manual_seed(seed), device="cpu")
    with torch.no_grad():
        policy.pi.layers[-1].weight.mul_(400.0)
    return policy


def _composed_frame(cfg, state, ret, alive, policy_fn, generator):
    """One frame of ``analyse._ZeroStartLoop``'s composed frame."""
    obs = core.compute_obs(cfg, state.player, state.yaw, state.time_remaining)
    ka, ya = policy_fn(obs, generator)
    state, rewards, dones = env_rollout.rollout_actions(
        cfg, state, ka.unsqueeze(0), ya.unsqueeze(0))
    return state, ret + rewards[0] * alive, alive & ~dones[0]


def _assert_same(got, want):
    (state, ret, alive), (state0, ret0, alive0) = got, want
    for x, y in zip(state.leaves(), state0.leaves()):
        assert torch.equal(x, y)
    assert torch.equal(ret, ret0)
    assert torch.equal(alive, alive0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 7, 512])
@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("deterministic", [False, True])
def test_plain_version_equals_the_composed_frame(deterministic, k, n, seed):
    """Twelve frames from a state with episodes ending inside: state,
    returns, alive flags and the next observation to the bit, and the
    generator left where the composed frames leave it."""
    cfg = CONFIGS[k]
    policy = _policy(cfg, seed)
    policy_fn = analyse._policy_from(policy, cfg, deterministic)
    state, _, _ = rollout_inputs(cfg, n, 1, seed, "cpu", near_end=0.5)
    rng = np.random.default_rng(seed)
    ret = torch.tensor(rng.normal(0.0, 100.0, n), dtype=torch.float32)
    alive = torch.tensor(rng.random(n) < 0.8)
    want = (state, ret, alive)
    got = (state.clone(), ret.clone(), alive.clone())
    composed_gen = torch.Generator().manual_seed(seed)
    plain_gen = torch.Generator().manual_seed(seed)
    obs = core.compute_obs(cfg, state.player, state.yaw, state.time_remaining)
    with torch.inference_mode():
        for _ in range(FRAMES):
            want = _composed_frame(cfg, *want, policy_fn, composed_gen)
            uniforms = normals = None
            if not deterministic:
                uniforms = torch.stack([torch.rand((n, 2),
                                                   generator=plain_gen)
                                        for _ in range(k)])
                normals = torch.randn((n,), generator=plain_gen)
            *got, obs = env_rollout.rollout_actions_sampled_plain(
                cfg, got[0], policy.pi(obs), uniforms, normals, *got[1:])
            _assert_same(got, want)
            assert torch.equal(obs, core.compute_obs(
                cfg, want[0].player, want[0].yaw, want[0].time_remaining))
    assert torch.equal(plain_gen.get_state(), composed_gen.get_state())
    if n == 512:
        assert not bool(want[2].all()) and bool(want[2].any())


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("k", [3, 4])
def test_wrapper_on_the_cpu_writes_the_plain_version_in_place(k,
                                                              deterministic):
    cfg = CONFIGS[k]
    state, logits, uniforms, normals, ret, alive = sampled_frame_inputs(
        cfg, 100, 3, "cpu")
    if deterministic:
        uniforms = normals = None
    want = env_rollout.rollout_actions_sampled_plain(
        cfg, state.clone(), logits, uniforms, normals, ret, alive)
    obs = torch.empty((100, 6))
    out = (state, ret, alive, obs)
    got = env_rollout.rollout_actions_sampled(cfg, state, logits, uniforms,
                                              normals, ret, alive, obs)
    assert all(g is o for g, o in zip(got, out))
    _assert_same(got[:3], want[:3])
    assert torch.equal(obs, want[3])


@pytest.mark.parametrize("change,error", [
    (dict(logits=torch.zeros((4, 9))), "logits"),
    (dict(normals=None), "both"),
    (dict(uniforms=torch.zeros((4, 4, 2), dtype=torch.float64)), "uniforms"),
    (dict(alive=torch.ones(4, dtype=torch.int32)), "alive"),
    (dict(obs=torch.zeros((4, 6))[:, :5]), "obs"),
    (dict(cfg=dataclasses.replace(RUN4, discrete_yaw_steps=3)), "continuous"),
])
def test_wrapper_rejects_bad_arguments(change, error):
    state, logits, uniforms, normals, ret, alive = sampled_frame_inputs(
        RUN4, 4, 0, "cpu")
    args = dict(cfg=RUN4, state=state, logits=logits, uniforms=uniforms,
                normals=normals, ret=ret, alive=alive,
                obs=torch.zeros((4, 6)))
    args.update(change)
    with pytest.raises(ValueError, match=error):
        env_rollout.rollout_actions_sampled(**args)


# --- the loop's choice of frame -----------------------------------------------


def _fallbacks():
    """Each case the composed frame keeps: (policy, config, shard)."""
    discrete = dataclasses.replace(RUN4, discrete_yaw_steps=2)
    no_yaw = dataclasses.replace(RUN4, allow_yaw=False)
    return {
        "discrete yaw": (Policy(discrete, device="cpu"), discrete, None),
        "no yaw": (Policy(no_yaw, device="cpu"), no_yaw, None),
        "callable policy": (analyse._policy_from(Policy(RUN4, device="cpu"),
                                                 RUN4, False), RUN4, None),
        "shard": (Policy(RUN4, device="cpu"), RUN4, EnvShard(0, 2, 4)),
    }


@pytest.mark.parametrize("case", list(_fallbacks()))
def test_the_composed_frame_stays_where_the_fused_one_does_not_apply(case):
    """Discrete or absent yaw, a callable policy and a shard keep the
    composed frame even on a card; a Policy with a continuous yaw takes the
    fused one there, K=3 and K=4; the CPU always keeps the composed."""
    policy, cfg, shard = _fallbacks()[case]
    cuda = torch.device("cuda")
    assert not analyse._takes_fused_frame(policy, cfg, shard, cuda)
    for k, c in CONFIGS.items():
        p = Policy(c, device="cpu")
        assert analyse._takes_fused_frame(p, c, None, cuda), k
        assert not analyse._takes_fused_frame(p, c, None, "cpu"), k


@pytest.mark.parametrize("case", list(_fallbacks()) + ["cpu"])
def test_zero_start_counts_its_composed_frames(case):
    """Every frame of a scoring run on the composed frame is counted in
    ``analyse.composed_frames``, none in ``analyse.fused_frames``."""
    if case == "cpu":
        policy, cfg, shard = Policy(RUN4, device="cpu"), RUN4, None
    else:
        policy, cfg, shard = _fallbacks()[case]
    frames = analyse._episode_steps(
        dataclasses.replace(cfg, zero_start_prob=1.0))
    before = profiling.counters()
    for deterministic in (False, True):
        analyse.zero_start_returns(policy, cfg, num_episodes=4,
                                   deterministic=deterministic, seed=1,
                                   device="cpu", shard=shard)
    after = profiling.counters()
    delta = lambda name: after.get(name, 0) - before.get(name, 0)
    assert delta("analyse.composed_frames") == 2 * frames
    assert delta("analyse.fused_frames") == 0
