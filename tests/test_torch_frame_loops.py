"""The scoring, eval_sim and PPO-rollout loops split into a frame function
on static buffers: under the eager driver each gives, to the bit, what the
loops they replace gave.  Those loops are written out here as they were
(``_reference_*``).  On a card the same frames are replayed from CUDA
graphs (``tests/test_torch_cuda.py`` holds them to the eager driver)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from q1physrl_torch import analyse, phys
from q1physrl_torch.algo import ppo
from q1physrl_torch.algo.config import PPOConfig, load_run_config
from q1physrl_torch.env import core
from q1physrl_torch.models import Policy, import_policy_params
from q1physrl_torch.models.policy import action_dist
from q1physrl_torch.ops import env_rollout
from q1physrl_torch.parallel import spmd
from q1physrl_torch.parallel.mesh import EnvShard, shard_env_axis
from q1physrl_torch.utils import cuda_graph

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN4 = load_run_config(str(ROOT / "configs" / "run4.yml")).env
CHECKPOINT = str(ROOT / "data" / "checkpoints" / "tpu_pb" / "checkpoint")
_PLAYER_FIELDS = tuple(f.name for f in dataclasses.fields(phys.PlayerState))


def _policy():
    policy = Policy(RUN4, device="cpu")
    policy.load_state_dict(import_policy_params(CHECKPOINT))
    return policy


# --- the loops as they were -----------------------------------------------------


def _reference_zero_start(policy, cfg, n, deterministic, seed, shard=None):
    """eval_zero_start's loop before the split; returns the returns and the
    generator."""
    cfg = dataclasses.replace(cfg, num_envs=None, zero_start_prob=1.0)
    steps = int(np.ceil(cfg.time_limit / cfg.time_delta)) + 2
    policy_fn = analyse._policy_from(policy, cfg, deterministic, shard)
    generator = torch.Generator("cpu").manual_seed(seed)
    step = env_rollout.rollout_actions
    with torch.inference_mode():
        state = core.reset(cfg, generator, n, device="cpu")
        if shard is not None:
            state = shard_env_axis(state, shard)
            n = shard.local
        ret = torch.zeros(n, dtype=torch.float32)
        alive = torch.ones(n, dtype=torch.bool)
        for _ in range(steps):
            obs = core.compute_obs(cfg, state.player, state.yaw,
                                   state.time_remaining)
            ka, ya = policy_fn(obs, generator)
            state, rewards, dones = step(cfg, state, ka.unsqueeze(0),
                                         ya.unsqueeze(0))
            ret += rewards[0] * alive
            alive &= ~dones[0]
    return ret.numpy(), generator


def _reference_eval_sim(policy, cfg, deterministic, seed, max_steps):
    """eval_sim's loop before the split: its record, cut at the episode's
    end, and the generator."""
    cfg = dataclasses.replace(cfg, num_envs=None, zero_start_prob=1.0)
    policy_fn = analyse._policy_from(policy, cfg, deterministic)
    generator = torch.Generator("cpu").manual_seed(seed)
    frames = []
    with torch.inference_mode():
        state = core.reset(cfg, generator, 1, device="cpu")
        alive = torch.ones(1, dtype=torch.bool)
        for _ in range(max_steps):
            obs = core.compute_obs(cfg, state.player, state.yaw,
                                   state.time_remaining)
            ka, ya = policy_fn(obs, generator)
            yaw, smove, fmove, jump = core.decode_actions(cfg, state, ka, ya)
            pre = state.player
            state, rewards, dones = env_rollout.rollout_actions(
                cfg, state, ka.unsqueeze(0), ya.unsqueeze(0))
            frames.append({
                **{f: getattr(pre, f) for f in _PLAYER_FIELDS},
                "obs": obs[0], "ka": ka[:, 0], "ya": ya,
                "reward": rewards[0] * alive, "yaw": yaw, "smove": smove,
                "fmove": fmove, "jump": jump, "alive": alive})
            alive = alive & ~dones[0]
        rec = {k: torch.stack([f[k] for f in frames]).numpy()
               for k in frames[0]}
    t_len = int(rec["alive"][:, 0].sum())
    cut = {k: v[:t_len] for k, v in rec.items()}
    return cut, generator


def _reference_rollout(env_cfg, ppo_cfg, policy, env_state, stats, generator,
                       shard=None):
    """ppo.rollout before the split."""
    n = env_state.num_envs
    draw = dict(generator=generator, dtype=torch.float32, device="cpu")
    frames = []
    with torch.no_grad():
        for _ in range(ppo_cfg.rollout_length):
            obs = core.compute_obs(env_cfg, env_state.player, env_state.yaw,
                                   env_state.time_remaining).to(torch.float32)
            logits, value = policy(obs)
            dist = action_dist(env_cfg, logits)
            ka, ya = dist.sample(generator, shard)
            logp = dist.logp(ka, ya)
            ru = (torch.rand((5, n), **draw) if shard is None
                  else shard.draw(torch.rand, (5, n), 1, **draw))
            zero_start = env_state.zero_start
            env_state, rewards, dones = env_rollout.rollout_actions_autoreset(
                env_cfg, env_state, ka[None], ya[None], ru[None])
            stats = stats.update(rewards[0], dones[0], zero_start)
            frames.append((obs, ka, ya, logits, logp, value, rewards[0],
                           dones[0], ru))
        final_obs = core.compute_obs(
            env_cfg, env_state.player, env_state.yaw,
            env_state.time_remaining).to(torch.float32)
        _, bootstrap_value = policy(final_obs)
    traj = ppo.Trajectory(*(torch.stack(x) for x in zip(*frames)))
    return env_state, stats, traj, bootstrap_value


# --- scoring ---------------------------------------------------------------------


@pytest.mark.parametrize("deterministic", [False, True])
def test_zero_start_matches_the_loop_it_replaces(deterministic):
    """64 episodes of tpu_pb, both modes: the returns to the bit, and the
    generator left where the old loop left it."""
    policy = _policy()
    want, want_gen = _reference_zero_start(policy, RUN4, 64, deterministic,
                                           seed=2)
    got = analyse.zero_start_returns(policy, RUN4, num_episodes=64,
                                     deterministic=deterministic, seed=2,
                                     device="cpu")
    np.testing.assert_array_equal(got, want)
    # Zero-start episodes are alike: one deterministic trajectory.
    unique = len(np.unique(got))
    assert unique == 1 if deterministic else unique > 32

    cfg = dataclasses.replace(RUN4, num_envs=None, zero_start_prob=1.0)
    loop = analyse._ZeroStartLoop(
        analyse._policy_from(policy, cfg, deterministic), cfg, 64, "cpu")
    loop.start(2)
    with torch.inference_mode():
        loop.run(analyse._episode_steps(cfg), "eager")
    np.testing.assert_array_equal(loop.ret.numpy(), want)
    assert torch.equal(loop.generator.get_state(), want_gen.get_state())


def test_zero_start_shard_matches_the_loop_it_replaces():
    """Rank 1 of two plays its half of 64 episodes from draws made for all
    64: its returns (the other half zero before the gather) to the bit."""
    policy = _policy()
    shard = EnvShard(1, 2, 64)
    want, _ = _reference_zero_start(policy, RUN4, 64, False, seed=4,
                                    shard=shard)
    got = analyse.zero_start_returns(policy, RUN4, num_episodes=64, seed=4,
                                     device="cpu", shard=shard)
    np.testing.assert_array_equal(got[32:], want)
    assert not got[:32].any() and got[32:].all()


def test_summary_is_the_returns_summarized():
    policy = _policy()
    ret = analyse.zero_start_returns(policy, RUN4, num_episodes=8, seed=1,
                                     device="cpu")
    stats = analyse.eval_zero_start(policy, RUN4, num_episodes=8, seed=1,
                                    device="cpu")
    assert stats == {"mean": float(ret.mean()),
                     "median": float(np.median(ret)),
                     "std": float(ret.std()), "min": float(ret.min()),
                     "max": float(ret.max()), "num_episodes": 8}


# --- eval_sim ------------------------------------------------------------------


@pytest.mark.parametrize("deterministic,max_steps",
                         [(True, None), (False, 100), (False, 101),
                          (True, 1)])
def test_eval_sim_matches_the_loop_it_replaces(deterministic, max_steps):
    """Every recorded field to the bit, at an even and an odd step count,
    one frame, and the whole episode, and the generator where the old loop
    left it."""
    policy = _policy()
    steps = max_steps or analyse._episode_steps(
        dataclasses.replace(RUN4, zero_start_prob=1.0))
    want, want_gen = _reference_eval_sim(policy, RUN4, deterministic, 7,
                                         steps)
    got = analyse.eval_sim(policy, RUN4, deterministic=deterministic, seed=7,
                           max_steps=max_steps, device="cpu")
    assert len(got.reward) == len(want["reward"])
    for f in _PLAYER_FIELDS:
        np.testing.assert_array_equal(getattr(got.player_state, f),
                                      want[f][:, 0], err_msg=f)
    np.testing.assert_array_equal(got.action, np.concatenate(
        [want["ka"], want["ya"]], axis=1))
    np.testing.assert_array_equal(got.obs, want["obs"])
    for k in ("reward", "yaw", "smove", "fmove", "jump"):
        np.testing.assert_array_equal(getattr(got, k), want[k][:, 0],
                                      err_msg=k)
        assert getattr(got, k).dtype == want[k].dtype

    cfg = dataclasses.replace(RUN4, num_envs=None, zero_start_prob=1.0)
    loop = analyse._SimLoop(analyse._policy_from(policy, cfg, deterministic),
                            cfg, steps, "cpu")
    loop.start(7)
    with torch.inference_mode():
        loop.run(steps, "eager")
    assert int(loop.idx) == steps
    assert torch.equal(loop.generator.get_state(), want_gen.get_state())


# --- the PPO rollout ---------------------------------------------------------------


def _run(rollout_length=16, seed=0):
    cfg = dataclasses.replace(RUN4, num_envs=None, zero_start_prob=0.3)
    ppo_cfg = PPOConfig(num_envs=64, rollout_length=rollout_length,
                        num_sgd_iter=1, sgd_minibatch_size=64)
    ts = ppo.init_train_state(seed, cfg, ppo_cfg, "cpu")
    rng = np.random.default_rng(seed)
    tr = ts.env_state.time_remaining.numpy()
    early = rng.random(64) < 0.33
    ts.env_state.time_remaining = torch.tensor(
        np.where(early, rng.uniform(0, 0.2, 64), tr).astype(np.float32))
    return cfg, ppo_cfg, ts


def _assert_rollouts_equal(got, want):
    (s, st, tr, b), (s0, st0, tr0, b0) = got, want
    for x, y in zip(s.leaves(), s0.leaves()):
        assert torch.equal(x, y)
    for f in dataclasses.fields(st0):
        assert torch.equal(getattr(st, f.name), getattr(st0, f.name)), f
    for k in tr0._fields:
        assert torch.equal(getattr(tr, k), getattr(tr0, k)), k
    assert torch.equal(b, b0)


@pytest.mark.parametrize("rollout_length", [16, 15])
def test_rollout_matches_the_loop_it_replaces(rollout_length):
    """64 envs, an even and an odd number of frames, a third of the
    episodes ending inside: trajectory, final state, statistics, bootstrap
    value and the generator's state to the bit."""
    cfg, ppo_cfg, ts = _run(rollout_length, seed=3)
    gen_state = ts.generator.get_state()
    want = _reference_rollout(cfg, ppo_cfg, ts.policy, ts.env_state,
                              ts.stats, ts.generator)
    want_gen = ts.generator.get_state()
    ts.generator.set_state(gen_state)
    got = ppo.rollout(cfg, ppo_cfg, ts.policy, ts.env_state, ts.stats,
                      ts.generator)
    assert bool(want[2].done.any())
    _assert_rollouts_equal(got, want)
    assert torch.equal(ts.generator.get_state(), want_gen)


def test_rollout_shard_matches_the_loop_it_replaces():
    """Rank 0 of two: draws for the whole batch, its half kept."""
    cfg, ppo_cfg, ts = _run(seed=5)
    shard = EnvShard(0, 2, 64)
    state, stats = (shard_env_axis(ts.env_state, shard),
                    shard_env_axis(ts.stats, shard))
    gen_state = ts.generator.get_state()
    want = _reference_rollout(cfg, ppo_cfg, ts.policy, state, stats,
                              ts.generator, shard)
    ts.generator.set_state(gen_state)
    got = ppo.rollout(cfg, ppo_cfg, ts.policy, state, stats, ts.generator,
                      shard)
    assert got[2].obs.shape == (16, 32, 6)
    _assert_rollouts_equal(got, want)


def test_a_kept_rollout_loop_matches_fresh_rollouts():
    """A loop kept across iterations (as the Trainer keeps it) gives what a
    fresh rollout gives each time, and its outputs are its own copies."""
    cfg, ppo_cfg, ts = _run(seed=6)
    loop = ppo.RolloutLoop(cfg, ppo_cfg, ts.policy, ts.generator, 64, "cpu")
    state, stats = ts.env_state, ts.stats
    kept = []
    for _ in range(2):
        gen_state = ts.generator.get_state()
        want = _reference_rollout(cfg, ppo_cfg, ts.policy, state, stats,
                                  ts.generator)
        ts.generator.set_state(gen_state)
        got = loop.rollout(state, stats)
        _assert_rollouts_equal(got, want)
        kept.append(got)
        state, stats = got[0], got[1]
    assert not torch.equal(kept[0][2].obs, kept[1][2].obs)


def _last_rollout_loop():
    return next(reversed(ppo._LOOPS.loops.values()))


def test_rollout_keeps_its_loop_while_its_key_holds():
    """ppo.rollout and train_iter reuse one loop (on a card, one capture)
    for one policy, generator and geometry; another generator, or a
    parameter at a new address, gets a loop of its own."""
    cfg, ppo_cfg, ts = _run(seed=8)
    args = (cfg, ppo_cfg, ts.policy, ts.env_state, ts.stats)
    ppo.rollout(*args, ts.generator)
    loop = _last_rollout_loop()
    assert loop.policy is ts.policy and loop.generator is ts.generator
    ppo.rollout(*args, ts.generator)
    ts, _ = ppo.train_iter(cfg, ppo_cfg, ts)
    assert _last_rollout_loop() is loop
    ppo.rollout(*args, torch.Generator().manual_seed(1))
    assert _last_rollout_loop() is not loop
    layer = ts.policy.pi.layers[0]
    layer.weight = torch.nn.Parameter(layer.weight.detach().clone())
    ppo.rollout(*args, ts.generator)
    assert _last_rollout_loop() is not loop
    assert len(ppo._LOOPS.loops) <= ppo._LOOPS.size


def test_trainer_keeps_one_rollout_loop():
    """Iterations of the Trainer reuse its rollout loop while the policy's
    parameters keep their addresses (Adam updates them in place)."""
    from q1physrl_torch.algo.config import RunConfig
    from q1physrl_torch.algo.train import Trainer
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        run = RunConfig(ppo=PPOConfig(num_envs=64, rollout_length=8,
                                      num_sgd_iter=1, sgd_minibatch_size=64),
                        max_iterations=2, checkpoint_dir=tmp)
        trainer = Trainer(run, device="cpu")
        trainer.step()
        loop = _last_rollout_loop()
        assert loop.policy is trainer.ts.policy
        trainer.step()
        assert _last_rollout_loop() is loop
        layer = trainer.ts.policy.pi.layers[0]
        layer.weight = torch.nn.Parameter(layer.weight.detach().clone())
        trainer.step()
        assert _last_rollout_loop() is not loop


def test_rank_generator_reseeds_the_generator_it_is_given():
    """spmd keeps one generator per run generator and rank, and reseeds it
    every iteration with the seed a new one would get: the same bits."""
    run_a = torch.Generator().manual_seed(9)
    run_b = torch.Generator().manual_seed(9)
    kept = None
    for _ in range(3):
        seed = int(torch.randint(0, 1 << 62, (), generator=run_a))
        fresh = torch.Generator().manual_seed(spmd._fold_in(seed, 1))
        same = spmd.rank_generator(run_b, rank=1)
        assert kept is None or same is kept
        kept = same
        assert torch.equal(torch.rand(16, generator=fresh),
                           torch.rand(16, generator=same))
    assert spmd.rank_generator(run_b, rank=0) is not kept
    assert spmd.rank_generator(torch.Generator(), rank=1) is not kept


def test_loop_cache_keeps_the_most_recent():
    cache = cuda_graph.LoopCache(2)
    made = []
    make = lambda key: lambda: made.append(key) or object()
    a = cache.get("a", make("a"))
    cache.get("b", make("b"))
    assert cache.get("a", make("a")) is a  # "b" is now the oldest
    cache.get("c", make("c"))
    assert list(cache.loops) == ["a", "c"]
    cache.get("b", make("b"))
    assert made == ["a", "b", "c", "b"] and list(cache.loops) == ["c", "b"]


# --- the pieces -----------------------------------------------------------------


def test_wrappers_write_into_the_buffers_they_are_given():
    """``out=`` on the CPU: the plain version's result, written in place,
    the state itself as its own output."""
    cfg = RUN4
    gen = torch.Generator().manual_seed(0)
    state = core.reset(cfg, gen, 50, device="cpu")
    ka = torch.randint(0, 2, (1, cfg.num_keys, 50), generator=gen,
                       dtype=torch.int32)
    ya = torch.rand((1, 50), generator=gen)
    ru = torch.rand((1, 5, 50), generator=gen)
    for fn, extra in ((env_rollout.rollout_actions, ()),
                      (env_rollout.rollout_actions_autoreset, (ru,))):
        want = fn(cfg, state, ka, ya, *extra)
        mine = state.clone()
        out = (mine, torch.empty(1, 50), torch.empty((1, 50), dtype=bool))
        got = fn(cfg, mine, ka, ya, *extra, out=out)
        assert got is out
        for x, y in zip(mine.leaves(), want[0].leaves()):
            assert torch.equal(x, y)
        assert torch.equal(out[1], want[1]) and torch.equal(out[2], want[2])
    with pytest.raises(ValueError):
        env_rollout.rollout_actions(cfg, state, ka, ya,
                                    out=(state.clone(), torch.empty(2, 50),
                                         torch.empty((1, 50), dtype=bool)))


def test_decode_divisors_are_made_once():
    """_decode divides by one cached 0-dim tensor per (value, dtype,
    device), not by a new one every frame."""
    a = core._divisor(2.0, torch.float32, torch.device("cpu"))
    assert a is core._divisor(2.0, torch.float32, torch.device("cpu"))
    assert a.dim() == 0 and float(a) == 2.0 and not a.is_inference()


def test_drivers():
    cpu = torch.device("cpu")
    assert cuda_graph.resolve_driver(None, cpu) == "eager"
    assert cuda_graph.resolve_driver(None, "cuda") == "graph"
    assert cuda_graph.resolve_driver("eager", "cuda") == "eager"
    with pytest.raises(ValueError):
        cuda_graph.resolve_driver("graph", cpu)
    with pytest.raises(ValueError):
        cuda_graph.resolve_driver("scan", cpu)
    with pytest.raises(ValueError):
        cuda_graph.FrameGraph(lambda: None, cpu)
    with pytest.raises(ValueError):
        analyse.eval_sim(_policy(), RUN4, max_steps=2, device="cpu",
                         driver="graph")
