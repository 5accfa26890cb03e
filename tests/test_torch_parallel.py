"""The port's data-parallel layer (``q1physrl_torch/parallel``,
``ops/sharded_rollout.py``, the multi-rank Trainer) in two gloo processes on
the CPU, held against the JAX package's sharded kernels and explicit
data-parallel iteration, and against one process of the port.

The ranks run ``tests/_torch_parallel_worker.py``, which imports torch and
the port only; JAX runs here, in the parent.  Each child has a process
group timeout and a wall-clock limit, so a hung rank fails the test.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from q1physrl_torch.algo import ppo as tppo
from q1physrl_torch.algo.config import PPOConfig as TPPOConfig
from q1physrl_torch.algo.config import RunConfig as TRunConfig
from q1physrl_torch.algo.train import Trainer
from q1physrl_torch.env import Config as TConfig
from q1physrl_torch.env import core as tcore
from q1physrl_torch.ops import sharded_rollout
from q1physrl_torch.parallel import distributed, spmd
from q1physrl_torch.parallel.mesh import (env_shard, shard_env_axis,
                                          unshard_env_axis)

from _torch_common import env_state_from_jax, run_ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL_PPO = dict(num_envs=64, rollout_length=8, num_sgd_iter=2,
                 sgd_minibatch_size=128)
STATE_LEAVES = ("z_pos", "vel_x", "vel_y", "vel_z", "on_ground",
                "jump_released", "yaw", "time_remaining", "zero_start",
                "last_keys", "last_key_press_time")


def _state_leaves(st):
    """An EnvState's 11 leaves by name, as numpy."""
    p = st.player
    return {k: np.asarray(getattr(p, k) if hasattr(p, k) else getattr(st, k))
            for k in STATE_LEAVES}


def _joined(ranks, key):
    """(state leaves, rewards, dones) of every rank joined on the env
    axis."""
    parts = [r[key] for r in ranks]
    state = {k: torch.cat([p[0][k] for p in parts], -1).numpy()
             for k in STATE_LEAVES}
    return (state, torch.cat([p[1] for p in parts], -1).numpy(),
            torch.cat([p[2] for p in parts], -1).numpy())


# --- the sharded kernels --------------------------------------------------


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """JAX's sharded_rollout_actions / _autoreset on make_mesh(2), Pallas in
    interpret mode as tests/test_pallas_rollout.py runs them, and the port's
    on two ranks, from the same state and inputs."""
    import jax
    import jax.numpy as jnp

    from q1physrl_tpu import env as jenv
    from q1physrl_tpu.env import core as jcore
    from q1physrl_tpu.ops.sharded_rollout import (
        sharded_rollout_actions, sharded_rollout_actions_autoreset)
    from q1physrl_tpu.parallel import make_mesh, shard_env_axis as jshard

    cfg = dataclasses.replace(jenv.Config.get_default(), num_envs=None)
    reset_cfg = dataclasses.replace(cfg, zero_start_prob=0.3)
    n, t = 2 * 128, 80
    mesh = make_mesh(2)
    state = jcore.reset(reset_cfg, jax.random.key(1), n, jnp.float32)
    rng = np.random.default_rng(1)
    ka = rng.integers(0, 2, (t, cfg.num_keys, n)).astype(np.int32)
    ya = rng.uniform(-10, 10, (t, n)).astype(np.float32)
    ru = rng.random((t, 5, n)).astype(np.float32)

    sharded = jshard(state, mesh)
    want_actions = jax.jit(lambda s, k, y: sharded_rollout_actions(
        cfg, s, k, y, mesh, block_envs=128, interpret=True))(
        sharded, jnp.asarray(ka), jnp.asarray(ya))
    want_autoreset = jax.jit(lambda s, k, y, u:
                             sharded_rollout_actions_autoreset(
                                 reset_cfg, s, k, y, u, mesh, block_envs=128,
                                 interpret=True))(
        sharded, jnp.asarray(ka), jnp.asarray(ya), jnp.asarray(ru))

    tstate = env_state_from_jax(state)
    inputs = {**{k: torch.from_numpy(v)
                 for k, v in _state_leaves(tstate).items()},
              "ka": torch.from_numpy(ka), "ya": torch.from_numpy(ya),
              "ru": torch.from_numpy(ru)}
    ranks = run_ranks("rollouts", tmp_path_factory.mktemp("rollouts"),
                      {"cfg": dataclasses.asdict(cfg),
                       "reset_cfg": dataclasses.asdict(reset_cfg),
                       "seed": 11, "t_random": 100}, inputs)
    return {"actions": want_actions, "autoreset": want_autoreset,
            "ranks": ranks}


def _assert_same_metrics(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k] == b[k] or math.isnan(a[k]) and math.isnan(b[k]), k


def _assert_matches_jax(got, want):
    """The tolerances of tests/test_pallas_rollout.py:160-214, with the
    absolute yaw tolerance of tests/test_torch_train.py's comparison with
    the Pallas kernel: under jit XLA folds the mouse step's multiply and
    divide (ROADMAP section 3, _torch_common.assert_env_state_close), which
    moves yaw by an ulp of its size in some frames."""
    (state, rewards, dones), (jstate, jr, jd) = got, want
    np.testing.assert_allclose(rewards, np.asarray(jr), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(dones, np.asarray(jd))
    jleaves = _state_leaves(jstate)
    for name in ("vel_x", "vel_y", "vel_z", "z_pos"):
        np.testing.assert_allclose(state[name], jleaves[name], rtol=1e-5,
                                   atol=1e-3, err_msg=name)
    np.testing.assert_allclose(state["yaw"], jleaves["yaw"], rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(state["time_remaining"],
                               jleaves["time_remaining"], rtol=1e-5,
                               atol=1e-5)
    for name in ("on_ground", "jump_released", "zero_start", "last_keys"):
        np.testing.assert_array_equal(state[name], jleaves[name],
                                      err_msg=name)


def test_sharded_rollout_actions_matches_jax(sharded_runs):
    _assert_matches_jax(_joined(sharded_runs["ranks"], "actions"),
                        sharded_runs["actions"])


def test_sharded_rollout_autoreset_matches_jax(sharded_runs):
    want = sharded_runs["autoreset"]
    assert int(np.asarray(want[2]).sum()) > 0  # resets fired
    _assert_matches_jax(_joined(sharded_runs["ranks"], "autoreset"), want)


def test_sharded_rollout_random_per_rank(sharded_runs):
    """Rank r's shard equals rollout_random's plain version with seed + r *
    SEED_STRIDE to the bit, and each rank holds the done count of both."""
    ranks = sharded_runs["ranks"]
    plain_total = sum(int(r["random_plain"][2]) for r in ranks)
    assert plain_total > 0
    for r in ranks:
        (s, rew, d), (s0, rew0, _) = r["random"], r["random_plain"]
        assert torch.equal(rew, rew0)
        for k in STATE_LEAVES:
            assert torch.equal(s[k], s0[k]), k
        assert int(d) == plain_total
    # The ranks' streams differ.
    assert not torch.equal(ranks[0]["random"][1], ranks[1]["random"][1])
    # On the CPU no kernel launched, so no launch was counted.
    assert all(v == 0 for r in ranks for v in r["launches"].values())


@pytest.mark.parametrize("case", ["ranks", "envs", "frames"])
def test_random_stream_guard_raises(case):
    """The stream guard: the ranks' 32-bit keys must differ, and env and
    frame indices must fit their counter words."""
    sharded_rollout.check_random_streams(0, 8, 1 << 20, 720)  # passes
    world, n, t = {"ranks": (2 ** 32 + 1, 16, 10), "envs": (2, 2 ** 32, 10),
                   "frames": (2, 16, 2 ** 32)}[case]
    with pytest.raises(ValueError):
        sharded_rollout.check_random_streams(7, world, n, t)
    if case == "frames":  # the function checks before it runs
        state = tcore.reset(TConfig.get_default(),
                            torch.Generator().manual_seed(0), 4, device="cpu")
        with pytest.raises(ValueError):
            sharded_rollout.sharded_rollout_random(TConfig.get_default(),
                                                   state, 2 ** 32)


# --- the layout and the collectives in one process ------------------------


def test_single_process_initialize_is_a_no_op(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert not distributed.is_initialized()
    assert not distributed.is_multi_process()
    assert distributed.process_info() == {"rank": 0, "world_size": 1,
                                          "local_rank": 0, "backend": None}
    x = torch.arange(4.0)
    assert torch.equal(distributed.all_reduce_sum(x), x)
    assert torch.equal(distributed.all_reduce_max(x), x)
    shard = env_shard(4)
    assert torch.equal(distributed.gather_env_axis(x, shard), x)


def test_env_shard_layout_and_draws():
    with pytest.raises(ValueError):
        env_shard(10, rank=0, world_size=4)
    shard = env_shard(12, rank=1, world_size=3)
    assert (shard.start, shard.stop, shard.local) == (4, 8, 4)
    # Draws for the whole batch, cut to the shard's envs.
    full = torch.rand((5, 12), generator=torch.Generator().manual_seed(3))
    got = shard.draw(torch.rand, (5, 4), 1,
                     generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, full[:, 4:8])
    cfg = TConfig.get_default()
    state = tcore.reset(cfg, torch.Generator().manual_seed(0), 12,
                        device="cpu")
    part = shard_env_axis(state, shard)
    assert torch.equal(part.last_keys, state.last_keys[:, 4:8])
    assert torch.equal(part.player.vel_x, state.player.vel_x[4:8])
    stats = shard_env_axis(tppo.EpisodeStats.zeros(12), shard)
    assert stats.ep_return.shape == (4,) and stats.finished.dim() == 0
    whole = unshard_env_axis(state, env_shard(12))  # one process: itself
    assert torch.equal(whole.yaw, state.yaw)


def test_spmd_with_coeffs_refuses_an_lr_schedule():
    cfg = TConfig.get_default()
    ppo = TPPOConfig(**SMALL_PPO, lr_schedule=((0, 1e-3), (100, 1e-4)))
    with pytest.raises(ValueError, match="lr_schedule"):
        spmd.make_spmd_train_iter(cfg, ppo, with_coeffs=True)
    spmd.make_spmd_train_iter(cfg, ppo)  # a static schedule is fine


def test_trainer_accepts_use_shard_map_in_one_process(tmp_path):
    run = TRunConfig(ppo=TPPOConfig(**SMALL_PPO), use_shard_map=True,
                     max_iterations=1, checkpoint_dir=str(tmp_path))
    trainer = Trainer(run, device="cpu")
    assert trainer.mode == "single"
    trainer.train()
    assert trainer.ts.iteration == 1


# --- training in two ranks ------------------------------------------------


def _small_cfg():
    return dataclasses.replace(TConfig.get_default(), num_envs=None,
                               zero_start_prob=0.3)


@pytest.fixture(scope="module")
def global_runs(tmp_path_factory):
    """Two iterations of global mode in two ranks, and in one process."""
    ranks = run_ranks("global", tmp_path_factory.mktemp("global"),
                      {"ppo": SMALL_PPO, "seed": 0, "iterations": 2})
    ppo = TPPOConfig(**SMALL_PPO)
    ts = tppo.init_train_state(0, _small_cfg(), ppo, "cpu")
    single = []
    for _ in range(2):
        ts, metrics = tppo.train_iter(_small_cfg(), ppo, ts)
        single.append({k: float(v) for k, v in metrics.items()})
    return ranks, single, ts


def test_global_mode_matches_one_process(global_runs):
    """The mirror of tests/test_parallel.py:46-61: two ranks draw what one
    process draws and learn on its batch; sums over ranks round in another
    order, so the metrics agree to rtol 1e-3 / atol 1e-5."""
    ranks, single, ts = global_runs
    for i, want in enumerate(single):
        got = ranks[0]["metrics"][i]
        assert set(got) == set(want)
        for k in want:
            if math.isnan(want[k]):
                assert math.isnan(got[k]), (i, k)
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                           atol=1e-5, err_msg=f"{i} {k}")
    for k, v in ts.policy.state_dict().items():
        np.testing.assert_allclose(ranks[0]["params"][k].numpy(), v.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    assert ranks[0]["env_steps"] == ts.env_steps


def test_two_processes_agree(global_runs):
    """The mirror of tests/test_distributed.py:30-68: every rank applies
    the same reduced gradient, so the params are equal to the bit, and the
    metrics are the same numbers on both ranks."""
    ranks, _, _ = global_runs
    a, b = ranks
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for m, n in zip(a["metrics"], b["metrics"]):
        _assert_same_metrics(m, n)
    assert np.isfinite(a["metrics"][-1]["entropy"])
    assert a["iteration"] == b["iteration"] == 2


def _jax_composition(ranks, ppo: TPPOConfig, perms):
    """The learning half of JAX's explicit data-parallel iteration
    (q1physrl_tpu/parallel/spmd.py:92-161) composed over the two ranks'
    trajectories: local GAE, global two-pass advantage moments, local
    minibatches, gradients and loss statistics averaged over the ranks, the
    reference optimizer, the KL rule."""
    import jax
    import jax.numpy as jnp
    import optax

    from q1physrl_tpu import env as jenv
    from q1physrl_tpu.algo import PPOConfig as JPPOConfig
    from q1physrl_tpu.algo import ppo as jppo

    w = len(ranks)
    jcfg = jenv.Config(**dataclasses.asdict(_small_cfg()))
    jppo_cfg = JPPOConfig(**dataclasses.asdict(ppo))
    local = dataclasses.replace(jppo_cfg, num_envs=ppo.num_envs // w,
                                sgd_minibatch_size=ppo.sgd_minibatch_size
                                // w)
    a = lambda x: jnp.asarray(x.numpy())
    sd = ranks[0]["params0"]
    tower = lambda name: [(a(sd[f"{name}.layers.{i}.weight"]).T,
                           a(sd[f"{name}.layers.{i}.bias"]))
                          for i in range(3)]
    params = {"policy": tower("pi"), "value": tower("vf")}

    gae = [jppo.compute_gae(local, a(r["traj"]["reward"]),
                            a(r["traj"]["done"]), a(r["traj"]["value"]),
                            a(r["boot"])) for r in ranks]
    total = sum(adv.size for adv, _ in gae)
    mean = sum(adv.sum() for adv, _ in gae) / total
    var = sum(jnp.square(adv - mean).sum() for adv, _ in gae) / total
    batches = []
    for r, (adv, vt) in zip(ranks, gae):
        adv = (adv - mean) / jnp.maximum(jnp.sqrt(var), 1e-4)
        tr = {k: a(v) for k, v in r["traj"].items()}
        T, N = tr["reward"].shape
        flat = lambda x: x.reshape((T * N,) + x.shape[2:])
        batches.append(jppo.Batch(
            obs=flat(tr["obs"]),
            key_actions=flat(jnp.moveaxis(tr["key_actions"], 1, 2)),
            yaw_actions=flat(tr["yaw_actions"]), logits=flat(tr["logits"]),
            logp=flat(tr["logp"]), value=flat(tr["value"]),
            advantage=flat(adv), value_target=flat(vt)))

    tx = jppo.make_optimizer(jppo_cfg)
    opt = tx.init(params)
    kl_coeff = jnp.float32(ppo.kl_coeff)
    grad_fn = jax.jit(jax.grad(
        lambda p, mb: jppo.ppo_loss(jcfg, jppo_cfg, p, mb, kl_coeff,
                                    ppo.entropy_coeff), has_aux=True))
    n_mb = local.num_minibatches
    mb = local.batch_size // n_mb
    for epoch in range(ppo.num_sgd_iter):
        stats = []
        for j in range(n_mb):
            results = [grad_fn(params, jax.tree.map(
                lambda x: x[np.asarray(perms[d][epoch][j * mb:(j + 1) * mb])],
                batches[d])) for d in range(w)]
            grads = jax.tree.map(lambda *g: sum(g) / w,
                                 *[g for g, _ in results])
            aux = jax.tree.map(lambda *x: sum(x) / w,
                               *[x for _, x in results])
            updates, opt = tx.update(grads, opt, params)
            params = optax.apply_updates(params, updates)
            stats.append(aux)
        aux = {k: jnp.mean(jnp.stack([s[k] for s in stats])) for k in stats[0]}
    kl_coeff = jppo.update_kl_coeff(jppo_cfg, kl_coeff, aux["kl"])
    adam = [s for s in jax.tree.leaves(
        opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    return params, adam, aux, kl_coeff


@pytest.fixture(scope="module")
def spmd_learn_runs(tmp_path_factory):
    """One spmd iteration in two ranks, its learning half ``ppo.learn``
    under the spmd layout on the parent's local permutations."""
    ppo = TPPOConfig(**SMALL_PPO, lr=1e-4)
    local_batch = ppo.batch_size // 2
    rng = np.random.default_rng(5)
    perms = np.stack([[rng.permutation(local_batch)
                       for _ in range(ppo.num_sgd_iter)] for _ in range(2)])
    ranks = run_ranks("spmd_learn", tmp_path_factory.mktemp("spmd_learn"),
                      {"ppo": dataclasses.asdict(ppo), "seed": 2},
                      {"perms": torch.from_numpy(perms)})
    return ranks, ppo, perms


def test_spmd_learning_half_matches_jax_composition(spmd_learn_runs):
    """Two ranks' spmd learning half on the parent's local permutations,
    against JAX's, at the tolerances of tests/test_torch_train.py:572-584
    (params to lr / 10, moments to 1e-3 relative, metrics to 1e-4)."""
    ranks, ppo, perms = spmd_learn_runs
    # The ranks rolled out different streams from one generator.
    assert not torch.equal(ranks[0]["traj"]["yaw_actions"],
                           ranks[1]["traj"]["yaw_actions"])
    for k in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k
    params, adam, aux, kl_coeff = _jax_composition(ranks, ppo, perms)

    def jax_layout(named):
        return {"policy": [(named[f"pi.layers.{i}.weight"].numpy().T,
                            named[f"pi.layers.{i}.bias"].numpy())
                           for i in range(3)],
                "value": [(named[f"vf.layers.{i}.weight"].numpy().T,
                           named[f"vf.layers.{i}.bias"].numpy())
                          for i in range(3)]}

    import jax

    def close(got, want, rtol, atol, what):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=rtol, atol=atol, err_msg=what)

    r = ranks[0]
    close(jax_layout(r["params"]), params, 1e-4, ppo.lr / 10, "params")
    assert r["count"] == int(adam.count)
    close(jax_layout(r["mu"]), adam.mu, 1e-3, 1e-5, "mu")
    close(jax_layout(r["nu"]), adam.nu, 1e-3, 1e-8, "nu")
    assert r["kl_coeff"] == float(kl_coeff)
    for k in aux:
        np.testing.assert_allclose(r["metrics"][k], float(aux[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _assert_same_metrics(r["metrics"], ranks[1]["metrics"])


def test_spmd_iteration_records_the_learning_spans(spmd_learn_runs):
    """The spmd layout runs the one learning half, so every rank records
    its spans: one ``ppo.learn``, and per epoch of the local config's
    minibatches one ``ppo.update`` each, with ``ppo.loss``, ``ppo.grad``
    and ``ppo.adam`` inside, in that order."""
    ranks, ppo, _ = spmd_learn_runs
    local = spmd.local_config(ppo, len(ranks))
    for r in ranks:
        spans = sorted(r["spans"], key=lambda s: s[1])
        assert [s[0] for s in spans].count("ppo.learn") == 1
        epochs = [s for s in spans if s[0] == "ppo.epoch"]
        updates = [s for s in spans if s[0] == "ppo.update"]
        assert len(epochs) == ppo.num_sgd_iter
        assert len(updates) == ppo.num_sgd_iter * local.num_minibatches
        for u in updates:
            assert u[2] in {e[1] for e in epochs}
            assert [s[0] for s in spans if s[2] == u[1]] == [
                "ppo.loss", "ppo.grad", "ppo.adam"]


def test_spmd_coeffs_equal_static_and_lr0_freezes(tmp_path):
    """The mirror of tests/test_parallel.py:111-152: Coeffs equal to the
    config give the static iteration's update, and lr 0 leaves the params
    as they were while the rest runs."""
    ranks = run_ranks("spmd_coeffs", tmp_path,
                      {"ppo": SMALL_PPO, "seed": 0})
    for r in ranks:
        static, dyn = r["static"], r["coeffs"]
        for k, a in static["metrics"].items():
            b = dyn["metrics"][k]
            assert (math.isnan(a) and math.isnan(b)) or np.isclose(
                a, b, rtol=1e-6), (k, a, b)
        for k, v in static["params"].items():
            assert float((v - dyn["params"][k]).abs().max()) < 1e-7, k
            assert torch.equal(r["frozen"]["params"][k], r["params0"][k]), k
            assert not torch.equal(v, r["params0"][k]), k
        assert np.isfinite(r["frozen"]["metrics"]["entropy"])


def test_scoring_over_two_ranks_matches_one_process(tmp_path):
    """The evaluate CLI in two ranks: each plays half of the episodes with
    the draws one process makes for them, and both report the scores of all
    of them; the policy's products round by rows alike or within a point,
    so the scores agree to a tenth of a point here."""
    from q1physrl_torch import analyse
    from q1physrl_torch.algo.config import load_run_config
    from q1physrl_torch.models import Policy, import_policy_params

    run_yaml = str(ROOT / "configs" / "run4.yml")
    checkpoint = str(ROOT / "data" / "checkpoints" / "tpu_pb" / "checkpoint")
    ranks = run_ranks("score", tmp_path, {"run_yaml": run_yaml,
                                          "checkpoint": checkpoint,
                                          "episodes": 16})
    cfg = load_run_config(run_yaml).env
    policy = Policy(cfg, device="cpu")
    policy.load_state_dict(import_policy_params(checkpoint))
    sto = analyse.eval_zero_start(policy, cfg, num_episodes=16, device="cpu")
    det = analyse.eval_zero_start(policy, cfg, num_episodes=2,
                                  deterministic=True, device="cpu")
    for r in ranks:
        assert r["sto"]["num_episodes"] == 16
        for key in ("mean", "min", "max"):
            assert abs(r["sto"][key] - sto[key]) <= 0.1, key
        assert abs(r["det"]["mean"] - det["mean"]) <= 0.1
    assert ranks[0]["sto"] == ranks[1]["sto"]


def test_trainer_spmd_under_torchrun(tmp_path):
    """The mirror of tests/test_parallel.py:95-108 through the CLI: two
    ranks under torchrun, use_shard_map, two iterations; rank 0 alone
    prints and writes."""
    ckpt = tmp_path / "ckpt"
    config = tmp_path / "run.yml"
    config.write_text(json.dumps({
        "ppo": SMALL_PPO, "use_shard_map": True, "max_iterations": 2,
        "checkpoint_dir": str(ckpt)}))  # JSON is YAML
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "q1physrl_torch.algo.train",
         str(config), "--device", "cpu"], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("Finished 2 iterations") == 1, proc.stdout
    assert proc.stdout.count("Iteration: 1 ") == 1
    assert (ckpt / "iter_0000002" / "train_state.pt").exists()
    records = (ckpt / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(records) == 2


def test_checkpoints_move_between_rank_counts(tmp_path):
    """A 2-rank checkpoint resumes in one process, and a one-process
    checkpoint in two ranks: the format holds no env state and no rank
    count."""
    two = tmp_path / "two"
    ranks = run_ranks("trainer", tmp_path / "run_two",
                      {"ppo": SMALL_PPO, "seed": 0, "use_shard_map": False,
                       "iterations": 2, "checkpoint_dir": str(two)})
    assert ranks[0]["mode"] == "global"
    run = TRunConfig(ppo=TPPOConfig(**SMALL_PPO), max_iterations=2,
                     checkpoint_dir=str(two))
    resumed = Trainer(run, device="cpu")
    assert resumed.ts.iteration == 2
    assert resumed.ts.env_steps == ranks[0]["env_steps"]
    for k, v in resumed.ts.policy.state_dict().items():
        assert torch.equal(v, ranks[0]["params"][k]), k

    one = tmp_path / "one"
    single = Trainer(dataclasses.replace(run, max_iterations=1,
                                         checkpoint_dir=str(one)),
                     device="cpu")
    single.train()
    ranks = run_ranks("trainer", tmp_path / "run_one",
                      {"ppo": SMALL_PPO, "seed": 5, "use_shard_map": True,
                       "iterations": 2, "checkpoint_dir": str(one)})
    # Resumed at iteration 1 with its env steps, then one more iteration.
    for r in ranks:
        assert r["mode"] == "spmd" and r["iteration"] == 2
        assert r["env_steps"] == 2 * run.ppo.batch_size
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
