"""The port's population (q1physrl_torch/algo/population.py) against P solo
runs of the port and against the JAX package's vmapped learner: the
stacked policy and its conversions, init_population, the population
rollout member by member (against solo rollouts and, frame by frame,
against the JAX package), the learning half against ``jax.vmap`` of the
JAX package's compute_gae -> standardize -> sgd_epochs -> update_kl_coeff,
one iteration against solo iterations, and a member's checkpoint.  CPU,
16 envs x 8 frames per member, minibatch 32, 2 epochs, 3 members with
different seeds and coefficients.

Tolerances are stated in each test; "to the bit" means torch.equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from q1physrl_torch.algo import checkpoint as tckpt
from q1physrl_torch.algo import population as tpop
from q1physrl_torch.algo import ppo as tppo
from q1physrl_torch.algo.config import PPOConfig as TPPOConfig
from q1physrl_torch.env import Config as TConfig
from q1physrl_torch.models import (Policy, StackedPolicy,
                                   import_policy_params, params_from_jax,
                                   population_adam_state_from_jax,
                                   population_params_from_jax)
from q1physrl_torch.parallel.mesh import EnvShard, shard_env_axis
from q1physrl_tpu import models as jmodels
from q1physrl_tpu.algo import ppo as jppo
from q1physrl_tpu.env import core as jcore

from _torch_common import assert_env_state_close, t
from test_torch_train import (_assert_tree_close, _env_state_to_jax,
                              _jax_cfg, _jax_params, _jax_ppo, _port_grads)

torch.set_num_threads(1)

SEEDS = (3, 5, 9)
CFG = dataclasses.replace(TConfig.get_default(), num_envs=None,
                          zero_start_prob=0.3)
COEFFS = tppo.Coeffs(entropy_coeff=np.float32([0.01, 0.03, 0.0]),
                     lr=np.float32([1e-4, 3e-4, 5e-5]),
                     kl_target=np.float32([0.0036, 0.01, 0.001]))


def _ppo(**over):
    return TPPOConfig(num_envs=16, rollout_length=8, num_sgd_iter=2,
                      sgd_minibatch_size=32, **over)


def _early_ends(ts, seed):
    """A third of the envs end their episode inside the rollout."""
    n = ts.env_state.num_envs
    rng = np.random.default_rng(seed)
    tr = ts.env_state.time_remaining.numpy()
    ts.env_state.time_remaining = t(np.where(
        rng.random(n) < 0.33, rng.uniform(0, 0.1, n), tr).astype(np.float32))
    return ts


def _solos(ppo, seeds=SEEDS):
    return [_early_ends(tppo.init_train_state(s, CFG, ppo, "cpu"), s)
            for s in seeds]


def _population(ppo, seeds=SEEDS):
    return tpop.stack_train_states(CFG, _solos(ppo, seeds))


def _member_envs(i, n):
    return slice(i * n, (i + 1) * n)


# --- the stacked policy ------------------------------------------------------


def test_stacked_policy_conversions_and_forward():
    """P solo policies -> stacked -> member i back, to the bit; the
    parameters are views of the flat buffer; the batched forward agrees
    with each member's solo forward to float32 rounding (another order of
    summation: rtol 1e-5, atol 1e-6); the flat and (P * n, 6) forms agree
    to the bit."""
    policies = [Policy(CFG, torch.Generator().manual_seed(s)) for s in SEEDS]
    stacked = StackedPolicy.from_policies(CFG, policies)
    assert [k for k, _ in stacked.named_parameters()] == [
        k for k, _ in policies[0].named_parameters()]
    for i, p in enumerate(policies):
        back = stacked.member_policy(CFG, i)
        for (k, a), b in zip(p.state_dict().items(),
                             back.state_dict().values()):
            assert torch.equal(a, b), k
    with torch.no_grad():
        stacked.flat[1].add_(1.0)
    assert torch.equal(stacked.pi.layers[0].weight[1],
                       policies[1].pi.layers[0].weight + 1.0)
    with torch.no_grad():
        stacked.flat[1].sub_(1.0)
    obs = torch.randn(len(SEEDS), 20, 6, generator=torch.Generator()
                      .manual_seed(0))
    logits, value = stacked(obs)
    for i, p in enumerate(policies):
        want_l, want_v = p(obs[i])
        np.testing.assert_allclose(logits[i].detach().numpy(),
                                   want_l.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(value[i].detach().numpy(),
                                   want_v.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
    flat_l, flat_v = stacked(obs.reshape(-1, 6))
    assert torch.equal(flat_l, logits.reshape(-1, logits.shape[-1]))
    assert torch.equal(flat_v, value.reshape(-1))


def test_population_params_from_jax():
    """The JAX package's vmapped params and Adam state (leading axis P) ->
    the stacked layout, each member equal to the solo conversion."""
    keys = jax.random.split(jax.random.key(1), 3)
    jparams = jax.vmap(lambda k: jmodels.init_params(k, _jax_cfg(CFG)))(keys)
    host = jax.tree.map(np.asarray, jparams)
    stacked = population_params_from_jax(host)
    adam = population_adam_state_from_jax(host, host, np.array([0, 4, 9]))
    assert adam["count"] == [0, 4, 9]
    policy = StackedPolicy(CFG, 3)
    policy.load_members([{k: v[i] for k, v in stacked.items()}
                         for i in range(3)])
    for i in range(3):
        solo = params_from_jax(jax.tree.map(lambda x: x[i], host))
        for k, v in solo.items():
            assert torch.equal(stacked[k][i], v), k
            assert torch.equal(adam["mu"][k][i], v), k
            assert torch.equal(policy.member_state_dict(i)[k], v), k


# --- init and the rollout ----------------------------------------------------


def test_init_population_equals_solo_inits():
    """Each member's weights, env states, Adam state, KL coefficient and
    generator equal ``ppo.init_train_state`` of its seed, to the bit."""
    ppo = _ppo()
    ps = tpop.init_population(SEEDS, CFG, ppo, "cpu")
    assert ps.members == 3 and ps.num_envs == ppo.num_envs
    for i, s in enumerate(SEEDS):
        solo = tppo.init_train_state(s, CFG, ppo, "cpu")
        member = tpop.member_train_state(CFG, ps, i)
        for (k, a), b in zip(solo.policy.state_dict().items(),
                             member.policy.state_dict().values()):
            assert torch.equal(a, b), k
        for a, b in zip(solo.env_state.leaves(), member.env_state.leaves()):
            assert torch.equal(a, b)
        assert torch.equal(solo.generator.get_state(),
                           ps.generators[i].get_state())
        assert float(ps.kl_coeff[i]) == float(solo.kl_coeff)
    assert not ps.mu.any() and not ps.nu.any() and ps.count == [0, 0, 0]
    assert ps.iteration == [0, 0, 0] and ps.env_steps == [0.0, 0.0, 0.0]


def test_population_rollout_matches_solo_rollouts():
    """Each member's envs of one population rollout against a solo
    ``ppo.rollout`` of its seed: the generator after it to the bit (the
    same draws in the same order and shapes); trajectory, statistics, final
    state and bootstrap value within float32 rounding of the stacked
    products (rtol 1e-5, atol 1e-5; dones, actions and flags exactly)."""
    ppo = _ppo()
    ps = _population(ppo)
    env_state, stats, traj, boot = tpop.rollout(
        CFG, ppo, ps.policy, ps.env_state, ps.stats, ps.generators)
    assert traj.obs.shape == (8, 48, 6) and bool(traj.done.any())
    assert stats.finished.shape == (3,)
    n = ppo.num_envs
    for i, solo in enumerate(_solos(ppo)):
        s_state, s_stats, s_traj, s_boot = tppo.rollout(
            CFG, ppo, solo.policy, solo.env_state, solo.stats, solo.generator)
        assert torch.equal(ps.generators[i].get_state(),
                           solo.generator.get_state())
        envs = _member_envs(i, n)
        for name, got, want in zip(tppo.Trajectory._fields, traj, s_traj):
            got = (got[..., envs] if name in ("key_actions", "reset_uniforms")
                   else got[:, envs])
            if got.dtype in (torch.bool, torch.int32):
                assert torch.equal(got, want), name
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=name)
        for f in dataclasses.fields(tppo.EpisodeStats):
            got, want = getattr(stats, f.name), getattr(s_stats, f.name)
            got = got[envs] if got.shape[0] == 3 * n else got[i]
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f.name)
        for a, b in zip(env_state.leaves(), s_state.leaves()):
            np.testing.assert_allclose(a[..., envs].numpy().astype(float),
                                       b.numpy().astype(float), rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(boot[envs].numpy(), s_boot.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_population_rollout_matches_jax_frame_by_frame():
    """Each member of a population rollout replayed through the JAX package
    on the member's own actions and re-draws, as
    test_torch_train.test_rollout_matches_jax_frame_by_frame does for one
    run: observations, policy outputs, log-probs, rewards and dones every
    frame, then the member's episode statistics, final state and bootstrap
    value; the same tolerances."""
    ppo = _ppo()
    ps = _population(ppo)
    jcfg = _jax_cfg(CFG)
    n = ppo.num_envs
    start = [tpop.member_train_state(CFG, ps, i) for i in range(3)]
    env_state, stats, traj, boot = tpop.rollout(
        CFG, ppo, ps.policy, ps.env_state, ps.stats, ps.generators)
    jforward = jax.jit(jmodels.forward)
    jstep = jax.jit(functools.partial(jcore.step_autoreset, jcfg,
                                      compute_observation=False))
    for i, member in enumerate(start):
        envs = _member_envs(i, n)
        jparams = _jax_params(member.policy)
        jstate = _env_state_to_jax(member.env_state)
        jstats = jppo.EpisodeStats.zeros(n)
        a = lambda x: jnp.asarray(x.numpy())
        for f in range(ppo.rollout_length):
            jobs = jcore.compute_obs(jcfg, jstate.player, jstate.yaw,
                                     jstate.time_remaining).astype(
                                         jnp.float32)
            np.testing.assert_allclose(traj.obs[f, envs].numpy(),
                                       np.asarray(jobs), rtol=1e-5,
                                       atol=1e-5)
            logits, value = jforward(jparams, a(traj.obs[f, envs]))
            np.testing.assert_allclose(traj.logits[f, envs].numpy(),
                                       np.asarray(logits), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(traj.value[f, envs].numpy(),
                                       np.asarray(value), rtol=1e-5,
                                       atol=1e-6)
            ka, ya = a(traj.key_actions[f, :, envs]), a(traj.yaw_actions[f,
                                                                         envs])
            dist = jmodels.action_dist(jcfg, a(traj.logits[f, envs]))
            np.testing.assert_allclose(traj.logp[f, envs].numpy(),
                                       np.asarray(dist.logp(ka, ya)),
                                       rtol=1e-5, atol=1e-4)
            jstate, out = jstep(jstate, ka, ya, reset_uniforms=a(
                traj.reset_uniforms[f, :, envs]))
            np.testing.assert_allclose(traj.reward[f, envs].numpy(),
                                       np.asarray(out.reward), rtol=1e-5,
                                       atol=1e-4)
            np.testing.assert_array_equal(traj.done[f, envs].numpy(),
                                          np.asarray(out.done))
            jstats = jstats.update(out.reward, out.done, out.zero_start)
        mine = tppo.EpisodeStats(**{
            f.name: (getattr(stats, f.name)[envs] if f.name in (
                "ep_return", "ep_len") else getattr(stats, f.name)[i])
            for f in dataclasses.fields(tppo.EpisodeStats)})
        for f in dataclasses.fields(tppo.EpisodeStats):
            np.testing.assert_allclose(getattr(mine, f.name).numpy(),
                                       np.asarray(getattr(jstats, f.name)),
                                       rtol=1e-5, atol=1e-4, err_msg=f.name)
        member_state = shard_env_axis(env_state, EnvShard(i, 3, 3 * n))
        assert_env_state_close(member_state, jstate, yaw_atol=1e-4)
        _, jboot = jforward(jparams, jcore.compute_obs(
            jcfg, jstate.player, jstate.yaw,
            jstate.time_remaining).astype(jnp.float32))
        np.testing.assert_allclose(boot[envs].numpy(), np.asarray(jboot),
                                   rtol=1e-5, atol=1e-6)


# --- the learning half -------------------------------------------------------


def _adam(opt):
    return [s for s in jax.tree.leaves(
        opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_population_learn_matches_jax_vmap(grad_clip):
    """The population's learning half on one population trajectory against
    ``jax.vmap`` of the JAX package's compute_gae -> standardize ->
    sgd_epochs -> update_kl_coeff, with each member's permutations from
    its JAX key, different lr, entropy coefficient and KL target per
    member, and member 1 warm (5 Adam steps in, so another count).  The
    tolerances of test_torch_train.test_learn_matches_jax: params within
    each member's lr / 10 (rtol 1e-4), moments 1e-3 relative above floors
    of 1e-5 (mu) and 1e-8 (nu), metrics rtol 1e-4 / atol 1e-6, the KL
    coefficient and counts exactly."""
    ppo = _ppo(grad_clip=grad_clip)
    jcfg, jppo_cfg = _jax_cfg(CFG), _jax_ppo(ppo)
    solos = _solos(ppo)
    # Member 1 warm: five steps of the reference's optimizer on random
    # gradients, its params and Adam state carried into the port.
    rng = np.random.default_rng(4)
    tx = jppo.make_optimizer(jppo_cfg)
    jparams = [_jax_params(ts.policy) for ts in solos]
    opts = [tx.init(p) for p in jparams]
    for _ in range(5):
        g = jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 0.3, x.shape),
                                               jnp.float32), jparams[1])
        updates, opts[1] = tx.update(g, opts[1], jparams[1])
        jparams[1] = optax.apply_updates(jparams[1], updates)
    host = lambda tree: jax.tree.map(np.asarray, tree)
    solos[1].policy.load_state_dict(params_from_jax(host(jparams[1])))
    warm = _adam(opts[1])
    solos[1].opt_state = tppo.AdamState(
        mu=params_from_jax(host(warm.mu)), nu=params_from_jax(host(warm.nu)),
        count=int(warm.count))
    ps = tpop.stack_train_states(CFG, solos)
    assert ps.count == [0, 5, 0]
    env_state, stats, traj, boot = tpop.rollout(
        CFG, ppo, ps.policy, ps.env_state, ps.stats, ps.generators)
    ps = dataclasses.replace(ps, env_state=env_state, stats=stats)

    n, T, P = ppo.num_envs, ppo.rollout_length, 3
    n_mb = ppo.num_minibatches
    keys = [jax.random.key(20 + i) for i in range(P)]
    perms = np.stack([np.stack([np.asarray(jax.random.permutation(
        key, ppo.batch_size))[:n_mb * (ppo.batch_size // n_mb)]
        for key in jax.random.split(jax.random.split(k)[1],
                                    ppo.num_sgd_iter)]) for k in keys])
    a = lambda x: jnp.asarray(x.numpy())

    def member(x, axis=-1):  # (..., P*N) -> (P, ..., N)
        x = a(x)
        x = x.reshape(x.shape[:axis % x.ndim] + (P, n)
                      + x.shape[axis % x.ndim + 1:])
        return jnp.moveaxis(x, axis % x.ndim, 0)

    def jlearn(params, opt, kl_coeff, reward, done, value, bootv, obs, ka,
               ya, logits, logp, key, ent, lr, kl_target):
        adv, vt = jppo.compute_gae(jppo_cfg, reward, done, value, bootv)
        adv = (adv - adv.mean()) / jnp.maximum(adv.std(), 1e-4)
        flat = lambda x: x.reshape((T * n,) + x.shape[2:])
        batch = jppo.Batch(
            obs=flat(obs), key_actions=flat(jnp.moveaxis(ka, 1, 2)),
            yaw_actions=flat(ya), logits=flat(logits), logp=flat(logp),
            value=flat(value), advantage=flat(adv), value_target=flat(vt))
        params, opt, aux, _ = jppo.sgd_epochs(jcfg, jppo_cfg, params, opt,
                                              kl_coeff, batch, key, ent, lr)
        return params, opt, aux, jppo.update_kl_coeff(jppo_cfg, kl_coeff,
                                                      aux["kl"], kl_target)

    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    want_params, want_opt, want_aux, want_kl = jax.jit(jax.vmap(jlearn))(
        stack(jparams), stack(opts), jnp.full(P, ppo.kl_coeff, jnp.float32),
        member(traj.reward, 1), member(traj.done, 1), member(traj.value, 1),
        member(boot, 0), member(traj.obs, 1), member(traj.key_actions, 2),
        member(traj.yaw_actions, 1), member(traj.logits, 1),
        member(traj.logp, 1), jnp.stack(keys),
        *(jnp.asarray(c) for c in COEFFS))

    new, metrics = tpop.learn(CFG, ppo, ps, traj, boot, COEFFS,
                              perms=torch.from_numpy(perms))
    steps = ppo.num_sgd_iter * n_mb
    assert new.count == [steps, 5 + steps, steps]
    assert new.iteration == [1, 1, 1] and new.env_steps == [T * n] * 3
    want_adam = _adam(want_opt)
    assert [int(c) for c in want_adam.count] == new.count
    assert [float(x) for x in new.kl_coeff] == [float(x) for x in want_kl]
    views = {name: new.policy.views(x) for name, x in
             (("params", new.policy.flat), ("mu", new.mu), ("nu", new.nu))}
    for i in range(P):
        pick = lambda tree: jax.tree.map(lambda x: x[i], tree)
        got = lambda name: _port_grads({k: v[i].detach() for k, v in
                                        views[name].items()})
        _assert_tree_close(got("params"), pick(want_params), rtol=1e-4,
                           atol=float(COEFFS.lr[i]) / 10,
                           what=f"member {i} params")
        _assert_tree_close(got("mu"), pick(want_adam.mu), rtol=1e-3,
                           atol=1e-5, what=f"member {i} mu")
        _assert_tree_close(got("nu"), pick(want_adam.nu), rtol=1e-3,
                           atol=1e-8, what=f"member {i} nu")
        for k in want_aux:
            np.testing.assert_allclose(float(metrics[k][i]),
                                       float(want_aux[k][i]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{k} {i}")


def test_population_iteration_matches_solo_iterations():
    """One population iteration with per-member coefficients against a
    solo ``ppo.train_iter`` of each member with its own: generators
    (rollout draws and permutations) to the bit, counts, iterations and
    env steps exactly, params within lr / 10 (rtol 1e-4) as Adam amplifies
    rounding-level gradient differences to a share of lr, metrics rtol
    1e-4 / atol 1e-5."""
    ppo = _ppo()
    ps = _population(ppo)
    new, metrics = tpop.train_iter(CFG, ppo, ps, COEFFS)
    views = new.policy.views(new.policy.flat)
    for i, solo in enumerate(_solos(ppo)):
        coeffs = tppo.Coeffs(*(float(c[i]) for c in COEFFS))
        ts, m = tppo.train_iter(CFG, ppo, solo, coeffs)
        assert torch.equal(new.generators[i].get_state(),
                           ts.generator.get_state())
        assert new.count[i] == ts.opt_state.count
        assert (new.iteration[i], new.env_steps[i]) == (ts.iteration,
                                                        ts.env_steps)
        for k, v in ts.policy.state_dict().items():
            np.testing.assert_allclose(views[k][i].detach().numpy(),
                                       v.numpy(), rtol=1e-4,
                                       atol=coeffs.lr / 10, err_msg=k)
        for k, v in m.items():
            np.testing.assert_allclose(float(metrics[k][i]), float(v),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_member_checkpoint_restores_and_scores(tmp_path):
    """A member written by ``save_member_checkpoint`` restores through the
    single-run loader to the bit (weights, moments, count, KL coefficient,
    generator, iteration, env steps), and its RLLib pickle holds its
    weights; the stacked resume point restores the whole population."""
    ppo = _ppo()
    ps, _ = tpop.train_iter(CFG, ppo, _population(ppo), COEFFS)
    path = tckpt.save_member_checkpoint(str(tmp_path / "best_member_02"),
                                        tpop.member_train_state(CFG, ps, 2))
    restored = tckpt.restore_checkpoint(
        path, tppo.init_train_state(0, CFG, ppo, "cpu"))
    member = tpop.member_train_state(CFG, ps, 2)
    for k, v in member.policy.state_dict().items():
        assert torch.equal(restored.policy.state_dict()[k], v), k
        assert torch.equal(restored.opt_state.mu[k], member.opt_state.mu[k])
        assert torch.equal(restored.opt_state.nu[k], member.opt_state.nu[k])
    assert restored.opt_state.count == ps.count[2]
    assert float(restored.kl_coeff) == float(ps.kl_coeff[2])
    assert torch.equal(restored.generator.get_state(),
                       ps.generators[2].get_state())
    assert (restored.iteration, restored.env_steps) == (1, ps.env_steps[2])
    for k, v in import_policy_params(f"{path}/checkpoint").items():
        assert torch.equal(v, member.policy.state_dict()[k]), k

    stacked = tckpt.save_population(str(tmp_path / "stacked"), ps)
    fresh = tpop.init_population((1, 2, 4), CFG, ppo, "cpu")
    back = tckpt.restore_population(stacked, fresh)
    assert torch.equal(back.policy.flat, ps.policy.flat)
    assert torch.equal(back.mu, ps.mu) and torch.equal(back.nu, ps.nu)
    assert (back.count, back.iteration, back.env_steps) == (
        ps.count, ps.iteration, ps.env_steps)
    assert torch.equal(back.kl_coeff, ps.kl_coeff)
    for g, h in zip(back.generators, ps.generators):
        assert torch.equal(g.get_state(), h.get_state())
    with pytest.raises(ValueError, match="3 members saved"):
        tckpt.restore_population(stacked, tpop.init_population(
            (1, 2), CFG, ppo, "cpu"))
