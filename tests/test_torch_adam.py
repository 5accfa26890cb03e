"""Adam's step (``ops/adam.py``).

On the CPU: the plain version of the kernel's arithmetic held to the
composed steps bit for bit, solo (``ppo.adam_update`` over params_tpu's
leaves, at update counts 1, 2 and 10^6) and stacked
(``population.adam_step``, P=4, each member its own rate and bias
corrections, the towers' own transposed weight gradients); the leaf table
the kernel reads; the choice of step with its counters.

Marked ``cuda``, on a card: the fused step against the composed one, bit
for bit in the parameters, moments and count over 5 consecutive steps,
solo (random, zero and subnormal gradients), stacked (4, D) and (8, D)
(96 segments: two launches a step) and in a global-layout epoch at world
size 1.  Run them with
``python -m pytest --noconftest -m cuda tests/test_torch_adam.py``.
"""

import copy
import dataclasses
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

from q1physrl_torch.algo import population, ppo
from q1physrl_torch.algo.config import load_run_config
from q1physrl_torch.models.policy import action_dist
from q1physrl_torch.ops import adam as adam_mod
from q1physrl_torch.parallel import distributed
from q1physrl_torch.parallel.mesh import EnvShard
from q1physrl_torch.utils import profiling

from chip_smoke import ppo_head_inputs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PARAMS_TPU = load_run_config(str(ROOT / "configs" / "params_tpu.yml"))
RUN4 = load_run_config(str(ROOT / "configs" / "run4.yml"))
SEEDS = (11, 12, 13, 14, 15, 16, 17, 18)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _solo(device, seed=5):
    """params_tpu's policy, its Adam state and its leaves in the state's
    order."""
    ts = ppo.init_train_state(seed, PARAMS_TPU.env, PARAMS_TPU.ppo, device)
    named = dict(ts.policy.named_parameters())
    return ts, [named[k] for k in ts.opt_state.mu]


def _moments(state):
    return list(state.mu.values()), list(state.nu.values())


def _bias_corrections(steps):
    return tuple(float(np.float32(1 - b ** steps))
                 for b in (ppo.ADAM_B1, ppo.ADAM_B2))


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("count", [1, 2, 10**6])
def test_plain_version_equals_the_composed_solo_step(count):
    """At P = 1 over params_tpu's leaves, from moments of earlier steps:
    the plain version's parameters and moments equal ``adam_update``'s
    composed step's to the bit, at the step's update count ``count``."""
    ts, params = _solo("cpu")
    gen = torch.Generator().manual_seed(count % 1000)
    for m, v in zip(*_moments(ts.opt_state)):
        m.copy_(torch.randn(m.shape, generator=gen) * 1e-3)
        v.copy_(torch.rand(v.shape, generator=gen) * 1e-6)
    ts.opt_state.count = count - 1
    twin = [p.detach().clone() for p in params]
    mu, nu = (copy.deepcopy(x) for x in _moments(ts.opt_state))
    grads = [torch.randn(p.shape, generator=gen) for p in params]
    state = ppo.adam_update(PARAMS_TPU.ppo, params, grads, ts.opt_state,
                            4e-5)
    bc1, bc2 = _bias_corrections(count)
    adam_mod.adam_plain(ppo.ADAM, twin, grads, mu, nu, bc1, bc2, -4e-5)
    assert state.count == count
    assert _equal(params, twin)
    assert _equal(state.mu.values(), mu)
    assert _equal(state.nu.values(), nu)


def _rollout_batch(env_cfg, policy, x, obs, gen):
    """A batch on ``obs`` whose behaviour is the towers' own output moved a
    little, as a rollout records it; the rest from ``x``."""
    with torch.no_grad():
        logits, value = policy(obs)
        logp = action_dist(env_cfg, logits).logp(
            x["key_actions"].movedim(-1, 0), x["yaw_actions"])
    noise = lambda t: t + 0.1 * torch.randn(t.shape, generator=gen,
                                            device=t.device)
    return ppo.Batch(obs=obs, key_actions=x["key_actions"],
                     yaw_actions=x["yaw_actions"], logits=noise(logits),
                     logp=noise(logp), value=noise(value),
                     advantage=x["advantage"], value_target=x["value_target"])


def _population(device, members=4, rows=16):
    """A population of ``members`` on run4, and the gradients of one
    stacked step through the towers (``baddbmm``: each weight's gradient a
    transposed view)."""
    ppo_cfg = dataclasses.replace(RUN4.ppo, num_envs=rows, rollout_length=1,
                                  sgd_minibatch_size=rows)
    ps = population.init_population(list(SEEDS[:members]), RUN4.env, ppo_cfg,
                                    device)
    x = ppo_head_inputs(RUN4.env, ppo_cfg, members, rows, 3, device)
    gen = torch.Generator(device).manual_seed(3)
    batch = _rollout_batch(RUN4.env, ps.policy, x, torch.randn(
        (members, rows, 6), generator=gen, device=device), gen)

    def grads():
        total, _ = population.population_loss_and_stats(
            RUN4.env, ppo_cfg, ps.policy, batch, x["kl_coeff"][:, None],
            x["entropy_coeff"][:, None])
        return list(torch.autograd.grad(total, list(ps.policy.parameters())))

    return ppo_cfg, ps, grads


def _member_coefficients(device, members=4,
                         counts=(0, 3, 40, 1000, 1, 7, 99, 12345)):
    """Each member its own bias corrections (from its update count) and
    rate: (steps, P, 1) tables and (P, 1) negated rates."""
    bc1, bc2 = population.bias_corrections(list(counts[:members]), 5, device)
    rates = (5e-6, 3e-5, 1e-4, 7e-6, 2e-5, 4e-6, 6e-5, 1e-5)
    neg_lr = -torch.tensor(rates[:members], device=device)[:, None]
    return bc1, bc2, neg_lr


def test_plain_version_equals_the_composed_stacked_step():
    """At P = 4, each member its own rate and bias corrections, the
    gradients the towers' backward leaves (transposed weight gradients):
    the plain version on the (P, D) tensors equals ``adam_step``'s
    composed step to the bit over 3 steps."""
    ppo_cfg, ps, grads = _population("cpu")
    bc1, bc2, neg_lr = _member_coefficients("cpu")
    twin = copy.deepcopy(ps)
    for step in range(3):
        g = grads()
        assert any(not x.is_contiguous() for x in g)
        population.adam_step(ppo_cfg, ps, g, bc1[step], bc2[step], neg_lr)
        adam_mod.adam_plain(ppo.ADAM, twin.policy.flat, g, twin.mu, twin.nu,
                            bc1[step], bc2[step], neg_lr)
        assert torch.equal(ps.policy.flat, twin.policy.flat)
        assert torch.equal(ps.mu, twin.mu) and torch.equal(ps.nu, twin.nu)


def test_the_leaf_table_reads_gradients_where_autograd_left_them():
    """The kernel's table of a stacked step: each leaf at its offset in
    the (P, D) rows, and a weight gradient through its transposed strides
    (element (o, i) at o + i * out), a bias's as it lies."""
    _, ps, grads = _population("cpu")
    g = grads()
    table, _ = adam_mod._table(ps.policy.flat, g, ps.mu, ps.nu, 4)
    rows = np.array(table[:], np.int64).reshape(len(g), adam_mod._LEAF_FIELDS)
    flat, width = ps.policy.flat, ps.policy.flat.shape[1]
    offsets = np.cumsum([0] + [x[0].numel() for x in g])[:-1]
    assert list(rows[:, 0]) == [flat.data_ptr() + 4 * o for o in offsets]
    assert list(rows[:, 2]) == [ps.mu.data_ptr() + 4 * o for o in offsets]
    assert set(rows[:, 4]) == {width}
    for row, x in zip(rows, g):
        assert row[1] == x.data_ptr() and row[5] == x.stride(0)
        assert row[8] == x[0].numel()
        cols, row_stride, col_stride = row[9:]
        e = np.arange(row[8])
        index = np.unravel_index(e, tuple(x.shape[1:]))
        where = sum(i * s for i, s in zip(index, x.stride()[1:]))
        assert np.array_equal((e // cols) * row_stride
                              + (e % cols) * col_stride, where)
    # The hidden layers' weights: (P, out, in) read through (1, out).
    weight = g[2]
    assert weight.stride()[1:] == (1, weight.shape[1])
    assert tuple(rows[2, 9:]) == (weight.shape[2], 1, weight.shape[1])


@pytest.mark.parametrize("shape, strides, view", [
    ((), (), (1, 0, 0)),
    ((7,), (1,), (7, 0, 1)),
    ((7,), (3,), (7, 0, 3)),
    ((4, 5), (5, 1), (20, 0, 1)),
    ((4, 5), (1, 4), (5, 1, 4)),
    ((1, 4, 1, 5), (99, 5, 7, 1), (20, 0, 1)),
    ((2, 3, 4), (1, 2, 6), None),
])
def test_a_gradient_merges_into_at_most_two_dims(shape, strides, view):
    assert adam_mod._grad_view(shape, strides) == view


def _fake_fits(monkeypatch):
    monkeypatch.setattr(adam_mod, "leaf_table", lambda *args: True)


@pytest.mark.parametrize("case", ["cpu", "grad_clip", "float64"])
def test_the_composed_step_runs_where_the_kernel_does_not(monkeypatch, case):
    """The composed step on the CPU, with a global-norm clip (even where
    the leaves fit the kernel) and for float64 leaves (which the kernel's
    table refuses)."""
    ts, params = _solo("cpu")
    mu, nu = _moments(ts.opt_state)
    grads = [torch.ones_like(p) for p in params]
    ppo_cfg = PARAMS_TPU.ppo
    if case == "grad_clip":
        ppo_cfg = dataclasses.replace(ppo_cfg, grad_clip=0.5)
        _fake_fits(monkeypatch)
        assert ppo._takes_fused_adam(PARAMS_TPU.ppo, params, grads, mu, nu,
                                     0.1)
    if case == "float64":
        leaves = [[x.double() for x in xs] for xs in (params, grads, mu, nu)]
        assert adam_mod._table(*leaves, None) is None
        assert adam_mod._table(params, grads, mu, nu, None) is not None
        params, grads, mu, nu = leaves
    assert not ppo._takes_fused_adam(ppo_cfg, params, grads, mu, nu, 0.1)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("where", ["solo", "stacked"])
def test_the_counters_count_each_step(monkeypatch, where, fused):
    """``ppo.fused_adam``/``ppo.composed_adam`` count ``adam_update``'s
    steps by path, ``population.fused_adam``/``population.composed_adam``
    ``adam_step``'s (on the CPU the fused branch runs the plain version)."""
    if fused:
        _fake_fits(monkeypatch)
    names = [f"{where_}.{kind}_adam" for where_ in ("ppo", "population")
             for kind in ("fused", "composed")]
    before = {k: profiling.counter(k) for k in names}
    if where == "solo":
        ts, params = _solo("cpu")
        grads = [torch.full_like(p, 0.25) for p in params]
        ppo.adam_update(PARAMS_TPU.ppo, params, grads, ts.opt_state)
        monkeypatch.undo()
        ppo.adam_update(PARAMS_TPU.ppo, params, grads, ts.opt_state)
        assert ts.opt_state.count == 2
        prefix = "ppo"
    else:
        ppo_cfg, ps, grads = _population("cpu")
        bc1, bc2, neg_lr = _member_coefficients("cpu")
        twin = copy.deepcopy(ps)
        g = grads()
        population.adam_step(ppo_cfg, ps, g, bc1[0], bc2[0], neg_lr)
        monkeypatch.undo()
        population.adam_step(ppo_cfg, twin, g, bc1[0], bc2[0], neg_lr)
        # The stacked step divides by tensors alike on either path.
        assert torch.equal(ps.policy.flat, twin.policy.flat)
        prefix = "population"
    rose = {k: profiling.counter(k) - before[k] for k in names}
    kind = "fused" if fused else "composed"
    assert rose == {k: (k == f"{prefix}.{kind}_adam") + (
        k == f"{prefix}.composed_adam") for k in names}


# --- on the card ------------------------------------------------------------


def _composed(monkeypatch):
    monkeypatch.setattr(ppo, "_takes_fused_adam", lambda *args: False)


def _solo_steps(device, grads_of, fused, monkeypatch, steps=5):
    if not fused:
        _composed(monkeypatch)
    ts, params = _solo(device)
    before = profiling.counter("ppo.fused_adam")
    for step in range(steps):
        ppo.adam_update(PARAMS_TPU.ppo, params, grads_of(step, params),
                        ts.opt_state)
    assert profiling.counter("ppo.fused_adam") - before == (steps if fused
                                                            else 0)
    monkeypatch.undo()
    torch.cuda.synchronize()
    return ts.opt_state, [p.detach().clone() for p in params]


@pytest.mark.cuda
@pytest.mark.parametrize("grads", ["random", "zero", "subnormal"])
def test_fused_solo_step_equals_the_composed_step(cuda, monkeypatch, grads):
    """params_tpu's 12 leaves over 5 steps: parameters, moments and count
    to the bit, with random gradients, all-zero ones and ones below 1e-38
    (subnormal, as are their squares' products: the kernel flushes
    nothing)."""
    def grads_of(step, params):
        gen = torch.Generator(cuda).manual_seed(step)
        out = []
        for p in params:
            g = torch.randn(p.shape, generator=gen, device=cuda)
            out.append({"random": g, "zero": torch.zeros_like(g),
                        "subnormal": g * 1e-39}[grads])
        return out

    fused = _solo_steps(cuda, grads_of, True, monkeypatch)
    composed = _solo_steps(cuda, grads_of, False, monkeypatch)
    assert fused[0].count == composed[0].count == 5
    assert _equal(fused[1], composed[1])
    assert _equal(fused[0].mu.values(), composed[0].mu.values())
    assert _equal(fused[0].nu.values(), composed[0].nu.values())
    if grads == "subnormal":
        assert any(bool(((v > 0) & (v < 1.2e-38)).any())
                   for v in fused[0].mu.values())


@pytest.mark.cuda
@pytest.mark.parametrize("members, launches_a_step", [(4, 1), (8, 2)])
def test_fused_stacked_step_equals_the_composed_step(cuda, monkeypatch,
                                                     members,
                                                     launches_a_step):
    """P members on the stacked (P, D) tensors over 5 steps, the gradients
    from a real ``population_loss_and_stats`` backward (``baddbmm``'s
    transposed weight gradients), each member its own rate and bias
    corrections: the parameters and moments to the bit.  A launch takes 56
    segments (one leaf of one member each), so P = 4 (48) is one launch a
    step and P = 8 (96, the 8-member sweeps) two."""
    out = {}
    for fused in (True, False):
        if not fused:
            _composed(monkeypatch)
        ppo_cfg, ps, grads = _population(cuda, members, rows=128)
        bc1, bc2, neg_lr = _member_coefficients(cuda, members)
        launches = adam_mod.adam.launches
        for step in range(5):
            g = grads()
            assert any(not x.is_contiguous() for x in g)
            population.adam_step(ppo_cfg, ps, g, bc1[step], bc2[step],
                                 neg_lr)
        assert adam_mod.adam.launches - launches == (
            5 * launches_a_step if fused else 0)
        monkeypatch.undo()
        out[fused] = ps
    assert torch.equal(out[True].policy.flat, out[False].policy.flat)
    assert torch.equal(out[True].mu, out[False].mu)
    assert torch.equal(out[True].nu, out[False].nu)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_fused_step_in_the_global_layout_at_world_size_1(cuda, monkeypatch):
    """One epoch of 4 steps of ``sgd_epochs`` in ``GlobalLayout`` on NCCL
    at world size 1, whose gradients are views into the all-reduced flat
    buffer (at any offset): fused against composed, the parameters,
    moments and count to the bit."""
    env_cfg = PARAMS_TPU.env
    ppo_cfg = dataclasses.replace(PARAMS_TPU.ppo, num_envs=512,
                                  rollout_length=4, sgd_minibatch_size=512,
                                  num_sgd_iter=1)
    x = ppo_head_inputs(env_cfg, ppo_cfg, 1, ppo_cfg.batch_size, 9, cuda)
    gen = torch.Generator(cuda).manual_seed(9)
    batch = _rollout_batch(env_cfg, ppo.init_train_state(
        5, env_cfg, ppo_cfg, cuda).policy, x, torch.randn(
            (ppo_cfg.batch_size, 6), generator=gen, device=cuda), gen)
    perms = np.random.default_rng(9).permutation(ppo_cfg.batch_size)[None]
    distributed.initialize(backend="nccl",
                           init_method=f"tcp://localhost:{_free_port()}",
                           world_size=1, rank=0)
    try:
        out = {}
        for fused in (True, False):
            if not fused:
                _composed(monkeypatch)
            ts = ppo.init_train_state(5, env_cfg, ppo_cfg, cuda)
            before = profiling.counter("ppo.fused_adam")
            layout = ppo.GlobalLayout(EnvShard(0, 1, ppo_cfg.num_envs))
            state, _ = ppo.sgd_epochs(env_cfg, ppo_cfg, ts.policy,
                                      ts.opt_state, ts.kl_coeff, batch,
                                      ts.generator, 0.01, perms=perms,
                                      layout=layout)
            assert profiling.counter("ppo.fused_adam") - before == (
                4 if fused else 0)
            monkeypatch.undo()
            out[fused] = (state, [p.detach().clone()
                                  for p in ts.policy.parameters()])
    finally:
        distributed.shutdown()
    (s1, p1), (s0, p0) = out[True], out[False]
    assert s1.count == s0.count == 4
    assert _equal(p1, p0)
    assert _equal(s1.mu.values(), s0.mu.values())
    assert _equal(s1.nu.values(), s0.nu.values())
