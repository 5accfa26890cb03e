"""The PPO loss head (``ops/ppo_head.py``).

On the CPU: its plain version, through ``ppo.loss_and_stats`` and
``population.population_loss_and_stats`` with the fused head forced on
(where the plain version runs), held to the composed head and autograd:
the loss, its statistics and the gradients of the logits and the value,
solo, stacked (P=3, B=16, distinct coefficients per member) and at scale
1/2, on inputs with ratio-1 and value ties, ratios at the clip, the yaw's
mean and log std at and past their clamps and saturated keys
(``chip_smoke.ppo_head_inputs``); the same through the towers; and the
choice of head with its counters.

Marked ``cuda``, on a card: the kernels against the plain version and the
composed head at the training cells' shapes (8,192 rows; 4 x 128), and
``sgd_epochs`` and the population's fused against composed.  Run them
with ``python -m pytest --noconftest -m cuda tests/test_torch_ppo_head.py``.
"""

import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from q1physrl_torch.algo import population, ppo
from q1physrl_torch.algo.config import load_run_config
from q1physrl_torch.models import Policy, StackedPolicy
from q1physrl_torch.models.policy import action_dist
from q1physrl_torch.ops import ppo_head as head_mod
from q1physrl_torch.utils import profiling

from chip_smoke import ppo_head_inputs, ulps_apart

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN4 = load_run_config(str(ROOT / "configs" / "run4.yml"))
PARAMS_TPU = load_run_config(str(ROOT / "configs" / "params_tpu.yml"))
SPACES = {"run4": (RUN4.env, RUN4.ppo),
          "params_tpu": (PARAMS_TPU.env, PARAMS_TPU.ppo),
          "run4_k3": (dataclasses.replace(RUN4.env, allow_jump=False),
                      RUN4.ppo)}
# (members, rows, scale)
CASES = {"solo": (1, 64, 1.0), "stacked": (3, 16, 1.0),
         "scale_half": (1, 64, 0.5)}
# The largest distance, in float32 ulps, of the kernel's logit gradients
# from autograd's through the composed head on the card.
MAX_ULPS = 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _batch(x) -> ppo.Batch:
    rows = tuple(x["value"].shape)
    return ppo.Batch(
        obs=torch.zeros(rows + (6,), dtype=x["value"].dtype,
                        device=x["value"].device),
        key_actions=x["key_actions"], yaw_actions=x["yaw_actions"],
        logits=x["behaviour_logits"], logp=x["behaviour_logp"],
        value=x["old_value"], advantage=x["advantage"],
        value_target=x["value_target"])


def _fused(monkeypatch, on: bool):
    monkeypatch.setattr(ppo, "_takes_fused_head", lambda *args: on)


def _loss(env_cfg, ppo_cfg, policy, batch, x, scale):
    """The loss and its statistics as the solo or the population path
    takes them."""
    if batch.value.dim() == 1:
        return ppo.loss_and_stats(env_cfg, ppo_cfg, policy, batch,
                                  x["kl_coeff"][0],
                                  float(x["entropy_coeff"][0]), scale)
    return population.population_loss_and_stats(
        env_cfg, ppo_cfg, policy, batch, x["kl_coeff"][:, None],
        x["entropy_coeff"][:, None])


def _head_loss(env_cfg, ppo_cfg, x, scale):
    """The loss on ``x``'s logits and value as leaves (a stub policy): the
    loss, its statistics and the gradients of the logits and the value."""
    logits = x["logits"].clone().requires_grad_()
    value = x["value"].clone().requires_grad_()
    total, stats = _loss(env_cfg, ppo_cfg, lambda obs: (logits, value),
                         _batch(x), x, scale)
    return (total, stats, *torch.autograd.grad(total, [logits, value]))


def _assert_close(got, want, rtol):
    scale = float(want.detach().abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * scale)


def test_inputs_hold_the_edge_cases():
    """The inputs' rows reach what the tests claim: ratio 1 and value ties,
    the ratio at 1 +- clip_param and the value change at +- vf_clip_param,
    the yaw's clamps at their bounds."""
    env_cfg, ppo_cfg = SPACES["run4"]
    x = ppo_head_inputs(env_cfg, ppo_cfg, 1, 64, 0, "cpu")
    logp = action_dist(env_cfg, x["logits"]).logp(x["key_actions"].T,
                                                  x["yaw_actions"])
    ratio = torch.exp(logp - x["behaviour_logp"])
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    assert torch.equal(ratio[0::8], torch.ones(8))
    assert torch.equal(ratio[1::8], f32(1 + ppo_cfg.clip_param).expand(8))
    assert torch.equal(ratio[2::8], f32(1 - ppo_cfg.clip_param).expand(8))
    dv = x["value"] - x["old_value"]
    assert torch.equal(dv[0::8], torch.zeros(8))
    assert torch.equal(dv[1::8], f32(ppo_cfg.vf_clip_param).expand(8))
    assert torch.equal(x["logits"][3::8, 8:], f32([3.0, 2.0]).expand(8, 2))
    assert torch.equal(x["logits"][5::8, 8:], f32([-3.0, -20.0]).expand(8, 2))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("space", list(SPACES))
def test_plain_version_equals_the_composed_head(monkeypatch, space, case,
                                                dtype):
    """The fused head (its plain version on the CPU) against the composed
    head and autograd: the loss, its statistics and the gradient of the
    logits to float64 rounding, or to a few float32 ulps (torch's CPU
    log_softmax and divisions by a scalar round otherwise than the card's,
    which the plain version follows); the value's gradient to the bit."""
    env_cfg, ppo_cfg = SPACES[space]
    members, rows, scale = CASES[case]
    x = ppo_head_inputs(env_cfg, ppo_cfg, members, rows, 1, "cpu", dtype)
    _fused(monkeypatch, False)
    want = _head_loss(env_cfg, ppo_cfg, x, scale)
    _fused(monkeypatch, True)
    got = _head_loss(env_cfg, ppo_cfg, x, scale)
    rtol = 1e-12 if dtype == "float64" else 2e-5
    for g, w in zip(got[:3], want[:3]):
        _assert_close(g, w, rtol)
    assert torch.equal(got[3], want[3])


def _rollout_batch(env_cfg, policy, x, obs, gen):
    """A batch on ``obs`` whose behaviour is the towers' own output, as a
    rollout records it, moved a little; the rest from ``x``."""
    with torch.no_grad():
        logits, value = policy(obs)
        logp = action_dist(env_cfg, logits).logp(
            x["key_actions"].movedim(-1, 0), x["yaw_actions"])
    noise = lambda t: t + 0.1 * torch.randn(t.shape, generator=gen,
                                            device=t.device)
    return _batch(x)._replace(obs=obs, logits=noise(logits),
                              logp=noise(logp), value=noise(value))


@pytest.mark.parametrize("members", [1, 3])
def test_fused_head_through_the_towers(monkeypatch, members):
    """The whole loss through the towers (a ``Policy``, or P=3 members'
    ``StackedPolicy``), fused against composed on the CPU: the loss and
    every parameter's gradient."""
    env_cfg, ppo_cfg = SPACES["run4"]
    rows = 32
    x = ppo_head_inputs(env_cfg, ppo_cfg, members, rows, 2, "cpu")
    gen = torch.Generator().manual_seed(2)
    obs = torch.randn(tuple(x["value"].shape) + (6,), generator=gen)
    policies = [Policy(env_cfg, torch.Generator().manual_seed(i))
                for i in range(members)]
    policy = (policies[0] if members == 1
              else StackedPolicy.from_policies(env_cfg, policies))
    batch = _rollout_batch(env_cfg, policy, x, obs, gen)
    out = {}
    for on in (False, True):
        _fused(monkeypatch, on)
        total, stats = _loss(env_cfg, ppo_cfg, policy, batch, x, 1.0)
        out[on] = (total, stats, torch.autograd.grad(
            total, list(policy.parameters())))
    _assert_close(out[True][0], out[False][0], 2e-5)
    _assert_close(out[True][1], out[False][1], 2e-5)
    for g, w in zip(out[True][2], out[False][2]):
        _assert_close(g, w, 1e-4)


def _batch_like(cuda: bool, rows=128, dtype=torch.float32):
    tensor = lambda shape, dt=dtype: types.SimpleNamespace(
        is_cuda=cuda, dtype=dt, shape=shape)
    return types.SimpleNamespace(obs=tensor((rows, 6)),
                                 logits=tensor((rows, 10)),
                                 value=tensor((rows,)))


def test_the_head_is_chosen_from_what_the_call_observes():
    """The fused head: float32 on a card, K Categorical(2) keys and a
    continuous yaw, a power-of-two gradient per row.  Else the composed:
    the CPU, float64, a discrete or absent yaw, rows or a rank share that
    are no power of two."""
    env_cfg = RUN4.env
    choose = ppo._takes_fused_head
    assert choose(env_cfg, _batch_like(True), 1.0)
    assert choose(env_cfg, _batch_like(True, rows=8192), 0.5)
    assert choose(dataclasses.replace(env_cfg, allow_jump=False),
                  _batch_like(True), 1.0)
    assert not choose(env_cfg, _batch_like(False), 1.0)
    assert not choose(env_cfg, _batch_like(True, dtype=torch.float64), 1.0)
    assert not choose(dataclasses.replace(env_cfg, discrete_yaw_steps=3),
                      _batch_like(True), 1.0)
    assert not choose(dataclasses.replace(env_cfg, allow_yaw=False),
                      _batch_like(True), 1.0)
    assert not choose(env_cfg, _batch_like(True, rows=96), 1.0)
    assert not choose(env_cfg, _batch_like(True), 1.0 / 3)


@pytest.mark.parametrize("change", [
    {}, {"discrete_yaw_steps": 3}, {"allow_yaw": False}])
def test_the_cpu_takes_the_composed_head(change):
    """On the CPU every action space runs the composed head, and the
    counters say so."""
    env_cfg = dataclasses.replace(RUN4.env, **change)
    ppo_cfg = RUN4.ppo
    policy = Policy(env_cfg, torch.Generator().manual_seed(0))
    rows, k = 16, env_cfg.num_keys
    gen = torch.Generator().manual_seed(0)
    yaw = (torch.rand(rows, generator=gen) * 18 - 9
           if env_cfg.discrete_yaw_steps == -1
           else torch.randint(0, 7, (rows,), generator=gen).float())
    batch = ppo.Batch(
        obs=torch.randn(rows, 6, generator=gen),
        key_actions=torch.randint(0, 2, (rows, k), generator=gen,
                                  dtype=torch.int32),
        yaw_actions=yaw,
        logits=torch.randn(rows, env_cfg.num_action_logits, generator=gen),
        logp=torch.randn(rows, generator=gen) - 3.0,
        value=torch.randn(rows, generator=gen),
        advantage=torch.randn(rows, generator=gen),
        value_target=torch.randn(rows, generator=gen))
    before = {k: profiling.counter(f"ppo.{k}_heads")
              for k in ("fused", "composed")}
    total, _ = ppo.loss_and_stats(env_cfg, ppo_cfg, policy, batch,
                                  torch.tensor(0.2), 0.01)
    assert torch.isfinite(total)
    assert profiling.counter("ppo.composed_heads") == before["composed"] + 1
    assert profiling.counter("ppo.fused_heads") == before["fused"]


# --- on the card ------------------------------------------------------------


def _args(x):
    return (x["logits"], x["value"], x["behaviour_logits"],
            x["key_actions"], x["yaw_actions"], x["behaviour_logp"],
            x["advantage"], x["old_value"], x["value_target"])


@pytest.mark.cuda
@pytest.mark.parametrize("members, rows", [(1, 8192), (4, 128)])
def test_kernel_equals_plain_version_and_composed_head(cuda, monkeypatch,
                                                       members, rows):
    """At the training cells' shapes: the forward terms to the bit against
    the plain version and the composed head; the unit gradient of the
    value to the bit against the plain version's, and of the logits within
    its float64 fma; the gradients of the value and the logits through the
    loss against autograd through the composed head, to the bit and within
    MAX_ULPS."""
    env_cfg, ppo_cfg = SPACES["params_tpu"]
    x = ppo_head_inputs(env_cfg, ppo_cfg, members, rows, 3, cuda)
    params = head_mod.HeadParams(env_cfg.num_keys, env_cfg.action_range,
                            ppo_cfg.clip_param, ppo_cfg.vf_clip_param,
                            ppo_cfg.vf_loss_coeff)
    kc, ec = x["kl_coeff"], x["entropy_coeff"]
    if members == 1:
        ec = float(ec[0])
    terms, grad = head_mod._forward(params, x["logits"], x["value"],
                                    _args(x)[2:], kc, ec)
    *plain, plain_grad = head_mod.ppo_head_plain(params, *_args(x), kc, ec)
    for t, p in zip(terms, plain):
        assert torch.equal(t, p)
    assert torch.equal(grad[..., -1], plain_grad[..., -1])
    print("unit gradient, kernel against plain, ulps:",
          ulps_apart(grad[..., :-1], plain_grad[..., :-1]))
    assert ulps_apart(grad[..., :-1], plain_grad[..., :-1]) <= 1

    _fused(monkeypatch, False)
    want = _head_loss(env_cfg, ppo_cfg, x, 1.0)
    composed = ppo.loss_terms(env_cfg, ppo_cfg,
                              lambda obs: (x["logits"], x["value"]),
                              _batch(x))
    assert torch.equal(terms[1], -composed[0])
    for t, c in zip(terms[2:], composed[1:]):
        assert torch.equal(t, c)
    _fused(monkeypatch, True)
    got = _head_loss(env_cfg, ppo_cfg, x, 1.0)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[3], want[3])
    per_column = [ulps_apart(got[2][..., j], want[2][..., j])
                  for j in range(got[2].shape[-1])]
    print("logit gradients, fused against composed, ulps by column:",
          per_column)
    assert max(per_column) <= MAX_ULPS


@pytest.mark.cuda
def test_fused_head_takes_strided_minibatches(cuda, monkeypatch):
    """A stacked minibatch sliced out of a longer batch (its rows strided,
    as a caller of ``population.minibatch_step`` may slice them): the fused
    head's loss, statistics and gradients equal the composed head's to the
    bit."""
    env_cfg, ppo_cfg = SPACES["params_tpu"]
    x = ppo_head_inputs(env_cfg, ppo_cfg, 4, 256, 7, cuda)
    x = {k: v[:, :128] if v.dim() > 1 else v for k, v in x.items()}
    assert not x["behaviour_logits"].is_contiguous()
    x["logits"], x["value"] = (x["logits"].contiguous(),
                               x["value"].contiguous())
    _fused(monkeypatch, False)
    want = _head_loss(env_cfg, ppo_cfg, x, 1.0)
    _fused(monkeypatch, True)
    got = _head_loss(env_cfg, ppo_cfg, x, 1.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _recorded(module, name, monkeypatch):
    """Wrap ``module.name`` (a loss function) to record each step's loss."""
    fn, losses = getattr(module, name), []

    def recorded(*args, **kwargs):
        total, stats = fn(*args, **kwargs)
        losses.append(total.detach().clone())
        return total, stats

    monkeypatch.setattr(module, name, recorded)
    return losses


def _gaps(a, b):
    return max(float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
               for x, y in zip(a, b))


@pytest.mark.cuda
def test_sgd_epochs_fused_against_composed(cuda, monkeypatch):
    """One epoch of 3 Adam steps of 2,048 rows under params_tpu's PPO
    coefficients, fused against composed, with the same permutation: each
    step's loss to the bit; the weights' largest relative gap printed."""
    env_cfg = PARAMS_TPU.env
    ppo_cfg = dataclasses.replace(PARAMS_TPU.ppo, num_envs=1024,
                                  rollout_length=6, sgd_minibatch_size=2048,
                                  num_sgd_iter=1)
    x = ppo_head_inputs(env_cfg, ppo_cfg, 1, ppo_cfg.batch_size, 4, cuda)
    gen = torch.Generator(cuda).manual_seed(4)
    obs = torch.randn((ppo_cfg.batch_size, 6), generator=gen, device=cuda)
    batch = _rollout_batch(env_cfg, ppo.init_train_state(
        5, env_cfg, ppo_cfg, cuda).policy, x, obs, gen)
    perms = np.random.default_rng(4).permutation(
        ppo_cfg.batch_size)[None]
    out = {}
    for on in (False, True):
        _fused(monkeypatch, on)
        losses = _recorded(ppo, "loss_and_stats", monkeypatch)
        ts = ppo.init_train_state(5, env_cfg, ppo_cfg, cuda)
        before = profiling.counter("ppo.fused_heads")
        ppo.sgd_epochs(env_cfg, ppo_cfg, ts.policy, ts.opt_state,
                       ts.kl_coeff, batch, ts.generator, 0.02, perms=perms)
        assert profiling.counter("ppo.fused_heads") - before == (3 if on
                                                                 else 0)
        monkeypatch.undo()
        out[on] = (losses, [p.detach() for p in ts.policy.parameters()])
    print("weights' largest relative gap:", _gaps(out[True][1],
                                                  out[False][1]))
    assert len(out[True][0]) == 3
    for got, want in zip(out[True][0], out[False][0]):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_population_sgd_epochs_fused_against_composed(cuda, monkeypatch):
    """One epoch of 3 stacked steps of 4 x 128 rows, fused against
    composed, with the same permutations: each step's losses to the bit;
    the weights' largest relative gap printed."""
    env_cfg = RUN4.env
    ppo_cfg = dataclasses.replace(RUN4.ppo, num_envs=128, rollout_length=3,
                                  sgd_minibatch_size=128, num_sgd_iter=1)
    members = 4
    x = ppo_head_inputs(env_cfg, ppo_cfg, members, ppo_cfg.batch_size, 6,
                        cuda)
    gen = torch.Generator(cuda).manual_seed(6)
    obs = torch.randn((members, ppo_cfg.batch_size, 6), generator=gen,
                      device=cuda)
    seeds = [7, 8, 9, 10]
    batch = _rollout_batch(env_cfg, population.init_population(
        seeds, env_cfg, ppo_cfg, cuda).policy, x, obs, gen)
    rng = np.random.default_rng(6)
    perms = np.stack([rng.permutation(ppo_cfg.batch_size)[None]
                      for _ in range(members)])
    entropy_coeff = x["entropy_coeff"]
    lr = torch.full((members,), 5e-6, device=cuda)
    out = {}
    for on in (False, True):
        _fused(monkeypatch, on)
        losses = _recorded(population, "population_loss_and_stats",
                           monkeypatch)
        ps = population.init_population(seeds, env_cfg, ppo_cfg, cuda)
        ps.kl_coeff = x["kl_coeff"].clone()
        population.sgd_epochs(env_cfg, ppo_cfg, ps, batch, entropy_coeff,
                              lr, perms=perms)
        monkeypatch.undo()
        out[on] = (losses, [ps.policy.flat.detach().clone()])
    print("weights' largest relative gap:", _gaps(out[True][1],
                                                  out[False][1]))
    assert len(out[True][0]) == 3
    for got, want in zip(out[True][0], out[False][0]):
        assert torch.equal(got, want)
