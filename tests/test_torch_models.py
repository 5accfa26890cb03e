"""The port's policy and action distributions against the JAX package: the
shipped checkpoint loaded by both, and JAX-initialised params carried
across with params_from_jax; plus sample statistics of both distribution
types drawn with a torch.Generator."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q1physrl_torch.env import Config as TConfig
from q1physrl_torch.models import (Categorical, GaussianSquashedGaussian,
                                   Policy, action_dist, import_policy_params,
                                   normc_init, params_from_jax)
from q1physrl_tpu import env as jenv
from q1physrl_tpu import models as jmodels

from _torch_common import t

torch.set_num_threads(1)

CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "data",
                          "checkpoints", "tpu_pb", "checkpoint")
# Float32 products summed in another order.  The shipped checkpoint's
# logits reach |33|, where one float32 ulp is 3.8e-6 and 256-term sums in
# another order differ by a few ulps: hence the relative term.
ATOL, RTOL = 1e-5, 2e-6


def _run4():
    return dataclasses.replace(TConfig.get_default(), action_range=10.0)


def _obs(rng, n=256):
    """Observations spread like the env's normalized ones."""
    return rng.normal(0.0, 1.0, (n, 6)).astype(np.float32)


def _compare_policies(cfg, tpolicy, jparams, seed):
    jcfg = jenv.Config(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(seed)
    obs, obs2 = _obs(rng), _obs(rng)
    with torch.no_grad():
        logits, value = tpolicy(t(obs))
        logits2, _ = tpolicy(t(obs2))
    jlogits, jvalue = jmodels.forward(jparams, jnp.asarray(obs))
    jlogits2, _ = jmodels.forward(jparams, jnp.asarray(obs2))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=RTOL,
                               atol=ATOL)

    # The distributions on the JAX logits, so that only the distribution
    # math is compared from here on.
    jl, jl2 = np.asarray(jlogits), np.asarray(jlogits2)
    td, td2 = action_dist(cfg, t(jl)), action_dist(cfg, t(jl2))
    jd = jmodels.action_dist(jcfg, jnp.asarray(jl))
    jd2 = jmodels.action_dist(jcfg, jnp.asarray(jl2))

    t_keys, t_yaw = td.mode()
    j_keys, j_yaw = jd.mode()
    assert t_keys.dtype == torch.int32
    np.testing.assert_array_equal(t_keys.numpy(), np.asarray(j_keys))
    np.testing.assert_allclose(t_yaw.numpy(), np.asarray(j_yaw), rtol=RTOL,
                               atol=ATOL)

    ka, ya = jd.sample(jax.random.key(seed))
    ka, ya = np.asarray(ka), np.asarray(ya)
    np.testing.assert_allclose(td.logp(t(ka), t(ya)).numpy(),
                               np.asarray(jd.logp(jnp.asarray(ka),
                                                  jnp.asarray(ya))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(td.entropy().numpy(), np.asarray(jd.entropy()),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(td.kl(td2).numpy(), np.asarray(jd.kl(jd2)),
                               rtol=RTOL, atol=ATOL)


def test_checkpoint_loads_alike_in_both_packages():
    cfg = _run4()
    policy = Policy(cfg, device="cpu")
    policy.load_state_dict(import_policy_params(CHECKPOINT))
    jparams = jmodels.import_policy_params(CHECKPOINT)
    _compare_policies(cfg, policy, jparams, seed=0)


@pytest.mark.parametrize("overrides", [
    {}, {"discrete_yaw_steps": 3}, {"allow_yaw": False},
    {"auto_jump": True}])
def test_params_from_jax(overrides):
    cfg = dataclasses.replace(_run4(), **overrides)
    jcfg = jenv.Config(**dataclasses.asdict(cfg))
    jparams = jmodels.init_params(jax.random.key(1), jcfg)
    as_numpy = jax.tree.map(np.asarray, jparams)
    policy = Policy(cfg, device="cpu")
    policy.load_state_dict(params_from_jax(as_numpy))
    assert policy.pi.layers[-1].out_features == cfg.num_action_logits
    _compare_policies(cfg, policy, jparams, seed=1)


def test_normc_init_and_policy_init():
    gen = torch.Generator("cpu").manual_seed(0)
    w = normc_init(64, 16, std=0.01, generator=gen)
    np.testing.assert_allclose(w.norm(dim=1).numpy(), 0.01, rtol=1e-5)
    a = Policy(_run4(), generator=torch.Generator("cpu").manual_seed(3))
    b = Policy(_run4(), generator=torch.Generator("cpu").manual_seed(3))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    sd = a.state_dict()
    np.testing.assert_allclose(sd["pi.layers.2.weight"].norm(dim=1).numpy(),
                               0.01, rtol=1e-5)
    np.testing.assert_allclose(sd["pi.layers.0.weight"].norm(dim=1).numpy(),
                               1.0, rtol=1e-5)
    assert not sd["vf.layers.0.bias"].any()


def test_categorical_sample_statistics():
    logits = torch.tensor([[0.3, -1.2, 2.0, 0.0]]).expand(200000, 4)
    gen = torch.Generator("cpu").manual_seed(0)
    x = Categorical(logits).sample(gen)
    freq = np.bincount(x.numpy(), minlength=4) / x.numel()
    np.testing.assert_allclose(freq, torch.softmax(logits[0], -1).numpy(),
                               atol=0.004)


def test_gaussian_squashed_gaussian_sample_statistics():
    """Unsquashed samples are N(mean, std) with the clips applied; squashed
    ones stay inside (low, high)."""
    n = 200000
    d = GaussianSquashedGaussian(mean_raw=torch.full((n,), 4.0),
                                 log_std_raw=torch.full((n,), -3.0),
                                 low=-10.0, high=10.0)
    gen = torch.Generator("cpu").manual_seed(0)
    x = d.sample(gen)
    assert float(x.min()) > -10.0 and float(x.max()) < 10.0
    u = d._unsquash(x.double())
    assert abs(float(u.mean()) - 3.0) < 0.001  # mean clipped to 3
    assert abs(float(u.std()) - np.exp(-3.0)) < 0.001
