"""Read RLLib checkpoints into the port's :class:`Policy`, and carry the JAX
package's params pytree across.

An RLLib 0.8.4 checkpoint is a pickle of ``{worker: bytes, optimizer: [...],
trainer_state: {...}}`` where ``worker`` unpickles to ``{filters, state:
{default_policy: {name: ndarray}}}`` (weight names
``default_policy/fc_{1,2}/...`` etc.).  The arrays are plain NumPy, but the
pickle references ray classes — a tolerant unpickler stubs those out so no
ray/TF install is needed.  Both packages read and write this format.

TF Dense kernels and the JAX package's weights are ``(in, out)``;
``nn.Linear`` weights are ``(out, in)``, so weights are transposed here.
"""

from __future__ import annotations

import io
import pickle

import numpy as np
import torch

__all__ = ("load_rllib_checkpoint", "import_policy_params", "params_from_jax",
           "adam_state_from_jax", "population_params_from_jax",
           "population_adam_state_from_jax")

_POLICY_LAYERS = ("fc_1", "fc_2", "fc_out")
_VALUE_LAYERS = ("fc_value_1", "fc_value_2", "value_out")


class _StubUnpickler(pickle.Unpickler):
    """Unpickler that fabricates placeholder classes for unimportable
    modules (ray.*, tf.*) — only the ndarray leaves are needed."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            def _setstate(self, s):
                self.__dict__.update(s if isinstance(s, dict) else {"_state": s})

            return type(name, (), {"__module__": module,
                                   "__setstate__": _setstate})


def _loads(data: bytes):
    return _StubUnpickler(io.BytesIO(data)).load()


def load_rllib_checkpoint(path: str) -> dict:
    """Load an RLLib checkpoint file -> {weight_name: ndarray} plus metadata.

    Returns dict with keys ``weights`` (name -> ndarray), ``optimizer``,
    ``filters``.
    """
    with open(path, "rb") as f:
        data = _StubUnpickler(f).load()
    worker = _loads(data["worker"])
    state = worker["state"]["default_policy"]
    if isinstance(state, bytes):
        state = _loads(state)
    weights = {k: np.asarray(v) for k, v in state.items()
               if isinstance(v, np.ndarray)}
    return {"weights": weights, "optimizer": data.get("optimizer"),
            "filters": worker.get("filters")}


def _state_dict(towers, dtype=torch.float32) -> dict:
    """{"pi"/"vf": [(W (..., in, out), b), ...]} -> a :class:`Policy` state
    dict of ``dtype`` (with the leading axes kept: a stacked one)."""
    sd = {}
    for tower, layers in towers.items():
        for i, (w, b) in enumerate(layers):
            sd[f"{tower}.layers.{i}.weight"] = torch.tensor(
                np.swapaxes(np.asarray(w), -1, -2), dtype=dtype)
            sd[f"{tower}.layers.{i}.bias"] = torch.tensor(
                np.asarray(b), dtype=dtype)
    return sd


def import_policy_params(path: str) -> dict:
    """RLLib checkpoint -> a :class:`Policy` state dict."""
    w = load_rllib_checkpoint(path)["weights"]

    def layers(names):
        return [(w[f"default_policy/{name}/kernel"],
                 w[f"default_policy/{name}/bias"]) for name in names]

    return _state_dict({"pi": layers(_POLICY_LAYERS),
                        "vf": layers(_VALUE_LAYERS)})


def params_from_jax(params, dtype=torch.float32) -> dict:
    """The JAX package's params pytree, as numpy arrays
    (``{"policy": [(W, b)] * 3, "value": [(W, b)] * 3}``, W laid out
    ``(in, out)``) -> a :class:`Policy` state dict of ``dtype`` (float64
    keeps float64 params exact).  Gradients and Adam moments of the same
    layout carry across the same way."""
    return _state_dict({"pi": params["policy"], "vf": params["value"]},
                       dtype)


def adam_state_from_jax(mu, nu, count, dtype=torch.float32) -> dict:
    """Adam's first and second moments (params-shaped pytrees of numpy
    arrays) and update count from the JAX package's optimizer state ->
    ``{"mu", "nu", "count"}``, the fields of ``algo.ppo.AdamState``, keyed
    by the :class:`Policy` parameter names."""
    return {"mu": params_from_jax(mu, dtype), "nu": params_from_jax(nu, dtype),
            "count": int(count)}


def population_params_from_jax(params, dtype=torch.float32) -> dict:
    """The JAX package's params of a population (its vmapped pytree: every
    leaf with a leading member axis P) -> a stacked state dict, each tensor
    ``(P, *shape)`` under :class:`Policy`'s names (``StackedPolicy``'s
    layout)."""
    return params_from_jax(params, dtype)


def population_adam_state_from_jax(mu, nu, count, dtype=torch.float32) -> dict:
    """Adam's stacked moments and the (P,) update counts of a population
    -> ``{"mu", "nu", "count"}``: stacked state dicts and a list of P
    ints."""
    return {"mu": params_from_jax(mu, dtype), "nu": params_from_jax(nu, dtype),
            "count": [int(c) for c in np.asarray(count).reshape(-1)]}
