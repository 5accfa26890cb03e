"""Write the port's policy as an RLLib 0.8.4 checkpoint pickle, the format
both packages read (models/import_rllib.py is the reader):
``{worker: pickled {filters, state: {default_policy: {name: ndarray}}},
optimizer: [...], trainer_state: {}}`` plus a ``.tune_metadata`` file.

TF Dense kernels are ``(in, out)``; ``nn.Linear`` weights are ``(out, in)``,
so weights are transposed here.
"""

from __future__ import annotations

import pickle

import numpy as np

__all__ = ("export_policy_params",)

_TOWERS = {"pi": ("fc_1", "fc_2", "fc_out"),
           "vf": ("fc_value_1", "fc_value_2", "value_out")}


def export_policy_params(state_dict: dict, path: str, *, iteration: int = 0,
                         timesteps_total: int = 0, time_total_s: float = 0.0,
                         episodes_total: int = 0) -> str:
    """Write ``path`` (checkpoint pickle) and ``path + '.tune_metadata'``
    from a :class:`Policy` state dict; return ``path``."""
    weights = {}
    for tower, names in _TOWERS.items():
        for i, name in enumerate(names):
            w = state_dict[f"{tower}.layers.{i}.weight"]
            b = state_dict[f"{tower}.layers.{i}.bias"]
            weights[f"default_policy/{name}/kernel"] = np.ascontiguousarray(
                w.detach().cpu().numpy().T)
            weights[f"default_policy/{name}/bias"] = b.detach().cpu().numpy()

    worker = pickle.dumps({"filters": {}, "state": {"default_policy": weights}})
    data = {
        "worker": worker,
        "optimizer": [int(timesteps_total), int(timesteps_total)],
        "trainer_state": {},
    }
    with open(path, "wb") as f:
        pickle.dump(data, f)
    meta = {
        "iteration": int(iteration),
        "timesteps_total": int(timesteps_total),
        "time_total": float(time_total_s),
        "episodes_total": int(episodes_total),
    }
    with open(path + ".tune_metadata", "wb") as f:
        pickle.dump(meta, f)
    return path
