"""Export an orbax single-run checkpoint of the JAX package as the RLLib
checkpoint pickle that the PyTorch port scores.

usage: JAX_PLATFORMS=cpu python scripts/torch_export_orbax.py <orbax_dir>
           <out_dir> [--train-state]

Restores ``<orbax_dir>`` with the JAX package on the CPU, into the train
state template of ``configs/run4.yml`` (as ``scripts/eval_sweep.py``
does; every orbax checkpoint of the repo was trained at its widths), and
writes ``<out_dir>/checkpoint`` and ``<out_dir>/checkpoint.tune_metadata``
with ``q1physrl_tpu.models.export_rllib.export_policy_params``.  The
metadata carries the iteration and env steps of ``<orbax_dir>.json`` (a
sweep's best-member record) when that file exists, else the restored
state's.  Then ``python -m q1physrl_torch.algo.evaluate <run.yml>
<out_dir>`` scores it.

With ``--train-state`` it also writes ``<out_dir>/train_state.pt``, the
port's single-run state (``q1physrl_torch/algo/checkpoint.py``): the
params, Adam's moments and update count, the KL coefficient, and the
iteration and env steps of the sidecar (else the restored state's).  It
holds no generator state (a JAX key has no torch counterpart), so a port
sweep warm-starts from it (``init_from``), reseeding the member's
generator, and a plain resume refuses it.

The script needs JAX and orbax; the port never runs it.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

RUN_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "run4.yml")


def restore(orbax_dir: str):
    """The JAX package's TrainState of ``orbax_dir``, restored on the CPU
    into the template of ``configs/run4.yml``."""
    from q1physrl_tpu.algo import checkpoint as ckpt_mod
    from q1physrl_tpu.algo.ppo import init_train_state
    from q1physrl_tpu.algo.train import load_run_config

    run = load_run_config(RUN_YAML)
    template = init_train_state(jax.random.key(0), run.env, run.ppo)
    return ckpt_mod.restore_checkpoint(orbax_dir.rstrip("/"), template)


def adam_state(opt_state):
    """The Adam moments and count inside the JAX package's optimizer
    state."""
    import optax

    (adam,) = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


def export(orbax_dir: str, out_dir: str, train_state: bool = False) -> str:
    """Write the pickle and its metadata (and with ``train_state`` the
    port's ``train_state.pt``); return the pickle's path."""
    from q1physrl_tpu.models.export_rllib import export_policy_params

    orbax_dir = orbax_dir.rstrip("/")
    ts = restore(orbax_dir)
    meta = {"iteration": int(ts.iteration), "env_steps": int(ts.env_steps)}
    sidecar = {}
    if os.path.exists(orbax_dir + ".json"):
        with open(orbax_dir + ".json") as f:
            sidecar = json.load(f)
        meta.update({k: int(v) for k, v in sidecar.items() if k in meta})
    os.makedirs(out_dir, exist_ok=True)
    params = jax.tree.map(lambda x: jax.device_get(x), ts.params)
    if train_state:
        _write_train_state(out_dir, ts, meta["iteration"],
                           float(sidecar.get("env_steps", ts.env_steps)))
    return export_policy_params(params, os.path.join(out_dir, "checkpoint"),
                                iteration=meta["iteration"],
                                timesteps_total=meta["env_steps"])


def _write_train_state(out_dir: str, ts, iteration: int, env_steps: float):
    import numpy as np
    import torch

    from q1physrl_torch.algo.checkpoint import STATE_FILE
    from q1physrl_torch.models import adam_state_from_jax, params_from_jax

    host = lambda tree: jax.tree.map(np.asarray, tree)
    adam = adam_state(ts.opt_state)
    torch.save({
        "params": params_from_jax(host(ts.params)),
        "opt_state": adam_state_from_jax(host(adam.mu), host(adam.nu),
                                         adam.count),
        "kl_coeff": torch.tensor(np.asarray(ts.kl_coeff),
                                 dtype=torch.float32),
        "iteration": iteration, "env_steps": env_steps,
    }, os.path.join(out_dir, STATE_FILE))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python scripts/torch_export_orbax.py",
        description="Export an orbax checkpoint as an RLLib pickle.")
    parser.add_argument("orbax_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--train-state", action="store_true",
                        help="also write the port's train_state.pt, for a "
                             "sweep's init_from")
    args = parser.parse_args(argv)
    path = export(args.orbax_dir, args.out_dir, args.train_state)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
