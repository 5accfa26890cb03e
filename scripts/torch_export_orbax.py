"""Export an orbax single-run checkpoint of the JAX package as the RLLib
checkpoint pickle that the PyTorch port scores.

usage: JAX_PLATFORMS=cpu python scripts/torch_export_orbax.py <orbax_dir>
           <out_dir>

Restores ``<orbax_dir>`` with the JAX package on the CPU, into the train
state template of ``configs/run4.yml`` (as ``scripts/eval_sweep.py``
does; every orbax checkpoint of the repo was trained at its widths), and
writes ``<out_dir>/checkpoint`` and ``<out_dir>/checkpoint.tune_metadata``
with ``q1physrl_tpu.models.export_rllib.export_policy_params``.  The
metadata carries the iteration and env steps of ``<orbax_dir>.json`` (a
sweep's best-member record) when that file exists, else the restored
state's.  Then ``python -m q1physrl_torch.algo.evaluate <run.yml>
<out_dir>`` scores it.

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


def export(orbax_dir: str, out_dir: str) -> str:
    """Write the pickle and its metadata; return the pickle's path."""
    from q1physrl_tpu.algo import checkpoint as ckpt_mod
    from q1physrl_tpu.algo.ppo import init_train_state
    from q1physrl_tpu.algo.train import load_run_config
    from q1physrl_tpu.models.export_rllib import export_policy_params

    run = load_run_config(RUN_YAML)
    template = init_train_state(jax.random.key(0), run.env, run.ppo)
    orbax_dir = orbax_dir.rstrip("/")
    ts = ckpt_mod.restore_checkpoint(orbax_dir, template)
    meta = {"iteration": int(ts.iteration), "env_steps": int(ts.env_steps)}
    if os.path.exists(orbax_dir + ".json"):
        with open(orbax_dir + ".json") as f:
            meta.update({k: int(v) for k, v in json.load(f).items()
                         if k in meta})
    os.makedirs(out_dir, exist_ok=True)
    params = jax.tree.map(lambda x: jax.device_get(x), ts.params)
    return export_policy_params(params, os.path.join(out_dir, "checkpoint"),
                                iteration=meta["iteration"],
                                timesteps_total=meta["env_steps"])


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python scripts/torch_export_orbax.py",
        description="Export an orbax checkpoint as an RLLib pickle.")
    parser.add_argument("orbax_dir")
    parser.add_argument("out_dir")
    args = parser.parse_args(argv)
    path = export(args.orbax_dir, args.out_dir)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
