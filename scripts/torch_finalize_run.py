"""Post-training pipeline on the port: evaluate the latest checkpoint of a
training run and export its artifacts.

usage: python scripts/torch_finalize_run.py <run.yaml> <checkpoint_dir>
           <out_dir> [--device cuda|cpu]

The port's copy of ``scripts/finalize_run.py``, on the card unless
``--device cpu`` is given.  Restores the latest ``iter_*`` of
``<checkpoint_dir>`` (or ``<checkpoint_dir>`` itself, a checkpoint of the
single-run format, ``algo/checkpoint.py``) and writes in ``<out_dir>``,
with the JAX script's keys:

- eval.json            stochastic (512 episodes) and deterministic (2)
                       zero-start statistics
- run.dem              demo of the deterministic zero-start run
                       (``mkdemo.export_sim_demo``)
- checkpoint{,.tune_metadata}   RLLib-format export of the policy
- native/ + native_meta.json    a copy of the port's train-state file, the
                       resumable source of truth (``restore_checkpoint``
                       reads the directory)
- behaviour.json       air-strafe diagnostics (jumps, wish angles,
                       efficiency)

eval.json's "checkpoint" names the bundle's native export (repo-relative);
"source_checkpoint" records where the weights were restored from.
"""

import argparse
import json
import os
import shutil
import sys

# Recorded paths are relative to the REPO ROOT, not the process cwd.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _repo_rel(path: str) -> str:
    return os.path.relpath(os.path.abspath(path), REPO_ROOT)


def main(argv):
    parser = argparse.ArgumentParser(prog="torch_finalize_run.py")
    parser.add_argument("run_yaml")
    parser.add_argument("checkpoint_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    out_dir = args.out_dir

    from q1physrl_torch import analyse, mkdemo
    from q1physrl_torch.algo.checkpoint import STATE_FILE, latest_checkpoint
    from q1physrl_torch.algo.config import load_run_config
    from q1physrl_torch.models import Policy, export_policy_params

    device = analyse.resolve_device(args.device)
    os.makedirs(out_dir, exist_ok=True)
    run = load_run_config(args.run_yaml)
    path = latest_checkpoint(args.checkpoint_dir) or args.checkpoint_dir
    tree = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                      weights_only=True)
    policy = Policy(run.env, device=device)
    policy.load_state_dict(tree["params"])
    iteration, env_steps = int(tree["iteration"]), int(tree["env_steps"])
    print(f"checkpoint {path}: iter {iteration}, {env_steps:,} steps")

    # Copy the native checkpoint into the bundle first so the recorded
    # paths point at the bundle, not the (possibly ephemeral) restore
    # source.
    native_dir = os.path.join(out_dir, "native")
    os.makedirs(native_dir, exist_ok=True)
    shutil.copyfile(os.path.join(path, STATE_FILE),
                    os.path.join(native_dir, STATE_FILE))
    with open(f"{out_dir}/native_meta.json", "w") as f:
        json.dump({"iteration": iteration, "env_steps": env_steps,
                   "run_yaml": args.run_yaml,
                   "source_checkpoint": _repo_rel(path)}, f, indent=1)

    sto = analyse.eval_zero_start(policy, run.env, num_episodes=512,
                                  device=device)
    det = analyse.eval_zero_start(policy, run.env, num_episodes=2,
                                  deterministic=True, device=device)
    evals = {"checkpoint": _repo_rel(native_dir),
             "source_checkpoint": _repo_rel(path),
             "iteration": iteration, "env_steps": env_steps,
             "stochastic": sto, "deterministic": det["mean"]}
    print(json.dumps(evals, indent=1))
    with open(f"{out_dir}/eval.json", "w") as f:
        json.dump(evals, f, indent=1)

    r, corrected = mkdemo.export_sim_demo(policy, run.env,
                                          f"{out_dir}/run.dem",
                                          deterministic=True, device=device)
    print(f"demo: return {float(np.asarray(r.reward).sum()):.0f}, "
          f"corrected finish {corrected}")

    export_policy_params(policy.state_dict(), f"{out_dir}/checkpoint",
                         iteration=iteration, timesteps_total=env_steps)

    jumps = int((np.diff(r.jump.astype(int)) == 1).sum())
    ds = r.hypothetical_delta_speeds()
    actual = np.diff(r.speed, prepend=r.speed[0])
    eff = float(actual[30:].sum() / ds.max(axis=0)[30:].sum())
    wrapped = ((r.wish_angle - r.move_angle + 180) % 360 - 180)
    behaviour = {
        "jumps": jumps,
        "mean_speed": float(r.speed.mean()),
        "final_speed": float(r.speed[-1]),
        "dspeed_efficiency": eff,
        "median_abs_wish_move_angle": float(np.median(np.abs(wrapped))),
        "fwd_pressed_frac": float((r.fmove > 0).mean()),
        "corrected_finish_time": corrected,
    }
    print(json.dumps(behaviour, indent=1))
    with open(f"{out_dir}/behaviour.json", "w") as f:
        json.dump(behaviour, f, indent=1)
    return evals, behaviour


if __name__ == "__main__":
    main(sys.argv[1:])
