"""Evaluate every best-member snapshot of a population sweep, on the port.

usage: python scripts/torch_eval_sweep.py <base_run.yml> <sweep_dir>
           [episodes] [--device cuda|cpu]

The port's copy of ``scripts/eval_sweep.py``.  Runs the zero-start
instrument (``episodes`` stochastic, default 512, and 2 deterministic) on
each ``<sweep_dir>/best_member_XX`` snapshot that the port's sweep writes
(``algo/checkpoint.py:save_member_checkpoint``, the single-run format),
on the card unless ``--device cpu`` is given.  One policy object carries
every member's weights in turn, so on a card each mode's scoring loop is
captured once and reused, the weights copied in.  Writes
``<sweep_dir>/eval_summary.json`` with the JAX script's keys, sorted by
stochastic mean.
"""

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def main(argv):
    parser = argparse.ArgumentParser(prog="torch_eval_sweep.py")
    parser.add_argument("run_yaml")
    parser.add_argument("sweep_dir")
    parser.add_argument("episodes", nargs="?", type=int, default=512)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from q1physrl_torch import analyse
    from q1physrl_torch.algo.checkpoint import STATE_FILE
    from q1physrl_torch.algo.config import load_run_config
    from q1physrl_torch.models import Policy

    device = analyse.resolve_device(args.device)
    run = load_run_config(args.run_yaml)
    policy = Policy(run.env, device=device)

    labels = {}
    members_json = os.path.join(args.sweep_dir, "members.json")
    if os.path.exists(members_json):
        with open(members_json) as f:
            for i, m in enumerate(json.load(f)):
                labels[i] = m.get("label", str(i))

    rows = []
    for path in sorted(glob.glob(os.path.join(args.sweep_dir,
                                              "best_member_*"))):
        if not os.path.isdir(path):
            continue
        idx = int(path.rsplit("_", 1)[1])
        tree = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                          weights_only=True)
        policy.load_state_dict(tree["params"])
        meta = {}
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
        sto = analyse.eval_zero_start(policy, run.env,
                                      num_episodes=args.episodes,
                                      device=device)
        det = analyse.eval_zero_start(policy, run.env, num_episodes=2,
                                      deterministic=True, device=device)
        row = {
            "member": idx,
            "label": labels.get(idx, str(idx)),
            "checkpoint": path,
            "env_steps": int(tree["env_steps"]),
            "train_ema": meta.get("ema"),
            "stochastic_mean": sto["mean"],
            "stochastic_std": sto["std"],
            "stochastic_max": sto["max"],
            "deterministic": det["mean"],
        }
        rows.append(row)
        ema = meta.get("ema")
        print(f"member {idx:2d} {row['label']:>20s}: "
              f"sto {sto['mean']:7.1f} ± {sto['std']:.0f}  "
              f"det {det['mean']:7.1f}  "
              f"(ema {float('nan') if ema is None else ema:.1f}, "
              f"{row['env_steps'] / 1e6:.0f}M steps)", flush=True)

    if not rows:
        raise SystemExit(f"no best_member_* snapshot in {args.sweep_dir}")
    rows.sort(key=lambda r: -r["stochastic_mean"])
    out = os.path.join(args.sweep_dir, "eval_summary.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"\nwrote {out}; winner: member {rows[0]['member']} "
          f"({rows[0]['label']}) at {rows[0]['stochastic_mean']:.1f}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
