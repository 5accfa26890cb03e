"""Report per-member anneal-stage engagements of a gated sweep.

usage: python scripts/torch_gate_report.py <sweep_dir>

The port's copy of ``scripts/gate_report.py`` (standard library only): it
reads the ``members.json`` and ``logs/member_XX.jsonl`` that both
packages' sweeps write, and writes ``<sweep_dir>/gate_report.json`` with
the same keys.  For every member of an entropy-gated sweep
(``MemberSpec.gates``) it reports, for each stage transition, the env step
it engaged, the measured policy entropy at engagement, and whether the
GATE or the DEADLINE triggered it (gate: entropy at engagement <= the
stage's gate value; deadline otherwise).  Two faults of the original are
fixed here: a stage without a gate value (null) is a deadline engagement
rather than a TypeError, and a deadline of 0 is reported rather than
dropped.
"""

import json
import math
import os
import sys


def report(sweep_dir: str):
    with open(os.path.join(sweep_dir, "members.json")) as f:
        members = json.load(f)
    out = []
    for i, m in enumerate(members):
        gates = m.get("gates")
        log_path = os.path.join(sweep_dir, "logs", f"member_{i:02d}.jsonl")
        if not gates or not os.path.exists(log_path):
            continue
        rows = []
        with open(log_path) as f:
            for line in f:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # mid-write tail line
        transitions = []
        prev_stage = 0
        for r in rows:
            s = r.get("stage", 0)
            if s > prev_stage:
                for k in range(prev_stage + 1, s + 1):
                    gate_val, coeff, lr = gates[k][:3]
                    deadline = gates[k][3] if len(gates[k]) > 3 else None
                    ent = r.get("entropy", float("nan"))
                    gated = (gate_val is not None and not math.isnan(ent)
                             and ent <= gate_val)
                    transitions.append({
                        "stage": k, "coeff": coeff, "lr": lr,
                        "gate": gate_val, "deadline": deadline,
                        "env_steps": r.get("step"),
                        "entropy_at_engage": ent,
                        "trigger": "gate" if gated else "deadline",
                    })
                prev_stage = s
        out.append({"member": i, "label": m.get("label", str(i)),
                    "seed": m.get("seed"), "transitions": transitions})
    return out


def main(argv):
    sweep_dir = argv[0]
    result = report(sweep_dir)
    for m in result:
        print(f"member {m['member']} ({m['label']}, seed {m['seed']}):")
        for t in m["transitions"]:
            dl = (f" deadline={t['deadline']:.3g}"
                  if t["deadline"] is not None else "")
            print(f"  stage {t['stage']}: coeff={t['coeff']} "
                  f"@ {t['env_steps']:,} steps, "
                  f"entropy {t['entropy_at_engage']:.3f} "
                  f"(gate {t['gate']}{dl}) <- {t['trigger']}")
    out_path = os.path.join(sweep_dir, "gate_report.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
