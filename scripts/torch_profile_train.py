#!/usr/bin/env python3
"""Where the port's learning half (or its scoring loop) spends its time on
a card, by the program's own spans.

usage: python scripts/torch_profile_train.py [config.yml] [--epochs N]
           [--score CHECKPOINT] [--trace-dir DIR] [--top K]
       python scripts/torch_profile_train.py --workload CELL [--seed N]
           [--seconds S] [--top K]

Training (the default): builds the train state at the config's geometry
(default ``configs/params_tpu.yml``) and runs a rollout and ``ppo.learn``
with ``--epochs`` epochs three times: a warm-up, a run without the
profiler (the spans' host times), and a run whose ``ppo.learn`` is under
``utils.profiling.trace`` (CPU and CUDA activity).  With ``--score``, the
run config's env scores ``CHECKPOINT`` (512 stochastic and 2 deterministic
zero-start episodes, as the evaluate CLI does) the same three times.

With ``--workload``, a training cell of the benchmark (``train.*`` or
``sweep.*``, from the root of a checkout): the cell is set up as
``benchmark.run`` sets it up, its window runs for ``--seconds`` and its
profiled slice (one rollout and one learning epoch) is read by the
learning call that the slice's ``bench.learn`` range wraps.  No output
check runs.  The JSON line then holds the workload, seed, card, torch,
the slice's ``updates``, ``busy_ms`` and ``window_ms`` and
``kernels_by_span``.

Prints one JSON line:

- ``clock``: the profiler's host clock against the spans': a
  ``record_function`` opened inside a span at the start and at the end of
  the profiled run, its start after the span's and its end before the
  span's end, in us (both small and positive when the clocks agree);
- ``spans``: for each span name in the profiled run, its count, its host
  ms and self host ms (less its children's), the device operations that
  start inside it (``kernels``, children included) and inside it alone
  (``kernels_self``), and the card's idle ms while it is the innermost
  span (``idle_ms``; ``(no span)`` outside every span);
- ``unprofiled_ms``: the median host ms of each span name in the run
  without the profiler;
- ``kernels_by_span`` (training): for each innermost span, the device ms
  and operations that start in it, each per update, with its ``--top``
  kernels by device ms (name, ms per update, operations per update);
- ``kernels_per_update`` (training): the device operations that start
  inside a ``ppo.update`` over the updates, and per phase
  (``ppo.loss``, ``ppo.grad``, ``ppo.adam``, the update's own);
  ``kernels_per_update_key_averages``: the count an earlier version of
  this script reported, the ``key_averages()`` rows with device time,
  which hold each operator beside its kernels;
- ``span_ns``: the host cost of one span, from 100,000 empty ones after a
  collection of the garbage;
- ``counters``: the store's counters.

The Chrome trace, with the spans on a track of their own, goes to
``--trace-dir`` (a new temporary directory by default).  Needs a card.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from q1physrl_torch.algo import ppo  # noqa: E402
from q1physrl_torch.algo.config import load_run_config  # noqa: E402
from q1physrl_torch.utils import profiling  # noqa: E402

OUTSIDE = "(no span)"
PHASES = ("ppo.loss", "ppo.grad", "ppo.adam", "ppo.update")


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def _clock_probe():
    """A span around a profiler range of the same name; the trace reads
    the range's kineto interval against the span's."""
    with profiling.span("clock.probe") as outer:
        with torch.profiler.record_function("clock.probe"):
            pass
    return outer


def _innermost(spans: list):
    """(starts, names): from each start on, the innermost of ``spans``
    (which nest: one thread opens them) until the next start."""
    points = []
    for e in spans:
        points.append((e.start_ns, 1, e.id, e))
        points.append((e.end_ns, 0, -e.id, e))
    points.sort(key=lambda p: p[:3])  # ends first at a tie, inner ends first
    starts, names, stack = [], [], []
    for t, is_start, _, e in points:
        if is_start:
            stack.append(e)
        else:
            stack.remove(e)
        starts.append(t)
        names.append(stack[-1].name if stack else OUTSIDE)
    return starts, names


def _name_at(segments, t) -> str:
    starts, names = segments
    i = bisect.bisect_right(starts, t) - 1
    return names[i] if i >= 0 else OUTSIDE


def _idle_by_span(segments, busy, lo, hi) -> dict:
    """Seconds of [lo, hi] outside the ``busy`` intervals, by innermost
    span (``lo`` is the first span's start)."""
    starts, names = segments
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    idle = collections.Counter()
    for a, b in zip(edges[::2], edges[1::2]):
        i = bisect.bisect_right(starts, a) - 1
        while a < b:
            end = min(b, starts[i + 1] if i + 1 < len(starts) else hi)
            idle[names[i]] += (end - a) * 1e-9
            a, i = end, i + 1
    return idle


def _kernels_by_span(ops, segments, per: int, top: int) -> dict:
    """Device ms and operations of ``ops`` ((name, start ns, end ns)) by the
    innermost span at their start, each over ``per``, with the ``top``
    kernels of each by device ms."""
    table = collections.defaultdict(lambda: collections.defaultdict(
        lambda: [0.0, 0]))
    for name, a, b in ops:
        row = table[_name_at(segments, a)][name[:100]]
        row[0] += (b - a) / 1e6
        row[1] += 1
    out = {}
    for where, kernels in sorted(table.items()):
        ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
        out[where] = {
            "ms": sum(ms for ms, _ in kernels.values()) / per,
            "ops": sum(n for _, n in kernels.values()) / per,
            "top": [[k, ms / per, n / per] for k, (ms, n) in ranked]}
    return out


def _device_ops(prof) -> list:
    """(name, start ns, end ns) of each device operation of the profiled
    run, on the spans' clock, by start."""
    from torch.autograd import DeviceType

    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    host_names = {e.name for e in events if e.device_type != DeviceType.CUDA}
    absolute = lambda us: t0 + round(us * 1e3)
    return sorted((absolute(e.time_range.start), absolute(e.time_range.end),
                   e.name) for e in events
                  if e.device_type == DeviceType.CUDA
                  and e.name not in host_names)


def analyse(prof, spans: list) -> dict:
    """The profiled run by span: host and self ms, kernels, idle ms."""
    from torch.autograd import DeviceType

    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    absolute = lambda us: t0 + round(us * 1e3)
    ops = [(a, b) for a, b, _ in _device_ops(prof)]
    probes = sorted((absolute(e.time_range.start), absolute(e.time_range.end))
                    for e in events if e.name == "clock.probe"
                    and e.device_type != DeviceType.CUDA)
    clock = [{"start_after_span_us": (a - s.start_ns) / 1e3,
              "end_before_span_us": (s.end_ns - b) / 1e3}
             for s, (a, b) in zip(
                 [e for e in spans if e.name == "clock.probe"], probes)]
    spans = [e for e in spans if e.name != "clock.probe"]

    segments = _innermost(spans)
    busy = []
    for a, b in ops:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    lo = min(e.start_ns for e in spans)
    hi = max(e.end_ns for e in spans)
    inside = [a for a, _ in ops if lo <= a <= hi]
    idle = _idle_by_span(segments, [(max(a, lo), min(b, hi)) for a, b in busy
                                    if b > lo and a < hi], lo, hi)
    own = collections.Counter(_name_at(segments, a) for a in inside)
    children = collections.defaultdict(int)
    for e in spans:
        if e.parent is not None:
            children[e.parent] += e.end_ns - e.start_ns
    table = {}
    for e in spans:
        row = table.setdefault(e.name, {"count": 0, "host_ms": 0.0,
                                        "self_host_ms": 0.0, "kernels": 0})
        row["count"] += 1
        row["host_ms"] += (e.end_ns - e.start_ns) / 1e6
        row["self_host_ms"] += (e.end_ns - e.start_ns - children[e.id]) / 1e6
        i, j = (bisect.bisect_left(inside, e.start_ns),
                bisect.bisect_right(inside, e.end_ns))
        row["kernels"] += j - i
    for name, row in table.items():
        row["kernels_self"] = own[name]
        row["idle_ms"] = idle[name] * 1e3
    table[OUTSIDE] = {"kernels_self": own[OUTSIDE],
                      "idle_ms": idle[OUTSIDE] * 1e3}
    return {"clock": clock, "window_ms": (hi - lo) / 1e6,
            "busy_ms": sum(min(b, hi) - max(a, lo) for a, b in busy
                           if b > lo and a < hi) / 1e6,
            "device_ops": len(inside), "spans": table}


def _median_ms(spans: list) -> dict:
    by_name = collections.defaultdict(list)
    for e in spans:
        by_name[e.name].append((e.end_ns - e.start_ns) / 1e6)
    return {k: statistics.median(v) for k, v in by_name.items()}


def _span_ns(n: int = 100_000) -> float:
    gc.collect()  # the profiler's events, which would be collected inside
    store = profiling.Store(capacity=n)
    with store.span("cost"):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with store.span("x"):
                pass
        return (time.perf_counter_ns() - t0) / n


def _run(prepare, work, trace_dir: str):
    """``work(prepare())`` three times: a warm-up, unprofiled, then with
    ``work`` profiled and a clock probe at each end.  Returns (unprofiled
    spans, profiled spans, the profiler)."""
    work(prepare())
    torch.cuda.synchronize()
    first = _last_id()
    work(prepare())
    torch.cuda.synchronize()
    plain = [e for e in profiling.events() if e.id > first]
    given = prepare()
    torch.cuda.synchronize()
    first = _last_id()
    with profiling.trace(trace_dir) as prof:
        _clock_probe()
        work(given)
        torch.cuda.synchronize()
        _clock_probe()
    traced = [e for e in profiling.events() if e.id > first and e.profiled]
    return plain, traced, prof


def _last_id() -> int:
    with profiling.span("profile.mark") as mark:
        pass
    return mark.id


def _train(args, run, device):
    env_cfg = dataclasses.replace(run.env, num_envs=None)
    cfg = dataclasses.replace(run.ppo, num_sgd_iter=args.epochs)
    state = {"ts": ppo.init_train_state(0, env_cfg, cfg, device)}

    def rollout():
        ts = state["ts"]
        env_state, stats, traj, boot = ppo.rollout(
            env_cfg, cfg, ts.policy, ts.env_state, ts.stats, ts.generator)
        ts = dataclasses.replace(ts, env_state=env_state, stats=stats)
        return ts, traj, boot

    def learn(given):
        ts, traj, boot = given
        state["ts"], _ = ppo.learn(env_cfg, cfg, ts, traj, boot)

    plain, traced, prof = _run(rollout, learn, args.trace_dir)
    out = analyse(prof, traced)
    rows = out["spans"]
    updates = rows["ppo.update"]["count"]
    keyed = sum(e.count for e in prof.key_averages() if _device_us(e) > 0)
    learn = [e for e in traced if e.name == "ppo.learn"][-1]
    named = [(name, a, b) for a, b, name in _device_ops(prof)]
    segments = _innermost([e for e in traced if e.name != "clock.probe"])
    return {**out,
            "kernels_by_span": _kernels_by_span(named, segments, updates,
                                                args.top),
            "geometry": {"envs": cfg.num_envs, "frames": cfg.rollout_length,
                         "minibatch": cfg.sgd_minibatch_size,
                         "epochs": cfg.num_sgd_iter, "updates": updates},
            "kernels_per_update": {
                "all": rows["ppo.update"]["kernels"] / updates,
                **{k: rows[k]["kernels_self"] / updates for k in PHASES}},
            "kernels_per_update_key_averages": keyed / updates,
            "learn_kernels": rows["ppo.learn"]["kernels"],
            "spans_per_learn": sum(e.root == learn.root for e in traced),
            "unprofiled_ms": _median_ms(plain),
            "unprofiled_learn_ms_per_update": sum(
                (e.end_ns - e.start_ns) / 1e6 for e in plain
                if e.name == "ppo.learn") / updates}


def _score(args, run, device):
    from q1physrl_torch import analyse as qanalyse
    from q1physrl_torch.models import Policy, import_policy_params

    policy = Policy(run.env, device=device)
    policy.load_state_dict(import_policy_params(args.score))

    def evaluate(_):
        for deterministic, episodes in ((False, 512), (True, 2)):
            qanalyse.zero_start_returns(policy, run.env,
                                        num_episodes=episodes,
                                        deterministic=deterministic, seed=1,
                                        device=device)

    plain, traced, prof = _run(lambda: None, evaluate, args.trace_dir)
    out = analyse(prof, traced)
    replays = [e for e in plain if e.name == "cuda_graph.replay"]
    frames = sum(e.attrs["frames"] for e in traced
                 if e.name == "cuda_graph.replay")
    return {**out, "frames": frames,
            "kernels_per_frame": out["device_ops"] / frames,
            "unprofiled_ms": _median_ms(plain),
            "unprofiled_replay_ms_per_frame": statistics.median(
                (e.end_ns - e.start_ns) / 1e6 / e.attrs["frames"]
                for e in replays)}


def _cell(args) -> dict:
    """A benchmark training cell's profiled slice by innermost learning
    span and kernel (``--workload``)."""
    from benchmark import registry
    from benchmark import spans as bench_spans

    bench = registry.load_benchmark()
    cell = registry.workload(bench, args.workload)
    mix = registry.traffic(cell["traffic"])
    prefix = {"train": "ppo", "sweep": "population"}.get(mix["kind"])
    if prefix is None:
        raise SystemExit(f"{args.workload} is no training cell")
    # The sweep's host loop prints its log rows: they go to stderr, so
    # that the JSON line is the only output.
    with contextlib.redirect_stdout(sys.stderr):
        job = registry.driver(mix["kind"]).Job(
            registry.config(bench, cell["config"]), mix, args.seed, "cuda")
        try:
            job.window(args.seconds)
            found = job.profile()
        finally:
            job.close()
    anchored = bench_spans.anchor(found, "bench.learn", f"{prefix}.learn")
    if anchored is None:
        raise RuntimeError("the slice's bench.learn range and the program's "
                           "learning span do not line up")
    offset, root = anchored
    learning = [e for e in profiling.events()
                if e.profiled and e.root == root.id]
    updates = sum(e.name == f"{prefix}.update" for e in learning)
    ops = [(name, round(a * 1e3) - offset, round(b * 1e3) - offset)
           for name, a, b in found.ops]
    return {"workload": args.workload, "seed": args.seed, "updates": updates,
            "busy_ms": found.busy_s * 1e3, "window_ms": found.window_s * 1e3,
            "kernels_by_span": _kernels_by_span(ops, _innermost(learning),
                                                updates, args.top)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("config", nargs="?",
                        default=str(ROOT / "configs" / "params_tpu.yml"))
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--score", metavar="CHECKPOINT")
    parser.add_argument("--trace-dir", default=None)
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--workload", metavar="CELL")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if args.workload:
        out = _cell(args)
        print(json.dumps({"device": smi, "torch": torch.__version__, **out}),
              flush=True)
        return
    args.trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="q1trace-")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = load_run_config(args.config)
    out = (_score if args.score else _train)(args, run,
                                             torch.device("cuda", 0))
    counters = profiling.counters()
    print(json.dumps({
        "config": str(Path(args.config).resolve().relative_to(ROOT)),
        "mode": "score" if args.score else "train", "device": smi,
        "torch": torch.__version__, "span_ns": _span_ns(),
        "counters": counters, "trace": args.trace_dir, **out}), flush=True)


if __name__ == "__main__":
    main()
