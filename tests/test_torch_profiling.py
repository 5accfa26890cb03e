"""The port's store of spans and counters (``utils/profiling.py``): how
spans nest, what an error leaves, the ring's bound, the spans of the
learning halves (solo and population) and of the scoring loop, the clock
they share with ``torch.profiler``, and their place in ``trace()``'s
Chrome trace."""

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from q1physrl_torch import analyse
from q1physrl_torch.algo import population, ppo
from q1physrl_torch.algo.config import PPOConfig, load_run_config
from q1physrl_torch.models import Policy
from q1physrl_torch.utils import profiling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN4 = load_run_config(str(ROOT / "configs" / "run4.yml")).env
PROGRAM = ("ppo.", "cuda_graph.", "analyse.")


def _since(first_id: int) -> list:
    """The process's events opened after the span of ``first_id``."""
    return [e for e in profiling.events() if e.id > first_id]


def _last_id() -> int:
    with profiling.span("test.mark") as mark:
        pass
    return mark.id


def test_nested_spans_know_their_parent_and_root():
    store = profiling.Store()
    with store.span("outer", rows=8) as outer:
        with store.span("middle") as middle:
            with store.span("inner", k="v"):
                pass
        with store.span("sibling"):
            pass
    with store.span("next"):
        pass
    got = {e.name: e for e in store.events()}
    assert [e.name for e in store.events()] == ["inner", "middle", "sibling",
                                                "outer", "next"]
    assert got["outer"].parent is None and got["outer"].root == outer.id
    assert got["middle"].parent == outer.id
    assert got["inner"].parent == middle.id
    assert got["sibling"].parent == outer.id
    assert {got[k].root for k in ("middle", "inner", "sibling")} == {outer.id}
    assert got["next"].parent is None and got["next"].root == got["next"].id
    assert got["outer"].attrs == {"rows": 8}
    assert got["inner"].attrs == {"k": "v"} and got["middle"].attrs is None
    assert got["outer"].start_ns <= got["middle"].start_ns
    assert got["middle"].end_ns <= got["outer"].end_ns
    assert not any(e.profiled for e in store.events())
    assert len({e.id for e in store.events()}) == 5


def test_a_span_left_by_an_error_is_recorded_and_closed():
    store = profiling.Store()
    with pytest.raises(ValueError, match="stop"):
        with store.span("outer"):
            with store.span("inner"):
                raise ValueError("stop")
    assert [e.name for e in store.events()] == ["inner", "outer"]
    assert all(e.end_ns >= e.start_ns for e in store.events())
    with store.span("after") as after:
        pass
    assert after.parent is None and after.root == after.id
    assert store.total("outer")[0] == 1


def test_the_ring_keeps_the_newest_events_and_totals_keep_all():
    store = profiling.Store(capacity=4)
    for i in range(10):
        with store.span("x", i=i):
            time.sleep(0.001)
    store.count("rows", 5)
    store.count("rows")
    kept = store.events("x")
    assert [e.attrs["i"] for e in kept] == [6, 7, 8, 9]
    n, seconds = store.total("x")
    assert n == 10 and 0.01 <= seconds < 1.0
    assert store.total("never") == (0, 0.0)
    assert store.counter("rows") == 6 and store.counter("never") == 0


def test_sgd_epochs_records_each_update_with_its_three_phases():
    cfg = dataclasses.replace(RUN4, num_envs=None)
    p = PPOConfig(num_envs=16, rollout_length=4, num_sgd_iter=3,
                  sgd_minibatch_size=16)
    ts = ppo.init_train_state(0, cfg, p, "cpu")
    first = _last_id()
    ppo.train_iter(cfg, p, ts)
    got = _since(first)
    by_id = {e.id: e for e in got}
    learn, = [e for e in got if e.name == "ppo.learn"]
    gae, = [e for e in got if e.name == "ppo.gae"]
    epochs = [e for e in got if e.name == "ppo.epoch"]
    updates = [e for e in got if e.name == "ppo.update"]
    assert gae.parent == learn.id
    assert len(epochs) == p.num_sgd_iter
    assert len(updates) == p.num_sgd_iter * p.num_minibatches == 12
    assert all(by_id[u.parent].name == "ppo.epoch" for u in updates)
    for u in updates:
        children = sorted((e for e in got if e.parent == u.id),
                          key=lambda e: e.start_ns)
        assert [e.name for e in children] == ["ppo.loss", "ppo.grad",
                                              "ppo.adam"]
        assert all(u.start_ns <= e.start_ns <= e.end_ns <= u.end_ns
                   for e in children)
    assert all(e.root == learn.id for e in got if e.name.startswith("ppo."))


def test_population_records_each_stacked_update_and_counts_them():
    cfg = dataclasses.replace(RUN4, num_envs=None)
    p = PPOConfig(num_envs=8, rollout_length=4, num_sgd_iter=3,
                  sgd_minibatch_size=8)
    ps = population.init_population([1, 2], cfg, p, "cpu")
    coeffs = ppo.Coeffs(entropy_coeff=np.float32([0.01, 0.03]),
                        lr=np.float32([1e-4, 3e-4]),
                        kl_target=np.float32([0.0036, 0.0036]))
    counted = profiling.counter("population.updates")
    first = _last_id()
    population.train_iter(cfg, p, ps, coeffs)
    got = _since(first)
    learn, = [e for e in got if e.name == "population.learn"]
    updates = [e for e in got if e.name == "population.update"]
    assert len(updates) == p.num_sgd_iter * p.num_minibatches == 12
    assert profiling.counter("population.updates") - counted == 12
    for u in updates:
        assert u.parent == learn.id
        children = sorted((e for e in got if e.parent == u.id),
                          key=lambda e: e.start_ns)
        assert [e.name for e in children] == [
            "population.loss", "population.grad", "population.adam"]
        assert all(u.start_ns <= e.start_ns <= e.end_ns <= u.end_ns
                   for e in children)
    assert all(e.root == learn.id for e in got
               if e.name.startswith("population."))
    assert not [e for e in got if e.name.startswith("ppo.")]


def test_zero_start_returns_records_its_call_and_readback():
    cfg = dataclasses.replace(RUN4, time_limit=0.25)
    first = _last_id()
    ret = analyse.zero_start_returns(Policy(cfg, device="cpu"), cfg,
                                     num_episodes=3, seed=1, device="cpu")
    got = _since(first)
    assert ret.shape == (3,)
    call, = [e for e in got if e.name == "analyse.zero_start"]
    readback, = [e for e in got if e.name == "analyse.readback"]
    assert readback.parent == call.id and call.parent is None
    assert call.attrs == {"episodes": 3}
    assert call.start_ns <= readback.start_ns <= readback.end_ns \
        <= call.end_ns
    # The eager driver replays no graph.
    assert not [e for e in got if e.name.startswith("cuda_graph.")]


def test_spans_share_the_profilers_clock_and_are_no_profiler_events():
    cfg = dataclasses.replace(RUN4, num_envs=None, time_limit=0.25)
    p = PPOConfig(num_envs=16, rollout_length=4, num_sgd_iter=1,
                  sgd_minibatch_size=32)
    ts = ppo.init_train_state(0, cfg, p, "cpu")
    pad = 0.005  # the clocks agree well inside it
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("test.clock") as outer:
            time.sleep(pad)
            with record_function("test.range"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(pad)
        ppo.train_iter(cfg, p, ts)
        analyse.zero_start_returns(ts.policy, cfg, num_episodes=2,
                                   device="cpu")
    assert outer.profiled
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "test.range"]
    assert ranges
    for e in ranges:
        assert outer.start_ns < e.start_ns() <= e.end_ns() < outer.end_ns
    names = {e.name for e in prof.events()}
    assert "test.range" in names
    assert not [n for n in names if n.startswith(PROGRAM)]


def test_trace_writes_the_program_spans_into_its_chrome_trace(tmp_path):
    with profiling.span("test.before"):
        pass
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("test.traced", rows=64):
            time.sleep(0.002)
            torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.002)
    assert prof is not None
    doc = json.loads((tmp_path / "trace.json").read_text())
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "program"]
    mine, = [e for e in spans if e["name"] == "test.traced"]
    assert mine["args"]["rows"] == 64 and mine["args"]["parent"] is None
    matmuls = [e for e in doc["traceEvents"]
               if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    assert matmuls
    for mm in matmuls:
        assert mine["ts"] < mm["ts"]
        assert mm["ts"] + mm["dur"] < mine["ts"] + mine["dur"]
    assert not [e for e in spans if e["name"] == "test.before"]


def test_collectives_count_in_the_store_and_timed_run_in_a_span(tmp_path):
    from q1physrl_torch.parallel import distributed

    calls = profiling.counter("distributed.collectives")
    timed, _ = profiling.total("distributed.collective")
    distributed.initialize(backend="gloo",
                           init_method=f"file://{tmp_path / 'group'}",
                           world_size=1, rank=0)
    try:
        x = torch.arange(4.0)
        assert torch.equal(distributed.all_reduce_sum(x), x)
        distributed.time_collectives(True)
        try:
            assert torch.equal(distributed.all_reduce_max(x), x)
        finally:
            distributed.time_collectives(False)
    finally:
        distributed.shutdown()
    assert profiling.counter("distributed.collectives") == calls + 2
    assert profiling.total("distributed.collective")[0] == timed + 1
    span, = profiling.events("distributed.collective")[-1:]
    assert span.end_ns >= span.start_ns and span.parent is None


def test_the_profile_script_tables_a_learning_half_by_span(tmp_path):
    """``scripts/torch_profile_train.py``'s analysis on a CPU profile of a
    tiny learning half: each span's count, self time under its host time,
    and the idle time (all of it, with no device) split over the
    innermost spans."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_profile_train", ROOT / "scripts" / "torch_profile_train.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    cfg = dataclasses.replace(RUN4, num_envs=None)
    p = PPOConfig(num_envs=16, rollout_length=4, num_sgd_iter=2,
                  sgd_minibatch_size=32)
    ts = ppo.init_train_state(0, cfg, p, "cpu")
    env_state, stats, traj, boot = ppo.rollout(
        cfg, p, ts.policy, ts.env_state, ts.stats, ts.generator)
    ts = dataclasses.replace(ts, env_state=env_state, stats=stats)
    first = _last_id()
    with profiling.trace(str(tmp_path)) as prof:
        script._clock_probe()
        ppo.learn(cfg, p, ts, traj, boot)
        script._clock_probe()
    out = script.analyse(prof, [e for e in _since(first) if e.profiled])
    rows = out["spans"]
    assert rows["ppo.update"]["count"] == 4 and rows["ppo.loss"]["count"] == 4
    assert rows["ppo.learn"]["count"] == 1 and rows["ppo.epoch"]["count"] == 2
    for name in ("ppo.learn", "ppo.epoch", "ppo.update", "ppo.adam"):
        assert 0 <= rows[name]["self_host_ms"] <= rows[name]["host_ms"]
    assert rows["ppo.update"]["self_host_ms"] < rows["ppo.update"]["host_ms"]
    assert out["device_ops"] == 0 and out["busy_ms"] == 0
    idle = sum(row["idle_ms"] for row in rows.values())
    assert idle == pytest.approx(out["window_ms"], rel=1e-6)
    assert rows["ppo.loss"]["idle_ms"] == pytest.approx(
        rows["ppo.loss"]["self_host_ms"], rel=1e-6)
    assert len(out["clock"]) == 2
    assert all(c["start_after_span_us"] > 0 and c["end_before_span_us"] > 0
               for c in out["clock"])


def test_the_profile_script_gives_each_kernel_to_its_innermost_span():
    """``scripts/torch_profile_train.py``'s ``kernels_by_span``: each device
    operation goes to the innermost span open at its start (none before
    the first or after the last), its device ms and count over the
    updates, the top kernels by device ms."""
    import importlib.util
    import types

    spec = importlib.util.spec_from_file_location(
        "torch_profile_train", ROOT / "scripts" / "torch_profile_train.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    span = types.SimpleNamespace
    spans = [span(name="ppo.learn", id=1, start_ns=0, end_ns=100),
             span(name="ppo.update", id=2, start_ns=10, end_ns=50),
             span(name="ppo.adam", id=3, start_ns=40, end_ns=45)]
    ops = [("a", -5, 0), ("b", 5, 7), ("c", 12, 20), ("d", 41, 44),
           ("e", 46, 49), ("c", 30, 34), ("f", 120, 130)]
    out = script._kernels_by_span(ops, script._innermost(spans), 2, 1)
    assert sorted(out) == [script.OUTSIDE, "ppo.adam", "ppo.learn",
                           "ppo.update"]
    update = out["ppo.update"]
    assert update["ops"] == 1.5 and update["ms"] == pytest.approx(7.5e-6)
    assert update["top"] == [["c", pytest.approx(6e-6), 1.0]]
    assert out["ppo.adam"]["top"] == [["d", pytest.approx(1.5e-6), 0.5]]
    assert out[script.OUTSIDE]["ops"] == 1.0
    assert out["ppo.learn"]["top"][0][0] == "b"
