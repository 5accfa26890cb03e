"""The readers of the program's spans (``benchmark/spans.py`` and the
metrics that use it) on a synthetic slice and store: the anchor that
places the program's events on the slice, its refusal when the ends
disagree, the medians of the unprofiled events, and None without a
store."""

import types

import pytest

from benchmark import registry, spans, trace

T0 = 1_790_000_000_000_000_000  # the profiler's trace start, epoch ns
SPAN_METRICS = ("loss_ms_per_update.train", "grad_ms_per_update.train",
                "adam_ms_per_update.train", "kernels_per_update.train",
                "replay_ms_per_frame.score", "readback_ms_per_loop.score")


def _event(name, id, root, start_us, end_us, profiled=True, attrs=None,
           parent=None):
    if parent is None and id != root:
        parent = root
    return types.SimpleNamespace(
        name=name, id=id, parent=parent, root=root,
        start_ns=T0 + round(start_us * 1e3), end_ns=T0 + round(end_us * 1e3),
        attrs=attrs, profiled=profiled)


class _Store:
    def __init__(self, events):
        self._events = events

    def events(self, name):
        return [e for e in self._events if e.name == name]


def _slice(ops_us, learn_us):
    ops = [("kernel", a, a + 5.0) for a in ops_us]
    return trace.Slice(ops=ops, ranges={"bench.learn": [learn_us]},
                       start_us=0.0, end_us=10_000.0, busy_s=0.0,
                       breakdown={})


def _ctx(s=None):
    return types.SimpleNamespace(slice=s, window={})


def _learn(end_us=4_990.0, skew_us=20.0):
    """A profiled ppo.learn that starts ``skew_us`` after the slice's
    bench.learn (1,000 to 5,000 us), with two updates, and updates that
    do not belong to it."""
    return [
        _event("ppo.learn", 1, 1, 1_000.0 + skew_us, end_us + skew_us),
        _event("ppo.update", 2, 1, 1_100.0, 2_000.0),
        _event("ppo.update", 3, 1, 2_100.0, 3_000.0),
        _event("ppo.update", 4, 9, 3_100.0, 3_900.0),  # another learn
        _event("ppo.update", 5, 1, 3_100.0, 3_900.0, profiled=False),
    ]


def test_kernels_per_update_places_the_updates_by_the_anchor(monkeypatch):
    monkeypatch.setattr(spans, "store", lambda: _Store(_learn()))
    s = _slice([1_010.0, 1_130.0, 1_500.0, 2_130.0, 2_500.0, 2_990.0,
                3_050.0, 3_500.0], (1_000.0, 5_000.0))
    offset, learn = spans.anchor(s, "bench.learn", "ppo.learn")
    assert learn.id == 1 and offset == -T0 - 20_000
    # Shifted 20 us back: updates at 1,080-1,980 and 2,080-2,980 us.
    got = registry.reader("kernels_per_update.train")(_ctx(s))
    assert got == 4 / 2


def test_the_anchor_refuses_ends_that_disagree(monkeypatch):
    s = _slice([1_500.0], (1_000.0, 5_000.0))
    read = registry.reader("kernels_per_update.train")
    # The span's end lands 990 us before the range's: kept.
    monkeypatch.setattr(spans, "store",
                        lambda: _Store(_learn(end_us=4_010.0, skew_us=20.0)))
    assert spans.ANCHOR_NS == 1_000_000
    assert spans.anchor(s, "bench.learn", "ppo.learn") is not None
    assert read(_ctx(s)) == 0.5
    # 1,500 us: refused.
    monkeypatch.setattr(spans, "store",
                        lambda: _Store(_learn(end_us=3_500.0, skew_us=20.0)))
    assert spans.anchor(s, "bench.learn", "ppo.learn") is None
    assert read(_ctx(s)) is None


def test_host_times_are_medians_of_the_unprofiled_events(monkeypatch):
    events = [_event("ppo.loss", i, i, 0.0, ms * 1e3, profiled=False)
              for i, ms in enumerate([1.0, 2.0, 3.0, 100.0])]
    events.append(_event("ppo.loss", 10, 10, 0.0, 50_000.0))
    monkeypatch.setattr(spans, "store", lambda: _Store(events))
    assert registry.reader("loss_ms_per_update.train")(_ctx()) == 2.5
    assert registry.reader("grad_ms_per_update.train")(_ctx()) is None


def test_scoring_times_are_medians_per_kind_of_loop(monkeypatch):
    """Loops of 512 and of 2 episodes alternate: each kind's median,
    averaged over the kinds."""
    events = []
    # (episodes, replay us over 723 frames, readback us) of each loop.
    loops = [(512, 72_300.0, 40_000.0), (2, 723_000.0, 2_000.0),
             (512, 144_600.0, 30_000.0), (2, 723_000.0, 2_000.0),
             (512, 216_900.0, 20_000.0)]
    for i, (episodes, replay_us, readback_us) in enumerate(loops):
        call = 100 + 10 * i
        events += [
            _event("analyse.zero_start", call, call, 0.0, 1e6,
                   profiled=False, attrs={"episodes": episodes}),
            _event("cuda_graph.replay", call + 1, call, 0.0, replay_us,
                   profiled=False, attrs={"frames": 723}),
            _event("analyse.readback", call + 2, call, 0.0, readback_us,
                   profiled=False)]
    # Profiled, or without its call in the store: left out.
    events += [_event("analyse.readback", 200, 100, 0.0, 9e6),
               _event("analyse.readback", 201, 999, 0.0, 9e6,
                      profiled=False)]
    monkeypatch.setattr(spans, "store", lambda: _Store(events))
    assert registry.reader("replay_ms_per_frame.score")(_ctx()) == \
        pytest.approx((0.2 + 1.0) / 2)
    assert registry.reader("readback_ms_per_loop.score")(_ctx()) == \
        pytest.approx((30.0 + 2.0) / 2)


@pytest.mark.parametrize("store", [None, _Store([])])
def test_without_the_programs_events_the_readers_find_nothing(monkeypatch,
                                                              store):
    monkeypatch.setattr(spans, "store", lambda: store)
    s = _slice([1_500.0], (1_000.0, 5_000.0))
    for name in SPAN_METRICS:
        assert registry.reader(name)(_ctx(s)) is None, name
    assert spans.anchor(None, "bench.learn", "ppo.learn") is None


def test_the_store_is_the_programs():
    from q1physrl_torch.utils import profiling

    assert spans.store() is profiling.STORE
