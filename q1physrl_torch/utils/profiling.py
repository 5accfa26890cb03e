"""The port's store of spans and counters, its ``torch.profiler`` export,
and the card's memory statistics.

A span times one call of a layer on the host::

    with profiling.span("ppo.update"):
        ...

and keeps an :class:`Event`: its name, its own id, its parent's and its
root's (every span of one ``ppo.learn`` or one evaluation shares the
root's id), its start and end in ns, its attributes, and ``profiled``,
whether a ``torch.profiler`` was running when it began.  A counter adds
up what a layer did (``count("cuda_graph.frames", n)``).

Events are stamped with ``time.time_ns()``, the clock on which the
profiler stamps its host events (kineto's epoch ns), so an event lies on
a profiled slice where the work it wraps does; :func:`trace` writes the
program's events into its Chrome trace beside the kernels they issued.

Spans never enter a profiler range: a ``record_function`` gets a copy on
the device that covers its kernels, which a device trace would count as an
operation.  The store is always on; spans sit at per-call, per-update and
per-loop boundaries only, never per frame or per kernel.  The events sit
in a bounded ring (the oldest dropped past ``CAPACITY``); the per-name
totals and the counters cover the whole process.  Spans nest on one stack
per store: the port opens them on one thread.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

from .device import resolve_device

__all__ = ("Event", "Store", "STORE", "span", "count", "events", "total",
           "counter", "counters", "trace", "device_memory_stats")

# Events kept: a 51 s window of training issues about 30,000 spans.
CAPACITY = 1 << 17


class Event:
    """One span: a context manager while it runs, the record after."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "attrs", "profiled", "_store")

    def __init__(self, store: "Store", name: str, attrs):
        self._store = store
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        store = self._store
        stack = store._stack
        self.id = i = next(store._ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[0].id
        else:
            self.parent, self.root = None, i
        self.profiled = _autograd_profiler._is_profiler_enabled
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = end = time.time_ns()
        store = self._store
        store._stack.pop()
        store._events.append(self)
        totals = store._totals.get(self.name)
        if totals is None:
            totals = store._totals[self.name] = [0, 0]
        totals[0] += 1
        totals[1] += end - self.start_ns
        return False


class Store:
    """Spans and counters of one process (or of a test)."""

    def __init__(self, capacity: int = CAPACITY):
        self._events = collections.deque(maxlen=capacity)
        self._totals = {}  # name -> [count, ns]
        self._counters = collections.Counter()
        self._ids = itertools.count(1)
        self._stack = []  # the open spans, outermost first

    def span(self, name: str, **attrs) -> Event:
        return Event(self, name, attrs or None)

    def count(self, name: str, n=1):
        self._counters[name] += n

    def events(self, name: str = None) -> list:
        """The kept events, oldest first; of one name where given."""
        if name is None:
            return list(self._events)
        return [e for e in self._events if e.name == name]

    def total(self, name: str) -> tuple:
        """(spans, seconds) of every span of ``name`` closed so far."""
        n, ns = self._totals.get(name, (0, 0))
        return n, ns * 1e-9

    def counter(self, name: str):
        return self._counters[name]

    def counters(self) -> dict:
        return dict(self._counters)


STORE = Store()
span = STORE.span
count = STORE.count
events = STORE.events
total = STORE.total
counter = STORE.counter
counters = STORE.counters


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write a Chrome trace,
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing), with
    the program's spans of the block on a track of their own.  Yields the
    profiler, whose ``key_averages()`` sums time by operation."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    _write_spans(path, [e for e in events() if e.start_ns >= start_ns])


def _write_spans(path: str, spans: list):
    """Add ``spans`` to the Chrome trace at ``path``, as a thread of the
    process named "program spans".  Kineto writes its events' starts in us
    after ``baseTimeNanoseconds`` on the same epoch clock."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), "program spans"
    out = doc.setdefault("traceEvents", [])
    out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tid}})
    out.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                "tid": tid, "args": {"sort_index": -1}})
    for e in spans:
        out.append({"ph": "X", "cat": "program", "name": e.name, "pid": pid,
                    "tid": tid, "ts": (e.start_ns - base) / 1e3,
                    "dur": (e.end_ns - e.start_ns) / 1e3,
                    "args": {"id": e.id, "parent": e.parent, "root": e.root,
                             **(e.attrs or {})}})
    with open(path, "w") as f:
        json.dump(doc, f)


def device_memory_stats(device="cuda") -> dict:
    """The card's allocator statistics (bytes and counts,
    ``torch.cuda.memory_stats``); an empty dict for the CPU, whose
    allocator keeps none.  Raises for ``cuda`` without a card."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))
