"""The program's own spans, as the per-layer readers take them: the events
of the port's store (``q1physrl_torch.utils.profiling``), read after the
run, each with its name, ids, start and end in ns on the clock of the
profiler's host events, attributes and ``profiled`` (a profiler was
running when it began).

Host times are the median over the unprofiled events: the window's, with
set-up's few first ones, and without the profiled slice's, which the
profiler slows.  Where a cell runs calls of a few kinds in turn (a
scoring loop of 512 episodes, then one of 2), the median is taken for
each kind and the medians are averaged: the median of the mix would fall
anywhere between the kinds.  A program without the store, or a store
without the events asked for, gives None.
"""

from __future__ import annotations

import bisect
import collections
import statistics

# The most by which the ends of an anchor's range and span may disagree:
# on the card they disagree by 0.19-0.29 ms, the exit of the profiler's
# range after the span's end.
ANCHOR_NS = 1_000_000


def store():
    """The program's store of spans, or None where it has none."""
    try:
        from q1physrl_torch.utils import profiling
        return profiling.STORE
    except (ImportError, AttributeError):
        return None


def events(name: str) -> list:
    """The program's kept events of ``name``, oldest first."""
    s = store()
    return [] if s is None else s.events(name)


def median_ms(name: str, per: str = None):
    """Median host ms of the unprofiled events of ``name``, each over its
    attribute ``per`` where given; None where there are none."""
    times = [(e.end_ns - e.start_ns) / 1e6 / (e.attrs[per] if per else 1)
             for e in events(name) if not e.profiled]
    return statistics.median(times) if times else None


def median_ms_by_kind(name: str, parent_name: str, key: str,
                      per: str = None):
    """The mean over the kinds of call (the attribute ``key`` of the
    parent event, of ``parent_name``) of the median host ms of the
    unprofiled events of ``name`` under them, each over its attribute
    ``per`` where given; None where there are none."""
    kinds = {e.id: e.attrs[key] for e in events(parent_name)
             if e.attrs and key in e.attrs}
    times = collections.defaultdict(list)
    for e in events(name):
        if not e.profiled and e.parent in kinds:
            times[kinds[e.parent]].append(
                (e.end_ns - e.start_ns) / 1e6 / (e.attrs[per] if per else 1))
    if not times:
        return None
    return statistics.mean(statistics.median(v) for v in times.values())


def anchor(s, range_name: str, span_name: str):
    """(offset_ns, event): the last profiled event of ``span_name``, which
    the slice's one host range ``range_name`` wraps, and the offset from
    the program's clock to the slice's (slice ns = event ns + offset).
    None without them, or where their ends disagree by more than
    ``ANCHOR_NS``."""
    if s is None:
        return None
    ranges = s.ranges.get(range_name, [])
    spans = [e for e in events(span_name) if e.profiled]
    if len(ranges) != 1 or not spans:
        return None
    (a, b), = ranges
    event = spans[-1]
    offset = round(a * 1e3) - event.start_ns
    if abs(event.end_ns + offset - round(b * 1e3)) > ANCHOR_NS:
        return None
    return offset, event


def ops_per_span(s, range_name: str, root_name: str, name: str):
    """The slice's device operations that start inside the profiled events
    of ``name`` under the event of ``root_name`` that the host range
    ``range_name`` wraps, over those events; None where the anchor fails
    or the slice or the store holds none."""
    found = anchor(s, range_name, root_name)
    if found is None or not s.ops:
        return None
    offset, root = found
    spans = [e for e in events(name) if e.profiled and e.root == root.id]
    if not spans:
        return None
    starts = sorted(op[1] for op in s.ops)
    n = sum(bisect.bisect_right(starts, (e.end_ns + offset) / 1e3)
            - bisect.bisect_left(starts, (e.start_ns + offset) / 1e3)
            for e in spans)
    return n / len(spans)
