"""Scoring: host milliseconds per frame of a loop's graph replays: for
each kind of loop (its episodes), the median over the program's
unprofiled ``cuda_graph.replay`` spans of each one's time over its
``frames``, averaged over the kinds.  Above the card's time per frame the
host sets the pace; below it the card does, and the host waits at the
readback."""

from benchmark import spans


def read(ctx):
    return spans.median_ms_by_kind("cuda_graph.replay", "analyse.zero_start",
                                   "episodes", per="frames")
