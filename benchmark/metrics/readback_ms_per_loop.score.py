"""Scoring: host milliseconds of a loop's copy of its returns to the host,
where the host waits for the frames the card has still to run: for each
kind of loop (its episodes), the median of the program's unprofiled
``analyse.readback`` spans, averaged over the kinds."""

from benchmark import spans


def read(ctx):
    return spans.median_ms_by_kind("analyse.readback", "analyse.zero_start",
                                   "episodes")
