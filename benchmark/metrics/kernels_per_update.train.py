"""Training: device operations per Adam update in the profiled slice, those
that start inside the program's ``ppo.update`` spans of the ``ppo.learn``
that the slice's ``bench.learn`` range wraps, over those updates.  The two
wrap one call, which places the program's events on the slice."""

from benchmark import spans


def read(ctx):
    return spans.ops_per_span(ctx.slice, "bench.learn", "ppo.learn",
                              "ppo.update")
