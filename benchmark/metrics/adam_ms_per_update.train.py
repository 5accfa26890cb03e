"""Training: host milliseconds of an update's Adam step (``adam_update``,
the global-norm clip included), the median of the program's unprofiled
``ppo.adam`` spans."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("ppo.adam")
