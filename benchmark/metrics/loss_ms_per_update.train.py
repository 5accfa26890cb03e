"""Training: host milliseconds of an update's loss forward
(``loss_and_stats``), the median of the program's unprofiled ``ppo.loss``
spans."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("ppo.loss")
