"""Training: host milliseconds of an update's gradient
(``torch.autograd.grad``), the median of the program's unprofiled
``ppo.grad`` spans."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("ppo.grad")
