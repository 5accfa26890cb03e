"""Tracing and profiling helpers: a ``torch.profiler`` trace of the host and
the card, a rolling step timer, and the card's memory statistics."""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ("trace", "StepTimer", "device_memory_stats")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write a Chrome trace,
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` sums time by operation."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling wall-clock step timer with steps/s accounting.

    ``device``: where the step's work runs.  On a card the step's launches
    return before the card finishes them, so the timer synchronizes the
    card before it reads the clock at each end of the step; otherwise it
    would time the launches' issue, not the step.
    """

    def __init__(self, window: int = 20, device=None):
        self.window = window
        self.device = torch.device(device) if device is not None else None
        self.times: list[float] = []
        self._t0 = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def steps_per_sec(self, steps_per_iter: int) -> float:
        return steps_per_iter / self.mean if self.times else float("nan")


def device_memory_stats(device="cuda") -> dict:
    """The card's allocator statistics (bytes and counts,
    ``torch.cuda.memory_stats``); an empty dict for the CPU, whose
    allocator keeps none.  Raises for ``cuda`` without a card."""
    from ..analyse import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))
