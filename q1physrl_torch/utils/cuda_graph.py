"""One frame of a host loop captured as a CUDA graph and replayed.

The JAX package runs its scoring, analysis and PPO-rollout loops as jitted
``lax.scan``s.  The port's counterpart is a frame function that reads and
writes static buffers (the env state, accumulators, (T, ...) records
written at a device-side index), captured once with ``torch.cuda.CUDAGraph``
and replayed once per frame: the host issues one graph launch per frame
instead of the frame's 60-80 small kernels and the env kernel's ctypes
wrapper.

:class:`FrameGraph` runs a loop's first frame eagerly on a side stream (the
warm-up that fills the caches and initialises the libraries), captures the
frame, and replays it for the rest; a later run replays every frame.  Its
rules:

- The loop's explicit ``torch.Generator``s are registered with the graph,
  so a replay draws from each what the eager frame would have drawn and
  advances it as far.
- The capture runs under ``torch.cuda.set_sync_debug_mode("error")``: a host
  sync in the frame (``.item()``, a Python branch on a tensor) raises there.
- A wrapper that counts its kernel's launches in ``.launches`` counts once
  while the frame is captured; the count is taken back, and each replay adds
  the launches the graph holds, so the counts stay one per launch on the
  card.
- Any failure raises: there is no eager fallback on a card.

A loop is captured against fixed addresses, so a caller that runs it again
keeps it: :class:`LoopCache` holds the loops of a module by key, a few at
most.  ``counters`` sums the captures of every FrameGraph of the process
and their seconds.
"""

from __future__ import annotations

import collections
import time

import torch

__all__ = ("FrameGraph", "FrameLoop", "LoopCache", "counters",
           "param_addresses", "resolve_driver")

counters = {"captures": 0, "capture_seconds": 0.0}


def param_addresses(module: torch.nn.Module) -> tuple:
    """The data addresses of ``module``'s parameters: a graph captured
    against them stays valid while they do not change."""
    return tuple(p.data_ptr() for p in module.parameters())


def resolve_driver(driver, device) -> str:
    """``"graph"`` on a card and ``"eager"`` on the CPU unless ``driver``
    names one; a graph on the CPU raises."""
    device = torch.device(device)
    if driver is None:
        return "graph" if device.type == "cuda" else "eager"
    if driver not in ("eager", "graph"):
        raise ValueError(f"driver is 'eager' or 'graph', not {driver!r}")
    if driver == "graph" and device.type != "cuda":
        raise ValueError(f"the graph driver runs on a card, not {device}")
    return driver


class FrameLoop:
    """A loop of frames on static buffers, with its two drivers.

    A subclass holds the buffers and defines ``frame()``; :meth:`run`
    advances the loop either by calling ``frame()`` once per frame (the
    eager driver: the CPU's, and the yardstick on a card) or by replaying
    its :class:`FrameGraph`, captured on the first graphed run.
    """

    def __init__(self, device, generators=(), counted=()):
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.counted = tuple(counted)
        self.graph = None

    def frame(self):
        raise NotImplementedError

    def run(self, frames: int, driver: str):
        if driver == "eager":
            for _ in range(frames):
                self.frame()
            return
        if self.graph is None:
            self.graph = FrameGraph(self.frame, self.device, self.generators,
                                    self.counted)
        self.graph.run(frames)


class LoopCache:
    """Loops, or what a capture is bound to, kept by key for reuse, at most
    ``size`` of them.

    A loop whose key comes again is reused, its capture with it; past
    ``size`` keys the least recently used loop is dropped, and with it its
    graph and buffers.  A key holds whatever a capture is bound to: the
    config and shapes, and the identity and parameter addresses of the
    policy and generators the loop keeps references to.
    """

    def __init__(self, size: int):
        self.size = size
        self.loops = collections.OrderedDict()

    def get(self, key, make):
        """The loop kept for ``key``, or ``make()``'s, kept from now on."""
        loop = self.loops.pop(key, None)
        if loop is None:
            loop = make()
        self.loops[key] = loop
        if len(self.loops) > self.size:
            self.loops.popitem(last=False)
        return loop


class FrameGraph:
    """``frame()`` captured as a CUDA graph on ``device``.

    Args:
        frame: a function of no arguments that advances the loop by one
            frame, reading and writing only tensors that outlive it.
        device: the card.
        generators: the ``torch.Generator``s the frame draws from.
        counted: the kernel wrappers (functions with a ``launches`` count)
            the frame calls.
    """

    def __init__(self, frame, device, generators=(), counted=()):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph runs on a card, not {device}")
        self.frame = frame
        self.device = device
        self.generators = tuple(generators)
        self.counted = tuple(counted)
        self.graph = None
        self.capture_seconds = None
        self.launches = {}  # wrapper -> its launches in one replay

    def run(self, frames: int):
        """Advance the loop by ``frames`` frames: on the first run, one
        eager frame, the capture, then ``frames - 1`` replays; later, a
        replay per frame."""
        if frames < 1:
            return
        if self.graph is None:
            self._warm_up()
            self._capture()
            frames -= 1
        for _ in range(frames):
            self.replay()

    def replay(self):
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n

    def _warm_up(self):
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.frame()
        current.wait_stream(side)

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        register = getattr(graph, "register_generator_state", None)
        if register is None and self.generators:
            raise RuntimeError("this torch cannot register a generator with a "
                               "CUDA graph (torch.cuda.CUDAGraph."
                               "register_generator_state)")
        for generator in self.generators:
            register(generator)
        before = {fn: fn.launches for fn in self.counted}
        t0 = time.perf_counter()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(graph):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self.frame()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            torch.cuda.synchronize(self.device)
        finally:
            captured = {fn: fn.launches - n for fn, n in before.items()}
            for fn, n in before.items():
                fn.launches = n
        self.capture_seconds = time.perf_counter() - t0
        self.launches = {fn: n for fn, n in captured.items() if n}
        self.graph = graph
        counters["captures"] += 1
        counters["capture_seconds"] += self.capture_seconds
