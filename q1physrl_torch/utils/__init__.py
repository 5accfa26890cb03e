"""Utility subsystems: the device an entry point runs on (``device``),
metrics sinks, the .dem demo file reader and writer, the CUDA-graph
capture of a loop's frame, and the store of the program's spans and
counters with its ``torch.profiler`` export (``profiling``); imported on
use: the NetQuake client (``netclient``) and the lockstep oracle server
(``lockstep_server``)."""

from . import cuda_graph, demfile, device, metrics_io, profiling

__all__ = ("cuda_graph", "demfile", "device", "metrics_io", "profiling")
