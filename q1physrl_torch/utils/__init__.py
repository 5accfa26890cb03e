"""Utility subsystems: metrics sinks, the .dem demo file reader and
writer, and the CUDA-graph capture of a loop's frame; imported on use: the
NetQuake client (``netclient``), the lockstep oracle server
(``lockstep_server``) and the profiling helpers (``profiling``)."""

from . import cuda_graph, demfile, metrics_io

__all__ = ("cuda_graph", "demfile", "metrics_io")
