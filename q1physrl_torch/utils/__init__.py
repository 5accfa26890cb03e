"""Utility subsystems: metrics sinks and the .dem demo file reader and
writer."""

from . import demfile, metrics_io

__all__ = ("demfile", "metrics_io")
