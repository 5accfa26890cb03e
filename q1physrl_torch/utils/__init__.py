"""Utility subsystems: metrics sinks."""

from . import metrics_io

__all__ = ("metrics_io",)
