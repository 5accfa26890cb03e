"""Host-side metrics sinks.

A JSONL file always (cheap, greppable, survives crashes), TensorBoard when
its writer imports, and wandb when asked for and installed.  All sinks are
fed once per iteration from the metrics the trainer has already brought to
the host; metrics I/O never touches the hot path.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ("MetricsWriter",)

WANDB_PROJECT = "q1physrl_torch"


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 use_wandb: bool = False, wandb_config: Optional[dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                           buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except Exception:  # tensorboard not installed
                self._tb = None
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=WANDB_PROJECT,
                                         config=wandb_config or {})
            except Exception:
                self._wandb = None

    def write(self, step: int, metrics: dict):
        rec = {"step": step, "time": time.time(), **metrics}
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_figure(self, fig, step: int):
        """Log a matplotlib figure (or ``pyplot``) to wandb as ``chart``;
        nothing without wandb."""
        if self._wandb is not None:
            self._wandb.log({"chart": fig}, step=step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
