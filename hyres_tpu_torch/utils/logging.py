"""Scalar logging: TensorBoard when tensorboardX is installed, else stdout
only (counterpart of ``hyres_tpu/utils/logging.py``)."""

from __future__ import annotations

from typing import Dict, Optional


class ScalarLogger:
    def __init__(self, logdir: Optional[str] = None):
        self._writer = None
        if logdir is not None:
            try:
                from tensorboardX import SummaryWriter

                self._writer = SummaryWriter(logdir)
            except ImportError:
                print("tensorboardX unavailable; scalar logging to stdout only")

    def log(self, prefix: str, metrics: Dict[str, float], step: int):
        if self._writer is None:
            return
        for k, v in metrics.items():
            try:
                self._writer.add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self):
        if self._writer is not None:
            self._writer.close()
