"""Stdout tee and a JSON-lines metric log (port of
``muscle_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import os
import sys
import time


class Logger:
    """Tee stdout to a file until ``close``."""

    def __init__(self, path: str):
        self.terminal = sys.stdout
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.log = open(path, "a")
        sys.stdout = self

    def write(self, msg: str) -> None:
        self.terminal.write(msg)
        self.log.write(msg)

    def flush(self) -> None:
        self.terminal.flush()
        self.log.flush()

    def close(self) -> None:
        sys.stdout = self.terminal
        self.log.close()


class MetricLogger:
    """One JSON object per ``log`` call: time, step and the metrics."""

    def __init__(self, path: str | None):
        self.f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.f = open(path, "a")

    def log(self, step: int, **metrics) -> None:
        rec = {"time": time.time(), "step": step}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self.f:
            self.f.write(json.dumps(rec) + "\n")
            self.f.flush()

    def close(self) -> None:
        if self.f:
            self.f.close()
