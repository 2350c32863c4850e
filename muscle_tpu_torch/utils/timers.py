"""Wall-clock instrumentation: running averages and a progress timer with
ETA (port of ``muscle_tpu/utils/timers.py``)."""

from __future__ import annotations

import time


class AverageMeter:
    def __init__(self, *names: str):
        self.totals = {n: 0.0 for n in names}
        self.counts = {n: 0 for n in names}

    def add(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self.totals[k] = self.totals.get(k, 0.0) + float(v)
            self.counts[k] = self.counts.get(k, 0) + 1

    def get(self, *names: str):
        vals = tuple(self.totals[n] / max(self.counts[n], 1) for n in names)
        return vals[0] if len(vals) == 1 else vals

    def pop(self, *names: str):
        vals = self.get(*names)
        for n in names:
            self.totals[n] = 0.0
            self.counts[n] = 0
        return vals


class Timer:
    """Progress timer with ETA."""

    def __init__(self):
        self.start = time.time()
        self.stage_start = self.start
        self.progress = 0.0

    def update_progress(self, progress: float) -> None:
        self.progress = max(progress, 1e-9)

    def elapsed(self) -> float:
        return time.time() - self.start

    def stage_elapsed(self) -> float:
        return time.time() - self.stage_start

    def reset_stage(self) -> None:
        self.stage_start = time.time()

    def eta_str(self) -> str:
        remain = self.elapsed() * (1.0 - self.progress) / self.progress
        return time.strftime("%H:%M:%S", time.gmtime(self.start + self.elapsed() + remain))
