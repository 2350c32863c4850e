"""Wall-clock instrumentation: running averages, a progress timer with
ETA and a profiler trace scope (port of ``muscle_tpu/utils/timers.py``)."""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """A ``torch.profiler`` trace of the scope (the CPU, and the card when
    there is one) written to ``logdir`` as a TensorBoard trace; does
    nothing when logdir is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
