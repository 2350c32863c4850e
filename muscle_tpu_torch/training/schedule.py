"""Host-side learning-rate schedules (port of
``muscle_tpu/training/schedule.py``): both reference training loops drive
Adam with ReduceLROnPlateau('max', patience=0, factor=0.5) stepped on an
epoch-end mIoU."""

from __future__ import annotations


def poly_schedule(base_lr: float, max_step: int, power: float = 0.9):
    """lr(t) = base * (1 - t / max_step)^power, clipped to [0, base]."""

    def fn(step: int) -> float:
        frac = min(max(1.0 - step / max_step, 0.0), 1.0)
        return base_lr * frac ** power

    return fn


class ReduceLROnPlateau:
    """torch's ReduceLROnPlateau semantics (relative threshold), on the
    host: ``step(metric)`` returns the possibly reduced lr."""

    def __init__(self, lr: float, mode: str = "max", factor: float = 0.5, patience: int = 0,
                 min_lr: float = 0.0, threshold: float = 1e-4):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best: float | None = None
        self.num_bad = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold)
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
