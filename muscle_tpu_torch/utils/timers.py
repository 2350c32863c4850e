"""Wall-clock instrumentation: running averages and a progress timer with
ETA (port of ``muscle_tpu/utils/timers.py``), and the port's span
recorder.

Spans mark what a host thread is doing at the program's stage
boundaries (``span("dispatch", batch=3, images=8)``).  They cost one
check of a module global while no recording is open: ``span`` then hands
back one shared object that does nothing, reads no clock and allocates
nothing.  ``recording()`` opens a recording; each span closed while it is
open appends a ``Span`` record (its name, the span open around it on the
same thread, the thread's name, start and end, its attributes), kept in
memory only.  The stamps are on the clock of ``torch.profiler``'s events
(``now_ns``), so a recording lines up with a device trace taken over the
same stretch.  ``self_ns``, ``totals``, ``timeline`` and ``attribute``
reduce a recording.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

# The span clock: torch.profiler's events (kineto's ``start_ns()``, host
# and device alike) are stamped on the Unix epoch's clock, which is
# ``time.time_ns``'s; a build whose events use another clock is fixed here.
now_ns = time.time_ns
NONE = "(none)"  # ``attribute``'s name for time under no span


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


# ---- spans ---------------------------------------------------------------------------------


class Span(NamedTuple):
    """One closed span.  ``parent``: the ``id`` of the span that was open
    around it on its thread when it opened (None at the top)."""
    id: int
    name: str
    parent: int | None
    thread: str
    start_ns: int
    end_ns: int
    attrs: dict

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


_records: list | None = None  # the open recording's list; None: spans do nothing
_ids = itertools.count()
_local = threading.local()


class _Noop:
    """What ``span`` returns with no recording open."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _Noop()


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start = now_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = now_ns()
        _local.stack.pop()
        out = _records
        if out is not None:  # a recording closed meanwhile keeps nothing more
            out.append(Span(self.id, self.name, self.parent, threading.current_thread().name,
                            self.start, end, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span (a count of work)."""
        self.attrs.update(attrs)


def span(name: str, *, batch: int | None = None, step: int | None = None,
         images: int | None = None):
    """A context manager that records ``name`` over its body while a
    recording is open, with the attributes given (the work's identifier,
    ``batch`` in a stream or ``step``, and its count, ``images``); with
    none open, a shared no-op."""
    if _records is None:
        return _NOOP
    attrs = {k: v for k, v in (("batch", batch), ("step", step), ("images", images))
             if v is not None}
    return _Open(name, attrs)


@contextlib.contextmanager
def recording():
    """Record every span closed on any thread until the block ends; yields
    the list of ``Span`` records, in the order they closed.  One recording
    at a time."""
    global _records
    if _records is not None:
        raise RuntimeError("a span recording is already open")
    out: list[Span] = []
    _records = out
    try:
        yield out
    finally:
        _records = None


def self_ns(records) -> dict[int, int]:
    """Each span's own time (by ``id``): its duration less what its
    recorded children cover."""
    own = {r.id: r.ns for r in records}
    for r in records:
        if r.parent in own:
            own[r.parent] -= r.ns
    return own


def totals(records) -> dict[str, tuple[int, int, int]]:
    """{name: (spans, total ns, own ns)} of a recording."""
    own = self_ns(records)
    out: dict[str, tuple[int, int, int]] = {}
    for r in records:
        n, total, mine = out.get(r.name, (0, 0, 0))
        out[r.name] = (n + 1, total + r.ns, mine + own[r.id])
    return out


def timeline(records, thread: str) -> list[tuple[int, int, str]]:
    """The innermost span open on ``thread`` over time: (start ns, end ns,
    name) pieces in order, not overlapping; time under no span has no
    piece.  A thread's spans nest, so the innermost is the latest opened
    of those still open."""
    marks = []
    for r in records:
        if r.thread == thread:
            marks.append((r.start_ns, 1, r.id, r.name))
            marks.append((r.end_ns, 0, r.id, r.name))
    marks.sort()  # at one instant, ends before starts
    pieces, stack, last = [], [], None
    for t, opens, sid, name in marks:
        if stack and t > last:
            pieces.append((last, t, stack[-1][1]))
        if opens:
            stack.append((sid, name))
        else:
            stack.remove((sid, name))
        last = t
    return pieces


def attribute(intervals, pieces) -> dict[str, int]:
    """{name: ns} of ``intervals`` ((start ns, end ns), sorted by start and
    not overlapping, such as a device's idle gaps) under each name of
    ``pieces`` (``timeline``), and under ``NONE`` where no piece covers
    them."""
    out: dict[str, int] = {}
    j = 0
    for a, b in intervals:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi, name = pieces[k]
            part = min(hi, b) - max(lo, a)
            if part > 0:
                out[name] = out.get(name, 0) + part
                covered += part
            k += 1
        if b - a > covered:
            out[NONE] = out.get(NONE, 0) + (b - a - covered)
    return out
