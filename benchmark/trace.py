"""A bounded stretch of a run under ``torch.profiler`` (device activity
only: tracing the host's operators would slow the dispatch the cells
measure), reduced to what the per-layer readers take: the device's busy
time, launches, device time by kernel name, and the idle gaps.  No trace
file is written.

The stretch is timed on the device's clock alone: a marker kernel
(``torch.cuda._sleep``, ATen's ``spin_kernel``) is launched on an idle card
before the stretch and another after it has drained, and the stretch runs
from the first marker's end to the second's start.  Only the operations
inside it count, clipped to it, so the busy time never passes the window
and work still draining from before the stretch is left out."""

from __future__ import annotations

import dataclasses
import re
import time

import torch


@dataclasses.dataclass
class Summary:
    window_s: float                  # device-clock length of the stretch
    busy_s: float                    # union of the device's operations
    launches: int                    # kernels (no copies or memsets)
    units: int                       # images or steps in the stretch
    by_name: dict                    # kernel or copy name -> device seconds
    gaps: list                       # (seconds, (op before, op after)) idle gaps, longest first

    def seconds_matching(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for name, s in self.by_name.items() if rx.search(name))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps (named by the operations on either side), names shortened."""
        ops: dict[str, float] = {}
        for name, s in self.by_name.items():
            ops[short(name)] = ops.get(short(name), 0.0) + s
        ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = [[f"{short(a, 60)} .. {short(b, 60)}", s] for s, (a, b) in self.gaps[:top]]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}


def short(name: str, width: int = 100) -> str:
    """A kernel's name without ``void``, the anonymous namespace and its
    parameter list, cut to ``width`` characters."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):  # the parameter list: the first '(' outside <...>
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width]


class Phases:
    """Host-clock seconds of consecutive set-up phases, for standard error."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


def _ns(ev, what: str) -> int:
    get = getattr(ev, f"{what}_ns", None)
    return int(get()) if get is not None else int(getattr(ev, f"{what}_us")() * 1000)


def device_events(prof) -> list[tuple[int, int, str]]:
    """(start ns, end ns, name) of every operation on a CUDA device."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            start = _ns(ev, "start")
            out.append((start, start + _ns(ev, "duration"), ev.name()))
    out.sort()
    return out


MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep, which bounds the stretch
MARKER_CYCLES = 1000     # under a microsecond


def stretch_bounds(events) -> tuple[int, int, list]:
    """(start ns, end ns, the operations between) of the stretch that the
    first and last marker kernels bound; ValueError without two markers."""
    marks = [i for i, (_, _, name) in enumerate(events) if MARKER in name]
    if len(marks) < 2:
        raise ValueError(f"{len(marks)} marker kernels in the trace; the stretch needs 2")
    lo, hi = events[marks[0]][1], events[marks[-1]][0]
    inside = [(max(a, lo), min(b, hi), name) for a, b, name in events
              if MARKER not in name and b > lo and a < hi]
    return lo, hi, inside


def summarise(events, window_s: float | None, units: int) -> Summary:
    """``events`` reduced; with ``window_s`` None the stretch is the one
    the markers bound (``stretch_bounds``), else every event counts and
    ``window_s`` is the stretch's length."""
    lo = hi = None
    if window_s is None:
        lo, hi, events = stretch_bounds(events)
        window_s = (hi - lo) / 1e9
    by_name: dict[str, float] = {}
    busy, launches, gaps = 0, 0, []
    cur_start = cur_end = lo
    last_name = None if lo is None else "(stretch start)"
    for start, end, name in events:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e9
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
                gaps.append(((start - cur_end) / 1e9, (last_name, name)))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
        if end >= cur_end:
            last_name = name
    if cur_end is not None:
        busy += cur_end - cur_start
        if hi is not None and hi > cur_end:
            gaps.append(((hi - cur_end) / 1e9, (last_name, "(stretch end)")))
    gaps.sort(key=lambda g: -g[0])
    return Summary(window_s, busy / 1e9, launches, units, by_name, gaps)


def profile(fn, device: torch.device, units: int) -> Summary:
    """Run ``fn`` once under the profiler, between two marker kernels
    launched on an idle card (on the CPU: timed by the host's clock)."""
    from torch.profiler import ProfilerActivity

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            with torch.cuda.device(device):
                torch.cuda.synchronize()
                torch.cuda._sleep(MARKER_CYCLES)
                fn()
                torch.cuda.synchronize()
                torch.cuda._sleep(MARKER_CYCLES)
                torch.cuda.synchronize()
        else:
            t0 = time.perf_counter()
            fn()
            window_s = time.perf_counter() - t0
    if cuda:
        return summarise(device_events(prof), None, units)
    return summarise([], window_s, units)
