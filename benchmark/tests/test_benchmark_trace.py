"""The traced stretch's reduction (``benchmark/trace.py``) on made-up
device events: the stretch is what the two marker kernels bound, on the
device's clock, so the busy time never passes it."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import trace  # noqa: E402

MARK = "void at::cuda::(anonymous namespace)::spin_kernel(long)"


def test_stretch_is_bounded_by_the_markers():
    events = [
        (0, 500, "drain_before"),        # still running from before the stretch
        (400, 1000, MARK),               # the stretch starts at 1000
        (900, 1300, "overlaps_start"),   # counts from 1000
        (1500, 2000, "k1"),
        (1800, 2500, "k2"),              # overlaps k1: the union counts
        (3000, 3500, "nccl_wait"),
        (4000, 4100, MARK),              # the stretch ends at 4000
        (4200, 4300, "after"),
    ]
    s = trace.summarise(events, None, units=2)
    assert s.window_s == pytest.approx(3000e-9)
    assert s.busy_s == pytest.approx((300 + 1000 + 500) * 1e-9)
    assert s.launches == 4
    assert "drain_before" not in s.by_name and "after" not in s.by_name
    assert s.by_name["overlaps_start"] == pytest.approx(300e-9)
    # the gaps, the one to the stretch's end included, longest first
    assert [round(g * 1e9) for g, _ in s.gaps] == [500, 500, 200]
    assert s.gaps[0][1] in (("k2", "nccl_wait"), ("nccl_wait", "(stretch end)"))
    assert 0.0 < s.busy_s <= s.window_s


def test_busy_never_passes_the_window():
    # work on other streams that runs on past the stretch's end is clipped
    events = [(0, 10, MARK), (5, 400, "long"), (10, 200, "k"), (300, 310, MARK)]
    s = trace.summarise(events, None, units=1)
    assert s.busy_s == pytest.approx(s.window_s)


def test_a_stretch_without_two_markers_is_refused():
    with pytest.raises(ValueError, match="marker"):
        trace.summarise([(0, 10, MARK), (20, 30, "k")], None, units=1)


def test_host_window_when_given():
    s = trace.summarise([(0, 100, "k"), (200, 250, "k")], 1e-6, units=1)
    assert s.window_s == 1e-6
    assert s.busy_s == pytest.approx(150e-9)
