"""The span recorder (``utils/timers.py``) and the spans the port opens:
the recorder's no-op, nesting and own time, threads, its clock against
``torch.profiler``'s events, the reductions (``timeline``, ``attribute``),
both serving engines' stream on the CPU, the MCL steps and the exchange
counters of one process.  This file imports neither JAX nor the JAX
package; on a card it runs as

    python -m pytest --noconftest tests/test_torch_spans.py -q

where the test marked ``cuda`` also holds the stamps to a device kernel's.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from muscle_tpu_torch.inference import CamTTAEngine, SegTTAEngine
from muscle_tpu_torch.models import MuSCLe, init_weights
from muscle_tpu_torch.training import MCLConfig, make_adam, mcl_train_step, mcl_views_step
from muscle_tpu_torch.utils import timers
from muscle_tpu_torch.utils.timers import NONE, Span, recording, span


def _fake_clock(monkeypatch, stamps):
    """Replace the span clock by ``stamps``, read in turn; returns the
    list of reads."""
    it, reads = iter(stamps), []

    def clock():
        reads.append(next(it))
        return reads[-1]

    monkeypatch.setattr(timers, "now_ns", clock)
    return reads


def test_span_without_recording_reads_no_clock(monkeypatch):
    reads = _fake_clock(monkeypatch, [])
    a, b = span("prep", batch=0, images=8), span("dispatch")
    assert a is b  # one shared object
    with a as s:
        s.set(images=3)
        with span("inner"):
            pass
    assert reads == []
    with recording() as recs:
        pass
    assert recs == []


def test_nesting_parent_and_own_time(monkeypatch):
    _fake_clock(monkeypatch, [0, 10, 30, 40, 70, 100])
    with recording() as recs:
        with span("outer", step=4, images=16):
            with span("a"):
                pass
            with span("b") as s:
                s.set(images=2)
    a, b, outer = recs
    assert [r.name for r in recs] == ["a", "b", "outer"]  # in the order they closed
    assert (outer.start_ns, outer.end_ns, outer.parent) == (0, 100, None)
    assert a.parent == b.parent == outer.id
    assert (a.ns, b.ns) == (20, 30) and b.attrs == {"images": 2}
    assert outer.attrs == {"step": 4, "images": 16}
    own = timers.self_ns(recs)
    assert own == {a.id: 20, b.id: 30, outer.id: 50}
    assert timers.totals(recs) == {"outer": (1, 100, 50), "a": (1, 20, 20), "b": (1, 30, 30)}


def test_records_from_three_threads():
    """Each thread's spans nest on their own stack and carry the thread's
    name; one recording takes them all, none lost with the threads
    switching as often as the interpreter allows."""
    start = threading.Barrier(3, timeout=10)

    def work(k: int):
        start.wait()
        for i in range(5):
            with span("outer", batch=i, images=k):
                with span("inner"):
                    time.sleep(1e-4)

    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording() as recs:
            threads = [threading.Thread(target=work, args=(k,), name=f"t{k}") for k in (1, 2)]
            for t in threads:
                t.start()
            work(0)
            for t in threads:
                t.join(timeout=10)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(was)
    assert len(recs) == 30
    by_id = {r.id: r for r in recs}
    names = {"t1", "t2", threading.current_thread().name}
    for r in recs:
        assert r.thread in names
        if r.name == "inner":
            parent = by_id[r.parent]
            assert parent.name == "outer" and parent.thread == r.thread
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
        else:
            assert r.parent is None
    for name in names:
        outer = [r for r in recs if r.thread == name and r.name == "outer"]
        assert [r.attrs["batch"] for r in outer] == list(range(5))


def test_recording_is_one_at_a_time_and_keeps_nothing_after():
    with recording() as recs:
        with pytest.raises(RuntimeError, match="already open"):
            with recording():
                pass
        late = span("late")
        late.__enter__()
    late.__exit__(None, None, None)  # closed after the recording: not kept
    with span("after"):
        pass
    assert recs == []
    with recording() as again:  # the recorder opens again
        with span("x"):
            pass
    assert [r.name for r in again] == ["x"]


def test_stamps_on_the_profiler_clock():
    """A span around a ``record_function`` contains the profiler's event
    for it, on the same clock (a millisecond of slack for the profiler's
    own clock conversion)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    slack = 1_000_000
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording() as recs:
        with span("around"):
            with record_function("mark"):
                time.sleep(5e-3)
    (rec,) = recs
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "mark"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert end - start > 4_000_000
    assert rec.start_ns - slack <= start and end <= rec.end_ns + slack


def _span(i, name, thread, start, end, parent=None):
    return Span(i, name, parent, thread, start, end, {})


def test_timeline_and_attribute():
    """Idle intervals split by the innermost span open on one thread; time
    under no span is ``NONE``, other threads' spans do not count."""
    recs = [
        _span(1, "fetch", "main", 20, 30, parent=0),
        _span(0, "dispatch", "main", 10, 40),
        _span(2, "wait_result", "main", 50, 80),
        _span(3, "finalize", "fin", 0, 100),
    ]
    pieces = timers.timeline(recs, "main")
    assert pieces == [(10, 20, "dispatch"), (20, 30, "fetch"), (30, 40, "dispatch"),
                      (50, 80, "wait_result")]
    gaps = [(0, 5), (15, 25), (35, 60), (70, 90)]
    got = timers.attribute(gaps, pieces)
    assert got == {NONE: 5 + 10 + 10, "dispatch": 5 + 5, "fetch": 5, "wait_result": 10 + 10}
    assert sum(got.values()) == sum(b - a for a, b in gaps)
    assert timers.attribute(gaps, []) == {NONE: 60}


# ---- the engines' stream ---------------------------------------------------------------------


def _images(i, sizes=((50, 40), (40, 56))):
    rng = np.random.default_rng(i)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for h, w in sizes]


def _cam_batch(i):
    labels = [np.zeros(20, np.float32) for _ in range(2)]
    labels[0][[i % 20, (i + 3) % 20]] = 1
    labels[1][(i + 1) % 20] = 1
    return _images(i), [f"s{i}_0", f"s{i}_1"], labels


def _seg_batch(i):
    return _images(i), [f"s{i}_0", f"s{i}_1"]


@pytest.fixture(scope="module")
def engines():
    gen = torch.Generator().manual_seed(0)
    enc = init_weights(MuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False),
                       gen).eval()
    dec = init_weights(MuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1),
                       gen).eval()
    kw = dict(out_side=64, max_side=60, accum_stride=4, tight_upload=True,
              upload_mode="ycbcr420", device="cpu")
    return {"cam": (CamTTAEngine(enc, scales=(0.5, 1.0), max_classes=4, return_cam=False,
                                 download_dtype="uint8", **kw), _cam_batch),
            "seg": (SegTTAEngine(dec, scales=(0.5, 1.0), output="labels",
                                 download_dtype="float16", **kw), _seg_batch)}


@pytest.mark.parametrize("kind", ["cam", "seg"])
def test_run_stream_spans(engines, kind):
    """One ``prep``, ``dispatch`` and ``finalize`` a batch, numbered in
    order on their own threads, whose images sum to the records returned;
    ``fetch`` inside each ``finalize``; the dispatching thread's waits; no
    span once the recording is closed."""
    engine, batch = engines[kind]
    with recording() as recs:
        out = list(engine.run_stream(batch(i) for i in range(3)))
    n_out = sum(len(b) for b in out)
    assert n_out == 6
    me = threading.current_thread().name
    by_id = {r.id: r for r in recs}
    for name, thread in (("prep", "prep"), ("dispatch", me), ("finalize", "finalize_0")):
        mine = sorted((r for r in recs if r.name == name), key=lambda r: r.attrs["batch"])
        assert [r.attrs["batch"] for r in mine] == [0, 1, 2], name
        assert sum(r.attrs["images"] for r in mine) == n_out, name
        assert {r.thread for r in mine} == {thread}, name
    fetches = [r for r in recs if r.name == "fetch"]
    assert len(fetches) == 3 and all(by_id[r.parent].name == "finalize" for r in fetches)
    waits = [r for r in recs if r.name in ("wait_prep", "wait_result")]
    assert {r.name for r in waits} == {"wait_prep", "wait_result"}
    assert {r.thread for r in waits} == {me}
    kept = len(recs)
    list(engine.run_stream(batch(i) for i in range(2)))
    assert len(recs) == kept


# ---- the training steps ----------------------------------------------------------------------


def _mcl_batch(n=2, crop=64, view=32):
    rng = np.random.default_rng(0)
    b = {}
    for key, side in (("img", crop), ("view1", view), ("view2", view)):
        b[key + "_y"] = rng.integers(0, 256, (n, side, side), dtype=np.uint8)
        b[key + "_c"] = rng.integers(0, 256, (n, side // 2, side // 2, 2), dtype=np.uint8)
    label = np.zeros((n, 20), np.float32)
    label[0, 7] = label[1, 7] = label[1, 11] = 1.0
    b["label"] = label
    b["coord1"] = np.asarray([[0, 0, 20, 24], [4, 2, 28, 30]], np.int32)
    b["coord2"] = np.asarray([[12, 8, 20, 24], [0, 0, 28, 30]], np.int32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("which", ["a", "b"])
def test_mcl_step_spans(which):
    """A step is one ``step`` (its number and images) whose children are
    ``forward``, ``backward``, ``exchange``, ``update`` and ``metrics``,
    in that order, and cover most of it."""
    model = init_weights(MuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False),
                         torch.Generator().manual_seed(1))
    opt = make_adam(model.trained_parameters(), 1e-4, 5e-5)
    batch, gen = _mcl_batch(), torch.Generator().manual_seed(2)
    if which == "a":
        def step():
            return mcl_train_step(model, opt, batch, MCLConfig(use_imc=True), gen)
    else:
        def step():
            return mcl_views_step(model, opt, batch, MCLConfig(True, True, False), gen)
    step()  # outside the recording
    with recording() as recs:
        step()
        step()
    steps = [r for r in recs if r.name == "step"]
    assert len(steps) == 2 and steps[1].attrs["step"] == steps[0].attrs["step"] + 1
    for s in steps:
        assert s.attrs["images"] == 2 and s.parent is None
        kids = sorted((r for r in recs if r.parent == s.id), key=lambda r: r.start_ns)
        assert [r.name for r in kids] == ["forward", "backward", "exchange", "update", "metrics"]
        assert sum(r.ns for r in kids) > 0.9 * s.ns


# ---- on the card --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device trace's clock is the card's")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_stamps_bound_the_device_kernel(cuda):
    """On the profiler's device events: a span around the launch of a
    ``torch.cuda._sleep`` kernel starts before the kernel does (and ends
    before it ends: the launch does not wait), and a span around the
    ``synchronize`` after it ends after the kernel ends."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)  # the kernel loaded before the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, recording() as recs:
        with span("launch"):
            torch.cuda._sleep(20_000_000)  # ~10 ms at the card's clock
        with span("sync"):
            torch.cuda.synchronize()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA and "spin_kernel" in e.name()]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    launch, sync = recs
    assert end - start > 1_000_000
    assert launch.start_ns < start and launch.end_ns < end
    assert sync.end_ns > end


def test_mesh_stats_one_process_and_reset():
    """One process exchanges nothing and counts nothing; ``reset_stats``
    zeroes the counters."""
    from muscle_tpu_torch.parallel import all_gather, all_reduce_flat, all_reduce_sum, mesh

    mesh.stats["all_reduce"]["calls"] += 1  # as a step on ranks would have
    before = {k: dict(v) for k, v in mesh.stats.items()}
    t = torch.ones(3)
    all_reduce_sum(t)
    all_reduce_flat([t])
    assert all_gather(t) is t
    assert mesh.stats == before
    mesh.reset_stats()
    assert all(v == {"calls": 0, "bytes": 0} for v in mesh.stats.values())
