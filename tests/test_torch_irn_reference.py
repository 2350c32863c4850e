"""The port's IRN refinement against the benchmark's plain reference
(``benchmark/reference/irn.py``) on seeded random weights
(``benchmark/weights_irn.py``, the edge head calibrated as the cell's
configuration states) at crop 64, on the CPU: labels and scores of
``RandomWalkRefiner.run_stream``, the stream against ``refine_batch``, the
stream's spans and the refiner's counters, and the benchmark's counts of
the walk's and the bf16 MBConv block's work."""

import threading

import numpy as np
import pytest
import torch

from benchmark import weights_irn
from benchmark.counts import mbconv as mbconv_counts
from benchmark.counts import mbconv_bf16, stencil_walk
from benchmark.drivers.irn_stream import cam_pool
from benchmark.reference import irn as ref
from muscle_tpu_torch.inference import RandomWalkRefiner
from muscle_tpu_torch.inference import irn as program_irn
from muscle_tpu_torch.models import EdgeDisplacement
from muscle_tpu_torch.ops import random_walk
from muscle_tpu_torch.ops import stencil_walk as program_walk
from muscle_tpu_torch.utils.timers import recording

CROP = 64
CONFIG = {"strides": [2, 2, 2, 1], "crop": CROP, "stride": 4}
WALK = dict(crop=CROP, stride=4, radius=5, beta=8, exp_times=6)
SIZES = [(60, 44), (44, 60), (58, 41)]
CLASSES = [[14], [3, 7], [0, 11, 19]]
# labels: both sides compute in float32 from the same float16 CAMs; they
# differ in the edge net's summation order and in the walk's (the stencil
# against the dense matrix), ~1e-6 of a score, which flips only a pixel
# whose two largest scores (or the largest and the threshold) tie that
# closely: at most a few in a thousand
LABEL_GAP = 1e-3
# scores: the program downloads the walked grid in float16 (a relative
# step of 2^-11 under the 0-1 scores) and upsamples it on the host
SCORE_ATOL = 2e-3


def _images(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in SIZES:
        yy, xx = np.mgrid[0:h, 0:w]
        base = 60 + 120 * (yy / h)[..., None] * rng.uniform(0.3, 1, 3) + 60 * (xx / w)[..., None]
        out.append(np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    images = _images()
    reference = weights_irn.make(CONFIG, 2 ** 31 + 11, "cpu", images[:2])
    model = EdgeDisplacement(crop_size=CROP)
    missing, unexpected = model.load_state_dict(reference.state_dict(), strict=False)
    assert not unexpected and all(k.startswith(("fc_dp", "mean_shift")) for k in missing)
    dicts = []
    for k, ((h, w), classes) in enumerate(zip(SIZES, CLASSES)):
        pool = cam_pool(k + 5, (h, w), len(classes), 8, "cpu")
        dicts.append(dict(zip(classes, pool)))
    return reference, model, images, dicts


def _refiner(model, **kw):
    return RandomWalkRefiner(model, crop_size=CROP, fast_io=True, device="cpu", **kw)


def test_labels_match_reference(setup):
    reference, model, images, dicts = setup
    batches = [(images[:2], ["a", "b"], dicts[:2]), (images[2:], ["c"], dicts[2:])]
    got = [r for recs in _refiner(model, output="labels").run_stream(iter(batches))
           for r in recs]
    differ = count = 0
    for g, img, cd in zip(got, images, dicts):
        want = ref.refine(reference, img, cd, bg_threshold=0.35, **WALK)
        assert g.shape == want.shape == img.shape[:2] and g.dtype == np.uint8
        assert set(np.unique(want)) <= {0, *(c + 1 for c in cd)}
        differ += int((g != want).sum())
        count += want.size
    assert differ / count <= LABEL_GAP
    # the labels are not trivial: background and a class both occur
    assert any(len(np.unique(g)) > 1 for g in got)


def test_scores_match_reference(setup):
    reference, model, images, dicts = setup
    got = _refiner(model, output="scores").refine_batch(images, dicts)
    for g, img, cd in zip(got, images, dicts):
        keys, want = ref.walked(reference, img, cd, **WALK)
        assert g.shape == (*img.shape[:2], 21) and g.dtype == np.float32
        np.testing.assert_allclose(g[..., 0], 0.35, atol=SCORE_ATOL)  # float16's 0.35
        others = [c + 1 for c in range(20) if c not in keys]
        assert not g[..., others].any()
        np.testing.assert_allclose(g[..., [k + 1 for k in keys]],
                                   want.permute(1, 2, 0).numpy(), atol=SCORE_ATOL)


def test_run_stream_equals_refine_batch(setup):
    """Record by record and in order, a batch across two size buckets (the
    stream's prep splits it) included."""
    _, model, images, dicts = setup
    big = np.tile(_images(seed=3)[0], (2, 2, 1))[:100, :70]
    big_cams = {5: cam_pool(9, big.shape[:2], 1, 8, "cpu")[0]}
    refiner = RandomWalkRefiner(model, crop_size=128, bucket=64, fast_io=True,
                                output="labels", device="cpu")
    batches = [([images[0], big, images[1]], ["a", "big", "b"], [dicts[0], big_cams, dicts[1]]),
               (images[2:], ["c"], dicts[2:])]
    streamed = list(refiner.run_stream(iter(batches)))
    assert [len(r) for r in streamed] == [3, 1]
    for recs, (imgs, _, cds) in zip(streamed, batches):
        for g, w, img in zip(recs, refiner.refine_batch(imgs, cds), imgs):
            assert g.shape == img.shape[:2]
            np.testing.assert_array_equal(g, w)


def test_stream_spans_and_counters(setup):
    _, model, images, dicts = setup
    refiner = _refiner(model, output="labels")
    batches = [(images[:2], ["a", "b"], dicts[:2]), (images[2:], ["c"], dicts[2:])]
    before = dict(program_irn.stats)
    launches = program_walk.stencil_walk.launches
    with recording() as recs:
        out = list(refiner.run_stream(iter(batches)))
    assert [len(r) for r in out] == [2, 1]
    by_id = {r.id: r for r in recs}

    def inside(r, name):
        while r.parent is not None:
            r = by_id[r.parent]
            if r.name == name:
                return True
        return False

    me = threading.current_thread().name
    for name, parent, thread in (("cam_pack", "prep", "prep"), ("edge", "dispatch", me),
                                 ("walk", "dispatch", me)):
        mine = [r for r in recs if r.name == name]
        assert len(mine) == 2, name  # one a batch: one size bucket each
        assert all(inside(r, parent) and r.thread == thread for r in mine), name
    assert sorted(r.attrs["images"] for r in recs if r.name == "cam_pack") == [1, 2]
    diff = {k: program_irn.stats[k] - before[k] for k in before}
    grid = CROP // 4
    labelled = sum(len(cd) * ((h - 1) // 4 + 1) * ((w - 1) // 4 + 1)
                   for cd, (h, w) in zip(dicts, SIZES))
    assert diff == {"images": 3, "walks": 2, "walked_nodes": 3 * 20 * grid * grid,
                    "labelled_nodes": labelled}
    assert program_walk.stencil_walk.launches == launches  # no kernel on the CPU


def test_reference_transition_matches_the_port():
    """The reference's dense matrix, built from the path equations, against
    the port's pair-index build on one random edge map."""
    edge = torch.rand((7, 9), generator=torch.Generator().manual_seed(4))
    want = random_walk.transition_matrices(edge[None], radius=5, beta=8)[0]
    torch.testing.assert_close(ref.transition(edge, radius=5, beta=8), want, rtol=1e-5,
                               atol=1e-7)
    assert len(ref.search_paths(5)) == stencil_walk.directions(5) == 34


def test_walk_and_bf16_mbconv_counts():
    # one walk of two images: (3 x 4 grid, 2 classes) and (2 x 2, 1), 64 steps, D = 34
    nbytes, flops = stencil_walk.walk_work([(3, 4, 2), (2, 2, 1)], radius=5, steps=64)
    assert flops == 2 * 64 * 12 * 137 + 1 * 64 * 4 * 137
    assert nbytes == 4 * (2 * 2 * 12 + 34 * 12 + 12) + 4 * (2 * 1 * 4 + 34 * 4 + 4)
    # the port's arithmetic for one image
    assert stencil_walk.walk_work([(3, 4, 2)], 5, 64) == program_walk.walk_work(1, 2, 3, 4, 34, 64)
    assert stencil_walk.least_seconds([(128, 128, 20)], 5, 64) == pytest.approx(
        20 * 64 * 128 * 128 * 137 / 67e12)
    # a bf16 block call over 10 pixels: 8 -> 48 expanded, 3 x 3 depthwise, SE 2, 8 out
    nbytes, products, dw = mbconv_bf16.call_work(10, 8, 48, 2, 8, 3, True)
    matrices = 8 * 48 + 9 * 48 + 2 * 48 * 2 + 48 * 8
    vectors = 2 * 48 + 2 * 48 + 2 + 48 + 2 * 8
    assert nbytes == 2 * (10 * 16 + matrices) + 4 * vectors
    assert (products, dw) == (2 * 10 * (8 * 48 + 48 * 8), 2 * 10 * 9 * 48)
    assert (products, dw) == mbconv_counts.call_work(10, 8, 48, 2, 8, 3, True)[1:]
    assert mbconv_bf16.least_seconds(0, 989e12, 67e12) == pytest.approx(2.0)


def test_edge_net_count_leaves_the_padding_out():
    """``counts/irn.py`` counts both views on the image's own (H, W): below
    the crop canvas's count, and twice one view's."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.counts import irn as irn_counts

    flops = irn_counts.image_flops(CONFIG, SIZES[0])
    model = weights_irn.reference_model(CONFIG).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(torch.empty((1, 3, *SIZES[0]), device="meta"))
    assert flops == 2 * fc.get_total_flops()
    assert flops < irn_counts.image_flops(CONFIG, (CROP, CROP))
