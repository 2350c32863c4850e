"""IRN refinement: ``RandomWalkRefiner.run_stream`` of the program (fast
IO, labels out) against the reference's ``refine`` (``reference/irn.py``)
on the same images and CAMs.

Compared, over the checked batches: the share of pixels whose label
differs from the reference's (``label_gap``).  The calibration's planted
fault leaves the second half of each batch out: those images read as
background everywhere.

The traced stretch is recorded by the program's span recorder and its
counters are read around it (``spans``, ``counts``), for the per-layer
readers."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import gen, trace, weights_irn
from benchmark.drivers.serve import ServeDriver
from benchmark.reference import irn as reference_irn
from benchmark.reference import tf32

COUNTERS = ("images", "walks", "walked_nodes", "labelled_nodes")


@torch.no_grad()
def cam_pool(seed: int, size, n: int, field: int, device) -> list[np.ndarray]:
    """n smooth (h, w) float16 maps in [0, 1]: a field of uniform draws,
    ``field`` nodes along the longer side, upsampled bilinearly (half-pixel)
    to (h, w) and min-max normalised."""
    h, w = size
    fh, fw = (max(2, round(field * s / max(h, w))) for s in (h, w))
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    lo = torch.rand((n, 1, fh, fw), generator=g, device=device)
    m = torch.nn.functional.interpolate(lo, size=(h, w), mode="bilinear", align_corners=False)
    mn, mx = m.amin(dim=(2, 3), keepdim=True), m.amax(dim=(2, 3), keepdim=True)
    m = (m - mn) / (mx - mn)
    return list(m[:, 0].to(torch.float16).cpu().numpy())


class IrnTraffic:
    """``gen.ImageTraffic``'s batches with a CAM dict an image: each
    labelled class's map drawn from the size's CAM pool, by the seed."""

    def __init__(self, traffic: dict, seed: int, device):
        self.seed = seed
        self.images = gen.ImageTraffic(traffic, seed, device)
        self.sizes = self.images.sizes
        self.cams = [cam_pool(seed + 104729 * (k + 1), s, traffic["cam_pool_per_size"],
                              traffic["cam_field"], device) for k, s in enumerate(self.sizes)]

    def batch(self, i: int):
        """(images, names, cam dicts) of batch i."""
        images, names, labels = self.images.batch(i)
        pool = self.cams[i % len(self.sizes)]
        pick = np.random.default_rng([self.seed % 2 ** 63, 3, i]).integers(
            0, len(pool), size=(len(images), 20))
        dicts = [{int(c): pool[pick[j, c]] for c in np.nonzero(lab > 0.5)[0]}
                 for j, lab in enumerate(labels)]
        return images, names, dicts


def program_irn(config: dict, state: dict, device):
    """The program's EdgeDisplacement at the configuration's crop, built on
    the meta device and loaded with ``state`` (the edge net's keys); the
    displacement heads, which refinement never runs, are zeros."""
    from muscle_tpu_torch.models import EdgeDisplacement

    with torch.device("meta"):
        model = EdgeDisplacement(crop_size=config["crop"], stride=config["stride"])
    model = model.to_empty(device=device)
    missing, unexpected = model.load_state_dict(state, strict=False)
    stray = [k for k in missing if not k.startswith(("fc_dp", "mean_shift."))]
    if stray or unexpected:
        raise KeyError(f"the edge net's weights do not fit: missing {stray[:3]}, "
                       f"unexpected {unexpected[:3]}")
    own = model.state_dict()  # tensors sharing the model's storage
    for k in missing:
        own[k].zero_()
    return model


class Driver(ServeDriver):
    def setup(self) -> None:
        from muscle_tpu_torch.inference import RandomWalkRefiner

        if not hasattr(RandomWalkRefiner, "run_stream"):
            raise SystemExit("this program's RandomWalkRefiner has no run_stream: "
                             "the IRN cell cannot run")
        clock = trace.Phases()
        c, e = self.config, self.t["engine"]
        self.traffic = IrnTraffic(self.t, self.seed, self.device)
        clock.mark("traffic")
        self.reference = weights_irn.make(c, self.seed, self.device,
                                          self.traffic.images.pools[0][:2])
        clock.mark("weights")
        model = program_irn(c, self.reference.state_dict(), self.device)
        self.reference.to("cpu")
        self.engine = RandomWalkRefiner(
            model, beta=c["beta"], exp_times=c["exp_times"], bg_threshold=c["bg_threshold"],
            radius=c["radius"], crop_size=c["crop"], stride=c["stride"], bucket=e["bucket"],
            fast_io=e["fast_io"], max_classes=e["max_classes"], output=e["output"],
            device=self.device)
        clock.mark("program")
        if self.device.type == "cuda":
            # the walk's library, built by nvcc in a checkout's first run and
            # loaded after: timed apart from the warm-up
            from muscle_tpu_torch.ops import build

            build.load("stencil_walk")
            clock.mark("kernels")
        warm = [self.fed(i) for i in range(len(self.traffic.sizes) * 2)]
        for _ in self.engine.run_stream(iter(warm)):
            pass
        self._sync()
        clock.mark("warm-up")
        self.phases = clock.seconds

    def device_exec(self, batch):
        images, _, dicts = batch
        return self.engine.bench_device_exec(images, dicts)

    # ---- trace -----------------------------------------------------------------

    def stretch(self) -> trace.Summary:
        """``ServeDriver.stretch`` under the program's span recorder, with
        the refiner's counters read around it: ``spans`` (the records),
        ``counts`` (the counters' differences; None where the program has
        no such counters).  The device-only calls before the traced
        batches open no ``prep`` span and count nothing."""
        from muscle_tpu_torch.inference import irn
        from muscle_tpu_torch.utils import timers

        stats = getattr(irn, "stats", {})
        before = dict(stats)
        with timers.recording() as spans:
            summary = super().stretch()
        self.spans = list(spans)
        self.counts = ({k: stats[k] - before[k] for k in COUNTERS}
                       if all(k in stats for k in COUNTERS) else None)
        return summary

    def stretch_walks(self) -> list[list[tuple[int, int, int]]]:
        """(eh, ew, labelled classes) of each image of each traced batch."""
        s = self.config["stride"]
        out = []
        for i in self.stretch_batches:
            images, _, dicts = self.traffic.batch(i)
            out.append([((im.shape[0] - 1) // s + 1, (im.shape[1] - 1) // s + 1, len(d))
                        for im, d in zip(images, dicts)])
        return out

    # ---- the check ---------------------------------------------------------------

    def reference_batch(self, model, batch):
        images, _, dicts = batch
        c = self.config
        return [reference_irn.refine(model, img, cd, crop=c["crop"], stride=c["stride"],
                                     radius=c["radius"], beta=c["beta"],
                                     exp_times=c["exp_times"], bg_threshold=c["bg_threshold"])
                for img, cd in zip(images, dicts)]

    def check(self, control: bool = False):
        """The program's readings against the reference's; with
        ``control``, also those of the reference at TF32 (``control``) and
        of the reference's records with each batch's second half left out
        (``half_batch``)."""
        self.reference.to(self.device)
        got, ctrl, half = [], [], []
        for i in self.sample():
            batch = self.traffic.batch(i)
            want = self.reference_batch(self.reference, batch)
            got.append((self.records[i], want))
            if control:
                with tf32():
                    ctrl.append((self.reference_batch(self.reference, batch), want))
                n = len(want) // 2
                half.append((want[:n] + [np.zeros_like(w) for w in want[n:]], want))
        planted = {"control": self.readings(ctrl), "half_batch": self.readings(half)}
        return self.readings(got), (planted if control else None)

    def readings(self, pairs) -> dict:
        differ, count, whole = 0, 0, True
        for got, want in pairs:
            whole &= len(got) == len(want)
            for g, w in zip(got, want):
                a = np.asarray(g)
                if a.shape != w.shape:
                    whole = False
                    continue
                differ += int((a != w).sum())
                count += w.size
        return {"whole": whole, "label_gap": differ / count if count else 1.0}
