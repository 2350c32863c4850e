"""Segmentation: ``SegTTAEngine.run_stream`` (labels out) of the program
against the reference's ``seg_batch`` on the same images.

Compared, over the checked batches: the share of pixels whose label
differs from the reference's (``label_gap``)."""

from __future__ import annotations

import numpy as np

from benchmark.drivers.serve import ServeDriver
from benchmark.reference.tta import seg_batch


class Driver(ServeDriver):
    def make_engine(self, model):
        from muscle_tpu_torch.inference import SegTTAEngine

        e = self.t["engine"]
        return SegTTAEngine(model, scales=tuple(e["scales"]),
                            num_classes=self.config["num_classes"], device=self.device,
                            accum_stride=e["accum_stride"], download_dtype=e["download_dtype"],
                            tight_upload=e["tight_upload"], upload_mode=e["upload_mode"],
                            output="labels")

    def fed(self, i: int) -> tuple:
        images, names, _ = self.traffic.batch(i)
        return images, names

    def device_exec(self, batch):
        return self.engine.bench_device_exec(*batch)

    def reference_batch(self, model, batch):
        images, _, _ = batch
        e = self.t["engine"]
        return seg_batch(model, images, e["scales"], accum_stride=e["accum_stride"],
                         num_classes=self.config["num_classes"])

    def readings(self, pairs) -> dict:
        differ, count, whole = 0, 0, True
        for got, want in pairs:
            whole &= len(got) == len(want)
            for g, w in zip(got, want):
                a = np.asarray(g["label"] if isinstance(g, dict) else g)
                if a.shape != w.shape:
                    whole = False
                    continue
                differ += int((a != w).sum())
                count += w.size
        return {"whole": whole, "label_gap": differ / count if count else 1.0}
