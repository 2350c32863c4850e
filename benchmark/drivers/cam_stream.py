"""CAM generation: ``CamTTAEngine.run_stream`` of the program against the
reference's ``cam_batch`` on the same images and labels.

Compared, over the checked batches: the largest gap of a class score
(``score_gap``), and the mean gap over every pixel of every labelled
class's SGC map (``sgc_gap``), the maps as the program downloads them
(uint8 on the stride grid) and upsamples them on the host (float16)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.drivers.serve import ServeDriver
from benchmark.reference.tta import cam_batch


class Driver(ServeDriver):
    def make_engine(self, model):
        from muscle_tpu_torch.inference import CamTTAEngine

        e = self.t["engine"]
        return CamTTAEngine(model, scales=tuple(e["scales"]),
                            num_classes=self.config["num_classes"], device=self.device,
                            max_classes=e["max_classes"], return_cam=False,
                            accum_stride=e["accum_stride"], download_dtype=e["download_dtype"],
                            tight_upload=e["tight_upload"], upload_mode=e["upload_mode"])

    def device_exec(self, batch):
        return self.engine.bench_device_exec(*batch)

    def reference_batch(self, model, batch):
        images, _, labels = batch
        e = self.t["engine"]
        return cam_batch(model, images, labels, e["scales"], accum_stride=e["accum_stride"],
                         max_classes=e["max_classes"],
                         num_classes=self.config["num_classes"])

    def readings(self, pairs) -> dict:
        score_gap, total, count, whole = 0.0, 0.0, 0, True
        for got, want in pairs:
            whole &= len(got) == len(want)
            for g, w in zip(got, want):
                whole &= sorted(g["sgc"]) == sorted(w["sgc"])
                score_gap = max(score_gap, float(np.abs(np.asarray(g["score"], np.float64)
                                                        - w["score"]).max()))
                for c in w["sgc"]:
                    a = np.asarray(g["sgc"].get(c, 0.0), np.float32)
                    b = w["sgc"][c].astype(np.float32)
                    if a.shape != b.shape or not np.isfinite(a).all():
                        whole = False
                        continue
                    total += float(np.abs(a - b).sum())
                    count += a.size
        return {"whole": whole, "score_gap": score_gap,
                "sgc_gap": total / count if count else float("inf")}
