"""Rank bodies of the engines' mesh tests (test_torch_mesh_engines.py): the
in-process data-parallel ``mesh=`` and bf16 under ``shard_spatial``.  The
ranks are spawned CPU processes joined over gloo
(``torch_dp_ranks.launch``); they import this module, torch_dp_ranks,
torch_spatial_ranks and the port only (never JAX or tests/conftest.py).

Every rank passes the same global batch to each engine and returns the
records the engine gave it.  Two launches:

* 2 ranks: ``make_mesh()`` (2 data rows) at f32 on a CAM batch of 4 (the
  rows divide it) and of 3 (they do not: every rank runs it whole), the
  same batches through ``run_stream`` and ``run_batch_async``, a seg
  batch of 2 and of 3; then ``make_mesh(2)`` (1 x 2) at bf16 under
  shard_spatial, a CAM batch of 4 and a seg batch of 2;
* 4 ranks: ``make_mesh(4)`` (1 x 4) and ``make_mesh(2)`` (2 x 2) at bf16
  under shard_spatial on the same batches, and the 2 x 2 at f32."""

from __future__ import annotations

import torch

from muscle_tpu_torch import parallel
from torch_spatial_ranks import cam_model, seg_model

BF16 = torch.bfloat16


def _engines(spec: dict, **kw) -> tuple:
    from muscle_tpu_torch.inference import CamTTAEngine, SegTTAEngine

    return (CamTTAEngine(cam_model(spec["cam_state"]), device="cpu", **spec["cam_kw"], **kw),
            SegTTAEngine(seg_model(spec["seg_state"]), device="cpu", **spec["seg_kw"], **kw))


def _cam(batch: dict, n: int) -> tuple:
    return batch["images"][:n], batch["names"][:n], batch["labels"][:n]


def _seg(batch: dict, n: int) -> tuple:
    return batch["images"][:n], batch["names"][:n]


def checks2(group, spec: dict) -> dict:
    """The 2-rank launch (module docstring)."""
    data, mesh = parallel.make_mesh(), parallel.make_mesh(2)
    out = {"coords": [(m.data_index, m.model_index) for m in (data, mesh)]}
    with torch.inference_mode():
        cam, seg = _engines(spec, mesh=data)
        out["cam"] = {n: cam.run_batch(*_cam(spec["cam"], n)) for n in (4, 3)}
        out["cam_stream"] = list(cam.run_stream(_cam(spec["cam"], n) for n in (4, 3)))
        out["cam_async"] = cam.run_batch_async(*_cam(spec["cam"], 4))()
        out["seg"] = {n: seg.run_batch(*_seg(spec["seg"], n)) for n in (2, 3)}
        out["seg_stream"] = list(seg.run_stream(_seg(spec["seg"], n) for n in (2, 3)))
        cam, seg = _engines(spec, mesh=mesh, shard_spatial=True, compute_dtype=BF16)
        out["bf16_1x2"] = {"cam": cam.run_batch(*_cam(spec["cam"], 4)),
                           "seg": seg.run_batch(*_seg(spec["seg"], 2))}
    return out


def checks4(group, spec: dict) -> dict:
    """The 4-rank launch (module docstring)."""
    meshes = {"1x4": parallel.make_mesh(4), "2x2": parallel.make_mesh(2)}
    out = {"coords": {k: (m.data_index, m.model_index) for k, m in meshes.items()}}
    with torch.inference_mode():
        for tag, mesh in meshes.items():
            cam, seg = _engines(spec, mesh=mesh, shard_spatial=True, compute_dtype=BF16)
            out[f"bf16_{tag}"] = {"cam": cam.run_batch(*_cam(spec["cam"], 4)),
                                  "seg": seg.run_batch(*_seg(spec["seg"], 2))}
        cam, seg = _engines(spec, mesh=meshes["2x2"], shard_spatial=True)
        out["f32_2x2"] = {"cam": cam.run_batch(*_cam(spec["cam"], 4)),
                          "seg": seg.run_batch(*_seg(spec["seg"], 2))}
    return out
