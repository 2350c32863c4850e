"""Rank bodies of the spatial-sharding tests (test_torch_spatial.py).  The
ranks are spawned CPU processes joined over gloo (``torch_dp_ranks.launch``);
they import this module, torch_dp_ranks and the port only (never JAX or
tests/conftest.py).

One launch of 4 ranks runs every case: ``make_mesh(4)`` gives one model
group of 4 ranks (1 data x 4 model), ``make_mesh(2)`` two groups of 2
(ranks 0-1 and 2-3: 2 data x 2 model), so the 2-stripe cases run twice,
once in each group, on the same inputs."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from muscle_tpu_torch import parallel
from muscle_tpu_torch.parallel.spatial import Stripes


def cam_model(state: dict, fuse: int = 384):
    from muscle_tpu_torch.models import MuSCLe

    m = MuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False,
               fuse_mbconv=fuse)
    m.load_state_dict(state, strict=False)
    return m.eval()


def seg_model(state: dict):
    from muscle_tpu_torch.models import MuSCLe

    m = MuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1, last_pooling=True,
               fuse_mbconv=384)
    m.load_state_dict(state)
    return m.eval()


def halo_conv(x: torch.Tensor, w: torch.Tensor, stride: int, stripes=None) -> torch.Tensor:
    """A depthwise k x k conv of NHWC ``x`` with the backbone's padding (k//2
    at stride 1, the static pad at stride 2), whole or on this rank's
    stripe of ``x`` with its halo, padding only the width."""
    from muscle_tpu_torch.models.efficientnet import _static_pad

    k, c = w.shape[-1], x.shape[-1]
    lo, hi = (k // 2, k // 2) if stride == 1 else _static_pad(k)
    if stripes is None:
        h = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    else:
        h = F.pad(stripes.halo(stripes.take(x), lo, hi).permute(0, 3, 1, 2), (lo, hi, 0, 0))
    return F.conv2d(h, w, stride=stride, groups=c).permute(0, 2, 3, 1)


def mbconv_owned(spec: dict, stripes) -> torch.Tensor:
    """The plain MBConv block with the owned-row SE on this rank's stripe
    (halo k//2 rows), the SE sums added over the group."""
    from muscle_tpu_torch.ops.mbconv import mbconv_stride1_plain, shift_rows

    d = spec
    k = d["k"]
    p = k // 2
    stripe = stripes.take(d["x"])
    s = stripe.shape[1]
    xe = stripes.halo(stripe, p, p).contiguous()
    win = shift_rows(d["win"], stripes.row0(s) - p)
    return mbconv_stride1_plain(xe, d["weights"], win, k=k, has_expand=True,
                                has_skip=True, owned=(p, p + s), se_sum=stripes.sum)


def checks(group, spec: dict) -> dict:
    """Every spatial case on this rank (module docstring): returns this
    rank's stripes and records."""
    from muscle_tpu_torch.inference import CamTTAEngine, SegTTAEngine

    mesh4, mesh2 = parallel.make_mesh(4), parallel.make_mesh(2)
    st = {4: Stripes(mesh4.model_group), 2: Stripes(mesh2.model_group)}
    out = {"coords": {4: (mesh4.data_index, mesh4.model_index),
                      2: (mesh2.data_index, mesh2.model_index)}}
    with torch.inference_mode():
        d = spec["halo"]
        out["halo"] = {(n, stride, k): halo_conv(d["x"], d["w"][k], stride, st[n])
                       for n in (2, 4) for stride in (1, 2) for k in (3, 5)}
        out["mbconv"] = mbconv_owned(spec["mbconv"], st[2])
        d = spec["pyramid"]
        out["pyramid"] = {}
        for n in (2, 4):
            for fuse in (0, 384):
                m = cam_model(spec["cam_state"], fuse)
                out["pyramid"][(n, fuse)] = m.backbone(st[n].take(d["x"]),
                                                       valid_window=d["win"], stripes=st[n])

        d = spec["cam"]
        eng = CamTTAEngine(cam_model(spec["cam_state"]), mesh=mesh4, shard_spatial=True,
                           device="cpu", **d["kw"])
        out["cam_1x4"] = eng.run_batch(d["images"], d["names"], d["labels"])
        out["cam_1x4_stats"] = eng.stripes.stats
        eng = CamTTAEngine(cam_model(spec["cam_state"]), mesh=mesh2, shard_spatial=True,
                           device="cpu", **d["kw"])
        out["cam_2x2"] = eng.run_batch(d["images"], d["names"], d["labels"])

        d = spec["seg"]
        eng = SegTTAEngine(seg_model(spec["seg_state"]), mesh=mesh4, shard_spatial=True,
                           device="cpu", **d["kw"])
        out["seg_1x4"] = eng.run_batch(d["images"], d["names"])

    model = cam_model(spec["cam_state"])
    out["built"] = {}
    for name, kw in {"bf16": dict(mesh=mesh4, shard_spatial=True,
                                  compute_dtype=torch.bfloat16),
                     "data_mesh": dict(mesh=mesh4)}.items():
        eng = CamTTAEngine(model, device="cpu", **kw)
        out["built"][name] = (eng.compute_dtype, eng.stripes is not None)
    errors = {}
    for name, call in {"exact": lambda e: e.run_batch_exact([], [], []),
                       "host": lambda e: e.run_batch([], [], [])}.items():
        eng = CamTTAEngine(model, device="cpu", mesh=mesh4, shard_spatial=True,
                           device_tta=name != "host")
        try:
            call(eng)
        except Exception as e:  # noqa: BLE001
            errors[name] = (type(e).__name__, str(e))
    out["errors"] = errors
    return out
