"""CAM generation with the model in bfloat16: ``CamTTAEngine.run_stream``
at ``compute_dtype=torch.bfloat16`` against the float32 reference's
``cam_batch``, compared as ``cam_stream`` compares them.

The seed's weights are conditioned on two of the traffic's images before
the window, in the reference and the program alike: each classifier row
loses its component along the images' mean embedding, so that a class's
CAM is signed and about half of it positive, and the PCM's ``fuse``
convolution gets the bias that centres its features over the pixels, so
that the affinities keep only similar pixels.  Unconditioned, a random
net's SGC maps vary by 0.3-5% of their peak over an image, the fusion's
min-max normalisation scales bfloat16's rounding up 20-300 times, and
``sgc_gap`` reads the program as high as the control; conditioned, they
vary by 50-80% of it.

The control is the reference with both operands of every convolution,
linear and batched matrix product rounded through float8 (e4m3, clamped
to its range): a precision below the configuration's bfloat16.  The planted fault leaves
the second half of each batch out: those images' maps and scores read as
zeros."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.drivers import cam_stream
from benchmark.reference.tta import IMAGENET_MEAN, IMAGENET_STD

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8_e4m3fn, back in its own dtype."""
    return t.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(t.dtype)


@contextlib.contextmanager
def fp8_products():
    """Round both operands of every ``F.conv2d`` and ``F.linear`` call
    (``nn.Conv2d`` and ``nn.Linear`` call them) and of every ``torch.bmm``
    (the PCM's affinity and its product with the CAMs, which the program
    computes in its compute dtype too) through float8 while the block
    runs."""
    conv, linear, bmm = F.conv2d, F.linear, torch.bmm
    F.conv2d = lambda x, w, *a, **k: conv(fp8(x), fp8(w), *a, **k)
    F.linear = lambda x, w, *a, **k: linear(fp8(x), fp8(w), *a, **k)
    torch.bmm = lambda a, b, **k: bmm(fp8(a), fp8(b), **k)
    try:
        yield
    finally:
        F.conv2d, F.linear, torch.bmm = conv, linear, bmm


def left_out(records: list[dict]) -> list[dict]:
    """A batch's records with its second half's maps and scores zero."""
    n = len(records) // 2
    return records[:n] + [{"sgc": {c: np.zeros_like(m) for c, m in r["sgc"].items()},
                           "score": np.zeros_like(r["score"])} for r in records[n:]]


@torch.no_grad()
def condition(reference, program, images) -> None:
    """Centre ``reference``'s classifier rows and PCM features on
    ``images`` (HWC uint8, their top-left 256 x 256) and copy both into
    ``program``."""
    dev = next(reference.parameters()).device
    x = torch.from_numpy(np.stack([im[:256, :256] for im in images])).to(dev)
    x = (x.to(torch.float32) / 255.0 - torch.tensor(IMAGENET_MEAN, device=dev)) \
        / torch.tensor(IMAGENET_STD, device=dev)
    fused = []
    hook = reference.fuse.register_forward_hook(lambda m, i, o: fused.append(o))
    try:
        _, _, emb, _ = reference(x, mode="cam_lowres")
    finally:
        hook.remove()
    mu = emb.mean(dim=0)
    w = reference.fc.weight
    w -= (w @ mu)[:, None] * mu[None, :] / (mu @ mu)
    reference.fuse.bias.copy_(-fused[0].mean(dim=(0, 2, 3)))
    program.fc.weight.copy_(w)
    program.fuse.bias.copy_(reference.fuse.bias)


class Driver(cam_stream.Driver):
    def setup(self) -> None:
        super().setup()
        t0 = time.perf_counter()
        self.reference.to(self.device)
        condition(self.reference, self.engine.model, self.traffic.pools[0][:2])
        self.reference.to("cpu")
        self.phases["conditioning"] = time.perf_counter() - t0

    def make_engine(self, model):
        from muscle_tpu_torch.inference import CamTTAEngine

        e = self.t["engine"]
        return CamTTAEngine(model, scales=tuple(e["scales"]),
                            num_classes=self.config["num_classes"], device=self.device,
                            max_classes=e["max_classes"], return_cam=False,
                            accum_stride=e["accum_stride"], download_dtype=e["download_dtype"],
                            tight_upload=e["tight_upload"], upload_mode=e["upload_mode"],
                            compute_dtype=getattr(torch, e["compute_dtype"]))

    def check(self, control: bool = False):
        """The program's readings against the reference's; with
        ``control``, also the reference's through float8 (``control``) and
        its records with each batch's second half left out
        (``half_batch``)."""
        self.reference.to(self.device)
        got, ctrl, half = [], [], []
        for i in self.sample():
            batch = self.traffic.batch(i)
            want = self.reference_batch(self.reference, batch)
            got.append((self.records[i], want))
            if control:
                with fp8_products():
                    ctrl.append((self.reference_batch(self.reference, batch), want))
                half.append((left_out(want), want))
        planted = {"control": self.readings(ctrl), "half_batch": self.readings(half)}
        return self.readings(got), (planted if control else None)
