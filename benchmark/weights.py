"""Seeded random weights for a configuration, made on the device in two
large draws and named by the reference's state-dict keys, so one set loads
into the reference model and into the program's.

Convolution and linear kernels: lecun-normal (truncated at two standard
deviations by clamping), biases zero; batch norms near the identity with
random scale, shift and running statistics, so a random backbone keeps
O(1) activations to its last block (identity norms let them decay until
the CAM fusion's min-max normalisation degenerates).  A 'dec' model's
segmentation head is then rescaled on two seeded images so that its
labels vary over an image (a random BiFPN's output is nearly constant
over the pixels).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from benchmark.reference.model import MuSCLe
from benchmark.reference.tta import IMAGENET_MEAN, IMAGENET_STD

# (low, high) of the uniform draws of a batch norm's tensors
BN_RANGES = {"weight": (0.75, 1.25), "bias": (-0.1, 0.1), "running_mean": (-0.2, 0.2),
             "running_var": (0.5, 1.0)}


def reference_model(config: dict) -> MuSCLe:
    """The configuration's reference model, uninitialised, on the meta
    device."""
    with torch.device("meta"):
        return MuSCLe(num_classes=config["num_classes"], backbone=config["backbone"],
                      bifpn_layers=config["bifpn_layers"],
                      bifpn_channels=config["bifpn_channels"],
                      last_pooling=config["last_pooling"], mode=config["mode"])


@torch.no_grad()
def fill(model: MuSCLe, seed: int) -> MuSCLe:
    """Fill ``model`` (already on its device) with the seed's weights."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    kernels, norms, zeros = [], [], []
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            kernels.append(m.weight)
            if m.bias is not None:
                zeros.append(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            norms += [(getattr(m, n), BN_RANGES[n]) for n in BN_RANGES]
            zeros.append(m.num_batches_tracked)
    z = torch.randn(sum(t.numel() for t in kernels), generator=gen, device=dev)
    u = torch.rand(sum(t.numel() for t, _ in norms), generator=gen, device=dev)
    at = 0
    for t in kernels:
        std = (1.0 / t[0].numel()) ** 0.5 / 0.87962566103423978
        t.copy_((z[at: at + t.numel()].clamp(-2.0, 2.0) * std).view_as(t))
        at += t.numel()
    at = 0
    for t, (lo, hi) in norms:
        t.copy_((u[at: at + t.numel()] * (hi - lo) + lo).view_as(t))
        at += t.numel()
    for t in zeros:
        t.zero_()
    return model


@torch.no_grad()
def calibrate_head(model: MuSCLe, images: torch.Tensor, gain: float = 3.0) -> None:
    """Rescale a 'dec' model's ``fuse_dec`` so that its logits on
    ``images`` (NHWC, normalised) are centred with a spread of ~``gain``."""
    was = model.training
    model.eval()
    _, f = model(images, mode="seg_lowres")
    model.train(was)
    f = f.reshape(-1, f.shape[-1])
    mean, std = f.mean(dim=0), f.std(dim=0)
    w = model.fuse_dec.weight[:, :, 0, 0] * (gain / (std + 1e-6))
    model.fuse_dec.weight.copy_(w[:, :, None, None])
    model.fuse_dec.bias.copy_(-(w @ mean))


def make(config: dict, seed: int, device, images=()) -> MuSCLe:
    """The seed's reference model for ``config`` on ``device``; a 'dec'
    model's head calibrated on the top-left 256 x 256 of ``images`` (HWC
    uint8, the traffic's own)."""
    model = reference_model(config).to_empty(device=device)
    fill(model, seed)
    if config["mode"] == "dec":
        x = torch.from_numpy(np.stack([im[:256, :256] for im in images])).to(device)
        mean = torch.tensor(IMAGENET_MEAN, device=device)
        std = torch.tensor(IMAGENET_STD, device=device)
        calibrate_head(model, (x.to(torch.float32) / 255.0 - mean) / std)
    return model.eval()
