"""Weights between the JAX package's Flax trees and this package's state
dicts.

The port's modules use the reference's state-dict key names, so a
reference ``.pth`` loads straight into them (``load_reference_state_dict``)
and a JAX package variable tree maps onto them key by key
(``state_dict_from_jax``, the port's own copy of the JAX package's inverse
converter, restricted to the backbone, ``fuse``, ``fc`` and ``fuse_dec``).

Layouts: conv (kh, kw, I, O) -> (O, I, kh, kw) (the depthwise (k, k, 1, C)
included); dense (in, out) -> (out, in); BatchNorm scale/bias and
mean/var -> weight/bias and running_mean/running_var.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pth``/``.ckpt`` state dict, unwrapping Lightning-style
    ``{'state_dict': ...}`` files."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj and not any(
        k.endswith(".weight") for k in obj
    ):
        obj = obj["state_dict"]
    return {k: v.detach() for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _get(tree: Mapping[str, Any], path: tuple[str, ...]) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def _has(tree: Mapping[str, Any], path: tuple[str, ...]) -> bool:
    node = tree
    for p in path:
        if p not in node:
            return False
        node = node[p]
    return True


def _writers(variables: Mapping[str, Any], sd: dict[str, np.ndarray]):
    """(conv, norm) functions copying a Flax conv / norm at ``path`` into
    ``sd`` under the torch ``key``; a norm with running statistics in
    ``batch_stats`` (BatchNorm) gets them too."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def conv(path, key, bias=False):
        sd[key + ".weight"] = _get(params, path + ("kernel",)).transpose(3, 2, 0, 1)
        if bias:
            sd[key + ".bias"] = _get(params, path + ("bias",))

    def norm(path, key):
        sd[key + ".weight"] = _get(params, path + ("scale",))
        sd[key + ".bias"] = _get(params, path + ("bias",))
        if _has(stats, path + ("mean",)):
            sd[key + ".running_mean"] = _get(stats, path + ("mean",))
            sd[key + ".running_var"] = _get(stats, path + ("var",))

    return conv, norm


def _tensors(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's state dict for a JAX ``MuSCLe`` (enc mode) variable tree
    ``{'params': ..., 'batch_stats': ...}`` of numpy arrays."""
    params = variables["params"]
    sd: dict[str, np.ndarray] = {}
    conv, bn = _writers(variables, sd)

    bb = ("backbone",)
    conv(bb + ("_conv_stem",), "backbone._conv_stem")
    bn(bb + ("_bn0",), "backbone._bn0")
    blocks = sorted(int(k.split("_blocks_")[1]) for k in params["backbone"]
                    if k.startswith("_blocks_"))
    for i in blocks:
        src = bb + (f"_blocks_{i}",)
        dst = f"backbone._blocks.{i}."
        if _has(params, src + ("_expand_conv",)):
            conv(src + ("_expand_conv",), dst + "_expand_conv")
            bn(src + ("_bn0",), dst + "_bn0")
        conv(src + ("_depthwise_conv",), dst + "_depthwise_conv")
        bn(src + ("_bn1",), dst + "_bn1")
        if _has(params, src + ("_se_reduce",)):
            conv(src + ("_se_reduce",), dst + "_se_reduce", bias=True)
            conv(src + ("_se_expand",), dst + "_se_expand", bias=True)
        conv(src + ("_project_conv",), dst + "_project_conv")
        bn(src + ("_bn2",), dst + "_bn2")
    if _has(params, ("fuse",)):
        conv(("fuse",), "fuse", bias=True)
    if _has(params, ("fc",)):
        sd["fc.weight"] = _get(params, ("fc", "kernel")).T
    if _has(params, ("fuse_dec",)):
        conv(("fuse_dec",), "fuse_dec", bias=True)
    return _tensors(sd)


def irn_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's (and the reference's) state dict for a JAX
    ``EdgeDisplacement`` variable tree ``{'params': ..., 'batch_stats': ...}``
    of numpy arrays: the inverse of the JAX package's
    ``convert_irn_state_dict``."""
    sd: dict[str, np.ndarray] = {}
    conv, norm = _writers(variables, sd)
    net = ("net",)
    rn = net + ("resnet50",)
    conv(rn + ("conv1",), "resnet50.conv1")
    norm(rn + ("bn1", "bn"), "resnet50.bn1")
    for layer, blocks in (("layer1", 3), ("layer2", 4), ("layer3", 6), ("layer4", 3)):
        for i in range(blocks):
            src = rn + (f"{layer}_{i}",)
            dst = f"resnet50.{layer}.{i}."
            for c in ("conv1", "conv2", "conv3"):
                conv(src + (c,), dst + c)
            for b in ("bn1", "bn2", "bn3"):
                norm(src + (b, "bn"), dst + b)
            if _has(variables["params"], src + ("downsample_conv",)):
                conv(src + ("downsample_conv",), dst + "downsample.0")
                norm(src + ("downsample_bn", "bn"), dst + "downsample.1")
    heads = [f"fc_edge{i}" for i in range(1, 6)] + [f"fc_dp{i}" for i in range(1, 7)]
    for h in heads:
        conv(net + (h, "conv"), h + ".0")
        norm(net + (h, "gn"), h + ".1")
    conv(net + ("fc_edge6",), "fc_edge6", bias=True)
    conv(net + ("fc_dp7_pre", "conv"), "fc_dp7.0")
    norm(net + ("fc_dp7_pre", "gn"), "fc_dp7.1")
    conv(net + ("fc_dp7_out",), "fc_dp7.3")
    stats = variables.get("batch_stats", {})
    if _has(stats, net + ("mean_shift",)):
        sd["mean_shift.running_mean"] = _get(stats, net + ("mean_shift",))
    return _tensors(sd)
