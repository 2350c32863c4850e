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


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's state dict for a JAX ``MuSCLe`` (enc mode) variable tree
    ``{'params': ..., 'batch_stats': ...}`` of numpy arrays."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: dict[str, np.ndarray] = {}

    def conv(path, key, bias=False):
        sd[key + ".weight"] = _get(params, path + ("kernel",)).transpose(3, 2, 0, 1)
        if bias:
            sd[key + ".bias"] = _get(params, path + ("bias",))

    def bn(path, key):
        sd[key + ".weight"] = _get(params, path + ("scale",))
        sd[key + ".bias"] = _get(params, path + ("bias",))
        sd[key + ".running_mean"] = _get(stats, path + ("mean",))
        sd[key + ".running_var"] = _get(stats, path + ("var",))

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
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
