"""Weights between the JAX package's Flax trees and this package's state
dicts.

The port's modules use the reference's state-dict key names, so a
reference ``.pth`` loads straight into them (``load_reference_state_dict``)
and a JAX package variable tree maps onto them key by key
(``state_dict_from_jax``, the port's own copy of the JAX package's inverse
converter: the backbone, ``fuse``, ``fc``, ``fuse_dec`` and the BiFPN).

Layouts: conv (kh, kw, I, O) -> (O, I, kh, kw) (the depthwise (k, k, 1, C)
included); dense (in, out) -> (out, in); BatchNorm scale/bias and
mean/var -> weight/bias and running_mean/running_var.  Each leaf keeps
its dtype where it is bfloat16 (a bf16 model's fresh classifier kernel,
its Adam moments) and is float32 otherwise.

The JAX package's ``model_<epoch>.msgpack`` (Flax's ``to_bytes`` of
``{params, batch_stats}``) reads without the ``msgpack`` package
(``read_flax_msgpack``), and ``load_into`` loads a state dict with each
tensor in its own dtype.
"""

from __future__ import annotations

import struct
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


def _tensor(a) -> torch.Tensor:
    """A leaf as a torch tensor: bfloat16 (a torch tensor, or numpy's
    ``ml_dtypes.bfloat16`` from JAX) stays bfloat16, the rest is float32."""
    if isinstance(a, torch.Tensor):
        return a if a.dtype == torch.bfloat16 else a.to(torch.float32)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.tensor(np.asarray(a, np.float32))


def _get(tree: Mapping[str, Any], path: tuple[str, ...]) -> torch.Tensor:
    node = tree
    for p in path:
        node = node[p]
    return _tensor(node)


def _has(tree: Mapping[str, Any], path: tuple[str, ...]) -> bool:
    node = tree
    for p in path:
        if p not in node:
            return False
        node = node[p]
    return True


def _writers(variables: Mapping[str, Any], sd: dict[str, torch.Tensor]):
    """(conv, norm) functions copying a Flax conv / norm at ``path`` into
    ``sd`` under the torch ``key``; a norm with running statistics in
    ``batch_stats`` (BatchNorm) gets them too."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def conv(path, key, bias=False):
        sd[key + ".weight"] = _get(params, path + ("kernel",)).permute(3, 2, 0, 1)
        if bias:
            sd[key + ".bias"] = _get(params, path + ("bias",))

    def norm(path, key):
        sd[key + ".weight"] = _get(params, path + ("scale",))
        sd[key + ".bias"] = _get(params, path + ("bias",))
        if _has(stats, path + ("mean",)):
            sd[key + ".running_mean"] = _get(stats, path + ("mean",))
            sd[key + ".running_var"] = _get(stats, path + ("var",))

    return conv, norm


def _tensors(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.contiguous() for k, v in sd.items()}


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's state dict for a JAX ``MuSCLe`` variable tree (enc or dec
    mode) ``{'params': ..., 'batch_stats': ...}`` of numpy arrays (a JAX
    ``TrainState``'s ``params`` and ``batch_stats``), or for any of its
    parts (a tree holding only ``BIFPN``, say).  A tree shaped like
    ``params`` (gradients, Adam moments) given as ``{'params': tree}``
    maps onto the parameters' names the same way."""
    params = variables["params"]
    sd: dict[str, torch.Tensor] = {}
    conv, bn = _writers(variables, sd)

    bb = ("backbone",)
    if _has(params, bb):
        conv(bb + ("_conv_stem",), "backbone._conv_stem")
        bn(bb + ("_bn0",), "backbone._bn0")
    blocks = sorted(int(k.split("_blocks_")[1]) for k in params.get("backbone", {})
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
        sd["fc.weight"] = _get(params, ("fc", "kernel")).t()
    if _has(params, ("fuse_dec",)):
        conv(("fuse_dec",), "fuse_dec", bias=True)
    if _has(params, ("BIFPN",)):
        for k in ("inp3", "inp4", "inp5", "inp6", "inp7"):
            conv(("BIFPN", k, "conv"), f"BIFPN.{k}.0", bias=True)
            bn(("BIFPN", k, "bn"), f"BIFPN.{k}.1")
        layers = sorted(int(k.split("layer_")[1]) for k in params["BIFPN"]
                        if k.startswith("layer_"))
        for i in layers:
            src, dst = ("BIFPN", f"layer_{i}"), f"BIFPN.BIFPN_Layers.{i}."
            for k in ("convp67", "convp56", "convp45", "convp34"):
                conv(src + (k, "conv"), dst + k + ".0", bias=True)
            for k in ("out4", "out5", "out6", "out7"):
                conv(src + (k, "conv"), dst + k + ".0", bias=True)
                bn(src + (k, "bn"), dst + k + ".1")
    return _tensors(sd)


def irn_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's (and the reference's) state dict for a JAX
    ``EdgeDisplacement`` variable tree ``{'params': ..., 'batch_stats': ...}``
    of numpy arrays: the inverse of the JAX package's
    ``convert_irn_state_dict``."""
    sd: dict[str, torch.Tensor] = {}
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


def load_into(model: torch.nn.Module, sd: Mapping[str, torch.Tensor], strict: bool = False):
    """``model.load_state_dict(sd, strict)`` with each float32 or bfloat16
    tensor loaded in its own dtype: a parameter or buffer of another
    dtype is converted first (its object kept, so an optimizer built on
    it stays valid), where ``load_state_dict`` would round the tensor to
    the parameter's dtype.  The JAX package's loaders keep each leaf's
    dtype the same way."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    with torch.no_grad():
        for k, v in sd.items():
            t = own.get(k)
            if (t is not None and v.dtype in (torch.float32, torch.bfloat16)
                    and t.dtype != v.dtype and t.is_floating_point()):
                t.data = t.data.to(v.dtype)
    return model.load_state_dict(sd, strict=strict)


# Flax's msgpack serialisation: ``flax.serialization.to_bytes`` packs a
# nested dict with each array as msgpack ext type 1 (type 3: a numpy
# scalar) holding the msgpack of (shape, dtype name, C-order bytes).  (It
# splits arrays over 2**30 bytes into chunks; no MuSCLe tensor comes near.)
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# marker -> (length format, kind)
_SIZED = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"), 0xde: (">H", "map"),
          0xdf: (">I", "map")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _msgpack_array(data: bytes):
    """Flax's array encoding: bfloat16 as a torch tensor (numpy has no
    bfloat16 of its own), other dtypes as numpy arrays."""
    (shape, name, buf), _ = _unpack(data, 0)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unpack(buf: bytes, pos: int):
    """The msgpack object at ``buf[pos:]`` and the position after it."""
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b], pos
    if b in _FIXED:
        return struct.unpack_from(_FIXED[b], buf, pos)[0], pos + struct.calcsize(_FIXED[b])
    if 0xa0 <= b <= 0xbf:
        kind, n = "str", b & 0x1f
    elif 0x90 <= b <= 0x9f:
        kind, n = "array", b & 0x0f
    elif 0x80 <= b <= 0x8f:
        kind, n = "map", b & 0x0f
    elif b in _FIXEXT:
        kind, n = "ext", _FIXEXT[b]
    elif b in _SIZED:
        fmt, kind = _SIZED[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack: unsupported marker 0x{b:02x} at byte {pos - 1}")
    if kind in ("str", "bin"):
        raw = bytes(buf[pos:pos + n])
        return (raw.decode() if kind == "str" else raw), pos + n
    if kind == "ext":
        code = struct.unpack_from(">b", buf, pos)[0]
        data = bytes(buf[pos + 1:pos + 1 + n])
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        return _msgpack_array(data), pos + 1 + n
    out = [] if kind == "array" else {}
    for _ in range(n):
        if kind == "array":
            item, pos = _unpack(buf, pos)
            out.append(item)
        else:
            key, pos = _unpack(buf, pos)
            out[key], pos = _unpack(buf, pos)
    return out, pos


def read_flax_msgpack(path: str) -> dict:
    """The nested dict that ``flax.serialization.to_bytes`` wrote to
    ``path`` (the JAX package's ``model_<epoch>.msgpack``: ``{'params':
    ..., 'batch_stats': ...}``), each array in its own dtype (bfloat16 ones
    as torch tensors), for ``state_dict_from_jax`` or
    ``irn_state_dict_from_jax``."""
    with open(path, "rb") as f:
        data = f.read()
    tree, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{path!r}: {len(data) - end} bytes after the msgpack object")
    return tree
