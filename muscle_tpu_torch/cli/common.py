"""Shared CLI plumbing (port of ``muscle_tpu/cli/common.py``)."""

from __future__ import annotations

import argparse
import os


def add_voc_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--voc12_root", default="data/VOC2012", type=str)
    p.add_argument("--cls_labels", default="data/cls_labels.npy", type=str)
    p.add_argument("--num_classes", default=21, type=int)
    p.add_argument("--num_workers", default=8, type=int)


def train_device(name: str):
    """``torch.device(name)`` for a trainer: 'cuda' on a machine without a
    card raises rather than falling back to the CPU (``--device cpu`` asks
    for it)."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA card here; pass --device cpu to train "
                           "on the CPU")
    return dev


def train_ranks(name: str):
    """(group, device) of a trainer.  Under ``torchrun`` with more than one
    rank: the rank's process group and device (``parallel.init_from_env``:
    cuda:<LOCAL_RANK> over NCCL, or the CPU over gloo; raises when a rank
    has no card of its own).  Alone: (None, ``train_device(name)``)."""
    from muscle_tpu_torch.parallel import init_from_env

    group, device = init_from_env(name)
    return (group, device) if group is not None else (None, train_device(name))


def load_lists(args, list_path: str):
    from muscle_tpu_torch.data.voc12 import load_img_name_list, load_label_dict

    return load_img_name_list(list_path), load_label_dict(args.cls_labels)


def fetch_weights(path_or_url: str, cache_dir: str | None = None) -> str:
    """Resolve a checkpoint argument to a local file: local paths pass
    through; http(s)/file URLs are downloaded once into a cache keyed by
    basename."""
    if "://" not in path_or_url:
        return path_or_url
    import urllib.parse
    import urllib.request

    cache_dir = cache_dir or os.environ.get(
        "MUSCLE_TPU_CACHE", os.path.expanduser("~/.cache/muscle_tpu"))
    os.makedirs(cache_dir, exist_ok=True)
    name = os.path.basename(urllib.parse.urlparse(path_or_url).path) or "weights.pth"
    dest = os.path.join(cache_dir, name)
    if not os.path.exists(dest):
        tmp = dest + ".part"
        urllib.request.urlretrieve(path_or_url, tmp)
        os.replace(tmp, dest)
    return dest


def load_model_state(weights: str | None, model) -> None:
    """Load a checkpoint into ``model`` with strict=False semantics: keys
    the model has are overwritten (their shapes must match), each in its
    own dtype (``convert.load_into``), the rest keep their initialisation.
    ``weights``: a reference ``.pth``/``.ckpt`` state dict (local path or
    URL), the JAX package's ``model_<epoch>.msgpack``, or None to keep the
    initialisation."""
    if not weights:
        return
    from muscle_tpu_torch.convert import (
        load_into,
        load_reference_state_dict,
        read_flax_msgpack,
        state_dict_from_jax,
    )

    weights = fetch_weights(weights)
    if weights.endswith(".pth") or weights.endswith(".ckpt"):
        loaded = load_reference_state_dict(weights)
    elif weights.endswith(".msgpack"):
        loaded = state_dict_from_jax(read_flax_msgpack(weights))
    else:
        raise ValueError(f"unrecognised checkpoint {weights!r}: expected a torch .pth/.ckpt "
                         "or the JAX package's model_<epoch>.msgpack")
    own = model.state_dict()
    keep = {}
    for k, v in loaded.items():
        if k in own:
            if own[k].shape != v.shape:
                raise ValueError(f"shape mismatch for {k}: {tuple(own[k].shape)} vs "
                                 f"{tuple(v.shape)}")
            keep[k] = v
    load_into(model, keep)


class RunStats:
    """What an inference CLI's run did, from construction on: the wall
    seconds, the backbone's forward calls (a hook on ``backbone``) and the
    MBConv kernel's launches (its wrapper's counts).  ``tick(done)`` after
    each batch keeps the first batch's seconds apart (its canvases' first
    convolutions, the kernels' weight folds).  ``summary`` prints and
    returns them as one JSON line, which is how a caller in another
    process reads them."""

    def __init__(self, backbone, device):
        import time

        import torch

        from muscle_tpu_torch.ops.mbconv import mbconv_stride1

        self._sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
            else (lambda: None)
        self._counts = lambda: (mbconv_stride1.launches, mbconv_stride1.launches_bf16)
        self._start = self._counts()
        self.forwards = 0
        backbone.register_forward_hook(lambda *_: setattr(self, "forwards", self.forwards + 1))
        self._clock = time.perf_counter
        self._t0 = self._clock()
        self._first = (0, 0.0)  # (images, seconds) at the first batch's end

    def tick(self, done: int) -> None:
        if not self._first[0]:
            self._first = (done, self._clock() - self._t0)

    def summary(self, images: int, **extra) -> dict:
        import json

        self._sync()
        secs = self._clock() - self._t0
        f32, bf16 = (now - was for now, was in zip(self._counts(), self._start))
        n1, s1 = self._first
        rec = {"images": images, "seconds": secs,
               "images_per_s": images / secs if secs > 0 else None,
               "first_batch_images": n1, "first_batch_seconds": s1,
               "images_per_s_after_first": (images - n1) / (secs - s1)
               if images > n1 and secs > s1 else None,
               "backbone_forwards": self.forwards, "mbconv_launches": f32,
               "mbconv_launches_bf16": bf16, **extra}
        print(json.dumps(rec), flush=True)
        return rec


def save_score_dict(path: str, d: dict) -> None:
    """Save a {class index: (H, W) array} dict as the reference's .npy."""
    import numpy as np

    np.save(path, d)


def spatial_summary(mesh, engine) -> dict:
    """A spatially sharded CLI run's extra summary keys: the mesh's shape
    and this rank's coordinates and exchanges (the engine's
    ``stripes.stats``); none without a mesh."""
    if mesh is None:
        return {}
    return {"mesh": mesh.shape, "data_index": mesh.data_index, "model_index": mesh.model_index,
            "exchanges": {k: {"calls": v["calls"], "bytes": v["bytes"]}
                          for k, v in engine.stripes.stats.items()}}


def written_rows(mesh, n: int) -> slice:
    """The records of a batch of ``n`` that this rank writes, so that each
    image's files are written once: all of them without a mesh; under one
    (where the engines return the whole batch's records on every rank)
    its data row's share on the first rank of each model group, or where
    the batch was not split (``parallel.data_share``) all of them on the
    first rank, and none on the other ranks."""
    from muscle_tpu_torch.parallel import data_share

    if mesh is None:
        return slice(None)
    rows, split = data_share(mesh, n)
    if mesh.model_index or not (split or mesh.data_index == 0):
        return slice(0)
    return rows


def sort_by_orientation(names: list[str], voc12_root: str) -> list[str]:
    """Stable-sort an inference list landscape-first (header-only PIL
    reads), so batches are orientation-homogeneous and the TTA engine's
    per-batch canvases drop the square canvas's padding."""
    from PIL import Image

    from muscle_tpu_torch.data.voc12 import get_img_path

    def is_portrait(n: str) -> bool:
        with Image.open(get_img_path(n, voc12_root)) as im:
            w, h = im.size
        return h > w

    return sorted(names, key=is_portrait)


def prefetch_chunks(items: list, batch_size: int, load_fn, depth: int = 2, group=None):
    """Yield (chunk, load_fn(chunk)) over consecutive chunks, loading ahead
    in one worker thread.  group: a data-parallel process group: each chunk
    is cut to this rank's rows (``parallel.rank_rows``: the JAX engines'
    batch sharded over 'data'; a last chunk the ranks do not divide is split
    as evenly as it goes) and a rank's empty chunk is skipped."""
    import collections
    import itertools
    from concurrent.futures import ThreadPoolExecutor

    from muscle_tpu_torch.parallel import rank_rows

    chunks = [items[i: i + batch_size] for i in range(0, len(items), batch_size)]
    chunks = [c for c in (c[rank_rows(len(c), group)] for c in chunks) if c]
    with ThreadPoolExecutor(1) as ex:
        pending = collections.deque()
        it = iter(chunks)
        for c in itertools.islice(it, depth):
            pending.append((c, ex.submit(load_fn, c)))
        for nxt in it:
            c, f = pending.popleft()
            yield c, f.result()
            pending.append((nxt, ex.submit(load_fn, nxt)))
        while pending:
            c, f = pending.popleft()
            yield c, f.result()
