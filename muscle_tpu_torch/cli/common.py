"""Shared CLI plumbing (port of ``muscle_tpu/cli/common.py``)."""

from __future__ import annotations

import argparse
import os


def add_voc_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--voc12_root", default="data/VOC2012", type=str)
    p.add_argument("--cls_labels", default="data/cls_labels.npy", type=str)
    p.add_argument("--num_classes", default=21, type=int)
    p.add_argument("--num_workers", default=8, type=int)


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
    the model has are overwritten (their shapes must match), the rest keep
    their initialisation.  ``weights``: a reference ``.pth``/``.ckpt``
    state dict (local path or URL), or None to keep the initialisation."""
    if not weights:
        return
    weights = fetch_weights(weights)
    if weights.endswith(".pth") or weights.endswith(".ckpt"):
        from muscle_tpu_torch.convert import load_reference_state_dict

        loaded = load_reference_state_dict(weights)
    elif weights.endswith(".msgpack"):
        raise NotImplementedError(
            f"{weights!r}: Flax .msgpack checkpoints are not readable by the PyTorch "
            "port yet; convert them to a .pth state dict with "
            "muscle_tpu_torch.convert.state_dict_from_jax")
    else:
        raise ValueError(f"unrecognised checkpoint {weights!r}: expected a torch .pth/.ckpt")
    own = model.state_dict()
    keep = {}
    for k, v in loaded.items():
        if k in own:
            if own[k].shape != v.shape:
                raise ValueError(f"shape mismatch for {k}: {tuple(own[k].shape)} vs "
                                 f"{tuple(v.shape)}")
            keep[k] = v
    model.load_state_dict(keep, strict=False)


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


def prefetch_chunks(items: list, batch_size: int, load_fn, depth: int = 2):
    """Yield (chunk, load_fn(chunk)) over consecutive chunks, loading ahead
    in one worker thread."""
    import collections
    import itertools
    from concurrent.futures import ThreadPoolExecutor

    chunks = [items[i: i + batch_size] for i in range(0, len(items), batch_size)]
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
