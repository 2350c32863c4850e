"""The general traffic generator: images, label vectors and training
batches from a traffic file's parameters and the run's seed.

Everything a run feeds is a pure function of (seed, batch index), so the
reference can rebuild any batch after the window.  Pixels are made on the
device from a ``torch.Generator`` in a few large calls and brought to the
host once, where the program takes them: a pool per image size, from which
each batch draws its images in a seeded order, so every seed sends the same
sizes and amounts of work in another order.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

TRAFFIC = Path(__file__).resolve().parent / "traffic"
DECK = 1024  # label sets in a serving mix's deck


def label_sets(name: str) -> tuple[list[list[int]], np.ndarray]:
    """(class-index sets, probabilities) of a label file under traffic/:
    each set with the count of images that carry it."""
    rows = json.loads((TRAFFIC / name).read_text())["sets"]
    counts = np.asarray([n for _, n in rows], np.float64)
    return [list(s) for s, _ in rows], counts / counts.sum()


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, *key])


def multi_hot(classes, num_classes: int = 20) -> np.ndarray:
    lab = np.zeros(num_classes, np.float32)
    lab[list(classes)] = 1.0
    return lab


def draw_labels(rng: np.random.Generator, sets, probs, n: int) -> list[np.ndarray]:
    """n multi-hot label vectors drawn from the sets."""
    return [multi_hot(sets[j]) for j in rng.choice(len(sets), size=n, p=probs)]


def label_deck(sets, probs, n: int) -> list[list[int]]:
    """n label sets in the sets' proportions (largest remainders): the same
    deck for every seed, which only shuffles it."""
    exact = probs * n
    counts = np.floor(exact).astype(int)
    counts[np.argsort(counts - exact)[: n - counts.sum()]] += 1
    return [sets[j] for j, c in enumerate(counts) for _ in range(c)]


@torch.no_grad()
def image_pool(seed: int, size, n: int, device) -> list[np.ndarray]:
    """n smooth-gradient-plus-noise HWC uint8 images of ``size`` (h, w), the
    VOC-shaped synthetic images of the port's card checks."""
    h, w = size
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    mix = torch.rand((n, 2, 3), generator=gen, device=device) * 0.8 + 0.2
    yy = torch.linspace(0, 1, h, device=device)[None, :, None, None]
    xx = torch.linspace(0, 1, w, device=device)[None, None, :, None]
    base = 255 * (0.2 + 0.6 * (yy * mix[:, None, None, 0] + xx * mix[:, None, None, 1]) / 2.0)
    base = base + 12.0 * torch.randn((n, h, w, 3), generator=gen, device=device)
    imgs = base.clamp(0, 255).to(torch.uint8).cpu().numpy()
    return list(imgs)


class ImageTraffic:
    """Batches of ``traffic['batch']`` images for the serving cells: batch i
    takes size ``sizes[i % len(sizes)]`` (orientation-homogeneous batches
    alternating, as the CLIs' orientation sort feeds them) and draws its
    images from that size's pool.  Labels come from a deck of DECK sets in
    the label file's proportions, the same for every seed
    and shuffled by it, so that every seed asks for the same host work (one
    map a labelled class) in another order."""

    def __init__(self, traffic: dict, seed: int, device):
        self.t, self.seed = traffic, seed
        self.sizes = [tuple(s) for s in traffic["sizes"]]
        self.pools = [image_pool(seed + 7919 * (k + 1), s, traffic["pool_per_size"], device)
                      for k, s in enumerate(self.sizes)]
        deck = label_deck(*label_sets(traffic["labels"]), DECK)
        order = _rng(seed, 1).permutation(len(deck))
        self.deck = [multi_hot(deck[j]) for j in order]

    def batch(self, i: int):
        """(images, names, labels) of batch i."""
        b = self.t["batch"]
        k = i % len(self.sizes)
        idx = _rng(self.seed, 2, i).choice(len(self.pools[k]), size=b, replace=False)
        names = [f"b{i}_{j}" for j in range(b)]
        labels = [self.deck[(i * b + j) % len(self.deck)] for j in range(b)]
        return [self.pools[k][j] for j in idx], names, labels


@torch.no_grad()
def ycbcr_batches(seed: int, n_batches: int, batch: int, side: int, device):
    """n_batches of ``batch`` smooth random ``side`` x ``side`` crops (16-pixel
    blocks plus noise) as uint8 4:2:0 planes (BT.601 full range, the chroma
    box-subsampled), made on the device: [(y (B, S, S), c (B, S/2, S/2, 2))]."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    out = []
    for _ in range(n_batches):
        lo = torch.rand((batch, 3, side // 16, side // 16), generator=gen, device=device) * 255
        rgb = torch.nn.functional.interpolate(lo, scale_factor=16, mode="nearest")
        rgb = rgb.permute(0, 2, 3, 1) + 12.0 * torch.randn((batch, side, side, 3),
                                                          generator=gen, device=device)
        r, g, b = rgb.clamp(0, 255).unbind(-1)
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
        cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
        c = torch.stack([cb, cr], -1).reshape(batch, side // 2, 2, side // 2, 2, 2).mean((2, 4))
        out.append((torch.round(y).to(torch.uint8).cpu().numpy(),
                    torch.round(c).to(torch.uint8).cpu().numpy()))
    return out


class TrainTraffic:
    """A pool of ``traffic['pool_batches']`` distinct training batches
    {'img_y', 'img_c', 'label'} (host numpy, the loader's output); step i
    takes pool batch i mod the pool, so the first steps' rows all differ."""

    def __init__(self, traffic: dict, seed: int, device):
        self.t = traffic
        sets, probs = label_sets(traffic["labels"])
        planes = ycbcr_batches(seed, traffic["pool_batches"], traffic["batch"], traffic["crop"],
                               device)
        self.pool = []
        for k, (y, c) in enumerate(planes):
            labels = draw_labels(_rng(seed, k), sets, probs, traffic["batch"])
            self.pool.append({"img_y": y, "img_c": c, "label": np.stack(labels)})

    def batch(self, i: int) -> dict:
        return self.pool[i % len(self.pool)]
