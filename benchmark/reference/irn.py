"""Plain IRN random-walk refinement in float32, one image at a time: what
SCoulY/MuSCLe's ``infer_irn.py`` computes with IRN's ``propagate_to_edge``
(Ahn, Cho and Kwak, CVPR 2019, github.com/jiwoon-ahn/irn).

* ``EdgeNet``: the ResNet-50 with strides (2, 2, 2, 1) and frozen batch
  norms, and IRN's edge head: five 1x1 convolutions to 32 channels, each
  with GroupNorm(4, 32), the deeper three upsampled 2x / 4x / 4x
  (bilinear, half-pixel), cropped to the stride-4 grid, concatenated and
  reduced by ``fc_edge6`` to one logit.  NCHW; state-dict keys are IRN's
  (``resnet50.layer1.0.conv1.weight``, ``fc_edge3.1.bias`` ...), so one set
  of weights loads into it and into the program's ``EdgeDisplacement``.
* ``edge_map``: the image and its horizontal flip, each zero-padded
  top-left to the crop, through the net; the logits cropped to the
  feature window (eh, ew) = ((H - 1) // 4 + 1, (W - 1) // 4 + 1), the
  flip undone inside it, and the edge the sigmoid of their mean.
* ``transition``: the dense (V, V) affinity of the window's V = eh * ew
  nodes: a unit diagonal, and for each pair of nodes p, q = p + d over
  the 34 radius-5 search directions d, 1 - max(edge over the cells within
  distance 1 of the segment p -> q), both ways; raised to the power beta
  and normalised over each column.
* ``refine``: the walk of the labelled CAMs times (1 - edge) over
  2^exp_times steps, the 4x half-pixel upsample with its edge clamp, the
  crop to (H, W), the division by the largest value, the background at
  the threshold, the argmax.

Where it departs from the published code, and why:

1. The image reaches the net through the 4:2:0 upload of the fast IO
   (``--fast 1``, the cell's): PIL's YCbCr conversion and BOX chroma
   subsampling, the BT.601 decode (``tta.upload``), as the CAM and seg
   references take it.  The published code reads the JPEG's RGB.
2. The CAMs reach the walk grid as the fast IO uploads them: each
   class's map resized to (eh, ew) by PIL's bilinear on the host and
   rounded to float16.  The published code resizes with
   ``F.interpolate(..., align_corners=False)`` in float32.
3. The 2^exp_times steps are taken as 64 products of the CAM rows with
   the transition matrix (x <- x @ T); the published code squares T
   exp_times times and multiplies once.  The operator is the same, the
   rounding differs, and the rows cost 60x fewer operations.
4. The affinities are built straight on the (eh, ew) window with walls of
   edge 1 around it; the published code builds them on a grid padded by
   the radius and crops the dense matrix.  Both keep exactly the pairs
   whose two ends lie in the window.

Plain PyTorch, NumPy and PIL; it imports neither JAX, nor the JAX
package, nor anything of the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.tta import IMAGENET_MEAN, IMAGENET_STD, upload

BN_EPS = GN_EPS = 1e-5


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1, each with a frozen batch norm, and
    the projected or identity shortcut."""

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * planes, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or cin != 4 * planes:
            self.downsample = nn.Sequential(nn.Conv2d(cin, 4 * planes, 1, stride=stride,
                                                      bias=False),
                                            nn.BatchNorm2d(4 * planes, eps=BN_EPS))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet50(nn.Module):
    """The five feature maps the edge head takes: the pooled stem and the
    four stages."""

    def __init__(self, strides=(2, 2, 2, 1)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=strides[0], padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        cin = 64
        for i, (planes, n, stride) in enumerate(((64, 3, 1), (128, 4, strides[1]),
                                                 (256, 6, strides[2]), (512, 3, strides[3]))):
            blocks = [Bottleneck(cin if j == 0 else 4 * planes, planes, stride if j == 0 else 1)
                      for j in range(n)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            cin = 4 * planes

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        feats = [x]
        for i in range(1, 5):
            feats.append(getattr(self, f"layer{i}")(feats[-1]))
        return feats


class EdgeBranch(nn.Sequential):
    """1x1 convolution to 32 channels and GroupNorm(4, 32), then the
    upsample (half-pixel bilinear) and the ReLU."""

    def __init__(self, cin: int, up: int):
        super().__init__(nn.Conv2d(cin, 32, 1, bias=False), nn.GroupNorm(4, 32, eps=GN_EPS))
        self.up = up

    def forward(self, x):
        x = super().forward(x)
        if self.up > 1:
            x = F.interpolate(x, scale_factor=self.up, mode="bilinear", align_corners=False)
        return F.relu(x)


class EdgeNet(nn.Module):
    """ResNet-50 and IRN's edge head; ``forward`` gives the edge logits
    (N, 1, h, w) at stride 4."""

    def __init__(self, strides=(2, 2, 2, 1)):
        super().__init__()
        self.resnet50 = ResNet50(strides)
        for i, (cin, up) in enumerate(((64, 1), (256, 1), (512, 2), (1024, 4), (2048, 4))):
            setattr(self, f"fc_edge{i + 1}", EdgeBranch(cin, up))
        self.fc_edge6 = nn.Conv2d(160, 1, 1, bias=True)

    def forward(self, x):
        feats = self.resnet50(x)
        e = [getattr(self, f"fc_edge{i + 1}")(f) for i, f in enumerate(feats)]
        h, w = e[1].shape[2:]
        return self.fc_edge6(torch.cat([t[..., :h, :w] for t in e], dim=1))


def grid_size(h: int, w: int, stride: int = 4) -> tuple[int, int]:
    """The feature window (eh, ew) of an (h, w) image."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def normalised(image: np.ndarray, crop: int, device) -> torch.Tensor:
    """The (H, W) image through the 4:2:0 upload, normalised, and its
    horizontal flip, each zero-padded top-left to (crop, crop): (2, 3,
    crop, crop)."""
    rgb, sizes = upload([image], crop, device)
    h, w = (int(v) for v in sizes[0])
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    x = (rgb[0, :h, :w] / 255.0 - mean) / std
    views = torch.zeros((2, crop, crop, 3), device=device)
    views[0, :h, :w] = x
    views[1, :h, :w] = x.flip(1)
    return views.permute(0, 3, 1, 2)


@torch.no_grad()
def edge_map(model: EdgeNet, image: np.ndarray, crop: int = 512, stride: int = 4):
    """The (eh, ew) edge probability of an (H, W, 3) uint8 image."""
    h, w = image.shape[:2]
    eh, ew = grid_size(h, w, stride)
    dev = next(model.parameters()).device
    logits = model(normalised(image, crop, dev))[:, 0, :eh, :ew]
    return torch.sigmoid(logits[0] / 2 + logits[1].flip(-1) / 2)


@functools.lru_cache(maxsize=4)
def search_paths(radius: int = 5) -> tuple:
    """((dy, dx), cells) of each search direction: (0, 1) .. (0, radius - 1),
    then every (dy > 0, dx) strictly inside the radius; cells are the
    (y, x) of the box between (0, 0) and (dy, dx) within distance 1 of the
    segment between them."""
    dirs = [(0, x) for x in range(1, radius)]
    dirs += [(y, x) for y in range(1, radius) for x in range(1 - radius, radius)
             if x * x + y * y < radius * radius]
    out = []
    for dy, dx in dirs:
        cells = [(y, x) for y in range(min(0, dy), max(0, dy) + 1)
                 for x in range(min(0, dx), max(0, dx) + 1)
                 if (dy * x - dx * y) ** 2 < dy * dy + dx * dx]
        out.append(((dy, dx), tuple(cells)))
    return tuple(out)


def transition(edge: torch.Tensor, radius: int = 5, beta: int = 8) -> torch.Tensor:
    """The (V, V) column-stochastic transition matrix of an (eh, ew) edge
    map, nodes in row-major order."""
    eh, ew = edge.shape
    v = eh * ew
    walled = F.pad(edge, (radius, radius, radius, radius), value=1.0)
    node = torch.arange(v, device=edge.device).reshape(eh, ew)
    aff = torch.eye(v, device=edge.device)
    for (dy, dx), cells in search_paths(radius):
        # the path's largest edge from every node p of the window; a pair
        # whose far end q = p + d leaves the window meets a wall (its q cell)
        top = torch.stack([walled[radius + y: radius + y + eh, radius + x: radius + x + ew]
                           for y, x in cells]).amax(dim=0)
        a = 1.0 - top
        ys, xs = torch.meshgrid(torch.arange(eh, device=edge.device),
                                torch.arange(ew, device=edge.device), indexing="ij")
        inside = (ys + dy < eh) & (xs + dx >= 0) & (xs + dx < ew)
        p = node[inside]
        q = node[ys[inside] + dy, xs[inside] + dx]
        aff[p, q] = a[inside]
        aff[q, p] = a[inside]
    scaled = aff ** beta
    return scaled / scaled.sum(dim=0, keepdim=True)


def grid_cams(cam_dict: dict, eh: int, ew: int) -> tuple[list[int], torch.Tensor]:
    """(classes in ascending order, (C, eh, ew) float32): each class's map
    resized to the walk grid by PIL's bilinear and rounded to float16, as
    the fast IO uploads it."""
    from PIL import Image

    keys = sorted(int(k) for k in cam_dict)
    maps = [np.asarray(Image.fromarray(np.asarray(cam_dict[k], np.float32), "F").resize(
        (ew, eh), Image.BILINEAR), np.float32).astype(np.float16) for k in keys]
    return keys, torch.from_numpy(np.stack(maps).astype(np.float32))


@torch.no_grad()
def walked(model: EdgeNet, image: np.ndarray, cam_dict: dict, *, crop: int = 512,
           stride: int = 4, radius: int = 5, beta: int = 8, exp_times: int = 6):
    """(classes, (C, H, W) walked CAMs upsampled to the image and divided
    by their largest value)."""
    h, w = image.shape[:2]
    edge = edge_map(model, image, crop, stride)
    eh, ew = edge.shape
    keys, cams = grid_cams(cam_dict, eh, ew)
    x = (cams.to(edge.device) * (1.0 - edge)).reshape(len(keys), -1)
    t = transition(edge, radius, beta)
    for _ in range(2 ** exp_times):
        x = x @ t
    up = F.interpolate(x.reshape(len(keys), 1, eh, ew), scale_factor=stride, mode="bilinear",
                       align_corners=False)[:, 0, :h, :w]
    return keys, up / up.max()


def refine(model: EdgeNet, image: np.ndarray, cam_dict: dict, *, bg_threshold: float = 0.35,
           **kw) -> np.ndarray:
    """The (H, W) uint8 label map: 0 where the background threshold wins
    (ties included), else 1 + the class."""
    keys, up = walked(model, image, cam_dict, **kw)
    scores = torch.cat([torch.full_like(up[:1], bg_threshold), up])
    pick = torch.argmax(scores, dim=0).cpu().numpy()
    return np.asarray([0] + [k + 1 for k in keys], np.uint8)[pick]
