"""IRN random-walk pseudo-label refinement (port of
``muscle_tpu/inference/irn.py``).

Each image is placed top-left in a square canvas (the smallest multiple of
``bucket`` that fits it, at most ``crop_size``); the edge map is walled
with edge 1.0 outside the image's feature window, which gives zero
affinity to and from pad vertices and zero CAM mass on them, so the walk on
the canvas is exactly the walk on the unpadded grid.  A batch of one
bucket runs as one edge-net forward and one walk.

Two IO modes, as in the JAX package:

* parity (``fast_io=False``): f32 normalised (orig, flip) pairs and
  canvas-resolution CAMs up, (H, W, 21) f32 scores down;
* fast (``fast_io=True``): the image as YCbCr 4:2:0 (normalisation and flip
  on the device), the labelled CAM channels in f16 already at the walk grid
  up, and either the (21, grid, grid) f16 walk scores down, upsampled on
  the host (``output='scores'``), or one uint8 label map per image
  (``output='labels'``: the reference's tail fused on the device).

``run_stream`` overlaps a batch's host packing, its device work and its
host tail over a stream of batches (``inference/stream.py``, as the TTA
engines do); ``refine_batch`` runs the same three stages one after the
other.  The spans (``utils/timers.py``): ``cam_pack`` (the fast path's
per-class CAM downscale, inside ``prep``), ``edge`` (the host's time
enqueueing the edge net, inside ``dispatch``) and the walk's ``walk``
(``ops/stencil_walk.py``).  ``stats`` counts the refiner's work, always
on: read it as a difference.
"""

from __future__ import annotations

import numpy as np
import torch

from muscle_tpu_torch.core.resize import dynamic_window_resize, resize_bilinear
from muscle_tpu_torch.data import transforms as T
from muscle_tpu_torch.inference import stream
from muscle_tpu_torch.inference.cam import COMPUTE_DTYPES
from muscle_tpu_torch.inference.upload import start_download, to_device
from muscle_tpu_torch.ops.random_walk import propagate_to_edge
from muscle_tpu_torch.utils.timers import span

# The refiner's work since the process started: images refined, walks run
# (one a size bucket of a batch), and channel-nodes: ``walked_nodes`` those
# a walk steps over (each image's 20 classes on the whole grid x grid
# canvas), ``labelled_nodes`` the labelled classes' (eh, ew) windows among
# them.  Counted where the work is enqueued (not by ``bench_device_exec``).
stats = {"images": 0, "walks": 0, "walked_nodes": 0, "labelled_nodes": 0}


def _clamp_replicate(rw: torch.Tensor, eh: torch.Tensor, ew: torch.Tensor) -> torch.Tensor:
    """Replicate each (B, C, g, g) map's last valid row and column across
    the pad: the reference interpolates the unpadded (eh, ew) field, which
    clamps at the window edge, where a canvas resize would blend the
    outermost window nodes with pad zeros."""
    b, c, g, _ = rw.shape
    ar = torch.arange(g, device=rw.device)[None]
    ri = torch.minimum(ar, (eh - 1)[:, None])
    rw = torch.gather(rw, 2, ri[:, None, :, None].expand(b, c, g, g))
    ci = torch.minimum(ar, (ew - 1)[:, None])
    return torch.gather(rw, 3, ci[:, None, None, :].expand(b, c, g, g))


def _window(n: int, hw: torch.Tensor) -> torch.Tensor:
    """(B, n, n) indicator of the top-left (h, w) window of each image."""
    rows = torch.arange(n, device=hw.device)[None, :, None]
    cols = torch.arange(n, device=hw.device)[None, None, :]
    return (rows < hw[:, 0, None, None]) & (cols < hw[:, 1, None, None])


class RandomWalkRefiner:
    """Refine CAM score dicts into pseudo-labels.

    Args:
      irn_model: EdgeDisplacement (models/irn.py); moved to ``device`` and
        put in eval mode.
      beta, exp_times, bg_threshold: reference defaults 8 / 6 / 0.35.
      crop_size: max canvas side (512); the walk grid is crop // stride.
      bucket: canvas side granularity (256/384/512 for VOC); 0 = always
        crop_size.
      walk_method: 'stencil' (default), 'banded', 'vector' or 'power'
        (ops/random_walk.py).
      fast_io: the fast IO mode (module docstring).
      max_classes: fast_io per-image class budget floor; a group's budget
        is its largest CAM dict, so no class is ever dropped.
      compute_dtype: torch.float32 or torch.bfloat16: the edge model runs
        in it and the edge map is cast to float32 straight after it; the
        walk stays float32 (its (1 - e)^beta amplifies low-bit noise).
      output: 'scores' or 'labels' (fast_io only).
      device: where the model and the walk run: 'cuda' (default) or 'cpu'.
      walk_kernel: None = the walk's CUDA kernel on a card, its plain
        version on the CPU; False = the plain version anywhere (for
        comparisons on the card).
    """

    def __init__(self, irn_model, beta: int = 8, exp_times: int = 6,
                 bg_threshold: float = 0.35, radius: int = 5, crop_size: int = 512,
                 stride: int = 4, walk_method: str = "stencil", bucket: int = 128,
                 fast_io: bool = False, max_classes: int = 4, compute_dtype=torch.float32,
                 output: str = "scores", device: str | torch.device = "cuda",
                 walk_kernel: bool | None = None):
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        if output not in ("scores", "labels"):
            raise ValueError(f"unsupported output {output!r}")
        if output == "labels" and not fast_io:
            raise ValueError("output='labels' requires fast_io=True")
        self.device = torch.device(device)
        self.model = irn_model.to(self.device).eval()
        self.compute_dtype = compute_dtype
        self.beta = beta
        self.exp_times = exp_times
        self.bg_threshold = bg_threshold
        self.radius = radius
        self.crop_size = crop_size
        self.stride = stride
        self.bucket = bucket
        self.walk_method = walk_method
        self.fast_io = fast_io
        self.max_classes = max_classes
        self.output = output
        self.walk_kernel = walk_kernel
        self._mean = torch.tensor(T.IMAGENET_MEAN[0, 0], dtype=torch.float32, device=self.device)
        self._std = torch.tensor(T.IMAGENET_STD[0, 0], dtype=torch.float32, device=self.device)

    def _crop_for(self, h: int, w: int) -> int:
        if not self.bucket:
            return self.crop_size
        side = max(h, w, self.bucket)
        return min(self.crop_size, -(-side // self.bucket) * self.bucket)

    def _put(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    def _walk(self, crop: int, pairs: torch.Tensor, cams: torch.Tensor, sizes: torch.Tensor,
              cams_at_grid: bool) -> torch.Tensor:
        """Edge forward + CAM downscale + random walk of a batch: pairs
        (B, 2, crop, crop, 3) normalised orig + flip, cams (B, 20, ...) at
        canvas resolution (or at the walk grid with ``cams_at_grid``),
        sizes (B, 2) valid (H, W).  Returns (B, 20, grid, grid) walk output."""
        grid = crop // self.stride
        with span("edge"):  # the host's time enqueueing the edge net
            edge = self.model.edge(pairs.to(self.compute_dtype), valid_hw=sizes,
                                   crop_size=crop).float()
        ehw = (sizes - 1) // self.stride + 1
        fvalid = _window(grid, ehw)
        edge = torch.where(fvalid, edge, torch.ones_like(edge))  # walls outside the window
        if not cams_at_grid:
            # the reference resizes the unpadded (H, W) CAM to its own
            # (eh, ew) feature window: a scale of H / eh, which equals the
            # canvas's uniform stride only when H, W are multiples of it
            box = torch.cat([torch.zeros_like(sizes), sizes], dim=1)
            cams = dynamic_window_resize(cams.permute(0, 2, 3, 1), box, (grid, grid),
                                         dst_hw=ehw, align_corners=False).permute(0, 3, 1, 2)
        cam_small = cams * fvalid[:, None]
        return propagate_to_edge(cam_small, edge, radius=self.radius, beta=self.beta,
                                 exp_times=self.exp_times, method=self.walk_method,
                                 kernel=self.walk_kernel)

    def _upsample_labels_input(self, crop: int, rw: torch.Tensor, sizes: torch.Tensor):
        """The reference tail up to the bg threshold: window-edge clamp, 4x
        half-pixel upsample, /max over the cropped window of all fg
        channels.  Returns (B, crop, crop, 20)."""
        ehw = (sizes - 1) // self.stride + 1
        rw = _clamp_replicate(rw, ehw[:, 0], ehw[:, 1])
        up = resize_bilinear(rw.permute(0, 2, 3, 1), (crop, crop), align_corners=False)
        valid = _window(crop, sizes)[..., None]
        m = torch.amax(torch.where(valid, up, torch.full_like(up, -torch.inf)), dim=(1, 2, 3))
        return up / torch.clamp(m, min=1e-12)[:, None, None, None]

    @torch.inference_mode()
    def _refine(self, crop: int, pairs, cams, sizes) -> torch.Tensor:
        """Parity path of a batch: (B, crop, crop, 21) bg-thresholded scores
        (valid top-left window (H, W), bg channel first)."""
        rw = self._walk(crop, pairs, cams, sizes, cams_at_grid=False)
        up = self._upsample_labels_input(crop, rw, sizes)
        bg = torch.full_like(up[..., :1], self.bg_threshold)
        return torch.cat([bg, up], dim=-1)

    @torch.inference_mode()
    def _refine_fast(self, crop: int, y, c, transposed, cam_vals, cam_idx, sizes,
                     labels: bool) -> torch.Tensor:
        """fast_io path of a batch.  labels=False: (B, 21, grid, grid) f16
        walk scores (bg channel first), divided by the node max only as an
        f16 pre-scale (the host renormalises after its upsample).
        labels=True: (B, crop, crop) uint8 label maps."""
        from muscle_tpu_torch.inference.upload import ycbcr420_unpack_fn

        b = y.shape[0]
        grid = crop // self.stride
        rgb = ycbcr420_unpack_fn(crop)(y, c, transposed)
        valid = _window(crop, sizes)[..., None]
        x = ((rgb / 255.0) - self._mean) / self._std * valid
        # flip the valid window, zero elsewhere
        fcols = torch.clamp(sizes[:, 1, None] - 1 - torch.arange(crop, device=x.device)[None],
                            0, crop - 1)
        xf = torch.gather(x, 2, fcols[:, None, :, None].expand(b, crop, crop, 3)) * valid
        pairs = torch.stack([x, xf], dim=1)
        # scatter the K labelled channels into the class stack; pad entries
        # carry index 20 and land in a dropped channel
        k = cam_idx.shape[1]
        cams = torch.zeros((b, 21, grid, grid), dtype=torch.float32, device=x.device)
        cams.scatter_add_(1, cam_idx.long()[:, :, None, None].expand(b, k, grid, grid),
                          cam_vals.float())
        rw = self._walk(crop, pairs, cams[:, :20], sizes, cams_at_grid=True)
        if not labels:
            m = torch.amax(rw, dim=(1, 2, 3))
            rw = rw / torch.clamp(m, min=1e-12)[:, None, None, None]
            bg = torch.full_like(rw[:, :1], self.bg_threshold)
            return torch.cat([bg, rw], dim=1).to(torch.float16)
        up = self._upsample_labels_input(crop, rw, sizes)
        fg_max = torch.amax(up, dim=-1)
        fg_arg = torch.argmax(up, dim=-1) + 1
        # argmax([bg, fg...]) picks bg on ties: strict >
        return torch.where(fg_max > self.bg_threshold, fg_arg, 0).to(torch.uint8)

    def _host_prep(self, image, cam_dict, crop: int):
        w, h = T.image_size(image)
        arr = T.color_norm(np.asarray(image)[..., :3])
        pair = np.zeros((2, crop, crop, 3), np.float32)
        pair[0, :h, :w] = arr
        pair[1, :h, :w] = arr[:, ::-1]
        cams = np.zeros((20, crop, crop), np.float32)
        for k, v in cam_dict.items():
            cams[k, :h, :w] = np.asarray(v, np.float32)
        return pair, cams, (h, w)

    def refine_image(self, image, cam_dict: dict) -> np.ndarray:
        """One image end to end.  Returns (H, W, 21) float32 scores (bg
        channel = threshold), or an (H, W) uint8 label map with
        output='labels'."""
        return self.refine_batch([image], [cam_dict])[0]

    def refine_batch(self, images, cam_dicts) -> list[np.ndarray]:
        """Batched refinement, grouped by size bucket, one stage after the
        other (``run_stream`` overlaps them).  images: PIL images or HWC
        uint8 arrays; cam_dicts: {class index: (H, W) scores}.  Returns
        per-image (H, W, 21) float32 scores, or (H, W) uint8 label maps
        with output='labels'."""
        names = [str(i) for i in range(len(images))]
        prep, _ = self._prepare((images, names, cam_dicts))
        return self._dispatch_prepped(prep)()

    def run_stream(self, batches, prep_ahead: int = 2, finalize_ahead: int = 2):
        """Overlapped refinement over an iterable of ``(images, names,
        cam_dicts)`` batches; yields each batch's records, ``refine_batch``'s
        for its images, in the order fed.

        The stages run at once (``inference/stream.py``): ``_prepare`` on
        the prep thread (a batch across size buckets is split there into
        one part a bucket, each packed on the host), ``_dispatch_prepped``
        on the caller's thread (each part's upload, edge net, walk and the
        device's share of the tail enqueued, its download started), and
        the finalize on its thread (the wait for the downloads and the
        host's tail).  The records are never gathered: the refiner has no
        mesh."""
        yield from stream.run_stream(batches, self._prepare, self._dispatch_prepped, None,
                                     prep_ahead, finalize_ahead)

    def _prepare(self, batch: tuple) -> tuple[dict, bool]:
        """A fed batch's host stage: its images split by size bucket (the
        order kept in each part's indices), each part packed for its IO
        path, and the part's labelled channel-nodes (for ``stats``).
        Returns (prep, False: no gather)."""
        images, names, cam_dicts = batch
        groups: dict[int, list[int]] = {}
        for i, img in enumerate(images):
            w, h = T.image_size(img)
            groups.setdefault(self._crop_for(h, w), []).append(i)
        parts = []
        for crop, idxs in groups.items():
            imgs = [images[i] for i in idxs]
            dicts = [cam_dicts[i] for i in idxs]
            pack = self._pack_fast if self.fast_io else self._pack_parity
            labelled = 0
            for img, cd in zip(imgs, dicts):
                w, h = T.image_size(img)
                labelled += len(cd) * ((h - 1) // self.stride + 1) * ((w - 1) // self.stride + 1)
            parts.append((crop, idxs, pack(crop, imgs, dicts), labelled))
        return {"names": list(names), "parts": parts}, False

    def _dispatch_prepped(self, prep: dict):
        """Enqueue each part of a prepped batch and start its download;
        returns the ``finalize() -> records`` that waits for them."""
        labels = self.output == "labels"
        pending = []
        for crop, idxs, packed, labelled in prep["parts"]:
            args = [self._put(a) for a in packed]
            if self.fast_io:
                out = self._refine_fast(crop, *args, labels=labels)
            else:
                out = self._refine(crop, *args)
            grid = crop // self.stride
            stats["images"] += len(idxs)
            stats["walks"] += 1
            stats["walked_nodes"] += len(idxs) * 20 * grid * grid
            stats["labelled_nodes"] += labelled
            pending.append((crop, idxs, packed[-1], start_download(out)))
        n = len(prep["names"])

        def finalize() -> list[np.ndarray]:
            out: list = [None] * n
            for crop, idxs, sizes, fetch in pending:
                for i, rec in zip(idxs, self._tail(crop, fetch(), sizes)):
                    out[i] = rec
            return out

        return finalize

    def _pack_parity(self, crop: int, images, cam_dicts):
        """Host packing for the parity path: (pairs (B, 2, crop, crop, 3),
        cams (B, 20, crop, crop), sizes (B, 2))."""
        b = len(images)
        pairs = np.empty((b, 2, crop, crop, 3), np.float32)
        cams = np.empty((b, 20, crop, crop), np.float32)
        sizes = np.empty((b, 2), np.int64)
        for j, (img, cd) in enumerate(zip(images, cam_dicts)):
            pairs[j], cams[j], sizes[j] = self._host_prep(img, cd, crop)
        return pairs, cams, sizes

    def _tail(self, crop: int, buf: np.ndarray, sizes: np.ndarray) -> list[np.ndarray]:
        """The host's share of a part's tail on its download: each image's
        window of the parity scores or of the labels, or the fast scores
        upsampled to image size (PIL bilinear, the device resize's
        half-pixel convention) and renormalised.  Copies: no record holds
        the download buffer."""
        if not self.fast_io or self.output == "labels":
            return [buf[i, : sizes[i, 0], : sizes[i, 1]].copy() for i in range(len(sizes))]
        from PIL import Image

        outs = buf.astype(np.float32)
        grid = crop // self.stride
        results = []
        for i in range(len(sizes)):
            h, w = sizes[i]
            # replicate the last valid row/column one node into the pad: the
            # half-pixel 4x upsample reaches one node past the window edge,
            # where the reference's unpadded interpolate clamps
            eh = (h - 1) // self.stride + 1
            ew = (w - 1) // self.stride + 1
            if eh < grid:
                outs[i, :, eh, :ew] = outs[i, :, eh - 1, :ew]
            if ew < grid:
                outs[i, :, : min(eh + 1, grid), ew] = outs[i, :, : min(eh + 1, grid), ew - 1]
            chans = [np.asarray(Image.fromarray(np.ascontiguousarray(outs[i, ch]), "F").resize(
                (crop, crop), Image.BILINEAR), np.float32)[:h, :w]
                for ch in range(outs.shape[1])]
            res = np.stack(chans, axis=-1)
            # the reference normalises after the upsample, over the cropped
            # window; the device's node-max division was only a pre-scale
            res[..., 1:] /= max(float(res[..., 1:].max()), 1e-12)
            results.append(res)
        return results

    def _pack_fast(self, crop: int, images, cam_dicts):
        """Host packing for the fast_io path: YCbCr canvases and K-channel
        f16 CAM stacks at the walk grid (the host does the reference's
        window downsample with PIL F-mode bilinear, the device resize's
        half-pixel convention; the span ``cam_pack``).  Returns (y, c,
        transposed, cam_vals, cam_idx, sizes)."""
        from PIL import Image

        from muscle_tpu_torch.data.tta import pack_canvas_ycbcr

        b = len(images)
        grid = crop // self.stride
        # the group's largest CAM dict sets the class budget: never a dropped class
        k = max(self.max_classes, max((len(cd) for cd in cam_dicts), default=1))
        y, c, sizes, transposed = pack_canvas_ycbcr(images, [str(i) for i in range(b)], crop,
                                                    tight=False)
        cam_vals = np.zeros((b, k, grid, grid), np.float16)
        cam_idx = np.full((b, k), 20, np.int64)  # pad -> dropped channel
        with span("cam_pack", images=b):
            for i, cd in enumerate(cam_dicts):
                h, w = sizes[i]
                eh = (h - 1) // self.stride + 1
                ew = (w - 1) // self.stride + 1
                for j, (cls, v) in enumerate(sorted(cd.items())):
                    small = Image.fromarray(np.ascontiguousarray(v, np.float32), "F").resize(
                        (ew, eh), Image.BILINEAR)
                    cam_vals[i, j, :eh, :ew] = np.asarray(small, np.float16)
                    cam_idx[i, j] = cls
        return y, c, transposed, cam_vals, cam_idx, sizes.astype(np.int64)

    def bench_device_exec(self, images, cam_dicts):
        """A zero-argument closure for device-only timing (the JAX
        refiner's ``bench_device_exec``): the fast_io host packing and the
        upload once, here; each call re-enqueues the edge forward, the walk
        and the tail (``_refine_fast``) on the resident tensors and returns
        the buffer the download would fetch, without downloading or
        synchronizing.  Needs ``fast_io`` and a batch of one size bucket."""
        if not self.fast_io:
            raise ValueError("bench_device_exec requires fast_io")
        crops = {self._crop_for(h, w) for w, h in map(T.image_size, images)}
        if len(crops) != 1:
            raise ValueError(f"bench_device_exec needs a batch of one size bucket, got {crops}")
        crop = crops.pop()
        args = [self._put(a) for a in self._pack_fast(crop, images, cam_dicts)]
        labels = self.output == "labels"
        return lambda: self._refine_fast(crop, *args, labels=labels)

    def to_png_labels(self, scores_hwc: np.ndarray) -> np.ndarray:
        if scores_hwc.ndim == 2:  # output='labels': already argmaxed on the device
            return scores_hwc
        return np.argmax(scores_hwc, axis=-1).astype(np.uint8)
