"""Batched multi-scale + flip CAM generation (port of
``muscle_tpu/inference/cam.py``).

Each scale's (orig, flip) pairs run as one padded-canvas batch; the
model's CAM/SGC maps are resized back to the original image size on the
device (un-flip fused into the resize) and summed into per-image
accumulators that stay on the device across scales, updated in place.

Fusion follows the reference's infer_mcl: elementwise sum over versions,
clip negatives, per-class min-max normalisation (with the pre-normalisation
zeroing of sub-min values), sigmoid of the mean score.

Three modes:

* ``run_batch_exact``: images grouped by shape and run at their exact
  sizes (no canvas), the reference's per-image forwards batched;
* ``run_batch`` with ``device_tta=False``: host PIL resize into per-scale
  canvases, one upload per scale;
* ``run_batch``/``run_batch_async``/``run_stream`` with ``device_tta=True``
  (default): one uint8 upload per image, the multi-scale bicubic resize,
  normalisation and flip on the device, and a download of the labelled
  classes only.

``mesh`` (``parallel.make_mesh``), as the JAX engines take it: every rank
passes the same global batch and gets the whole batch's records back.
Where the mesh's data rows divide the batch each row runs its share and
the records are gathered over the data axis; where they do not every rank
runs the whole batch, as the JAX engines replicate it
(``parallel.data_share``).  ``shard_spatial`` (the device path only) with
``make_mesh(model_axis=k)``: the k ranks of a model group run their data
row's share together.  Each builds the same scaled pairs from it, takes
its stripe of the canvas into the model (``parallel/spatial.py``), and
gets the whole maps back; the fusion and download then run on every rank
of the group alike.
"""

from __future__ import annotations

import numpy as np
import torch

from muscle_tpu_torch.core.resize import (
    composed_cam_resize_weights,
    dynamic_cubic_resize_weights,
    dynamic_window_resize,
    resize_bilinear,
)
from muscle_tpu_torch.data import transforms as T
from muscle_tpu_torch.data.tta import group_by_shape, msf_batch, scaled_size
from muscle_tpu_torch.inference.upload import start_download, to_device
from muscle_tpu_torch.models.efficientnet import placement_offset
from muscle_tpu_torch.parallel.mesh import data_share, gather_rows
from muscle_tpu_torch.parallel.spatial import Stripes

# stride-2 convs between the input and the CAM-mode stride-16 maps (stem +
# stages 2-4): the ladder depth for placement_offset
N_STRIDED_ENC = 4
# the engines' model dtypes (the JAX package's compute_dtype)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
# model axes whose stripes of every canvas (a multiple of 64 rows) are even
# and at least 4 rows tall, so the stem halves them (parallel/spatial.py)
SPATIAL_AXES = (2, 4, 8, 16)


def spatial_stripes(mesh, shard_spatial: bool):
    """The engines' ``shard_spatial`` on ``mesh``, as the JAX engines take
    them: the ``Stripes`` of this rank's model group, or None without
    ``shard_spatial``.  Raises ValueError for shard_spatial without a mesh
    or on a model axis of 1 (the JAX engines' errors) or one whose stripes
    would not split every canvas."""
    if not shard_spatial:
        return None
    if mesh is None:
        raise ValueError("shard_spatial requires a mesh")
    k = mesh.shape.get("model", 1)
    if k < 2:
        raise ValueError("shard_spatial needs make_mesh(model_axis>1)")
    if k not in SPATIAL_AXES:
        raise ValueError(f"shard_spatial over {k} ranks: the stripes of a canvas of 64 m rows "
                         f"halve through the stem for a model axis in {SPATIAL_AXES} only")
    return Stripes(mesh.model_group)


def share_batch(mesh, batch: tuple) -> tuple[tuple, bool]:
    """This rank's share of a global batch (images, names, ...; parts may
    be None) under ``mesh``'s data axis, and whether the ranks' records are
    gathered after it (``parallel.data_share``)."""
    rows, gather = data_share(mesh, len(batch[0]))
    return tuple(None if part is None else part[rows] for part in batch), gather


def gather_batch(mesh, records: list, gather: bool) -> list:
    """The whole batch's records from every data row's share, in order
    (``records`` itself where the batch was not split)."""
    return gather_rows(records, mesh.data_group) if gather else records


def _scaled_np(orig_sizes, scale: float) -> np.ndarray:
    """Scaled (h, w) with the device's arithmetic: f32 product, round half
    to even."""
    return np.round(np.asarray(orig_sizes, np.float32) * np.float32(scale)).astype(np.int32)


def _batch_canvas(scale: float, orig_sizes, max_side: int,
                  n_strided: int = N_STRIDED_ENC) -> tuple[int, int]:
    """Per-batch canvas: the batch's max scaled (h, w) plus its placement
    offset, bucketed to multiples of 64.  Orientation-homogeneous batches
    get a rectangular canvas and skip the square canvas's padding."""
    scaled = _scaled_np(orig_sizes, scale)
    off = placement_offset(scaled, n_strided)
    sh = int(np.max(scaled[:, 0] + off[:, 0]))
    sw = int(np.max(scaled[:, 1] + off[:, 1]))
    return -(-sh // 64) * 64, -(-sw // 64) * 64


def _valid(rows: int, cols: int, hw: torch.Tensor) -> torch.Tensor:
    """(B, rows, cols, 1) indicator of the top-left (h, w) of each image."""
    r = torch.arange(rows, device=hw.device)[None, :, None]
    c = torch.arange(cols, device=hw.device)[None, None, :]
    return ((r < hw[:, 0, None, None]) & (c < hw[:, 1, None, None]))[..., None]


def _minmax_norm(m: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-class min-max normalisation over the valid region of (B, H, W, K)
    maps, with the reference's zeroing of sub-min values."""
    fg = torch.where(m < 0, torch.zeros_like(m), m)
    big = torch.where(valid, fg, torch.full_like(fg, -torch.inf))
    small = torch.where(valid, fg, torch.full_like(fg, torch.inf))
    mx = torch.amax(big, dim=(1, 2), keepdim=True)
    mn = torch.amin(small, dim=(1, 2), keepdim=True)
    fg = torch.where(fg < mn + 1e-6, torch.zeros_like(fg), fg)
    return (fg - mn - 1e-6) / (mx - mn + 1e-6) * valid


def scaled_pairs(images: torch.Tensor, orig_sizes: torch.Tensor, scale: float,
                 canvas_hw: tuple[int, int], mean: torch.Tensor, std: torch.Tensor,
                 n_strided: int):
    """One TTA scale of a device batch: uint8 (or [0, 255] float) originals
    (B, S, S, 3) with sizes (B, 2) -> normalised bicubic-scaled (orig, flip)
    images interleaved in a (2B, ch, cw, 3) canvas at their placement
    offsets.  Returns (scaled sizes, offsets, images)."""
    ch, cw = canvas_hw
    in_side = images.shape[1]
    scaled = torch.round(orig_sizes.to(torch.float32) * scale).to(torch.int32)
    off = placement_offset(scaled, n_strided)
    x = (images.to(torch.float32) / 255.0 - mean) / std
    wh = dynamic_cubic_resize_weights(orig_sizes[:, 0], scaled[:, 0], in_side, ch,
                                      dst_off=off[:, 0])
    ww = dynamic_cubic_resize_weights(orig_sizes[:, 1], scaled[:, 1], in_side, cw,
                                      dst_off=off[:, 1])
    wwf = dynamic_cubic_resize_weights(orig_sizes[:, 1], scaled[:, 1], in_side, cw,
                                       flip=True, dst_off=off[:, 1])
    a = torch.einsum("bIy,byxc->bIxc", wh, x)
    pairs = torch.stack([torch.einsum("bJx,bIxc->bIJc", ww, a),
                         torch.einsum("bJx,bIxc->bIJc", wwf, a)], dim=1)
    return scaled, off, pairs.reshape(-1, ch, cw, 3)


def _resize_pairs(wh, ww, wwf, pairs):
    """Resize (B, 2, h, w, K) orig/flip maps with per-image (B, H, h) and
    (B, W, w) weights (``wwf`` un-flips) and sum the two."""
    def one(m, wx):
        a = torch.einsum("bIy,byxk->bIxk", wh, m)
        return torch.einsum("bJx,bIxk->bIJk", wx, a)

    return one(pairs[:, 0], ww) + one(pairs[:, 1], wwf)


class CamTTAEngine:
    """Runs MuSCLe 'cam' TTA over batches of images (PIL images or HWC
    uint8 arrays).

    Args:
      model: MuSCLe (mode='enc'); moved to ``device`` and put in eval mode.
      scales: TTA scales (reference default [0.5, 1, 1.5, 2]).
      out_side: canvas side of the fused output maps (>= max image side).
      max_side: dataset max long side (VOC: 500).
      compute_dtype: torch.float32 or torch.bfloat16: the model runs in it
        (the images cast at its input, ``models/layers.py``) and its
        outputs are cast to float32 straight after it; resizes back,
        fusion and accumulation stay float32.
      lowres: resize the stride-16 maps with the reference's two-stage
        chain composed into one per-axis matrix (exact); False materialises
        the input-size maps, for cross-checks.
      device_tta: one uint8 upload per image, multi-scale resize on the
        device, download of the labelled classes only.
      max_classes: per-image class budget of that download.
      return_cam: also return the raw-CAM dicts.
      accum_stride: device_tta only.  N > 1 accumulates on an out_side/N
        grid and upsamples to the original size on the host after the
        download.
      download_dtype: 'float16' or 'uint8' (device_tta only).
      tight_upload: device_tta only: upload a (B, short, out_side) canvas
        with portrait images transposed.
      upload_mode: 'rgb' or 'ycbcr420' (device_tta only): 4:2:0 upload,
        reconstructed to RGB on the device.
      mesh: ``parallel.make_mesh()``: every rank passes the same global
        batch; the engine splits it over the data axis and every rank
        returns the whole batch's records (module docstring).
      shard_spatial: with ``make_mesh(model_axis=k)``, also split each
        canvas's height over this rank's model group (``spatial_stripes``
        for what raises).
      device: where the model runs: 'cuda' (default) or 'cpu'.
    """

    def __init__(self, model, scales=(0.5, 1.0, 1.5, 2.0), num_classes: int = 21,
                 out_side: int = 512, max_side: int = 500, compute_dtype=torch.float32,
                 lowres: bool = True, device_tta: bool = True, max_classes: int = 8,
                 return_cam: bool = True, accum_stride: int = 1,
                 download_dtype: str = "float16", tight_upload: bool = False,
                 upload_mode: str = "rgb", mesh=None, shard_spatial: bool = False,
                 device: str | torch.device = "cuda"):
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        self.mesh = mesh
        self.stripes = spatial_stripes(mesh, shard_spatial)
        if out_side % accum_stride:
            raise ValueError("accum_stride must divide out_side")
        if download_dtype not in ("float16", "uint8"):
            raise ValueError(f"unsupported download_dtype {download_dtype!r}")
        if upload_mode not in ("rgb", "ycbcr420"):
            raise ValueError(f"unsupported upload_mode {upload_mode!r}")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.compute_dtype = compute_dtype
        self.scales = tuple(scales)
        self.num_classes = num_classes
        self.out_side = out_side
        self.max_side = max_side
        self.lowres = lowres
        self.device_tta = device_tta
        self.max_classes = max_classes
        self.return_cam = return_cam
        self.accum_stride = accum_stride
        self.acc_side = out_side // accum_stride
        self.download_dtype = download_dtype
        self.tight_upload = tight_upload
        self.upload_mode = upload_mode
        self._mean = torch.tensor(T.IMAGENET_MEAN[0, 0], dtype=torch.float32, device=self.device)
        self._std = torch.tensor(T.IMAGENET_STD[0, 0], dtype=torch.float32, device=self.device)

    def _put(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    def _model(self, images: torch.Tensor, **kw):
        """(cams, sgcs, emb, logits) of the model on ``images`` cast to the
        compute dtype, the maps and logits cast back to float32; under
        shard_spatial on this rank's stripe of ``images``, the outputs
        whole."""
        if self.stripes is not None:
            images = self.stripes.take(images)
            kw["stripes"] = self.stripes
        cams, sgcs, emb, logits = self.model(images.to(self.compute_dtype), **kw)
        return cams.float(), sgcs.float(), emb, logits.float()

    def _forward(self, images: torch.Tensor, win: torch.Tensor):
        """Model maps of one scale's (orig, flip) batch: window-exact
        'cam_lowres' (lowres) or masked full-res 'cam'."""
        if self.lowres:
            return self._model(images, mode="cam_lowres",
                               valid_window=win.repeat_interleave(2, dim=0))
        return self._model(images, mode="cam", valid_hw=win[:, 2:].repeat_interleave(2, dim=0))

    def _map_resizers(self, maps_hw, sizes, dst, canvas_hw, grid: int):
        """Per-image (rows, cols, flipped cols) weights taking the model's
        maps of each image back to ``dst`` (B, 2) on a grid x grid canvas,
        or None for the lowres=False gather path."""
        if not self.lowres:
            return None
        ch, cw = canvas_hw
        feat_stride = ch // maps_hw[0]
        map_sz = sizes // feat_stride  # the static-pad floor chain
        wh = composed_cam_resize_weights(map_sz[:, 0], sizes[:, 0], dst[:, 0],
                                         maps_hw[0], ch, grid)
        ww = composed_cam_resize_weights(map_sz[:, 1], sizes[:, 1], dst[:, 1],
                                         maps_hw[1], cw, grid)
        wwf = composed_cam_resize_weights(map_sz[:, 1], sizes[:, 1], dst[:, 1],
                                          maps_hw[1], cw, grid, flip=True)
        return wh, ww, wwf

    def _resize_back(self, resizers, pairs, sizes, dst, grid: int):
        if resizers is not None:
            return _resize_pairs(*resizers, pairs)
        box = torch.cat([torch.zeros_like(sizes), sizes], dim=-1)
        return sum(
            dynamic_window_resize(pairs[:, i], box, (grid, grid), dst_hw=dst,
                                  align_corners=False, flip_x=bool(i))
            for i in (0, 1)
        )

    # ---- host-prep path (device_tta=False) --------------------------------

    def _host_scale(self, images, win, orig_sizes, canvas_hw, accs):
        """One scale of the host-prep path: maps of all classes resized to
        the out_side canvas and summed into ``accs`` in place."""
        sizes = win[:, 2:]
        cams, sgcs, _, logits = self._forward(images, win)
        b = sizes.shape[0]
        rs = self._map_resizers(cams.shape[1:3], sizes, orig_sizes, canvas_hw, self.out_side)
        valid = _valid(self.out_side, self.out_side, orig_sizes)
        for name, maps in (("cam", cams), ("sgc", sgcs)):
            pairs = maps.reshape(b, 2, *maps.shape[1:])
            accs[name] += self._resize_back(rs, pairs, sizes, orig_sizes, self.out_side) * valid
        accs["logits"] += logits.reshape(b, 2, -1).sum(dim=1)

    def _fuse(self, accs, orig_sizes, n_versions: float):
        valid = _valid(self.out_side, self.out_side, orig_sizes)
        cam = _minmax_norm(accs["cam"][..., 1:], valid)
        sgc = _minmax_norm(accs["sgc"][..., 1:], valid)
        score = torch.sigmoid(accs["logits"][:, 1:] / n_versions)
        return cam.to(torch.float16), sgc.to(torch.float16), score

    def run_batch(self, images, names, labels) -> list[dict]:
        """Per-image dicts: name, cam/sgc ({cls: (H, W) float16}, labelled
        classes only) and score (20,): the reference's npy contract."""
        (images, names, labels), gather = share_batch(self.mesh, (images, names, labels))
        if self.device_tta:
            return gather_batch(self.mesh, self._run_batch_device(images, names, labels), gather)
        return gather_batch(self.mesh, self._run_host(images, names, labels), gather)

    def _run_host(self, images, names, labels) -> list[dict]:
        self._no_stripes("the host-prep path (device_tta=False)")
        b = len(images)
        z = torch.zeros((b, self.out_side, self.out_side, self.num_classes), device=self.device)
        accs = {"cam": z, "sgc": z.clone(),
                "logits": torch.zeros((b, self.num_classes), device=self.device)}
        orig_sizes = None
        with torch.inference_mode():
            for s in self.scales:
                scaled = np.asarray(
                    [scaled_size(*T.image_size(img), s)[::-1] for img in images], np.int32)
                off = placement_offset(scaled, N_STRIDED_ENC)
                ch = -(-int(np.max(scaled[:, 0] + off[:, 0])) // 64) * 64
                cw = -(-int(np.max(scaled[:, 1] + off[:, 1])) // 64) * 64
                mb = msf_batch(images, names, s, canvas=(ch, cw), offsets=off)
                win = self._put(np.concatenate([off, mb.sizes], axis=-1))
                orig_sizes = self._put(mb.orig_sizes)
                self._host_scale(self._put(mb.images), win, orig_sizes, (ch, cw), accs)
            cam, sgc, score = (t.cpu().numpy() for t in
                               self._fuse(accs, orig_sizes, float(2 * len(self.scales))))
        sizes = orig_sizes.cpu().numpy()
        out = []
        for i, name in enumerate(names):
            hh, ww = sizes[i]
            keep = np.nonzero(np.asarray(labels[i]) > 1e-5)[0]
            out.append({
                "name": name,
                "cam": {k: cam[i, :hh, :ww, k] for k in keep},
                "sgc": {k: sgc[i, :hh, :ww, k] for k in keep},
                "score": score[i],
            })
        return out

    def _no_stripes(self, path: str) -> None:
        if self.stripes is not None:
            raise ValueError(f"{path} has no device canvas to split: shard_spatial runs the "
                             "device path (device_tta=True, run_batch / run_stream)")

    # ---- exact mode --------------------------------------------------------

    def run_batch_exact(self, images, names, labels) -> list[dict]:
        """Parity TTA mode: images grouped by identical shape and run at
        their exact sizes (no canvas padding), the reference's per-image
        forwards batched."""
        self._no_stripes("run_batch_exact")
        (images, names, labels), gather = share_batch(self.mesh, (images, names, labels))
        results: dict[int, dict] = {}
        nv = float(2 * len(self.scales))
        with torch.inference_mode():
            for (w, h), idxs in group_by_shape(images, names).items():
                g = len(idxs)
                cam_sum = torch.zeros((g, h, w, self.num_classes), device=self.device)
                sgc_sum = torch.zeros_like(cam_sum)
                logits_sum = torch.zeros((g, self.num_classes), device=self.device)
                for s in self.scales:
                    tw, th = scaled_size(w, h, s)
                    batch = np.empty((2 * g, th, tw, 3), np.float32)
                    for j, i in enumerate(idxs):
                        img = T.to_pil(images[i]).resize((tw, th), resample=T.BICUBIC)
                        arr = T.color_norm(np.asarray(img))
                        batch[2 * j] = arr
                        batch[2 * j + 1] = arr[:, ::-1]
                    cams, sgcs, _, logits = self._model(self._put(batch), mode="cam")
                    for acc, maps in ((cam_sum, cams), (sgc_sum, sgcs)):
                        maps = resize_bilinear(maps, (h, w), align_corners=False)
                        maps = maps.reshape(g, 2, *maps.shape[1:])
                        acc += maps[:, 0] + maps[:, 1].flip(2)
                    logits_sum += logits.reshape(g, 2, -1).sum(dim=1)
                every = torch.ones((g, h, w, 1), dtype=torch.bool, device=self.device)
                cam = _minmax_norm(cam_sum[..., 1:], every).cpu().numpy()
                sgc = _minmax_norm(sgc_sum[..., 1:], every).cpu().numpy()
                score = torch.sigmoid(logits_sum[:, 1:] / nv).cpu().numpy()
                for j, i in enumerate(idxs):
                    keep = np.nonzero(np.asarray(labels[i]) > 1e-5)[0]
                    results[i] = {
                        "name": names[i],
                        "cam": {int(k): cam[j, :, :, k] for k in keep},
                        "sgc": {int(k): sgc[j, :, :, k] for k in keep},
                        "score": score[j],
                    }
        return gather_batch(self.mesh, [results[i] for i in range(len(images))], gather)

    # ---- device TTA path -----------------------------------------------------

    def _device_scale(self, scale: float, images, orig_sizes, class_idx, canvas_hw, accs):
        """One scale on the device: uint8 (or [0, 255] float) originals ->
        bicubic-scaled normalised (orig, flip) pairs -> model -> gather of
        the labelled classes -> resize onto the accumulation grid -> sum
        into ``accs`` in place."""
        scaled, off, pairs = scaled_pairs(images, orig_sizes, scale, canvas_hw,
                                          self._mean, self._std, N_STRIDED_ENC)
        win = torch.cat([off, scaled], dim=-1)
        cams, sgcs, _, logits = self._forward(pairs, win)

        b = scaled.shape[0]
        stride = self.accum_stride
        dst = (orig_sizes + stride - 1) // stride
        k = class_idx.shape[1]
        rs = self._map_resizers(cams.shape[1:3], scaled, dst, canvas_hw, self.acc_side)
        valid = _valid(self.acc_side, self.acc_side, dst)
        for name, maps in (("cam", cams), ("sgc", sgcs)):
            if name not in accs:
                continue
            pairs = maps.reshape(b, 2, *maps.shape[1:])[..., 1:]
            idx = class_idx[:, None, None, None, :].expand(*pairs.shape[:4], k)
            pairs = torch.gather(pairs, -1, idx.to(torch.int64))
            accs[name] += self._resize_back(rs, pairs, scaled, dst, self.acc_side) * valid
        accs["logits"] += logits.reshape(b, 2, -1).sum(dim=1)

    def _fuse_gathered(self, accs, orig_sizes, n_versions: float) -> torch.Tensor:
        """Fusion over the gathered K-channel accumulators, packed into ONE
        (B, bytes) uint8 tensor (maps' bytes, then the f32 scores') so each
        batch downloads in one copy."""
        dst = (orig_sizes + self.accum_stride - 1) // self.accum_stride
        valid = _valid(self.acc_side, self.acc_side, dst)

        def norm(m):
            out = _minmax_norm(m, valid)
            if self.download_dtype == "uint8":
                return torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)
            return out.to(torch.float16)

        def tobytes(t):
            return t.reshape(t.shape[0], -1).view(torch.uint8)

        score = torch.sigmoid(accs["logits"][:, 1:] / n_versions)
        parts = [tobytes(norm(accs["sgc"])), tobytes(score.to(torch.float32).contiguous())]
        if self.return_cam:
            parts.insert(0, tobytes(norm(accs["cam"])))
        return torch.cat(parts, dim=1)

    def _unpack_fused(self, buf: np.ndarray, k: int):
        """Host-side split of the packed buffer into (cam?, sgc, score)."""
        b = buf.shape[0]
        acc = self.acc_side
        map_dt = np.uint8 if self.download_dtype == "uint8" else np.float16
        nbytes = acc * acc * k * np.dtype(map_dt).itemsize

        def view(sl, dt, shape):
            return np.ascontiguousarray(sl).view(dt).reshape(shape)

        off = 0
        cam = None
        if self.return_cam:
            cam = view(buf[:, :nbytes], map_dt, (b, acc, acc, k))
            off = nbytes
        sgc = view(buf[:, off: off + nbytes], map_dt, (b, acc, acc, k))
        score = view(buf[:, off + nbytes:], np.float32, (b, self.num_classes - 1))
        return cam, sgc, score

    def _host_prep(self, images, names, labels) -> dict:
        """Host stage of the device path: canvas packing and the class
        budget.  CPU only, safe on a prefetch thread."""
        from muscle_tpu_torch.data.tta import pack_canvas, pack_canvas_ycbcr

        b = len(images)
        if self.upload_mode == "ycbcr420":
            y, c, orig_sizes, transposed = pack_canvas_ycbcr(
                images, names, self.out_side, self.tight_upload)
            upload = ("ycbcr420", y, c, transposed)
        elif self.tight_upload:
            canvas, orig_sizes, transposed = pack_canvas(images, names, self.out_side, True)
            upload = ("tight", canvas, transposed)
        else:
            canvas, orig_sizes, _ = pack_canvas(images, names, self.out_side, False)
            upload = ("rgb", canvas)
        k = self.max_classes
        class_idx = np.zeros((b, k), np.int32)
        counts = np.zeros(b, np.int32)
        for i, lab in enumerate(labels):
            keep = np.nonzero(np.asarray(lab) > 1e-5)[0][:k]
            class_idx[i, : len(keep)] = keep
            counts[i] = len(keep)
        return {"b": b, "names": list(names), "upload": upload, "orig_sizes": orig_sizes,
                "class_idx": class_idx, "counts": counts}

    def _upload(self, prep: dict) -> dict:
        """A prepped batch's upload arrays, sizes and class indices on the
        device, and its host sizes (the canvases)."""
        kind, *arrays = prep["upload"]
        return {"kind": kind, "arrays": [self._put(a) for a in arrays],
                "sizes": self._put(prep["orig_sizes"]), "idx": self._put(prep["class_idx"]),
                "orig_sizes": prep["orig_sizes"]}

    def _device_pipeline(self, up: dict) -> torch.Tensor:
        """Unpack, every TTA scale and the fusion of one uploaded batch
        (``_upload``), enqueued on the device; returns the packed result
        tensor."""
        from muscle_tpu_torch.inference.upload import square_unpack_fn, ycbcr420_unpack_fn

        kind, args, orig_sizes = up["kind"], up["arrays"], up["orig_sizes"]
        if kind == "ycbcr420":
            images = ycbcr420_unpack_fn(self.out_side)(*args)
        elif kind == "tight":
            images = square_unpack_fn(self.out_side)(*args)
        else:
            images = args[0]
        b = len(orig_sizes)
        acc, k = self.acc_side, self.max_classes
        accs = {"sgc": torch.zeros((b, acc, acc, k), device=self.device),
                "logits": torch.zeros((b, self.num_classes), device=self.device)}
        if self.return_cam:
            accs["cam"] = torch.zeros((b, acc, acc, k), device=self.device)
        sizes, idx = up["sizes"], up["idx"]
        for s in self.scales:
            self._device_scale(s, images, sizes, idx,
                               _batch_canvas(s, orig_sizes, self.max_side), accs)
        return self._fuse_gathered(accs, sizes, float(2 * len(self.scales)))

    def _run_batch_device(self, images, names, labels, defer: bool = False):
        if len(images) == 0:
            return (lambda: []) if defer else []
        finalize = self._dispatch_prepped(self._host_prep(images, names, labels))
        return finalize if defer else finalize()

    def run_batch_async(self, images, names, labels):
        """Enqueue a device_tta batch; returns a ``finalize() -> list[dict]``
        closure that waits for it.  Enqueue the next batch before
        finalizing this one to overlap its download with the next
        compute."""
        if not self.device_tta:
            raise ValueError("run_batch_async requires device_tta")
        (images, names, labels), gather = share_batch(self.mesh, (images, names, labels))
        finalize = self._run_batch_device(images, names, labels, defer=True)
        return lambda: gather_batch(self.mesh, finalize(), gather)

    def bench_device_exec(self, images, names, labels):
        """A zero-argument closure for device-only timing (the JAX engine's
        ``bench_device_exec``): the host prep and the upload run once, here;
        each call re-enqueues the whole device pipeline (every TTA scale
        and the fusion) on the resident tensors and returns the packed
        result buffer on the device, with no download and no synchronize
        (time chained calls with CUDA events).  Under a mesh on this rank's
        share of the batch.  The device_tta path only."""
        if not self.device_tta:
            raise ValueError("bench_device_exec requires device_tta (the fused device pipeline)")
        (images, names, labels), _ = share_batch(self.mesh, (images, names, labels))
        prep = self._host_prep(images, names, labels)
        with torch.inference_mode():
            up = self._upload(prep)

        def run() -> torch.Tensor:
            with torch.inference_mode():
                return self._device_pipeline(up)

        return run

    def _dispatch_prepped(self, prep: dict):
        with torch.inference_mode():
            fused = self._device_pipeline(self._upload(prep))
        return self._make_finalize(start_download(fused), prep["names"], prep["orig_sizes"],
                                   prep["class_idx"], prep["counts"], self.max_classes)

    def _make_finalize(self, fetch, names, orig_sizes, class_idx, counts, k):
        stride = self.accum_stride

        def expand(m: np.ndarray, hh: int, ww: int) -> np.ndarray:
            """One fused channel sliced to its valid region, dequantised,
            and (accum_stride > 1) upsampled to the original size on the
            host (PIL 'F' bilinear, half-pixel)."""
            if self.download_dtype == "uint8":
                m = m.astype(np.float32) / 255.0
            if stride == 1:
                return m[:hh, :ww].astype(np.float16)
            from PIL import Image

            ah, aw = -(-hh // stride), -(-ww // stride)
            img = Image.fromarray(np.ascontiguousarray(m[:ah, :aw], np.float32), "F")
            return np.asarray(img.resize((ww, hh), Image.BILINEAR), np.float32).astype(np.float16)

        def finalize() -> list[dict]:
            cam, sgc, score = self._unpack_fused(fetch(), k)
            out = []
            for i, name in enumerate(names):
                hh, ww = orig_sizes[i]
                ks = class_idx[i, : counts[i]]
                rec = {
                    "name": name,
                    "sgc": {int(c): expand(sgc[i, ..., j], hh, ww) for j, c in enumerate(ks)},
                    "score": score[i],
                }
                if cam is not None:
                    rec["cam"] = {int(c): expand(cam[i, ..., j], hh, ww)
                                  for j, c in enumerate(ks)}
                out.append(rec)
            return out

        return finalize

    def run_stream(self, batches, prep_ahead: int = 2, finalize_ahead: int = 2):
        """Overlapped pipeline over an iterable of ``(images, names,
        labels)`` batches; yields each batch's result list in order.

        Three stages run concurrently: host prep (canvas packing) on a
        thread, dispatch on the caller's thread (enqueues device work), and
        finalize (blocking download + host upsample) on a thread.  Under a
        mesh the records are gathered on the caller's thread, which issues
        every collective in the same order on every rank."""
        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        prep_q: queue.Queue = queue.Queue(maxsize=max(1, prep_ahead))
        sentinel = object()

        def produce():
            try:
                for batch in batches:
                    mine, gather = share_batch(self.mesh, tuple(batch))
                    prep_q.put((self._host_prep(*mine), gather))
            except BaseException as e:  # re-raised in the consumer
                prep_q.put(e)
                return
            prep_q.put(sentinel)

        threading.Thread(target=produce, daemon=True).start()
        with ThreadPoolExecutor(max_workers=1) as fin_ex:
            pending: list = []
            while True:
                item = prep_q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                prep, gather = item
                pending.append((fin_ex.submit(self._dispatch_prepped(prep)), gather))
                if len(pending) > finalize_ahead:
                    fut, gather = pending.pop(0)
                    yield gather_batch(self.mesh, fut.result(), gather)
            for fut, gather in pending:
                yield gather_batch(self.mesh, fut.result(), gather)
