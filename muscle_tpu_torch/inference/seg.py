"""Batched multi-scale + flip segmentation TTA (port of
``muscle_tpu/inference/seg.py``).

The batched-canvas design of ``CamTTAEngine`` with the reference's seg
fusion: a softmax per version, each version resized back to the original
image size (un-flip fused into the resize), and the MEAN over the 2 x
|scales| versions (the CAM fusion sums; the seg fusion averages).  The
caller applies the optional class gating and dense CRF and the argmax,
or (``output='labels'``) the argmax runs on the device.

Two input paths:

* ``device_tta=True`` (default): one uint8 upload per image, the
  multi-scale bicubic resize, normalisation and flip on the device;
* ``device_tta=False``: PIL-prepped canvases per scale on the host, for
  parity checks.

``lowres`` and ``window_exact`` are the JAX engine's parity switches (the
input-size 'seg' logits; the top-left canvas without window masks), on
every path.

``mesh`` and ``shard_spatial`` as ``CamTTAEngine``'s: every rank passes the
same global batch and gets the whole batch's records back, each data row
running its share; under ``shard_spatial`` each rank of a model group runs
its stripe of every canvas and gets the whole logits back.
"""

from __future__ import annotations

import numpy as np
import torch

from muscle_tpu_torch.core.resize import dynamic_window_resize
from muscle_tpu_torch.data import transforms as T
from muscle_tpu_torch.data.tta import msf_batch, scaled_size
from muscle_tpu_torch.inference import stream
from muscle_tpu_torch.inference.cam import (
    COMPUTE_DTYPES,
    _batch_canvas,
    _valid,
    gather_batch,
    scaled_pairs,
    share_batch,
    spatial_stripes,
)
from muscle_tpu_torch.inference.upload import start_download, to_device
from muscle_tpu_torch.models.efficientnet import advance_window, placement_offset

# stride-2 convs of the dec backbone ladder (last_pooling=True: stride 32),
# the ladder depth for placement_offset
N_STRIDED_DEC = 5


def _host_scaled(hw: np.ndarray, scale: float) -> np.ndarray:
    """The host path's scaled (h, w) of (B, 2) sizes (``scaled_size``)."""
    return np.asarray([scaled_size(int(w), int(h), scale)[::-1] for h, w in hw], np.int32)


def _host_canvas(scaled: np.ndarray, off: np.ndarray) -> tuple[int, int]:
    """The host path's canvas: the batch's max placed extent, rounded up
    to multiples of 64."""
    return (-(-int(np.max(scaled[:, 0] + off[:, 0])) // 64) * 64,
            -(-int(np.max(scaled[:, 1] + off[:, 1])) // 64) * 64)


class SegTTAEngine:
    """Runs MuSCLe seg TTA over batches of images (PIL images or HWC uint8
    arrays).

    Args:
      model: MuSCLe (mode='dec'); moved to ``device`` and put in eval mode.
      scales: TTA scales (the reference's six).
      out_side: canvas side of the fused output (>= max image side).
      max_side: dataset max long side (VOC: 500).
      compute_dtype: torch.float32 or torch.bfloat16: the model runs in it
        and its logits are cast to float32 straight after it; the
        upsample, softmax and accumulation stay float32.
      lowres: take the model's stride-8 logits and upsample them in the
        engine (exact: the 1x1 head commutes with the bilinear upsample),
        never materialising the input-size 256-channel decoder feature;
        False takes the model's input-size 'seg' logits, for cross-checks.
      device_tta: see the module docstring.
      accum_stride: 1 accumulates the mean probabilities at the full
        original resolution; N > 1 on an out_side/N grid, upsampled to the
        original size on the host (PIL bilinear) after the download.
      download_dtype: 'float32' or 'float16' (probabilities output).
      tight_upload: device_tta only: a (B, short, out_side) upload canvas
        with portrait images transposed (exact).
      upload_mode: 'ycbcr420' (4:2:0 upload, device_tta only) or 'rgb'.
      output: 'probs' returns the mean TTA softmax per image; 'labels'
        (device_tta only) resizes to the original size and takes the
        argmax on the device and downloads one uint8 map per image (argmax
        commutes with the mean; class gating needs 'probs').
      mesh: ``parallel.make_mesh()``: every rank passes the same global
        batch; the engine splits it over the data axis and every rank
        returns the whole batch's records (``CamTTAEngine``).
      shard_spatial: with ``make_mesh(model_axis=k)``, also split each
        canvas's height over this rank's model group
        (``inference.cam.spatial_stripes`` for what raises).
      window_exact: place each image at its placement offset and run the
        model with per-image valid windows, so the padded canvas computes
        each image's unpadded forward; False puts every image at the
        canvas origin and runs the model without windows (the SE means and
        the BiFPN then see the canvas's zero padding).
      device: where the model runs: 'cuda' (default) or 'cpu'.
    """

    def __init__(self, model, scales=(0.5, 0.75, 1.0, 1.25, 1.5, 1.75), num_classes: int = 21,
                 out_side: int = 512, max_side: int = 500, compute_dtype=torch.float32,
                 device_tta: bool = True, accum_stride: int = 1,
                 download_dtype: str = "float32", tight_upload: bool = True,
                 upload_mode: str = "ycbcr420", mesh=None, shard_spatial: bool = False,
                 output: str = "probs", lowres: bool = True, window_exact: bool = True,
                 device: str | torch.device = "cuda"):
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        self.mesh = mesh
        self.stripes = spatial_stripes(mesh, shard_spatial)
        if out_side % accum_stride:
            raise ValueError("accum_stride must divide out_side")
        if download_dtype not in ("float32", "float16"):
            raise ValueError(f"unsupported download_dtype {download_dtype!r}")
        if upload_mode not in ("rgb", "ycbcr420"):
            raise ValueError(f"unsupported upload_mode {upload_mode!r}")
        if output not in ("probs", "labels"):
            raise ValueError(f"unsupported output {output!r}")
        if output == "labels" and not device_tta:
            raise ValueError("output='labels' requires device_tta=True "
                             "(the argmax runs on the device)")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.compute_dtype = compute_dtype
        self.scales = tuple(scales)
        self.num_classes = num_classes
        self.out_side = out_side
        self.max_side = max_side
        self.device_tta = device_tta
        self.accum_stride = accum_stride
        self.acc_side = out_side // accum_stride
        self.download_dtype = download_dtype
        self.tight_upload = tight_upload
        self.upload_mode = upload_mode
        self.output = output
        self.lowres = lowres
        self.window_exact = window_exact
        self._mean = torch.tensor(T.IMAGENET_MEAN[0, 0], dtype=torch.float32, device=self.device)
        self._std = torch.tensor(T.IMAGENET_STD[0, 0], dtype=torch.float32, device=self.device)

    def _put(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    def bench_device_exec(self, images, names):
        """A zero-argument closure for device-only timing, as
        ``CamTTAEngine.bench_device_exec``: the host prep and the upload
        once, each call re-enqueues the device pipeline (every TTA scale
        and the finish) on the resident tensors and returns the buffer the
        download would fetch, without downloading or synchronizing.  The
        device_tta path only."""
        if not self.device_tta:
            raise ValueError("bench_device_exec requires device_tta (the fused device pipeline)")
        (images, names), _, canvases = self._share((images, names))
        prep = self._host_prep(images, names, canvases=canvases)
        with torch.inference_mode():
            up = self._upload(prep)

        def run() -> torch.Tensor:
            with torch.inference_mode():
                return self._device_pipeline(up)

        return run

    # ---- one scale -------------------------------------------------------------

    def _scale(self, images: torch.Tensor, off: torch.Tensor, sizes: torch.Tensor,
               orig_sizes: torch.Tensor, canvas_hw: tuple[int, int], acc: torch.Tensor):
        """One scale's (orig, flip) batch ``images`` (2B, ch, cw, 3), placed
        at ``off`` with scaled sizes ``sizes`` (B, 2) -> the forward
        (window-exact: the padded canvas computes each image's unpadded
        forward) -> softmax of the input-size logits -> resized to the
        accumulation grid (un-flipped) and added into ``acc`` (B, acc, acc,
        C) in place."""
        ch, cw = canvas_hw
        win = torch.cat([off, sizes], dim=-1)
        kw = {}
        if self.window_exact:
            kw["valid_window"] = win.repeat_interleave(2, dim=0)
        if self.stripes is not None:  # this rank's stripe in, the whole logits out
            images, kw["stripes"] = self.stripes.take(images), self.stripes
        seg, _ = self.model(images.to(self.compute_dtype),
                            mode="seg_lowres" if self.lowres else "seg", **kw)
        seg = seg.float()
        if self.lowres:
            # stride-8 logits -> input-size logits, the reference's seg_map
            # (exact: the 1x1 head commutes with the bilinear upsample)
            stride = ch // seg.shape[1]
            if self.window_exact:
                boxes = win
                for _ in range(stride.bit_length() - 1):
                    boxes = advance_window(boxes)
            else:  # the whole canvas went through the ladder: ceil, not floor
                boxes = torch.cat([torch.zeros_like(sizes), (sizes + stride - 1) // stride], -1)
            seg = dynamic_window_resize(seg, boxes.repeat_interleave(2, dim=0), (ch, cw),
                                        dst_hw=sizes.repeat_interleave(2, dim=0),
                                        align_corners=True)
        probs = torch.softmax(seg, dim=-1)
        b = sizes.shape[0]
        pairs = probs.reshape(b, 2, *probs.shape[1:])
        box = torch.cat([torch.zeros_like(sizes), sizes], dim=-1)
        dst = (orig_sizes + self.accum_stride - 1) // self.accum_stride
        grid = (self.acc_side, self.acc_side)
        back = sum(dynamic_window_resize(pairs[:, i], box, grid, dst_hw=dst,
                                         align_corners=False, flip_x=bool(i)) for i in (0, 1))
        acc += back * _valid(*grid, dst)

    def _new_acc(self, b: int) -> torch.Tensor:
        return torch.zeros((b, self.acc_side, self.acc_side, self.num_classes),
                           device=self.device)

    def _finish(self, acc: torch.Tensor) -> torch.Tensor:
        mean = acc / float(2 * len(self.scales))
        return mean.to(torch.float16) if self.download_dtype == "float16" else mean

    def _labels_finish(self, acc: torch.Tensor, orig_sizes: torch.Tensor) -> torch.Tensor:
        """Summed probabilities -> resized to each image's original size in
        the (out_side, out_side) canvas (half-pixel, as the host's PIL
        upsample) -> argmax -> uint8.  The argmax ignores the /n of the
        mean."""
        awh = (orig_sizes + self.accum_stride - 1) // self.accum_stride
        box = torch.cat([torch.zeros_like(awh), awh], dim=-1)
        up = dynamic_window_resize(acc, box, (self.out_side, self.out_side), dst_hw=orig_sizes,
                                   align_corners=False)
        return torch.argmax(up, dim=-1).to(torch.uint8)

    # ---- public entry points ---------------------------------------------------

    def run_batch(self, images, names, cls_gates=None) -> list[dict]:
        """output='probs': per image {'name', 'probs' (H, W, C) float32},
        the mean TTA softmax before any CRF (the caller runs either CRF
        backend and the argmax).  output='labels': per image {'name',
        'label' (H, W) uint8}.  cls_gates: optional per-image (C,) gates
        multiplied into the foreground probabilities."""
        (images, names, cls_gates), gather, canvases = self._share((images, names, cls_gates))
        if self.device_tta:
            recs = self._dispatch_prepped(self._host_prep(images, names, cls_gates, canvases))()
        else:
            recs = self._run_host(images, names, cls_gates, canvases)
        return gather_batch(self.mesh, recs, gather)

    def run_batch_async(self, images, names, cls_gates=None):
        """Enqueue a device_tta batch; returns a ``finalize() -> list[dict]``
        closure that waits for it.  Enqueue the next batch before
        finalizing this one to overlap its download with the next
        compute."""
        if not self.device_tta:
            raise ValueError("run_batch_async requires device_tta")
        (images, names, cls_gates), gather, canvases = self._share((images, names, cls_gates))
        finalize = self._dispatch_prepped(self._host_prep(images, names, cls_gates, canvases))
        return lambda: gather_batch(self.mesh, finalize(), gather)

    def _share(self, batch: tuple) -> tuple:
        """This rank's share of a global batch (``share_batch``), whether
        the records are gathered after it, and, where the batch was split
        at window_exact=False, the whole batch's canvas at each scale (else
        None).  Without windows the canvas's padding moves the numbers, so
        every data row runs on the canvases one process would, as JAX's
        engine sizes its canvases before it shards the batch; window-exact
        forwards do not see the canvas, and each row keeps its own."""
        mine, gather = share_batch(self.mesh, batch)
        if not gather or self.window_exact:
            return mine, gather, None
        hw = np.asarray([T.image_size(img)[::-1] for img in batch[0]], np.int32)
        if self.device_tta:
            canvases = [_batch_canvas(s, hw, self.max_side, n_strided=N_STRIDED_DEC)
                        for s in self.scales]
        else:
            canvases = [_host_canvas(_host_scaled(hw, s), np.zeros((1, 2), np.int32))
                        for s in self.scales]
        return mine, gather, canvases

    def _run_host(self, images, names, cls_gates, canvases=None):
        """The host-prep path: PIL-resized canvases per scale (``canvases``:
        the whole batch's, see ``_share``)."""
        if self.stripes is not None:
            raise ValueError("the host-prep path (device_tta=False) has no device canvas to "
                             "split: shard_spatial runs the device path")
        b = len(images)
        acc = self._new_acc(b)
        orig_sizes = None
        with torch.inference_mode():
            for i, s in enumerate(self.scales):
                scaled = _host_scaled(
                    np.asarray([T.image_size(img)[::-1] for img in images], np.int32), s)
                if self.window_exact:
                    off = placement_offset(scaled, N_STRIDED_DEC)
                else:
                    off = np.zeros_like(scaled)
                ch, cw = _host_canvas(scaled, off) if canvases is None else canvases[i]
                mb = msf_batch(images, names, s, canvas=(ch, cw), offsets=off)
                orig_sizes = mb.orig_sizes
                self._scale(self._put(mb.images), self._put(off), self._put(mb.sizes),
                            self._put(orig_sizes), (ch, cw), acc)
            fused = self._finish(acc)
        return self._make_finalize(start_download(fused), names, orig_sizes, cls_gates)()

    def _host_prep(self, images, names, cls_gates=None, canvases=None) -> dict:
        """Host stage of the device path: canvas packing.  CPU only, safe on
        a prefetch thread.  ``canvases``: the whole batch's (``_share``),
        None to size them from this batch."""
        from muscle_tpu_torch.data.tta import pack_canvas, pack_canvas_ycbcr

        if self.output == "labels" and cls_gates is not None:
            raise ValueError("cls_gates are applied to probabilities; use output='probs'")
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
        return {"names": list(names), "upload": upload, "orig_sizes": orig_sizes,
                "cls_gates": cls_gates, "canvases": canvases}

    def _upload(self, prep: dict) -> dict:
        """A prepped batch's upload arrays and sizes on the device, and its
        host sizes (the canvases)."""
        kind, *arrays = prep["upload"]
        return {"kind": kind, "arrays": [self._put(a) for a in arrays],
                "sizes": self._put(prep["orig_sizes"]), "orig_sizes": prep["orig_sizes"],
                "canvases": prep["canvases"]}

    def _device_pipeline(self, up: dict) -> torch.Tensor:
        """Unpack, every TTA scale and the finish of one uploaded batch
        (``_upload``), enqueued on the device; returns the tensor to
        download."""
        from muscle_tpu_torch.inference.upload import square_unpack_fn, ycbcr420_unpack_fn

        kind, args, orig_sizes, sizes = up["kind"], up["arrays"], up["orig_sizes"], up["sizes"]
        if kind == "ycbcr420":
            images = ycbcr420_unpack_fn(self.out_side)(*args)
        elif kind == "tight":
            images = square_unpack_fn(self.out_side)(*args)
        else:
            images = args[0]
        acc = self._new_acc(len(orig_sizes))
        for i, s in enumerate(self.scales):
            canvas = (_batch_canvas(s, orig_sizes, self.max_side, n_strided=N_STRIDED_DEC)
                      if up["canvases"] is None else up["canvases"][i])
            scaled, off, pairs = scaled_pairs(images, sizes, s, canvas, self._mean, self._std,
                                              N_STRIDED_DEC if self.window_exact else None)
            self._scale(pairs, off, scaled, sizes, canvas, acc)
        if self.output == "labels":
            return self._labels_finish(acc, sizes)
        return self._finish(acc)

    def _dispatch_prepped(self, prep: dict):
        with torch.inference_mode():
            fused = self._device_pipeline(self._upload(prep))
        fetch = start_download(fused)
        names, orig_sizes = prep["names"], prep["orig_sizes"]
        if self.output == "labels":
            def finalize() -> list[dict]:
                lab = fetch()
                return [{"name": n, "label": lab[i, :orig_sizes[i][0], :orig_sizes[i][1]]}
                        for i, n in enumerate(names)]

            return finalize
        return self._make_finalize(fetch, names, orig_sizes, prep["cls_gates"])

    def _make_finalize(self, fetch, names, orig_sizes, cls_gates):
        def finalize() -> list[dict]:
            mean = fetch()
            out = []
            for i, name in enumerate(names):
                hh, ww = orig_sizes[i]
                probs = self._expand(mean[i], hh, ww)
                if cls_gates is not None and cls_gates[i] is not None:
                    gate = np.asarray(cls_gates[i]).reshape(-1)
                    probs[..., 1:] *= gate[1:][None, None, :]
                out.append({"name": name, "probs": probs})
            return out

        return finalize

    def _expand(self, m: np.ndarray, hh: int, ww: int) -> np.ndarray:
        """One image's (acc, acc, C) mean probabilities -> its valid region,
        upsampled (accum_stride > 1) to (hh, ww, C) float32 on the host
        (PIL 'F' bilinear, half-pixel)."""
        if self.accum_stride == 1:
            return m[:hh, :ww].astype(np.float32)
        from PIL import Image

        stride = self.accum_stride
        ah, aw = -(-hh // stride), -(-ww // stride)
        chans = [np.asarray(Image.fromarray(np.ascontiguousarray(m[:ah, :aw, c], np.float32), "F")
                            .resize((ww, hh), Image.BILINEAR), np.float32)
                 for c in range(m.shape[-1])]
        return np.stack(chans, axis=-1)

    def _prepare(self, batch: tuple) -> tuple[dict, bool]:
        """A fed batch's host prep (this rank's share, ``_share``) and
        whether the ranks' records are gathered after it."""
        mine, gather, canvases = self._share(batch)
        return self._host_prep(*mine, canvases=canvases), gather

    def run_stream(self, batches, prep_ahead: int = 1, finalize_ahead: int = 1):
        """Overlapped pipeline over an iterable of ``(images, names[,
        cls_gates])`` batches; yields each batch's result list in order.

        Three stages run concurrently (``inference/stream.py``): host prep
        (canvas packing) on a thread, dispatch on the caller's thread
        (enqueues device work), and finalize (blocking download + host
        upsample) on a thread.  Shallower than the CAM engine's default: a
        seg batch downloads far more.  Under a mesh the records are
        gathered on the caller's thread."""
        if not self.device_tta:
            raise ValueError("run_stream requires device_tta")
        yield from stream.run_stream(batches, self._prepare, self._dispatch_prepped, self.mesh,
                                     prep_ahead, finalize_ahead)
