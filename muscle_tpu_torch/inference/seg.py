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
"""

from __future__ import annotations

import numpy as np
import torch

from muscle_tpu_torch.core.resize import dynamic_window_resize
from muscle_tpu_torch.data import transforms as T
from muscle_tpu_torch.data.tta import msf_batch, scaled_size
from muscle_tpu_torch.inference.cam import COMPUTE_DTYPES, _batch_canvas, _valid, scaled_pairs
from muscle_tpu_torch.inference.upload import start_download, to_device
from muscle_tpu_torch.models.efficientnet import advance_window, placement_offset

# stride-2 convs of the dec backbone ladder (last_pooling=True: stride 32),
# the ladder depth for placement_offset
N_STRIDED_DEC = 5


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
      mesh, shard_spatial: sharding one engine over several devices is not
        ported: launch one engine per card with torchrun, each on its rows
        of every batch (``cli/infer_seg.py``; ROADMAP Queue A item 7).
      device: where the model runs: 'cuda' (default) or 'cpu'.
    """

    def __init__(self, model, scales=(0.5, 0.75, 1.0, 1.25, 1.5, 1.75), num_classes: int = 21,
                 out_side: int = 512, max_side: int = 500, compute_dtype=torch.float32,
                 device_tta: bool = True, accum_stride: int = 1,
                 download_dtype: str = "float32", tight_upload: bool = True,
                 upload_mode: str = "ycbcr420", mesh=None, shard_spatial: bool = False,
                 output: str = "probs", device: str | torch.device = "cuda"):
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        if mesh is not None or shard_spatial:
            raise NotImplementedError(
                "mesh / shard_spatial (one engine over several devices) are not ported: run "
                "one engine per card under torchrun (cli/infer_seg.py), ROADMAP Queue A item 7")
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
        self._mean = torch.tensor(T.IMAGENET_MEAN[0, 0], dtype=torch.float32, device=self.device)
        self._std = torch.tensor(T.IMAGENET_STD[0, 0], dtype=torch.float32, device=self.device)

    def _put(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    def bench_device_exec(self, images, names):
        raise NotImplementedError("bench_device_exec waits for a device-only bench of the port")

    # ---- one scale -------------------------------------------------------------

    def _scale(self, images: torch.Tensor, off: torch.Tensor, sizes: torch.Tensor,
               orig_sizes: torch.Tensor, canvas_hw: tuple[int, int], acc: torch.Tensor):
        """One scale's (orig, flip) batch ``images`` (2B, ch, cw, 3), placed
        at ``off`` with scaled sizes ``sizes`` (B, 2) -> the window-exact
        forward (the padded canvas computes each image's unpadded forward)
        -> softmax of the input-size logits -> resized to the accumulation
        grid (un-flipped) and added into ``acc`` (B, acc, acc, C) in
        place."""
        ch, cw = canvas_hw
        win = torch.cat([off, sizes], dim=-1)
        seg, _ = self.model(images.to(self.compute_dtype), mode="seg_lowres",
                            valid_window=win.repeat_interleave(2, dim=0))
        seg = seg.float()
        # stride-8 logits -> input-size logits, the reference's seg_map (exact:
        # the 1x1 head commutes with the bilinear upsample)
        boxes = win
        for _ in range((ch // seg.shape[1]).bit_length() - 1):
            boxes = advance_window(boxes)
        seg = dynamic_window_resize(seg, boxes.repeat_interleave(2, dim=0), (ch, cw),
                                    dst_hw=sizes.repeat_interleave(2, dim=0), align_corners=True)
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
        if self.device_tta:
            return self._dispatch_prepped(self._host_prep(images, names, cls_gates))()
        return self._run_host(images, names, cls_gates)

    def run_batch_async(self, images, names, cls_gates=None):
        """Enqueue a device_tta batch; returns a ``finalize() -> list[dict]``
        closure that waits for it.  Enqueue the next batch before
        finalizing this one to overlap its download with the next
        compute."""
        if not self.device_tta:
            raise ValueError("run_batch_async requires device_tta")
        return self._dispatch_prepped(self._host_prep(images, names, cls_gates))

    def _run_host(self, images, names, cls_gates):
        """The host-prep path: PIL-resized canvases per scale."""
        b = len(images)
        acc = self._new_acc(b)
        orig_sizes = None
        with torch.inference_mode():
            for s in self.scales:
                scaled = np.asarray(
                    [scaled_size(*T.image_size(img), s)[::-1] for img in images], np.int32)
                off = placement_offset(scaled, N_STRIDED_DEC)
                ch = -(-int(np.max(scaled[:, 0] + off[:, 0])) // 64) * 64
                cw = -(-int(np.max(scaled[:, 1] + off[:, 1])) // 64) * 64
                mb = msf_batch(images, names, s, canvas=(ch, cw), offsets=off)
                orig_sizes = mb.orig_sizes
                self._scale(self._put(mb.images), self._put(off), self._put(mb.sizes),
                            self._put(orig_sizes), (ch, cw), acc)
            fused = self._finish(acc)
        return self._make_finalize(start_download(fused), names, orig_sizes, cls_gates)()

    def _host_prep(self, images, names, cls_gates=None) -> dict:
        """Host stage of the device path: canvas packing.  CPU only, safe on
        a prefetch thread."""
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
                "cls_gates": cls_gates}

    def _device_pipeline(self, upload, orig_sizes: np.ndarray) -> torch.Tensor:
        """Upload, unpack, every TTA scale and the finish of one batch,
        enqueued on the device; returns the tensor to download."""
        from muscle_tpu_torch.inference.upload import square_unpack_fn, ycbcr420_unpack_fn

        kind, *arrays = upload
        args = [self._put(a) for a in arrays]
        if kind == "ycbcr420":
            images = ycbcr420_unpack_fn(self.out_side)(*args)
        elif kind == "tight":
            images = square_unpack_fn(self.out_side)(*args)
        else:
            images = args[0]
        sizes = self._put(orig_sizes)
        acc = self._new_acc(len(orig_sizes))
        for s in self.scales:
            canvas = _batch_canvas(s, orig_sizes, self.max_side, n_strided=N_STRIDED_DEC)
            scaled, off, pairs = scaled_pairs(images, sizes, s, canvas, self._mean, self._std,
                                              N_STRIDED_DEC)
            self._scale(pairs, off, scaled, sizes, canvas, acc)
        if self.output == "labels":
            return self._labels_finish(acc, sizes)
        return self._finish(acc)

    def _dispatch_prepped(self, prep: dict):
        with torch.inference_mode():
            fused = self._device_pipeline(prep["upload"], prep["orig_sizes"])
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

    def run_stream(self, batches, prep_ahead: int = 1, finalize_ahead: int = 1):
        """Overlapped pipeline over an iterable of ``(images, names[,
        cls_gates])`` batches; yields each batch's result list in order.

        Three stages run concurrently: host prep (canvas packing) on a
        thread, dispatch on the caller's thread (enqueues device work), and
        finalize (blocking download + host upsample) on a thread.  Shallower
        than the CAM engine's default: a seg batch downloads far more."""
        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        if not self.device_tta:
            raise ValueError("run_stream requires device_tta")
        prep_q: queue.Queue = queue.Queue(maxsize=max(1, prep_ahead))
        sentinel = object()

        def produce():
            try:
                for batch in batches:
                    prep_q.put(self._host_prep(*batch))
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
                pending.append(fin_ex.submit(self._dispatch_prepped(item)))
                if len(pending) > finalize_ahead:
                    yield pending.pop(0).result()
            for fut in pending:
                yield fut.result()
