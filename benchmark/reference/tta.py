"""Plain multi-scale + flip TTA of the reference, one batch at a time, in
float32, with the pipeline's output contract:

* CAM (``cam_batch``): the reference's ``infer_mcl`` fusion (sum over the
  versions, per-class min-max normalisation with the zeroing of sub-min
  values, sigmoid of the mean score) in the fast settings the cells state:
  the labelled classes only (at most ``max_classes``), accumulated on an
  ``accum_stride`` grid, quantised to uint8, upsampled to the original size
  on the host (PIL bilinear) as float16.
* seg (``seg_batch``): the reference's ``infer_seg`` fusion (softmax per
  version, mean over the versions) on an ``accum_stride`` grid, resized to
  the original size and the argmax taken: a uint8 label map.

Both upload each image as 4:2:0 YCbCr planes (PIL's conversion and BOX
chroma subsampling on the host, the BT.601 decode on the device), resize it
with PIL's bicubic on the device, and run the model on window-exact
canvases of the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.resize import (
    cam_resize_weights,
    cubic_weights,
    resize_bilinear,
    window_sample,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def ycbcr420(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """HWC uint8 RGB -> (Y (H, W), CbCr (ceil H/2, ceil W/2, 2)) uint8 by
    PIL's YCbCr conversion and a BOX 2x chroma subsample."""
    from PIL import Image

    pil = Image.fromarray(np.ascontiguousarray(img[..., :3]), "RGB")
    y, cb, cr = (np.asarray(p) for p in pil.convert("YCbCr").split())
    h, w = y.shape
    c = np.stack([np.asarray(Image.fromarray(p).resize(((w + 1) // 2, (h + 1) // 2), Image.BOX))
                  for p in (cb, cr)], axis=-1)
    return y, c


def decode_ycbcr420(y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, H, W) Y + (B, H/2, W/2, 2) CbCr uint8 -> (B, H, W, 3) RGB floats
    in [0, 255]: bilinear (half-pixel) chroma upsample, BT.601 full range."""
    cup = resize_bilinear(c.to(torch.float32), tuple(y.shape[1:3]), align_corners=False)
    yf = y.to(torch.float32)
    cb, cr = cup[..., 0] - 128.0, cup[..., 1] - 128.0
    rgb = torch.stack([yf + 1.402 * cr, yf - 0.344136 * cb - 0.714136 * cr, yf + 1.772 * cb],
                      dim=-1)
    return torch.clamp(rgb, 0.0, 255.0)


def upload(images, side: int, device) -> tuple[torch.Tensor, np.ndarray]:
    """Each image's 4:2:0 planes on a (side, side) canvas, decoded to RGB on
    the device: ((B, side, side, 3) floats, (B, 2) original (h, w)).  The
    chroma's last row and column are repeated once past the image, so the
    upsample never blends chroma with the canvas's zeros inside it."""
    b = len(images)
    ys = np.zeros((b, side, side), np.uint8)
    cs = np.zeros((b, side // 2, side // 2, 2), np.uint8)
    sizes = np.zeros((b, 2), np.int32)
    for i, img in enumerate(images):
        y, c = ycbcr420(np.asarray(img))
        h, w = y.shape
        ch, cw = c.shape[:2]
        sizes[i] = (h, w)
        ys[i, :h, :w] = y
        cs[i, :ch, :cw] = c
        if ch < side // 2:
            cs[i, ch, :cw] = c[-1]
        if cw < side // 2:
            cs[i, : ch + (ch < side // 2), cw] = cs[i, : ch + (ch < side // 2), cw - 1]
    rgb = decode_ycbcr420(torch.from_numpy(ys).to(device), torch.from_numpy(cs).to(device))
    return rgb, sizes


def batch_canvas(sizes: np.ndarray, scale: float) -> tuple[int, int]:
    """A batch's canvas at ``scale``: its largest scaled (h, w), rounded up
    to multiples of 64 (every image at the origin)."""
    scaled = np.round(sizes.astype(np.float32) * np.float32(scale)).astype(np.int32)
    return (-(-int(scaled[:, 0].max()) // 64) * 64, -(-int(scaled[:, 1].max()) // 64) * 64)


def scaled_pairs(rgb, sizes_t, scale: float, canvas_hw):
    """Normalised bicubic-scaled (orig, flip) pairs of each image at the
    canvas origin, interleaved: (scaled sizes (B, 2), (2B, ch, cw, 3))."""
    ch, cw = canvas_hw
    side = rgb.shape[1]
    scaled = torch.round(sizes_t.to(torch.float32) * scale).to(torch.int32)
    mean = torch.tensor(IMAGENET_MEAN, device=rgb.device)
    std = torch.tensor(IMAGENET_STD, device=rgb.device)
    x = (rgb / 255.0 - mean) / std
    wh = cubic_weights(sizes_t[:, 0], scaled[:, 0], side, ch)
    ww = cubic_weights(sizes_t[:, 1], scaled[:, 1], side, cw)
    wwf = cubic_weights(sizes_t[:, 1], scaled[:, 1], side, cw, flip=True)
    a = torch.einsum("bIy,byxc->bIxc", wh, x)
    pairs = torch.stack([torch.einsum("bJx,bIxc->bIJc", ww, a),
                         torch.einsum("bJx,bIxc->bIJc", wwf, a)], dim=1)
    return scaled, pairs.reshape(-1, ch, cw, 3)


def _valid(rows: int, cols: int, hw: torch.Tensor) -> torch.Tensor:
    r = torch.arange(rows, device=hw.device)[None, :, None]
    c = torch.arange(cols, device=hw.device)[None, None, :]
    return ((r < hw[:, 0, None, None]) & (c < hw[:, 1, None, None]))[..., None]


def _minmax_norm(m, valid):
    fg = torch.clamp(m, min=0.0)
    mx = torch.amax(torch.where(valid, fg, torch.full_like(fg, -torch.inf)), dim=(1, 2),
                    keepdim=True)
    mn = torch.amin(torch.where(valid, fg, torch.full_like(fg, torch.inf)), dim=(1, 2),
                    keepdim=True)
    fg = torch.where(fg < mn + 1e-6, torch.zeros_like(fg), fg)
    return (fg - mn - 1e-6) / (mx - mn + 1e-6) * valid


def _host_upsample(m: np.ndarray, hh: int, ww: int, stride: int) -> np.ndarray:
    """One map on the stride grid -> (hh, ww) by PIL's bilinear."""
    from PIL import Image

    ah, aw = -(-hh // stride), -(-ww // stride)
    img = Image.fromarray(np.ascontiguousarray(m[:ah, :aw], np.float32), "F")
    return np.asarray(img.resize((ww, hh), Image.BILINEAR), np.float32)


@torch.no_grad()
def cam_batch(model, images, labels, scales, out_side: int = 512, accum_stride: int = 4,
              max_classes: int = 8, num_classes: int = 21) -> list[dict]:
    """One CAM batch: per image {'sgc': {class: (H, W) float16}, 'score':
    (num_classes - 1,) float32}."""
    dev = next(model.parameters()).device
    rgb, sizes = upload(images, out_side, dev)
    sizes_t = torch.from_numpy(sizes).to(dev)
    b, acc = len(images), out_side // accum_stride
    idx = np.zeros((b, max_classes), np.int64)
    keep = []
    for i, lab in enumerate(labels):
        k = np.nonzero(np.asarray(lab) > 1e-5)[0][:max_classes]
        idx[i, :len(k)] = k
        keep.append(k)
    idx_t = torch.from_numpy(idx).to(dev)
    dst = (sizes_t + accum_stride - 1) // accum_stride
    sgc = torch.zeros((b, acc, acc, max_classes), device=dev)
    logits = torch.zeros((b, num_classes), device=dev)
    for s in scales:
        ch, cw = batch_canvas(sizes, s)
        scaled, pairs = scaled_pairs(rgb, sizes_t, s, (ch, cw))
        win = torch.cat([torch.zeros_like(scaled), scaled], dim=-1)
        _, maps, _, lg = model(pairs, mode="cam_lowres", valid_window=win.repeat_interleave(2, 0))
        maps = maps.reshape(b, 2, *maps.shape[1:])[..., 1:]
        maps = torch.gather(maps, -1, idx_t[:, None, None, None, :].expand(
            *maps.shape[:4], max_classes))
        h16, w16 = maps.shape[2:4]
        map_sz = scaled // (ch // h16)
        wh = cam_resize_weights(map_sz[:, 0], scaled[:, 0], dst[:, 0], h16, ch, acc)
        ww = cam_resize_weights(map_sz[:, 1], scaled[:, 1], dst[:, 1], w16, cw, acc)
        wwf = cam_resize_weights(map_sz[:, 1], scaled[:, 1], dst[:, 1], w16, cw, acc, flip=True)

        def back(m, wx):
            return torch.einsum("bJx,bIxk->bIJk", wx, torch.einsum("bIy,byxk->bIxk", wh, m))

        sgc += (back(maps[:, 0], ww) + back(maps[:, 1], wwf)) * _valid(acc, acc, dst)
        logits += lg.reshape(b, 2, -1).sum(dim=1)
    fused = _minmax_norm(sgc, _valid(acc, acc, dst))
    q = torch.round(torch.clamp(fused, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
    score = torch.sigmoid(logits[:, 1:] / float(2 * len(scales))).cpu().numpy()
    out = []
    for i in range(b):
        hh, ww_ = sizes[i]
        maps_i = {int(c): _host_upsample(q[i, ..., j].astype(np.float32) / 255.0, hh, ww_,
                                         accum_stride).astype(np.float16)
                  for j, c in enumerate(keep[i])}
        out.append({"sgc": maps_i, "score": score[i]})
    return out


@torch.no_grad()
def seg_batch(model, images, scales, out_side: int = 512, accum_stride: int = 4,
              num_classes: int = 21) -> list[np.ndarray]:
    """One seg batch: per image its (H, W) uint8 label map."""
    dev = next(model.parameters()).device
    rgb, sizes = upload(images, out_side, dev)
    sizes_t = torch.from_numpy(sizes).to(dev)
    b, acc = len(images), out_side // accum_stride
    dst = (sizes_t + accum_stride - 1) // accum_stride
    total = torch.zeros((b, acc, acc, num_classes), device=dev)
    for s in scales:
        ch, cw = batch_canvas(sizes, s)
        scaled, pairs = scaled_pairs(rgb, sizes_t, s, (ch, cw))
        win = torch.cat([torch.zeros_like(scaled), scaled], dim=-1)
        seg, _ = model(pairs, mode="seg_lowres", valid_window=win.repeat_interleave(2, 0))
        boxes = win
        for _ in range((ch // seg.shape[1]).bit_length() - 1):
            boxes = boxes // 2
        seg = window_sample(seg, boxes.repeat_interleave(2, 0), (ch, cw),
                            scaled.repeat_interleave(2, 0), align_corners=True)
        probs = torch.softmax(seg, dim=-1).reshape(b, 2, ch, cw, num_classes)
        box = torch.cat([torch.zeros_like(scaled), scaled], dim=-1)
        for f in (0, 1):
            total += window_sample(probs[:, f], box, (acc, acc), dst, align_corners=False,
                                   flip_x=bool(f)) * _valid(acc, acc, dst)
    box = torch.cat([torch.zeros_like(dst), dst], dim=-1)
    up = window_sample(total, box, (out_side, out_side), sizes_t, align_corners=False)
    lab = torch.argmax(up, dim=-1).to(torch.uint8).cpu().numpy()
    return [lab[i, :sizes[i][0], :sizes[i][1]] for i in range(b)]
