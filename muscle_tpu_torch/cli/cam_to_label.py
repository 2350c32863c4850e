"""CAM -> hard pseudo-label CLI for IRN training (port of
``muscle_tpu/cli/cam_to_label.py``, same flags plus --device for the
mean-field backend).

Two hard-label CRF passes over the CAM argmax, at a conservative (fg) and
a permissive (bg) background score; pixels where the passes disagree
become void (255).  Input: the {fg_class_idx: (H, W)} SGC npy dicts of
``infer_mcl``.  Output: palettised PNGs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from muscle_tpu_torch.cli.common import add_voc_args, load_lists
from muscle_tpu_torch.core.palette import save_indexed_png
from muscle_tpu_torch.data.voc12 import get_img_path


def cam_dict_to_label(img: np.ndarray, cam_dict: dict[int, np.ndarray], fg_thres: float = 0.30,
                      bg_thres: float = 0.05, t: int = 10, crf_backend: str = "native",
                      device: str = "cuda") -> np.ndarray:
    """(H, W) uint8 VOC labels with a void band (255) between the
    confident-foreground and confident-background CRF passes.  cam_dict
    keys are 0-indexed foreground classes (VOC class = key + 1)."""
    h, w = img.shape[:2]
    keys = np.array(sorted(cam_dict), dtype=np.int64)
    if keys.size == 0:
        return np.zeros((h, w), np.uint8)
    cams = np.stack([cam_dict[int(k)].astype(np.float32) for k in keys])

    def crf_pass(bg_score: float) -> np.ndarray:
        stack = np.concatenate([np.full((1, h, w), bg_score, np.float32), cams], axis=0)
        labels = np.argmax(stack, axis=0).astype(np.uint8)  # 0 = bg, i + 1 = keys[i]
        return _crf_label(img, labels, t, keys.size + 1, crf_backend, device)

    fg_conf = crf_pass(fg_thres)
    bg_conf = crf_pass(bg_thres)
    lut = np.concatenate([[0], keys + 1]).astype(np.uint8)
    out = lut[fg_conf]
    out[fg_conf == 0] = 255  # background in the fg pass: uncertain
    out[(fg_conf == 0) & (bg_conf == 0)] = 0  # both passes agree: background
    return out


def _crf_label(img, labels, t, n_labels, backend, device):
    if backend == "native":
        from muscle_tpu_torch.ops.exact_crf import dense_crf_label

        return dense_crf_label(img, labels, t=t, n_labels=n_labels)
    # the mean-field CRF with unary_from_labels semantics
    import torch

    from muscle_tpu_torch.ops.crf import mean_field_crf

    gt_prob = 0.7
    p = np.full((*labels.shape, n_labels), (1.0 - gt_prob) / max(n_labels - 1, 1), np.float32)
    rows, cols = np.indices(labels.shape)
    p[rows, cols, labels.astype(np.int64)] = gt_prob
    q = mean_field_crf(torch.from_numpy(p).to(device), torch.from_numpy(np.array(img)).to(device),
                       t=t, sxy_gaussian=3.0, compat_gaussian=3.0, sxy_bilateral=50.0, srgb=5.0,
                       compat_bilateral=10.0, scale_factor=1.0, confidence=1.0)
    return torch.argmax(q, dim=-1).cpu().numpy()


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--cam_dir", required=True, type=str,
                   help="SGC npy dict dir from cli.infer_mcl (out/cam_sgc)")
    p.add_argument("--out_dir", default="out/cam_png", type=str)
    p.add_argument("--infer_list", default="data/train_aug.txt", type=str)
    p.add_argument("--fg_thres", default=0.30, type=float,
                   help="conservative bg score: argmax fg here is confident fg")
    p.add_argument("--bg_thres", default=0.05, type=float,
                   help="permissive bg score: argmax bg here is confident bg")
    p.add_argument("--crf_t", default=10, type=int)
    p.add_argument("--crf_backend", default="native", choices=["native", "xla"])
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda or cpu: where the xla (mean-field) backend runs")
    add_voc_args(p)
    args = p.parse_args(argv)

    from PIL import Image

    names, _ = load_lists(args, args.infer_list)
    os.makedirs(args.out_dir, exist_ok=True)
    for i, name in enumerate(names):
        img = np.asarray(Image.open(get_img_path(name, args.voc12_root)).convert("RGB"))
        cam_dict = np.load(os.path.join(args.cam_dir, name + ".npy"), allow_pickle=True).item()
        labels = cam_dict_to_label(img, cam_dict, args.fg_thres, args.bg_thres, args.crf_t,
                                   args.crf_backend, args.device)
        save_indexed_png(os.path.join(args.out_dir, name + ".png"), labels)
        if i % 100 == 0:
            print(f"{i}/{len(names)}")


if __name__ == "__main__":
    main()
