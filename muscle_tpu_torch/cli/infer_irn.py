"""Random-walk CAM refinement CLI (port of ``muscle_tpu/cli/infer_irn.py``,
same flags plus --device).

Writes hard pseudo-labels as palettised PNGs into <sem_seg_out_dir>_png/,
or with --soft_output 1 soft float16 (H, W, 21) npy labels into
<sem_seg_out_dir>/.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from muscle_tpu_torch.cli.common import add_voc_args, fetch_weights, load_lists, prefetch_chunks
from muscle_tpu_torch.core.palette import save_indexed_png
from muscle_tpu_torch.data.voc12 import get_img_path


def load_irn_weights(weights: str, model) -> None:
    """Load a reference IRN ``.pth`` (local path or URL) into ``model``.
    Every key of the model must be in the file, except the running-batch
    counters and the MeanShift buffer (zero when absent, as in the JAX
    package's converter); other keys of the file are ignored."""
    weights = fetch_weights(weights)
    if weights.endswith(".msgpack"):
        raise NotImplementedError(
            f"{weights!r}: Flax .msgpack checkpoints are not readable by the PyTorch port yet; "
            "convert them to a .pth state dict with muscle_tpu_torch.convert."
            "irn_state_dict_from_jax")
    from muscle_tpu_torch.convert import load_reference_state_dict

    sd = load_reference_state_dict(weights)
    own = model.state_dict()
    optional = ("num_batches_tracked", "mean_shift.running_mean")
    missing = [k for k in own if k not in sd and not k.endswith(optional)]
    if missing:
        raise KeyError(f"{weights!r} lacks {len(missing)} IRN keys, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in own if k in sd}, strict=False)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--beta", default=8, type=int)
    p.add_argument("--exp_times", default=6, type=int)
    p.add_argument("--sem_seg_bg_thres", default=0.35, type=float)
    p.add_argument("--irn_weights_name", type=str, required=True)
    p.add_argument("--cam_dir", required=True, type=str)
    p.add_argument("--sem_seg_out_dir", default="./irn_rw", type=str)
    p.add_argument("--infer_list", default="data/train.txt", type=str)
    p.add_argument("--soft_output", default=0, type=int)
    p.add_argument("--walk_method", default="stencil",
                   choices=["stencil", "vector", "banded", "power"], type=str)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--bf16", default=0, type=int, help="not supported yet: 0 only")
    p.add_argument("--fast", default=1, type=int,
                   help="1 = fast IO (ycbcr420 image upload, K-channel f16 CAMs at the walk "
                        "grid, uint8 labels or grid-res f16 scores down); 0 = full-res f32 "
                        "parity IO")
    p.add_argument("--device", default="cuda", type=str, help="cuda or cpu")
    add_voc_args(p)
    args = p.parse_args(argv)
    if args.bf16:
        raise NotImplementedError("--bf16 1: bf16 edge-model compute is not ported yet")

    from PIL import Image

    from muscle_tpu_torch.inference.irn import RandomWalkRefiner
    from muscle_tpu_torch.models.irn import EdgeDisplacement

    model = EdgeDisplacement()
    load_irn_weights(args.irn_weights_name, model)
    refiner = RandomWalkRefiner(
        model, beta=args.beta, exp_times=args.exp_times, bg_threshold=args.sem_seg_bg_thres,
        walk_method=args.walk_method, fast_io=bool(args.fast), device=args.device,
        # PNG-only output needs no soft scores: the reference tail (upsample,
        # /max, bg threshold, argmax) runs on the device, one uint8 map down
        output="scores" if (args.soft_output or not args.fast) else "labels",
    )

    names, _ = load_lists(args, args.infer_list)
    if args.soft_output:
        os.makedirs(args.sem_seg_out_dir, exist_ok=True)
    os.makedirs(args.sem_seg_out_dir + "_png", exist_ok=True)

    def load(chunk):
        imgs, dicts = [], []
        for name in chunk:
            imgs.append(Image.open(get_img_path(name, args.voc12_root)).convert("RGB"))
            dicts.append(np.load(os.path.join(args.cam_dir, name + ".npy"),
                                 allow_pickle=True).item())
        return imgs, dicts

    done = 0
    for chunk, (imgs, dicts) in prefetch_chunks(names, max(1, args.batch_size), load):
        for name, scores in zip(chunk, refiner.refine_batch(imgs, dicts)):
            if args.soft_output:
                np.save(os.path.join(args.sem_seg_out_dir, name + ".npy"),
                        scores.astype(np.float16))
            else:
                save_indexed_png(os.path.join(args.sem_seg_out_dir + "_png", name + ".png"),
                                 refiner.to_png_labels(scores))
        done += len(chunk)
        print(f"{done}/{len(names)}")


if __name__ == "__main__":
    main()
