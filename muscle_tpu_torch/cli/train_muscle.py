"""MuSCLe segmentation training CLI (port of
``muscle_tpu/cli/train_muscle.py``: its flags, plus --device and
--fuse_mbconv): EfficientNet-b7 + BiFPN on soft pseudo-labels with CE +
BEACON, the gradients clipped to a norm of 9, Adam, and at each epoch's
end a checkpoint (``model_<ep>.pth`` and the full state ``step_<ep>.pt``)
and the single-scale val mIoU driving ReduceLROnPlateau (0.5, patience 0,
min 5e-6).

The training step runs the plain MBConv blocks under autograd; the
epoch-end eval runs ``SegTTAEngine`` at scale 1 with the stride-1 blocks
through the MBConv kernel (``--fuse_mbconv``), and with ``--crf 1`` one
mean-field CRF step on its float32 probabilities.  float32 with TF32 off,
or with --bf16 1 bfloat16 on float32 parameters, as the JAX package's
``MuSCLe(dtype=jnp.bfloat16)`` trains; the eval then runs in bf16, its
fused blocks through the MBConv kernel's bf16 instantiation.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from muscle_tpu_torch.cli.common import add_voc_args, load_lists, load_model_state, train_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", default=6, type=int)
    p.add_argument("--max_epoches", default=8, type=int)
    p.add_argument("--lr", default=1e-5, type=float)
    p.add_argument("--wt_dec", default=1e-5, type=float)
    p.add_argument("--train_list", default="data/train_aug.txt", type=str)
    p.add_argument("--eval_list", default="data/val.txt", type=str)
    p.add_argument("--session_name", default="runs/muscle", type=str)
    p.add_argument("--crop_size", default=448, type=int)
    p.add_argument("--weights", default=None, type=str)
    p.add_argument("--mask_root", type=str, required=True)
    p.add_argument("--k", default=128, type=int)
    p.add_argument("--step", default=7, type=int)
    p.add_argument("--lamb", default=5e-2, type=float)
    p.add_argument("--crf", default=0, type=int)
    p.add_argument("--seed", default=221, type=int)
    p.add_argument("--pretrained", default="b7", type=str)
    p.add_argument("--bifpn", default=3, type=int)
    p.add_argument("--log_dir", default="logs/muscle", type=str)
    p.add_argument("--resume_epoch", default=None, type=int,
                   help="resume the full train state (model, Adam, step) from "
                        "<session_name>/step_<epoch>.pt")
    p.add_argument("--bf16", default=0, type=int,
                   help="1 = bfloat16 compute on float32 parameters and Adam state, the "
                        "epoch-end eval too; 0 = float32")
    p.add_argument("--device_norm", default=1, type=int,
                   help="1 = uint8 images and x255-quantised uint8 soft masks, decoded on "
                        "the device; 0 = host float32 (the reference's exact inputs)")
    p.add_argument("--pack_mask", default=-1, type=int,
                   help="ship only the mask channels that can be nonzero (background and "
                        "the image's classes) with their channel ids, added back on the "
                        "device (exact): -1 = size K from the label set, 0 = dense, K > 0 "
                        "a fixed budget (raises if exceeded)")
    p.add_argument("--upload", default="ycbcr420", choices=["rgb", "ycbcr420"],
                   help="with --device_norm 1: 'ycbcr420' ships luma + 2x2-subsampled "
                        "chroma (half the bytes), 'rgb' uint8 RGB")
    p.add_argument("--vis_every", default=25, type=int,
                   help="seg-mask PNGs under <log_dir>/vis every N iterations; 0 disables")
    p.add_argument("--log_every", default=25, type=int,
                   help="print and metrics.jsonl every N iterations")
    p.add_argument("--tb", default=1, type=int,
                   help="also write tensorboard event files under <log_dir>/tb")
    p.add_argument("--fuse_mbconv", default=384, type=int,
                   help="in the epoch-end eval, run stride-1 MBConv blocks with <= N input "
                        "channels through the MBConv CUDA kernel (0 = none; 384 = all of "
                        "b7's); training always runs the plain blocks")
    p.add_argument("--device", default="cuda", type=str, help="cuda or cpu")
    add_voc_args(p)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import torch

    from muscle_tpu_torch.data.loader import PrefetchLoader
    from muscle_tpu_torch.data.voc12 import VOC12SegDataset
    from muscle_tpu_torch.inference.upload import to_device
    from muscle_tpu_torch.models import MuSCLe
    from muscle_tpu_torch.training import (
        ReduceLROnPlateau,
        SegConfig,
        make_adam,
        restore_checkpoint,
        save_checkpoint,
        seg_train_step,
        set_learning_rate,
    )
    from muscle_tpu_torch.utils import MetricLogger, Timer, TrainVisualizer
    from muscle_tpu_torch.utils.tb_events import EventWriter

    device = train_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names, labels = load_lists(args, args.train_list)
    dataset = VOC12SegDataset(
        names, args.voc12_root, labels, args.mask_root, min_scale=0.5, max_scale=1.75,
        crop_size=args.crop_size, device_norm=bool(args.device_norm), pack_mask=args.pack_mask,
        upload=args.upload if args.device_norm else "rgb")
    # one process until the data-parallel slice: the whole index stream
    loader = PrefetchLoader(dataset, args.batch_size, seed=args.seed,
                            num_threads=args.num_workers, shard=(0, 1))

    model = MuSCLe(num_classes=args.num_classes, backbone_name="efficientnet-" + args.pretrained,
                   bifpn_layers=args.bifpn, mode="dec", last_pooling=True,
                   fuse_mbconv=args.fuse_mbconv)
    load_model_state(args.weights, model)
    model.to(device)
    opt = make_adam(model.trained_parameters(), args.lr, args.wt_dec)
    step, start_epoch = 0, 0
    if args.resume_epoch is not None:
        step = restore_checkpoint(args.session_name, args.resume_epoch, model, opt)
        start_epoch = args.resume_epoch + 1

    sched = ReduceLROnPlateau(args.lr, factor=0.5, patience=0, min_lr=5e-6)
    cfg = SegConfig(lamb=args.lamb, step=args.step, k=args.k, num_classes=args.num_classes)
    os.makedirs(args.session_name, exist_ok=True)
    mlog = MetricLogger(os.path.join(args.log_dir, "metrics.jsonl"))
    tb = EventWriter(os.path.join(args.log_dir, "tb")) if args.tb else None
    vis = TrainVisualizer(model, os.path.join(args.log_dir, "vis"), mode="seg",
                          every=args.vis_every, tb=tb, compute_dtype=dtype)
    timer = Timer()
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)

    for ep in range(start_epoch, args.max_epoches):
        for it, batch in enumerate(loader.epoch(ep)):
            dev = {k: to_device(v, device) for k, v in batch.items()}
            metrics = seg_train_step(model, opt, dev, cfg, gen, compute_dtype=dtype)
            step += 1
            if it % args.log_every == 0:
                vals = {k: float(v) for k, v in metrics.items()}
                ips = (it + 1) * args.batch_size / timer.stage_elapsed()
                lr = opt.param_groups[0]["lr"]
                print(f"ep {ep} it {it} " + " ".join(f"{k}:{v:.4f}" for k, v in vals.items())
                      + f" imps:{ips:.1f} lr:{lr:.7f}", flush=True)
                mlog.log(step, **vals, imps=ips, lr=lr)
                if tb is not None:
                    for k, v in vals.items():
                        tb.add_scalar(f"train/{k}", v, step)
            vis.maybe_dump(step, batch)

        save_checkpoint(args.session_name, model, opt, step, ep)
        miou = _val_eval(args, model, device, dtype)
        model.train()  # the engine left it in eval mode
        print(f"epoch {ep} val mIoU {miou:.3f}", flush=True)
        if tb is not None:
            tb.add_scalar("eval/seg_miou", miou, ep)
            tb.flush()
        set_learning_rate(opt, sched.step(miou))
        timer.reset_stage()
    mlog.close()
    if tb is not None:
        tb.close()


def _val_eval(args, model, device, dtype) -> float:
    """Single-scale val mIoU through ``SegTTAEngine(scales=(1.0,))`` (the
    fused blocks) in the training's compute dtype; with --crf, one
    mean-field step on each prediction's float32 probabilities before its
    argmax."""
    import torch
    from PIL import Image

    from muscle_tpu_torch.data.voc12 import get_img_path
    from muscle_tpu_torch.evaluation import confusion_matrix, iou_from_confusion
    from muscle_tpu_torch.inference import SegTTAEngine
    from muscle_tpu_torch.ops.crf import mean_field_crf

    names, _ = load_lists(args, args.eval_list)
    engine = SegTTAEngine(model, scales=(1.0,), num_classes=args.num_classes, device=device,
                          compute_dtype=dtype)
    conf = np.zeros((args.num_classes, args.num_classes), np.int64)
    bs = 4
    for i in range(0, len(names), bs):
        chunk = names[i: i + bs]
        imgs = [Image.open(get_img_path(n, args.voc12_root)).convert("RGB") for n in chunk]
        for img, rec in zip(imgs, engine.run_batch(imgs, chunk)):
            gt = np.array(Image.open(os.path.join(args.voc12_root, "SegmentationClass",
                                                  rec["name"] + ".png")))
            probs = rec["probs"]
            if args.crf:
                probs = mean_field_crf(torch.from_numpy(probs).to(device, torch.float32),
                                       torch.from_numpy(np.array(img)).to(device),
                                       t=1).cpu().numpy()
            conf += confusion_matrix(np.argmax(probs, axis=-1), gt, args.num_classes)
    return iou_from_confusion(conf)["mIoU"]


if __name__ == "__main__":
    main()
