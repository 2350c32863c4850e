"""MCL contrastive-classifier training CLI (port of
``muscle_tpu/cli/train_mcl.py``: its flags, plus --device).

Curriculum (the reference's): epochs 0-3 the classification losses only
(step A); IMC from epoch 4; step B with PixPro from epoch 8; EMD from
epoch 12.  At each epoch's end: a checkpoint (``model_<ep>.pth`` and the
full state ``step_<ep>.pt``), the rapid CAM eval over background
thresholds 0.20-0.50, and ReduceLROnPlateau on its best mIoU.  The model
trains with the plain MBConv blocks under autograd (``fuse_mbconv=0``, as
the JAX trainer does), in float32 with TF32 off, or with --bf16 1 in
bfloat16 on float32 parameters as the JAX package's
``MuSCLe(dtype=jnp.bfloat16)`` does: a fresh classifier kernel starts in
bf16 (``models.classifier_as``; a checkpoint's ``fc.weight`` replaces it
in its own dtype) and the first Adam step promotes it to float32
(``training/state.py``); the epoch-end eval runs the CAM engine in bf16.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from muscle_tpu_torch.cli.common import add_voc_args, load_lists, load_model_state, train_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--max_epoches", default=16, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--wt_dec", default=5e-5, type=float)
    p.add_argument("--train_list", default="data/train_aug.txt", type=str)
    p.add_argument("--eval_list", default="data/train.txt", type=str)
    p.add_argument("--session_name", default="runs/EffSeg_mcl", type=str)
    p.add_argument("--crop_size", default=448, type=int)
    p.add_argument("--weights", default=None, type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--log_dir", default="logs/mcl", type=str)
    p.add_argument("--resume_epoch", default=None, type=int,
                   help="resume the full train state (model, Adam, step) from "
                        "<session_name>/step_<epoch>.pt")
    p.add_argument("--backbone", default="efficientnet-b3", type=str)
    p.add_argument("--device_norm", default=1, type=int,
                   help="1 = uint8 batches normalised on the device; 0 = host-normalised "
                        "float32 (the reference's exact inputs)")
    p.add_argument("--upload", default="ycbcr420", choices=["rgb", "ycbcr420"],
                   help="with --device_norm 1: 'ycbcr420' ships luma + 2x2-subsampled "
                        "chroma (half the bytes), 'rgb' uint8 RGB")
    p.add_argument("--bf16", default=0, type=int,
                   help="1 = bfloat16 compute on float32 parameters and Adam state (the "
                        "classifier kernel bf16 until its first step), 0 = float32")
    p.add_argument("--vis_every", default=25, type=int,
                   help="CAM/SGC overlay PNGs under <log_dir>/vis every N iterations; "
                        "0 disables")
    p.add_argument("--log_every", default=25, type=int,
                   help="print and metrics.jsonl every N iterations")
    p.add_argument("--tb", default=1, type=int,
                   help="also write tensorboard event files under <log_dir>/tb")
    p.add_argument("--profile_dir", default=None, type=str,
                   help="write a torch.profiler chrome trace of epoch 0's steps 10-13 here")
    p.add_argument("--device", default="cuda", type=str, help="cuda or cpu")
    add_voc_args(p)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import torch

    from muscle_tpu_torch.data.loader import PrefetchLoader
    from muscle_tpu_torch.data.voc12 import VOC12ClsPixDataset
    from muscle_tpu_torch.inference.upload import to_device
    from muscle_tpu_torch.models import MuSCLe, classifier_as
    from muscle_tpu_torch.training import (
        MCLConfig,
        ReduceLROnPlateau,
        make_adam,
        mcl_train_step,
        mcl_views_step,
        restore_checkpoint,
        save_checkpoint,
        set_learning_rate,
    )
    from muscle_tpu_torch.utils import MetricLogger, Timer, TrainVisualizer
    from muscle_tpu_torch.utils.tb_events import EventWriter

    device = train_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names, labels = load_lists(args, args.train_list)
    dataset = VOC12ClsPixDataset(
        names, args.voc12_root, labels, crop_size=args.crop_size,
        device_norm=bool(args.device_norm),
        upload=args.upload if args.device_norm else "rgb")
    # one process until the data-parallel slice: the whole index stream
    loader = PrefetchLoader(dataset, args.batch_size, seed=args.seed,
                            num_threads=args.num_workers, shard=(0, 1))

    model = MuSCLe(num_classes=args.num_classes, backbone_name=args.backbone,
                   bifpn_layers=3, mode="enc", last_pooling=False, fuse_mbconv=0)
    classifier_as(model, dtype)
    load_model_state(args.weights, model)
    model.to(device)
    opt = make_adam(model.trained_parameters(), args.lr, args.wt_dec)
    step, start_epoch = 0, 0
    if args.resume_epoch is not None:
        step = restore_checkpoint(args.session_name, args.resume_epoch, model, opt)
        start_epoch = args.resume_epoch + 1

    sched = ReduceLROnPlateau(args.lr, factor=0.5, patience=0, min_lr=1e-5)
    os.makedirs(args.session_name, exist_ok=True)
    mlog = MetricLogger(os.path.join(args.log_dir, "metrics.jsonl"))
    tb = EventWriter(os.path.join(args.log_dir, "tb")) if args.tb else None
    vis = TrainVisualizer(model, os.path.join(args.log_dir, "vis"), mode="cam",
                          every=args.vis_every, tb=tb, compute_dtype=dtype)
    timer = Timer()
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    prof = None

    for ep in range(start_epoch, args.max_epoches):
        cfg = MCLConfig(use_imc=ep >= 4, use_pixpro=ep >= 8, use_emd=ep >= 12)
        for it, batch in enumerate(loader.epoch(ep)):
            if args.profile_dir and ep == 0 and it == 10:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            if prof is not None and it == 14:
                prof = _stop_trace(prof, args.profile_dir)
            dev = {k: to_device(v, device) for k, v in batch.items()}
            metrics = mcl_train_step(model, opt, dev, cfg, gen, compute_dtype=dtype)
            step += 1
            if cfg.use_pixpro:
                metrics.update(mcl_views_step(model, opt, dev, cfg, gen, compute_dtype=dtype))
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
                    tb.add_scalar("train/lr", lr, step)
            vis.maybe_dump(step, batch)

        if prof is not None:  # an epoch of fewer than 14 iterations
            prof = _stop_trace(prof, args.profile_dir)
        save_checkpoint(args.session_name, model, opt, step, ep)
        miou = _rapid_eval(args, model, device, dtype)
        model.train()  # the engine left it in eval mode
        print(f"epoch {ep} best train-CAM mIoU {miou:.3f}", flush=True)
        if tb is not None:
            tb.add_scalar("eval/cam_miou", miou, ep)
            tb.flush()
        set_learning_rate(opt, sched.step(miou))
        timer.reset_stage()
    mlog.close()
    if tb is not None:
        tb.close()


def _stop_trace(prof, profile_dir: str) -> None:
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "train_mcl_trace.json"))


def _rapid_eval(args, model, device, dtype) -> float:
    """Epoch-end CAM eval: single-scale SGC maps over the eval list through
    the TTA engine (DEVIATIONS #11) in the training's compute dtype (the
    JAX package's bf16 model computes in bf16 inside its engine), best
    mIoU over background thresholds 0.20..0.50 step 0.02."""
    from PIL import Image

    from muscle_tpu_torch.data.voc12 import get_img_path
    from muscle_tpu_torch.evaluation import threshold_sweep
    from muscle_tpu_torch.inference import CamTTAEngine

    names, labels = load_lists(args, args.eval_list)
    engine = CamTTAEngine(model, scales=(1.0,), num_classes=args.num_classes,
                          return_cam=False, device=device, compute_dtype=dtype)
    outdir = os.path.join(args.session_name, "training_eval")
    os.makedirs(outdir, exist_ok=True)
    bs = 8
    for i in range(0, len(names), bs):
        chunk = names[i: i + bs]
        imgs = [Image.open(get_img_path(n, args.voc12_root)).convert("RGB") for n in chunk]
        for rec in engine.run_batch(imgs, chunk, [labels[n] for n in chunk]):
            np.save(os.path.join(outdir, rec["name"] + ".npy"), rec["sgc"])
    gt = os.path.join(args.voc12_root, "SegmentationClass")
    results = threshold_sweep(outdir, gt, names, np.arange(0.20, 0.52, 0.02))
    return max(r["mIoU"] for r in results)


if __name__ == "__main__":
    main()
