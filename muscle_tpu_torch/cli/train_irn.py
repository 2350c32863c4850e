"""IRN training CLI (port of ``muscle_tpu/cli/train_irn.py``: its flags,
plus --device): trains the edge and displacement heads of ``IRNNet`` on
affinity targets from pseudo-label PNGs (``cam_to_label``'s), with the
ResNet-50 frozen.  The reference ships the losses but no training script.

Recipe: SGD with momentum 0.9, L2 decay --wt_dec on the heads only, the
learning rate --lr poly-decayed (power 0.9) to 0 over the run's steps.
The JAX package's CLI fixes its learning rate at 1 and decays the frozen
backbone too (ROADMAP Queue C); the port follows the recipe.  Writes
``model_<ep>.pth`` (the reference's IRN keys: ``infer_irn
--irn_weights_name`` loads it) and ``step_<ep>.pt`` per epoch.  float32
with TF32 off.  Randomly initialised from --seed by ``init_weights``
(batch norms with random statistics), not by the JAX CLI's Flax defaults
(identity norms); like the JAX CLI it loads no pretrained backbone, so
the heads train on a random frozen ResNet-50 (ROADMAP Queue C).

Data parallel, one rank per card (``torchrun --nproc_per_node=<cards> -m
muscle_tpu_torch.cli.train_irn ...``): ``--batch_size`` is the global
batch, W ranks compute the one-process step on it (the mask sums over the
global batch), and rank 0 writes the checkpoints and the log.
"""

from __future__ import annotations

import argparse
import os

from muscle_tpu_torch.cli.common import add_voc_args, load_lists, train_ranks


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--max_epoches", default=3, type=int)
    p.add_argument("--lr", default=1e-1, type=float)
    p.add_argument("--wt_dec", default=1e-4, type=float)
    p.add_argument("--train_list", default="data/train_aug.txt", type=str)
    p.add_argument("--pseudo_label_root", required=True, type=str,
                   help="directory of pseudo-label PNGs (e.g. from cam_to_label)")
    p.add_argument("--session_name", default="runs/irn", type=str)
    p.add_argument("--crop_size", default=512, type=int)
    p.add_argument("--device_norm", default=1, type=int,
                   help="1 = uint8 image and 0/1 uint8 affinity masks decoded on the "
                        "device; 0 = float32")
    p.add_argument("--upload", default="ycbcr420", choices=["rgb", "ycbcr420"],
                   help="with --device_norm 1: 'ycbcr420' ships luma + 2x2-subsampled "
                        "chroma (half the bytes), 'rgb' uint8 RGB")
    p.add_argument("--pack_bits", default=1, type=int,
                   help="ship the 0/1 affinity masks 8 pairs a byte, unpacked on the "
                        "device (exact); ignored with --device_norm 0")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", type=str, help="cuda or cpu")
    add_voc_args(p)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import torch

    from muscle_tpu_torch.data.loader import PrefetchLoader
    from muscle_tpu_torch.data.voc12 import VOC12AffinityDataset
    from muscle_tpu_torch.inference.upload import to_device
    from muscle_tpu_torch.models import IRNNet, init_weights
    from muscle_tpu_torch.parallel import per_rank_batch, rank, replicate, shutdown, world
    from muscle_tpu_torch.training import (
        IRNTrainConfig,
        irn_train_step,
        make_irn_sgd,
        poly_schedule,
        save_checkpoint,
        set_learning_rate,
    )
    from muscle_tpu_torch.utils import Timer

    group, device = train_ranks(args.device)
    per_rank_batch(args.batch_size, group)
    lead = rank(group) == 0
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names, labels = load_lists(args, args.train_list)
    dataset = VOC12AffinityDataset(
        names, args.voc12_root, labels, args.pseudo_label_root, crop_size=args.crop_size,
        device_norm=bool(args.device_norm),
        upload=args.upload if args.device_norm else "rgb",
        pack_bits=bool(args.pack_bits and args.device_norm))
    loader = PrefetchLoader(dataset, args.batch_size, seed=args.seed,
                            num_threads=args.num_workers, rank=(rank(group), world(group)))

    model = init_weights(IRNNet(), torch.Generator().manual_seed(args.seed)).to(device)
    replicate(model, group)
    opt = make_irn_sgd(model, args.lr, args.wt_dec)
    steps_total = max(len(names) // args.batch_size, 1) * args.max_epoches
    lr_at = poly_schedule(args.lr, steps_total, power=0.9)
    cfg = IRNTrainConfig(crop_size=args.crop_size)
    os.makedirs(args.session_name, exist_ok=True)
    timer = Timer()
    step = 0

    for ep in range(args.max_epoches):
        for it, batch in enumerate(loader.epoch(ep)):
            set_learning_rate(opt, lr_at(step))
            metrics = irn_train_step(model, opt, {k: to_device(v, device)
                                                  for k, v in batch.items()}, cfg, group)
            step += 1
            if lead and it % 25 == 0:
                vals = {k: float(v) for k, v in metrics.items()}
                ips = (it + 1) * args.batch_size / timer.stage_elapsed()
                print(f"ep {ep} it {it} " + " ".join(f"{k}:{v:.4f}" for k, v in vals.items())
                      + f" imps:{ips:.1f} lr:{opt.param_groups[0]['lr']:.6f}", flush=True)
        if lead:
            save_checkpoint(args.session_name, model, opt, step, ep)
        timer.reset_stage()
    shutdown(group)


if __name__ == "__main__":
    main()
