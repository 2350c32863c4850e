"""Segmentation inference CLI (port of ``muscle_tpu/cli/infer_seg.py``, same
flags without --spatial, plus --fuse_mbconv and --device): 6-scale x flip
TTA with MuSCLe in dec mode, optional class gating and dense CRF, argmax
PNGs into --out_seg, and last one JSON line of the run's numbers
(``common.RunStats``, with the CRF's ms per image).

Data parallel, one rank per card (``torchrun --nproc_per_node=<cards> -m
muscle_tpu_torch.cli.infer_seg ...``): each rank runs its own engine (the
MBConv kernel on its card) on its rows of every --batch_size batch and
writes its images' PNGs.  --spatial (one image's height over several
cards) is not ported.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from muscle_tpu_torch.cli.common import (
    RunStats,
    add_voc_args,
    load_lists,
    load_model_state,
    prefetch_chunks,
    sort_by_orientation,
)
from muscle_tpu_torch.data.voc12 import get_img_path


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--infer_list", default="data/val.txt", type=str)
    p.add_argument("--cls_dir", default=None, type=str)
    p.add_argument("--out_seg", default=None, type=str)
    p.add_argument("--crf", default=1, type=int)
    p.add_argument("--crf_backend", default="xla", choices=["xla", "native"], type=str,
                   help="xla = the mean-field CRF on the device (ops/crf.py); native = "
                        "the exact permutohedral CRF on the CPU (ops/exact_crf.py)")
    p.add_argument("--bifpn", default=3, type=int)
    p.add_argument("--pretrained", default="b7", type=str)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--fast", default=1, type=int,
                   help="1 = fast mode (stride-4 prob grid + f16 download + tight ycbcr420 "
                        "upload + overlapped stream); 0 = full-res f32 mode")
    p.add_argument("--spatial", default=0, type=int,
                   help="sharding image height over several devices: not ported (0 only; "
                        "torchrun shards the batch over cards)")
    p.add_argument("--fuse_mbconv", default=384, type=int,
                   help="run stride-1 MBConv blocks with <= N input channels through the "
                        "MBConv CUDA kernel (0 = none; 384 = all of b7's)")
    p.add_argument("--device", default="cuda", type=str, help="cuda or cpu")
    add_voc_args(p)
    args = p.parse_args(argv)
    if args.spatial > 1:
        raise NotImplementedError("--spatial (height sharding over several devices) is not "
                                  "ported: launch with torchrun --nproc_per_node=<cards> to "
                                  "shard each batch over the cards (ROADMAP Queue A item 7)")

    import torch
    from PIL import Image

    from muscle_tpu_torch.inference import SegTTAEngine
    from muscle_tpu_torch.models import MuSCLe
    from muscle_tpu_torch.ops.crf import mean_field_crf
    from muscle_tpu_torch.parallel import init_from_env, rank, shutdown

    group, device = init_from_env(args.device)

    model = MuSCLe(num_classes=args.num_classes, backbone_name="efficientnet-" + args.pretrained,
                   bifpn_layers=args.bifpn, mode="dec", last_pooling=True,
                   fuse_mbconv=args.fuse_mbconv)
    load_model_state(args.weights, model)
    fast = dict(accum_stride=4, download_dtype="float16", tight_upload=True,
                upload_mode="ycbcr420")
    # no CRF and no class gating: nothing downstream needs probabilities, so
    # the engine resizes and takes the argmax on the device and downloads
    # one uint8 label map per image
    labels_out = bool(args.fast) and not args.crf and not args.cls_dir
    engine = SegTTAEngine(model, num_classes=args.num_classes, device=device,
                          output="labels" if labels_out else "probs",
                          **(fast if args.fast else {}))

    names, _ = load_lists(args, args.infer_list)
    if args.fast:
        names = sort_by_orientation(names, args.voc12_root)
    if args.out_seg:
        os.makedirs(args.out_seg, exist_ok=True)

    def save(name, pred):
        if args.out_seg:
            Image.fromarray(pred).save(os.path.join(args.out_seg, name + ".png"))

    crf_s = [0.0]

    def postprocess(imgs, records):
        for img, rec in zip(imgs, records):
            if labels_out:
                save(rec["name"], rec["label"])
                continue
            probs = rec["probs"]
            if args.crf:
                t0 = time.perf_counter()  # the .cpu() below waits for the card
                orig = np.array(img)
                if args.crf_backend == "native":
                    from muscle_tpu_torch.ops.exact_crf import dense_crf

                    probs = dense_crf(orig, probs.transpose(2, 0, 1), t=4).transpose(1, 2, 0)
                else:
                    probs = mean_field_crf(torch.from_numpy(probs).to(engine.device),
                                           torch.from_numpy(orig).to(engine.device),
                                           t=4).cpu().numpy()
                crf_s[0] += time.perf_counter() - t0
            save(rec["name"], np.argmax(probs, axis=-1).astype(np.uint8))

    def load(chunk):
        imgs = [Image.open(get_img_path(n, args.voc12_root)).convert("RGB") for n in chunk]
        gates = None
        if args.cls_dir:
            gates = [np.load(os.path.join(args.cls_dir, n + ".npy"), allow_pickle=True).squeeze()
                     for n in chunk]
        return imgs, gates

    stats = RunStats(model.backbone, engine.device)
    done, tag = 0, f"rank {rank(group)}: " if group is not None else ""
    if args.fast:
        img_fifo = []

        def batches():
            for chunk, (imgs, gates) in prefetch_chunks(names, args.batch_size, load,
                                                        group=group):
                img_fifo.append(imgs)
                yield imgs, chunk, gates

        for records in engine.run_stream(batches()):
            postprocess(img_fifo.pop(0), records)
            done += len(records)
            stats.tick(done)
            print(f"{tag}{done}/{len(names)}")
    else:
        for chunk, (imgs, gates) in prefetch_chunks(names, args.batch_size, load, group=group):
            postprocess(imgs, engine.run_batch(imgs, chunk, gates))
            done += len(chunk)
            stats.tick(done)
            print(f"{tag}{done}/{len(names)}")
    shutdown(group)
    return stats.summary(done, crf_ms_per_image=1e3 * crf_s[0] / done
                         if args.crf and not labels_out and done else None)


if __name__ == "__main__":
    main()
