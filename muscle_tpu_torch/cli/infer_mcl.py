"""CAM generation CLI (port of ``muscle_tpu/cli/infer_mcl.py``, same flags,
plus --fuse_mbconv and --device).

Writes {class_idx: (H, W) float16} npy dicts of the SGC maps into
<out_npy>_sgc/ (and the raw CAMs into <out_npy>/ with --save_cam 1), and
last one JSON line of the run's numbers (``common.RunStats``: images,
seconds, images/s, backbone forwards, MBConv kernel launches).

The stride-1 MBConv blocks run through the MBConv CUDA kernel by default
(--fuse_mbconv 384), where the JAX CLI never fuses.

Data parallel, one rank per card, as the JAX CLI shards each batch over
all local chips::

    torchrun --nproc_per_node=<cards> -m muscle_tpu_torch.cli.infer_mcl ...

Each rank runs its own engine (and the MBConv kernel on its card) on its
rows of every --batch_size batch and writes its images' files.

Spatial sharding, as the JAX CLI's --spatial k: under torchrun with W
ranks, a multiple of k, the ranks form a (W / k data) x (k model) mesh
(``parallel.make_mesh``) and every rank hands the engine the whole
--batch_size batch.  The engine splits it over the data axis (each model
group, k consecutive ranks, runs its data row's share, a batch the rows do
not divide whole) and each canvas's height over the group's ranks (halo
exchanges, ``parallel/spatial.py``), and returns the whole batch's records
on every rank; each image's files are written once, by the first rank of
the model group that ran it (``common.written_rows``)::

    torchrun --nproc_per_node=<cards> -m muscle_tpu_torch.cli.infer_mcl --spatial 2 ...

Every rank prints its own last JSON line, with its MBConv launches and
its exchanges.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from muscle_tpu_torch.cli.common import (
    RunStats,
    add_voc_args,
    load_lists,
    load_model_state,
    prefetch_chunks,
    sort_by_orientation,
    spatial_summary,
    written_rows,
)
from muscle_tpu_torch.data.voc12 import get_img_path


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--infer_list", default="data/train.txt", type=str)
    p.add_argument("--out_npy", default=None, type=str)
    p.add_argument("--save_cam", default=0, type=int, help="also save raw CAM dicts")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--scales", default="0.5,1,1.5,2", type=str)
    p.add_argument("--backbone", default="efficientnet-b3", type=str,
                   help="reference uses b3; smaller variants for smoke runs")
    p.add_argument("--exact", default=0, type=int,
                   help="shape-grouped unpadded TTA (parity mode)")
    p.add_argument("--fast", default=1, type=int,
                   help="1 = fast mode (K-class gather, stride-4 fusion grid + uint8 "
                        "download, tight ycbcr420 upload); 0 = full-res f16")
    p.add_argument("--spatial", default=0, type=int,
                   help="k > 1: split each image's height over k ranks (torchrun with a "
                        "multiple of k ranks: a (ranks / k data) x (k model) mesh; k in 2, 4, "
                        "8, 16; the device path only); 0 and 1: one engine per rank on its "
                        "rows of every batch")
    p.add_argument("--fuse_mbconv", default=384, type=int,
                   help="run stride-1 MBConv blocks with <= N input channels through the "
                        "MBConv CUDA kernel (384 = all of b3's, the default; 0 = none).  "
                        "The JAX CLI never fuses: its Pallas kernel lost to XLA on the "
                        "TPU, while on an H100 the CUDA kernel pays (50.4 against 31.4 "
                        "images/s at --fast 1, chip_smoke.py, PERF.md)")
    p.add_argument("--device", default="cuda", type=str, help="cuda or cpu")
    add_voc_args(p)
    args = p.parse_args(argv)

    from PIL import Image

    from muscle_tpu_torch.inference import CamTTAEngine
    from muscle_tpu_torch.models import MuSCLe
    from muscle_tpu_torch.parallel import init_from_env, make_mesh, rank, shutdown

    group, device = init_from_env(args.device)
    mesh = make_mesh(model_axis=args.spatial) if args.spatial > 1 else None
    # under a mesh the engine splits the global batch; else each rank loads its rows
    rows_group = group if mesh is None else None

    model = MuSCLe(num_classes=args.num_classes, backbone_name=args.backbone,
                   bifpn_layers=3, mode="enc", last_pooling=False,
                   fuse_mbconv=args.fuse_mbconv)
    load_model_state(args.weights, model)
    scales = tuple(float(s) for s in args.scales.split(","))
    fast = dict(accum_stride=4, download_dtype="uint8", tight_upload=True,
                upload_mode="ycbcr420")
    engine = CamTTAEngine(
        model, scales=scales, num_classes=args.num_classes,
        return_cam=bool(args.save_cam), device=device, mesh=mesh,
        shard_spatial=mesh is not None, **(fast if args.fast and not args.exact else {}),
    )

    names, labels = load_lists(args, args.infer_list)
    if args.fast and not args.exact:
        names = sort_by_orientation(names, args.voc12_root)
    if args.out_npy:
        os.makedirs(args.out_npy + "_sgc", exist_ok=True)
        if args.save_cam:
            os.makedirs(args.out_npy, exist_ok=True)

    def save(records):
        for rec in records[written_rows(mesh, len(records))]:
            if args.out_npy:
                np.save(os.path.join(args.out_npy + "_sgc", rec["name"] + ".npy"), rec["sgc"])
                if args.save_cam:
                    np.save(os.path.join(args.out_npy, rec["name"] + ".npy"), rec["cam"])

    def load(chunk):
        return [Image.open(get_img_path(n, args.voc12_root)).convert("RGB") for n in chunk]

    stats = RunStats(model.backbone, engine.device)
    done, tag = 0, f"rank {rank(group)}: " if group is not None else ""
    if args.exact:
        for chunk, imgs in prefetch_chunks(names, args.batch_size, load, group=rows_group):
            save(engine.run_batch_exact(imgs, chunk, [labels[n] for n in chunk]))
            done += len(chunk)
            stats.tick(done)
            print(f"{tag}{done}/{len(names)}")
    else:
        def batches():
            for chunk, imgs in prefetch_chunks(names, args.batch_size, load, group=rows_group):
                yield imgs, chunk, [labels[n] for n in chunk]

        for records in engine.run_stream(batches()):
            save(records)
            done += len(records)
            stats.tick(done)
            print(f"{tag}{done}/{len(names)}")
    shutdown(group)
    return stats.summary(done, **spatial_summary(mesh, engine))


if __name__ == "__main__":
    main()
