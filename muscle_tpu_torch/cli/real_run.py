"""One-command real-asset parity runner (port of
``muscle_tpu/cli/real_run.py``: its flags, with --device for --platform,
plus --reference_root for the gates stage).

The day real VOC2012 + the published .pth checkpoints are on disk (or a
URL), this runs the whole acceptance chain unattended and writes ONE
report:

    python -m muscle_tpu_torch.cli.real_run \
        --voc12_root data/VOC2012 --list data/val.txt \
        --cls_labels data/cls_labels.npy \
        --mcl_weights <url|path> --seg_weights <url|path> \
        [--irn_weights <url|path>] --reference_root <reference checkout> \
        --out_dir out/real_run

Stages (select with --stages):
  gates     all fidelity gates vs the reference oracle on the SAME weights
            (muscle_tpu_torch.cli.gates, real mode)
  seg       full seg inference (TTA + CRF + argmax PNGs) with the seg
            checkpoint (muscle_tpu_torch.cli.infer_seg); the report adds
            its images/s, the CRF's ms per image, the backbone forwards
            and the MBConv kernel's launches
  eval      VOC mIoU of the seg PNGs vs SegmentationClass GT

Writes <out_dir>/real_run_report.json and <out_dir>/real_run.log.  The
seg and eval stages rehearse on a synthetic tree
(``gates.build_synthetic_voc``) with a random local checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--voc12_root", required=True, type=str)
    p.add_argument("--list", dest="list_path", required=True, type=str)
    p.add_argument("--cls_labels", required=True, type=str)
    p.add_argument("--mcl_weights", default=None, type=str,
                   help=".pth or URL — enc (CAM) checkpoint for the gates")
    p.add_argument("--seg_weights", default=None, type=str,
                   help=".pth or URL — dec checkpoint for gates + seg stage")
    p.add_argument("--irn_weights", default=None, type=str)
    p.add_argument("--out_dir", default="out/real_run", type=str)
    p.add_argument("--stages", default="gates,seg,eval", type=str)
    p.add_argument("--backbone", default="efficientnet-b3", type=str,
                   help="gates oracle backbone (reference MCL: b3)")
    p.add_argument("--seg_backbone", default="b7", type=str,
                   help="seg-stage backbone suffix (reference: b7)")
    p.add_argument("--bifpn", default=3, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--crf", default=1, type=int)
    p.add_argument("--crf_backend", default="xla", choices=["xla", "native"], type=str,
                   help="xla = the mean-field CRF on the device; native = the exact "
                        "permutohedral CRF on the CPU")
    p.add_argument("--quick", action="store_true",
                   help="pro-rated quick gate tier (regression canary)")
    p.add_argument("--quick_budget", default=None, type=float,
                   help="override the quick tier's wall budget (seconds), e.g. for "
                        "rehearsals on loaded hosts where wall time measures contention, "
                        "not the harness")
    p.add_argument("--gates", default="1,1f,2,2e,3,4,5,6,7,7e,t", type=str)
    p.add_argument("--scales", default="0.5,1.0,1.5,2.0", type=str)
    p.add_argument("--seg_scales", default="0.75,1.0,1.5", type=str)
    p.add_argument("--reference_root", default=None, type=str,
                   help="the PyTorch reference tree, for the gates stage's oracle gates")
    p.add_argument("--device", default="cuda", type=str, help="cuda or cpu")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    log_path = os.path.join(args.out_dir, "real_run.log")
    report: dict = {"stages": {}, "argv": argv}
    t_all = time.time()

    def log(msg: str) -> None:
        line = f"[real_run +{time.time() - t_all:6.0f}s] {msg}"
        print(line, flush=True)
        with open(log_path, "a") as f:
            f.write(line + "\n")

    from muscle_tpu_torch.cli.common import fetch_weights

    weights = {}
    for a in ("mcl_weights", "seg_weights", "irn_weights"):
        src = getattr(args, a)
        if src:
            log(f"fetch {a}: {src}")
            weights[a] = fetch_weights(src)
            log(f"fetch {a} -> {weights[a]} "
                f"({os.path.getsize(weights[a])} bytes)")
        else:
            weights[a] = None
    report["weights"] = dict(weights)

    stages = [s.strip() for s in args.stages.split(",") if s.strip()]

    if "gates" in stages:
        from muscle_tpu_torch.cli import gates as gates_cli

        gates_out = os.path.join(args.out_dir, "gates")
        gv = ["--voc12_root", args.voc12_root, "--list", args.list_path,
              "--cls_labels", args.cls_labels, "--out_dir", gates_out,
              "--backbone", args.backbone, "--gates", args.gates,
              "--scales", args.scales, "--seg_scales", args.seg_scales,
              "--device", args.device]
        for a in ("mcl_weights", "seg_weights", "irn_weights"):
            if weights[a]:
                gv += [f"--{a}", weights[a]]
        if args.reference_root:
            gv += ["--reference_root", args.reference_root]
        if args.quick:
            gv += ["--quick"]
        if args.quick_budget is not None:
            gv += ["--quick_budget", str(args.quick_budget)]
        log(f"stage gates: muscle_tpu_torch.cli.gates {' '.join(gv)}")
        t0 = time.time()
        gates_cli.main(gv)
        with open(os.path.join(gates_out, "gates_report.json")) as f:
            rows = json.load(f)
        n_pass = sum(1 for r in rows if r["passed"])
        report["stages"]["gates"] = {
            "passed": n_pass, "total": len(rows),
            "all_passed": n_pass == len(rows),
            "report": os.path.join(gates_out, "gates_report.json"),
            "seconds": round(time.time() - t0, 1),
        }
        log(f"stage gates done: {n_pass}/{len(rows)} passed")

    if "seg" in stages:
        if not weights["seg_weights"]:
            raise SystemExit("stage seg requires --seg_weights")
        from muscle_tpu_torch.cli import infer_seg

        seg_out = os.path.join(args.out_dir, "seg")
        sv = ["--weights", weights["seg_weights"],
              "--infer_list", args.list_path,
              "--voc12_root", args.voc12_root,
              "--cls_labels", args.cls_labels,
              "--out_seg", seg_out,
              "--bifpn", str(args.bifpn),
              "--pretrained", args.seg_backbone,
              "--batch_size", str(args.batch_size),
              "--crf", str(args.crf), "--crf_backend", args.crf_backend,
              "--device", args.device]
        log(f"stage seg: muscle_tpu_torch.cli.infer_seg {' '.join(sv)}")
        t0 = time.time()
        run = infer_seg.main(sv)
        n_png = len([f for f in os.listdir(seg_out) if f.endswith(".png")])
        report["stages"]["seg"] = {
            "pngs": n_png, "out": seg_out,
            "seconds": round(time.time() - t0, 1),
            **{k: run[k] for k in ("images_per_s", "first_batch_seconds",
                                   "images_per_s_after_first", "crf_ms_per_image",
                                   "backbone_forwards", "mbconv_launches",
                                   "mbconv_launches_bf16")},
        }
        log(f"stage seg done: {n_png} PNGs")

    if "eval" in stages:
        from muscle_tpu_torch.data.voc12 import load_img_name_list
        from muscle_tpu_torch.evaluation import evaluate_folder
        from muscle_tpu_torch.evaluation.miou import write_log

        seg_out = os.path.join(args.out_dir, "seg")
        gt_dir = os.path.join(args.voc12_root, "SegmentationClass")
        names = load_img_name_list(args.list_path)
        log(f"stage eval: {len(names)} images, {seg_out} vs {gt_dir}")
        t0 = time.time()
        loglist = evaluate_folder(seg_out, gt_dir, names, 21, "png", None)
        write_log(os.path.join(args.out_dir, "evallog.txt"), loglist, "real_run")
        miou = float(loglist["mIoU"])
        report["stages"]["eval"] = {
            "mIoU": round(miou, 4),
            "seconds": round(time.time() - t0, 1),
        }
        log(f"stage eval done: mIoU {miou:.4f}")

    report["seconds"] = round(time.time() - t_all, 1)
    out_path = os.path.join(args.out_dir, "real_run_report.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    log(f"report -> {out_path}")
    print(json.dumps(report["stages"]), flush=True)
    return report


if __name__ == "__main__":
    main()
