"""Standalone mIoU evaluation CLI (port of ``muscle_tpu/cli/evaluate.py``,
same flags): png or npy predictions, optional bg-threshold curve."""

from __future__ import annotations

import argparse

import numpy as np

from muscle_tpu_torch.data.voc12 import load_img_name_list
from muscle_tpu_torch.evaluation.miou import evaluate_folder, threshold_sweep, write_log


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--list", required=True, type=str)
    p.add_argument("--predict_dir", required=True, type=str)
    p.add_argument("--gt_dir", required=True, type=str)
    p.add_argument("--logfile", default="./evallog.txt", type=str)
    p.add_argument("--comment", required=True, type=str)
    p.add_argument("--type", default="npy", choices=["npy", "png"], type=str)
    p.add_argument("--t", default=None, type=float)
    p.add_argument("--curve", default=False, type=bool)
    args = p.parse_args(argv)

    name_list = load_img_name_list(args.list)
    if not args.curve:
        loglist = evaluate_folder(args.predict_dir, args.gt_dir, name_list, 21, args.type,
                                  args.t)
        for k, v in loglist.items():
            if isinstance(v, float):
                print(f"{k:>11s}: {v:7.3f}%")
        write_log(args.logfile, loglist, args.comment)
    else:
        results = threshold_sweep(args.predict_dir, args.gt_dir, name_list,
                                  np.arange(60) / 100.0)
        mious = [r["mIoU"] for r in results]
        for i, m in enumerate(mious):
            print(f"{i}/60 background score: {i / 100.0:.3f}\tmIoU: {m:.3f}%")
        write_log(args.logfile, {"mIoU": mious}, args.comment)


if __name__ == "__main__":
    main()
