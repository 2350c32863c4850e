#!/usr/bin/env python3
"""Drive the PyTorch port's CAM-generation path on one CUDA card.

    python3 chip_smoke.py            # every phase, the full check
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,profile   # where the device time goes

Phases:
  build    compile every CUDA kernel of the path from the checkout
           (nvcc, sm_90a) and print the build seconds;
  kernels  hold each kernel against its plain PyTorch version at the b3
           CAM shapes (VOC 500x375 image, TTA scales 1 and 2, B = 16),
           with and without windows, and time both;
  main     run CamTTAEngine over synthetic VOC-shaped images at scales
           0.5/1/1.5/2 with MuSCLe-b3 (fuse_mbconv=384, float32, seeded
           random weights), count the kernel launches, and hold the
           results against the same engine with the plain blocks; then
           the same for the --fast 1 configuration;
  profile  (not run by default) device time by kernel name over two
           --fast 0 batches, with and without the kernel, and the
           device's busy share of the wall time.

Prints the card's name and power limit, one JSON line per kernel shape,
a {"kernels": [...]} summary line, and last the result line
{"ok": true, "device": {...}}.  Exits non-zero, with no result line,
when there is no CUDA card, when the port is not beside this script, or
when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# b3 stride-1 blocks to check: name -> (stride of the block's input grid,
# Cin, Cout, expand ratio, k)
B3_BLOCKS = {
    "_blocks_0": (2, 40, 24, 1, 3),
    "_blocks_1": (2, 24, 24, 1, 3),
    "_blocks_3": (4, 32, 32, 6, 3),
    "_blocks_6": (8, 48, 48, 6, 5),
    "_blocks_9": (16, 96, 96, 6, 3),
    "_blocks_13": (16, 96, 136, 6, 5),
    "_blocks_14": (16, 136, 136, 6, 5),
    "_blocks_18": (16, 136, 232, 6, 5),
    "_blocks_19": (16, 232, 232, 6, 5),
    "_blocks_24": (16, 232, 384, 6, 3),
    "_blocks_25": (16, 384, 384, 6, 3),
}
VOC_HW = (375, 500)
TTA_BATCH = 16  # 8 images x (orig, flip)
KERNEL_TOL = 1e-4  # f32 kernel vs f32 plain: summation order only
SCORE_TOL, SGC_TOL = 1e-4, 5e-3  # the JAX package's engine bounds
KERNEL_REPS = 10  # timed launches per kernel shape, after one warm-up
MAIN_BATCHES = 4  # timed TTA batches of 8 images per engine
FLIP_TOL = 0.01  # share of a map's pixels whose pre-normalisation zeroing may flip


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> float:
    from muscle_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build_all(["mbconv"])
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                log(f"[nvcc {name}] {line.strip()}")
    print(f"build: {secs:.1f} s")
    return secs


def _random_block(cin, cout, expand, k, gen, device):
    import torch

    from muscle_tpu_torch.models.efficientnet import BlockArgs, MBConvBlock
    from muscle_tpu_torch.models.muscle import init_weights

    block = MBConvBlock(BlockArgs(k, 1, cin, cout, expand, 1))
    init_weights(block, gen)
    return block.eval().to(device)


def _windows(stride: int, scale: float, device):
    """(B, 4) windows of the TTA batch at a block's grid: images of
    500x375 and 400x300, scaled, through the floor chain."""
    import torch

    rows = []
    for i in range(TTA_BATCH // 2):
        h, w = VOC_HW if i % 2 == 0 else (300, 400)
        h, w = round(h * scale), round(w * scale)
        rows += [[0, 0, h // stride, w // stride]] * 2
    return torch.tensor(rows, dtype=torch.int32, device=device)


def phase_kernels() -> dict:
    import torch

    from muscle_tpu_torch.inference.cam import _batch_canvas
    from muscle_tpu_torch.ops import mbconv as M

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    xgen = torch.Generator(device=dev).manual_seed(0)
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0, "max_abs_err": 0.0}
    for name, (stride, cin, cout, expand, k) in B3_BLOCKS.items():
        block = _random_block(cin, cout, expand, k, gen, dev)
        wd = block.fused_weights()
        cmid, csq = cin * expand, wd["w_se_r"].shape[1]
        kw = dict(k=k, has_expand=expand != 1, has_skip=cin == cout)
        for scale in (1.0, 2.0):
            ch, cw = _batch_canvas(scale, [VOC_HW] * 8, 500)
            h, w = ch // stride, cw // stride
            x = torch.randn((TTA_BATCH, h, w, cin), generator=xgen, device=dev)
            for windowed in (False, True):
                win = _windows(stride, scale, dev) if windowed else None
                before = M.mbconv_stride1.launches
                with torch.inference_mode():
                    got = M.mbconv_stride1(x, wd, win, **kw)
                    want = M.mbconv_stride1_plain(x, wd, win, **kw)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    ms = time_ms(lambda: M.mbconv_stride1(x, wd, win, **kw), KERNEL_REPS)
                    plain_ms = time_ms(lambda: M.mbconv_stride1_plain(x, wd, win, **kw),
                                       KERNEL_REPS)
                work = M.block_work(TTA_BATCH, h, w, cin, cmid, csq, cout, k, expand != 1)
                bound, by = M.bound_ms(*work)
                rec = {"kernel": "mbconv_stride1", "block": name, "scale": scale,
                       "windowed": windowed, "B": TTA_BATCH, "H": h, "W": w, "Cin": cin,
                       "Cmid": cmid, "Cout": cout, "k": k, "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "launches": M.mbconv_stride1.launches - before}
                print(json.dumps(rec), flush=True)
                if not err <= KERNEL_TOL:
                    raise AssertionError(f"{name} scale {scale} windowed={windowed}: "
                                         f"max_abs_err {err} > {KERNEL_TOL}")
                if windowed:  # the main path's calls are windowed
                    total["ms"] += ms
                    total["plain_ms"] += plain_ms
                    total["bytes"] += work[0]
                    total["flops"] += work[1]
                total["max_abs_err"] = max(total["max_abs_err"], err)
            del x
    return total


def _images(n_batches: int, seed: int):
    """Orientation-homogeneous batches of 8 synthetic VOC-shaped images
    (HWC uint8), labels and names."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        hw = VOC_HW if i % 2 == 0 else VOC_HW[::-1]
        yy = np.linspace(0, 1, hw[0])[:, None, None]
        xx = np.linspace(0, 1, hw[1])[None, :, None]
        imgs, labels = [], []
        for j in range(8):
            mix = rng.uniform(0.2, 1.0, size=(2, 3))
            base = 255 * (0.2 + 0.6 * (yy * mix[0] + xx * mix[1]) / 2.0)
            base = base + rng.normal(0, 12, size=(*hw, 3))
            imgs.append(np.clip(base, 0, 255).astype(np.uint8))
            lab = np.zeros(20, np.float32)
            lab[rng.choice(20, size=1 + j % 3, replace=False)] = 1
            labels.append(lab)
        out.append((imgs, [f"b{i}_{j}" for j in range(8)], labels))
    return out


def _run(engine, batches):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [r for rs in engine.run_stream(iter(batches)) for r in rs]
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def _map_err(got, want) -> tuple[float, float, float]:
    """(max |got - want| away from the zeroing, share of pixels whose
    zeroing flipped, relative error of the zeroed value) of two fused maps.

    The reference's fusion zeroes every pixel below min + 1e-6 before the
    min-max normalisation, which sends a zeroed pixel to the map's lowest
    output -(min + 1e-6) / (range + 1e-6) and a pixel just above the
    threshold to ~0: a discontinuity that float noise can flip.  The
    zeroed pixels share that lowest value, so they are found exactly."""
    import numpy as np

    zg, zw = got == got.min(), want == want.min()
    keep = ~(zg | zw)
    err = float(np.abs(got[keep] - want[keep]).max()) if keep.any() else 0.0
    low = float(abs(got.min() - want.min()) / max(abs(float(want.min())), 1.0))
    return err, float((zg != zw).mean()), low


def _compare(got, want, tag: str) -> tuple[float, float]:
    import numpy as np

    score_err = sgc_err = flips = low = 0.0
    for g, w in zip(got, want):
        assert g["name"] == w["name"] and sorted(g["sgc"]) == sorted(w["sgc"]), tag
        score_err = max(score_err, float(np.abs(g["score"] - w["score"]).max()))
        for c in w["sgc"]:
            a, b = g["sgc"][c].astype(np.float32), w["sgc"][c].astype(np.float32)
            assert a.shape == b.shape and np.isfinite(a).all(), tag
            e, f, lo = _map_err(a, b)
            sgc_err, flips, low = max(sgc_err, e), max(flips, f), max(low, lo)
    print(json.dumps({"compare": tag, "score_max_abs_err": score_err,
                      "sgc_max_abs_err": sgc_err, "sgc_zeroing_flip_share": flips,
                      "sgc_zeroed_value_rel_err": low}), flush=True)
    if not (score_err <= SCORE_TOL and sgc_err <= SGC_TOL and flips <= FLIP_TOL
            and low <= 1e-2):
        raise AssertionError(f"{tag}: score err {score_err} (tol {SCORE_TOL}), sgc err "
                             f"{sgc_err} (tol {SGC_TOL}), zeroing flips {flips} (tol "
                             f"{FLIP_TOL}), zeroed value rel err {low} (tol 1e-2)")
    return score_err, sgc_err


def _check_contract(results, batches) -> None:
    import numpy as np

    flat = [(img, lab) for imgs, _, labs in batches for img, lab in zip(imgs, labs)]
    assert len(results) == len(flat)
    for rec, (img, lab) in zip(results, flat):
        assert sorted(rec["sgc"]) == sorted(np.nonzero(lab)[0].tolist())
        for m in rec["sgc"].values():
            assert m.shape == img.shape[:2] and m.dtype == np.float16
            assert np.isfinite(m.astype(np.float32)).all()
        assert rec["score"].shape == (20,) and np.isfinite(rec["score"]).all()


def phase_main(n_batches: int = MAIN_BATCHES) -> dict:
    import torch

    from muscle_tpu_torch.inference import CamTTAEngine
    from muscle_tpu_torch.models import MuSCLe, init_weights
    from muscle_tpu_torch.ops import mbconv as M

    scales = (0.5, 1.0, 1.5, 2.0)
    models = {}
    for fuse in (384, 0):
        m = MuSCLe(backbone_name="efficientnet-b3", mode="enc", last_pooling=False,
                   fuse_mbconv=fuse)
        models[fuse] = init_weights(m, torch.Generator().manual_seed(0))
    warm = _images(2, seed=1)
    batches = _images(n_batches, seed=2)
    out = {}
    configs = {"fast0": {}, "fast1": dict(accum_stride=4, download_dtype="uint8",
                                          tight_upload=True, upload_mode="ycbcr420")}
    for cname, extra in configs.items():
        engines = {f: CamTTAEngine(models[f], scales=scales, return_cam=False, device="cuda",
                                   **extra) for f in models}
        for e in engines.values():
            _run(e, warm)  # cuDNN autotune, allocator warm-up
        M.mbconv_stride1.launches = 0
        fused, fused_s = _run(engines[384], batches)
        launches = M.mbconv_stride1.launches
        want = 23 * len(scales) * n_batches
        if launches != want:
            raise AssertionError(f"{cname}: {launches} kernel launches, want {want} "
                                 "(23 per forward, 4 forwards per batch)")
        plain, plain_s = _run(engines[0], batches)
        _check_contract(fused, batches)
        score_err, sgc_err = _compare(fused, plain, f"{cname} kernel vs plain blocks")
        n_img = 8 * n_batches
        rec = {"config": cname, "images": n_img, "launches": launches,
               "launches_per_batch": launches / n_batches,
               "kernel_images_per_s": n_img / fused_s, "plain_images_per_s": n_img / plain_s,
               "score_max_abs_err": score_err, "sgc_max_abs_err": sgc_err}
        print(json.dumps(rec), flush=True)
        out[cname] = rec
    return out


def phase_profile(n_batches: int) -> None:
    """Where the device time of the --fast 0 main path goes: one
    torch.profiler window over ``n_batches`` batches per engine (kernel
    and plain blocks), device time summed by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from muscle_tpu_torch.inference import CamTTAEngine
    from muscle_tpu_torch.models import MuSCLe, init_weights

    batches = _images(n_batches, seed=3)
    for fuse in (384, 0):
        m = init_weights(MuSCLe(backbone_name="efficientnet-b3", mode="enc",
                                last_pooling=False, fuse_mbconv=fuse),
                         torch.Generator().manual_seed(0))
        engine = CamTTAEngine(m, return_cam=False, device="cuda")
        _run(engine, _images(1, seed=1))
        # device activity only: tracing host ops would slow the dispatch
        # and understate the busy share
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall = _run(engine, batches)
        rows = []  # device-side events only (kernels, copies): no double count
        for evt in prof.key_averages():
            t = getattr(evt, "self_device_time_total", None)
            if t is None:
                t = evt.self_cuda_time_total
            if t > 0 and str(evt.device_type).endswith("CUDA"):
                rows.append((t / 1e3, evt.count, evt.key))
        rows.sort(reverse=True)
        device_ms = sum(r[0] for r in rows)
        ours = sum(r[0] for r in rows if any(
            f"namespace)::{k}" in r[2] for k in ("expand_dw_kernel", "se_kernel",
                                                 "project_kernel")))
        print(json.dumps({
            "profile": f"fast0 fuse_mbconv={fuse}", "batches": n_batches,
            "wall_ms": wall * 1e3, "device_ms": device_ms,
            "device_busy_share": device_ms / (wall * 1e3), "mbconv_kernel_ms": ours,
            "top": [[name[:90], calls, ms] for ms, calls, name in rows[:15]],
        }), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases", default="build,kernels,main")
    args = p.parse_args(argv)
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's kernels run only on the card")
        return 1
    try:
        import muscle_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the port (muscle_tpu_torch) is not beside this script: {e}")
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    if "build" in phases:
        phase_build()
    totals = phase_kernels() if "kernels" in phases else None
    main_out = phase_main() if "main" in phases else None
    if "profile" in phases:
        phase_profile(4)

    if totals is not None:
        from muscle_tpu_torch.ops.mbconv import bound_ms

        bound, by = bound_ms(totals["bytes"], totals["flops"])
        entry = {"name": "mbconv_stride1", "route": "cuda",
                 "source": "muscle_tpu_torch/csrc/mbconv.cu",
                 "replaces": "muscle_tpu/ops/pallas/mbconv.py:299",
                 "launches": main_out["fast0"]["launches"] if main_out else 0,
                 "max_abs_err": totals["max_abs_err"], "ms": totals["ms"],
                 "plain_ms": totals["plain_ms"], "bound_ms": bound, "bound_by": by,
                 "library_ms": None}
        print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
