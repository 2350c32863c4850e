#!/usr/bin/env python3
"""Drive the PyTorch port's CAM-generation and IRN-refinement paths on
one CUDA card.

    python3 chip_smoke.py            # every phase, the full check
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,profile   # where the device time goes

Phases:
  build    compile every CUDA kernel of the paths from the checkout
           (nvcc, sm_90a, one process per source, in parallel) and print
           the build seconds;
  kernels  hold each kernel against its plain PyTorch version and time
           both: the MBConv block at the b3 CAM shapes (VOC 500x375 image,
           TTA scales 1 and 2, B = 16, with and without windows); the
           stencil walk at B = 8, C = 20, 64 steps on the 128/96/64 walk
           grids (the 512/384/256 buckets) and a 375x500 image's own
           94x125 grid; the banded walk at C = 20, 64 steps on grid 64
           (two images) and grid 128 (one image), beside 64 dense
           torch.matmul steps (its library yardstick);
  main     run CamTTAEngine over synthetic VOC-shaped images at scales
           0.5/1/1.5/2 with MuSCLe-b3 (fuse_mbconv=384, float32, seeded
           random weights), count the kernel launches, and hold the
           results against the same engine with the plain blocks; then
           the same for the --fast 1 configuration;
  irn      run RandomWalkRefiner (ResNet-50 EdgeDisplacement, crop 512,
           seeded random weights, fast IO, labels output: the infer_irn
           default) over batches of 8 synthetic VOC-shaped images with
           2-class CAM dicts, with the stencil kernel and with the plain
           walk, counting launches and comparing labels; the scores output
           on one batch; then one batch of 2 with the banded walk;
  profile  (not run by default) device time by kernel name over --fast 0
           CAM batches, with and without the MBConv kernel, and over IRN
           batches with the stencil kernel, and the device's busy share of
           the wall time.

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

# walk kernels: grids (h, w) of the stencil check, the first being the
# main path's (crop 512, stride 4); (grid side, images) of the banded check
STENCIL_GRIDS = ((128, 128), (96, 96), (64, 64), (94, 125))
BANDED_CASES = ((64, 2), (128, 1))
WALK_B, WALK_C, WALK_STEPS = 8, 20, 64
WALK_REPS = 5
# the JAX package's walk bounds: the stencil differs from its plain loop
# in summation order only (relative to the output's scale); the banded walk
# sums per column block (test_banded_walk.py)
STENCIL_RTOL, STENCIL_ATOL = 2e-4, 1e-6
BANDED_RTOL, BANDED_ATOL = 2e-3, 1e-5
# kernel -> (source under muscle_tpu_torch/csrc, the TPU kernel's pallas_call)
KERNEL_SOURCES = {
    "mbconv_stride1": ("mbconv.cu", "muscle_tpu/ops/pallas/mbconv.py:299"),
    "stencil_walk": ("stencil_walk.cu", "muscle_tpu/ops/pallas/stencil_walk.py:102"),
    "banded_walk": ("banded_walk.cu", "muscle_tpu/ops/pallas/banded_walk.py:109"),
}
IRN_BATCHES = 4  # timed refinement batches of 8 images per walk
LABEL_AGREE = 0.999  # labels: kernel and plain walk, argmax ties only
IRN_SCORE_TOL = 1e-3  # f16 scores, kernel and plain walk


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0 (before a path runs)."""
    from muscle_tpu_torch.ops import banded_walk, mbconv, stencil_walk

    mbconv.mbconv_stride1.launches = 0
    stencil_walk.stencil_walk.launches = 0
    banded_walk.banded_walk.launches = 0


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
    logs = build.build_all(["mbconv", "stencil_walk", "banded_walk"])
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


def _check_mbconv() -> dict:
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


def _smooth_edges(b: int, h: int, w: int, gen, device):
    """(B, h, w) edge maps in (0, 1): a seeded low-frequency random field,
    so the affinities span their range instead of being all ~0 or ~1."""
    import torch
    import torch.nn.functional as F

    z = torch.randn((b, 1, 6, 6), generator=gen, device=device)
    z = F.interpolate(z, size=(h, w), mode="bicubic", align_corners=False)[:, 0]
    return torch.sigmoid(2.5 * z - 1.0)


def _check_stencil() -> dict:
    import torch

    from muscle_tpu_torch.ops import random_walk as R
    from muscle_tpu_torch.ops import stencil_walk as S
    from muscle_tpu_torch.ops.mbconv import bound_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for h, w in STENCIL_GRIDS:
        edge = _smooth_edges(WALK_B, h, w, gen, dev)
        cam = torch.rand((WALK_B, WALK_C, h, w), generator=gen, device=dev)
        with torch.inference_mode():
            vs, inv, dirs = R.stencil_operands(edge)
            x = (cam * (1.0 - edge)[:, None]).contiguous()
            kw = dict(dirs=dirs, steps=WALK_STEPS)
            before = S.stencil_walk.launches
            got = S.stencil_walk(x, vs, inv, **kw)
            want = S.stencil_walk_plain(x, vs, inv, **kw)
            torch.cuda.synchronize()
            launches = S.stencil_walk.launches - before
            err = float((got - want).abs().max())
            tol = STENCIL_RTOL * float(want.abs().max()) + STENCIL_ATOL
            ms = time_ms(lambda: S.stencil_walk(x, vs, inv, **kw), WALK_REPS)
            plain_ms = time_ms(lambda: S.stencil_walk_plain(x, vs, inv, **kw), 1)
        bound, by = bound_ms(*S.walk_work(WALK_B, WALK_C, h, w, len(dirs), WALK_STEPS))
        rec = {"kernel": "stencil_walk", "B": WALK_B, "C": WALK_C, "H": h, "W": w,
               "steps": WALK_STEPS, "max_abs_err": err, "tol": tol, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
               "launches": launches}
        print(json.dumps(rec), flush=True)
        if not err <= tol:
            raise AssertionError(f"stencil walk {h}x{w}: max_abs_err {err} > {tol}")
        out[(h, w)] = rec
    return out


def _check_banded() -> dict:
    import torch

    from muscle_tpu_torch.ops import banded_walk as BW
    from muscle_tpu_torch.ops import random_walk as R
    from muscle_tpu_torch.ops.mbconv import bound_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for side, b in BANDED_CASES:
        v, band = side * side, BW.walk_band(side)
        edge = _smooth_edges(b, side, side, gen, dev)
        cam = torch.rand((b, WALK_C, side, side), generator=gen, device=dev)
        kw = dict(steps=WALK_STEPS, band=band)
        with torch.inference_mode():
            trans = R.transition_matrices(edge)
            x = (cam * (1.0 - edge)[:, None]).reshape(b, WALK_C, v).contiguous()
            before = BW.banded_walk.launches
            got = BW.banded_walk(x, trans, **kw)
            want = BW.banded_walk_plain(x, trans, **kw)
            torch.cuda.synchronize()
            launches = BW.banded_walk.launches - before
            err = float((got - want).abs().max())
            excess = float(((got - want).abs() - BANDED_RTOL * want.abs()).max())

            def library():
                y = x
                for _ in range(WALK_STEPS):
                    y = torch.matmul(y, trans)
                return y

            ms = time_ms(lambda: BW.banded_walk(x, trans, **kw), WALK_REPS)
            plain_ms = time_ms(lambda: BW.banded_walk_plain(x, trans, **kw), 1)
            library_ms = time_ms(library, 1)
        bound, by = bound_ms(*BW.walk_work(b, WALK_C, v, band, WALK_STEPS))
        rec = {"kernel": "banded_walk", "B": b, "C": WALK_C, "V": v, "band": band,
               "steps": WALK_STEPS, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
               "launches": launches}
        print(json.dumps(rec), flush=True)
        if not excess <= BANDED_ATOL:
            raise AssertionError(f"banded walk grid {side}: |diff| exceeds rtol "
                                 f"{BANDED_RTOL} * |plain| by {excess} > atol {BANDED_ATOL}")
        out[side] = rec
        del trans
    return out


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the summaries the
    {"kernels": ...} line reports, at the main paths' shapes."""
    from muscle_tpu_torch.ops.mbconv import bound_ms

    mb = _check_mbconv()
    bound, by = bound_ms(mb["bytes"], mb["flops"])
    stencil = _check_stencil()[STENCIL_GRIDS[0]]
    banded = _check_banded()[BANDED_CASES[-1][0]]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "mbconv_stride1": {"max_abs_err": mb["max_abs_err"], "ms": mb["ms"],
                           "plain_ms": mb["plain_ms"], "bound_ms": bound, "bound_by": by,
                           "library_ms": None},
        "stencil_walk": {k: stencil[k] for k in keys},
        "banded_walk": {k: banded[k] for k in keys},
    }


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
        _zero_counts()
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


def _irn_model():
    """EdgeDisplacement at crop 512 with seeded random weights (batch norms
    near the identity with random statistics).  The edge head's weights
    are scaled by 4 and its bias set to -4 so the random edge map spans
    (0, 1) with median ~0.24 instead of sitting near 0.65, where the
    affinities (1 - e)^8 would all be ~1e-4 and the walk trivial."""
    import torch

    from muscle_tpu_torch.models import EdgeDisplacement, init_weights

    model = init_weights(EdgeDisplacement(crop_size=512), torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.fc_edge6.weight.mul_(4.0)
        model.fc_edge6.bias.fill_(-4.0)
    return model


def _irn_batches(n_batches: int, seed: int, per_batch: int = 8):
    """Orientation-homogeneous batches of synthetic VOC-shaped images, each
    with a CAM dict of 2 classes: smooth f16 bumps at random centres."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i, (imgs, _, _) in enumerate(_images(n_batches, seed)):
        h, w = imgs[0].shape[:2]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        dicts = []
        for j in range(per_batch):
            d = {}
            for cls in ((i + j) % 20, (i + j + 7) % 20):
                cy, cx = rng.uniform(0, h), rng.uniform(0, w)
                s = rng.uniform(0.15, 0.4) * min(h, w)
                bump = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
                d[cls] = (bump + rng.uniform(0, 0.05, (h, w))).astype(np.float16)
            dicts.append(d)
        out.append((imgs[:per_batch], dicts))
    return out


def _refine(refiner, batches):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [r for imgs, dicts in batches for r in refiner.refine_batch(imgs, dicts)]
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def _labels_agreement(got, want, batches) -> float:
    import numpy as np

    flat = [(img, d) for imgs, dicts in batches for img, d in zip(imgs, dicts)]
    assert len(got) == len(want) == len(flat)
    agree = 1.0
    for g, w, (img, d) in zip(got, want, flat):
        assert g.shape == w.shape == img.shape[:2] and g.dtype == w.dtype == np.uint8
        assert set(np.unique(g).tolist()) <= {0} | {c + 1 for c in d}
        agree = min(agree, float((g == w).mean()))
    return agree


def phase_irn(n_batches: int = IRN_BATCHES) -> dict:
    import numpy as np

    from muscle_tpu_torch.inference import RandomWalkRefiner
    from muscle_tpu_torch.ops.banded_walk import banded_walk
    from muscle_tpu_torch.ops.stencil_walk import stencil_walk

    model = _irn_model()
    batches = _irn_batches(n_batches, seed=4)
    warm = _irn_batches(1, seed=5)
    kw = dict(crop_size=512, fast_io=True, device="cuda")
    kern = RandomWalkRefiner(model, output="labels", **kw)
    plain = RandomWalkRefiner(model, output="labels", walk_kernel=False, **kw)
    for r in (kern, plain):
        _refine(r, warm)  # cuDNN autotune, allocator warm-up
    _zero_counts()
    got, kern_s = _refine(kern, batches)
    launches = stencil_walk.launches
    if launches != n_batches:
        raise AssertionError(f"irn: {launches} stencil launches, want {n_batches} "
                             "(one walk per batch: every image falls in the 512 bucket)")
    want, plain_s = _refine(plain, batches)
    agree = _labels_agreement(got, want, batches)

    # the scores output on one batch: f16 grid scores, host upsample
    s_got, _ = _refine(RandomWalkRefiner(model, **kw), batches[:1])
    s_want, _ = _refine(RandomWalkRefiner(model, walk_kernel=False, **kw), batches[:1])
    score_err = max(float(np.abs(a - b).max()) for a, b in zip(s_got, s_want))
    for sc, img in zip(s_got, batches[0][0]):
        assert sc.shape == (*img.shape[:2], 21) and np.isfinite(sc).all()

    # the banded walk on one batch of 2 (a dense (V, V) T per image, 1 GiB)
    two = [(batches[0][0][:2], batches[0][1][:2])]
    bkern = RandomWalkRefiner(model, walk_method="banded", output="labels", **kw)
    bplain = RandomWalkRefiner(model, walk_method="banded", output="labels", walk_kernel=False,
                               **kw)
    _refine(bkern, [(warm[0][0][:2], warm[0][1][:2])])
    _zero_counts()
    b_got, bkern_s = _refine(bkern, two)
    b_launches = banded_walk.launches
    if b_launches != 1:
        raise AssertionError(f"irn banded: {b_launches} banded launches, want 1")
    b_want, bplain_s = _refine(bplain, two)
    b_agree = _labels_agreement(b_got, b_want, two)

    n_img = 8 * n_batches
    rec = {"irn": "fast labels, crop 512", "images": n_img, "stencil_launches": launches,
           "kernel_ms_per_image": kern_s * 1e3 / n_img,
           "plain_walk_ms_per_image": plain_s * 1e3 / n_img,
           "labels_agreement_min": agree, "scores_max_abs_err": score_err,
           "banded_images": 2, "banded_launches": b_launches,
           "banded_kernel_ms_per_image": bkern_s * 1e3 / 2,
           "banded_plain_ms_per_image": bplain_s * 1e3 / 2,
           "banded_labels_agreement_min": b_agree}
    print(json.dumps(rec), flush=True)
    if not (agree >= LABEL_AGREE and b_agree >= LABEL_AGREE and score_err <= IRN_SCORE_TOL):
        raise AssertionError(f"irn: labels agreement {agree} / banded {b_agree} (min "
                             f"{LABEL_AGREE}), scores err {score_err} (tol {IRN_SCORE_TOL})")
    return rec


def _device_rows(prof):
    """(ms, calls, name) of the device-side events of a profile (kernels,
    copies; no double count with host ops), largest first."""
    rows = []
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        if t > 0 and str(evt.device_type).endswith("CUDA"):
            rows.append((t / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    return rows


def _profile_record(tag, n_batches, wall, rows, ours_name, ours_keys) -> None:
    device_ms = sum(r[0] for r in rows)
    ours = sum(r[0] for r in rows if any(f"namespace)::{k}" in r[2] for k in ours_keys))
    print(json.dumps({
        "profile": tag, "batches": n_batches, "wall_ms": wall * 1e3, "device_ms": device_ms,
        "device_busy_share": device_ms / (wall * 1e3), ours_name: ours,
        "top": [[name[:90], calls, ms] for ms, calls, name in rows[:15]],
    }), flush=True)


def phase_profile(n_batches: int) -> None:
    """Where the device time goes: one torch.profiler window over
    ``n_batches`` --fast 0 CAM batches per engine (kernel and plain
    blocks), and one over ``n_batches`` IRN batches of 8 (stencil kernel);
    device time summed by kernel name."""
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
        _profile_record(f"fast0 fuse_mbconv={fuse}", n_batches, wall, _device_rows(prof),
                        "mbconv_kernel_ms", ("expand_dw_kernel", "se_kernel", "project_kernel"))

    from muscle_tpu_torch.inference import RandomWalkRefiner

    refiner = RandomWalkRefiner(_irn_model(), crop_size=512, fast_io=True, output="labels",
                                device="cuda")
    _refine(refiner, _irn_batches(1, seed=5))
    irn_batches = _irn_batches(n_batches, seed=6)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = _refine(refiner, irn_batches)
    _profile_record("irn fast labels, stencil kernel", n_batches, wall, _device_rows(prof),
                    "stencil_kernel_ms", ("stencil_step",))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases", default="build,kernels,main,irn")
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
    summaries = phase_kernels() if "kernels" in phases else None
    main_out = phase_main() if "main" in phases else None
    irn_out = phase_irn() if "irn" in phases else None
    if "profile" in phases:
        phase_profile(4)

    if summaries is not None:
        # null, not 0, where the phase that drives the kernel's path did not run
        launches = {
            "mbconv_stride1": main_out["fast0"]["launches"] if main_out else None,
            "stencil_walk": irn_out["stencil_launches"] if irn_out else None,
            "banded_walk": irn_out["banded_launches"] if irn_out else None,
        }
        entries = [{"name": name, "route": "cuda",
                    "source": f"muscle_tpu_torch/csrc/{KERNEL_SOURCES[name][0]}",
                    "replaces": KERNEL_SOURCES[name][1], "launches": launches[name],
                    **summaries[name]} for name in KERNEL_SOURCES]
        print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
