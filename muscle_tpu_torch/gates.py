"""The measured-fidelity gate harness (port of ``muscle_tpu/gates.py``).

The artifact contract (BASELINE.md "Gated configs"):

  gate 1  single-image CAM parity: exact-TTA SGC maps vs the PyTorch
          reference's fusion chain on the SAME weights (max |delta|).
  gate 2  multi-scale TTA CAM over a list + npy threshold-sweep mIoU, ours
          vs the oracle's maps (mIoU delta <= 0.3).
  gate 3  IRN random-walk refinement -> pseudo-label mIoU, ours vs the
          oracle chain.
  gate 4  MCL memorisation through ``cli.train_mcl``: the loss must fall
          and every curriculum term must carry a live parameter gradient.
  gate 5  MuSCLe seg memorisation (CE + BEACON) through
          ``cli.train_muscle``, the same decrease + liveness contract.
  gate 6  convergence: CAM and seg mIoU must rise over their values at
          initialisation (in-process training).
  gate 7  seg-TTA fidelity: the SegTTAEngine + CRF chain vs the oracle's.

The oracle of gates 1, 2, 3 and 7 is the original PyTorch reference tree,
imported from the directory ``--reference_root`` names
(``load_reference``); every gate takes its oracle as an argument, so a
caller may pass a stand-in with the reference's call signature.  Gates 4,
5 and 6 need no oracle.  The port's engines and trainers run on
``device`` (the card by default); the oracle runs on the CPU.

Where the JAX package reads and writes Flax ``.msgpack`` checkpoints, the
port reads and writes ``.pth`` state dicts in the reference's key names
(``model_0.pth`` from the trainers, ``gate6_enc.pth`` / ``gate6_dec.pth``
from gate 6).  Every gate returns one JSON-able verdict dict with the JAX
package's keys; gates 4, 5 and 6 add the MBConv kernel's launches in
their inference forwards (``mbconv_launches``: the evals, and gate 4's
trainer's overlays), gates 4 and 5 the seconds of their
trainer's run (``seconds_cli``; the rest is the liveness probe).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
import types

import numpy as np

VOC_CATS = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

# the gates whose oracle is the reference tree
ORACLE_GATES = ("1", "1f", "2", "2e", "3", "7", "7e", "t")


# --------------------------------------------------------------------------
# synthetic mini-VOC
# --------------------------------------------------------------------------

def build_synthetic_voc(root: str, sizes=None, seed: int = 0) -> list[str]:
    """A miniature VOC2012 tree with STRUCTURED images: each image is a
    textured background with 1-2 high-contrast class blobs, and the
    SegmentationClass GT marks exactly those blobs, so CAM-style pipelines
    produce meaningful (not noise-level) mIoU numbers.  The same seed and
    sizes write the same bytes as the JAX package's."""
    from PIL import Image

    from muscle_tpu_torch.data.voc12 import build_cls_labels

    if sizes is None:
        sizes = [(375, 500), (500, 375), (333, 500), (500, 500)]
    img_dir = os.path.join(root, "JPEGImages")
    seg_dir = os.path.join(root, "SegmentationClass")
    ann_dir = os.path.join(root, "Annotations")
    for d in (img_dir, seg_dir, ann_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = []
    for i, (h, w) in enumerate(sizes):
        n = f"2012_{i:06d}"
        names.append(n)
        img = rng.integers(96, 160, (h, w, 3)).astype(np.uint8)  # texture
        seg = np.zeros((h, w), np.uint8)
        cls = [(i * 2) % 20, (i * 2 + 7) % 20]
        objs = []
        for j, c in enumerate(cls[: 1 + i % 2]):
            ch, cw = h // 3, w // 3
            r0 = (j + 1) * h // 4 - ch // 2
            c0 = (j + 1) * w // 4 - cw // 2
            colour = rng.integers(0, 255, 3)
            img[r0: r0 + ch, c0: c0 + cw] = colour
            seg[r0: r0 + ch, c0: c0 + cw] = c + 1
            objs.append(f"<object><name>{VOC_CATS[c]}</name></object>")
        Image.fromarray(img).save(os.path.join(img_dir, n + ".jpg"))
        Image.fromarray(seg).save(os.path.join(seg_dir, n + ".png"))
        with open(os.path.join(ann_dir, n + ".xml"), "w") as f:
            f.write("<annotation>" + "".join(objs) + "</annotation>")
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    build_cls_labels(names, root, os.path.join(root, "cls_labels.npy"))
    return names


# --------------------------------------------------------------------------
# the oracle: the PyTorch reference tree
# --------------------------------------------------------------------------

def _stub(name: str, **attrs) -> types.ModuleType:
    mod = sys.modules.get(name)
    if mod is None:
        mod = types.ModuleType(name)
        sys.modules[name] = mod
    for k, v in attrs.items():
        setattr(mod, k, v)
    return mod


def load_reference(root: str | None):
    """Import the reference's ``src`` package from the tree at ``root``
    (the directory that holds ``src/``), read-only, as the oracle.  Its
    imports of cv2, qpth, torchvision, scipy.misc and skimage, which no
    oracle forward uses, are stubbed, and its pretrained-weight download
    is made a no-op.  Raises FileNotFoundError when there is no tree."""
    if not root or not os.path.isdir(os.path.join(root, "src")):
        raise FileNotFoundError(f"no PyTorch reference tree at {root!r} (a directory holding "
                                "its src/ package)")
    root = os.path.abspath(root)
    if root not in sys.path:
        sys.path.insert(0, root)
    _stub("cv2", EMD=None, DIST_USER=None, resize=None, INTER_NEAREST=0)
    qpth = _stub("qpth")
    qpth.qp = _stub("qpth.qp", QPFunction=lambda *a, **k: None)
    tv = _stub("torchvision")
    transforms = _stub("torchvision.transforms")
    tv.transforms = transforms

    class _NoOpTransform:
        def __init__(self, *a, **k):
            pass

        def __call__(self, x):
            return x

    transforms.ColorJitter = _NoOpTransform
    transforms.Compose = _NoOpTransform
    transforms.RandomErasing = _NoOpTransform
    transforms.functional = _stub("torchvision.transforms.functional")
    import scipy

    if not hasattr(scipy, "misc"):
        scipy.misc = _stub("scipy.misc")
    _stub("skimage")
    sys.modules["skimage"].transform = _stub("skimage.transform", resize=None)

    import src.efficientnet_pytorch.model as ref_model
    import src.efficientnet_pytorch.utils as ref_utils

    noop = lambda *a, **k: None  # noqa: E731
    ref_model.load_pretrained_weights = noop
    ref_utils.load_pretrained_weights = noop

    import src

    return src


def make_oracle_muscle(backbone: str, mode: str = "enc", layers: int = 1,
                       weights: str | None = None, seed: int = 0,
                       reference_root: str | None = None):
    """(reference MuSCLe on the CPU in eval mode, the port's MuSCLe with the
    same weights).  The reference's state dict loads straight into the port
    model, whose keys are the reference's; its stride-1 blocks run through
    the MBConv kernel on a card, as the port serves.

    weights=None -> fixed-seed random init, calibrated below; otherwise
    the published .pth is loaded into both."""
    import torch

    from muscle_tpu_torch.convert import load_into
    from muscle_tpu_torch.models import MuSCLe

    src = load_reference(reference_root)
    torch.manual_seed(seed)
    tmodel = src.MuSCLe(
        num_classes=21, pretrained=backbone, layers=layers,
        MemoryEfficient=True, last_pooling=(mode == "dec"), mode=mode,
    )
    if weights:
        sd = torch.load(weights, map_location="cpu")
        tmodel.load_state_dict(sd, strict=False)
    else:
        # Random-init EfficientNet in eval mode has IDENTITY BN running
        # stats, so activations decay ~1e-12 by p7 and every fused map is
        # constant (the min-max fusion degenerates; fidelity deltas become
        # meaningless).  Calibrate the BN stats with a few train-mode
        # forwards on synthetic data (activations become O(1) layer by
        # layer, like a trained network's) and make the CAM head (the fc
        # rows) positive so class maps don't clip to constants.
        rng = np.random.default_rng(seed)
        calib_mode = "seg" if mode == "dec" else "cam"  # dec has no fc/fuse
        with torch.no_grad():
            tmodel.train()
            for _ in range(3):
                x = torch.from_numpy(
                    rng.normal(0, 1, size=(2, 3, 96, 96)).astype(np.float32)
                )
                tmodel(x, cam=calib_mode)
            tmodel.eval()
            if hasattr(tmodel, "fc") and mode == "enc":
                # Trained CAMs are relu-sparse (per-class min ~ 0), which is
                # what keeps the reference's min-max fusion well-conditioned.
                # A random head's map is a near-constant offset w . mean(p7)
                # instead: project each class row orthogonal to the mean p7
                # feature (probed once) so the maps straddle zero spatially.
                emb, _ = tmodel(
                    torch.from_numpy(
                        rng.normal(0, 1, size=(4, 3, 96, 96)).astype(np.float32)
                    ),
                    cam="logits",
                )
                p_bar = emb.mean(dim=0)
                w = tmodel.fc.weight
                w.sub_(torch.outer(w @ p_bar / (p_bar @ p_bar), p_bar))
                if tmodel.fc.bias is not None:
                    tmodel.fc.bias.zero_()
    tmodel.eval()
    model = MuSCLe(num_classes=21, backbone_name=backbone, bifpn_layers=layers, mode=mode,
                   last_pooling=(mode == "dec"), fuse_mbconv=384)
    sd = {k: v.detach().to(torch.float32) if v.is_floating_point() else v.detach()
          for k, v in tmodel.state_dict().items()}
    own = model.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"the reference lacks port keys: {missing[:5]}")
    load_into(model, {k: sd[k] for k in own if k in sd})
    return tmodel, model.eval()


def make_oracle_from_model(backbone: str, mode: str, layers: int, model,
                           reference_root: str | None = None):
    """The reference MuSCLe carrying weights TRAINED IN THIS PORT: the port
    model's state dict loaded into it (the keys are the reference's), so
    the '_trained' fidelity rows feed the gate-6 checkpoints back through
    the oracle and the 0.3 budget is exercised on structured,
    class-separated maps."""
    import torch

    src = load_reference(reference_root)
    tmodel = src.MuSCLe(
        num_classes=21, pretrained=backbone, layers=layers,
        MemoryEfficient=True, last_pooling=(mode == "dec"), mode=mode,
    )
    sd = {k: v.detach().cpu().to(torch.float32) if v.is_floating_point() else v.detach().cpu()
          for k, v in model.state_dict().items()}
    missing, unexpected = tmodel.load_state_dict(sd, strict=False)
    if unexpected:
        raise ValueError(f"the port's state dict has keys the reference lacks: "
                         f"{unexpected[:5]}")
    real_missing = [
        k for k in missing
        if "num_batches_tracked" not in k
        # the reference's top-level conv head, bn1 and fc are dead code
        # (their forward applications are commented out), so the port
        # model has no counterpart; random init is inert
        and not k.startswith(("backbone._conv_head", "backbone._bn1",
                              "backbone._fc"))
        # fuse_dec is constructed unconditionally but only applied in the
        # seg forward: dead in enc mode
        and not (mode == "enc" and k.startswith("fuse_dec"))
    ]
    if real_missing:
        raise ValueError(f"the port's state dict left reference keys unset: "
                         f"{real_missing[:5]}")
    tmodel.eval()
    return tmodel


def oracle_cam_fusion(tmodel, img, label: np.ndarray, scales):
    """The reference per-image TTA fusion chain (infer_mcl.py:107-174).

    Returns (cam_dict, sgc_dict, score).  For an untrained oracle the SGC
    maps are inherently constant (PCM averages with near-uniform
    affinities), so fidelity deltas on them are meaningless: channels whose
    oracle map is degenerate are left out."""
    import torch
    import torch.nn.functional as F
    from PIL import Image

    from muscle_tpu_torch.data import transforms as T

    w, h = img.size
    cam_versions, versions, score_list = [], [], []
    for s in scales:
        tw, th = round(w * s), round(h * s)
        arr = T.color_norm(np.asarray(img.resize((tw, th), resample=Image.BICUBIC)))
        for flip in (False, True):
            a = arr[:, ::-1] if flip else arr
            x = torch.from_numpy(a.transpose(2, 0, 1)[None].copy()).float()
            with torch.no_grad():
                cam, sgc, _, score = tmodel(x, cam="cam")
                sgc = F.interpolate(sgc, size=(h, w), mode="bilinear", align_corners=False)
                cam = F.interpolate(cam, size=(h, w), mode="bilinear", align_corners=False)
            m = sgc[0].numpy()
            mc = cam[0].numpy()
            if flip:
                m = m[:, :, ::-1]
                mc = mc[:, :, ::-1]
            versions.append(m[1:])
            cam_versions.append(mc[1:])
            score_list.append(score[:, 1:])

    def fuse(vv):
        norm = np.sum(vv, axis=0)
        norm[norm < 0] = 0
        mx = norm.max(axis=(1, 2), keepdims=True)
        mn = norm.min(axis=(1, 2), keepdims=True)
        norm[norm < mn + 1e-6] = 0
        # a channel is well-conditioned for fidelity comparison only when
        # its raw min ~ 0 relative to max (trained-CAM shape); otherwise the
        # pre-norm zeroing is a discontinuity that amplifies float noise
        ok = (mx[:, 0, 0] > 1e-6) & (mn[:, 0, 0] < 0.05 * mx[:, 0, 0])
        return (norm - mn - 1e-6) / (mx - mn + 1e-6), ok, (mx - mn)[:, 0, 0]

    sgc_n, sgc_ok, sgc_spread = fuse(versions)
    cam_n, cam_ok, cam_spread = fuse(cam_versions)
    score = torch.sigmoid(torch.mean(torch.cat(score_list, 0), dim=0)).numpy()
    keep = np.nonzero(label > 1e-5)[0]
    return (
        {int(k): (cam_n[k], float(cam_spread[k])) for k in keep if cam_ok[k]},
        {int(k): (sgc_n[k], float(sgc_spread[k])) for k in keep if sgc_ok[k]},
        score,
    )


def _cam_engine(model, scales, out_side, engine_mode: str, device):
    """The CAM engine a fidelity gate runs: 'exact' (host TTA, full-res
    fusion) or 'fast' (the production path with its documented
    deviations)."""
    from muscle_tpu_torch.inference import CamTTAEngine

    if engine_mode == "exact":
        return CamTTAEngine(model, scales=scales, out_side=out_side, lowres=False,
                            device_tta=False, device=device)
    return CamTTAEngine(model, scales=scales, out_side=out_side, lowres=True,
                        device_tta=True, accum_stride=4, download_dtype="uint8",
                        tight_upload=True, device=device)


# --------------------------------------------------------------------------
# gates
# --------------------------------------------------------------------------

def gate1_cam_single(model, tmodel, img, label, scales, out_side,
                     engine_mode: str = "exact", tag: str = "",
                     device: str = "cuda") -> dict:
    """Config #1: single-image CAM parity (exact or fast engine path)
    against ``tmodel``'s fusion chain.

    tag: report-row suffix (e.g. '_trained' for the rows evaluated at the
    gate-6 trained checkpoint).  The trained rows run the same 1e-3 score
    tolerance as the random-init rows."""
    t0 = time.time()
    score_tol = 1e-3
    want_cam, want_sgc, want_score = oracle_cam_fusion(tmodel, img, label, scales)
    engine = _cam_engine(model, scales, out_side, engine_mode, device)
    run = engine.run_batch_exact if engine_mode == "exact" else engine.run_batch
    got = run([img], ["x"], [label])[0]
    deltas, means, raw_deltas, degenerate = [], [], [], 0
    n_labels = int(np.sum(label > 1e-5))
    for key, want in (("cam", want_cam), ("sgc", want_sgc)):
        degenerate += n_labels - len(want)  # ill-conditioned channels omitted
        for k, (w, spread) in want.items():
            diff = np.abs(got[key][k].astype(np.float32) - w)
            deltas.append(float(diff.max()))
            means.append(float(diff.mean()))
            # normalised deltas divide by the raw map spread: scale back so
            # float-level noise on a low-spread synthetic oracle (spread
            # ~1e-4 instead of a trained net's ~1) doesn't read as failure
            raw_deltas.append(float(diff.max()) * spread)
    score_delta = float(np.abs(got["score"] - want_score).max())
    # exact: judged on the MAX delta, with a raw budget of 3e-5 for
    # conv-algorithm differences on O(1) activations; fast: judged on the
    # MEAN delta (its resample/quantisation deviations are distributed)
    if engine_mode == "exact":
        tol, raw_noise_budget = 2e-3, 3e-5
        ok = bool(deltas) and all(
            d <= tol or rd <= raw_noise_budget for d, rd in zip(deltas, raw_deltas)
        )
    else:
        tol, raw_noise_budget = 5e-2, 3e-5
        ok = bool(means) and all(
            m <= tol or rd <= raw_noise_budget for m, rd in zip(means, raw_deltas)
        )
    return {
        "gate": f"1_cam_single_{engine_mode}{tag}",
        "max_abs_delta": max(deltas) if deltas else float("nan"),
        "mean_abs_delta": max(means) if means else float("nan"),
        "max_raw_delta": max(raw_deltas) if raw_deltas else float("nan"),
        "channels_compared": len(deltas),
        "channels_degenerate": degenerate,
        "score_delta": score_delta,
        "tolerance": tol,
        "raw_noise_budget": raw_noise_budget,
        # which measured field `tolerance` applies to
        "judged_on": "max_abs_delta" if engine_mode == "exact" else "mean_abs_delta",
        "passed": bool(ok and score_delta <= score_tol),
        "seconds": round(time.time() - t0, 1),
    }


def gate2_cam_tta_miou(model, tmodel, voc_root, names, labels, scales, out_side, out_dir,
                       engine_mode: str = "fast", tag: str = "",
                       device: str = "cuda") -> dict:
    """Config #2: TTA CAM npy over a list, threshold-sweep mIoU vs the
    oracle's.

    tag: report-row suffix; also namespaces the npy output dirs so the
    trained-checkpoint rows don't clobber the random-init artifacts."""
    from PIL import Image

    from muscle_tpu_torch.data.voc12 import get_img_path
    from muscle_tpu_torch.evaluation import threshold_sweep

    t0 = time.time()
    ours_dir = os.path.join(out_dir, f"gate2_ours_{engine_mode}{tag}")
    ref_dir = os.path.join(out_dir, f"gate2_oracle{tag}")
    os.makedirs(ours_dir, exist_ok=True)
    os.makedirs(ref_dir, exist_ok=True)
    engine = _cam_engine(model, scales, out_side, engine_mode, device)
    run = engine.run_batch_exact if engine_mode == "exact" else engine.run_batch

    imgs = [Image.open(get_img_path(n, voc_root)).convert("RGB") for n in names]
    labs = [labels[n] for n in names]
    per_image_delta = []
    kept_names = []
    raw_spreads: list[float] = []
    for i in range(len(names)):
        rec = run([imgs[i]], [names[i]], [labs[i]])[0]
        want_cam, want_sgc, _ = oracle_cam_fusion(tmodel, imgs[i], labs[i], scales)
        # the artifact is the SGC dict, but an untrained oracle's SGC is
        # constant: gate on whichever map family kept more well-conditioned
        # channels (real weights: both do)
        use_cam = len(want_cam) > len(want_sgc)
        want = want_cam if use_cam else want_sgc
        key = "cam" if use_cam else "sgc"
        if not want:  # no well-conditioned channel on this image
            continue
        kept_names.append(names[i])
        # compare like with like: save only the channels the oracle kept
        np.save(os.path.join(ours_dir, names[i] + ".npy"),
                {k: rec[key][k] for k in want})
        np.save(os.path.join(ref_dir, names[i] + ".npy"),
                {k: v.astype(np.float16) for k, (v, _) in want.items()})
        per_image_delta.append(
            float(np.mean([
                np.abs(rec[key][k].astype(np.float32) - v).mean()
                for k, (v, _) in want.items()
            ]))
        )
        raw_spreads.extend(float(s) for _, (_, s) in want.items())
    if not kept_names:
        return {"gate": f"2_cam_tta_miou_{engine_mode}{tag}", "passed": False,
                "error": "no well-conditioned oracle channels",
                "seconds": round(time.time() - t0, 1)}

    gt = os.path.join(voc_root, "SegmentationClass")
    ths = np.arange(0.20, 0.52, 0.02)
    ours = max(r["mIoU"] for r in threshold_sweep(ours_dir, gt, kept_names, ths))
    ref = max(r["mIoU"] for r in threshold_sweep(ref_dir, gt, kept_names, ths))
    delta = abs(ours - ref)
    # noise-floor escape, as gate 1's raw_noise_budget: a RANDOM-INIT
    # oracle's raw maps are near-constant (spread ~1e-2 at full size vs a
    # trained net's ~1), so the best-threshold sweep over a few images
    # amplifies a bounded normalised-map deviation into chaotic mIoU
    # jumps.  In that degenerate regime the row is judged on the map
    # bound; trained rows (structured maps) always judge on mIoU.
    degenerate = bool(np.median(raw_spreads) < 1e-2) if raw_spreads else False
    map_budget = 5e-2 if engine_mode == "fast" else 2e-3
    on_maps = degenerate and delta > 0.3
    passed = (float(np.mean(per_image_delta)) <= map_budget) if on_maps \
        else (delta <= 0.3)
    return {
        "gate": f"2_cam_tta_miou_{engine_mode}{tag}",
        "mIoU_ours": round(float(ours), 4),
        "mIoU_oracle": round(float(ref), 4),
        "mIoU_delta": round(float(delta), 4),
        "mean_map_delta": round(float(np.mean(per_image_delta)), 5),
        "oracle_spread_median": round(float(np.median(raw_spreads)), 6)
        if raw_spreads else None,
        "tolerance": 0.3,
        "map_budget": map_budget,
        "judged_on": "mean_map_delta (degenerate random-init oracle — see "
                     "gates.py noise-floor note)" if on_maps else "mIoU_delta",
        "passed": bool(passed),
        "seconds": round(time.time() - t0, 1),
    }


def oracle_propagate_vector(ref_indexing, x, edge, radius=5, beta=8, exp_times=6):
    """The reference random walk evaluated by VECTOR ITERATION: the
    reference computes rw = x @ T^(2^t) via t matrix squarings
    (indexing.py:116-123, O(t * V^3)); iterating rw <- rw @ T 2^t times is
    the same linear map at O(2^t * C * V^2)."""
    import torch
    import torch.nn.functional as F

    height, width = x.shape[-2:]
    hor_padded = width + radius * 2
    ver_padded = height + radius
    path_index = ref_indexing.PathIndex(
        radius=radius, default_size=(ver_padded, hor_padded)
    )
    edge_padded = F.pad(edge, (radius, radius, 0, radius), mode="constant", value=1.0)
    sparse_aff = ref_indexing.edge_to_affinity(
        torch.unsqueeze(edge_padded, 0), path_index.path_indices
    )
    dense_aff = ref_indexing.affinity_sparse2dense(
        sparse_aff, path_index.src_indices, path_index.dst_indices,
        ver_padded * hor_padded,
    )
    dense_aff = dense_aff.view(ver_padded, hor_padded, ver_padded, hor_padded)
    dense_aff = dense_aff[:-radius, radius:-radius, :-radius, radius:-radius]
    dense_aff = dense_aff.reshape(height * width, height * width)

    scaled = torch.pow(dense_aff, beta)
    trans = scaled / torch.sum(scaled, dim=0, keepdim=True)
    del dense_aff, scaled
    rw = (x.view(-1, height, width) * (1 - edge)).view(-1, height * width)
    for _ in range(2 ** exp_times):
        rw = torch.matmul(rw, trans)
    return rw.view(rw.size(0), 1, height, width)


def make_irn_oracle(reference_root: str | None, weights: str | None = None, seed: int = 0,
                    oracle_method: str = "square", device: str = "cuda"):
    """(the port's RandomWalkRefiner, the oracle's label function) on the
    same IRN weights: the reference EdgeDisplacement at crop 512 (seeded
    random init, or ``weights``), its state dict loaded into the port's.

    The label function ``oracle_labels(img, cam_dict) -> (H, W) uint8`` is
    the reference chain (infer_irn.py:62-100) on the CPU.
    oracle_method: 'square' = the reference's literal matrix-squaring
    code; 'vector' = the same linear map by vector iteration (full-size
    runs, ``oracle_propagate_vector``).

    bucket=0: always the reference's full 512 canvas.  The edge net's deep
    features are canvas-size sensitive (bias/BN pad activations inside
    stride-32 receptive fields), so the parity gate must not exercise the
    refiner's small-image size bucketing."""
    import torch
    import torch.nn.functional as F

    from muscle_tpu_torch.data import transforms as T
    from muscle_tpu_torch.inference import RandomWalkRefiner
    from muscle_tpu_torch.models import EdgeDisplacement

    load_reference(reference_root)
    import src.backbones.resnet50 as ref_r50
    import src.backbones.resnet50_irn as ref_irn
    from src import indexing as ref_indexing

    orig = ref_r50.resnet50
    ref_r50.resnet50 = lambda pretrained=True, **kw: orig(pretrained=False, **kw)
    try:
        torch.manual_seed(seed)
        tnet = ref_irn.EdgeDisplacement(crop_size=512)
    finally:
        ref_r50.resnet50 = orig
    if weights:
        tnet.load_state_dict(torch.load(weights, map_location="cpu"), strict=False)
    tnet.eval()
    model = EdgeDisplacement(crop_size=512)
    sd = tnet.state_dict()
    own = model.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"the reference lacks IRN keys: {missing[:5]}")
    model.load_state_dict({k: sd[k].detach() for k in own if k in sd}, strict=False)
    refiner = RandomWalkRefiner(model, crop_size=512, bucket=0, device=device)

    def oracle_labels(img, cam: dict) -> np.ndarray:
        # the reference walk hardcodes .cuda() (indexing.py:84,111): run it
        # on the CPU by no-opping the transfer for the call
        orig_cuda = torch.Tensor.cuda
        torch.Tensor.cuda = lambda self, *a, **k: self
        try:
            arr = T.color_norm(np.asarray(img))
            x = np.stack([arr, arr[:, ::-1]], 0).transpose(0, 3, 1, 2)
            with torch.no_grad():
                edge, _ = tnet(torch.from_numpy(np.ascontiguousarray(x)).float())
                h, w = arr.shape[:2]
                cam_arr = np.zeros((20, h, w), np.float32)
                for k, v in cam.items():
                    cam_arr[k] = v
                down = F.interpolate(torch.from_numpy(cam_arr).unsqueeze(0),
                                     size=edge.shape[1:], mode="bilinear",
                                     align_corners=False)
                if oracle_method == "vector":
                    rw = oracle_propagate_vector(ref_indexing, down, edge,
                                                 beta=8, exp_times=6, radius=5)
                else:
                    rw = ref_indexing.propagate_to_edge(down, edge, beta=8,
                                                        exp_times=6, radius=5)
                rw_up = F.interpolate(rw, scale_factor=4, mode="bilinear",
                                      align_corners=False)[..., 0, :h, :w]
                rw_up = rw_up / torch.max(rw_up)
                rw_bg = F.pad(rw_up, (0, 0, 0, 0, 1, 0), value=0.35)
                return torch.argmax(rw_bg, dim=0).numpy().astype(np.uint8)
        finally:
            torch.Tensor.cuda = orig_cuda

    return refiner, oracle_labels


def gate3_irn_refine(voc_root, names, cam_dir, refiner, oracle_labels,
                     tag: str = "") -> dict:
    """Config #3: random-walk refinement -> hard pseudo-label mIoU, the
    port's ``refiner`` vs ``oracle_labels(img, cam_dict)`` (the reference
    chain, ``make_irn_oracle``) on the CAM npys of ``cam_dir``.

    tag: report-row suffix; '_trained' runs the walk on the CAM npys the
    gate-2 trained row produced (the edge net stays at its seeded init on
    both sides: the gate measures walk fidelity, not pseudo-label
    quality)."""
    from PIL import Image

    from muscle_tpu_torch.data.voc12 import get_img_path
    from muscle_tpu_torch.evaluation import confusion_matrix, iou_from_confusion

    t0 = time.time()
    conf_ours = np.zeros((21, 21), np.int64)
    conf_ref = np.zeros((21, 21), np.int64)
    agree = []
    # gate 2 only writes npys for images with well-conditioned channels
    names = [n for n in names if os.path.exists(os.path.join(cam_dir, n + ".npy"))]
    for n in names:
        img = Image.open(get_img_path(n, voc_root)).convert("RGB")
        cam = np.load(os.path.join(cam_dir, n + ".npy"), allow_pickle=True).item()
        ours = refiner.to_png_labels(refiner.refine_image(img, cam))
        ref_lab = oracle_labels(img, cam)
        gt = np.array(Image.open(os.path.join(voc_root, "SegmentationClass", n + ".png")))
        conf_ours += confusion_matrix(ours, gt, 21)
        conf_ref += confusion_matrix(ref_lab, gt, 21)
        agree.append(float((ours == ref_lab).mean()))

    miou_ours = iou_from_confusion(conf_ours)["mIoU"]
    miou_ref = iou_from_confusion(conf_ref)["mIoU"]
    delta = abs(miou_ours - miou_ref)
    return {
        "gate": f"3_irn_refine_miou{tag}",
        "mIoU_ours": round(float(miou_ours), 4),
        "mIoU_oracle": round(float(miou_ref), 4),
        "mIoU_delta": round(float(delta), 4),
        "pixel_agreement": round(float(np.mean(agree)), 4),
        "tolerance": 0.3,
        "passed": bool(delta <= 0.3),
        "seconds": round(time.time() - t0, 1),
    }


def oracle_seg_fusion(tmodel, img, scales):
    """The reference seg TTA fusion chain (infer_seg.py:88-117): per scale,
    PIL BICUBIC resize, forward cam='seg', softmax, cv2 half-pixel bilinear
    resize to the original size (applied as the equivalent interpolation
    matmul, ``core/resize._interp_matrix``), unflip odd versions, MEAN over
    the versions.  Returns (C, H, W) mean softmax probs."""
    import torch
    from PIL import Image

    from muscle_tpu_torch.core.resize import _interp_matrix
    from muscle_tpu_torch.data import transforms as T

    w, h = img.size
    versions = []
    for s in scales:
        tw, th = round(w * s), round(h * s)
        arr = T.color_norm(np.asarray(img.resize((tw, th), resample=Image.BICUBIC)))
        for flip in (False, True):
            a = arr[:, ::-1] if flip else arr
            x = torch.from_numpy(a.transpose(2, 0, 1)[None].copy()).float()
            with torch.no_grad():
                seg, _ = tmodel(x, cam="seg")
                p = torch.softmax(seg, dim=1)[0].numpy()
            mh = _interp_matrix(p.shape[1], h, align_corners=False)
            mw = _interp_matrix(p.shape[2], w, align_corners=False)
            p = np.einsum("Hh,chw,Ww->cHW", mh, p, mw, optimize=True)
            if flip:
                p = p[:, :, ::-1]
            versions.append(p)
    return np.mean(versions, axis=0)


def gate7_seg_tta(model, tmodel, voc_root, names, out_dir, scales, out_side, max_side,
                  engine_mode: str = "fast", tag: str = "", device: str = "cuda") -> dict:
    """Config #7: seg-TTA fidelity: the full b?+BiFPN seg inference chain
    (SegTTAEngine + dense CRF + argmax) vs ``tmodel``'s chain on the SAME
    weights.

    Gated on the artifact (post-CRF pseudo-label mIoU delta <= 0.3) with
    the pre-CRF mean map delta and post-CRF pixel agreement reported.
    Both sides run the SAME native permutohedral CRF (ops/exact_crf.py),
    so the row isolates the TTA/forward chain, not the CRF backend.

    engine_mode 'fast' = the shipping config (device TTA, window-exact
    canvases, accum_stride=4, f16 download, tight upload), with the
    labels output's agreement with the probabilities' argmax (>= 0.95);
    'exact' = host PIL prep + stride-1 f32 accumulation (parity mode)."""
    from PIL import Image

    from muscle_tpu_torch.data.voc12 import get_img_path
    from muscle_tpu_torch.evaluation import confusion_matrix, iou_from_confusion
    from muscle_tpu_torch.inference import SegTTAEngine
    from muscle_tpu_torch.ops.exact_crf import dense_crf

    t0 = time.time()
    if engine_mode == "exact":
        engine = SegTTAEngine(model, scales=scales, out_side=out_side, max_side=max_side,
                              device_tta=False, accum_stride=1, device=device)
    else:
        engine = SegTTAEngine(model, scales=scales, out_side=out_side, max_side=max_side,
                              device_tta=True, accum_stride=4, download_dtype="float16",
                              tight_upload=True, device=device)
    imgs = [Image.open(get_img_path(n, voc_root)).convert("RGB") for n in names]
    recs = engine.run_batch(imgs, names)
    conf_ours = np.zeros((21, 21), np.int64)
    conf_ref = np.zeros((21, 21), np.int64)
    agree, map_deltas = [], []
    classes_pred = set()  # degeneracy indicator: a random-init dec's argmax
    # collapses to 1-2 classes (near-uniform softmax); the '_trained' row
    # is where the mIoU comparison carries class structure
    for img, n, rec in zip(imgs, names, recs):
        want = oracle_seg_fusion(tmodel, img, scales)  # (C, H, W)
        got = rec["probs"].transpose(2, 0, 1).astype(np.float32)
        map_deltas.append(float(np.abs(got - want).mean()))
        orig = np.asarray(img)
        got_crf = dense_crf(orig, np.ascontiguousarray(got), t=4)
        want_crf = dense_crf(orig, np.ascontiguousarray(want.astype(np.float32)), t=4)
        ours_lab = np.argmax(got_crf, axis=0).astype(np.uint8)
        ref_lab = np.argmax(want_crf, axis=0).astype(np.uint8)
        gt = np.array(Image.open(os.path.join(voc_root, "SegmentationClass", n + ".png")))
        conf_ours += confusion_matrix(ours_lab, gt, 21)
        conf_ref += confusion_matrix(ref_lab, gt, 21)
        agree.append(float((ours_lab == ref_lab).mean()))
        classes_pred.update(np.unique(ours_lab).tolist())
    miou_ours = iou_from_confusion(conf_ours)["mIoU"]
    miou_ref = iou_from_confusion(conf_ref)["mIoU"]
    delta = abs(miou_ours - miou_ref)
    row = {
        "gate": f"7_seg_tta_miou_{engine_mode}{tag}",
        "mIoU_ours": round(float(miou_ours), 4),
        "mIoU_oracle": round(float(miou_ref), 4),
        "mIoU_delta": round(float(delta), 4),
        "pixel_agreement": round(float(np.mean(agree)), 4),
        "mean_map_delta": round(float(np.mean(map_deltas)), 7),
        "classes_predicted": len(classes_pred),
        "tolerance": 0.3,
        "judged_on": "mIoU_delta",
        "passed": bool(delta <= 0.3),
    }
    if engine_mode == "fast":
        # output='labels' (device-fused upsample + argmax, the no-CRF
        # production path) vs the probs path's own host argmax: bounds the
        # device-resize-vs-PIL boundary rounding on real engine maps
        lab_engine = SegTTAEngine(model, scales=scales, out_side=out_side,
                                  max_side=max_side, device_tta=True, accum_stride=4,
                                  tight_upload=True, output="labels", device=device)
        lab_recs = lab_engine.run_batch(imgs, names)
        lab_agree = [
            float((np.argmax(rec["probs"], axis=-1).astype(np.uint8)
                   == lrec["label"]).mean())
            for rec, lrec in zip(recs, lab_recs)
        ]
        row["labels_agreement"] = round(float(np.mean(lab_agree)), 4)
        row["labels_agreement_min"] = round(float(np.min(lab_agree)), 4)
        row["passed"] = bool(row["passed"] and np.mean(lab_agree) >= 0.95)
    row["seconds"] = round(time.time() - t0, 1)
    return row


# --------------------------------------------------------------------------
# training gates (no oracle)
# --------------------------------------------------------------------------

def _mbconv_launches() -> int:
    """The MBConv kernel's launches so far in this process (f32 and bf16)."""
    from muscle_tpu_torch.ops.mbconv import mbconv_stride1

    return mbconv_stride1.launches + mbconv_stride1.launches_bf16


def _metric_rows(log_dir: str) -> list[dict]:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _mcl_grad_norm_liveness(voc_root, names, labels, checkpoint: str, crop: int = 64,
                            backbone: str = "efficientnet-b1", method: str = "jacrev",
                            device: str = "cuda") -> dict:
    """Per-term liveness at the gate-4 TRAINED checkpoint (ALL curriculum
    terms enabled): a term whose value is tiny can still train, and a term
    whose value is O(1) can be a detached corpse; only its gradient
    separates them.  Evaluated at the trained point, not random init:
    maxnorm-based terms (PixPro/EMD) are legitimately flat when every CAM
    is a relu'd near-constant.  The batch carries two copies of each image
    so IMC has identical-set positives AND disjoint-set negatives."""
    import torch
    from PIL import Image

    from muscle_tpu_torch.cli.common import load_model_state
    from muscle_tpu_torch.data import transforms as T
    from muscle_tpu_torch.data.voc12 import get_img_path
    from muscle_tpu_torch.models import MuSCLe
    from muscle_tpu_torch.training import MCLConfig, mcl_term_grad_norms

    dev = torch.device(device)
    model = MuSCLe(backbone_name=backbone, mode="enc", last_pooling=False)
    load_model_state(checkpoint, model)
    model.to(dev)
    rng_np = np.random.default_rng(0)
    imgs, labs = [], []
    for n in (names[0], names[0], names[1], names[1]):
        img = Image.open(get_img_path(n, voc_root)).convert("RGB").resize((crop, crop))
        imgs.append(T.color_norm(np.asarray(img)))
        labs.append(labels[n])
    b = len(imgs)
    batch = {
        "img": np.stack(imgs).astype(np.float32),
        "label": np.stack(labs).astype(np.float32),
        # scaled-up random views: near-uniform CAMs otherwise zero the
        # cosine-cost EMD identically
        "view1": 4.0 * rng_np.normal(size=(b, crop, crop, 3)).astype(np.float32),
        "view2": 4.0 * rng_np.normal(size=(b, crop, crop, 3)).astype(np.float32),
        "coord1": np.tile(np.array([[4, 4, 32, 32]], np.int32), (b, 1)),
        "coord2": np.tile(np.array([[8, 2, 32, 32]], np.int32), (b, 1)),
    }
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
    # views_train_mode: a short memorisation only partially calibrates the
    # BN running stats; probe the step-B graph with train-mode BN so the
    # verdict reflects the graph, not BN calibration
    return mcl_term_grad_norms(model, batch, torch.Generator(device=dev).manual_seed(1),
                               MCLConfig(True, True, True), views_train_mode=True,
                               method=method)


def gate4_train_mcl(voc_root, names, labels_path, out_dir, steps: int = 100,
                    backbone: str = "efficientnet-b1", crop: int = 64,
                    min_decrease: float = 0.20, quick: bool = False,
                    lr: float = 1e-3, device: str = "cuda") -> dict:
    """Config #4: MCL memorisation gate through ``cli.train_mcl``: `steps`
    batches over 2 images must MATERIALLY reduce the loss (>= min_decrease,
    first-3-median to last-10-median), and every curriculum loss term must
    have a live parameter gradient at the checkpoint it wrote
    (``model_0.pth``).

    The decrease criterion is asserted in every tier; quick (cli/gates.py
    --quick) pro-rates to 60 steps / min_decrease=0.10 and probes liveness
    by one jvp.  `lr` exists so that a broken run (lr 0) can be
    reproduced: it must fail on the decrease with its gradients live."""
    from muscle_tpu_torch.cli import train_mcl

    t0 = time.time()
    session = os.path.join(out_dir, "gate4_session")
    logd = os.path.join(out_dir, "gate4_logs")
    shutil.rmtree(session, ignore_errors=True)  # reruns start clean
    shutil.rmtree(logd, ignore_errors=True)
    list_path = os.path.join(out_dir, "gate4_list.txt")
    # repeat the names so one epoch has `steps` batches of 2
    with open(list_path, "w") as f:
        for i in range(steps * 2):
            f.write(names[i % 2] + "\n")
    # the epoch-end rapid eval iterates the eval list verbatim: hand it the
    # two UNIQUE names, not the repeated train list
    eval_path = os.path.join(out_dir, "gate4_eval_list.txt")
    with open(eval_path, "w") as f:
        f.write(names[0] + "\n" + names[1] + "\n")
    launches0 = _mbconv_launches()
    train_mcl.main([
        "--train_list", list_path, "--eval_list", eval_path,
        "--voc12_root", voc_root, "--cls_labels", labels_path,
        "--session_name", session, "--log_dir", logd,
        "--backbone", backbone, "--batch_size", "2", "--max_epoches", "1",
        "--crop_size", str(crop), "--vis_every", str(max(steps - 1, 1)),
        "--log_every", "1", "--lr", str(lr),  # memorisation config: the
        # reference's 1e-4 is tuned for 10582 images x 16 epochs, not a
        # 100-step 2-image run
        "--device", device,
    ])
    launches = _mbconv_launches() - launches0  # the overlays' and the eval's
    t_train = time.time() - t0
    rows = _metric_rows(logd)
    losses = [r["loss"] for r in rows]
    loss_first = float(np.median(losses[:3]))
    loss_last = float(np.median(losses[-10:]))
    decreased = loss_last <= (1.0 - min_decrease) * loss_first
    finite = all(np.isfinite(v) for r in rows for k, v in r.items() if k != "step")
    ckpt = os.path.join(session, "model_0.pth")
    grad_norms = _mcl_grad_norm_liveness(
        voc_root, names, np.load(labels_path, allow_pickle=True).item(), ckpt, crop=crop,
        backbone=backbone, method="jvp" if quick else "jacrev", device=device,
    )
    live_floor = 1e-12 if quick else 1e-7  # jvp: any nonzero = live
    grads_live = all(np.isfinite(v) and v > live_floor for v in grad_norms.values())
    vis_dir = os.path.join(logd, "vis")
    vis = os.listdir(vis_dir) if os.path.isdir(vis_dir) else []
    return {
        "gate": "4_train_mcl_memorise",
        "steps": steps,
        "min_decrease_pct": round(100.0 * min_decrease, 1),
        "loss_first": round(loss_first, 4),
        "loss_last": round(loss_last, 4),
        "loss_decrease_pct": round(100.0 * (1.0 - loss_last / loss_first), 1),
        "finite": bool(finite),
        "grad_norms": {k: float(f"{v:.3e}") for k, v in grad_norms.items()},
        "grads_live": bool(grads_live),
        "checkpoint": os.path.exists(ckpt),
        "vis_pngs": len(vis),
        "quick": bool(quick),
        "criterion": (
            f"finite AND per-term grads live AND checkpoint written AND "
            f"loss_last <= {1.0 - min_decrease:.2f} * loss_first over "
            f"{steps} steps @ lr {lr:g}"
        ),
        "passed": bool(finite and grads_live and decreased and os.path.exists(ckpt)),
        "mbconv_launches": launches,
        "seconds_cli": round(t_train, 1),
        "seconds": round(time.time() - t0, 1),
    }


def flax_init(model, seed: int):
    """The JAX package's ``model.init`` distribution for a fresh model:
    truncated lecun-normal conv and linear kernels and zero biases
    (``models.init_weights``), batch norms at the identity (scale 1, shift
    0, running mean 0 and variance 1)."""
    import torch

    from muscle_tpu_torch.models import init_weights

    init_weights(model, torch.Generator().manual_seed(seed))
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return model


def gate6_convergence(voc_root, names, labels_path, out_dir, steps: int = 300,
                      crop: int = 64, backbone: str = "efficientnet-b1",
                      quick: bool = False, fullsize: bool = False,
                      device: str = "cuda") -> dict:
    """Config #6: END-TO-END convergence evidence.

    (a) MCL: train `steps` batches on the structured synthetic VOC and
        assert the epoch-end CAM-mIoU metric IMPROVES over the random init,
        i.e. the classifier's CAMs localise, not merely that losses fall.
    (b) seg: train on GT-aligned soft pseudo-masks and assert val seg mIoU
        improves over init.

    Runs the training loops in-process (gates 4/5 cover the CLI plumbing)
    so init and final evals share one model instance; the models start
    from ``flax_init`` (the JAX gate's ``model.init``) and their evals run
    the stride-1 blocks through the MBConv kernel (``fuse_mbconv=384``).
    Writes the trained states to ``gate6_enc.pth`` / ``gate6_dec.pth``."""
    import torch
    from PIL import Image

    from muscle_tpu_torch.data import transforms as T
    from muscle_tpu_torch.data.voc12 import get_img_path
    from muscle_tpu_torch.evaluation import confusion_matrix, iou_from_confusion, threshold_sweep
    from muscle_tpu_torch.inference import CamTTAEngine, SegTTAEngine
    from muscle_tpu_torch.models import MuSCLe
    from muscle_tpu_torch.training import (
        MCLConfig,
        SegConfig,
        make_adam,
        mcl_train_step,
        seg_train_step,
    )

    t0 = time.time()
    dev = torch.device(device)
    if dev.type == "cuda":  # f32, as the JAX package trains
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    labels = np.load(labels_path, allow_pickle=True).item()
    imgs = [Image.open(get_img_path(n, voc_root)).convert("RGB") for n in names]
    gts = [
        np.array(Image.open(os.path.join(voc_root, "SegmentationClass", n + ".png")))
        for n in names
    ]
    labs = [labels[n] for n in names]
    batch_imgs = np.stack(
        [T.color_norm(np.asarray(im.resize((crop, crop)))) for im in imgs]
    ).astype(np.float32)
    batch_labels = torch.from_numpy(np.stack(labs).astype(np.float32)).to(dev)
    img_t = torch.from_numpy(batch_imgs).to(dev)
    flipped = torch.from_numpy(np.ascontiguousarray(batch_imgs[:, :, ::-1])).to(dev)

    side = -(-max(max(im.size) for im in imgs) // 64) * 64
    max_side = max(max(im.size) for im in imgs)
    launches = {"cam_eval": 0, "seg_eval": 0}

    # ---- (a) MCL: CAM mIoU before/after -----------------------------------
    def cam_miou(model, tag):
        d = os.path.join(out_dir, f"gate6_cam_{tag}")
        os.makedirs(d, exist_ok=True)
        engine = CamTTAEngine(model, scales=(1.0,), out_side=side, max_side=max_side,
                              device=dev)
        before = _mbconv_launches()
        for rec in engine.run_batch(imgs, names, labs):
            np.save(os.path.join(d, rec["name"] + ".npy"), rec["sgc"])
        launches["cam_eval"] += _mbconv_launches() - before
        gt_dir = os.path.join(voc_root, "SegmentationClass")
        return max(
            r["mIoU"]
            for r in threshold_sweep(d, gt_dir, names, np.arange(0.20, 0.52, 0.02))
        )

    model = flax_init(MuSCLe(backbone_name=backbone, mode="enc", last_pooling=False,
                             fuse_mbconv=384), seed=0).to(dev)
    miou_cam_init = cam_miou(model, "init")
    opt = make_adam(model.trained_parameters(), 3e-4, 5e-5)
    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = MCLConfig(use_imc=True)
    for i in range(steps):
        # light augmentation: per-step flip keeps memorisation honest
        batch = {"img": flipped if i % 2 else img_t, "label": batch_labels}
        mcl_train_step(model, opt, batch, cfg, gen)
    miou_cam_final = cam_miou(model, "final")
    # persist the trained states: the runner feeds them back through the
    # fidelity gates (the 1/2/3/7 '_trained' rows)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(out_dir, "gate6_enc.pth"))

    # ---- (b) seg: val mIoU before/after ------------------------------------
    def seg_miou(model):
        engine = SegTTAEngine(model, scales=(1.0,), out_side=side, max_side=max_side,
                              device=dev)
        conf = np.zeros((21, 21), np.int64)
        before = _mbconv_launches()
        for rec, gt in zip(engine.run_batch(imgs, names), gts):
            conf += confusion_matrix(
                np.argmax(rec["probs"], axis=-1).astype(np.uint8), gt, 21
            )
        launches["seg_eval"] += _mbconv_launches() - before
        return iou_from_confusion(conf)["mIoU"]

    dec = flax_init(MuSCLe(backbone_name=backbone, mode="dec", bifpn_layers=1,
                           last_pooling=True, fuse_mbconv=384), seed=2).to(dev)
    miou_seg_init = seg_miou(dec)
    opt_seg = make_adam(dec.trained_parameters(), 3e-4, 1e-5)
    # GT-aligned soft pseudo-masks at crop size
    masks = []
    for gt in gts:
        g = np.asarray(
            Image.fromarray(gt).resize((crop, crop), Image.NEAREST), np.int32
        )
        g = np.where(g == 255, 0, g)
        soft = np.full((crop, crop, 21), 0.05, np.float32)
        for c in range(21):
            soft[..., c][g == c] = 1.0
        masks.append(soft)
    batch_s = {"img": img_t, "label": batch_labels,
               "mask": torch.from_numpy(np.stack(masks)).to(dev)}
    scfg = SegConfig(k=32)
    for _ in range(steps):
        seg_train_step(dec, opt_seg, batch_s, scfg, gen)
    miou_seg_final = seg_miou(dec)
    torch.save({k: v.detach().cpu() for k, v in dec.state_dict().items()},
               os.path.join(out_dir, "gate6_dec.pth"))

    return {
        "gate": "6_convergence",
        "steps": steps,
        "cam_miou_init": round(float(miou_cam_init), 4),
        "cam_miou_final": round(float(miou_cam_final), 4),
        "seg_miou_init": round(float(miou_seg_init), 4),
        "seg_miou_final": round(float(miou_seg_final), 4),
        "quick": bool(quick),
        # a short random-init run reaches only a few mIoU points absolute on
        # the 4-image synthetic val: require a material gain in absolute and
        # relative terms.  The quick tier (200 steps, past the CAM
        # convergence knee) asserts a +0.5 CAM margin above the seed/step
        # jitter; the fullsize tier trains at crop 64 but evaluates the
        # 375-500 px images (each crop covers ~1.6% of an image), so it
        # asserts seg improvement + CAM non-degradation
        "criterion": (
            "cam_final > cam_init + 0.5 AND seg_final > seg_init + 1.0 "
            "AND seg_final > 2x seg_init (quick, 200 steps)"
            if quick else
            "seg_final > seg_init + 1.0 AND seg_final > 1.5x seg_init AND "
            "cam_final > 0.75x cam_init (fullsize: crop-64 training vs "
            "full-size eval — margins asserted by the default tier)"
            if fullsize else
            "cam_final > cam_init + 1.0 AND seg_final > seg_init + 2.0 "
            "AND seg_final > 3x seg_init"
        ),
        "passed": bool(
            (np.isfinite(miou_cam_final)
             and miou_cam_final > miou_cam_init + 0.5
             and miou_seg_final > miou_seg_init + 1.0
             and miou_seg_final > 2.0 * miou_seg_init)
            if quick else
            (np.isfinite(miou_cam_final)
             and miou_seg_final > miou_seg_init + 1.0
             and miou_seg_final > 1.5 * miou_seg_init
             and miou_cam_final > 0.75 * miou_cam_init)
            if fullsize else
            (miou_cam_final > miou_cam_init + 1.0
             and miou_seg_final > miou_seg_init + 2.0
             and miou_seg_final > 3.0 * miou_seg_init)
        ),
        "mbconv_launches": launches,
        "seconds": round(time.time() - t0, 1),
    }


def _seg_grad_norm_liveness(voc_root, names, labels, mask_dir, checkpoint: str,
                            crop: int = 64, method: str = "jacrev", device: str = "cuda"):
    """Per-term (CE, BEACON) liveness at the gate-5 trained checkpoint (see
    _mcl_grad_norm_liveness).  Returns (norms, values).

    The probe runs SegConfig(k=8): BEACON only contributes for (image,
    class) pairs with more than k PREDICTED boundary pixels (the
    reference's own skip gate), and k is a data-engagement knob, not a
    graph property.  The small-k probe engages the term so the gate judges
    the GRAPH; the values let the caller exempt a term whose value is
    exactly zero by its own engagement gate (dead paths have nonzero value
    + zero grad and are still caught)."""
    import torch
    from PIL import Image

    from muscle_tpu_torch.cli.common import load_model_state
    from muscle_tpu_torch.data import transforms as T
    from muscle_tpu_torch.data.voc12 import get_img_path
    from muscle_tpu_torch.models import MuSCLe
    from muscle_tpu_torch.training import SegConfig, seg_term_grad_norms

    dev = torch.device(device)
    model = MuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1,
                   last_pooling=True)
    load_model_state(checkpoint, model)
    model.to(dev)
    imgs, labs, masks = [], [], []
    for n in names[:2]:
        img = Image.open(get_img_path(n, voc_root)).convert("RGB").resize((crop, crop))
        imgs.append(T.color_norm(np.asarray(img)))
        labs.append(labels[n])
        soft = np.load(os.path.join(mask_dir, n + ".npy")).astype(np.float32)
        m = np.stack(
            [
                np.asarray(
                    Image.fromarray(soft[..., c]).resize((crop, crop), Image.BILINEAR)
                )
                for c in range(soft.shape[-1])
            ],
            axis=-1,
        )
        masks.append(m)
    batch = {
        "img": np.stack(imgs).astype(np.float32),
        "label": np.stack(labs).astype(np.float32),
        "mask": np.stack(masks).astype(np.float32),
    }
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    return seg_term_grad_norms(model, batch, SegConfig(k=8),
                               torch.Generator(device=dev).manual_seed(1),
                               return_values=True, method=method)


def gate5_train_muscle(voc_root, names, labels_path, out_dir, steps: int = 100,
                       crop: int = 64, min_decrease: float = 0.20,
                       quick: bool = False, device: str = "cuda") -> dict:
    """Config #5: seg memorisation gate through ``cli.train_muscle`` (CE +
    BEACON on GT-aligned soft pseudo-masks) + its CRF'd val eval: the loss
    must fall >= min_decrease over `steps` batches of 2 images and both
    loss terms must carry live parameter gradients at the checkpoint it
    wrote (``model_0.pth``).

    quick: BEACON liveness is reported but not asserted: the term
    contributes only when predicted boundaries exist, and whether the
    FINAL checkpoint yields boundaries on the fixed probe batch depends on
    the step count.  The full tier asserts both terms."""
    from PIL import Image

    from muscle_tpu_torch.cli import train_muscle
    from muscle_tpu_torch.data.voc12 import get_img_path

    t0 = time.time()
    mask_dir = os.path.join(out_dir, "gate5_masks")
    os.makedirs(mask_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for n in names:
        img = Image.open(get_img_path(n, voc_root))
        w, h = img.size
        gt = np.array(Image.open(os.path.join(voc_root, "SegmentationClass", n + ".png")))
        soft = rng.uniform(0, 0.1, (h, w, 21)).astype(np.float32)
        # production walk pseudo-masks (infer_irn) zero every foreground
        # class absent from the image: mirror that so the CLI's default
        # --pack_mask -1 (exact packed upload) applies to the gate run too
        present = set(np.unique(gt[gt < 21]).tolist()) | {0}
        for c in range(21):
            if c not in present:
                soft[..., c] = 0.0
        for c in range(21):
            soft[..., c][gt == c] = 1.0  # GT-aligned soft pseudo-masks
        np.save(os.path.join(mask_dir, n + ".npy"), soft.astype(np.float16))

    session = os.path.join(out_dir, "gate5_session")
    logd = os.path.join(out_dir, "gate5_logs")
    shutil.rmtree(session, ignore_errors=True)
    shutil.rmtree(logd, ignore_errors=True)
    list_path = os.path.join(out_dir, "gate5_list.txt")
    with open(list_path, "w") as f:
        for i in range(steps * 2):
            f.write(names[i % 2] + "\n")
    eval_path = os.path.join(out_dir, "gate5_eval_list.txt")  # see gate 4
    with open(eval_path, "w") as f:
        f.write(names[0] + "\n" + names[1] + "\n")
    launches0 = _mbconv_launches()
    train_muscle.main([
        "--train_list", list_path, "--eval_list", eval_path,
        "--voc12_root", voc_root, "--cls_labels", labels_path,
        "--mask_root", mask_dir, "--session_name", session, "--log_dir", logd,
        "--pretrained", "b1", "--bifpn", "1", "--batch_size", "2",
        "--max_epoches", "1", "--crop_size", str(crop), "--k", "32",
        "--crf", "1", "--vis_every", str(max(steps - 1, 1)),
        "--log_every", "1", "--lr", "3e-4",  # memorisation lr (the
        # reference's 1e-5 is a full-dataset fine-tuning rate)
        "--device", device,
    ])
    launches = _mbconv_launches() - launches0  # the overlays' and the eval's
    t_train = time.time() - t0
    rows = _metric_rows(logd)
    losses = [r["loss"] for r in rows]
    loss_first = float(np.median(losses[:3]))
    loss_last = float(np.median(losses[-10:]))
    decreased = loss_last <= (1.0 - min_decrease) * loss_first
    finite = all(np.isfinite(v) for r in rows for k, v in r.items() if k != "step")
    ckpt = os.path.join(session, "model_0.pth")
    grad_norms, grad_values = _seg_grad_norm_liveness(
        voc_root, names, np.load(labels_path, allow_pickle=True).item(),
        mask_dir, ckpt, crop=crop, method="jvp" if quick else "jacrev", device=device,
    )
    # quick: beacon liveness reported, not asserted (see docstring)
    beacon_engaged = any(abs(r.get("loss_beacon", 0.0)) > 1e-9 for r in rows)
    required = {"seg"} if quick else set(grad_norms)
    # a term whose probe VALUE is exactly zero is not engaged on this data
    # by its own count>k gate (the reference skips it identically); exempt
    # it LOUDLY: dead paths carry nonzero value + zero grad and still fail
    probe_not_engaged = sorted(
        k for k in required if grad_values.get(k, 1.0) == 0.0 and grad_norms[k] == 0.0
    )
    required -= set(probe_not_engaged)
    live_floor = 1e-12 if quick else 1e-7  # jvp: any nonzero = live
    grads_live = all(
        np.isfinite(grad_norms[k]) and grad_norms[k] > live_floor for k in required
    )
    return {
        "gate": "5_train_muscle_memorise",
        "steps": steps,
        "min_decrease_pct": round(100.0 * min_decrease, 1),
        "loss_first": round(loss_first, 4),
        "loss_last": round(loss_last, 4),
        "loss_decrease_pct": round(100.0 * (1.0 - loss_last / loss_first), 1),
        "loss_beacon_last": round(float(rows[-1]["loss_beacon"]), 6),
        "finite": bool(finite),
        "grad_norms": {k: float(f"{v:.3e}") for k, v in grad_norms.items()},
        "grads_live": bool(grads_live),
        "beacon_engaged": bool(beacon_engaged),
        "probe_not_engaged": probe_not_engaged,
        "checkpoint": os.path.exists(ckpt),
        "quick": bool(quick),
        "passed": bool(finite and decreased and grads_live and os.path.exists(ckpt)),
        "mbconv_launches": launches,
        "seconds_cli": round(t_train, 1),
        "seconds": round(time.time() - t0, 1),
    }
