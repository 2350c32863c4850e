#!/usr/bin/env python3
"""Drive the PyTorch port's CAM-generation, IRN-refinement,
segmentation-inference (in float32 and in bfloat16), MCL-training and
segmentation-training (each in float32 and in bfloat16) and IRN-training
paths on one CUDA card, their data-parallel runs over several ranks, the
CAM and seg engines with one image's height split over several ranks,
and its file-based CLIs (infer_mcl, the gate harness, real_run) on a
synthetic VOC tree.

    python3 chip_smoke.py            # every phase, the full check
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,kernels,seg
    python3 chip_smoke.py --phases build,bf16
    python3 chip_smoke.py --phases train_mcl
    python3 chip_smoke.py --phases build,train_seg,train_irn
    python3 chip_smoke.py --phases build,profile        # where the device time goes
    python3 chip_smoke.py --phases build,bf16,profile   # the same for the bf16 paths
    python3 chip_smoke.py --phases build,train_mcl_bf16,train_seg_bf16
    python3 chip_smoke.py --phases build,dp              # data parallelism alone
    python3 chip_smoke.py --phases build,spatial         # spatial sharding alone
    python3 chip_smoke.py --phases build,kernels,spatial # with the bf16 stripes' kernel check
    python3 chip_smoke.py --phases build,device_exec     # device-only rates of the engines
    python3 chip_smoke.py --phases build,kernels,gates   # the CLIs and gates 4-6

Phases:
  build    compile every CUDA kernel of the paths from the checkout
           (nvcc, sm_90a, one process per source, in parallel) and print
           the build seconds;
  kernels  hold each kernel against its plain PyTorch version and time
           both: the MBConv block at the b3 CAM shapes (VOC 500x375 image,
           TTA scales 1 and 2, B = 16, with and without windows; bounds
           on the f32 pipes and with the products on the tensor cores) and
           at the 9 b7 seg shapes (square seg canvases of scales 1 and
           1.75, B = 8, with and without windows) and at the 14 b1
           shapes of the gates phase's evals (enc's 11, dec's 3 on its
           stride-32 grid; 64 x 64 canvas, B = 8, windowed to the quick
           tier's four images); the
           stencil walk at B = 8, C = 20, 64 steps on the 128/96/64 walk
           grids (the 512/384/256 buckets) and a 375x500 image's own
           94x125 grid, beside 64 sparse CSR products (torch.sparse.mm,
           its library yardstick); the banded walk at C = 20, 64 steps on
           grid 64 (two images) and grid 128 (one image), beside 64 dense
           torch.matmul steps (its library yardstick); both walks at the
           edges of their tilings (ragged grids, one row, one class, more
           classes than a chunk, band >= V), each repeating itself bit for
           bit; then the MBConv kernel's bf16 instantiation at the same b3
           and b7 shapes, windowed, against its bf16 plain version (max
           |diff| <= 2^-7 of the plain output's largest value), repeating
           itself bit for bit, its bound with bf16 products and bytes, and
           the f32 kernel's ms at the same shape beside it; and the f32
           kernel on stripes (each b3 and b7 shape split into 2 and 4
           stripes in one process, each with its halo rows, the SE
           partials of the stripes' own rows summed by hand between the
           kernel's two stages) against the plain version (1e-4), and the
           bf16 instantiation on stripes the same way against the bf16
           plain version (2^-7 of its output's largest value);
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
  seg      run SegTTAEngine with MuSCLe-b7 dec (BiFPN 3 x 256,
           fuse_mbconv=384, float32, seeded random weights, the head
           calibrated so labels vary) over batches of 4 synthetic
           VOC-shaped images at the six scales x flip, --fast 0 (f32
           probabilities, RGB upload) and --fast 1 (stride-4 grid, f16,
           4:2:0 tight upload, labels output), each with the kernel and
           with the plain blocks; counts the launches, compares, and times
           the mean-field CRF (t = 4) on the card and checks the native
           CRF against it on one image; then the engine's parity switches
           at --fast 0 on one batch of 4 (lowres=False: the input-size
           'seg' logits; window_exact=False: the top-left canvas without
           window masks, the kernel's unwindowed form; both off; and the
           default beside them), each with the kernel and with the plain
           blocks: 288 launches, the seg rules, batch seconds, images/s and
           peak memory, and lowres=False within 1e-4 of lowres=True
           through the kernel; then the four kernel engines timed in
           turns, SWITCH_TURNS turns over the 4 batches each, with each
           setting's median images/s, its range and its ratio to the
           default's median;
  bf16     the bf16 serving paths, each beside f32 in the same run: the CAM
           engine at the JAX bench's CamBench configuration (b3 enc,
           compute_dtype bf16, lowres, 4 classes, stride-4 grid, uint8
           download, tight 4:2:0 upload) over 4 batches of 8 images, with
           the kernel and with the plain blocks (scores within 1e-2; each
           SGC map's mean within 5e-3 away from the zeroing, or within
           twice the map's own bf16-vs-f32 distance), and against the f32
           engine (SGC, printed); the seg engine at SegBench's (b7 dec,
           BiFPN 3 x 256, bf16, stride-4 grid, tight 4:2:0 upload, labels,
           six scales x flip) over 2 batches of 4, kernel vs plain blocks:
           labels agree on >= 99% of each image's pixels whose f32 top-two
           probability margin exceeds 1e-2, or disagree on at most twice
           what the plain bf16 blocks disagree with f32 there; 288 bf16
           MBConv launches per batch; the same at window_exact=False on
           one batch (the bf16 kernel's unwindowed form); the IRN refiner
           with its edge model in bf16 and the stencil walk in f32 over 2
           batches of 8, labels within 99% of the f32 refiner's; and the
           count of bf16 (and tf32) HGMMA instructions in the built MBConv
           library (cuobjdump);
  train_mcl
           train MuSCLe-b3 enc (float32, TF32 off, seeded random weights,
           plain blocks) at the train_mcl default, batch 16, crop 448,
           views 224, on numpy-made 4:2:0 batches: 2 warm-up and 5 timed
           iterations of the epoch-0 configuration (step A) and of the
           epoch-12 one (step A with IMC, step B with PixPro and EMD);
           step A and step B ms per iteration, images/s, peak memory, the
           device time by kernel name over two epoch-12 iterations, every
           kernel's launches during training (0: the MBConv kernel has no
           backward), every loss term's gradient norm (train-mode
           views: at least 1e-6 of the largest term's), and one step A and
           one step B at b1 held to the same steps on the CPU: loss
           terms, gradients and BN statistics (and the same check with
           TF32 on, which must fail it); step A's device ms, wall ms and
           launches with the backbone's Flax-style BatchNorm2d and with
           plain torch.nn.BatchNorm2d;
  train_seg
           train MuSCLe-b7 dec (BiFPN 3 x 256, float32, TF32 off, seeded
           random weights, the head calibrated, fuse_mbconv=384) at the
           train_muscle default, batch 6, crop 448, k 128, step 7, on
           numpy-made 4:2:0 batches with packed soft masks, labelled with
           the classes the model's map covers most so BEACON engages: 2
           warm-up and 5 timed steps (ms, images/s, peak memory; BEACON
           nonzero on every timed step), the kernels' launches in the
           steps (0) and in the epoch-end eval after them (one scale-1
           SegTTAEngine batch of 4 images with the fused blocks: 48 MBConv
           launches, probabilities within 1e-3 of the plain blocks'),
           BEACON's own forward + backward ms, both terms' gradient norms,
           and one step at b1 (BiFPN 1 x 64, crop 64, k 16) held to the
           CPU with the same BEACON draws: loss terms, gradients, BN
           statistics, BEACON's boundary counts equal and its sign flips
           counted, and the same step with TF32 on, which must fail it;
  train_irn
           train IRNNet (ResNet-50 frozen, seeded random weights) at the
           train_irn default, batch 8, crop 512, numpy-made 4:2:0 batches
           with bit-packed affinity masks: 2 warm-up and 5 timed steps (ms,
           images/s, peak memory), the kernels' launches (0), the backbone
           unchanged, and one crop-64 step held to the CPU (loss terms,
           head gradients), and with TF32 on, which must fail it;
  train_mcl_bf16
           bf16 MCL training beside f32, in turns in the same run (1
           warm-up and 3 timed iterations each): MuSCLe-b3 enc at the JAX
           benches' TrainBench (batch 16, crop 448, 4:2:0 upload, step A
           with IMC) and CurriculumBench (the same, then step B with
           PixPro and EMD on views of 224), the bf16 model starting from
           a bf16 classifier kernel (the JAX package's bf16 init) that its
           first Adam step promotes to float32: step ms, images/s and peak
           memory of each dtype, the device time by kernel name and busy
           share of two bf16 curriculum iterations, no kernel launched,
           every loss term's gradient norm at bf16, and steps A and B at
           b1 on the card and on the CPU at bf16, each quantity within 2x
           (mean; 3x max) the CPU's own bf16-vs-f32 distance;
  train_seg_bf16
           bf16 seg training beside f32 in the same way at the
           train_muscle defaults (b7 dec, BiFPN 3 x 256, batch 6, crop
           448, k 128; BEACON nonzero on every timed bf16 step), the
           device time of two bf16 steps, no kernel launched in the
           steps, the bf16 epoch-end eval (one scale-1 SegTTAEngine batch
           of 4 images, counts zeroed just before it: 48 launches of the
           MBConv kernel's bf16 instantiation, labels held to the plain
           bf16 blocks' by the bf16 phase's rule), both terms' gradient
           norms, and one b1 step held to the CPU at bf16 as above;
  dp       data parallelism over torch.distributed (parallel/mesh.py): 2
           ranks sharing card 0 over gloo (two ranks on one card give no
           scaling number) and, where torch.cuda.device_count() >= 2, also
           min(cards, 4) ranks one a card over NCCL, each a spawned process;
           every W-rank result is held to the one-process run on card 0 on
           the same global batch: steps A (IMC, ER) and B, the seg step and
           the IRN step at b1, crop 64, global batch 4, f32 (TF32 off: the
           card-vs-CPU rule) and bf16 (the train_*_bf16 rule; IRN f32
           only), every rank's parameters bit-identical after the step; MCL
           b3 at batch 16, crop 448 (step A) and seg b7 + BiFPN 3 x 256 at
           3 images a rank, crop 448: 1 warm-up step (loss terms within
           1e-4 relative) and 2 timed, the step ms, the gradient all-reduce
           alone (ms, bytes) and the peak memory of each rank; the CAM
           engine (b3, --fast 0) over 2 batches of 8 and the seg engine
           (b7) over 1 batch of 4, each rank on its rows of every batch,
           collected and held to the one-process engine (the main and seg
           phases' rules), the MBConv launches of each rank; the same
           engines with mesh=make_mesh(), every rank given each global
           batch and returning the whole batch's records (bit-identical
           on every rank, held to one process by the same rules); and
           propagate_to_edge_sharded at grid 128 (V 16384, T 1 GiB, V / W
           columns a rank), 64 steps, against the one-card dense walk
           (1e-5 of its largest value);
  spatial  spatial sharding (parallel/spatial.py): the CAM engine at
           infer_mcl's defaults (b3, fused, --fast 1) on batches of 1 and
           8 images and the seg engine at infer_seg's without the CRF (b7
           + BiFPN 3 x 256, six scales x flip, f16 probabilities) on
           batches of 1 and 4, in f32 and in bf16, with each canvas's
           height split over a model group: 2 ranks sharing card 0 over
           gloo and, where there are several cards, 4 (or 2) one a card
           over NCCL as 1 x 4 and 2 x 2 meshes, each a spawned process
           given every whole batch (the engine splits it over the data
           rows); every rank returns the same records, held to one
           process on card 0 (f32: the main and seg phases' rules; bf16:
           the bf16 phase's against one process's bf16 engine), 23
           MBConv launches a b3 forward and 48 a b7 forward on every rank
           (the bf16 instantiation's for the bf16 engines); a seg batch of
           1 at lowres=False, window_exact=False (f32) likewise; each batch's
           latency beside one process's, images/s, the exchanges a
           forward (count, bytes, ms with the device synchronised around
           each) and peak memory a rank;
  device_exec
           each engine's bench_device_exec (the host prep and upload once,
           then the device pipeline alone on resident tensors) at the
           main phase's CAM configuration (b3, --fast 0), the bf16
           phase's CamBench one, the seg phase's --fast 1 labels one and
           the irn phase's: one call's launches (92 MBConv a CAM batch of
           8, 288 a seg batch of 4, one stencil walk an IRN batch) and its
           buffer against the engine's own result, 10 chained calls timed
           by CUDA events (device-only images/s) beside the engine's
           streaming rate over 4 copies of the batch;
  gates    the port's CLIs as a user runs them, each its own process
           (python -m), on a synthetic VOC tree (gates.build_synthetic_voc)
           of 16 images of 375-500 px: prints PIL.__version__; infer_mcl at
           its defaults (b3, seeded random weights, --fast 1, the stride-1
           blocks through the MBConv kernel: 23 launches per forward,
           images/s); cli.gates --synthetic --quick --gates 4,5,6 (MCL and
           seg memorisation through train_mcl and train_muscle, convergence
           in-process, b1 at crop 64 on the gate CLI's own small tree),
           every row passed, each gate's seconds and the MBConv launches
           of the trainers' and gate 6's evals; and cli.real_run --stages
           seg,eval with a seeded random b7 + BiFPN 3 x 256 at its
           defaults (six scales x flip, the CRF on the card): one PNG per
           image, mIoU finite in [0, 100], 48 MBConv launches per forward,
           images/s and the CRF's ms per image.  Each CLI reports its own
           kernel counts (its process starts at 0), summed into
           launches_gates;
  profile  (not run by default) device time by kernel name over --fast 0
           CAM batches, with and without the MBConv kernel, over IRN
           batches with the stencil kernel, and over one seg batch, and
           the device's busy share of the wall time; with the bf16 phase
           chosen too, over the bf16 paths at their bench configurations
           instead.

Prints the card's name and power limit (first, and again before the
summary), one JSON line per kernel shape, a {"kernels": [...]} summary
line, and last the result line
{"ok": true, "device": {...}}.  Exits non-zero, with no result line,
when there is no CUDA card, when the port is not beside this script, or
when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
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
# b1 stride-1 blocks of the gates phase's evals, one per shape: gate 6's
# CAM engine and the trainers' epoch-end evals (enc, last_pooling=False),
# and gate 6's seg engine (dec, last_pooling=True: blocks 0-15 as enc's,
# 17-22 on a stride-32 grid, 2 x 2 on the 64 x 64 canvas)
B1_BLOCKS = {
    "_blocks_0": (2, 32, 16, 1, 3),
    "_blocks_1": (2, 16, 16, 1, 3),
    "_blocks_3": (4, 24, 24, 6, 3),
    "_blocks_6": (8, 40, 40, 6, 5),
    "_blocks_9": (16, 80, 80, 6, 3),
    "_blocks_12": (16, 80, 112, 6, 5),
    "_blocks_13": (16, 112, 112, 6, 5),
    "_blocks_16": (16, 112, 192, 6, 5),
    "_blocks_17": (16, 192, 192, 6, 5),
    "_blocks_21": (16, 192, 320, 6, 3),
    "_blocks_22": (16, 320, 320, 6, 3),
    "dec_blocks_17": (32, 192, 192, 6, 5),
    "dec_blocks_21": (32, 192, 320, 6, 3),
    "dec_blocks_22": (32, 320, 320, 6, 3),
}
# b7 stride-1 blocks of the seg path (last_pooling=True), one per shape
B7_BLOCKS = {
    "_blocks_0": (2, 64, 32, 1, 3),
    "_blocks_1": (2, 32, 32, 1, 3),
    "_blocks_5": (4, 48, 48, 6, 3),
    "_blocks_12": (8, 80, 80, 6, 5),
    "_blocks_19": (16, 160, 160, 6, 3),
    "_blocks_28": (16, 160, 224, 6, 5),
    "_blocks_29": (16, 224, 224, 6, 5),
    "_blocks_39": (32, 384, 384, 6, 5),
    "_blocks_51": (32, 384, 640, 6, 3),
}
VOC_HW = (375, 500)
TTA_BATCH = 16  # 8 images x (orig, flip)
SEG_BATCH = 8  # 4 images x (orig, flip)
KERNEL_TOL = 1e-4  # f32 kernel vs f32 plain: summation order only
# bf16 kernel vs bf16 plain, relative to the plain output's largest value:
# y rounded once in both (one ulp 2^-8 of its power of two), the f32 sums
# in another order, and the kernel keeps each depthwise product exact where
# the plain version (as the Pallas kernel) rounds it
BF16_REL = 2.0 ** -7
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
# the tilings' edges (tests/test_torch_kernels_cuda.py): stencil (B, C, H,
# W, steps) on 32 x 16 tiles, banded (B, C, V, band, steps) on 64 columns
STENCIL_EDGES = ((2, 5, 37, 45, 8), (1, 4, 20, 9, 8), (2, 3, 1, 40, 8), (8, 20, 128, 128, 4),
                 (1, 1, 21, 19, 8), (2, 33, 19, 35, 6), (1, 120, 17, 33, 4))
BANDED_EDGES = ((2, 5, 700, 40, 8), (1, 4, 300, 400, 6), (1, 1, 500, 30, 8), (2, 33, 400, 25, 6),
                (1, 5, 97, 3, 1))
# kernel -> (source under muscle_tpu_torch/csrc, the TPU kernel's pallas_call)
KERNEL_SOURCES = {
    "mbconv_stride1": ("mbconv.cu", "muscle_tpu/ops/pallas/mbconv.py:299"),
    # the same pallas_call at compute_dtype=bf16, as its own kernel here
    "mbconv_bf16": ("mbconv.cu", "muscle_tpu/ops/pallas/mbconv.py:299"),
    "stencil_walk": ("stencil_walk.cu", "muscle_tpu/ops/pallas/stencil_walk.py:102"),
    "banded_walk": ("banded_walk.cu", "muscle_tpu/ops/pallas/banded_walk.py:109"),
}
IRN_BATCHES = 4  # timed refinement batches of 8 images per walk
SEG_SCALES = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)
SEG_BATCHES = 4  # timed seg TTA batches of 4 images per engine
SEG_PER_BATCH = 4
SEG_LAUNCHES = 48 * len(SEG_SCALES)  # fused b7 blocks per forward x forwards per batch
SEG_PROBS_TOL = 1e-3  # f32 probabilities, kernel vs plain blocks through 55 blocks + BiFPN
SEG_LABEL_AGREE = 0.999  # labels: kernel and plain blocks, near-ties of random weights
# the seg engine's parity switches (the JAX engine's lowres and window_exact)
# at --fast 0, the default beside them
SEG_SWITCHES = {"default": {}, "lowres_false": dict(lowres=False),
                "window_exact_false": dict(window_exact=False),
                "both_off": dict(lowres=False, window_exact=False)}
# lowres=False against lowres=True through the kernel, f32 probabilities: the
# 1x1 head commutes with the bilinear upsample (the JAX package holds it to
# 2e-5 at b1)
SEG_LOWRES_TOL = 1e-4
SWITCH_TURNS = 3  # timed turns of the switch engines, each over the seg phase's batches
CRF_AGREE = 0.9  # native vs mean-field CRF labels, two-region image: the JAX package's bound
LABEL_AGREE = 0.999  # labels: kernel and plain walk, argmax ties only
IRN_SCORE_TOL = 1e-3  # f16 scores, kernel and plain walk
# bf16 serving (bf16 phase): timed batches of each path (CAM batches of 8,
# seg batches of 4, IRN batches of 8).  The CAM kernel vs the plain blocks,
# both bf16: scores max |diff|; each fused SGC map's mean |diff| away from
# the zeroing discontinuity within the larger of BF16_SGC_TOL and
# BF16_SGC_REL times the map's own bf16 sensitivity (the plain bf16 map's
# distance from the f32 one).  A random net's SGC maps are nearly flat
# (the PCM averages the CAM over near-uniform affinities) and the min-max
# normalisation divides by their small range: f32 noise of ~1e-7 already
# moves them by up to 5e-3 (the main phase), bf16's ~4e-3 by tenths.  The
# bf16 CAM vs the f32 one (both with the kernel): SGC mean |diff|,
# printed.  Seg labels, kernel vs plain blocks at bf16, on the pixels whose
# f32 top-two probability margin exceeds BF16_MARGIN: agreeing on
# BF16_LABEL_AGREE of them, or disagreeing on at most BF16_SGC_REL times
# what the plain bf16 blocks disagree with f32 there, whichever allows
# more.  IRN labels, bf16 vs f32 edge model, on every pixel
BF16_BATCHES = {"cam": 4, "seg": 2, "irn": 2}
BF16_SCORE_TOL, BF16_SGC_TOL, BF16_SGC_REL = 1e-2, 5e-3, 2.0
BF16_MARGIN, BF16_LABEL_AGREE = 1e-2, 0.99
# MCL training (train_mcl phase): the JAX CLI's defaults
TRAIN_BACKBONE, TRAIN_BATCH, TRAIN_CROP, TRAIN_VIEW = "efficientnet-b3", 16, 448, 224
TRAIN_WARMUP, TRAIN_ITERS = 2, 5
TRAIN_LR, TRAIN_WD = 1e-4, 5e-5
# card vs CPU: b1, crop 64, views 32, batch 4; loss terms within 1e-4
# relative (plus 1e-7 absolute: EMD is ~1e-6 here, 1 - cos with cos one f32
# ulp from 1), BN statistics within 1e-4; each parameter's gradient within
# (tolerance) x its largest CPU entry or (zero share) x the model's largest
# gradient, whichever is larger: tests/test_torch_mcl.py's limits, step B's
# looser (its maxnorm amplifies the forward's rounding ~40x); the floor
# holds gradients that are zero in exact arithmetic to rounding noise, with
# no cliff for a real gradient near it (step B's last SE bias: 9.5e-4 of
# the largest)
CHECK_BACKBONE, CHECK_BATCH, CHECK_CROP, CHECK_VIEW = "efficientnet-b1", 4, 64, 32
TRAIN_RTOL, TRAIN_ATOL, TRAIN_STAT_TOL = 1e-4, 1e-7, 1e-4
GRAD_TOLS = {"step_a": (1e-4, 1e-5), "step_b": (1e-3, 1e-3)}  # (tolerance, zero share)
LIVE_FLOOR = 1e-6  # a live term's gradient norm, relative to the largest term's
# segmentation training (train_seg phase): the train_muscle defaults
SEG_TRAIN_BACKBONE, SEG_TRAIN_BATCH, SEG_TRAIN_CROP = "efficientnet-b7", 6, 448
SEG_TRAIN_K, SEG_TRAIN_STEP, SEG_TRAIN_LR, SEG_TRAIN_WD = 128, 7, 1e-5, 1e-5
SEG_EVAL_LAUNCHES = 48  # fused b7 blocks in one scale-1 forward (orig + flip in one batch)
# card vs CPU seg step: b1 dec, BiFPN 1 x 64, crop 64, batch 2, k 16
# (tests/test_torch_train_seg.py's sizes and limits): loss terms 1e-4
# relative, BN statistics 1e-5 or 1e-4 relative (the BiFPN's 1 x 1 p6/p7
# maps take a variance over 2 values), gradients 1e-4 of each tensor's
# largest with a floor of 1e-5 of the model's largest
SEG_CHECK_BACKBONE, SEG_CHECK_BATCH, SEG_CHECK_CROP, SEG_CHECK_K = "efficientnet-b1", 2, 64, 16
SEG_STAT_ATOL = 1e-5
SEG_GRAD_TOLS = (1e-4, 1e-5)
# IRN training (train_irn phase): the train_irn defaults; card vs CPU at crop
# 64, head gradients 1e-4 of each tensor's largest (tests/test_torch_train_irn.py)
IRN_TRAIN_BATCH, IRN_TRAIN_CROP, IRN_TRAIN_LR, IRN_TRAIN_WD = 8, 512, 0.1, 1e-4
IRN_CHECK_BATCH, IRN_CHECK_CROP = 2, 64
IRN_GRAD_TOLS = (1e-4, 1e-5)
# bf16 training (train_mcl_bf16, train_seg_bf16 phases): each configuration
# and dtype 1 warm-up and 3 timed iterations, bf16 and f32 in turns.  Card
# vs CPU at bf16 (the check phases' b1 sizes): cuDNN's and the CPU's bf16
# convolutions sum in other orders, so each quantity is held to the CPU's
# own bf16-vs-f32 distance on it: mean |card - cpu16| within 2x mean
# |cpu16 - cpu32| and max within 3x max, plus 4 bf16 half-ulps (2^-8) of
# its largest value (gradients: at least 2% of the model's largest); the
# loss terms over 4 batches (step A, B) or 4 sets of BEACON draws (seg);
# and the card's step-A (seg: step) gradients at least 0.5x that distance
# from the CPU's f32 ones (bf16 ran).  tests/test_torch_bf16_train_*.py
# hold the CPU's bf16 steps to the JAX package's by the same rule
BF16_TRAIN_WARMUP, BF16_TRAIN_ITERS = 1, 3
BF16_TRAIN_MEAN, BF16_TRAIN_MAX, BF16_TRAIN_ULPS, BF16_TRAIN_ZERO = 2.0, 3.0, 4.0, 2e-2
BF16_TRAIN_RAN, BF16_CHECK_BATCHES = 0.5, 4
# data parallelism (dp phase): DP_SHARED_RANKS ranks share card 0 over gloo;
# with several cards, min(cards, DP_MAX_RANKS) ranks one a card over NCCL.
# Parity at b1 (the check phases' sizes at a global batch of DP_CHECK_BATCH,
# which 2 and 4 ranks divide; BF16_CHECK_BATCHES batches, the bf16 rule's
# loss terms a mean over them); full width: MCL b3 at the train_mcl default
# (batch 16, crop 448, step A with IMC) and seg b7 + BiFPN 3 x 256 at
# DP_SEG_PER_RANK images a rank (the train_muscle default's 6 on 2 ranks),
# 1 warm-up step (held to the one-process step: the loss within
# DP_LOSS_RTOL, each term within DP_LOSS_RTOL of the loss: BEACON is a
# near-cancelling sum, ~1e-5 at random weights, whose boundary samples
# rounding can move) and DP_ITERS timed; serving: the CAM engine (b3,
# fused, --fast 0) over DP_CAM_BATCHES batches of 8, the seg engine (b7)
# over DP_SEG_BATCHES of 4, each rank on its rows of every batch; the
# sharded walk at grid 128 against the float64 dense walk: within
# DP_WALK_RTOL of its largest value, or within twice the one-card f32
# dense walk's own distance from it (cuBLAS sums a column block in
# another order than the whole: 1.3e-5 of the largest apart, first run)
DP_SHARED_RANKS, DP_MAX_RANKS = 2, 4
DP_CHECK_BATCH, DP_MCL_BATCH, DP_SEG_PER_RANK, DP_ITERS = 4, 16, 3, 2
DP_CAM_BATCHES, DP_SEG_BATCHES, DP_WALK_GRID = 2, 1, 128
DP_LOSS_RTOL, DP_WALK_RTOL = 1e-4, 1e-5
# gates phase: the port's CLIs as a user runs them, each its own process
# (python -m): infer_mcl at its defaults (b3, fused) and real_run's seg and
# eval stages (b7 + BiFPN 3, six scales x flip, CRF) on a synthetic VOC
# tree of 16 full-size images (the JAX harness's four sizes, four times),
# and the gate CLI's quick tier of gates 4, 5 and 6 on its own small tree
# (b1, crop 64); every gate row must pass.  MBConv launches per forward:
# b3's 23 stride-1 blocks (infer_mcl), b7's 48 (the seg stage)
GATES_FULL_SIZES = [(375, 500), (500, 375), (333, 500), (500, 500)] * 4
GATES_QUICK_SIZES = [(48, 64), (64, 48), (42, 64), (64, 64)]
GATES_B3_PER_FORWARD, GATES_B7_PER_FORWARD = 23, 48
GATES_CLI_TIMEOUT = 600
# spatial sharding (spatial phase): one image's height split over a model
# group (parallel/spatial.py).  SPATIAL_SHARED_RANKS ranks share card 0 over
# gloo (a 1 x 2 mesh); where the machine has several cards, SPATIAL_NCCL_RANKS
# of them (the most it has of 4 and 2) one a card over NCCL as 1 x W and, at
# W = 4, also as 2 x 2.  CAM at infer_mcl's defaults (b3, fused, scales
# 0.5-2, --fast 1) on batches of SPATIAL_CAM_SIZES images, seg at
# infer_seg's without the CRF (b7 + BiFPN 3 x 256, six scales x flip, the
# stride-4 grid, f16 probabilities) on batches of SPATIAL_SEG_SIZES; each
# batch once to warm up, SPATIAL_REPS times timed (the counts zeroed just
# before), once more with every exchange timed (``Stripes.timed``: the
# device synchronised around each).  Held to one process on card 0: CAM by the
# main phase's rules, seg probabilities within SEG_PROBS_TOL and labels on
# SEG_LABEL_AGREE of each image's pixels.  The kernels phase's owned-row
# check splits each MBConv shape into SPATIAL_SPLITS stripes in one process
SPATIAL_SHARED_RANKS, SPATIAL_NCCL_RANKS = 2, (4, 2)
SPATIAL_CAM_SIZES, SPATIAL_SEG_SIZES, SPATIAL_REPS = (1, 8), (1, 4), 2
SPATIAL_SPLITS = (2, 4)
SPATIAL_CAM_FAST = dict(accum_stride=4, download_dtype="uint8", tight_upload=True,
                        upload_mode="ycbcr420")
SPATIAL_SEG_FAST = dict(accum_stride=4, download_dtype="float16", tight_upload=True,
                        upload_mode="ycbcr420")
# device_exec phase: chained closure calls timed after one warm-up, and the
# copies of the batch the streaming rate beside it runs
DEVICE_EXEC_REPS, DEVICE_EXEC_STREAM_BATCHES = 10, 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0 (before a path runs)."""
    from muscle_tpu_torch.ops import banded_walk, mbconv, stencil_walk

    mbconv.mbconv_stride1.launches = 0
    mbconv.mbconv_stride1.launches_bf16 = 0
    stencil_walk.stencil_walk.launches = 0
    banded_walk.banded_walk.launches = 0


def _launch_counts() -> dict:
    """Every kernel's launch count, by the names of the kernels line (the
    MBConv wrapper counts its bf16 launches apart)."""
    from muscle_tpu_torch.ops import banded_walk, mbconv, stencil_walk

    return {"mbconv_stride1": mbconv.mbconv_stride1.launches,
            "mbconv_bf16": mbconv.mbconv_stride1.launches_bf16,
            "stencil_walk": stencil_walk.stencil_walk.launches,
            "banded_walk": banded_walk.banded_walk.launches}


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


def _windows(stride: int, scale: float, device, batch: int = TTA_BATCH,
             sizes=(VOC_HW, (300, 400))):
    """(B, 4) windows of a TTA batch of ``batch`` versions at a block's
    grid: images of ``sizes`` (h, w) in turn (500x375 and 400x300 by
    default), scaled, through the floor chain."""
    import torch

    rows = []
    for i in range(batch // 2):
        h, w = sizes[i % len(sizes)]
        h, w = round(h * scale), round(w * scale)
        rows += [[0, 0, h // stride, w // stride]] * 2
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _check_mbconv(blocks: dict, batch: int, scales, canvas,
                  sizes=(VOC_HW, (300, 400))) -> dict:
    """The MBConv kernel at ``blocks``' shapes on ``batch`` versions at each
    scale's ``canvas(scale)`` (h, w), windowed to images of ``sizes``, held
    to its plain version; returns the sums over the windowed calls (the
    main paths' calls are windowed)."""
    import torch

    from muscle_tpu_torch.ops import mbconv as M

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    xgen = torch.Generator(device=dev).manual_seed(0)
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0, "product_flops": 0,
             "depthwise_flops": 0, "max_abs_err": 0.0, "shape_ms": {}}
    for name, (stride, cin, cout, expand, k) in blocks.items():
        block = _random_block(cin, cout, expand, k, gen, dev)
        wd = block.fused_weights()
        cmid, csq = cin * expand, wd["w_se_r"].shape[1]
        kw = dict(k=k, has_expand=expand != 1, has_skip=cin == cout)
        for scale in scales:
            ch, cw = canvas(scale)
            h, w = ch // stride, cw // stride
            x = torch.randn((batch, h, w, cin), generator=xgen, device=dev)
            for windowed in (False, True):
                win = _windows(stride, scale, dev, batch, sizes) if windowed else None
                before = M.mbconv_stride1.launches
                with torch.inference_mode():
                    got = M.mbconv_stride1(x, wd, win, **kw)
                    want = M.mbconv_stride1_plain(x, wd, win, **kw)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    del got, want
                    ms = time_ms(lambda: M.mbconv_stride1(x, wd, win, **kw), KERNEL_REPS)
                    plain_ms = time_ms(lambda: M.mbconv_stride1_plain(x, wd, win, **kw),
                                       KERNEL_REPS)
                work = M.block_work(batch, h, w, cin, cmid, csq, cout, k, expand != 1)
                split = M.block_flops(batch, h, w, cin, cmid, cout, k, expand != 1)
                bound, by = M.bound_ms(*work)
                bound_tc, by_tc = M.bound_tc_ms(work[0], *split)
                rec = {"kernel": "mbconv_stride1", "block": name, "scale": scale,
                       "windowed": windowed, "B": batch, "H": h, "W": w, "Cin": cin,
                       "Cmid": cmid, "Cout": cout, "k": k, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "bound_tc_ms": bound_tc, "bound_tc_by": by_tc,
                       "launches": M.mbconv_stride1.launches - before}
                print(json.dumps(rec), flush=True)
                if not err <= KERNEL_TOL:
                    raise AssertionError(f"{name} scale {scale} windowed={windowed}: "
                                         f"max_abs_err {err} > {KERNEL_TOL}")
                if windowed:
                    total["shape_ms"][(name, scale)] = ms
                    total["ms"] += ms
                    total["plain_ms"] += plain_ms
                    total["bytes"] += work[0]
                    total["flops"] += work[1]
                    total["product_flops"] += split[0]
                    total["depthwise_flops"] += split[1]
                total["max_abs_err"] = max(total["max_abs_err"], err)
            del x
        del block, wd
        torch.cuda.empty_cache()
    return total


def _check_mbconv_bf16(blocks: dict, batch: int, scales, canvas, f32_ms: dict) -> dict:
    """The MBConv kernel's bf16 instantiation at ``blocks``' shapes,
    windowed, held to the bf16 plain version (max |diff| <= BF16_REL of the
    plain output's largest value) and to itself (a repeat bit for bit),
    with the f32 kernel's ms at the same shape from ``f32_ms`` beside it;
    returns the sums over the calls."""
    import torch

    from muscle_tpu_torch.ops import mbconv as M

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    xgen = torch.Generator(device=dev).manual_seed(0)
    total = {"ms": 0.0, "plain_ms": 0.0, "f32_ms": 0.0, "bytes": 0, "product_flops": 0,
             "depthwise_flops": 0, "max_abs_err": 0.0, "max_rel_err": 0.0}
    for name, (stride, cin, cout, expand, k) in blocks.items():
        block = _random_block(cin, cout, expand, k, gen, dev)
        wd = block.fused_weights(bf16)
        cmid, csq = cin * expand, wd["w_se_r"].shape[1]
        kw = dict(k=k, has_expand=expand != 1, has_skip=cin == cout)
        for scale in scales:
            ch, cw = canvas(scale)
            h, w = ch // stride, cw // stride
            x = torch.randn((batch, h, w, cin), generator=xgen, device=dev).to(bf16)
            win = _windows(stride, scale, dev, batch)
            before = M.mbconv_stride1.launches_bf16
            with torch.inference_mode():
                got = M.mbconv_stride1(x, wd, win, **kw)
                again = M.mbconv_stride1(x, wd, win, **kw)
                want = M.mbconv_stride1_plain(x, wd, win, **kw)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                scale_max = float(want.float().abs().max())
                same = bool(torch.equal(got, again))
                ok = got.dtype == bf16 and tuple(got.shape) == tuple(want.shape)
                del got, again, want
                ms = time_ms(lambda: M.mbconv_stride1(x, wd, win, **kw), KERNEL_REPS)
                plain_ms = time_ms(lambda: M.mbconv_stride1_plain(x, wd, win, **kw),
                                   KERNEL_REPS)
            launches = M.mbconv_stride1.launches_bf16 - before
            nbytes, _ = M.block_work(batch, h, w, cin, cmid, csq, cout, k, expand != 1, bf16)
            split = M.block_flops(batch, h, w, cin, cmid, cout, k, expand != 1)
            bound, by = M.bound_tc_ms(nbytes, *split, bf16)
            rec = {"kernel": "mbconv_bf16", "block": name, "scale": scale, "windowed": True,
                   "B": batch, "H": h, "W": w, "Cin": cin, "Cmid": cmid, "Cout": cout, "k": k,
                   "max_abs_err": err, "plain_max_abs": scale_max,
                   "tol": BF16_REL * scale_max, "repeats_bitwise": same, "ms": ms,
                   "plain_ms": plain_ms, "f32_ms": f32_ms.get((name, scale)),
                   "bound_ms": bound, "bound_by": by, "launches": launches}
            print(json.dumps(rec), flush=True)
            if not (ok and same and err <= BF16_REL * scale_max):
                raise AssertionError(f"bf16 {name} scale {scale}: max_abs_err {err} > "
                                     f"{BF16_REL} * {scale_max}, repeats bit for bit: {same}")
            total["ms"] += ms
            total["plain_ms"] += plain_ms
            total["f32_ms"] += f32_ms.get((name, scale), float("nan"))
            total["bytes"] += nbytes
            total["product_flops"] += split[0]
            total["depthwise_flops"] += split[1]
            total["max_abs_err"] = max(total["max_abs_err"], err)
            total["max_rel_err"] = max(total["max_rel_err"], err / scale_max)
            del x
        del block, wd
        torch.cuda.empty_cache()
    return total


def _check_mbconv_owned(blocks: dict, batch: int, scales, canvas,
                        dtype: str = "float32") -> float:
    """The MBConv kernel on stripes, in one process: each windowed shape's
    image split into SPATIAL_SPLITS stripes, each with its k//2 halo rows
    (zeros beyond the image) and its window in stripe rows; launch (a) on
    every stripe (the SE partials of its own rows), the partials summed by
    hand, then launches (b) and (c) on every stripe; the stripes' rows
    together held to the plain version on the whole image: KERNEL_TOL at
    float32, BF16_REL of the plain output's largest value for the bf16
    instantiation.  Returns the largest error (relative to that largest
    value at bf16)."""
    import torch
    import torch.nn.functional as F

    from muscle_tpu_torch.ops import mbconv as M

    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    xgen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for name, (stride, cin, cout, expand, k) in blocks.items():
        block = _random_block(cin, cout, expand, k, gen, dev)
        wd = block.fused_weights(dt)
        kw = dict(k=k, has_expand=expand != 1, has_skip=cin == cout)
        p = k // 2
        for scale in scales:
            ch, cw = canvas(scale)
            h, w = ch // stride, cw // stride
            x = torch.randn((batch, h, w, cin), generator=xgen, device=dev).to(dt)
            win = _windows(stride, scale, dev, batch)
            errs = {}
            with torch.inference_mode():
                want = M.mbconv_stride1_plain(x, wd, win, **kw)
                tol = KERNEL_TOL if dt == torch.float32 else BF16_REL * float(
                    want.float().abs().max())
                xp = F.pad(x, (0, 0, 0, 0, p, p))
                for n in SPATIAL_SPLITS:
                    s = h // n
                    if s * n != h:
                        raise AssertionError(f"{name} scale {scale}: {h} rows in {n} stripes")
                    parts = [M.mbconv_stride1_begin(
                        xp[:, r * s: r * s + s + 2 * p].contiguous(), wd,
                        M.shift_rows(win, r * s - p).contiguous(), owned=(p, p + s), **kw)
                        for r in range(n)]
                    total = sum(q.part for q in parts)
                    for q in parts:
                        q.part = total
                    got = torch.cat([M.mbconv_stride1_end(q) for q in parts], dim=1)
                    torch.cuda.synchronize()
                    errs[n] = float((got.float() - want.float()).abs().max())
            print(json.dumps({"kernel": "mbconv_stride1" if dt == torch.float32 else "mbconv_bf16",
                              "owned_rows": True, "block": name, "scale": scale, "B": batch,
                              "H": h, "W": w, "k": k, "stripes": list(SPATIAL_SPLITS),
                              "max_abs_err": [errs[n] for n in SPATIAL_SPLITS], "tol": tol}),
                  flush=True)
            if not (max(errs.values()) <= tol and got.dtype == dt):
                raise AssertionError(f"{dtype} {name} scale {scale} on stripes: max_abs_err "
                                     f"{errs} > {tol}")
            worst = max(worst, *(e if dt == torch.float32 else e / (tol / BF16_REL)
                                 for e in errs.values()))
            del x, xp, want
        del block, wd
        torch.cuda.empty_cache()
    return worst


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
            # the library yardstick: one step is one sparse product with the
            # block-diagonal T^T in CSR (built outside the timed window)
            csr = R.transition_csr(edge)
            xt = x.reshape(WALK_B, WALK_C, h * w).transpose(1, 2).reshape(-1, WALK_C)

            def library():
                y = xt
                for _ in range(WALK_STEPS):
                    y = torch.sparse.mm(csr, y)
                return y

            library_ms = time_ms(library, 1)
            lib_out = library().reshape(WALK_B, h * w, WALK_C).transpose(1, 2)
            library_err = float((lib_out.reshape(got.shape) - want).abs().max())
            del csr
        bound, by = bound_ms(*S.walk_work(WALK_B, WALK_C, h, w, len(dirs), WALK_STEPS))
        rec = {"kernel": "stencil_walk", "B": WALK_B, "C": WALK_C, "H": h, "W": w,
               "steps": WALK_STEPS, "max_abs_err": err, "tol": tol, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
               "library_max_abs_err": library_err, "launches": launches}
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


def _check_edges() -> None:
    """Both walk kernels at the edges of their tilings, against their plain
    versions, each repeating itself bit for bit."""
    import torch

    from muscle_tpu_torch.ops import banded_walk as BW
    from muscle_tpu_torch.ops import random_walk as R
    from muscle_tpu_torch.ops import stencil_walk as S

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for b, c, h, w, steps in STENCIL_EDGES:
        edge = _smooth_edges(b, h, w, gen, dev)
        x = torch.rand((b, c, h, w), generator=gen, device=dev)
        with torch.inference_mode():
            vs, inv, dirs = R.stencil_operands(edge)
            got = S.stencil_walk(x, vs, inv, dirs=dirs, steps=steps)
            again = S.stencil_walk(x, vs, inv, dirs=dirs, steps=steps)
            want = S.stencil_walk_plain(x, vs, inv, dirs=dirs, steps=steps)
            torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = STENCIL_RTOL * float(want.abs().max()) + STENCIL_ATOL
        same = bool(torch.equal(got, again))
        print(json.dumps({"kernel": "stencil_walk", "edge": [b, c, h, w, steps],
                          "max_abs_err": err, "tol": tol, "repeats_bitwise": same}), flush=True)
        if not (err <= tol and same):
            raise AssertionError(f"stencil walk edge {(b, c, h, w, steps)}: max_abs_err {err} "
                                 f"(tol {tol}), repeats bit for bit: {same}")
    for b, c, v, band, steps in BANDED_EDGES:
        t = torch.rand((b, v, v), generator=gen, device=dev)
        i = torch.arange(v, device=dev)
        t = t * ((i[:, None] - i[None, :]).abs() <= band)
        t = t / t.sum(dim=1, keepdim=True)
        x = torch.rand((b, c, v), generator=gen, device=dev)
        with torch.inference_mode():
            got = BW.banded_walk(x, t, steps=steps, band=band)
            again = BW.banded_walk(x, t, steps=steps, band=band)
            want = BW.banded_walk_plain(x, t, steps=steps, band=band)
            torch.cuda.synchronize()
        err = float((got - want).abs().max())
        excess = float(((got - want).abs() - BANDED_RTOL * want.abs()).max())
        same = bool(torch.equal(got, again))
        print(json.dumps({"kernel": "banded_walk", "edge": [b, c, v, band, steps],
                          "max_abs_err": err, "repeats_bitwise": same}), flush=True)
        if not (excess <= BANDED_ATOL and same):
            raise AssertionError(f"banded walk edge {(b, c, v, band, steps)}: |diff| exceeds "
                                 f"rtol {BANDED_RTOL} * |plain| by {excess} > atol "
                                 f"{BANDED_ATOL}, repeats bit for bit: {same}")


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the summaries the
    {"kernels": ...} line reports, at the main paths' shapes."""
    import torch

    from muscle_tpu_torch.data.tta import bucket_side
    from muscle_tpu_torch.inference.cam import _batch_canvas
    from muscle_tpu_torch.ops.mbconv import bound_ms, bound_tc_ms

    def summary(mb: dict) -> dict:
        bound, by = bound_ms(mb["bytes"], mb["flops"])
        bound_tc, _ = bound_tc_ms(mb["bytes"], mb["product_flops"], mb["depthwise_flops"])
        return {"max_abs_err": mb["max_abs_err"], "ms": mb["ms"], "plain_ms": mb["plain_ms"],
                "bound_ms": bound, "bound_by": by, "bound_tc_ms": bound_tc}

    def summary_bf16(mb: dict) -> dict:
        # the bound with each operation at its type's peak: bf16 products on
        # the tensor cores, the f32 depthwise on the f32 pipes
        bound, by = bound_tc_ms(mb["bytes"], mb["product_flops"], mb["depthwise_flops"],
                                torch.bfloat16)
        return {"max_abs_err": mb["max_abs_err"], "max_rel_err": mb["max_rel_err"],
                "ms": mb["ms"], "plain_ms": mb["plain_ms"], "f32_kernel_ms": mb["f32_ms"],
                "bound_ms": bound, "bound_by": by}

    b3_canvas = lambda s: _batch_canvas(s, [VOC_HW] * 8, 500)  # noqa: E731
    b7_canvas = lambda s: (bucket_side(s), bucket_side(s))  # noqa: E731
    b3_raw = _check_mbconv(B3_BLOCKS, TTA_BATCH, (1.0, 2.0), b3_canvas)
    b7_raw = _check_mbconv(B7_BLOCKS, SEG_BATCH, (1.0, 1.75), b7_canvas)
    b3, b7 = summary(b3_raw), summary(b7_raw)
    # gate 6's evals: 4 images of the quick tier's tree x (orig, flip) on
    # its 64 x 64 canvas at scale 1
    b1 = summary(_check_mbconv(B1_BLOCKS, 2 * len(GATES_QUICK_SIZES), (1.0,),
                               lambda s: (64, 64), GATES_QUICK_SIZES))
    b3_16 = summary_bf16(_check_mbconv_bf16(B3_BLOCKS, TTA_BATCH, (1.0, 2.0), b3_canvas,
                                            b3_raw["shape_ms"]))
    b7_16 = summary_bf16(_check_mbconv_bf16(B7_BLOCKS, SEG_BATCH, (1.0, 1.75), b7_canvas,
                                            b7_raw["shape_ms"]))
    owned = max(_check_mbconv_owned(B3_BLOCKS, TTA_BATCH, (1.0, 2.0), b3_canvas),
                _check_mbconv_owned(B7_BLOCKS, SEG_BATCH, (1.0, 1.75), b7_canvas))
    owned_16 = max(_check_mbconv_owned(B3_BLOCKS, TTA_BATCH, (1.0, 2.0), b3_canvas, "bfloat16"),
                   _check_mbconv_owned(B7_BLOCKS, SEG_BATCH, (1.0, 1.75), b7_canvas,
                                       "bfloat16"))
    print(json.dumps({"mbconv_b3_cam_windowed_total": b3, "mbconv_b7_seg_windowed_total": b7,
                      "mbconv_owned_rows_max_abs_err": owned,
                      "mbconv_bf16_owned_rows_max_rel_err": owned_16,
                      "mbconv_b1_gates_windowed_total": b1,
                      "mbconv_bf16_b3_cam_windowed_total": b3_16,
                      "mbconv_bf16_b7_seg_windowed_total": b7_16}), flush=True)
    stencil = _check_stencil()[STENCIL_GRIDS[0]]
    banded = _check_banded()[BANDED_CASES[-1][0]]
    _check_edges()
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "mbconv_stride1": {**b3, "max_abs_err": max(b3["max_abs_err"], b7["max_abs_err"],
                                                    b1["max_abs_err"]),
                           "owned_rows_max_abs_err": owned,
                           "library_ms": None, "b7_seg": b7, "b1_gates": b1},
        "mbconv_bf16": {**b3_16, "max_abs_err": max(b3_16["max_abs_err"], b7_16["max_abs_err"]),
                        "max_rel_err": max(b3_16["max_rel_err"], b7_16["max_rel_err"]),
                        "owned_rows_max_rel_err": owned_16,
                        "library_ms": None, "b7_seg": b7_16},
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


def _two_region_problem(h: int, w: int, n_labels: int = 21):
    """The JAX package's CRF check (test_ops.py): two colour regions with
    noise, one class favoured in each, 10% of the pixels' unaries flipped."""
    import numpy as np

    rng = np.random.default_rng(0)
    img = np.zeros((h, w, 3), np.uint8)
    img[:, : w // 2] = [200, 40, 40]
    img[:, w // 2:] = [40, 40, 200]
    img = np.clip(img.astype(int) + rng.integers(-15, 15, img.shape), 0, 255).astype(np.uint8)
    probs = np.full((h, w, n_labels), 1e-3, np.float32)
    probs[:, : w // 2, 1] = 0.5
    probs[:, w // 2:, 2] = 0.5
    probs[..., 0] = 0.3
    flip = rng.random((h, w)) < 0.1
    probs[flip] = probs[flip][:, ::-1]
    probs /= probs.sum(-1, keepdims=True)
    return img, probs


def _seg_model(fuse: int):
    """MuSCLe-b7 dec (BiFPN 3 x 256) with seeded random weights (batch
    norms, the BiFPN's too, near the identity with random statistics) and
    the head calibrated on two synthetic images so the labels vary over
    each image (``calibrate_seg_head``)."""
    import numpy as np
    import torch

    from muscle_tpu_torch.data.transforms import color_norm
    from muscle_tpu_torch.models import MuSCLe, calibrate_seg_head, init_weights

    model = MuSCLe(backbone_name="efficientnet-b7", mode="dec", bifpn_layers=3,
                   bifpn_channels=256, last_pooling=True, fuse_mbconv=fuse)
    init_weights(model, torch.Generator().manual_seed(0))
    imgs, _, _ = _images(1, seed=7)[0]
    cal = torch.from_numpy(np.stack([color_norm(im[:256, :256]) for im in imgs[:2]]))
    model = model.to("cuda").eval()
    with torch.inference_mode():
        calibrate_seg_head(model, cal.to("cuda"))
    return model


def _seg_batches(n_batches: int, seed: int):
    """Orientation-homogeneous batches of SEG_PER_BATCH synthetic
    VOC-shaped images (the CAM phase's images), with their names."""
    return [(imgs[:SEG_PER_BATCH], names[:SEG_PER_BATCH])
            for imgs, names, _ in _images(n_batches, seed)]


def _seg_run(engine, batches):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [r for rs in engine.run_stream(iter(batches)) for r in rs]
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def phase_seg(n_batches: int = SEG_BATCHES) -> dict:
    """SegTTAEngine at the infer_seg default (b7, BiFPN 3 x 256, six scales
    x flip), --fast 0 and --fast 1, each with the MBConv kernel and with
    the plain blocks; the CRF's time on the card."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from muscle_tpu_torch.inference import SegTTAEngine
    from muscle_tpu_torch.ops import mbconv as M
    from muscle_tpu_torch.ops.crf import mean_field_crf
    from muscle_tpu_torch.ops.exact_crf import dense_crf

    fused_model = _seg_model(384)
    plain_model = _seg_model(0)
    plain_model.load_state_dict(fused_model.state_dict())
    warm = _seg_batches(1, seed=1)
    batches = _seg_batches(n_batches, seed=2)
    configs = {
        "fast0": dict(upload_mode="rgb", tight_upload=False),
        "fast1": dict(accum_stride=4, download_dtype="float16", tight_upload=True,
                      upload_mode="ycbcr420", output="labels"),
    }
    n_img = SEG_PER_BATCH * n_batches
    out = {}
    probs0 = None
    for cname, extra in configs.items():
        engines = {f: SegTTAEngine(m, scales=SEG_SCALES, device="cuda", **extra)
                   for f, m in ((384, fused_model), (0, plain_model))}
        for e in engines.values():
            _seg_run(e, warm)  # cuDNN autotune, allocator warm-up
        _zero_counts()
        got, fused_s = _seg_run(engines[384], batches)
        launches = M.mbconv_stride1.launches
        if launches != SEG_LAUNCHES * n_batches:
            raise AssertionError(f"seg {cname}: {launches} kernel launches, want "
                                 f"{SEG_LAUNCHES * n_batches} (48 per forward, 6 per batch)")
        want, plain_s = _seg_run(engines[0], batches)
        # the busy share of the kernel run, from a second run under the
        # profiler (device activity only, which barely slows the dispatch)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, prof_s = _seg_run(engines[384], batches)
        device_ms = sum(r[0] for r in _device_rows(prof))
        flat = [img for imgs, _ in batches for img in imgs]
        assert [r["name"] for r in got] == [r["name"] for r in want]
        rec = {"seg": cname, "images": n_img, "launches": launches,
               "launches_per_batch": launches / n_batches,
               "kernel_images_per_s": n_img / fused_s, "plain_images_per_s": n_img / plain_s,
               "device_busy_share": device_ms / (prof_s * 1e3)}
        if extra.get("output") == "labels":
            agree, classes = 1.0, set()
            for g, w, img in zip(got, want, flat):
                assert g["label"].shape == img.shape[:2] and g["label"].dtype == np.uint8
                agree = min(agree, float((g["label"] == w["label"]).mean()))
                classes |= set(np.unique(g["label"]).tolist())
            rec.update(labels_agreement_min=agree, classes_seen=len(classes))
            ok = agree >= SEG_LABEL_AGREE and len(classes) > 1
        else:
            err = 0.0
            for g, w, img in zip(got, want, flat):
                p = g["probs"]
                assert p.shape == (*img.shape[:2], 21) and np.isfinite(p).all()
                assert np.abs(p.sum(-1) - 1.0).max() < 1e-3
                err = max(err, float(np.abs(p - w["probs"]).max()))
            rec.update(probs_max_abs_err=err)
            ok = err <= SEG_PROBS_TOL
            probs0 = (got, flat)
        print(json.dumps(rec), flush=True)
        if not ok:
            raise AssertionError(f"seg {cname}: kernel vs plain blocks out of bounds: {rec}")
        out[cname] = rec

    out["switches"] = _seg_switches(fused_model, plain_model, warm, batches)

    # the mean-field CRF (the --crf_backend xla default, t = 4) on the card
    # over the --fast 0 probabilities, and the native CRF on one image
    recs, imgs = probs0
    dev = torch.device("cuda")
    pairs = [(torch.from_numpy(r["probs"]).to(dev), torch.from_numpy(im).to(dev))
             for r, im in zip(recs, imgs)]
    mean_field_crf(*pairs[0], t=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined = [mean_field_crf(p, im, t=4) for p, im in pairs]
    torch.cuda.synchronize()
    crf_ms = (time.perf_counter() - t0) * 1e3 / len(pairs)
    q = refined[0].cpu().numpy()
    assert np.isfinite(q).all() and np.abs(q.sum(-1) - 1.0).max() < 1e-3
    # recorded: the random net's near-tied classes, where the two bilateral
    # approximations part most
    native = dense_crf(imgs[0], recs[0]["probs"].transpose(2, 0, 1), t=4)
    seg_agree = float((native.argmax(0) == q.argmax(-1)).mean())
    # held to the JAX package's bound: a two-region VOC-sized image
    img, probs = _two_region_problem(*VOC_HW)
    mf = mean_field_crf(torch.from_numpy(probs).to(dev), torch.from_numpy(img).to(dev), t=4)
    native = dense_crf(img, probs.transpose(2, 0, 1), t=4)
    crf_agree = float((native.argmax(0) == mf.argmax(-1).cpu().numpy()).mean())
    crf = {"crf": "mean_field_crf t=4", "images": len(pairs), "ms_per_image": crf_ms,
           "native_vs_mean_field_agreement_two_region": crf_agree,
           "native_vs_mean_field_agreement_seg_image": seg_agree}
    print(json.dumps(crf), flush=True)
    if not crf_agree >= CRF_AGREE:
        raise AssertionError(f"native vs mean-field CRF labels agree on {crf_agree} < "
                             f"{CRF_AGREE}")
    out["crf"] = crf
    return out


def _seg_switches(fused_model, plain_model, warm, batches) -> dict:
    """SEG_SWITCHES at --fast 0 (f32 probabilities, RGB upload) on the
    first of ``batches``, each with the MBConv kernel and with the plain
    blocks: one warm-up run, then the batch with the counts zeroed and the
    peak memory reset just before; the kernel held to the plain blocks by
    the seg phase's rules with 288 launches, and lowres=False to
    lowres=True through the kernel within SEG_LOWRES_TOL.  Then the kernel
    engines timed in SWITCH_TURNS turns over all ``batches``, the settings
    in turn within each, so a drift of the host's speed falls on all."""
    import numpy as np
    import torch

    from muscle_tpu_torch.inference import SegTTAEngine

    batch = batches[0]
    flat = batch[0]
    out, probs, kernel_engines = {}, {}, {}
    for name, switches in SEG_SWITCHES.items():
        runs = {}
        for fuse, model in ((384, fused_model), (0, plain_model)):
            engine = SegTTAEngine(model, scales=SEG_SCALES, device="cuda", upload_mode="rgb",
                                  tight_upload=False, **switches)
            if fuse:
                kernel_engines[name] = engine
            _seg_run(engine, warm)
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            recs, secs = _seg_run(engine, [batch])
            runs[fuse] = (recs, secs, _launch_counts()["mbconv_stride1"],
                          torch.cuda.max_memory_allocated() / 2 ** 30)
        (got, k_s, launches, k_peak), (want, p_s, _, p_peak) = runs[384], runs[0]
        err, agree = 0.0, 1.0
        for g, w, img in zip(got, want, flat):
            p = g["probs"]
            assert p.shape == (*img.shape[:2], 21) and np.isfinite(p).all()
            assert np.abs(p.sum(-1) - 1.0).max() < 1e-3
            err = max(err, float(np.abs(p - w["probs"]).max()))
            agree = min(agree, float((p.argmax(-1) == w["probs"].argmax(-1)).mean()))
        probs[name] = got
        rec = {"seg_switches": name, **switches, "images": len(flat), "launches": launches,
               "kernel_batch_s": k_s, "kernel_images_per_s": len(flat) / k_s,
               "plain_batch_s": p_s, "plain_images_per_s": len(flat) / p_s,
               "kernel_peak_gib": k_peak, "plain_peak_gib": p_peak,
               "probs_max_abs_err": err, "labels_agreement_min": agree}
        print(json.dumps(rec), flush=True)
        if not (launches == SEG_LAUNCHES and err <= SEG_PROBS_TOL and agree >= SEG_LABEL_AGREE):
            raise AssertionError(f"seg switches {name}: kernel vs plain blocks out of bounds "
                                 f"or {launches} launches, want {SEG_LAUNCHES}: {rec}")
        out[name] = rec

    def dist(a, b):
        return max(float(np.abs(x["probs"] - y["probs"]).max()) for x, y in zip(a, b))

    # lowres=False is exact; window_exact=False moves the probabilities (the
    # SE means and the BiFPN see the canvas padding): the switch took effect
    rec = {"seg_lowres_false_vs_true_max_abs": dist(probs["lowres_false"], probs["default"]),
           "seg_unwindowed_vs_default_max_abs": dist(probs["window_exact_false"],
                                                     probs["default"])}
    print(json.dumps(rec), flush=True)
    if not (rec["seg_lowres_false_vs_true_max_abs"] <= SEG_LOWRES_TOL
            and rec["seg_unwindowed_vs_default_max_abs"] > 0):
        raise AssertionError(f"seg switches: lowres=False vs True out of bounds, or "
                             f"window_exact=False changed nothing: {rec}")
    out["lowres"] = rec

    n_img = sum(len(imgs) for imgs, _ in batches)
    rates = {name: [] for name in kernel_engines}
    for _ in range(SWITCH_TURNS):
        for name, engine in kernel_engines.items():
            rates[name].append(n_img / _seg_run(engine, batches)[1])
    base = float(np.median(rates["default"]))
    turns = {"seg_switch_turns": SWITCH_TURNS, "images_per_turn": n_img}
    for name, r in rates.items():
        turns[name] = {"median_images_per_s": float(np.median(r)), "min": min(r), "max": max(r),
                       "median_vs_default": float(np.median(r)) / base}
    print(json.dumps(turns), flush=True)
    out["turns"] = turns
    return out


def _sass_counts() -> dict:
    """Tensor-core (HGMMA) instructions of the built MBConv library by
    operand type: bf16 for the bf16 kernel, tf32 for the f32 one."""
    import shutil

    from muscle_tpu_torch.ops import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path("mbconv"))],
                          capture_output=True, text=True, check=True).stdout
    hgmma = [line for line in sass.splitlines() if "HGMMA" in line]
    return {"hgmma_bf16": sum("BF16" in line for line in hgmma),
            "hgmma_tf32": sum("TF32" in line for line in hgmma)}


def _fused_mean_errs(got, want, key: str = "sgc") -> tuple[list, float]:
    """(per-map mean |got - want| away from the fusion's zeroing, largest
    share of a map's pixels whose zeroing flipped) over the records' fused
    maps (``_map_err`` says why the zeroed pixels are set apart)."""
    import numpy as np

    errs, flips = [], 0.0
    for g, w in zip(got, want):
        assert g["name"] == w["name"] and sorted(g[key]) == sorted(w[key])
        for c in w[key]:
            a, b = g[key][c].astype(np.float32), w[key][c].astype(np.float32)
            zg, zw = a == a.min(), b == b.min()
            keep = ~(zg | zw)
            errs.append(float(np.abs(a[keep] - b[keep]).mean()) if keep.any() else 0.0)
            flips = max(flips, float((zg != zw).mean()))
    return errs, flips


def _bf16_cam(n_batches: int) -> dict:
    """The JAX bench's CAM configuration (CamBench: b3 enc, bf16, lowres, 4
    classes, stride-4 grid, uint8 download, tight 4:2:0 upload) with the
    MBConv kernel and with the plain blocks, and the same engine at f32."""
    import numpy as np
    import torch

    from muscle_tpu_torch.inference import CamTTAEngine
    from muscle_tpu_torch.models import MuSCLe, init_weights

    models = {fuse: init_weights(MuSCLe(backbone_name="efficientnet-b3", mode="enc",
                                        last_pooling=False, fuse_mbconv=fuse),
                                 torch.Generator().manual_seed(0)) for fuse in (384, 0)}
    cfg = dict(scales=(0.5, 1.0, 1.5, 2.0), return_cam=False, max_classes=4, accum_stride=4,
               download_dtype="uint8", tight_upload=True, upload_mode="ycbcr420", device="cuda")
    engines = {"bf16": CamTTAEngine(models[384], compute_dtype=torch.bfloat16, **cfg),
               "bf16_plain": CamTTAEngine(models[0], compute_dtype=torch.bfloat16, **cfg),
               "f32": CamTTAEngine(models[384], **cfg)}
    warm, batches = _images(2, seed=1), _images(n_batches, seed=2)
    for e in engines.values():
        _run(e, warm)
    _zero_counts()
    got, bf16_s = _run(engines["bf16"], batches)
    launches = _launch_counts()
    want = 23 * len(cfg["scales"]) * n_batches
    if launches["mbconv_bf16"] != want or launches["mbconv_stride1"]:
        raise AssertionError(f"bf16 CAM: launches {launches}, want {want} bf16 ones "
                             "(23 per forward, 4 forwards per batch) and no f32 ones")
    plain, _ = _run(engines["bf16_plain"], batches)
    f32, f32_s = _run(engines["f32"], batches)
    _check_contract(got, batches)
    score_err = max(float(np.abs(g["score"] - w["score"]).max()) for g, w in zip(got, plain))
    errs, flips = _fused_mean_errs(got, plain)
    own, _ = _fused_mean_errs(plain, f32)  # each map's own bf16 sensitivity
    vs_f32, vs_f32_flips = _fused_mean_errs(got, f32)
    tols = [max(BF16_SGC_TOL, BF16_SGC_REL * o) for o in own]
    n_img = 8 * n_batches
    rec = {"bf16": "cam, CamBench config", "images": n_img,
           "launches_bf16": launches["mbconv_bf16"], "bf16_images_per_s": n_img / bf16_s,
           "f32_images_per_s": n_img / f32_s,
           "kernel_vs_plain_score_max_abs_err": score_err,
           "kernel_vs_plain_sgc_mean_abs_err_max": max(errs),
           "kernel_vs_plain_sgc_mean_abs_err_median": float(np.median(errs)),
           "sgc_maps": len(errs),
           "sgc_maps_within_abs_tol": sum(e <= BF16_SGC_TOL for e in errs),
           "kernel_vs_plain_over_own_bf16_max": max(e / max(o, 1e-12) for e, o in zip(errs, own)),
           "kernel_vs_plain_zeroing_flips": flips,
           "plain_bf16_vs_f32_sgc_mean_abs_err_max": max(own),
           "plain_bf16_vs_f32_sgc_mean_abs_err_median": float(np.median(own)),
           "bf16_vs_f32_sgc_mean_abs_err_max": max(vs_f32),
           "bf16_vs_f32_sgc_mean_abs_err_median": float(np.median(vs_f32)),
           "bf16_vs_f32_zeroing_flips": vs_f32_flips}
    print(json.dumps(rec), flush=True)
    if not (score_err <= BF16_SCORE_TOL and all(e <= t for e, t in zip(errs, tols))):
        raise AssertionError(f"bf16 CAM out of bounds: {rec}")
    return rec


def _bf16_seg(n_batches: int, window_exact: bool = True) -> dict:
    """The JAX bench's seg configuration (SegBench: b7 dec, BiFPN 3 x 256,
    bf16, stride-4 grid, tight 4:2:0 upload, labels) with the MBConv kernel
    and with the plain blocks, the same at f32, and f32 probabilities for
    the top-two margin; every engine at ``window_exact``."""
    import numpy as np
    import torch

    from muscle_tpu_torch.inference import SegTTAEngine

    fused = _seg_model(384)
    plain = _seg_model(0)
    plain.load_state_dict(fused.state_dict())
    cfg = dict(scales=SEG_SCALES, accum_stride=4, download_dtype="float16", tight_upload=True,
               upload_mode="ycbcr420", window_exact=window_exact, device="cuda")
    bf16 = torch.bfloat16
    engines = {"bf16": SegTTAEngine(fused, compute_dtype=bf16, output="labels", **cfg),
               "bf16_plain": SegTTAEngine(plain, compute_dtype=bf16, output="labels", **cfg),
               "f32": SegTTAEngine(fused, output="labels", **cfg)}
    warm, batches = _seg_batches(1, seed=1), _seg_batches(n_batches, seed=2)
    for e in engines.values():
        _seg_run(e, warm)
    _zero_counts()
    got, bf16_s = _seg_run(engines["bf16"], batches)
    launches = _launch_counts()
    if launches["mbconv_bf16"] != SEG_LAUNCHES * n_batches or launches["mbconv_stride1"]:
        raise AssertionError(f"bf16 seg: launches {launches}, want {SEG_LAUNCHES * n_batches} "
                             "bf16 ones (48 per forward, 6 per batch) and no f32 ones")
    plain_out, _ = _seg_run(engines["bf16_plain"], batches)
    f32, f32_s = _seg_run(engines["f32"], batches)
    probs, _ = _seg_run(SegTTAEngine(fused, **cfg), batches)
    flat = [img for imgs, _ in batches for img in imgs]
    agree, own, vs_f32, clear_share, classes = [], [], [], 1.0, set()
    for g, w, f, p, img in zip(got, plain_out, f32, probs, flat):
        assert g["label"].shape == img.shape[:2] and g["label"].dtype == np.uint8
        top2 = np.sort(p["probs"].astype(np.float32), axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > BF16_MARGIN
        agree.append(float((g["label"] == w["label"])[clear].mean()))
        own.append(float((w["label"] == f["label"])[clear].mean()))
        vs_f32.append(float((g["label"] == f["label"])[clear].mean()))
        clear_share = min(clear_share, float(clear.mean()))
        classes |= set(np.unique(g["label"]).tolist())
    # each image: kernel vs plain blocks disagree on at most the larger of
    # 1 - BF16_LABEL_AGREE and BF16_SGC_REL times the plain bf16 blocks'
    # own disagreement with f32
    floors = [1 - max(1 - BF16_LABEL_AGREE, BF16_SGC_REL * (1 - o)) for o in own]
    n_img = SEG_PER_BATCH * n_batches
    rec = {"bf16": f"seg, SegBench config, window_exact={window_exact}", "images": n_img,
           "launches_bf16": launches["mbconv_bf16"],
           "launches_bf16_per_batch": launches["mbconv_bf16"] / n_batches,
           "bf16_images_per_s": n_img / bf16_s, "f32_images_per_s": n_img / f32_s,
           "kernel_vs_plain_labels_agreement": agree,
           "plain_bf16_vs_f32_labels_agreement": own,
           "bf16_vs_f32_labels_agreement": vs_f32, "margin_share_min": clear_share,
           "classes_seen": len(classes)}
    print(json.dumps(rec), flush=True)
    if not (all(a >= fl for a, fl in zip(agree, floors)) and len(classes) > 1):
        raise AssertionError(f"bf16 seg out of bounds: {rec}")
    return rec


def _bf16_irn(n_batches: int) -> dict:
    """RandomWalkRefiner at crop 512, fast IO, labels: the edge model in
    bf16 and the stencil walk in f32, beside the f32 refiner."""
    import torch

    from muscle_tpu_torch.inference import RandomWalkRefiner

    model = _irn_model()
    batches, warm = _irn_batches(n_batches, seed=4), _irn_batches(1, seed=5)
    kw = dict(crop_size=512, fast_io=True, output="labels", device="cuda")
    r16 = RandomWalkRefiner(model, compute_dtype=torch.bfloat16, **kw)
    r32 = RandomWalkRefiner(model, **kw)
    for r in (r16, r32):
        _refine(r, warm)
    _zero_counts()
    got, s16 = _refine(r16, batches)
    launches = _launch_counts()
    if launches["stencil_walk"] != n_batches:
        raise AssertionError(f"bf16 irn: {launches}, want {n_batches} stencil launches")
    want, s32 = _refine(r32, batches)
    agree = _labels_agreement(got, want, batches)
    n_img = 8 * n_batches
    rec = {"bf16": "irn, fast labels, crop 512", "images": n_img,
           "stencil_launches": launches["stencil_walk"],
           "bf16_ms_per_image": s16 * 1e3 / n_img, "f32_ms_per_image": s32 * 1e3 / n_img,
           "bf16_vs_f32_labels_agreement_min": agree}
    print(json.dumps(rec), flush=True)
    if not agree >= BF16_LABEL_AGREE:
        raise AssertionError(f"bf16 irn: labels agree with f32 on {agree} < {BF16_LABEL_AGREE}")
    return rec


def phase_bf16(n_batches: int = BF16_BATCHES) -> dict:
    """The bf16 serving paths: the CAM and seg engines at the JAX bench's
    bf16 configurations (seg also at window_exact=False, one batch) and the
    IRN refiner with its edge model in bf16,
    each beside f32 in the same run; and the bf16 tensor-core instructions
    in the built MBConv library."""
    out = {"cam": _bf16_cam(n_batches["cam"]), "seg": _bf16_seg(n_batches["seg"]),
           "seg_unwindowed": _bf16_seg(1, window_exact=False),
           "irn": _bf16_irn(n_batches["irn"])}
    out["sass"] = _sass_counts()
    print(json.dumps({"bf16_sass": out["sass"]}), flush=True)
    if not out["sass"]["hgmma_bf16"] > 0:
        raise AssertionError(f"no bf16 HGMMA in the MBConv library: {out['sass']}")
    return out


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


def _profile_record(tag, n_batches, wall, rows, ours_name, ours_keys, top: int = 15) -> None:
    device_ms = sum(r[0] for r in rows)
    ours = sum(r[0] for r in rows if any(f"namespace)::{k}" in r[2] for k in ours_keys))
    launches = sum(r[1] for r in rows if not r[2].startswith("Mem"))
    print(json.dumps({
        "profile": tag, "batches": n_batches, "wall_ms": wall * 1e3, "device_ms": device_ms,
        "device_busy_share": device_ms / (wall * 1e3), "device_launches": launches, ours_name: ours,
        "top": [[name[:90], calls, ms] for ms, calls, name in rows[:top]],
    }), flush=True)


def phase_profile(n_batches: int, bf16: bool = False) -> None:
    """Where the device time goes: one torch.profiler window over
    ``n_batches`` CAM batches per engine (kernel and plain blocks), one
    over ``n_batches`` IRN batches of 8 (stencil kernel), and one over a
    seg batch of 4 (MBConv kernel); device time summed by kernel name.
    f32: the --fast 0 CAM and seg configurations; with ``bf16`` (the bf16
    phase chosen too) the bf16 paths at the JAX bench's configurations
    instead, and the IRN edge model in bf16."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from muscle_tpu_torch.inference import CamTTAEngine
    from muscle_tpu_torch.models import MuSCLe, init_weights

    dtype = torch.bfloat16 if bf16 else torch.float32
    tag = "bf16 CamBench" if bf16 else "fast0"
    cam_cfg = dict(max_classes=4, accum_stride=4, download_dtype="uint8", tight_upload=True,
                   upload_mode="ycbcr420") if bf16 else {}
    mbconv_keys = ("expand_dw_kernel", "se_kernel", "project_kernel")
    batches = _images(n_batches, seed=3)
    for fuse in (384, 0):
        m = init_weights(MuSCLe(backbone_name="efficientnet-b3", mode="enc",
                                last_pooling=False, fuse_mbconv=fuse),
                         torch.Generator().manual_seed(0))
        engine = CamTTAEngine(m, return_cam=False, compute_dtype=dtype, device="cuda", **cam_cfg)
        _run(engine, _images(1, seed=1))
        # device activity only: tracing host ops would slow the dispatch
        # and understate the busy share
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall = _run(engine, batches)
        _profile_record(f"{tag} fuse_mbconv={fuse}", n_batches, wall, _device_rows(prof),
                        "mbconv_kernel_ms", mbconv_keys)

    from muscle_tpu_torch.inference import RandomWalkRefiner

    refiner = RandomWalkRefiner(_irn_model(), crop_size=512, fast_io=True, output="labels",
                                compute_dtype=dtype, device="cuda")
    _refine(refiner, _irn_batches(1, seed=5))
    irn_batches = _irn_batches(n_batches, seed=6)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = _refine(refiner, irn_batches)
    _profile_record(f"irn fast labels, stencil kernel, edge model {dtype}", n_batches, wall,
                    _device_rows(prof), "stencil_kernel_ms", ("stencil_step",))

    from muscle_tpu_torch.inference import SegTTAEngine

    seg_cfg = (dict(accum_stride=4, tight_upload=True, upload_mode="ycbcr420", output="labels")
               if bf16 else dict(upload_mode="rgb", tight_upload=False))
    engine = SegTTAEngine(_seg_model(384), scales=SEG_SCALES, compute_dtype=dtype,
                          device="cuda", **seg_cfg)
    _seg_run(engine, _seg_batches(1, seed=1))
    batch = _seg_batches(1, seed=3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = _seg_run(engine, batch)
    _profile_record(f"seg {'bf16 SegBench' if bf16 else 'fast0'} b7, MBConv kernel", 1, wall,
                    _device_rows(prof), "mbconv_kernel_ms", mbconv_keys, top=30)
    if bf16:  # the breakdown reads the RGB canvas of the upload
        engine = SegTTAEngine(engine.model, scales=SEG_SCALES, compute_dtype=dtype,
                              upload_mode="rgb", tight_upload=False, device="cuda")
        _seg_run(engine, _seg_batches(1, seed=1))
    _seg_breakdown(engine, batch[0])


def _seg_breakdown(engine, batch) -> None:
    """Device ms of one seg batch by stage, each stage profiled on its own:
    the whole device pipeline, the backbone alone and the model (backbone,
    BiFPN and head) at each scale's (orig, flip) canvas, in the engine's
    compute dtype; the rest of the pipeline is the upload unpack, the
    bicubic scaling, the logits' upsample, softmax and accumulation.  The
    engine uploads RGB."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from muscle_tpu_torch.inference.cam import _batch_canvas, scaled_pairs
    from muscle_tpu_torch.inference.seg import N_STRIDED_DEC

    def device_ms(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(r[0] for r in _device_rows(prof))

    prep = engine._host_prep(*batch)
    sizes_np = prep["orig_sizes"]
    with torch.inference_mode():
        total = device_ms(lambda: engine._device_pipeline(prep["upload"], sizes_np))
        images = engine._put(prep["upload"][1])
        sizes = engine._put(sizes_np)
        backbone = model = 0.0
        for s in SEG_SCALES:
            canvas = _batch_canvas(s, sizes_np, engine.max_side, n_strided=N_STRIDED_DEC)
            scaled, off, pairs = scaled_pairs(images, sizes, s, canvas, engine._mean,
                                              engine._std, N_STRIDED_DEC)
            pairs = pairs.to(engine.compute_dtype)
            win = torch.cat([off, scaled], -1).repeat_interleave(2, dim=0)
            backbone += device_ms(lambda: engine.model.backbone(pairs, valid_window=win))
            model += device_ms(lambda: engine.model(pairs, mode="seg_lowres", valid_window=win))
    print(json.dumps({"seg_breakdown": f"{engine.compute_dtype}, RGB upload, one batch of 4, "
                                        "device ms",
                      "pipeline": total, "backbone": backbone, "bifpn_and_head": model - backbone,
                      "engine_rest": total - model}), flush=True)


def _ycbcr_planes(rng, n: int, side: int):
    """n smooth random side x side RGB images (16-pixel blocks plus
    noise) as the datasets' uint8 4:2:0 planes (y (n, side, side), c (n,
    side/2, side/2, 2)), made with numpy: BT.601 full range, the chroma
    box-subsampled."""
    import numpy as np

    lo = rng.uniform(0, 255, (n, side // 16, side // 16, 3))
    rgb = np.kron(lo, np.ones((1, 16, 16, 1))) + rng.normal(0, 12, (n, side, side, 3))
    rgb = np.clip(rgb, 0, 255)
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    cb = 128 - 0.168736 * rgb[..., 0] - 0.331264 * rgb[..., 1] + 0.5 * rgb[..., 2]
    cr = 128 + 0.5 * rgb[..., 0] - 0.418688 * rgb[..., 1] - 0.081312 * rgb[..., 2]
    c = np.stack([cb, cr], -1).reshape(n, side // 2, 2, side // 2, 2, 2).mean((2, 4))
    return np.round(y).astype(np.uint8), np.round(c).astype(np.uint8)


def _train_batch(n: int, crop: int, view: int, seed: int) -> dict:
    """A batch in the MCL dataset's default output (uint8 4:2:0 planes
    img/view1/view2, int32 overlaps coord1/coord2 of two view-sized crops
    of a crop-sized image, float32 labels), made with numpy: smooth random
    images, each class on a pair of consecutive images (IMC has positives
    and negatives)."""
    import numpy as np

    from muscle_tpu_torch.data.transforms import _intersection

    rng = np.random.default_rng(seed)
    b = {}
    for key, side in (("img", crop), ("view1", view), ("view2", view)):
        b[key + "_y"], b[key + "_c"] = _ycbcr_planes(rng, n, side)
    coords = []
    while len(coords) < n:
        i1, j1, i2, j2 = (int(v) for v in rng.integers(0, 2 * view - view + 1, 4))
        rel1, rel2, _ = _intersection((i1, j1, view, view), (i2, j2, view, view))
        if rel1 is not None:
            coords.append((rel1, rel2))
    b["coord1"] = np.asarray([c[0] for c in coords], np.int32)
    b["coord2"] = np.asarray([c[1] for c in coords], np.int32)
    b["label"] = np.zeros((n, 20), np.float32)
    return b


def _live_labels(model, batch: dict) -> dict:
    """Label the batch with the classes whose random view-1 CAMs vary most,
    two classes per image, the same two for each pair of consecutive
    images (IMC then has positives and negatives).  A random classifier's
    rectified CAM is all zero for about half the classes (the background's
    too, here), and PixPro's per-pixel cosine over a single live channel
    is 1 whatever the map: it needs two."""
    import torch

    from muscle_tpu_torch.training import decode_image

    with torch.no_grad():
        was = model.training
        cams, _ = model.eval()(decode_image(batch, "view1"), mode="pix")
        model.train(was)
    spread = (cams.amax(dim=(1, 2)) - cams.amin(dim=(1, 2)))[:, 1:].mean(dim=0)
    live = spread.argsort(descending=True).tolist()
    label = torch.zeros_like(batch["label"])
    for i in range(label.shape[0]):
        pair = (i // 2) % 4
        label[i, live[2 * pair]] = label[i, live[2 * pair + 1]] = 1.0
    return dict(batch, label=label)


def _train_model(backbone: str, seed: int):
    import torch

    from muscle_tpu_torch.models import MuSCLe, init_weights

    model = MuSCLe(backbone_name=backbone, mode="enc", last_pooling=False, fuse_mbconv=0)
    return init_weights(model, torch.Generator().manual_seed(seed))


def _grads(model) -> dict:
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: p.grad.detach().cpu().clone() for p in model.trained_parameters()}


def _grad_err(card: dict, cpu: dict, tol: float, zero_share: float) -> tuple[float, str]:
    """The worst gradient difference over its limit (GRAD_TOLS), and its
    parameter."""
    noise = zero_share * max(float(g.abs().max()) for g in cpu.values())
    worst, name = 0.0, ""
    for k, g in cpu.items():
        err = float((card[k] - g).abs().max()) / max(tol * float(g.abs().max()), noise)
        if err >= worst:
            worst, name = err, k
    return worst, name


@contextlib.contextmanager
def _tf32_restored():
    """Context: the TF32 switches of cuDNN and of matmul restored after."""
    import torch

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _card_vs_cpu_readings(card: tuple, cpu: tuple) -> dict:
    """Loss, BN-statistic and gradient errors of one card run against the
    CPU's, with ``passed``."""
    (mc, sc, gc), (mh, sh, gh) = card, cpu
    worst = max(abs(mc[k] - mh[k]) / (TRAIN_RTOL * abs(mh[k]) + TRAIN_ATOL) for k in mh)
    stat_err = max(float((sc[k] - sh[k]).abs().max()) for k in sh)
    grad_err = {step: _grad_err(gc[step], gh[step], *GRAD_TOLS[step]) for step in GRAD_TOLS}
    finite = all(v == v and abs(v) < float("inf") for v in mc.values())
    return {"card": mc, "loss_err_over_tol": worst, "bn_stat_max_abs_err": stat_err,
            "grad_err_over_tol": {step: {"worst": e, "param": k}
                                  for step, (e, k) in grad_err.items()},
            "finite": finite,
            "passed": (worst <= 1.0 and stat_err <= TRAIN_STAT_TOL and finite
                       and all(e <= 1.0 for e, _ in grad_err.values()))}


def _check_train_card_vs_cpu() -> dict:
    """One step A (IMC on) and one step B (PixPro + EMD) at b1 on the card
    and on the CPU, from the same weights, batch and EMD crop fractions,
    drop-connect off: loss terms, every parameter's gradient of each step,
    and BN statistics.  The card runs twice: f32 (TF32 off), which must
    pass, and the control with TF32 on, which must fail (the check can
    tell a lower-precision card path)."""
    import copy

    import torch

    from muscle_tpu_torch.losses import draw_crop_fractions
    from muscle_tpu_torch.training import MCLConfig, make_adam, mcl_train_step, mcl_views_step

    cfg = MCLConfig(True, True, True)
    base = _train_model(CHECK_BACKBONE, seed=1)
    base.backbone.drop_connect_rate = 0.0
    host = {k: torch.from_numpy(v) for k, v in
            _train_batch(CHECK_BATCH, CHECK_CROP, CHECK_VIEW, seed=1).items()}
    host = {k: v.cpu() for k, v in _live_labels(base, host).items()}
    frac = draw_crop_fractions(CHECK_BATCH, torch.Generator().manual_seed(1))
    runs = {}
    with _tf32_restored():
        for name, dev, tf32 in (("f32", "cuda", False), ("tf32", "cuda", True),
                                ("cpu", "cpu", False)):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            model = copy.deepcopy(base).to(dev)
            opt = make_adam(model.trained_parameters(), TRAIN_LR, TRAIN_WD)
            batch = {k: v.to(dev) for k, v in host.items()}
            m = {k: float(v) for k, v in mcl_train_step(model, opt, batch, cfg).items()}
            grads = {"step_a": _grads(model)}
            stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
                     if k.endswith("running_mean") or k.endswith("running_var")}
            m.update({k: float(v) for k, v in
                      mcl_views_step(model, opt, batch, cfg, crop_frac=frac.to(dev)).items()})
            grads["step_b"] = _grads(model)
            runs[name] = (m, stats, grads)
    f32 = _card_vs_cpu_readings(runs["f32"], runs["cpu"])
    control = _card_vs_cpu_readings(runs["tf32"], runs["cpu"])
    rec = {"train_mcl_card_vs_cpu": CHECK_BACKBONE, "batch": CHECK_BATCH, "crop": CHECK_CROP,
           "cpu": runs["cpu"][0], "f32": f32, "tf32_control": control}
    print(json.dumps(rec), flush=True)
    if not f32["passed"]:
        raise AssertionError(f"train_mcl card vs CPU failed: {f32}")
    if control["passed"]:
        raise AssertionError("train_mcl card vs CPU passed with TF32 on: the check is blind")
    return rec


def _bn_cost(model, opt, batch: dict, gen) -> dict:
    """What the Flax-style BN update costs step A: the epoch-0 step with
    the backbone's ``BatchNorm2d`` and with plain ``torch.nn.BatchNorm2d``
    (unbiased variance update) in its place, alternating (port, plain,
    port, plain), each 1 warm-up and TRAIN_ITERS timed iterations: step A
    device ms (CUDA events), wall ms an iteration, device launches of one
    step (kernels; copies not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from muscle_tpu_torch.models.efficientnet import BatchNorm2d
    from muscle_tpu_torch.training import MCLConfig, mcl_train_step

    forwards = {"port": BatchNorm2d.forward, "plain": torch.nn.BatchNorm2d.forward}
    runs = {"port": [], "plain": []}
    try:
        for variant in ("port", "plain", "port", "plain"):
            BatchNorm2d.forward = forwards[variant]
            mcl_train_step(model, opt, batch, MCLConfig(), gen)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            for _ in range(TRAIN_ITERS):
                mcl_train_step(model, opt, batch, MCLConfig(), gen)
            ev[1].record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / TRAIN_ITERS
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                mcl_train_step(model, opt, batch, MCLConfig(), gen)
                torch.cuda.synchronize()
            launches = sum(r[1] for r in _device_rows(prof) if not r[2].startswith("Mem"))
            runs[variant].append({"step_a_device_ms": ev[0].elapsed_time(ev[1]) / TRAIN_ITERS,
                                  "iter_wall_ms": wall * 1e3, "device_launches": launches})
    finally:
        BatchNorm2d.forward = forwards["port"]
    return runs


def phase_train_mcl(card: str) -> dict:
    """MCL training at the train_mcl default: MuSCLe-b3 enc (float32, TF32
    off, seeded random weights), batch 16, crop 448, views 224, 4:2:0
    upload; the epoch-0 configuration (step A) and the epoch-12 one (step A
    with IMC, then step B with PixPro and EMD), 2 warm-up and 5 timed
    iterations each, every iteration uploading its batch.  Counts the
    kernels' launches during training (the MBConv kernel has no backward:
    training runs the plain blocks), probes every loss term's gradient
    norm, times step A with plain BNs beside the port's, and holds the
    card's steps to the CPU's at b1."""
    import torch

    from muscle_tpu_torch.inference.upload import to_device
    from muscle_tpu_torch.training import (
        MCLConfig,
        make_adam,
        mcl_term_grad_norms,
        mcl_train_step,
        mcl_views_step,
    )

    dev = torch.device("cuda")
    model = _train_model(TRAIN_BACKBONE, seed=0).to(dev)
    opt = make_adam(model.trained_parameters(), TRAIN_LR, TRAIN_WD)
    gen = torch.Generator(device=dev).manual_seed(0)
    hosts = []
    for seed in range(2):
        b = {k: torch.from_numpy(v) for k, v in
             _train_batch(TRAIN_BATCH, TRAIN_CROP, TRAIN_VIEW, seed).items()}
        hosts.append({k: v.cpu().numpy() for k, v in
                      _live_labels(model, {k: v.to(dev) for k, v in b.items()}).items()})
    out = {"train_mcl": TRAIN_BACKBONE, "batch": TRAIN_BATCH, "crop": TRAIN_CROP,
           "view": TRAIN_VIEW, "card": card}
    _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, cfg in (("epoch0", MCLConfig()), ("epoch12", MCLConfig(True, True, True))):
        marks = []  # (before A, after A, after B) events of each timed iteration
        for it in range(TRAIN_WARMUP + TRAIN_ITERS):
            if it == TRAIN_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            batch = {k: to_device(v, dev) for k, v in hosts[it % 2].items()}
            ev[0].record()
            metrics = mcl_train_step(model, opt, batch, cfg, gen)
            ev[1].record()
            if cfg.use_pixpro:
                metrics.update(mcl_views_step(model, opt, batch, cfg, gen))
            ev[2].record()
            if it >= TRAIN_WARMUP:
                marks.append(ev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / TRAIN_ITERS
        a_ms = sum(e[0].elapsed_time(e[1]) for e in marks)
        b_ms = sum(e[1].elapsed_time(e[2]) for e in marks)
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(v == v and abs(v) < float("inf") for v in vals.values()):
            raise AssertionError(f"train_mcl {name}: losses not finite: {vals}")
        out[name] = {"step_a_ms": a_ms / TRAIN_ITERS,
                     "step_b_ms": b_ms / TRAIN_ITERS if cfg.use_pixpro else None,
                     "iter_wall_ms": wall * 1e3, "images_per_s": TRAIN_BATCH / wall,
                     "losses": vals}
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # where the device time goes: two epoch-12 iterations, device activity only
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(2):
            batch = {k: to_device(v, dev) for k, v in hosts[it].items()}
            mcl_train_step(model, opt, batch, cfg, gen)
            mcl_views_step(model, opt, batch, cfg, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _profile_record("train_mcl epoch12 (step A + step B)", 2, wall, _device_rows(prof),
                    "mbconv_kernel_ms", ("expand_dw_kernel", "se_kernel", "project_kernel"),
                    top=25)
    out["launches"] = _launch_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"train_mcl launched kernels of the inference paths: "
                             f"{out['launches']}")
    batch = {k: to_device(v, dev) for k, v in hosts[0].items()}
    t0 = time.perf_counter()
    # liveness with train-mode views, the JAX package's probe for random
    # weights: every term's norm at least LIVE_FLOOR of the largest; step B's
    # terms as step B runs them (eval-mode views) for information: there a
    # random net's flat maps leave EMD's gradient at ~1e-8
    norms = mcl_term_grad_norms(model, batch, gen, views_train_mode=True)
    out["term_grad_norms_views_train"] = norms
    floor = LIVE_FLOOR * max(norms.values())
    if sorted(norms) != ["emd", "er", "focal", "imc", "pair", "pixpro", "softmargin"] or \
            not all(n >= floor for n in norms.values()):
        raise AssertionError(f"train_mcl: a loss term's gradient norm is below {floor:.3g}: "
                             f"{norms}")
    out["term_grad_norms_eval_views"] = mcl_term_grad_norms(model, batch, gen)
    out["liveness_s"] = time.perf_counter() - t0
    out["bn_cost"] = _bn_cost(model, opt, batch, gen)
    print(json.dumps(out), flush=True)
    del model, opt, batch
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = _check_train_card_vs_cpu()
    return out


def _profile_steps(tag: str, step) -> None:
    """Device time by kernel name and the busy share of two training steps
    ``step(0)``, ``step(1)`` (device activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(2):
            step(it)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _profile_record(tag, 2, wall, _device_rows(prof), "mbconv_kernel_ms",
                    ("expand_dw_kernel", "se_kernel", "project_kernel"), top=20)


@contextlib.contextmanager
def _bn_frozen_train(model):
    """Context: ``batch_stats_train`` (train mode, BNs updating nothing)
    with drop-connect off; restored after."""
    from muscle_tpu_torch.training import batch_stats_train

    rate = model.backbone.drop_connect_rate
    model.backbone.drop_connect_rate = 0.0
    try:
        with batch_stats_train(model):
            yield model
    finally:
        model.backbone.drop_connect_rate = rate


def _seg_train_batch(model, n: int, crop: int, seed: int, calibrate: bool = False) -> dict:
    """A batch in the seg dataset's default output (uint8 4:2:0 planes, a
    packed uint8 soft mask with its channel ids, float32 labels), made with
    numpy and the model on its device.  Labels: each image's two
    foreground classes that the model's train-mode map covers most, so
    BEACON finds their boundaries; the mask: the softmax of the map over
    the background and those two classes (the classes meet where the map
    changes class), x255-quantised.  calibrate: first rescale the head on
    these images in train mode (``calibrate_seg_head``: a random BiFPN
    labels every pixel one class)."""
    import numpy as np
    import torch

    from muscle_tpu_torch.models import calibrate_seg_head
    from muscle_tpu_torch.training import decode_image

    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    y, c = _ycbcr_planes(rng, n, crop)
    img = decode_image({"img_y": torch.from_numpy(y).to(dev),
                        "img_c": torch.from_numpy(c).to(dev)}, "img")
    with _bn_frozen_train(model), torch.no_grad():
        if calibrate:
            calibrate_seg_head(model, img)
        seg = model(img, mode="seg")[0]
    area = torch.nn.functional.one_hot(seg.argmax(-1), seg.shape[-1]).sum(dim=(1, 2))[:, 1:]
    top = area.argsort(dim=1, descending=True, stable=True)[:, :2] + 1  # (n, 2) classes
    ids = torch.cat([torch.zeros_like(top[:, :1]), top], dim=1)  # background first
    probs = torch.softmax(torch.gather(seg, -1, ids[:, None, None, :].expand(-1, crop, crop, 3)),
                          dim=-1)
    label = torch.zeros((n, 20), device=dev)
    label.scatter_(1, top - 1, 1.0)
    return {"img_y": y, "img_c": c,
            "mask": torch.round(probs * 255.0).to(torch.uint8).cpu().numpy(),
            "mask_idx": ids.to(torch.int32).cpu().numpy(), "label": label.cpu().numpy()}


def _seg_train_model(backbone: str, bifpn_layers: int, bifpn_channels: int, fuse: int,
                     seed: int, device):
    import torch

    from muscle_tpu_torch.models import MuSCLe, init_weights

    model = MuSCLe(backbone_name=backbone, mode="dec", bifpn_layers=bifpn_layers,
                   bifpn_channels=bifpn_channels, last_pooling=True, fuse_mbconv=fuse)
    return init_weights(model, torch.Generator().manual_seed(seed)).to(device)


def _beacon_signs(model, batch: dict, cfg, draws):
    """BEACON's (count, sign_mask, sign_sim) of each (image, class) pair on
    a train-mode forward that updates nothing, both marginals stacked."""
    import torch

    from muscle_tpu_torch.core.cam_norm import attach_bg_channel
    from muscle_tpu_torch.losses.beacon import FieldLossConfig, pair_signs, pair_similarities
    from muscle_tpu_torch.training.seg import _dequant_batch

    b = _dequant_batch(batch, cfg.num_classes)
    with _bn_frozen_train(model), torch.no_grad():
        seg_map, dense_ft = model(b["img"], mode="seg")
        flc = FieldLossConfig(num_classes=seg_map.shape[-1], k=cfg.k, step=cfg.step,
                              beta=cfg.beta)
        sim, sim_mask, count, _ = pair_similarities(seg_map, dense_ft, b["mask"],
                                                    attach_bg_channel(b["label"]), flc, draws)
        signs = [pair_signs(sim, sim_mask, axis) for axis in (1, 0)]
    return (count.cpu(), torch.stack([s[0] for s in signs]).cpu(),
            torch.stack([s[1] for s in signs]).cpu())


def _seg_card_vs_cpu_readings(card: tuple, cpu: tuple, k_samples: int) -> dict:
    """Loss, BN-statistic and gradient errors of one seg card run against
    the CPU's (each over its limit), BEACON's boundary counts and sign
    flips, with ``passed``."""
    import torch

    (mc, sc, gc, (cc, smc, ssc)), (mh, sh, gh, (ch, smh, ssh)) = card, cpu
    loss_err = max(abs(mc[k] - mh[k]) / (TRAIN_RTOL * abs(mh[k]) + TRAIN_ATOL) for k in mh)
    stat_err = max(float(((sc[k] - sh[k]).abs() / (SEG_STAT_ATOL + TRAIN_RTOL * sh[k].abs()))
                         .max()) for k in sh)
    grad_err, grad_param = _grad_err(gc, gh, *SEG_GRAD_TOLS)
    engaged = ch > k_samples
    same_counts = bool(torch.equal(cc, ch))
    return {"card": mc, "loss_err_over_tol": loss_err, "bn_stat_err_over_tol": stat_err,
            "grad_err_over_tol": grad_err, "grad_worst_param": grad_param,
            "engaged_pairs": int(engaged.sum()), "same_boundary_counts": same_counts,
            "beacon_sign_flips": {"mask": int((smc != smh)[:, engaged].sum()),
                                  "sim": int((ssc != ssh)[:, engaged].sum()),
                                  "of": int(smh[:, engaged].numel())},
            "passed": (loss_err <= 1.0 and stat_err <= 1.0 and grad_err <= 1.0
                       and same_counts)}


def _check_seg_train_card_vs_cpu() -> dict:
    """One seg step at b1 dec (BiFPN 1 x 64, crop 64, batch 2, k 16, step
    3, drop-connect off) on the card and on the CPU from the same weights,
    batch and BEACON draws: loss terms, the gradient norm, every
    parameter's clipped gradient, BN statistics; and BEACON's boundary
    counts (the same on both devices) and sign decisions (flips counted).
    The card runs twice: f32 (TF32 off), which must pass, and the control
    with TF32 on, which must fail."""
    import copy

    import torch

    from muscle_tpu_torch.training import SegConfig, make_adam, seg_train_step

    cfg = SegConfig(k=SEG_CHECK_K, step=3)
    base = _seg_train_model(SEG_CHECK_BACKBONE, 1, 64, 0, seed=1, device="cpu")
    base.backbone.drop_connect_rate = 0.0
    host = {k: torch.from_numpy(v) for k, v in
            _seg_train_batch(base, SEG_CHECK_BATCH, SEG_CHECK_CROP, seed=1,
                             calibrate=True).items()}
    draws = torch.rand((SEG_CHECK_BATCH, 20, SEG_CHECK_CROP, SEG_CHECK_CROP),
                       generator=torch.Generator().manual_seed(1))
    runs = {}
    with _tf32_restored():
        for name, dev, tf32 in (("f32", "cuda", False), ("tf32", "cuda", True),
                                ("cpu", "cpu", False)):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            model = copy.deepcopy(base).to(dev)
            batch = {k: v.to(dev) for k, v in host.items()}
            signs = _beacon_signs(model, batch, cfg, draws.to(dev))
            opt = make_adam(model.trained_parameters(), SEG_TRAIN_LR, SEG_TRAIN_WD)
            m = {k: float(v) for k, v in
                 seg_train_step(model, opt, batch, cfg, draws=draws.to(dev)).items()}
            stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
                     if k.endswith("running_mean") or k.endswith("running_var")}
            runs[name] = (m, stats, _grads(model), signs)
    f32 = _seg_card_vs_cpu_readings(runs["f32"], runs["cpu"], cfg.k)
    control = _seg_card_vs_cpu_readings(runs["tf32"], runs["cpu"], cfg.k)
    rec = {"train_seg_card_vs_cpu": SEG_CHECK_BACKBONE, "batch": SEG_CHECK_BATCH,
           "crop": SEG_CHECK_CROP, "k": cfg.k, "cpu": runs["cpu"][0], "f32": f32,
           "tf32_control": control}
    print(json.dumps(rec), flush=True)
    if not (f32["passed"] and runs["cpu"][0]["loss_beacon"] != 0):
        raise AssertionError(f"train_seg card vs CPU failed: {rec}")
    if control["passed"]:
        raise AssertionError("train_seg card vs CPU passed with TF32 on: the check is blind")
    return rec


def phase_train_seg(card: str) -> dict:
    """Segmentation training at the train_muscle default: MuSCLe-b7 dec
    (BiFPN 3 x 256, float32, TF32 off, seeded random weights, the head
    calibrated), batch 6, crop 448, k 128, step 7, Adam, clip 9, 4:2:0 and
    packed-mask upload; 2 warm-up and 5 timed steps.  The MBConv kernel's
    launches in the steps (0: training runs the plain blocks) and in the
    epoch-end eval that follows (one scale-1 SegTTAEngine batch of 4
    images with the fused blocks, held to the plain blocks); BEACON's own
    ms, every term's gradient norm, and one b1 step held to the CPU."""
    import torch

    from muscle_tpu_torch.core.cam_norm import attach_bg_channel
    from muscle_tpu_torch.inference import SegTTAEngine
    from muscle_tpu_torch.inference.upload import to_device
    from muscle_tpu_torch.losses.beacon import FieldLossConfig, boundary_samples, field_loss
    from muscle_tpu_torch.training import SegConfig, make_adam, seg_term_grad_norms, seg_train_step
    from muscle_tpu_torch.training.seg import _dequant_batch

    launches = _launch_counts
    dev = torch.device("cuda")
    model = _seg_train_model(SEG_TRAIN_BACKBONE, 3, 256, 384, seed=0, device=dev)
    hosts = [_seg_train_batch(model, SEG_TRAIN_BATCH, SEG_TRAIN_CROP, seed, calibrate=seed == 0)
             for seed in range(2)]
    opt = make_adam(model.trained_parameters(), SEG_TRAIN_LR, SEG_TRAIN_WD)
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = SegConfig(k=SEG_TRAIN_K, step=SEG_TRAIN_STEP)
    out = {"train_seg": SEG_TRAIN_BACKBONE, "bifpn": "3 x 256", "batch": SEG_TRAIN_BATCH,
           "crop": SEG_TRAIN_CROP, "k": cfg.k, "step": cfg.step, "card": card}
    _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, beacon = [], []
    for it in range(TRAIN_WARMUP + TRAIN_ITERS):
        if it == TRAIN_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        batch = {k: to_device(v, dev) for k, v in hosts[it % 2].items()}
        ev[0].record()
        metrics = seg_train_step(model, opt, batch, cfg, gen)
        ev[1].record()
        if it >= TRAIN_WARMUP:
            marks.append(ev)
            beacon.append(metrics["loss_beacon"])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TRAIN_ITERS
    _profile_steps("train_seg (2 steps)", lambda it: seg_train_step(
        model, opt, {k: to_device(v, dev) for k, v in hosts[it].items()}, cfg, gen))
    out["step_launches"] = launches()
    out.update(step_ms=sum(e[0].elapsed_time(e[1]) for e in marks) / TRAIN_ITERS,
               iter_wall_ms=wall * 1e3, images_per_s=SEG_TRAIN_BATCH / wall,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               losses={k: float(v) for k, v in metrics.items()},
               loss_beacon_timed=[float(b) for b in beacon])

    # the epoch-end eval: scale 1, fused blocks, against the plain blocks
    imgs, names = _seg_batches(1, seed=3)[0]
    _zero_counts()
    got = SegTTAEngine(model, scales=(1.0,), device=dev).run_batch(imgs, names)
    out["launches"] = launches()
    eval_launches = out["launches"]["mbconv_stride1"]
    plain = _seg_train_model(SEG_TRAIN_BACKBONE, 3, 256, 0, seed=0, device=dev)
    plain.load_state_dict(model.state_dict())
    want = SegTTAEngine(plain, scales=(1.0,), device=dev).run_batch(imgs, names)
    err = max(float(abs(g["probs"] - w["probs"]).max()) for g, w in zip(got, want))
    out.update(eval_images=len(imgs), eval_launches=eval_launches, eval_probs_max_abs_err=err)
    del plain
    model.train()

    # BEACON alone, forward and backward, on the last batch's maps
    b = _dequant_batch(batch, cfg.num_classes)
    label_bg = attach_bg_channel(b["label"])
    flc = FieldLossConfig(k=cfg.k, step=cfg.step)
    with _bn_frozen_train(model), torch.no_grad():
        seg_map, dense_ft = model(b["img"], mode="seg")
    leaf = dense_ft.detach().requires_grad_(True)
    out["beacon_ms"] = time_ms(
        lambda: field_loss(seg_map, leaf, b["mask"], label_bg, flc, gen)[0].backward(), reps=5)
    draws = torch.rand(seg_map.shape[:1] + (20,) + seg_map.shape[1:3], device=dev,
                       generator=gen)
    out["beacon_engaged_pairs"] = int((boundary_samples(seg_map, label_bg, flc, draws)[3]
                                       > cfg.k).sum())
    del seg_map, dense_ft, leaf
    norms = seg_term_grad_norms(model, batch, cfg, gen)
    out["term_grad_norms"] = norms
    print(json.dumps(out), flush=True)
    if any(out["step_launches"].values()) or any(
            v for k, v in out["launches"].items() if k != "mbconv_stride1"):
        raise AssertionError(f"train_seg launched a kernel other than the eval's MBConv: {out}")
    if eval_launches != SEG_EVAL_LAUNCHES or err > SEG_PROBS_TOL:
        raise AssertionError(f"train_seg eval: {eval_launches} MBConv launches (want "
                             f"{SEG_EVAL_LAUNCHES}), probs err {err} (tol {SEG_PROBS_TOL})")
    if not all(v != 0 and v == v for v in out["loss_beacon_timed"]):
        raise AssertionError(f"train_seg: BEACON not engaged on every timed step: {out}")
    if sorted(norms) != ["beacon", "seg"] or not all(
            v >= LIVE_FLOOR * max(norms.values()) and v > 0 for v in norms.values()):
        raise AssertionError(f"train_seg: a loss term's gradient norm is dead: {norms}")
    del model, opt, batch, b
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = _check_seg_train_card_vs_cpu()
    return out


def _irn_train_batch(n: int, crop: int, seed: int) -> dict:
    """A batch in the IRN dataset's default output (uint8 4:2:0 planes and
    bit-packed bg_pos/fg_pos/neg over the stride-4 pair grid), made with
    numpy: each image's pseudo-label a background with two rectangles of
    classes that may overlap and a void band (a canvas pad), its affinity
    masks by ``affinity_labels_from_indices``."""
    import numpy as np
    import torch

    from muscle_tpu_torch.core.bitpack import packbits_last
    from muscle_tpu_torch.ops.affinity_labels import affinity_labels_from_indices
    from muscle_tpu_torch.training.irn import IRNTrainConfig, _grid_path_index

    rng = np.random.default_rng(seed)
    y, c = _ycbcr_planes(rng, n, crop)
    pi = _grid_path_index(IRNTrainConfig(crop_size=crop))
    masks = {k: [] for k in ("bg_pos", "fg_pos", "neg")}
    for _ in range(n):
        lab = np.zeros((crop, crop), np.uint8)
        for cls in rng.choice(np.arange(1, 21), 2, replace=False):
            t, left = rng.integers(0, crop // 2, 2)
            h, w = rng.integers(crop // 4, crop // 2, 2)
            lab[t: t + h, left: left + w] = cls
        lab[:, crop - int(rng.integers(1, crop // 4)):] = 255
        small = torch.from_numpy(lab[2::4, 2::4].reshape(-1).astype(np.int64))
        for k, m in zip(masks, affinity_labels_from_indices(small, pi)):
            masks[k].append(packbits_last(m.numpy().astype(np.uint8)))
    return {"img_y": y, "img_c": c, **{k: np.stack(v) for k, v in masks.items()}}


def _check_irn_train_card_vs_cpu() -> dict:
    """One IRN step at crop 64 (batch 2) on the card and on the CPU from the
    same weights and batch: loss terms and every head parameter's
    gradient; the backbone unchanged on each.  The card runs twice: f32
    (TF32 off), which must pass, and the control with TF32 on, which must
    fail."""
    import copy

    import torch

    from muscle_tpu_torch.models import IRNNet, init_weights
    from muscle_tpu_torch.training import IRNTrainConfig, irn_train_step, make_irn_sgd

    base = init_weights(IRNNet(), torch.Generator().manual_seed(1))
    host = {k: torch.from_numpy(v) for k, v in
            _irn_train_batch(IRN_CHECK_BATCH, IRN_CHECK_CROP, seed=1).items()}
    runs = {}
    with _tf32_restored():
        for name, dev, tf32 in (("f32", "cuda", False), ("tf32", "cuda", True),
                                ("cpu", "cpu", False)):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            model = copy.deepcopy(base).to(dev)
            opt = make_irn_sgd(model, IRN_TRAIN_LR, IRN_TRAIN_WD)
            m = irn_train_step(model, opt, {k: v.to(dev) for k, v in host.items()},
                               IRNTrainConfig(crop_size=IRN_CHECK_CROP))
            names = {id(p): n for n, p in model.named_parameters()}
            grads = {names[id(p)]: p.grad.detach().cpu() for p in model.head_parameters()}
            frozen = all(torch.equal(v.cpu(), base.state_dict()[k])
                         for k, v in model.state_dict().items() if k.startswith("resnet50."))
            runs[name] = ({k: float(v) for k, v in m.items()}, grads, frozen)

    def readings(card, cpu):
        (mc, gc, fc), (mh, gh, fh) = card, cpu
        loss_err = max(abs(mc[k] - mh[k]) / (TRAIN_RTOL * abs(mh[k]) + TRAIN_ATOL) for k in mh)
        grad_err, grad_param = _grad_err(gc, gh, *IRN_GRAD_TOLS)
        return {"card": mc, "loss_err_over_tol": loss_err, "grad_err_over_tol": grad_err,
                "grad_worst_param": grad_param, "backbone_unchanged": fc and fh,
                "passed": loss_err <= 1.0 and grad_err <= 1.0 and fc and fh}

    f32, control = readings(runs["f32"], runs["cpu"]), readings(runs["tf32"], runs["cpu"])
    rec = {"train_irn_card_vs_cpu": "IRNNet", "crop": IRN_CHECK_CROP, "batch": IRN_CHECK_BATCH,
           "cpu": runs["cpu"][0], "f32": f32, "tf32_control": control}
    print(json.dumps(rec), flush=True)
    if not f32["passed"]:
        raise AssertionError(f"train_irn card vs CPU failed: {rec}")
    if control["passed"]:
        raise AssertionError("train_irn card vs CPU passed with TF32 on: the check is blind")
    return rec


def phase_train_irn(card: str) -> dict:
    """IRN training at the train_irn default: IRNNet (ResNet-50 frozen,
    float32, TF32 off, seeded random weights), batch 8, crop 512, 4:2:0
    and bit-packed masks, SGD with momentum and a poly-decayed lr on the
    heads; 2 warm-up and 5 timed steps, the kernels' launches (0), the
    backbone unchanged, and one crop-64 step held to the CPU."""
    import torch

    from muscle_tpu_torch.inference.upload import to_device
    from muscle_tpu_torch.models import IRNNet, init_weights
    from muscle_tpu_torch.training import (
        IRNTrainConfig,
        irn_train_step,
        make_irn_sgd,
        poly_schedule,
        set_learning_rate,
    )

    dev = torch.device("cuda")
    model = init_weights(IRNNet(), torch.Generator().manual_seed(0)).to(dev)
    frozen = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("resnet50.")}
    opt = make_irn_sgd(model, IRN_TRAIN_LR, IRN_TRAIN_WD)
    lr_at = poly_schedule(IRN_TRAIN_LR, TRAIN_WARMUP + TRAIN_ITERS, 0.9)
    cfg = IRNTrainConfig(crop_size=IRN_TRAIN_CROP)
    hosts = [_irn_train_batch(IRN_TRAIN_BATCH, IRN_TRAIN_CROP, seed) for seed in range(2)]
    out = {"train_irn": "IRNNet (ResNet-50 frozen)", "batch": IRN_TRAIN_BATCH,
           "crop": IRN_TRAIN_CROP, "card": card}
    _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = []
    for it in range(TRAIN_WARMUP + TRAIN_ITERS):
        if it == TRAIN_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        set_learning_rate(opt, lr_at(it))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        batch = {k: to_device(v, dev) for k, v in hosts[it % 2].items()}
        ev[0].record()
        metrics = irn_train_step(model, opt, batch, cfg)
        ev[1].record()
        if it >= TRAIN_WARMUP:
            marks.append(ev)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TRAIN_ITERS
    _profile_steps("train_irn (2 steps)", lambda it: irn_train_step(
        model, opt, {k: to_device(v, dev) for k, v in hosts[it].items()}, cfg))
    out["launches"] = _launch_counts()
    vals = {k: float(v) for k, v in metrics.items()}
    sd = model.state_dict()
    out.update(step_ms=sum(e[0].elapsed_time(e[1]) for e in marks) / TRAIN_ITERS,
               iter_wall_ms=wall * 1e3, images_per_s=IRN_TRAIN_BATCH / wall,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30, losses=vals,
               backbone_unchanged=all(torch.equal(sd[k], v) for k, v in frozen.items()))
    print(json.dumps(out), flush=True)
    if any(out["launches"].values()):
        raise AssertionError(f"train_irn launched kernels of the inference paths: {out}")
    if not (out["backbone_unchanged"] and all(v == v and abs(v) < float("inf")
                                              for v in vals.values())):
        raise AssertionError(f"train_irn: backbone moved or losses not finite: {out}")
    del model, opt, batch
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = _check_irn_train_card_vs_cpu()
    return out


# (run, device, compute dtype) of the bf16 card-vs-CPU checks
BF16_CHECK_RUNS = (("card_bf16", "cuda", "bfloat16"), ("cpu_bf16", "cpu", "bfloat16"),
                   ("cpu_f32", "cpu", "float32"))


def _bf16_excess(card, cpu16, cpu32, floor: float = 0.0) -> float:
    """The card's bf16 distance from the CPU's bf16 over its limit (<= 1
    passes): mean |card - cpu16| <= BF16_TRAIN_MEAN x mean |cpu16 - cpu32|
    and max <= BF16_TRAIN_MAX x max |cpu16 - cpu32|, each plus the floor
    (BF16_TRAIN_ULPS half-ulps of the largest CPU bf16 value, or
    ``floor``)."""
    import numpy as np

    c, a, b = (np.asarray(t.detach().float().cpu().numpy() if hasattr(t, "detach") else t,
                          np.float64) for t in (card, cpu16, cpu32))
    d, ref = np.abs(c - a), np.abs(a - b)
    floor = max(floor, BF16_TRAIN_ULPS * 2.0 ** -8 * float(np.abs(a).max()))
    if floor == 0.0 and d.max() == 0.0:
        return 0.0
    return float(max(d.mean() / (BF16_TRAIN_MEAN * ref.mean() + floor),
                     d.max() / (BF16_TRAIN_MAX * ref.max() + floor)))


def _bf16_readings(runs: dict, grad_keys) -> dict:
    """The card's bf16 run against the CPU's bf16 one, each quantity over
    its limit (``_bf16_excess`` against the CPU's own bf16-vs-f32
    distance): the loss terms as a mean over the batches, every
    gradient (floor: BF16_TRAIN_ZERO of the model's largest) and every
    BN statistic of the first batch; and the control that bf16 ran on the
    card: its gradients of the first step in ``grad_keys`` stand off the
    CPU's f32 ones by at least BF16_TRAIN_RAN of the CPU's own
    bf16-vs-f32 distance (printed for every step; step B's, which a
    random net's maxnorm makes ill-conditioned, read 0.22 in a card run
    that ran bf16)."""
    import numpy as np

    card, c16, c32 = runs["card_bf16"], runs["cpu_bf16"], runs["cpu_f32"]
    loss = {}
    for k in c16["losses"][0]:
        p, a, b = (np.asarray([m[k] for m in r["losses"]]) for r in (card, c16, c32))
        floor = BF16_TRAIN_ULPS * 2.0 ** -8 * float(np.abs(a).max())
        loss[k] = float(np.abs(p - a).mean() / (BF16_TRAIN_MEAN * np.abs(a - b).mean() + floor))
    grad = {}
    for step in grad_keys:
        zero = BF16_TRAIN_ZERO * max(float(g.abs().max()) for g in c16["grads"][step].values())
        worst = max((_bf16_excess(card["grads"][step][k], g, c32["grads"][step][k], zero), k)
                    for k, g in c16["grads"][step].items())
        far = np.mean([float((card["grads"][step][k] - c32["grads"][step][k]).abs().mean())
                       for k in c32["grads"][step]])
        own = np.mean([float((c16["grads"][step][k] - c32["grads"][step][k]).abs().mean())
                       for k in c32["grads"][step]])
        grad[step] = {"worst": worst[0], "param": worst[1], "ran_share": float(far / own)}
    stats = max((_bf16_excess(card["stats"][k] - c16["stats0"][k],
                              c16["stats"][k] - c16["stats0"][k],
                              c32["stats"][k] - c16["stats0"][k]), k) for k in c16["stats"])
    passed = bool(all(v <= 1.0 for v in loss.values()) and stats[0] <= 1.0
                  and all(g["worst"] <= 1.0 for g in grad.values())
                  and grad[grad_keys[0]]["ran_share"] >= BF16_TRAIN_RAN)
    return {"loss_err_over_limit": loss, "grad_err_over_limit": grad,
            "bn_stat_err_over_limit": {"worst": stats[0], "stat": stats[1]}, "passed": passed}


def _check_train_bf16_card_vs_cpu() -> dict:
    """Step A (IMC on) and step B (PixPro + EMD) at b1, crop 64, views 32,
    batch 4 at bf16 on the card and on the CPU, and at f32 on the CPU (the
    yardstick), each step from the same weights (step A from a fresh bf16
    classifier kernel, step B from the f32 one training reaches it with),
    batches and EMD crop fractions, drop-connect off: loss terms over
    BF16_CHECK_BATCHES batches, every gradient of each step and the BN
    statistics of the first (``_bf16_readings``).  Step B does not start
    from each device's step A: Adam's first step moves ~10% of the entries
    the other way on the card than on the CPU at bf16, and step B's
    maxnormed maps amplify that."""
    import copy

    import torch

    from muscle_tpu_torch.losses import draw_crop_fractions
    from muscle_tpu_torch.models import classifier_as
    from muscle_tpu_torch.training import MCLConfig, make_adam, mcl_train_step, mcl_views_step

    cfg = MCLConfig(True, True, True)
    base = _train_model(CHECK_BACKBONE, seed=1)
    base.backbone.drop_connect_rate = 0.0
    hosts = [{k: v.cpu() for k, v in _live_labels(base, {k: torch.from_numpy(v) for k, v in
             _train_batch(CHECK_BATCH, CHECK_CROP, CHECK_VIEW, seed=s).items()}).items()}
             for s in range(1, 1 + BF16_CHECK_BATCHES)]
    frac = draw_crop_fractions(CHECK_BATCH, torch.Generator().manual_seed(1))
    runs = {}
    for name, dev, dtype in BF16_CHECK_RUNS:
        rec = {"losses": []}
        for i, host in enumerate(hosts):
            model = classifier_as(copy.deepcopy(base), torch.bfloat16).to(dev)
            opt = make_adam(model.trained_parameters(), TRAIN_LR, TRAIN_WD)
            batch = {k: v.to(dev) for k, v in host.items()}
            stats0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                      if k.endswith("running_mean") or k.endswith("running_var")}
            m = {k: float(v) for k, v in mcl_train_step(
                model, opt, batch, cfg, compute_dtype=getattr(torch, dtype)).items()}
            grads = {"step_a": _grads(model)}
            stats = {k: v.detach().cpu().float() for k, v in model.state_dict().items()
                     if k in stats0}
            model = copy.deepcopy(base).to(dev)
            opt = make_adam(model.trained_parameters(), TRAIN_LR, TRAIN_WD)
            m.update({k: float(v) for k, v in mcl_views_step(
                model, opt, batch, cfg, crop_frac=frac.to(dev),
                compute_dtype=getattr(torch, dtype)).items()})
            grads["step_b"] = _grads(model)
            rec["losses"].append(m)
            if i == 0:
                rec.update(grads={s: {k: g.float() for k, g in gs.items()}
                                  for s, gs in grads.items()}, stats=stats, stats0=stats0)
        runs[name] = rec
    readings = _bf16_readings(runs, ("step_a", "step_b"))
    out = {"train_mcl_bf16_card_vs_cpu": CHECK_BACKBONE, "batch": CHECK_BATCH,
           "crop": CHECK_CROP, "batches": BF16_CHECK_BATCHES,
           "card_losses": runs["card_bf16"]["losses"][0],
           "cpu_bf16_losses": runs["cpu_bf16"]["losses"][0],
           "cpu_f32_losses": runs["cpu_f32"]["losses"][0], **readings}
    print(json.dumps(out), flush=True)
    if not readings["passed"]:
        raise AssertionError(f"train_mcl bf16 card vs CPU failed: {out}")
    return out


def _timed_in_turns(models: dict, step, n_warm: int, n_timed: int) -> dict:
    """``step(name, it)`` for each model in turns (every name once per
    iteration), n_warm warm-up then n_timed timed iterations: per name the
    device ms of each step's segments (``step`` returns its CUDA events),
    the wall ms of an iteration (host clock to a synchronise) and the peak
    memory of its iterations."""
    import torch

    out = {name: {"events": [], "wall": [], "peak": 0} for name in models}
    for it in range(n_warm + n_timed):
        for name in models:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            events = step(name, it)
            torch.cuda.synchronize()
            if it >= n_warm:
                out[name]["events"].append(events)
                out[name]["wall"].append(time.perf_counter() - t0)
                out[name]["peak"] = max(out[name]["peak"], torch.cuda.max_memory_allocated())
    return out


def _turn_summary(rec: dict, batch: int, segments) -> dict:
    """ms per timed iteration of each segment (consecutive event pairs),
    images/s and peak GiB."""
    n = len(rec["wall"])
    wall = sum(rec["wall"]) / n
    out = {f"{s}_ms": sum(e[i].elapsed_time(e[i + 1]) for e in rec["events"]) / n
           for i, s in enumerate(segments)}
    out.update(iter_wall_ms=wall * 1e3, images_per_s=batch / wall,
               peak_memory_gib=rec["peak"] / 2 ** 30)
    return out


def phase_train_mcl_bf16(card: str) -> dict:
    """bf16 MCL training beside f32 in the same run, in turns, at the JAX
    benches' configurations: TrainBench (MuSCLe-b3 enc, batch 16, crop
    448, 4:2:0 upload, step A with IMC) and CurriculumBench (the same,
    then step B with PixPro and EMD on views of 224); the bf16 model from
    the f32 one's seeded weights with a fresh bf16 classifier kernel (the
    JAX package's bf16 init), which its first step promotes to f32.
    BF16_TRAIN_WARMUP warm-up and BF16_TRAIN_ITERS timed iterations per
    configuration and dtype: step ms, images/s and peak memory of each;
    the device time by kernel name and busy share of two bf16 curriculum
    iterations; no kernel launched; every loss term's gradient norm at
    bf16; and the b1 card-vs-CPU check at bf16."""
    import copy

    import torch

    from muscle_tpu_torch.inference.upload import to_device
    from muscle_tpu_torch.models import classifier_as
    from muscle_tpu_torch.training import (
        MCLConfig,
        make_adam,
        mcl_term_grad_norms,
        mcl_train_step,
        mcl_views_step,
    )

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    base = _train_model(TRAIN_BACKBONE, seed=0)
    models = {"f32": copy.deepcopy(base).to(dev),
              "bf16": classifier_as(copy.deepcopy(base), bf16).to(dev)}
    dtypes = {"f32": torch.float32, "bf16": bf16}
    opts = {k: make_adam(m.trained_parameters(), TRAIN_LR, TRAIN_WD) for k, m in models.items()}
    gens = {k: torch.Generator(device=dev).manual_seed(0) for k in models}
    hosts = []
    for seed in range(2):
        b = {k: torch.from_numpy(v).to(dev) for k, v in
             _train_batch(TRAIN_BATCH, TRAIN_CROP, TRAIN_VIEW, seed).items()}
        hosts.append({k: v.cpu().numpy() for k, v in _live_labels(models["f32"], b).items()})
    out = {"train_mcl_bf16": TRAIN_BACKBONE, "batch": TRAIN_BATCH, "crop": TRAIN_CROP,
           "view": TRAIN_VIEW, "card": card,
           "fc_dtype_at_start": str(models["bf16"].fc.weight.dtype)}
    metrics = {}

    def step(cfg):
        def run(name, it):
            m, o, g, dt = models[name], opts[name], gens[name], dtypes[name]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            batch = {k: to_device(v, dev) for k, v in hosts[it % 2].items()}
            ev[0].record()
            metrics[name] = mcl_train_step(m, o, batch, cfg, g, compute_dtype=dt)
            ev[1].record()
            if cfg.use_pixpro:
                metrics[name].update(mcl_views_step(m, o, batch, cfg, g, compute_dtype=dt))
            ev[2].record()
            return ev
        return run

    _zero_counts()
    for bench, cfg in (("train_bench", MCLConfig(use_imc=True)),
                       ("curriculum_bench", MCLConfig(True, True, True))):
        turns = _timed_in_turns(models, step(cfg), BF16_TRAIN_WARMUP, BF16_TRAIN_ITERS)
        rec = {}
        for name in models:
            rec[name] = _turn_summary(turns[name], TRAIN_BATCH, ("step_a", "step_b"))
            if not cfg.use_pixpro:
                rec[name].pop("step_b_ms")
            rec[name]["losses"] = {k: float(v) for k, v in metrics[name].items()}
            if not all(v == v and abs(v) < float("inf") for v in rec[name]["losses"].values()):
                raise AssertionError(f"train_mcl_bf16 {bench} {name}: losses not finite: {rec}")
        rec["bf16_over_f32_iter_ms"] = rec["bf16"]["iter_wall_ms"] / rec["f32"]["iter_wall_ms"]
        out[bench] = rec
    out["fc_dtype_after"] = str(models["bf16"].fc.weight.dtype)
    if out["fc_dtype_at_start"] != str(bf16) or out["fc_dtype_after"] != str(torch.float32):
        raise AssertionError(f"train_mcl_bf16: classifier kernel dtypes {out}")
    model, opt, gen = models["bf16"], opts["bf16"], gens["bf16"]
    del models["f32"], opts["f32"]
    torch.cuda.empty_cache()
    cfg = MCLConfig(True, True, True)
    _profile_steps("train_mcl_bf16 curriculum (step A + step B)", lambda it: (
        mcl_train_step(model, opt, {k: to_device(v, dev) for k, v in hosts[it].items()}, cfg,
                       gen, compute_dtype=bf16),
        mcl_views_step(model, opt, {k: to_device(v, dev) for k, v in hosts[it].items()}, cfg,
                       gen, compute_dtype=bf16)))
    out["launches"] = _launch_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"train_mcl_bf16 launched kernels: {out['launches']}")
    batch = {k: to_device(v, dev) for k, v in hosts[0].items()}
    norms = mcl_term_grad_norms(model, batch, gen, views_train_mode=True, compute_dtype=bf16)
    out["term_grad_norms_views_train"] = norms
    floor = LIVE_FLOOR * max(norms.values())
    print(json.dumps(out), flush=True)
    if sorted(norms) != ["emd", "er", "focal", "imc", "pair", "pixpro", "softmargin"] or \
            not all(n >= floor for n in norms.values()):
        raise AssertionError(f"train_mcl_bf16: a loss term's gradient norm is below {floor:.3g}: "
                             f"{norms}")
    del model, opt, batch
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = _check_train_bf16_card_vs_cpu()
    return out


def _check_seg_train_bf16_card_vs_cpu() -> dict:
    """One seg step at b1 dec (BiFPN 1 x 64, crop 64, batch 2, k 16, step
    3, drop-connect off) at bf16 on the card and on the CPU and at f32 on
    the CPU, from the same weights and batch, BF16_CHECK_BATCHES sets of
    BEACON draws: loss terms and the gradient norm over the draws, every
    clipped gradient and the BN statistics of the first (``_bf16_readings``)."""
    import copy

    import torch

    from muscle_tpu_torch.training import SegConfig, make_adam, seg_train_step

    cfg = SegConfig(k=SEG_CHECK_K, step=3)
    base = _seg_train_model(SEG_CHECK_BACKBONE, 1, 64, 0, seed=1, device="cpu")
    base.backbone.drop_connect_rate = 0.0
    host = {k: torch.from_numpy(v) for k, v in
            _seg_train_batch(base, SEG_CHECK_BATCH, SEG_CHECK_CROP, seed=1,
                             calibrate=True).items()}
    gen = torch.Generator().manual_seed(1)
    draws = [torch.rand((SEG_CHECK_BATCH, 20, SEG_CHECK_CROP, SEG_CHECK_CROP), generator=gen)
             for _ in range(BF16_CHECK_BATCHES)]
    runs = {}
    for name, dev, dtype in BF16_CHECK_RUNS:
        rec = {"losses": []}
        for i, d in enumerate(draws):
            model = copy.deepcopy(base).to(dev)
            opt = make_adam(model.trained_parameters(), SEG_TRAIN_LR, SEG_TRAIN_WD)
            stats0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                      if k.endswith("running_mean") or k.endswith("running_var")}
            rec["losses"].append({k: float(v) for k, v in seg_train_step(
                model, opt, {k: v.to(dev) for k, v in host.items()}, cfg, draws=d.to(dev),
                compute_dtype=getattr(torch, dtype)).items()})
            if i == 0:
                rec.update(grads={"step": {k: g.float() for k, g in _grads(model).items()}},
                           stats={k: v.detach().cpu().float() for k, v in
                                  model.state_dict().items() if k in stats0}, stats0=stats0)
        runs[name] = rec
    readings = _bf16_readings(runs, ("step",))
    out = {"train_seg_bf16_card_vs_cpu": SEG_CHECK_BACKBONE, "batch": SEG_CHECK_BATCH,
           "crop": SEG_CHECK_CROP, "k": cfg.k, "draws": BF16_CHECK_BATCHES,
           "card_losses": runs["card_bf16"]["losses"],
           "cpu_bf16_losses": runs["cpu_bf16"]["losses"],
           "cpu_f32_losses": runs["cpu_f32"]["losses"], **readings}
    print(json.dumps(out), flush=True)
    if not (readings["passed"] and any(m["loss_beacon"] for m in runs["cpu_f32"]["losses"])):
        raise AssertionError(f"train_seg bf16 card vs CPU failed: {out}")
    return out


def _eval_labels(engine, imgs, names):
    import numpy as np

    return [np.argmax(r["probs"], axis=-1) for r in engine.run_batch(imgs, names)]


def phase_train_seg_bf16(card: str) -> dict:
    """bf16 segmentation training beside f32 in the same run, in turns, at
    the train_muscle defaults (MuSCLe-b7 dec, BiFPN 3 x 256, batch 6, crop
    448, k 128, step 7, 4:2:0 and packed-mask upload, the head calibrated,
    fuse_mbconv=384): BF16_TRAIN_WARMUP warm-up and BF16_TRAIN_ITERS timed
    steps per dtype (ms, images/s, peak memory; BEACON nonzero on every
    timed bf16 step); the device time by kernel name and busy share of two
    bf16 steps; no kernel launched in the steps; the epoch-end eval at
    bf16 (one scale-1 SegTTAEngine batch of 4 images, counts zeroed just
    before it): 48 launches of the MBConv kernel's bf16 instantiation, its
    labels held to the plain bf16 blocks' by the bf16 phase's rule; both
    terms' gradient norms at bf16; and the b1 card-vs-CPU check at bf16."""
    import numpy as np
    import torch

    from muscle_tpu_torch.inference import SegTTAEngine
    from muscle_tpu_torch.inference.upload import to_device
    from muscle_tpu_torch.training import SegConfig, make_adam, seg_term_grad_norms, seg_train_step

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    f32_model = _seg_train_model(SEG_TRAIN_BACKBONE, 3, 256, 384, seed=0, device=dev)
    hosts = [_seg_train_batch(f32_model, SEG_TRAIN_BATCH, SEG_TRAIN_CROP, seed,
                              calibrate=seed == 0) for seed in range(2)]
    bf16_model = _seg_train_model(SEG_TRAIN_BACKBONE, 3, 256, 384, seed=0, device=dev)
    bf16_model.load_state_dict(f32_model.state_dict())  # the calibrated head too
    models = {"f32": f32_model, "bf16": bf16_model}
    dtypes = {"f32": torch.float32, "bf16": bf16}
    opts = {k: make_adam(m.trained_parameters(), SEG_TRAIN_LR, SEG_TRAIN_WD)
            for k, m in models.items()}
    gens = {k: torch.Generator(device=dev).manual_seed(0) for k in models}
    cfg = SegConfig(k=SEG_TRAIN_K, step=SEG_TRAIN_STEP)
    metrics = {k: [] for k in models}

    def run(name, it):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        batch = {k: to_device(v, dev) for k, v in hosts[it % 2].items()}
        ev[0].record()
        metrics[name].append(seg_train_step(models[name], opts[name], batch, cfg, gens[name],
                                            compute_dtype=dtypes[name]))
        ev[1].record()
        return ev

    _zero_counts()
    turns = _timed_in_turns(models, run, BF16_TRAIN_WARMUP, BF16_TRAIN_ITERS)
    out = {"train_seg_bf16": SEG_TRAIN_BACKBONE, "bifpn": "3 x 256", "batch": SEG_TRAIN_BATCH,
           "crop": SEG_TRAIN_CROP, "k": cfg.k, "step": cfg.step, "card": card}
    for name in models:
        out[name] = _turn_summary(turns[name], SEG_TRAIN_BATCH, ("step",))
        out[name]["losses"] = {k: float(v) for k, v in metrics[name][-1].items()}
    out["bf16_over_f32_step_ms"] = out["bf16"]["step_ms"] / out["f32"]["step_ms"]
    beacon = [float(m["loss_beacon"]) for m in metrics["bf16"][BF16_TRAIN_WARMUP:]]
    out["bf16_loss_beacon_timed"] = beacon
    del models["f32"], opts["f32"], f32_model
    torch.cuda.empty_cache()
    model, opt, gen = bf16_model, opts["bf16"], gens["bf16"]
    _profile_steps("train_seg_bf16 (2 steps)", lambda it: seg_train_step(
        model, opt, {k: to_device(v, dev) for k, v in hosts[it].items()}, cfg, gen,
        compute_dtype=bf16))
    out["step_launches"] = _launch_counts()

    # the epoch-end eval at bf16: the fused blocks, counts zeroed just before
    imgs, names = _seg_batches(1, seed=3)[0]
    _zero_counts()
    got = _eval_labels(SegTTAEngine(model, scales=(1.0,), device=dev, compute_dtype=bf16),
                       imgs, names)
    out["launches"] = _launch_counts()
    plain = _seg_train_model(SEG_TRAIN_BACKBONE, 3, 256, 0, seed=0, device=dev)
    plain.load_state_dict(model.state_dict())
    want = _eval_labels(SegTTAEngine(plain, scales=(1.0,), device=dev, compute_dtype=bf16),
                        imgs, names)
    f32_probs = [r["probs"] for r in SegTTAEngine(plain, scales=(1.0,), device=dev)
                 .run_batch(imgs, names)]
    agree, own = [], []
    for g, w, p in zip(got, want, f32_probs):
        top2 = np.sort(p, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > BF16_MARGIN
        agree.append(float((g == w)[clear].mean()))
        own.append(float((w == np.argmax(p, axis=-1))[clear].mean()))
    floors = [1 - max(1 - BF16_LABEL_AGREE, BF16_SGC_REL * (1 - o)) for o in own]
    out.update(eval_images=len(imgs), eval_launches_bf16=out["launches"]["mbconv_bf16"],
               eval_kernel_vs_plain_labels_agreement=agree,
               eval_plain_bf16_vs_f32_labels_agreement=own)
    del plain
    model.train()
    batch = {k: to_device(v, dev) for k, v in hosts[0].items()}
    norms, values = seg_term_grad_norms(model, batch, cfg, gen, return_values=True,
                                        compute_dtype=bf16)
    out.update(term_grad_norms=norms, term_values=values)
    print(json.dumps(out), flush=True)
    if any(out["step_launches"].values()):
        raise AssertionError(f"train_seg_bf16 launched a kernel in its steps: {out}")
    if out["launches"]["mbconv_bf16"] != SEG_EVAL_LAUNCHES or out["launches"]["mbconv_stride1"] \
            or not all(a >= fl for a, fl in zip(agree, floors)):
        raise AssertionError(f"train_seg_bf16 eval: want {SEG_EVAL_LAUNCHES} bf16 MBConv "
                             f"launches and labels within the bf16 rule: {out}")
    if not all(v != 0 and v == v for v in beacon):
        raise AssertionError(f"train_seg_bf16: BEACON not engaged on every timed step: {out}")
    if sorted(norms) != ["beacon", "seg"] or not all(
            v >= LIVE_FLOOR * max(norms.values()) and v > 0 for v in norms.values()):
        raise AssertionError(f"train_seg_bf16: a loss term's gradient norm is dead: {norms}")
    del model, opt, batch
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = _check_seg_train_bf16_card_vs_cpu()
    return out


# ---- data parallelism (dp phase) -----------------------------------------------------------


def _dp_arch(kind: str):
    """The model of a dp case, freshly built on the CPU: 'b1_enc', 'b1_dec'
    (BiFPN 1 x 64), 'irn', 'b3_enc' and 'b7_dec' (BiFPN 3 x 256) as the
    trainers build them, 'b3_cam' and 'b7_seg' with the fused blocks as the
    engines run them."""
    from muscle_tpu_torch.models import IRNNet, MuSCLe

    if kind == "irn":
        return IRNNet()
    name, mode, layers, ch, fuse = {
        "b1_enc": (CHECK_BACKBONE, "enc", 3, 256, 0),
        "b1_dec": (SEG_CHECK_BACKBONE, "dec", 1, 64, 0),
        "b3_enc": (TRAIN_BACKBONE, "enc", 3, 256, 0),
        "b7_dec": (SEG_TRAIN_BACKBONE, "dec", 3, 256, 0),
        "b3_cam": ("efficientnet-b3", "enc", 3, 256, 384),
        "b7_seg": ("efficientnet-b7", "dec", 3, 256, 384)}[kind]
    return MuSCLe(backbone_name=name, mode=mode, bifpn_layers=layers, bifpn_channels=ch,
                  last_pooling=mode == "dec", fuse_mbconv=fuse)


def _dp_model(kind: str, state: dict):
    """``_dp_arch(kind)`` loaded from ``state`` (every rank builds the same)."""
    m = _dp_arch(kind)
    m.load_state_dict(state)
    return m


def _dp_rows(batch: dict, group) -> dict:
    """This rank's rows of a global host batch (all of it for one process)."""
    import torch

    from muscle_tpu_torch import parallel

    return {k: torch.as_tensor(v[parallel.rank_rows(len(v), group)]) for k, v in batch.items()}


def _dp_step(case: dict, group, dev, timed: int = 0) -> dict:
    """One step of ``case`` (step 'a' or 'b' of MCL, 'seg', 'irn'; 'dtype')
    from its weights on this rank's rows of its global batch, its
    generator seeded alike on every rank, then ``timed`` more steps on the
    same batch, each timed (CUDA events), and the gradient all-reduce
    alone on the step's gradients.  Returns the first step's metrics,
    gradients, BN statistics and parameters after the update (on the CPU),
    the timings and the peak memory."""
    import torch

    from muscle_tpu_torch import parallel
    from muscle_tpu_torch.inference.upload import to_device
    from muscle_tpu_torch.models import classifier_as
    from muscle_tpu_torch.training import (
        IRNTrainConfig,
        MCLConfig,
        SegConfig,
        irn_train_step,
        make_adam,
        make_irn_sgd,
        mcl_train_step,
        mcl_views_step,
        seg_train_step,
    )

    dtype = getattr(torch, case["dtype"])
    model = _dp_model(case["model"], case["state"])
    if case["step"] == "a" and dtype == torch.bfloat16:
        classifier_as(model, dtype)  # the bf16 init's classifier kernel
    model = parallel.replicate(model.to(dev), group)
    batch = {k: to_device(v, dev) for k, v in _dp_rows(case["batch"], group).items()}
    gen = torch.Generator(device=dev).manual_seed(case["seed"])
    if case["step"] == "irn":
        opt = make_irn_sgd(model, case["lr"], case["wd"])
        step = lambda: irn_train_step(model, opt, batch, IRNTrainConfig(  # noqa: E731
            crop_size=case["crop"]), group)
    else:
        opt = make_adam(model.trained_parameters(), case["lr"], case["wd"])
        kw = dict(compute_dtype=dtype, group=group)
        step = {"a": lambda: mcl_train_step(model, opt, batch, MCLConfig(use_imc=True), gen,
                                            **kw),
                "b": lambda: mcl_views_step(model, opt, batch, MCLConfig(True, True, True), gen,
                                            **kw),
                "seg": lambda: seg_train_step(model, opt, batch, SegConfig(k=case.get("k", 16)),
                                              gen, **kw)}[case["step"]]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = {k: float(v) for k, v in step().items()}
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in opt.param_groups for p in g["params"]]
    out = {"metrics": metrics,
           "grads": {names[id(p)]: p.grad.detach().float().cpu() for p in params},
           "params": {names[id(p)]: p.detach().float().cpu() for p in params},
           "stats": {k: v.detach().float().cpu() for k, v in model.state_dict().items()
                     if k.endswith("running_mean") or k.endswith("running_var")}}
    flat = torch.cat([p.detach().float().reshape(-1) for p in params])
    ref = flat.clone()
    if group is not None:  # every rank holds rank 0's parameters, bit for bit
        torch.distributed.broadcast(ref, torch.distributed.get_global_rank(group, 0),
                                    group=group)
    out["rank_param_diff"] = float((flat - ref).abs().max())
    if timed:
        ms = []
        for _ in range(timed):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            step()
            ev[1].record()
            torch.cuda.synchronize(dev)
            ms.append(ev[0].elapsed_time(ev[1]))
        grads = [p.grad for p in params]
        ar = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            parallel.all_reduce_flat(grads, group)
            ev[1].record()
            torch.cuda.synchronize(dev)
            ar.append(ev[0].elapsed_time(ev[1]))
        out.update(step_ms=ms, allreduce_ms=ar,
                   allreduce_bytes=sum(g.numel() * g.element_size() for g in grads),
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    del model, opt, batch
    torch.cuda.empty_cache()
    return out


def _dp_parity_runs(case: dict, group, dev, every: bool = True) -> dict:
    """``_dp_step`` of a parity case from the same weights on each of its
    batches (only the first for an f32 case unless ``every``: the f32
    rule reads one batch, the bf16 rule the loss terms over all, against
    the one-process f32 step's): the first batch's tensors and every
    batch's metrics."""
    batches = case["batches"] if every or case["dtype"] != "float32" else case["batches"][:1]
    runs = [_dp_step(dict(case, batch=b), group, dev) for b in batches]
    return dict(runs[0], metrics_per_batch=[r["metrics"] for r in runs])


def _dp_serve(spec: dict, group, dev, mesh=None) -> dict:
    """CamTTAEngine (b3, fused, scales 0.5-2, --fast 0) and SegTTAEngine
    (b7, fused, six scales x flip, --fast 0): without ``mesh`` this rank's
    engines on its rows of every batch (one engine per rank, as the CLIs'
    default), with it the engines' ``mesh=`` given every global batch (the
    engine splits it and returns every rank the whole batch's records);
    every kernel's launches in each (counts zeroed just before it), the
    records and the wall seconds."""
    import torch

    from muscle_tpu_torch import parallel
    from muscle_tpu_torch.inference import CamTTAEngine, SegTTAEngine

    def rows(batches):
        if mesh is not None:
            return batches
        out = []
        for b in batches:
            sl = parallel.rank_rows(len(b[0]), group)
            out.append(tuple(part[sl] for part in b))
        return out

    out = {}
    engines = {
        "cam": (CamTTAEngine(_dp_model("b3_cam", spec["cam_state"]), scales=(0.5, 1.0, 1.5, 2.0),
                             return_cam=False, device=dev, mesh=mesh), spec["cam_batches"]),
        "seg": (SegTTAEngine(_dp_model("b7_seg", spec["seg_state"]), scales=SEG_SCALES,
                             device=dev, mesh=mesh), spec["seg_batches"]),
    }
    for name, (engine, batches) in engines.items():
        mine = rows(batches)
        list(engine.run_stream(iter(mine[:1])))  # warm-up (cuDNN, allocator)
        _zero_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        recs = [r for rs in engine.run_stream(iter(mine)) for r in rs]
        torch.cuda.synchronize(dev)
        out[name] = {"records": recs, "seconds": time.perf_counter() - t0,
                     "counts": _launch_counts(), "images": sum(len(b[0]) for b in mine)}
    return out


def _dp_walk(spec: dict, group, dev) -> dict:
    """``propagate_to_edge_sharded`` of the grid-128 image over the ranks
    (each building its V / W columns of T), timed by CUDA events."""
    import torch

    from muscle_tpu_torch.ops.random_walk import propagate_to_edge_sharded

    cam, edge = (torch.as_tensor(spec["walk"][k]).to(dev) for k in ("cam", "edge"))
    torch.cuda.reset_peak_memory_stats(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    rw = propagate_to_edge_sharded(cam, edge, group)
    ev[1].record()
    torch.cuda.synchronize(dev)
    return {"walk": rw.cpu(), "ms": ev[0].elapsed_time(ev[1]),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}


def _dp_collective_us(group, dev) -> dict:
    """Mean µs of one all-reduce and one all-gather of a batch norm's
    statistics (1 + 2 x 384 floats, a wide b3 layer) on the device: what
    each train-mode BN pays twice a step."""
    import torch

    from muscle_tpu_torch import parallel

    x = torch.ones(1 + 2 * 384, device=dev)
    out = {}
    for name, op in (("all_reduce", lambda: parallel.all_reduce_sum(x, group)),
                     ("all_gather", lambda: parallel.all_gather(x[None], group))):
        op()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(50):
            op()
        torch.cuda.synchronize(dev)
        out[name] = (time.perf_counter() - t0) / 50 * 1e6
    return out


def _dp_rank(rank: int, world: int, backend: str, tmp: str) -> None:
    """One rank of the dp phase: joins the group (gloo: every rank on card
    0; nccl: rank r on card r), runs every parity case, the full-width
    steps, the engines and the sharded walk, and saves what it measured
    (rank 0 the tensors, the others their agreement with rank 0)."""
    import os

    import numpy as np
    import torch

    from muscle_tpu_torch import parallel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0 if backend == "gloo" else rank)
    group = parallel.init(rank, world, f"file://{tmp}/store_{backend}", dev, backend)
    spec = torch.load(os.path.join(tmp, "spec.pt"), weights_only=False)
    marks = [time.perf_counter()]
    out = {"parity": {name: _dp_parity_runs(case, group, dev, every=False)
                      for name, case in spec["parity"].items()}, "full": {}}
    marks.append(time.perf_counter())
    for name, case in spec["full"].items():
        out["full"][name] = _dp_step(dict(case, batch=case["batches"][world]), group, dev,
                                     timed=DP_ITERS)
    marks.append(time.perf_counter())
    out["serve"] = _dp_serve(spec, group, dev)
    marks.append(time.perf_counter())
    out["serve_mesh"] = _dp_serve(spec, group, dev, parallel.make_mesh())
    marks.append(time.perf_counter())
    out["walk"] = _dp_walk(spec, group, dev)
    marks.append(time.perf_counter())
    out["collective_us"] = _dp_collective_us(group, dev)
    out["seconds"] = dict(zip(("parity", "full", "serve", "serve_mesh", "walk"),
                              np.diff(marks).tolist()))
    if rank:
        for res in list(out["parity"].values()) + list(out["full"].values()):
            for k in ("grads", "params", "stats"):
                res.pop(k)
    torch.save(out, os.path.join(tmp, f"{backend}_rank{rank}.pt"))
    parallel.barrier(group)
    parallel.shutdown(group)


def _dp_spec(worlds) -> dict:
    """Weights, batches and inputs of every dp case, made in this process
    (the seg heads calibrated on the card) and handed to the ranks; the
    full-width seg batch for each world size (DP_SEG_PER_RANK a rank)."""
    import numpy as np
    import torch

    from muscle_tpu_torch.models import init_weights

    def cpu(m):
        return {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}

    def host(batch):
        return {k: v.cpu().numpy() for k, v in batch.items()}

    dev = torch.device("cuda")
    spec = {"parity": {}, "full": {}}
    seeds = range(1, 1 + BF16_CHECK_BATCHES)
    b1 = _train_model(CHECK_BACKBONE, seed=1).to(dev)
    mcl = [host(_live_labels(b1, {k: torch.from_numpy(v).to(dev) for k, v in _train_batch(
        DP_CHECK_BATCH, CHECK_CROP, CHECK_VIEW, seed=s).items()})) for s in seeds]
    dec = _seg_train_model(SEG_CHECK_BACKBONE, 1, 64, 0, seed=1, device=dev)
    seg = [_seg_train_batch(dec, DP_CHECK_BATCH, SEG_CHECK_CROP, seed=s, calibrate=s == 1)
           for s in seeds]
    irn = init_weights(_dp_arch("irn"), torch.Generator().manual_seed(0))
    cases = {"a": dict(model="b1_enc", state=cpu(b1), batches=mcl, lr=TRAIN_LR, wd=TRAIN_WD),
             "seg": dict(model="b1_dec", state=cpu(dec), batches=seg, lr=SEG_TRAIN_LR,
                         wd=SEG_TRAIN_WD, k=SEG_CHECK_K),
             "irn": dict(model="irn", state=cpu(irn),
                         batches=[_irn_train_batch(DP_CHECK_BATCH, IRN_CHECK_CROP, seed=1)],
                         crop=IRN_CHECK_CROP, lr=IRN_TRAIN_LR, wd=IRN_TRAIN_WD)}
    cases["b"] = cases["a"]
    for dtype in ("float32", "bfloat16"):
        for step in ("a", "b", "seg", "irn"):
            if step != "irn" or dtype == "float32":  # IRN trains in f32 only
                spec["parity"][f"{step}_{dtype}"] = dict(cases[step], step=step, dtype=dtype,
                                                         seed=3)
    del b1, dec
    b3 = _train_model(TRAIN_BACKBONE, seed=0).to(dev)
    batch = host(_live_labels(b3, {k: torch.from_numpy(v).to(dev) for k, v in _train_batch(
        DP_MCL_BATCH, TRAIN_CROP, TRAIN_VIEW, seed=2).items()}))
    spec["full"]["mcl_b3"] = dict(model="b3_enc", state=cpu(b3), step="a", dtype="float32",
                                  seed=4, lr=TRAIN_LR, wd=TRAIN_WD,
                                  batches={w: batch for w in worlds})
    del b3
    b7 = _seg_train_model(SEG_TRAIN_BACKBONE, 3, 256, 0, seed=0, device=dev)
    batch = _seg_train_batch(b7, DP_SEG_PER_RANK * max(worlds), SEG_TRAIN_CROP, seed=2,
                             calibrate=True)
    spec["full"]["seg_b7"] = dict(model="b7_dec", state=cpu(b7), step="seg", dtype="float32",
                                  seed=5, lr=SEG_TRAIN_LR, wd=SEG_TRAIN_WD, k=SEG_TRAIN_K,
                                  batches={w: {k: v[:DP_SEG_PER_RANK * w] for k, v in
                                               batch.items()} for w in worlds})
    del b7
    spec["cam_state"] = cpu(init_weights(_dp_arch("b3_cam"), torch.Generator().manual_seed(0)))
    spec["cam_batches"] = _images(DP_CAM_BATCHES, seed=2)
    spec["seg_state"] = cpu(_seg_model(384))
    spec["seg_batches"] = _seg_batches(DP_SEG_BATCHES, seed=3)
    g = DP_WALK_GRID
    spec["walk"] = {"cam": np.random.default_rng(6).uniform(0, 1, (WALK_C, g, g)).astype(
                        np.float32),
                    "edge": _smooth_edges(1, g, g, torch.Generator(device=dev).manual_seed(6),
                                          dev)[0].cpu().numpy()}
    torch.cuda.empty_cache()
    return spec


def _dp_one_process(spec: dict, worlds) -> dict:
    """Every dp case in this process on card 0 without a group: the
    references (the full-width steps on each world size's global batch,
    timed as the ranks time theirs, and the engines' images/s)."""
    import torch

    from muscle_tpu_torch.ops.random_walk import propagate_to_edge

    dev = torch.device("cuda")
    ref = {"parity": {n: _dp_parity_runs(c, None, dev) for n, c in spec["parity"].items()},
           "full": {(n, w): _dp_step(dict(c, batch=c["batches"][w]), None, dev, timed=DP_ITERS)
                    for n, c in spec["full"].items() for w in worlds}}
    ref["serve"] = _dp_serve(spec, None, dev)
    walk = spec["walk"]
    ref["walk"], ref["walk64"] = (
        propagate_to_edge(torch.as_tensor(walk["cam"]).to(dev, dt),
                          torch.as_tensor(walk["edge"]).to(dev, dt), method="vector").cpu()
        for dt in (torch.float32, torch.float64))
    torch.cuda.empty_cache()
    return ref


def _dp_parity(name: str, spec: dict, ref: dict, got: dict) -> dict:
    """A W-rank b1 step against the one-process step on the card, each from
    the same weights on the same batches.  f32: the card-vs-CPU rule (loss
    terms 1e-4 relative; gradients within GRAD_TOLS-style limits; BN
    statistics 1e-4 of each tensor's largest; the parameters after the
    update within 1e-4 of each tensor's largest but for Adam's sign flips
    where a gradient is rounding noise, at most 0.1% of the entries, each
    within 2 lr), on the first batch.  bf16: the train_*_bf16 rule against
    the one-process step's own bf16-vs-f32 distance (``_bf16_excess``;
    the loss terms as means over the BF16_CHECK_BATCHES batches)."""
    import numpy as np

    step, dtype = name.rsplit("_", 1)
    one, case = ref["parity"][name], spec["parity"][name]
    if dtype == "float32":
        tol, zero = {"a": GRAD_TOLS["step_a"], "b": GRAD_TOLS["step_b"], "seg": SEG_GRAD_TOLS,
                     "irn": IRN_GRAD_TOLS}[step]
        loss = max(abs(got["metrics"][k] - v) / (TRAIN_RTOL * abs(v) + TRAIN_ATOL)
                   for k, v in one["metrics"].items())
        grad = _grad_err(got["grads"], one["grads"], tol, zero)
        stats = max([float((got["stats"][k] - v).abs().max())
                     / max(1e-4 * float(v.abs().max()), 1e-12)
                     for k, v in one["stats"].items()] or [0.0])
        off = total = 0
        worst_off = 0.0
        for k, v in one["params"].items():
            err = (got["params"][k] - v).abs()
            far = err > 1e-4 * float(v.abs().max())
            off, total = off + int(far.sum()), total + v.numel()
            worst_off = max(worst_off, float(err[far].max()) if bool(far.any()) else 0.0)
        passed = (loss <= 1.0 and grad[0] <= 1.0 and stats <= 1.0 and off <= 1e-3 * total
                  and worst_off <= 2 * case["lr"] * 1.01)
        return {"loss_err_over_tol": loss, "grad_err_over_tol": grad[0], "grad_param": grad[1],
                "bn_stat_err_over_tol": stats, "param_off_share": off / total,
                "param_off_max": worst_off, "passed": passed}
    f32 = ref["parity"][f"{step}_float32"]
    losses = {}
    for k in one["metrics"]:  # _bf16_readings' rule: means over the batches
        d, a, r = (np.asarray([m[k] for m in run["metrics_per_batch"]])
                   for run in (got, one, f32))
        floor = BF16_TRAIN_ULPS * 2.0 ** -8 * float(np.abs(a).max())
        losses[k] = float(np.abs(d - a).mean() / (BF16_TRAIN_MEAN * np.abs(a - r).mean() + floor))
    loss = max(losses.values())
    zero = BF16_TRAIN_ZERO * max(float(g.abs().max()) for g in one["grads"].values())
    grad = max((_bf16_excess(got["grads"][k], g, f32["grads"][k], zero), k)
               for k, g in one["grads"].items())
    s0 = {k: v.float() for k, v in case["state"].items()}
    stats = max([_bf16_excess(got["stats"][k] - s0[k], v - s0[k], f32["stats"][k] - s0[k])
                 for k, v in one["stats"].items()] or [0.0])
    return {"loss_err_over_limit": losses, "grad_err_over_limit": grad[0],
            "grad_param": grad[1], "bn_stat_err_over_limit": stats,
            "passed": loss <= 1.0 and grad[0] <= 1.0 and stats <= 1.0}


def _records_equal(got: list, want: list) -> bool:
    """Two engines' record lists equal bit for bit (CAM: names, scores and
    SGC maps; seg: names and probabilities)."""
    import numpy as np

    if [r["name"] for r in got] != [r["name"] for r in want]:
        return False
    for g, w in zip(got, want):
        for key in ("score", "probs", "label"):
            if key in w and not np.array_equal(g[key], w[key]):
                return False
        if "sgc" in w and (sorted(g["sgc"]) != sorted(w["sgc"]) or not all(
                np.array_equal(g["sgc"][c], w["sgc"][c]) for c in w["sgc"])):
            return False
    return True


def _dp_readings(spec: dict, ref: dict, outs: list, world: int, backend: str) -> dict:
    """Every check of one W-rank run against the one-process references,
    and what the ranks measured."""
    import numpy as np

    got = outs[0]
    rec = {"backend": backend, "ranks": world,
           "cards": 1 if backend == "gloo" else world,
           "scaling": ("none: the ranks share card 0, whose work both do" if backend == "gloo"
                       else "one card a rank"),
           "parity": {}, "full": {}, "serve": {}}
    agree = True
    for name in spec["parity"]:
        rec["parity"][name] = _dp_parity(name, spec, ref, got["parity"][name])
        agree &= all(o["parity"][name]["rank_param_diff"] == 0.0 for o in outs)
    for name in spec["full"]:
        one_run = ref["full"][(name, world)]
        one = one_run["metrics"]
        # the loss within DP_LOSS_RTOL, each term within DP_LOSS_RTOL of the loss (BEACON
        # is a near-cancelling sum whose boundary samples rounding can move)
        scale = DP_LOSS_RTOL * abs(one["loss"])
        loss = max(abs(got["full"][name]["metrics"][k] - v) / scale
                   for k, v in one.items() if k != "grad_norm")
        agree &= all(o["full"][name]["rank_param_diff"] == 0.0 for o in outs)
        rec["full"][name] = {
            "global_batch": len(next(iter(spec["full"][name]["batches"][world].values()))),
            "loss": got["full"][name]["metrics"], "one_process_loss": one,
            "loss_err_over_tol": loss,
            "step_ms_per_rank": [o["full"][name]["step_ms"] for o in outs],
            "allreduce_ms_per_rank": [o["full"][name]["allreduce_ms"] for o in outs],
            "allreduce_bytes": got["full"][name]["allreduce_bytes"],
            "peak_gib_per_rank": [o["full"][name]["peak_gib"] for o in outs],
            "one_process_step_ms": one_run["step_ms"],
            "one_process_peak_gib": one_run["peak_gib"],
            # the global batch's step: the slowest rank against one process on card 0
            "speedup": (float(np.mean(one_run["step_ms"]))
                        / max(float(np.mean(o["full"][name]["step_ms"])) for o in outs)),
            "passed": loss <= 1.0}
    rec["serve_mesh"] = {}
    for serve, name in [(s, n) for s in ("serve", "serve_mesh") for n in ("cam", "seg")]:
        want = ref["serve"][name]["records"]
        if serve == "serve":  # each rank returned its rows
            by_name = {r["name"]: r for o in outs for r in o[serve][name]["records"]}
            assert sorted(by_name) == sorted(r["name"] for r in want), name
            mine = [by_name[r["name"]] for r in want]
            identical = True
        else:  # every rank returned the whole batch's records, the same bit for bit
            recs = [o[serve][name]["records"] for o in outs]
            mine = recs[0]
            identical = all(_records_equal(r, mine) for r in recs[1:])
            assert [r["name"] for r in mine] == [r["name"] for r in want], name
        counts = [o[serve][name]["counts"] for o in outs]
        launches = [cnt["mbconv_stride1"] for cnt in counts]
        # per forward, whatever a rank's share of the batch
        expect = ref["serve"][name]["counts"]["mbconv_stride1"]
        entry = {"images_per_rank": [o[serve][name]["images"] for o in outs],
                 "images_per_s_per_rank": [o[serve][name]["images"] / o[serve][name]["seconds"]
                                           for o in outs],
                 "launches_per_rank": launches, "one_process_launches": expect,
                 "counts_per_rank": counts,
                 # the node: every image over the slowest rank's seconds
                 "node_images_per_s": len(want) / max(o[serve][name]["seconds"] for o in outs),
                 "one_process_images_per_s": len(want) / ref["serve"][name]["seconds"]}
        if name == "cam":
            entry["score_err"], entry["sgc_err"] = _compare(
                mine, want, f"dp {backend} x {world} CAM ({serve}) vs one process")
            ok = True
        else:
            err = max(float(np.abs(g["probs"] - w["probs"]).max()) for g, w in zip(mine, want))
            entry["probs_err"] = err
            ok = err <= SEG_PROBS_TOL
        entry["ranks_bit_identical"] = identical
        entry["passed"] = ok and identical and expect > 0 and all(n == expect for n in launches)
        rec[serve][name] = entry
    exact = ref["walk64"]
    scale = float(exact.abs().max())
    walk_err = max(float((o["walk"]["walk"] - ref["walk"]).abs().max()) for o in outs)
    off64 = max(float((o["walk"]["walk"].double() - exact).abs().max()) for o in outs)
    dense64 = float((ref["walk"].double() - exact).abs().max())
    rec["walk"] = {"grid": DP_WALK_GRID, "classes": WALK_C, "steps": 64,
                   "err_vs_dense_over_scale": walk_err / scale,
                   "err_vs_f64_over_scale": off64 / scale,
                   "dense_err_vs_f64_over_scale": dense64 / scale,
                   "ms_per_rank": [o["walk"]["ms"] for o in outs],
                   "peak_gib_per_rank": [o["walk"]["peak_gib"] for o in outs],
                   "passed": off64 <= max(DP_WALK_RTOL * scale, 2.0 * dense64)}
    rec["ranks_bit_identical"] = agree
    rec["collective_us_per_rank"] = [o["collective_us"] for o in outs]
    rec["rank_seconds"] = [o["seconds"] for o in outs]
    parts = (list(rec["parity"].values()) + list(rec["full"].values())
             + list(rec["serve"].values()) + list(rec["serve_mesh"].values()) + [rec["walk"]])
    rec["passed"] = agree and all(p["passed"] for p in parts)
    return rec


def phase_dp(card: str) -> dict:
    """Data parallelism (module docstring, phase dp): the one-process
    references on card 0, then DP_SHARED_RANKS ranks sharing card 0 over
    gloo and, where there are several cards, one rank a card over NCCL
    (spawned processes, a FileStore rendezvous in a temporary directory);
    one {"dp": ...} line; any failed check fails the phase."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    n = torch.cuda.device_count()
    configs = [("gloo", DP_SHARED_RANKS)]
    if n >= 2:
        configs.append(("nccl", min(n, DP_MAX_RANKS)))
    worlds = sorted({w for _, w in configs})
    out = {"card": card, "ran": [f"{b} x {w}" for b, w in configs]}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spec = _dp_spec(worlds)
        torch.save(spec, f"{tmp}/spec.pt")
        ref = _dp_one_process(spec, worlds)
        out["one_process_seconds"] = time.perf_counter() - t0
        for backend, world in configs:
            t0 = time.perf_counter()
            mp.spawn(_dp_rank, args=(world, backend, tmp), nprocs=world, join=True)
            outs = [torch.load(f"{tmp}/{backend}_rank{r}.pt", weights_only=False)
                    for r in range(world)]
            rec = _dp_readings(spec, ref, outs, world, backend)
            rec["seconds"] = time.perf_counter() - t0
            out[f"{backend}_{world}"] = rec
    print(json.dumps({"dp": out}), flush=True)
    failed = [f"{b}_{w}" for b, w in configs if not out[f"{b}_{w}"]["passed"]]
    if failed:
        raise AssertionError(f"dp: {failed} failed")
    return out


def _spatial_engines(spec: dict, dev, mesh=None) -> dict:
    """The CAM (infer_mcl's defaults) and seg (infer_seg's without the CRF,
    probabilities) engines of the spatial phase, in f32 and in bf16 (on the
    same models), and the f32 seg engine at lowres=False,
    window_exact=False ('segoff'), each data row of ``mesh`` running its share of every
    batch split over its model group where given."""
    import torch

    from muscle_tpu_torch.inference import CamTTAEngine, SegTTAEngine

    cam, seg = _dp_model("b3_cam", spec["cam_state"]), _dp_model("b7_seg", spec["seg_state"])
    out = {}
    for tag, dtype in (("", torch.float32), ("_bf16", torch.bfloat16)):
        kw = dict(device=dev, mesh=mesh, shard_spatial=mesh is not None, compute_dtype=dtype)
        out["cam" + tag] = CamTTAEngine(cam, scales=(0.5, 1.0, 1.5, 2.0), return_cam=False,
                                        **SPATIAL_CAM_FAST, **kw)
        out["seg" + tag] = SegTTAEngine(seg, scales=SEG_SCALES, **SPATIAL_SEG_FAST, **kw)
    # the parity switches off: the input-size logits, the whole canvas the window
    out["segoff"] = SegTTAEngine(seg, scales=SEG_SCALES, lowres=False, window_exact=False,
                                 **SPATIAL_SEG_FAST, **dict(kw, compute_dtype=torch.float32))
    return out


def _spatial_serve(engines: dict, spec: dict, dev) -> dict:
    """Each engine on each of its batches (every rank passes the whole
    batch; the engine splits it over the mesh's data rows): one warm-up
    run, SPATIAL_REPS timed ones with every kernel's count and the
    exchanges' counts zeroed just before them, and one more with the
    exchanges timed; the records, seconds, counts per forward, exchanges
    and peak memory."""
    import torch

    out = {}
    for name, engine in engines.items():
        stripes = engine.stripes
        for batch in spec[f"{name.split('_')[0]}_batches"]:
            size = len(batch[0])
            engine.run_batch(*batch)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            _zero_counts()
            if stripes:
                stripes.reset_stats()
            secs = []
            for _ in range(SPATIAL_REPS):
                t0 = time.perf_counter()
                recs = engine.run_batch(*batch)  # waits for its download
                secs.append(time.perf_counter() - t0)
            forwards = SPATIAL_REPS * len(engine.scales)
            counts = {k: v / forwards for k, v in _launch_counts().items()}
            exchanges = timed_s = None
            if stripes:  # the exchanges' counts, then one more run with them timed
                exchanges = {k: {"per_forward": v["calls"] / forwards,
                                 "bytes_per_forward": v["bytes"] / forwards}
                             for k, v in stripes.stats.items()}
                stripes.reset_stats()
                stripes.timed = True
                t0 = time.perf_counter()
                engine.run_batch(*batch)
                timed_s = time.perf_counter() - t0
                stripes.timed = False
                for k, v in stripes.stats.items():
                    exchanges[k]["ms_per_batch"] = v["seconds"] * 1e3
            out[(name, size)] = {
                "records": recs, "images": size, "seconds": secs,
                "timed_run_seconds": timed_s, "launches_per_forward": counts,
                "exchanges": exchanges,
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    return out


def _spatial_rank(rank: int, world: int, backend: str, axes, tmp: str) -> None:
    """One rank of the spatial phase: joins the group (gloo: every rank on
    card 0; nccl: rank r on card r), makes every mesh of ``axes`` (model
    axis k: a (world / k) x k mesh), runs both engines on each, and saves
    what it measured."""
    import os

    import torch

    from muscle_tpu_torch import parallel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0 if backend == "gloo" else rank)
    group = parallel.init(rank, world, f"file://{tmp}/store_sp_{backend}", dev, backend)
    spec = torch.load(os.path.join(tmp, "spatial_spec.pt"), weights_only=False)
    meshes = {k: parallel.make_mesh(k) for k in axes}
    out = {}
    for k, mesh in meshes.items():
        tag = f"{mesh.shape['data']}x{k}"
        out[tag] = {"coords": (mesh.data_index, mesh.model_index),
                    "serve": _spatial_serve(_spatial_engines(spec, dev, mesh), spec, dev)}
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"sp_{backend}_rank{rank}.pt"))
    parallel.barrier(group)
    parallel.shutdown(group)


def _spatial_readings(ref: dict, outs: list, tag: str, backend: str) -> dict:
    """One mesh's run against the one-process references: the records
    (every rank returns the whole batch's, and every rank must hold the
    same) by image name, the launches per forward of every rank, and the
    readings; the bf16 engines by the bf16 rules against one process's
    bf16 engine, each map's own distance its bf16 records' from its f32
    ones."""
    import numpy as np

    rec = {}
    for (name, size), one in ref.items():
        runs = [o[tag]["serve"].get((name, size)) for o in outs]
        cam = name.startswith("cam")
        key = "sgc" if cam else "probs"
        by_name, agree = {}, True
        for o, run in zip(outs, runs):
            for r in run["records"]:
                first = by_name.setdefault(r["name"], r)
                if cam:
                    agree &= all(np.array_equal(first[key][c], r[key][c]) for c in r[key])
                    agree &= bool(np.array_equal(first["score"], r["score"]))
                else:
                    agree &= bool(np.array_equal(first[key], r[key]))
        want = one["records"]
        mine = [by_name[r["name"]] for r in want]
        entry = {"batch": size, "one_process_latency_s": one["seconds"],
                 "latency_s": [max(run["seconds"][i] for run in runs)
                               for i in range(SPATIAL_REPS)],
                 "one_process_peak_gib": one["peak_gib"],
                 "peak_gib_per_rank": [run["peak_gib"] for run in runs],
                 "counts_per_rank": [run["launches_per_forward"] for run in runs],
                 "exchanges_rank0": runs[0]["exchanges"],
                 "timed_run_s_rank0": runs[0]["timed_run_seconds"],
                 "ranks_agree": agree}
        entry["images_per_s"] = size / min(entry["latency_s"])
        entry["one_process_images_per_s"] = size / min(one["seconds"])
        entry["speedup"] = min(one["seconds"]) / min(entry["latency_s"])
        per = GATES_B3_PER_FORWARD if cam else GATES_B7_PER_FORWARD
        kernel, other = (("mbconv_bf16", "mbconv_stride1") if name.endswith("bf16")
                         else ("mbconv_stride1", "mbconv_bf16"))
        launches_ok = all(c[kernel] == per and c[other] == 0 for c in entry["counts_per_rank"])
        if name.endswith("bf16"):
            f32 = ref[(name.split("_")[0], size)]["records"]
            entry.update(_bf16_readings_vs(mine, want, f32, cam))
            ok = entry["bf16_rules_passed"]
        elif cam:
            entry["score_err"], entry["sgc_err"] = _compare(
                mine, want, f"spatial {backend} {tag} CAM batch {size} vs one process")
            ok = True
        else:
            err, lab = 0.0, 1.0
            for g, w in zip(mine, want):
                assert g["probs"].shape == w["probs"].shape and np.isfinite(g["probs"]).all()
                err = max(err, float(np.abs(g["probs"] - w["probs"]).max()))
                lab = min(lab, float((g["probs"].argmax(-1) == w["probs"].argmax(-1)).mean()))
            entry["probs_err"], entry["labels_agreement_min"] = err, lab
            ok = err <= SEG_PROBS_TOL and lab >= SEG_LABEL_AGREE
        entry["passed"] = bool(ok and agree and launches_ok)
        rec[f"{name}_{size}"] = entry
    rec["passed"] = all(e["passed"] for e in rec.values())
    return rec


def _bf16_readings_vs(got, want, f32, cam: bool) -> dict:
    """The bf16 phase's rules for records ``got`` against the bf16
    reference ``want``, each map's own bf16 sensitivity ``want``'s distance
    from the f32 records ``f32``: CAM scores within BF16_SCORE_TOL, each
    SGC map's mean |diff| within BF16_SGC_TOL or BF16_SGC_REL times its
    own; seg labels (the probabilities' argmax) on BF16_LABEL_AGREE of
    the pixels whose f32 top-two margin exceeds BF16_MARGIN, or
    disagreeing there on at most BF16_SGC_REL times what ``want``
    disagrees with f32."""
    import numpy as np

    if cam:
        score = max(float(np.abs(g["score"] - w["score"]).max()) for g, w in zip(got, want))
        errs, flips = _fused_mean_errs(got, want)
        own, _ = _fused_mean_errs(want, f32)
        ok = score <= BF16_SCORE_TOL and all(
            e <= max(BF16_SGC_TOL, BF16_SGC_REL * o) for e, o in zip(errs, own))
        return {"bf16_score_max_abs_err": score, "bf16_sgc_mean_abs_err_max": max(errs),
                "bf16_own_sgc_mean_abs_err_max": max(own), "bf16_zeroing_flips": flips,
                "bf16_rules_passed": ok}
    agree, own = [], []
    for g, w, f in zip(got, want, f32):
        assert g["probs"].shape == w["probs"].shape and np.isfinite(g["probs"]).all()
        top2 = np.sort(f["probs"].astype(np.float32), axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > BF16_MARGIN
        lab, wlab, flab = (r["probs"].argmax(-1) for r in (g, w, f))
        agree.append(float((lab == wlab)[clear].mean()))
        own.append(float((wlab == flab)[clear].mean()))
    floors = [1 - max(1 - BF16_LABEL_AGREE, BF16_SGC_REL * (1 - o)) for o in own]
    return {"bf16_labels_agreement": agree, "bf16_own_labels_agreement": own,
            "bf16_rules_passed": all(a >= fl for a, fl in zip(agree, floors))}


def phase_spatial(card: str) -> dict:
    """Spatial sharding (module docstring, phase spatial): the one-process
    references on card 0, then SPATIAL_SHARED_RANKS ranks sharing card 0
    over gloo and, where there are several cards, one rank a card over
    NCCL (spawned processes, a FileStore rendezvous in a temporary
    directory); one {"spatial": ...} line; any failed check fails the
    phase."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from muscle_tpu_torch.models import init_weights

    n = torch.cuda.device_count()
    configs = [("gloo", SPATIAL_SHARED_RANKS, (SPATIAL_SHARED_RANKS,))]
    nccl = next((w for w in SPATIAL_NCCL_RANKS if w <= n), None)
    if nccl:
        configs.append(("nccl", nccl, (nccl, 2) if nccl == 4 else (nccl,)))
    cam = _images(1, seed=4)[0]
    seg = _seg_batches(1, seed=5)[0]
    spec = {"cam_state": {k: v.detach().cpu() for k, v in init_weights(
                _dp_arch("b3_cam"), torch.Generator().manual_seed(0)).state_dict().items()},
            "seg_state": {k: v.detach().cpu() for k, v in _seg_model(384).state_dict().items()},
            "cam_batches": [tuple(part[:size] for part in cam) for size in SPATIAL_CAM_SIZES],
            "seg_batches": [tuple(part[:size] for part in seg) for size in SPATIAL_SEG_SIZES],
            "segoff_batches": [tuple(part[:1] for part in seg)]}
    out = {"card": card, "ran": [f"{b} x {w}" for b, w, _ in configs]}
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref = _spatial_serve(_spatial_engines(spec, dev), spec, dev)
        torch.cuda.empty_cache()
        out["one_process_seconds"] = time.perf_counter() - t0
        torch.save(spec, f"{tmp}/spatial_spec.pt")
        for backend, world, axes in configs:
            t0 = time.perf_counter()
            mp.spawn(_spatial_rank, args=(world, backend, axes, tmp), nprocs=world, join=True)
            outs = [torch.load(f"{tmp}/sp_{backend}_rank{r}.pt", weights_only=False)
                    for r in range(world)]
            for tag in outs[0]:
                rec = _spatial_readings(ref, outs, tag, backend)
                rec["passed"] &= [o[tag]["coords"] for o in outs] == [
                    divmod(r, world // int(tag.split("x")[0])) for r in range(world)]
                out[f"{backend}_{tag}"] = rec
            out[f"{backend}_seconds"] = time.perf_counter() - t0
    print(json.dumps({"spatial": out}), flush=True)
    failed = [k for k, v in out.items() if isinstance(v, dict) and not v["passed"]]
    if failed:
        raise AssertionError(f"spatial: {failed} failed")
    return out


def _device_exec_case(engine, batch, stream, check) -> dict:
    """One engine's ``bench_device_exec`` on ``batch``: the closure made
    (host prep and upload once), one warm-up call, one call with every
    kernel's count zeroed just before it (its buffer handed to ``check``,
    which holds it to what the engine's own entry point returns for the
    batch), DEVICE_EXEC_REPS chained calls timed by CUDA events, and
    ``stream()`` (the engine's streaming entry point over
    DEVICE_EXEC_STREAM_BATCHES copies of the batch: (records, seconds))."""
    import torch

    run = engine.bench_device_exec(*batch)
    run()
    torch.cuda.synchronize()
    _zero_counts()
    buf = run()
    torch.cuda.synchronize()
    counts = _launch_counts()
    readings = check(buf)
    del buf
    ms = time_ms(run, DEVICE_EXEC_REPS)
    stream()  # warm-up
    _, secs = stream()
    n = len(batch[0])
    return {"images": n, "device_ms_per_call": ms, "device_images_per_s": n / ms * 1e3,
            "stream_images_per_s": n * DEVICE_EXEC_STREAM_BATCHES / secs,
            "launches_per_call": counts, **readings}


def phase_device_exec(card: str) -> dict:
    """Device-only rates (module docstring, phase device_exec): each
    engine's ``bench_device_exec`` at the main (CAM b3, --fast 0), bf16
    (CamBench), seg (b7, --fast 1 labels) and irn (crop 512, fast labels)
    phases' configurations, beside the engine's streaming rate on the same
    batch; one {"device_exec": ...} line."""
    import numpy as np
    import torch

    from muscle_tpu_torch.inference import CamTTAEngine, RandomWalkRefiner, SegTTAEngine
    from muscle_tpu_torch.models import MuSCLe, init_weights

    cam_model = init_weights(MuSCLe(backbone_name="efficientnet-b3", mode="enc",
                                    last_pooling=False, fuse_mbconv=384),
                             torch.Generator().manual_seed(0))
    cams = {"cam_f32": CamTTAEngine(cam_model, scales=(0.5, 1.0, 1.5, 2.0), return_cam=False,
                                    device="cuda"),
            "cam_bf16": CamTTAEngine(cam_model, compute_dtype=torch.bfloat16,
                                     scales=(0.5, 1.0, 1.5, 2.0), return_cam=False,
                                     max_classes=4, accum_stride=4, download_dtype="uint8",
                                     tight_upload=True, upload_mode="ycbcr420", device="cuda")}
    batch = _images(1, seed=2)[0]
    out = {"card": card}

    def cam_check(engine):
        want = engine.run_batch(*batch)
        prep = engine._host_prep(*batch)

        def check(buf):
            got = engine._make_finalize(lambda: buf.cpu().numpy(), prep["names"],
                                        prep["orig_sizes"], prep["class_idx"], prep["counts"],
                                        engine.max_classes)()
            score = max(float(np.abs(g["score"] - w["score"]).max()) for g, w in zip(got, want))
            errs, _ = _fused_mean_errs(got, want)
            return {"vs_run_batch_score_max_abs_err": score,
                    "vs_run_batch_sgc_mean_abs_err_max": max(errs),
                    "passed": score <= SCORE_TOL and max(errs) <= SGC_TOL}
        return check

    for name, engine in cams.items():
        out[name] = _device_exec_case(engine, batch, lambda e=engine: _run(
            e, [batch] * DEVICE_EXEC_STREAM_BATCHES), cam_check(engine))
    del cams, cam_model
    torch.cuda.empty_cache()

    seg = SegTTAEngine(_seg_model(384), scales=SEG_SCALES, accum_stride=4,
                       download_dtype="float16", tight_upload=True, upload_mode="ycbcr420",
                       output="labels", device="cuda")
    sbatch = _seg_batches(1, seed=2)[0]

    def seg_check(buf):
        want = seg.run_batch(*sbatch)
        lab = buf.cpu().numpy()
        agree = min(float((lab[i, :w["label"].shape[0], :w["label"].shape[1]]
                           == w["label"]).mean()) for i, w in enumerate(want))
        return {"vs_run_batch_labels_agreement_min": agree, "passed": agree >= SEG_LABEL_AGREE}

    out["seg"] = _device_exec_case(seg, sbatch, lambda: _seg_run(
        seg, [sbatch] * DEVICE_EXEC_STREAM_BATCHES), seg_check)
    del seg
    torch.cuda.empty_cache()

    refiner = RandomWalkRefiner(_irn_model(), crop_size=512, fast_io=True, output="labels",
                                device="cuda")
    ibatch = _irn_batches(1, seed=4)[0]

    def irn_check(buf):
        want = refiner.refine_batch(*ibatch)
        lab = buf.cpu().numpy()
        agree = min(float((lab[i, :w.shape[0], :w.shape[1]] == w).mean())
                    for i, w in enumerate(want))
        return {"vs_refine_batch_labels_agreement_min": agree, "passed": agree >= LABEL_AGREE}

    out["irn"] = _device_exec_case(refiner, ibatch, lambda: _refine(
        refiner, [ibatch] * DEVICE_EXEC_STREAM_BATCHES), irn_check)
    print(json.dumps({"device_exec": out}), flush=True)
    want = {"cam_f32": ("mbconv_stride1", 23 * 4), "cam_bf16": ("mbconv_bf16", 23 * 4),
            "seg": ("mbconv_stride1", SEG_LAUNCHES), "irn": ("stencil_walk", 1)}
    bad = [k for k, (kernel, n) in want.items()
           if out[k]["launches_per_call"][kernel] != n or not out[k]["passed"]
           or sum(out[k]["launches_per_call"].values()) != n]
    if bad:
        raise AssertionError(f"device_exec: {bad} failed (launches per call, or the closure's "
                             f"buffer against the engine's own result): {out}")
    return out


def _cli(tag: str, module: str, *args: str) -> dict:
    """Run ``python -m <module> <args>`` from the repository's root and
    return the JSON object of its last stdout line; a non-zero exit fails
    the phase with the tail of its stderr."""
    import os

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         timeout=GATES_CLI_TIMEOUT)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"{tag}: {module} exited {res.returncode}:\n{res.stderr[-4000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    log(f"{tag}: {secs:.1f} s of command time")
    return {"result": out, "command_seconds": secs, "stdout": res.stdout}


def phase_gates(card: str) -> dict:
    """The port's file-based CLIs on the card (module docstring, phase
    gates); one {"gates_phase": ...} line.  Each CLI runs in its own
    process, whose kernel counts start at 0 and which reports them at its
    end: infer_mcl and infer_seg in their last line
    (``cli/common.RunStats``), gates 4, 5 and 6 in their rows."""
    import os
    import tempfile

    import numpy as np
    import PIL
    import torch

    from muscle_tpu_torch.gates import build_synthetic_voc
    from muscle_tpu_torch.models import MuSCLe, init_weights

    print(json.dumps({"gates_phase": {"PIL": PIL.__version__}}), flush=True)
    out = {"card": card, "PIL": PIL.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "voc")
        names = build_synthetic_voc(root, sizes=GATES_FULL_SIZES)
        voc = ["--voc12_root", root, "--cls_labels", os.path.join(root, "cls_labels.npy")]
        lst = os.path.join(root, "list.txt")
        out["tree_seconds"] = time.perf_counter() - t0

        # infer_mcl at its defaults: a seeded random b3
        b3 = init_weights(MuSCLe(backbone_name="efficientnet-b3", mode="enc",
                                 last_pooling=False), torch.Generator().manual_seed(0))
        torch.save(b3.state_dict(), os.path.join(tmp, "b3.pth"))
        del b3
        cams = os.path.join(tmp, "cams")
        run = _cli("infer_mcl", "muscle_tpu_torch.cli.infer_mcl", "--weights",
                   os.path.join(tmp, "b3.pth"), "--infer_list", lst, "--out_npy", cams, *voc)
        r = run["result"]
        written = sorted(f[:-4] for f in os.listdir(cams + "_sgc"))
        finite = all(np.isfinite(m.astype(np.float32)).all()
                     for n in names for m in np.load(os.path.join(cams + "_sgc", n + ".npy"),
                                                     allow_pickle=True).item().values())
        out["infer_mcl"] = {**r, "command_seconds": run["command_seconds"],
                            "launches_per_image": r["mbconv_launches"] / r["images"]}
        print(json.dumps({"gates_phase": {"infer_mcl": out["infer_mcl"]}}), flush=True)
        if not (r["images"] == len(names) and written == sorted(names) and finite
                and r["mbconv_launches"] > 0
                and r["mbconv_launches"] == GATES_B3_PER_FORWARD * r["backbone_forwards"]):
            raise AssertionError(f"infer_mcl: {r}, {len(written)} npys, finite {finite}")

        # gates 4, 5 and 6 at the quick tier
        gdir = os.path.join(tmp, "gates")
        run = _cli("gates", "muscle_tpu_torch.cli.gates", "--synthetic", "--quick", "--gates",
                   "4,5,6", "--device", "cuda", "--out_dir", gdir)
        with open(os.path.join(gdir, "gates_report.json")) as f:
            rows = json.load(f)
        for row in rows:
            print(json.dumps({"gates_phase": {"gate": row}}), flush=True)
        by = {row["gate"]: row for row in rows}
        g6 = by.get("6_convergence", {}).get("mbconv_launches", {})
        out["gates"] = {"command_seconds": run["command_seconds"],
                        "seconds": {k: v["seconds"] for k, v in by.items()},
                        "passed": {k: v["passed"] for k, v in by.items()},
                        "gate6_mbconv_launches": g6,
                        "mbconv_launches": sum(
                            v["mbconv_launches"] if isinstance(v["mbconv_launches"], int)
                            else sum(v["mbconv_launches"].values())
                            for v in rows if "mbconv_launches" in v)}
        print(json.dumps({"gates_phase": {"gates": out["gates"]}}), flush=True)
        want = {"4_train_mcl_memorise", "5_train_muscle_memorise", "6_convergence",
                "quick_tier_budget"}
        if set(by) != want or not all(v["passed"] for v in rows):
            raise AssertionError(f"gates: {[(k, v['passed']) for k, v in by.items()]}")
        evals = [by["4_train_mcl_memorise"]["mbconv_launches"],
                 by["5_train_muscle_memorise"]["mbconv_launches"],
                 g6.get("cam_eval", 0), g6.get("seg_eval", 0)]
        if not all(n > 0 for n in evals):
            raise AssertionError(f"gates: MBConv launches in the evals {evals}, want each > 0")

        # real_run's seg and eval stages: a seeded random b7 + BiFPN 3
        b7 = _seg_model(0)
        torch.save({k: v.detach().cpu().clone() for k, v in b7.state_dict().items()},
                   os.path.join(tmp, "b7.pth"))
        del b7
        torch.cuda.empty_cache()
        rdir = os.path.join(tmp, "real_run")
        run = _cli("real_run", "muscle_tpu_torch.cli.real_run", "--list", lst, "--seg_weights",
                   os.path.join(tmp, "b7.pth"), "--out_dir", rdir, "--stages", "seg,eval", *voc)
        seg, ev = run["result"]["seg"], run["result"]["eval"]
        pngs = sorted(f[:-4] for f in os.listdir(os.path.join(rdir, "seg")))
        out["real_run"] = {**seg, **{"mIoU": ev["mIoU"], "eval_seconds": ev["seconds"]},
                           "command_seconds": run["command_seconds"],
                           "launches_per_forward": seg["mbconv_launches"]
                           / max(seg["backbone_forwards"], 1)}
        print(json.dumps({"gates_phase": {"real_run": out["real_run"]}}), flush=True)
        if not (pngs == sorted(names) and seg["pngs"] == len(names)
                and np.isfinite(ev["mIoU"]) and 0.0 <= ev["mIoU"] <= 100.0
                and seg["backbone_forwards"] > 0
                and seg["mbconv_launches"] == GATES_B7_PER_FORWARD * seg["backbone_forwards"]):
            raise AssertionError(f"real_run: {out['real_run']}, {len(pngs)} PNGs")
    out["launches"] = {
        "mbconv_stride1": (out["infer_mcl"]["mbconv_launches"] + out["gates"]["mbconv_launches"]
                           + out["real_run"]["mbconv_launches"]),
        "mbconv_bf16": (out["infer_mcl"]["mbconv_launches_bf16"]
                        + out["real_run"]["mbconv_launches_bf16"]),
        # no stage of this phase walks: infer_irn and gate 3 are not in it
        "stencil_walk": 0, "banded_walk": 0}
    print(json.dumps({"gates_phase": {"launches": out["launches"]}}), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases",
                   default="build,kernels,main,irn,seg,bf16,train_mcl,train_seg,train_irn,"
                           "train_mcl_bf16,train_seg_bf16,dp,spatial,device_exec,gates")
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
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    def run(name, fn, *a):
        if name not in phases:
            return None
        t0 = time.perf_counter()
        result = fn(*a)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return result

    run("build", phase_build)
    summaries = run("kernels", phase_kernels)
    main_out = run("main", phase_main)
    irn_out = run("irn", phase_irn)
    seg_out = run("seg", phase_seg)
    bf16_out = run("bf16", phase_bf16)
    train_out = run("train_mcl", phase_train_mcl, card)
    seg_train_out = run("train_seg", phase_train_seg, card)
    irn_train_out = run("train_irn", phase_train_irn, card)
    mcl_bf16_out = run("train_mcl_bf16", phase_train_mcl_bf16, card)
    seg_bf16_out = run("train_seg_bf16", phase_train_seg_bf16, card)
    dp_out = run("dp", phase_dp, card)
    spatial_out = run("spatial", phase_spatial, card)
    exec_out = run("device_exec", phase_device_exec, card)
    gates_out = run("gates", phase_gates, card)
    run("profile", phase_profile, 4, "bf16" in phases)

    print(card, flush=True)  # again beside the results, for readers of the output's tail
    if summaries is not None:
        # null, not 0, where the phase that drives the kernel's path did not run
        launches = {
            "mbconv_stride1": main_out["fast0"]["launches"] if main_out else None,
            "mbconv_bf16": bf16_out["cam"]["launches_bf16"] if bf16_out else None,
            "stencil_walk": irn_out["stencil_launches"] if irn_out else None,
            "banded_walk": irn_out["banded_launches"] if irn_out else None,
        }
        entries = [{"name": name, "route": "cuda",
                    "source": f"muscle_tpu_torch/csrc/{KERNEL_SOURCES[name][0]}",
                    "replaces": KERNEL_SOURCES[name][1], "launches": launches[name],
                    **summaries[name]} for name in KERNEL_SOURCES]
        # the MBConv kernel also runs on the seg path: its launches there
        entries[0]["launches_seg"] = seg_out["fast0"]["launches"] if seg_out else None
        entries[1]["launches_seg"] = bf16_out["seg"]["launches_bf16"] if bf16_out else None
        # the seg engine's parity switches: a batch of 4 each (f32), one
        # window_exact=False batch of 4 at bf16
        entries[0]["launches_seg_switches"] = (
            {k: v["launches"] for k, v in seg_out["switches"].items() if "launches" in v}
            if seg_out else None)
        entries[1]["launches_seg_unwindowed"] = (bf16_out["seg_unwindowed"]["launches_bf16"]
                                                 if bf16_out else None)
        for e in entries:  # none runs in a training step; the seg eval runs MBConv
            e["launches_train_mcl"] = train_out["launches"][e["name"]] if train_out else None
            e["launches_train_seg"] = (seg_train_out["launches"][e["name"]]
                                       if seg_train_out else None)
            e["launches_train_seg_steps"] = (seg_train_out["step_launches"][e["name"]]
                                             if seg_train_out else None)
            e["launches_train_irn"] = (irn_train_out["launches"][e["name"]]
                                       if irn_train_out else None)
            e["launches_train_mcl_bf16"] = (mcl_bf16_out["launches"][e["name"]]
                                            if mcl_bf16_out else None)
            e["launches_train_seg_bf16"] = (seg_bf16_out["launches"][e["name"]]
                                            if seg_bf16_out else None)
            e["launches_train_seg_bf16_steps"] = (seg_bf16_out["step_launches"][e["name"]]
                                                  if seg_bf16_out else None)
        # the bf16 instantiation's seg-training launches: the bf16 trainer's eval
        entries[1]["launches_train_seg"] = entries[1]["launches_train_seg_bf16"]
        # each rank's MBConv launches in the data-parallel engines (f32)
        for e in entries:
            e["launches_dp"] = None if dp_out is None else {
                run_name: {f"{serve}_{eng}": [cnt[e["name"]]
                                              for cnt in r[serve][eng]["counts_per_rank"]]
                           for serve in ("serve", "serve_mesh") for eng in ("cam", "seg")}
                for run_name, r in dp_out.items() if isinstance(r, dict)}
        # each rank's launches per forward in the spatially sharded engines
        # (f32: every rank of a model group runs every stride-1 block)
        for e in entries:
            e["launches_spatial"] = None if spatial_out is None else {
                run_name: {case: [c[e["name"]] for c in r[case]["counts_per_rank"]]
                           for case in r if isinstance(r[case], dict)}
                for run_name, r in spatial_out.items() if isinstance(r, dict)}
        for e in entries:  # one device-only call of each engine's executor
            e["launches_device_exec"] = None if exec_out is None else {
                k: v["launches_per_call"][e["name"]] for k, v in exec_out.items()
                if isinstance(v, dict)}
        for e in entries:  # the CLIs' launches in the gates phase (its subprocesses')
            e["launches_gates"] = gates_out["launches"][e["name"]] if gates_out else None
        print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
