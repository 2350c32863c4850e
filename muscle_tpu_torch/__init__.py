"""muscle_tpu_torch: the PyTorch + CUDA port of muscle_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  Four
stages run end to end so far:

* CAM generation: EfficientNet backbone, MuSCLe's CAM + PCM heads, batched
  multi-scale + flip TTA, the CLIs and mIoU evaluation.  The inference
  stride-1 MBConv block runs as a hand-written CUDA kernel
  (``csrc/mbconv.cu``, wrapper ``ops/mbconv.py``).
* IRN random-walk refinement: the ResNet-50 edge net (``EdgeDisplacement``)
  and ``RandomWalkRefiner``.  The stencil walk (``csrc/stencil_walk.cu``,
  wrapper ``ops/stencil_walk.py``) and the banded walk
  (``csrc/banded_walk.cu``, wrapper ``ops/banded_walk.py``) are
  hand-written CUDA kernels; ``ops/random_walk.py`` builds their operands.
* Segmentation inference: MuSCLe in dec mode (the BiFPN decoder),
  ``SegTTAEngine`` (6-scale x flip TTA, mean fusion), the mean-field dense
  CRF in PyTorch and the native permutohedral CRF (``native/`` built with
  g++ into ``build/native/``); b7's stride-1 blocks run through the MBConv
  kernel.
* MCL classifier training: the seeded host data path, the losses, steps A
  and B, Adam, checkpoints and ``train_mcl``.  Training runs the plain
  blocks under autograd (the MBConv kernel has no backward).

The package imports torch, numpy and the standard library, never JAX or
``muscle_tpu``; PIL is imported only inside the functions that resize,
decode or write images.

Subpackages
-----------
core        resize weights and bilinear resizes, the VOC palette, CAM
            normalisers, the 4:2:0 pack and decode
models      EfficientNet, MuSCLe (enc and dec modes), the BiFPN, ResNet-50,
            IRN EdgeDisplacement
ops         CUDA kernel wrappers with their plain versions, the random walk;
            the nvcc build; the CRFs, the exact EMD and the native
            library's loader
data        VOC12 lists and the MCL training set, transforms, the prefetch
            loader, batched TTA producers
losses      classification, contrastive (IMC, PixPro) and EMD losses
training    MCL steps A and B, Adam and checkpoints, schedules, liveness
utils       timers, metric and tensorboard logs, training overlays
inference   CamTTAEngine, RandomWalkRefiner, SegTTAEngine, the transfers and
            device-side upload unpackers
evaluation  vectorised mIoU with threshold sweep
cli         infer_mcl, evaluate, infer_irn, infer_seg, cam_to_label, train_mcl
convert     state dicts from the JAX package's variables or reference .pth
"""

__version__ = "0.1.0"
