"""muscle_tpu_torch: the PyTorch + CUDA port of muscle_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  Two
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

The package imports torch, numpy and the standard library, never JAX or
``muscle_tpu``; PIL is imported only inside the functions that resize,
decode or write images.

Subpackages
-----------
core        resize weights and bilinear resizes, the VOC palette
models      EfficientNet, MuSCLe (encoder mode), ResNet-50, IRN EdgeDisplacement
ops         CUDA kernel wrappers with their plain versions, the random walk;
            the nvcc build
data        VOC12 lists, transforms, batched TTA producers
inference   CamTTAEngine, RandomWalkRefiner, the device-side upload unpackers
evaluation  vectorised mIoU with threshold sweep
cli         infer_mcl, evaluate, infer_irn
convert     state dicts from the JAX package's variables or reference .pth
"""

__version__ = "0.1.0"
