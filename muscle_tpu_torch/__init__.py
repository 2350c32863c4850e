"""muscle_tpu_torch: the PyTorch + CUDA port of muscle_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  This
slice carries CAM generation end to end: EfficientNet backbone, MuSCLe's
CAM + PCM heads, batched multi-scale + flip TTA, the CLIs and mIoU
evaluation.  The inference stride-1 MBConv block runs as a hand-written
CUDA kernel (``csrc/mbconv.cu``, wrapper ``ops/mbconv.py``).

The package imports torch, numpy and the standard library, never JAX or
``muscle_tpu``; PIL is imported only inside the functions that resize or
decode images.

Subpackages
-----------
core        resize weights and bilinear resizes
models      EfficientNet, MuSCLe (encoder mode)
ops         CUDA kernel wrappers with their plain versions; the nvcc build
data        VOC12 lists, transforms, batched TTA producers
inference   CamTTAEngine and the device-side upload unpackers
evaluation  vectorised mIoU with threshold sweep
cli         infer_mcl, evaluate
convert     state dicts from the JAX package's variables or reference .pth
"""

__version__ = "0.1.0"
