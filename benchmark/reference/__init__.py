"""The plain reference the benchmark holds the program to: MuSCLe in
float32 (``model.py``), its resizes (``resize.py``), the CAM and seg TTA
(``tta.py``) and MCL step A with Adam (``mcl.py``).  Plain PyTorch and
NumPy; it imports neither JAX, nor the JAX package, nor anything of the
program, and takes nothing the program made."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32():
    """TF32 on for cuDNN's convolutions and for matrix products: the
    control, the precision below the cells' stated float32."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
