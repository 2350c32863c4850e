"""Compute dtypes as Flax's ``dtype`` with float32 parameters: the layers
that let one set of float32 parameters serve float32 and bfloat16
forwards (the JAX package's models at ``dtype=jnp.bfloat16``).

A model of the port computes in the dtype of its input: the engines cast
the normalised images to their ``compute_dtype`` at the model's input and
the model's outputs back to float32 straight after it.  Casts happen
where Flax casts, never by ``torch.autocast``, which keeps normalisation
and elementwise outputs in float32 where Flax rounds them:

* a convolution (``Conv2d``) casts its kernel and bias to its input's
  dtype (cached bf16 copies of the one f32 set) and returns that dtype;
  at bfloat16 the bias is added to the rounded product, a second rounding
  (Flax's ``nn.Conv(dtype=...)`` casts input, kernel and bias, and adds
  the bias after the convolution);
* a batch or group norm (``norm_in_f32``) computes in float32 against its
  float32 statistics and parameters and rounds its output to the input's
  dtype (Flax's ``_normalize``);
* elementwise ops run on the compute-dtype tensors, and masks take their
  dtype;
* where Flax mixes a compute-dtype array with a float32 one (the
  classifier's kernel, the window resizes' float32 weights), jnp promotes
  to float32; the port promotes the same way, and casts back to the
  compute dtype explicitly where Flax's next convolution would.
"""

from __future__ import annotations

import torch
from torch import nn


def norm_in_f32(forward, x: torch.Tensor) -> torch.Tensor:
    """``forward`` (a norm's float32 forward) on float32 ``x``, or on ``x``
    upcast and its output rounded back to ``x``'s dtype."""
    if x.dtype == torch.float32:
        return forward(x)
    return forward(x.float()).to(x.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype: at bfloat16 with
    the kernel and bias cast to bfloat16, the bias added to the product
    after its rounding, as Flax adds it."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._cast = {}  # dtype -> (key of the f32 parameters, (kernel, bias))

    def _params_as(self, dtype: torch.dtype):
        """(kernel, bias) in ``dtype``.  Outside autograd the copies are
        made once and kept until a parameter changes (its storage or
        version counter moves), so an inference forward casts no weight;
        under autograd, and under ``torch.func`` transforms, the casts are
        recorded like any op."""
        params = (self.weight, self.bias)
        if (torch.is_grad_enabled() or self.weight.is_inference()
                or torch._C._functorch.is_functorch_wrapped_tensor(self.weight)):
            return tuple(None if t is None else t.to(dtype) for t in params)
        key = tuple(None if t is None else (t.device, t.data_ptr(), t._version)
                    for t in params)
        hit = self._cast.get(dtype)
        if hit is None or hit[0] != key:
            with torch.inference_mode(False):  # reusable outside inference mode
                hit = (key, tuple(None if t is None else t.detach().to(dtype)
                                  for t in params))
            self._cast[dtype] = hit
        return hit[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        weight, bias = self._params_as(x.dtype)
        y = self._conv_forward(x, weight, None)
        return y if bias is None else y + bias[:, None, None]


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` computing in float32 for any input dtype, its
    output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_in_f32(super().forward, x)
