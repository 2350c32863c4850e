"""Optimizer, learning rate and checkpoints (port of
``muscle_tpu/training/state.py``).

Checkpoints per epoch ``<ep>``, in ``ckpt_dir``:

* ``model_<ep>.pth``: the model's state dict in the reference's key names
  (what the CLIs' ``--weights`` load);
* ``step_<ep>.pt``: the full train state (model, Adam moments and learning
  rate, step, epoch) for ``--resume_epoch``.

Each tensor is saved and restored in its own dtype.  The JAX package's
``.msgpack``/Orbax formats are not written (``convert.read_flax_msgpack``
reads its ``.msgpack``).

Parameters stored below float32 (a bf16 model's fresh classifier kernel,
``models.classifier_as``) step as optax steps them: the moments are kept
and updated in the parameter's dtype, and the float32 learning rate
promotes the update, and with it the parameter, to float32 at its first
step; the next step's float32 gradient promotes the moments
(``minimize``).
"""

from __future__ import annotations

import contextlib
import os

import torch


def make_adam(params, lr: float, weight_decay: float) -> torch.optim.Adam:
    """torch.optim.Adam: L2 decay added to the gradient before the moments
    (not AdamW), as the JAX package's ``make_adam`` (optax) and the
    reference do.  ``params``: every parameter the model trains (optax
    updates all of them, the BN affines and the biases included)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


@contextlib.contextmanager
def batch_stats_train(model: torch.nn.Module):
    """The model in train mode with its batch norms normalising by the
    batch and updating nothing (no running statistics, no count); the mode
    and the norms' settings are restored after."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    was, tracked = model.training, [m.track_running_stats for m in bns]
    model.train()
    try:
        for m in bns:
            m.track_running_stats = False
        yield model
    finally:
        for m, t in zip(bns, tracked):
            m.track_running_stats = t
        model.train(was)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def minimize(opt: torch.optim.Optimizer, loss: torch.Tensor,
             clip_norm: float | None = None) -> torch.Tensor | None:
    """One optimizer step on ``loss``.  A parameter the loss does not reach
    gets a zero gradient rather than none: optax updates every parameter
    (decay and moments included) at every step, torch.optim skips those
    without a gradient.  clip_norm: first scale every gradient by
    min(1, clip_norm / (g + 1e-6)), g their global norm, and return g."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    params = [p for group in opt.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    gnorm = None
    if clip_norm is not None:
        gnorm = torch.nn.utils.clip_grad_norm_(params, clip_norm)
    _promoting_step(opt)
    return gnorm


@torch.no_grad()
def _promoting_step(opt: torch.optim.Optimizer) -> None:
    """``opt.step()`` (Adam) with jnp's promotions for parameters stored
    below float32, as optax's chain (decay, ``scale_by_adam``, the injected
    float32 learning rate) and ``p + u`` compute them: moments in the
    parameter's dtype, ``u = (mu / bc1) / (sqrt(nu / bc2) + eps)`` with the
    bias corrections cast to it, then ``p + (-lr) * u`` in float32, which
    leaves the parameter float32.  Moments left below their parameter's
    dtype by that promotion are promoted first (the next step's float32
    gradient does so in optax)."""
    low = []
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p, {})
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st and st[key].dtype != p.dtype:
                    st[key] = st[key].to(p.dtype)
            if p.dtype != torch.float32:
                low.append((group, p, p.detach().clone()))
    opt.step()  # a low-precision parameter's own update rounds away here
    for group, p, before in low:
        st = opt.state[p]
        (b1, b2), t = group["betas"], float(st["step"])
        bc1 = torch.tensor(1.0 - b1 ** t, dtype=p.dtype)
        bc2 = torch.tensor(1.0 - b2 ** t, dtype=p.dtype)
        u = (st["exp_avg"] / bc1) / ((st["exp_avg_sq"] / bc2).sqrt() + group["eps"])
        p.data = before.to(torch.float32) - group["lr"] * u.to(torch.float32)


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module, opt: torch.optim.Optimizer,
                    step: int, epoch: int) -> None:
    """Write ``step_<epoch>.pt`` (full state) and ``model_<epoch>.pth``,
    each through a temporary file renamed into place."""
    os.makedirs(ckpt_dir, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    full = {"model": sd, "optimizer": opt.state_dict(), "step": step, "epoch": epoch}
    for obj, name in ((full, f"step_{epoch}.pt"), (sd, f"model_{epoch}.pth")):
        path = os.path.join(ckpt_dir, name)
        torch.save(obj, path + ".tmp")
        os.replace(path + ".tmp", path)


def restore_checkpoint(ckpt_dir: str, epoch: int, model: torch.nn.Module,
                       opt: torch.optim.Optimizer) -> int:
    """Load ``step_<epoch>.pt`` into ``model`` and ``opt``; returns the
    step count."""
    dev = next(model.parameters()).device
    from muscle_tpu_torch.convert import load_into

    full = torch.load(os.path.join(ckpt_dir, f"step_{epoch}.pt"), map_location=dev,
                      weights_only=True)
    load_into(model, full["model"], strict=True)
    opt.load_state_dict(full["optimizer"])  # moments cast to their parameters' dtypes
    return int(full["step"])
