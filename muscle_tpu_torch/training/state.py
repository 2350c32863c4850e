"""Optimizer, learning rate and checkpoints (port of
``muscle_tpu/training/state.py``).

Checkpoints per epoch ``<ep>``, in ``ckpt_dir``:

* ``model_<ep>.pth``: the model's state dict in the reference's key names
  (what the CLIs' ``--weights`` load);
* ``step_<ep>.pt``: the full train state (model, Adam moments and learning
  rate, step, epoch) for ``--resume_epoch``.

The JAX package's ``.msgpack``/Orbax formats are not written.
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
    opt.step()
    return gnorm


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
    full = torch.load(os.path.join(ckpt_dir, f"step_{epoch}.pt"), map_location=dev,
                      weights_only=True)
    model.load_state_dict(full["model"])
    opt.load_state_dict(full["optimizer"])
    return int(full["step"])
