"""Plain MCL training step A of the reference (SCoulY/MuSCLe
``train_mcl.py`` from epoch 4: focal + soft margin + LSEP + ER top-k +
IMC on the full image in mode 'cam', train-mode batch norms), with Adam
and L2 weight decay added to the gradient, in float32.

``step`` takes the batch as the cells feed it (4:2:0 planes and labels)
and returns the loss; the parameters, Adam's moments and the batch norms'
running statistics move in place.  With a ``group`` (``torch.distributed``)
the batch is this rank's rows of the global batch: every mean is the global
batch's (this rank adds its rows' share), IMC takes every rank's
embeddings, and the gradients are summed over the ranks before Adam, so
every rank takes the one step of the global batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F

from benchmark.reference.model import set_group
from benchmark.reference.tta import IMAGENET_MEAN, IMAGENET_STD, decode_ycbcr420


def _softmaxnorm(cams):
    fg = torch.softmax(cams[..., 1:], dim=-1)
    return torch.cat([1.0 - torch.amax(fg, dim=-1, keepdim=True), fg], dim=-1)


def focal(probs, target, gamma: float = 2.0, alpha: float = 0.5):
    """Per sample: focal loss summed over the classes."""
    pt = target * probs + (1.0 - target) * (1.0 - probs)
    return (-alpha * (1.0 - pt) ** gamma * torch.log(pt + 1e-9)).sum(dim=1)


def soft_margin(logits, target):
    """Per sample: the classes' mean binary cross-entropy."""
    per = -(target * F.logsigmoid(logits) + (1.0 - target) * F.logsigmoid(-logits))
    return per.mean(dim=-1)


def lsep(pred, labels):
    """Pairwise ranking loss per sample, absent entries zeroed (not
    excluded), as the reference computes it."""
    pos = torch.where(labels == 0, torch.zeros_like(pred), pred)
    neg = torch.where(labels == 1, torch.zeros_like(pred), pred)
    e = torch.exp(neg[:, None, :] - pos[:, :, None])
    return torch.log(1.0 + e.sum(dim=(1, 2)) / (e.shape[1] * e.shape[2]))


def er_topk(cams, sgcs, valid_channels, frac: float = 0.2, iters: int = 22):
    """Per sample: the mean of its top k = int(frac * label count * h * w)
    values of |cams - sgcs| (the label count of the whole batch), the k-th
    value found by ``iters`` halvings of [0, max], ties at the threshold
    counted once each."""
    n, h, w, _ = cams.shape
    diff = torch.abs(cams.detach() - sgcs).reshape(n, -1)
    k = (frac * valid_channels * h * w).to(torch.int32)
    kf = torch.clamp(k, 1, diff.shape[-1]).to(torch.float32)
    with torch.no_grad():
        d = diff.detach()
        lo, hi = torch.zeros((n,), device=d.device), d.amax(dim=-1)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            more = (d > mid[:, None]).sum(dim=-1).to(torch.float32) > kf
            lo, hi = torch.where(more, mid, lo), torch.where(more, hi, mid)
        above = d > hi[:, None]
        n_above = above.sum(dim=-1).to(torch.float32)
    top = torch.where(above, diff, torch.zeros_like(diff)).sum(dim=-1) + (kf - n_above) * hi
    return top / kf


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` along dim 0, in rank order, with gradient."""
    return t if group is None else torch.cat(dist_fn.all_gather(t, group=group))


def imc(emb, label, temperature: float = 0.1, group=None):
    """Image-level contrast, summed over this rank's samples: pairs (i, j >
    i) of the global batch with equal label sets are positives, with
    disjoint ones negatives; a sample counts with >= 1 positive, >= 1
    negative and more negatives than positives."""
    n = emb.shape[0]
    r = 0 if group is None else dist.get_rank(group)
    keys = _gather(emb, group)
    keys = keys / torch.clamp(torch.linalg.vector_norm(keys, dim=-1, keepdim=True), min=1e-6)
    key_label = _gather(label, group)
    rows = slice(r * n, (r + 1) * n)
    e, label = keys[rows], key_label[rows]
    b = keys.shape[0]
    sim = torch.exp(e @ keys.T / temperature)
    upper = torch.triu(torch.ones((b, b), dtype=torch.bool, device=emb.device), diagonal=1)[rows]
    eq = torch.all(label[:, None, :] == key_label[None, :, :], dim=-1)
    disjoint = (label[:, None, :] * key_label[None, :, :]).sum(dim=-1) == 0
    pos, neg = (upper & eq).float(), (upper & disjoint).float()
    sim_pos = 1e-6 + (pos * sim).sum(dim=1)
    denom = sim_pos + 1e-6 + (neg * sim).sum(dim=1)
    active = (pos.sum(1) >= 1) & (neg.sum(1) >= 1) & (neg.sum(1) > pos.sum(1))
    per = -torch.log(sim_pos / denom)
    return torch.where(active, per, torch.zeros_like(per)).sum()


def loss_a(model, batch: dict, generator, group=None) -> torch.Tensor:
    """Step A's loss on a batch {'img_y', 'img_c', 'label'} on the device:
    with a ``group``, this rank's share of the global batch's loss."""
    rgb = decode_ycbcr420(batch["img_y"], batch["img_c"])
    mean = torch.tensor(IMAGENET_MEAN, device=rgb.device)
    std = torch.tensor(IMAGENET_STD, device=rgb.device)
    label = batch["label"]
    raw_cams, raw_sgcs, emb, logits = model((rgb / 255.0 - mean) / std, mode="cam",
                                            generator=generator)
    lb = torch.cat([torch.ones_like(label[:, :1]), label], dim=-1)[:, None, None, :]
    probs = torch.sigmoid(logits[:, 1:])
    cams = _softmaxnorm(raw_cams).detach() * lb
    sgcs = _softmaxnorm(raw_sgcs) * lb
    n = label.shape[0] * (1 if group is None else dist.get_world_size(group))
    labelled = label.sum() if group is None else dist_fn.all_reduce(label.sum(), group=group)
    per_sample = (focal(probs, label) + soft_margin(logits[:, 1:], label) + lsep(probs, label)
                  + er_topk(cams, sgcs, labelled.detach()))
    return (per_sample.sum() + imc(emb, label, group=group)) / n


class Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8) with L2 decay added to the
    gradient before the moments, over every trained parameter: one the
    loss does not reach steps on a zero gradient."""

    def __init__(self, params, lr: float, weight_decay: float):
        self.params = list(params)
        self.lr, self.wd, self.t = lr, weight_decay, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> list[torch.Tensor]:
        """One update; returns the gradients as the moments took them
        (decay included)."""
        self.t += 1
        bc1, bc2 = 1.0 - 0.9 ** self.t, 1.0 - 0.999 ** self.t
        taken = []
        for p, m, v in zip(self.params, self.m, self.v):
            g = (torch.zeros_like(p) if p.grad is None else p.grad) + self.wd * p
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr * (m / bc1) / ((v / bc2).sqrt() + 1e-8))
            taken.append(g)
            p.grad = None
        return taken


def step(model, opt: Adam, batch: dict, generator,
         group=None) -> tuple[float, list[torch.Tensor]]:
    """One step A: (the global batch's loss, the gradients as Adam took
    them).  ``group``: this rank's rows of the global batch; the ranks'
    gradients are summed before the update."""
    model.train()
    set_group(model, group)
    loss = loss_a(model, batch, generator, group)
    loss.backward()
    loss = loss.detach()
    if group is not None:
        for p in opt.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            dist.all_reduce(p.grad, group=group)
        dist.all_reduce(loss, group=group)
    return float(loss), opt.step()
