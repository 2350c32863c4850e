"""Image-level (IMC) and pixel-level (PixPro) contrastive losses (port of
``muscle_tpu/losses/contrastive.py``): the reference's O(B^2) loop is a
masked B x B similarity matrix, its ragged overlap crops a per-sample
gather of a view-sized window with a validity mask."""

from __future__ import annotations

import torch

from muscle_tpu_torch.parallel.mesh import all_gather, batch_mean, rank


def info_nce(query: torch.Tensor, positive_keys: torch.Tensor, negative_keys: torch.Tensor,
             temperature: float = 0.1) -> torch.Tensor:
    """Generic InfoNCE: query (B, D), positive_keys (B, P, D),
    negative_keys (B, N, D)."""
    pos = torch.einsum("bd,bpd->bp", query, positive_keys).mean(dim=1, keepdim=True)
    neg = torch.einsum("bd,bnd->bn", query, negative_keys)
    logits = torch.cat([pos, neg], dim=1) / temperature
    return -torch.log_softmax(logits, dim=1)[:, 0].mean()


def image_level_contrast(emb: torch.Tensor, label: torch.Tensor,
                         temperature: float = 0.1, group=None) -> torch.Tensor:
    """IMC loss.  Pairs (i, j > i) are positives when their label sets are
    equal and negatives when disjoint; sample i adds
    -log(sim_pos / (sim_pos + sim_neg)) (with the reference's 1e-6
    accumulator seeds) only with >= 1 positive, >= 1 negative and more
    negatives than positives.  Summed and divided by the batch size: 0
    when no sample qualifies.  With a data-parallel ``group`` the
    embeddings and labels are gathered (with gradient) and this rank adds
    the rows of its own samples against every j > i by global index over
    the global batch size: its share of the global loss."""
    n = emb.shape[0]
    keys, key_label = all_gather(emb, group), all_gather(label, group)
    norm = torch.linalg.vector_norm(keys, dim=-1, keepdim=True)
    keys = keys / torch.clamp(norm, min=1e-6)
    rows = slice(rank(group) * n, (rank(group) + 1) * n)
    emb, label = keys[rows], key_label[rows]
    sim = torch.exp(emb @ keys.T / temperature)
    eq = torch.all(label[:, None, :] == key_label[None, :, :], dim=-1)
    disjoint = (label[:, None, :] * key_label[None, :, :]).sum(dim=-1) == 0
    b = keys.shape[0]
    upper = torch.triu(torch.ones((b, b), dtype=torch.bool, device=emb.device),
                       diagonal=1)[rows]
    pos_mask = (upper & eq).to(sim.dtype)
    neg_mask = (upper & disjoint).to(sim.dtype)
    pos_count, neg_count = pos_mask.sum(dim=1), neg_mask.sum(dim=1)
    sim_pos = 1e-6 + (pos_mask * sim).sum(dim=1)
    denom = sim_pos + 1e-6 + (neg_mask * sim).sum(dim=1)
    active = (pos_count >= 1) & (neg_count >= 1) & (neg_count > pos_count)
    per_sample = -torch.log(sim_pos / denom)
    return torch.where(active, per_sample, torch.zeros_like(per_sample)).sum() / b


def _overlap_windows(fm: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """The (H, W) window of each NHWC map starting at its overlap's
    (row, col) = coord[:, :2], zeros past the map's edge (the JAX
    package's padded dynamic slice)."""
    n, hv, wv, _ = fm.shape
    dev = fm.device
    rows = coord[:, 0:1].long() + torch.arange(hv, device=dev)[None]  # (N, H)
    cols = coord[:, 1:2].long() + torch.arange(wv, device=dev)[None]  # (N, W)
    inside = (rows < hv)[:, :, None] & (cols < wv)[:, None, :]
    bidx = torch.arange(n, device=dev)[:, None, None]
    win = fm[bidx, rows.clamp(max=hv - 1)[:, :, None], cols.clamp(max=wv - 1)[:, None, :]]
    return win * inside[..., None].to(fm.dtype)


def pixpro_loss(fm1: torch.Tensor, fm2: torch.Tensor, coord1: torch.Tensor,
                coord2: torch.Tensor, group=None) -> torch.Tensor:
    """PixPro cross-view pixel consistency: 1 - the mean over samples of
    the mean cosine between the views' maps over their overlap.

    fm1: (N, H, W, C) view 1 (with gradient); fm2: view 2 (detached here);
    coord1/coord2: (N, 4) int (row, col, h_inter, w_inter) of the overlap
    in each view.  group: a data-parallel group (this rank's share of the
    global batch's loss)."""
    f1 = _overlap_windows(fm1, coord1)
    f2 = _overlap_windows(fm2.detach(), coord2)
    _, hv, wv, _ = fm1.shape
    dev = fm1.device
    valid = ((torch.arange(hv, device=dev)[None, :, None] < coord1[:, 2, None, None])
             & (torch.arange(wv, device=dev)[None, None, :] < coord1[:, 3, None, None]))
    dot = (f1 * f2).sum(dim=-1)
    n12 = torch.linalg.vector_norm(f1, dim=-1) * torch.linalg.vector_norm(f2, dim=-1)
    cos = dot / torch.clamp(n12, min=1e-8)
    count = torch.clamp(valid.sum(dim=(1, 2)), min=1)
    per = torch.where(valid, cos, torch.zeros_like(cos)).sum(dim=(1, 2)) / count
    return batch_mean(1.0 - per, group)
