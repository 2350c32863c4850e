"""Per-loss-term liveness (port of ``muscle_tpu/training/liveness.py``).

A term whose value is small can still be a live training signal, and a
term whose value is O(1) can be a dead path (a detach in the wrong place);
only its gradient tells them apart.

* ``jacrev``: per-term parameter-gradient norms, one ``autograd.grad``
  per term over one forward.
* ``jvp``: per-term |directional derivative| along one tangent, all terms
  in one forward-mode pass (``torch.func.jvp``).  A dead path gives
  exactly 0 for every tangent, a live one is nonzero almost surely.
"""

from __future__ import annotations

import torch


def random_tangents(params: dict[str, torch.Tensor], seed: int = 0) -> dict[str, torch.Tensor]:
    """Standard-normal tangents shaped like ``params``, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen, dtype=v.dtype).to(v.device)
            for k, v in params.items()}


def term_liveness(stacked, n_terms: int, params: dict[str, torch.Tensor],
                  method: str = "jacrev", tangents: dict[str, torch.Tensor] | None = None):
    """``stacked(params) -> (n_terms,)`` losses, ``params`` a dict of
    tensors.  Returns ((n_terms,) values, (n_terms,) liveness): the
    gradient norm over all of ``params`` ('jacrev') or the
    |directional derivative| along ``tangents`` ('jvp'; seeded normal
    ones when None).  The values tell a dead path (value nonzero,
    liveness exactly 0) from a term not engaged on this batch (value 0)."""
    if method == "jacrev":
        leaves = [p.detach().requires_grad_(True) for p in params.values()]
        vals = stacked(dict(zip(params, leaves)))
        norms = []
        for i in range(n_terms):
            grads = torch.autograd.grad(vals[i], leaves, retain_graph=i + 1 < n_terms,
                                        allow_unused=True)
            sq = sum(((g.double() ** 2).sum() for g in grads if g is not None),
                     torch.zeros((), dtype=torch.float64, device=vals.device))
            norms.append(torch.sqrt(sq).to(vals.dtype))
        return vals.detach(), torch.stack(norms)
    if method != "jvp":
        raise ValueError(f"unknown liveness method {method!r}")
    if tangents is None:
        tangents = random_tangents(params)
    primals = {k: v.detach() for k, v in params.items()}
    vals, t = torch.func.jvp(stacked, (primals,), (dict(tangents),))
    return vals.detach(), t.abs().detach()
