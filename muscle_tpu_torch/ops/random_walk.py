"""Affinity random-walk CAM refinement (port of
``muscle_tpu/ops/random_walk.py``).

The IRN edge map defines pixel-pair affinities along short paths (radius
5); the affinities become a column-stochastic transition matrix T whose
2^exp_times-step walk ``x <- x @ T`` propagates CAM mass away from class
boundaries.  Every walk takes a batch: cams (B, C, h, w) and edges
(B, h, w) (or one image, (C, h, w) and (h, w)).

Methods of ``propagate_to_edge``:

* 'stencil' (default): no V x V matrix.  Each direction d's pairs lie on
  one diagonal of T, so the affinities are shifted-slice maxima of the
  edge map and a step is a 2*D-term spatial stencil, run by the CUDA
  kernel ``ops/stencil_walk.py`` on a card;
* 'banded': T built dense and walked by the CUDA kernel
  ``ops/banded_walk.py`` over its band only;
* 'vector': T built dense, 2^exp_times ``torch.matmul`` steps;
* 'power': T squared exp_times times (the reference's formulation).

``kernel`` (stencil and banded): None launches the CUDA kernel for CUDA
tensors and runs its plain version for CPU tensors; False runs the plain
version on any device (for comparisons on the card).

``propagate_to_edge_sharded`` walks with T column-sharded over the ranks
of a process group (the V x V matrix is the only memory-quadratic
operand).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from muscle_tpu_torch.ops.banded_walk import banded_walk, banded_walk_plain, walk_band
from muscle_tpu_torch.ops.stencil_walk import shift2d, stencil_walk, stencil_walk_plain
from muscle_tpu_torch.parallel.mesh import all_gather, rank, world


def _directions(radius: int) -> list[tuple[int, int]]:
    """Search directions: strictly right on the first row, then every
    (y > 0, x) inside the disc."""
    dirs = [(0, x) for x in range(1, radius)]
    for y in range(1, radius):
        for x in range(-radius + 1, radius):
            if x * x + y * y < radius * radius:
                dirs.append((y, x))
    return dirs


def _path_cells(dy: int, dx: int) -> list[list[int]]:
    """Cells within distance 1 of the segment (0, 0) -> (dy, dx), row-major."""
    length_sq = dy * dy + dx * dx
    cells = []
    for y in range(min(0, dy), max(0, dy) + 1):
        for x in range(min(0, dx), max(0, dx) + 1):
            if (dy * x - dx * y) ** 2 / length_sq < 1:
                cells.append([y, x])
    return cells


class PathIndex:
    """Host-side enumeration of pixel pairs within ``radius`` grouped by
    path length, with per-path pixel index tables over a padded grid."""

    def __init__(self, radius: int, size: tuple[int, int]):
        self.radius = radius
        self.radius_floor = int(np.ceil(radius) - 1)
        self.size = tuple(size)

        paths_by_len: dict[int, list[list[list[int]]]] = {}
        for dy, dx in _directions(radius):
            coords = sorted(_path_cells(dy, dx), key=lambda c: -abs(c[0]) - abs(c[1]))  # far to near
            paths_by_len.setdefault(len(coords), []).append(coords)
        self.search_paths = [np.asarray(v) for _, v in sorted(paths_by_len.items()) if v]
        # (D, 2) offset (dy, dx) of each direction, in the pairs' order
        self.search_dst = np.concatenate([p[:, 0] for p in self.search_paths], axis=0)

        h, w = self.size
        full = np.arange(h * w, dtype=np.int64).reshape(h, w)
        rf = self.radius_floor
        ch, cw = h - rf, w - 2 * rf
        self.path_indices = []
        for paths in self.search_paths:
            group = [[full[dy: dy + ch, rf + dx: rf + dx + cw].reshape(-1) for dy, dx in path]
                     for path in paths]
            self.path_indices.append(np.asarray(group))  # (n_dirs, plen, P)
        self.src_indices = full[:ch, rf: rf + cw].reshape(-1)
        self.dst_indices = np.concatenate([p[:, 0] for p in self.path_indices], axis=0)
        self.n_vertices = h * w


@functools.lru_cache(maxsize=8)
def _cached_path_index(radius: int, size: tuple[int, int]) -> PathIndex:
    return PathIndex(radius, size)


@functools.lru_cache(maxsize=8)
def _cached_cropped_pairs(radius: int, hw: tuple[int, int]):
    """Pair indices translated from the padded walk grid into the cropped
    (h*w, h*w) matrix.  Returns (sel, rows, cols): ``sel`` indexes the
    flattened (D*P,) affinity vector; rows/cols are symmetric scatter
    targets (each kept pair appears twice)."""
    h, w = hw
    hp, wp = h + radius, w + 2 * radius
    pi = _cached_path_index(radius, (hp, wp))
    src = np.broadcast_to(pi.src_indices[None, :], pi.dst_indices.shape).reshape(-1)
    dst = pi.dst_indices.reshape(-1)

    def to_cropped(idx):
        r, c = idx // wp, idx % wp
        valid = (r < h) & (c >= radius) & (c < radius + w)
        return r * w + (c - radius), valid

    s_idx, s_ok = to_cropped(src)
    d_idx, d_ok = to_cropped(dst)
    keep = s_ok & d_ok
    sel = np.nonzero(keep)[0]
    rows = np.concatenate([s_idx[keep], d_idx[keep]])
    cols = np.concatenate([d_idx[keep], s_idx[keep]])
    return sel, rows, cols


def edge_to_affinity(edge_flat: torch.Tensor, path_index: PathIndex) -> torch.Tensor:
    """affinity(src, dst) = 1 - max(edge along the path).  edge_flat: (..., V)
    padded edge map flattened; returns (..., D, P)."""
    affs = []
    for group in path_index.path_indices:
        ind = torch.as_tensor(group, device=edge_flat.device)  # (n_dirs, plen, P)
        affs.append(1.0 - torch.amax(edge_flat[..., ind], dim=-2))
    return torch.cat(affs, dim=-2)


def affinity_to_dense(aff: torch.Tensor, path_index: PathIndex) -> torch.Tensor:
    """The symmetric dense (V, V) affinity with a unit diagonal from the
    pairs' affinities ``aff`` (D, P) of ``edge_to_affinity`` (the
    reference's dense build; the walks never make it)."""
    v = path_index.n_vertices
    src = np.broadcast_to(path_index.src_indices[None, :],
                          path_index.dst_indices.shape).reshape(-1)
    dst = path_index.dst_indices.reshape(-1)
    rows = torch.as_tensor(np.concatenate([src, dst]), device=aff.device)
    cols = torch.as_tensor(np.concatenate([dst, src]), device=aff.device)
    dense = torch.zeros((v, v), dtype=aff.dtype, device=aff.device)
    dense.index_put_((rows, cols), torch.cat([aff.reshape(-1)] * 2), accumulate=True)
    return dense + torch.eye(v, dtype=aff.dtype, device=aff.device)


def to_transition_matrix(dense_aff: torch.Tensor, beta: int, times: int) -> torch.Tensor:
    """aff^beta normalised over each column, squared ``times`` times (the
    reference's transition matrix)."""
    scaled = dense_aff ** beta
    trans = scaled / scaled.sum(dim=0, keepdim=True)
    for _ in range(times):
        trans = trans @ trans
    return trans


def _pair_weights(edge: torch.Tensor, radius: int, beta: int):
    """(rows, cols, weights (B, P), colsum (B, V)) of (B, h, w) edges: the
    off-diagonal entries T[rows, cols] = weights / colsum[cols] of the
    transition matrices, the diagonal 1 / colsum."""
    b, h, w = edge.shape
    dev = edge.device
    pi = _cached_path_index(radius, (h + radius, w + 2 * radius))
    edge_padded = F.pad(edge, (radius, radius, 0, radius), value=1.0).reshape(b, -1)
    aff = edge_to_affinity(edge_padded, pi).reshape(b, -1)
    sel, rows_np, cols_np = _cached_cropped_pairs(radius, (h, w))
    rows = torch.as_tensor(rows_np, device=dev)
    cols = torch.as_tensor(cols_np, device=dev)
    vals = aff[:, torch.as_tensor(sel, device=dev)]
    vals_b = torch.cat([vals, vals], dim=1) ** beta
    colsum = torch.ones((b, h * w), dtype=vals_b.dtype, device=dev).index_add_(1, cols, vals_b)
    return rows, cols, vals_b, colsum


def transition_matrices(edge: torch.Tensor, radius: int = 5, beta: int = 8) -> torch.Tensor:
    """(B, V, V) column-stochastic transition matrices of (B, h, w) edges,
    scattered straight into the cropped grid: the beta power and the column
    sums run on the sparse pair values, not on the dense matrix."""
    b, h, w = edge.shape
    v = h * w
    dev = edge.device
    rows, cols, vals_b, colsum = _pair_weights(edge, radius, beta)
    trans = torch.zeros((b, v, v), dtype=vals_b.dtype, device=dev)
    bi = torch.arange(b, device=dev)[:, None]
    trans.index_put_((bi, rows[None], cols[None]), vals_b / colsum[:, cols], accumulate=True)
    idx = torch.arange(v, device=dev)
    trans[:, idx, idx] += 1.0 / colsum
    return trans


def transition_csr(edge: torch.Tensor, radius: int = 5, beta: int = 8) -> torch.Tensor:
    """The transposes of the (B, V, V) ``transition_matrices`` of (B, h, w)
    edges as one block-diagonal sparse CSR matrix (B*V, B*V), ~69 nonzeros
    per row: one walk step of x (B, C, V) is ``torch.sparse.mm(csr, xt)``
    with xt = x as (B*V, C).  The stencil kernel's library yardstick in
    ``chip_smoke.py``; no walk method calls it."""
    b, h, w = edge.shape
    v = h * w
    dev = edge.device
    rows, cols, vals_b, colsum = _pair_weights(edge, radius, beta)
    idx = torch.arange(v, device=dev)
    off = (torch.arange(b, device=dev) * v)[:, None]
    # T[i, j] at (j, i) of the transpose, image k's block at rows k*V
    tr = torch.cat([cols[None] + off, idx[None] + off], dim=1).reshape(-1)
    tc = torch.cat([rows[None] + off, idx[None] + off], dim=1).reshape(-1)
    tv = torch.cat([vals_b / colsum[:, cols], 1.0 / colsum], dim=1).reshape(-1)
    coo = torch.sparse_coo_tensor(torch.stack([tr, tc]), tv, (b * v, b * v),
                                  check_invariants=True).coalesce()
    return coo.to_sparse_csr()


def propagate_to_edge(cam: torch.Tensor, edge: torch.Tensor, radius: int = 5, beta: int = 8,
                      exp_times: int = 6, method: str = "stencil",
                      kernel: bool | None = None) -> torch.Tensor:
    """Random-walk CAM propagation.

    Args:
      cam: (B, C, h, w) (or (C, h, w)) downscaled CAM scores.
      edge: (B, h, w) (or (h, w)) boundary probability from IRN.
      method: 'stencil', 'banded', 'vector' or 'power' (module docstring).
      kernel: stencil and banded only; None = the CUDA kernel on a CUDA
        tensor, its plain version on a CPU tensor; False = the plain
        version anywhere.
    Returns:
      the propagated CAMs, shaped like ``cam``.
    """
    single = cam.ndim == 3
    if single:
        cam, edge = cam[None], edge[None]
    if method == "stencil":
        out = propagate_to_edge_stencil(cam, edge, radius, beta, exp_times, kernel=kernel)
        return out[0] if single else out
    b, c, h, w = cam.shape
    trans = transition_matrices(edge, radius, beta)
    x = (cam * (1.0 - edge)[:, None]).reshape(b, c, h * w)
    steps = 2 ** exp_times
    if method == "power":
        for _ in range(exp_times):
            trans = trans @ trans
        rw = x @ trans
    elif method == "vector":
        rw = x
        for _ in range(steps):
            rw = rw @ trans
    elif method == "banded":
        walk = banded_walk if kernel is not False else banded_walk_plain
        rw = walk(x.contiguous(), trans, steps=steps, band=walk_band(w, radius))
    else:
        raise ValueError(f"unknown method {method!r}")
    rw = rw.reshape(b, c, h, w)
    return rw[0] if single else rw


def transition_columns(edge: torch.Tensor, cols: slice, radius: int = 5,
                       beta: int = 8) -> torch.Tensor:
    """Columns ``cols`` (V, len) of one (h, w) edge map's transition
    matrix: each column is normalised by its own sum, so a column block
    needs no other block."""
    h, w = edge.shape
    v = h * w
    rows, pair_cols, vals_b, colsum = _pair_weights(edge[None], radius, beta)
    c0, c1 = cols.start, cols.stop
    keep = (pair_cols >= c0) & (pair_cols < c1)
    block = torch.zeros((v, c1 - c0), dtype=vals_b.dtype, device=edge.device)
    block.index_put_((rows[keep], pair_cols[keep] - c0),
                     vals_b[0, keep] / colsum[0, pair_cols[keep]], accumulate=True)
    idx = torch.arange(c0, c1, device=edge.device)
    block[idx, idx - c0] += 1.0 / colsum[0, c0:c1]
    return block


def propagate_to_edge_sharded(cam: torch.Tensor, edge: torch.Tensor, group, radius: int = 5,
                              beta: int = 8, exp_times: int = 6) -> torch.Tensor:
    """The random walk of one image with its (V, V) transition matrix
    column-sharded over the ranks of ``group`` (port of the JAX package's
    ``propagate_to_edge_sharded`` over a mesh axis).  Each rank builds
    only its V / W columns of the beta-powered, column-normalised T (the
    column norm is local), and each of the 2^exp_times steps computes this
    rank's columns of x @ T and all-gathers the small (C, V) iterate.

    cam (C, h, w), edge (h, w), on this rank's device; every rank passes
    the same.  Returns the (C, h, w) walk, the same on every rank.  Raises
    ValueError unless W divides V = h * w."""
    c, h, w = cam.shape
    v, n = h * w, world(group)
    if v % n:
        raise ValueError(f"V={v} not divisible by the {n} ranks")
    per = v // n
    trans = transition_columns(edge, slice(rank(group) * per, (rank(group) + 1) * per),
                               radius, beta)
    x = (cam * (1.0 - edge)[None]).reshape(c, v)
    for _ in range(2 ** exp_times):
        # the gather concatenates rows: gather x @ T_block's transpose
        x = all_gather((x @ trans).T.contiguous(), group).T
    return x.reshape(c, h, w)


@functools.lru_cache(maxsize=8)
def _direction_tables(radius: int):
    """Per direction (dy, dx) its path cell offsets (the same enumeration
    as PathIndex)."""
    return tuple((dy, dx, tuple(tuple(c) for c in _path_cells(dy, dx)))
                 for dy, dx in _directions(radius))


def stencil_operands(edge: torch.Tensor, radius: int = 5, beta: int = 8):
    """(vs (B, D, h, w) beta-powered affinities per direction, inv (B, h, w)
    reciprocal column sums, the ((dy, dx), ...) direction table) of (B, h, w)
    edges: the stencil walk's operands.  Pairs whose path leaves
    the grid see edge 1.0 in the padding, hence affinity 0: the cropped-pair
    drop of the matrix build, expressed as zeros."""
    _, h, w = edge.shape
    edge_pad = F.pad(edge, (radius, radius, 0, radius), value=1.0)
    vs = []
    for _, _, cells in _direction_tables(radius):
        m = None
        for py, px in cells:
            s = edge_pad[:, py: py + h, radius + px: radius + px + w]
            m = s if m is None else torch.maximum(m, s)
        vs.append((1.0 - m) ** beta)
    vs = torch.stack(vs, dim=1)
    colsum = torch.ones_like(edge)  # unit diagonal, 1^beta
    dirs = tuple((dy, dx) for dy, dx, _ in _direction_tables(radius))
    for d, (dy, dx) in enumerate(dirs):
        colsum = colsum + vs[:, d] + shift2d(vs[:, d], dy, dx)
    return vs.contiguous(), (1.0 / colsum).contiguous(), dirs


def propagate_to_edge_stencil(cam: torch.Tensor, edge: torch.Tensor, radius: int = 5,
                              beta: int = 8, exp_times: int = 6,
                              kernel: bool | None = None) -> torch.Tensor:
    """The stencil walk on a batch: cam (B, C, h, w), edge (B, h, w).

    Per step, for x <- x @ T with column sums col:
      x'[p] = (x[p] + sum_d x[p-d] * v_d[p-d] + x[p+d] * v_d[p]) / col[p]
    with out-of-grid neighbours contributing zero.  The construction
    (shifted-slice maxima, sums) is plain tensor code; the 2^exp_times
    steps run in ``stencil_walk``."""
    vs, inv, dirs = stencil_operands(edge, radius, beta)
    x = (cam * (1.0 - edge)[:, None]).contiguous()
    walk = stencil_walk if kernel is not False else stencil_walk_plain
    return walk(x, vs, inv, dirs=dirs, steps=2 ** exp_times)
