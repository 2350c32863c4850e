"""Data parallelism over ``torch.distributed`` (port of
``muscle_tpu/parallel/mesh.py``).

The JAX package runs its trainers and engines under a ('data',) mesh: the
batch is sharded over the chips and GSPMD computes exactly what one device
computes on the global batch.  The port runs one process per card (launched
by ``torchrun``), each process ("rank") on its slice of every global batch,
and makes each place where the step couples the batch global explicitly:

* train-mode batch norms reduce their statistics and the statistics'
  gradients over the ranks (``models/efficientnet.py`` ``BatchNorm2d``,
  given its group by ``replicate``);
* random draws over the batch draw the global batch's shape from a
  generator seeded alike on every rank and keep this rank's rows
  (``draw_rows``);
* a loss's mean over the batch is this rank's sum over the global count
  (``batch_mean``), and every count a loss divides by is the global one
  (``reduced``); IMC gathers the embeddings (``all_gather``);
* each rank's loss is its share of the global loss, so the sum of the
  ranks' gradients (``training/state.py`` ``minimize``) is the global
  gradient, clipped and applied identically on every rank.

A group of ``None`` means one process: every helper then computes what it
computed before this module existed (no collective, the same launches).

Backends: ``nccl`` where each rank has a card of its own, ``gloo`` on the
CPU and where ranks share a card (``chip_smoke.py`` runs two ranks on one
card; gloo copies CUDA tensors through host memory itself).  Every
exchange is ``all_reduce``, an all-gather into one tensor or
``broadcast``, which both backends take on CUDA and CPU tensors.

Spatial sharding (``make_mesh(model_axis=k)``, the JAX package's
``spatial_sharding``): the ranks form a (W / k data) x (k model) grid, k
consecutive ranks a model group that splits each image's height into k
stripes (``parallel/spatial.py``: halo exchanges and cross-stripe sums in
place of GSPMD's).  The engines' ``mesh=`` shards each batch over the
data axis as the JAX engines' does: each data row runs its share of the
batch and the records are gathered (``data_share``, ``gather_rows``).

``stats`` counts the tensor exchanges this module issues over a group,
{"all_reduce", "all_gather", "broadcast"} -> {"calls", "bytes"}, the bytes
being the payload this rank hands the backend (an all-gather's own part):
``all_reduce_sum``, ``all_reduce_flat`` (one call a flat buffer),
``all_gather_into``, the ``all_gather`` function and its backward's sum,
``replicate``'s broadcast.  Always on, as the kernels' launch counters
are; read it as a difference, or ``reset_stats()``.  The object exchanges
(``gather_rows``, ``broadcast_object``) and ``barrier`` are not counted.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys

import torch
import torch.distributed as dist

# long enough for rank 0's epoch-end eval while the others wait for its mIoU
TIMEOUT = datetime.timedelta(minutes=60)


def init(rank: int, world_size: int, init_method: str, device: torch.device | str,
         backend: str | None = None):
    """Join a process group of ``world_size`` ranks (``init_method``:
    'env://', 'tcp://host:port' or 'file://path') and return it.  backend:
    None takes 'nccl' for a CUDA device (one card per rank) and 'gloo'
    otherwise; ranks that share a card pass 'gloo'.  The backend is named
    on stderr."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=TIMEOUT, **kw)
    print(f"rank {rank}/{world_size}: {backend} on {device}", file=sys.stderr, flush=True)
    return dist.group.WORLD


def init_from_env(device_name: str):
    """(group, device) of a process that ``torchrun`` started, from its
    RANK, LOCAL_RANK and WORLD_SIZE: the rank's device is cuda:<LOCAL_RANK>
    for ``device_name`` 'cuda' (NCCL), the CPU for 'cpu' (gloo).  Raises
    when a rank has no card of its own: ranks never share one silently.
    Without torchrun's variables, or with one rank: (None, device), one
    process as before."""
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    device = torch.device(device_name)
    if world_size == 1:
        return None, device
    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    if device.type == "cuda":
        if device.index is not None:
            raise ValueError(f"--device {device_name}: under torchrun the rank's card is "
                             "cuda:<LOCAL_RANK>; pass --device cuda")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} (local rank {local}) has no card of its own: "
                               f"{torch.cuda.device_count()} visible; launch at most one rank "
                               "per card (torchrun --nproc_per_node)")
        device = torch.device("cuda", local)
    return init(rank, world_size, "env://", device), device


def rank(group=None) -> int:
    """This process's rank in ``group`` (0 for one process)."""
    return 0 if group is None else dist.get_rank(group)


def world(group=None) -> int:
    """The number of ranks in ``group`` (1 for one process)."""
    return 1 if group is None else dist.get_world_size(group)


def local_batch_slice(global_batch: int, process_index: int | None = None,
                      process_count: int | None = None) -> slice:
    """The slice of the global batch this process feeds (the JAX
    package's, with the default process group's rank and size)."""
    on = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if on else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if on else 1) if process_count is None else process_count
    if global_batch % pc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {pc} hosts")
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def rank_rows(n: int, group=None) -> slice:
    """This rank's contiguous share of n items, n // W or one more (the
    first n % W ranks); ``local_batch_slice`` where W divides n.  For
    serving, whose last batch may not divide."""
    r, w = rank(group), world(group)
    return slice(r * n // w, (r + 1) * n // w)


def per_rank_batch(global_batch: int, group=None) -> int:
    """The batch each rank trains on.  The counterpart of
    ``make_data_mesh_for_batch``: where the ranks do not divide the batch
    the JAX package idles chips, but a launched rank cannot idle, so this
    raises."""
    w = world(group)
    if global_batch % w:
        raise ValueError(f"--batch_size {global_batch} is not divisible by the {w} ranks: "
                         "launch a number of ranks that divides it (the JAX package would "
                         "leave devices idle instead)")
    return global_batch // w


stats = {kind: {"calls": 0, "bytes": 0} for kind in ("all_reduce", "all_gather", "broadcast")}


def reset_stats() -> None:
    for counts in stats.values():
        counts["calls"] = counts["bytes"] = 0


def _count(kind: str, t: torch.Tensor) -> None:
    counts = stats[kind]
    counts["calls"] += 1
    counts["bytes"] += t.numel() * t.element_size()


def _coalesced(tensors, op) -> None:
    """Apply ``op`` (in place, on one flat tensor) to ``tensors`` grouped by
    dtype and device, and copy the results back."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 and give
    its batch norms and drop-connect blocks the group (their train-mode
    statistics and draws then span the global batch).  A group of None
    leaves the module as it is."""
    if group is None:
        return module
    with torch.no_grad():
        _coalesced(list(module.parameters()) + list(module.buffers()),
                   lambda flat: _broadcast(flat, dist.get_global_rank(group, 0), group))
    set_group(module, group)
    return module


def _broadcast(flat: torch.Tensor, src: int, group) -> None:
    _count("broadcast", flat)
    dist.broadcast(flat, src, group=group)


def set_group(module: torch.nn.Module, group) -> None:
    """Set the data-parallel group of every submodule that reduces over
    the batch (those with a ``dp_group`` attribute); None makes them local."""
    for m in module.modules():
        if hasattr(m, "dp_group"):
            m.dp_group = group


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it."""
    if group is not None:
        _count("all_reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_flat(tensors, group=None) -> None:
    """Sum every tensor of ``tensors`` over the ranks in place, one
    collective per dtype."""
    if group is not None and tensors:
        _coalesced(tensors, lambda flat: all_reduce_sum(flat, group))


def reduced(x: torch.Tensor, group=None) -> torch.Tensor:
    """A detached copy of ``x`` summed over the ranks (the global value of a
    count or a sum a loss divides by); ``x`` itself for one process."""
    if group is None:
        return x
    return all_reduce_sum(x.detach().clone(), group)


def batch_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch: its
    sum over the global element count (every rank holds as many).  The
    ranks' shares sum to the global mean.  ``x.mean()`` for one process."""
    if group is None:
        return x.mean()
    return x.sum() / (x.numel() * world(group))


def all_gather_into(out: torch.Tensor, part: torch.Tensor, group) -> None:
    """Fill ``out`` (W x ``part``'s rows, contiguous) with every rank's
    ``part`` along dim 0, in rank order, in one collective.  ``part`` may
    be this rank's rows of ``out`` itself (NCCL then gathers in place)."""
    _count("all_gather", part)
    # torch 2.13 renames all_gather_into_tensor all_gather_single and
    # deprecates the old name; earlier versions have only the old one
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, part, group=group)


class _AllGather(torch.autograd.Function):
    """Concatenate every rank's ``x`` along dim 0, in rank order.  The
    backward sums the cotangent over the ranks (each rank's loss took the
    whole gather) and returns this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        x = x.contiguous()
        out = x.new_empty((world(group) * x.shape[0], *x.shape[1:]))
        all_gather_into(out, x, group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g.contiguous().clone(), ctx.group)
        r = rank(ctx.group)
        return g[r * ctx.rows: (r + 1) * ctx.rows], None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 (with gradient);
    ``x`` itself for one process."""
    if group is None:
        return x
    return _AllGather.apply(x, group)


def draw_rows(shape, generator: torch.Generator | None = None, group=None,
              dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """``torch.rand`` of ``shape`` as this rank's rows of one global draw:
    the global batch's shape (W x shape[0] rows) is drawn from
    ``generator``, seeded alike on every rank, and rank r keeps rows
    [r n, (r + 1) n).  W ranks together see the one-process draw."""
    if group is None:
        return torch.rand(shape, generator=generator, dtype=dtype, device=device)
    n, w = shape[0], world(group)
    u = torch.rand((n * w, *shape[1:]), generator=generator, dtype=dtype, device=device)
    r = rank(group)
    return u[r * n: (r + 1) * n]


def data_share(mesh, n: int) -> tuple[slice, bool]:
    """(this rank's share of a batch of n, whether the ranks' shares are
    gathered) under ``mesh``'s data axis, as the JAX engines place a batch:
    sharded over 'data' where the data rows divide n (``rank_rows`` of the
    data group), replicated (every rank the whole batch) where they do not
    or without a mesh."""
    if mesh is None or mesh.data_group is None or n % mesh.shape["data"]:
        return slice(None), False
    return rank_rows(n, mesh.data_group), True


def gather_rows(records: list, group=None) -> list:
    """Every rank's list of ``records`` (picklable) concatenated in rank
    order, on every rank of ``group``; ``records`` for one process."""
    if group is None:
        return records
    parts = [None] * world(group)
    dist.all_gather_object(parts, records, group=group)
    return [r for part in parts for r in part]


def broadcast_object(obj, group=None, src_rank: int = 0):
    """``obj`` (picklable) of the group's rank ``src_rank`` on every rank."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src_rank), group=group)
    return box[0]


def barrier(group=None) -> None:
    if group is not None:
        dist.barrier(group=group)


def shutdown(group=None) -> None:
    """Leave the process group (a no-op for one process)."""
    if group is not None:
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ('data', 'model') grid of ranks of ``make_mesh``: ``shape``
    {'data': W / k, 'model': k}; this rank's coordinates; ``data_group``,
    the ranks that share this rank's model coordinate (one a data row:
    the batch is split over them, ``rank_rows``), and ``model_group``,
    the k ranks of this rank's data row (one image's stripes).  A group
    of one rank is None, as everywhere in this module."""
    shape: dict
    data_index: int
    model_index: int
    data_group: object = None
    model_group: object = None


def make_mesh(model_axis: int = 1) -> Mesh:
    """The counterpart of the JAX package's ``make_mesh(model_axis=k)``
    over the ranks of the default process group (one process without
    one): the ranks reshaped to (W / k, k), so a model group is k
    consecutive ranks.  Every rank calls it, in the same order as its
    other group constructions.  Raises ValueError where k does not divide
    the ranks (one process with k > 1 among them)."""
    on = dist.is_available() and dist.is_initialized()
    n, me = (dist.get_world_size(), dist.get_rank()) if on else (1, 0)
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"{n} ranks not divisible by model axis {model_axis}")
    rows = n // model_axis
    groups = {}
    if model_axis > 1:  # dist.new_group on every rank, for every group
        for d in range(rows):
            ranks = list(range(d * model_axis, (d + 1) * model_axis))
            g = dist.new_group(ranks)
            if me in ranks:
                groups["model"] = g
    if rows > 1:
        for m in range(model_axis):
            ranks = list(range(m, n, model_axis))
            g = dist.new_group(ranks)
            if me in ranks:
                groups["data"] = g
    return Mesh({"data": rows, "model": model_axis}, me // model_axis, me % model_axis,
                groups.get("data"), groups.get("model"))
