"""Rank bodies of the data-parallel tests (test_torch_parallel.py,
test_torch_dp_train.py).  The ranks are spawned CPU processes joined over
gloo through a FileStore; they import this module and the port only (never
JAX or tests/conftest.py).  ``launch`` runs a body on every rank and
returns what each rank returned."""

from __future__ import annotations

import contextlib
import copy
import os

import numpy as np
import torch

from muscle_tpu_torch import parallel
from muscle_tpu_torch.parallel import mesh


def launch(body, world: int, tmp_path, spec) -> list:
    """Run ``body(group, spec)`` on ``world`` spawned gloo ranks; ``spec``
    is saved once and loaded by every rank.  Returns each rank's result."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path)
    torch.save(spec, os.path.join(tmp, "spec.pt"))
    mp.spawn(_entry, args=(world, tmp, body), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank: int, world: int, tmp: str, body) -> None:
    torch.set_num_threads(1)
    group = parallel.init(rank, world, f"file://{tmp}/store", "cpu", backend="gloo")
    spec = torch.load(os.path.join(tmp, "spec.pt"), weights_only=False)
    out = body(group, spec)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    parallel.barrier(group)
    parallel.shutdown(group)


def rows(a, group):
    """This rank's rows of a global numpy batch, as a tensor."""
    a = np.asarray(a)
    return torch.from_numpy(a[parallel.local_batch_slice(a.shape[0], parallel.rank(group),
                                                         parallel.world(group))].copy())


# ---- module-level checks (test_torch_parallel.py) ---------------------------------------


def module_checks(group, spec: dict) -> dict:
    """The cross-rank batch norm (f32, bf16), IMC, ER, the IRN losses and
    the column-sharded walk on this rank's rows of ``spec``'s global
    inputs: each result as this rank's share or rows."""
    from muscle_tpu_torch.losses import er_topk_loss, image_level_contrast
    from muscle_tpu_torch.models.efficientnet import BatchNorm2d
    from muscle_tpu_torch.ops.random_walk import PathIndex, propagate_to_edge_sharded
    from muscle_tpu_torch.ops.sync_bn import sync_bn
    from muscle_tpu_torch.training.irn import irn_losses

    out = {}
    for tag, dtype in (("bn_f32", torch.float32), ("bn_bf16", torch.bfloat16)):
        d = spec["bn"]
        c = d["x"].shape[-1]
        bn = BatchNorm2d(c, eps=1e-3, momentum=0.01)
        with torch.no_grad():
            for name, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                              ("running_var", "var")):
                getattr(bn, name).copy_(torch.from_numpy(d[key]))
        parallel.replicate(bn, group)
        bn.train()
        x = rows(d["x"], group).to(dtype).permute(0, 3, 1, 2).requires_grad_(True)
        y = bn(x)
        y.backward(rows(d["g"], group).to(dtype).permute(0, 3, 1, 2))
        out[tag] = {"y": y.detach().permute(0, 2, 3, 1).float(),
                    "dx": x.grad.permute(0, 2, 3, 1).float(), "dscale": bn.weight.grad,
                    "dbias": bn.bias.grad, "mean": bn.running_mean, "var": bn.running_var,
                    "count": int(bn.num_batches_tracked)}
    out["sync_bn_launches"] = (sync_bn.launches, sync_bn.launches_backward)

    d = spec["imc"]
    emb = rows(d["emb"], group).requires_grad_(True)
    loss = image_level_contrast(emb, rows(d["label"], group), group=group)
    loss.backward()
    out["imc"] = {"loss": loss.detach(), "grad": emb.grad}

    d = spec["er"]
    label = rows(d["label"], group)
    sgcs = rows(d["sgcs"], group).requires_grad_(True)
    loss = er_topk_loss(rows(d["cams"], group), sgcs, parallel.reduced(label.sum(), group),
                        group=group)
    loss.backward()
    out["er"] = {"loss": loss.detach(), "grad": sgcs.grad}

    d = spec["irn"]
    pi = PathIndex(5, (d["grid"], d["grid"]))
    edge = rows(d["edge"], group).requires_grad_(True)
    dp = rows(d["dp"], group).requires_grad_(True)
    total, metrics = irn_losses(edge, dp, *(rows(d[k], group) for k in ("bg", "fg", "neg")), pi,
                                group)
    total.backward()
    out["irn"] = {"metrics": {k: v.detach() for k, v in metrics.items()},
                  "edge_grad": edge.grad, "dp_grad": dp.grad}

    d = spec["walk"]
    out["walk"] = propagate_to_edge_sharded(torch.from_numpy(d["cam"]), torch.from_numpy(d["edge"]),
                                            group, exp_times=d["exp_times"])
    return out


# ---- whole steps (test_torch_dp_train.py) -------------------------------------------------


def build_model(kind: str, state: dict):
    """The b1 MuSCLe ('enc' MCL, 'dec' seg: BiFPN 1 x 64) or IRNNet of the
    steps, loaded from ``state``."""
    from muscle_tpu_torch.models import IRNNet, MuSCLe

    if kind == "enc":
        m = MuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False)
    elif kind == "dec":
        m = MuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1,
                   bifpn_channels=64, last_pooling=True)
    else:
        m = IRNNet()
    m.load_state_dict(state, strict=False)
    return m


def run_step(case: dict, group, control: bool = False) -> dict:
    """One step of ``case`` ('kind': mcl_a, mcl_b, seg or irn) on this
    rank's rows of its global batch (all of it without a group).  Returns
    the global metrics, every trained parameter's gradient and value after
    the update, and the BN running statistics.  control: the naive data
    parallelism instead (local BN statistics, local losses averaged over
    the ranks as DDP averages gradients).  'exchanges': the collectives of
    ``replicate`` and the step as ``parallel.mesh.stats`` counted them and
    as they reached ``torch.distributed``, with the sizes they follow
    from."""
    from muscle_tpu_torch.models.efficientnet import BatchNorm2d

    kind = case["kind"]
    model = build_model({"mcl_a": "enc", "mcl_b": "enc", "seg": "dec", "irn": "irn"}[kind],
                        case["state"])
    if not case.get("drop_connect", True):
        model.backbone.drop_connect_rate = 0.0
    before = copy.deepcopy(mesh.stats)
    with _issued() as issued:
        parallel.replicate(model, group)
        metrics, opt = _step(case, model, group, control)
    counted = {k: {n: mesh.stats[k][n] - before[k][n] for n in v} for k, v in before.items()}
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in opt.param_groups for p in g["params"]]
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    # every rank must hold rank 0's parameters after the step, bit for bit
    ref = flat.clone()
    if group is not None:
        torch.distributed.broadcast(ref, torch.distributed.get_global_rank(group, 0), group=group)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {names[id(p)]: p.grad.clone() for p in params},
            "params": {names[id(p)]: p.detach().clone() for p in params},
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if k.endswith("running_mean") or k.endswith("running_var")},
            "rank_param_diff": float((flat - ref).abs().max()),
            "exchanges": {"counted": counted, "issued": issued,
                          "bn": sum(isinstance(m, BatchNorm2d) for m in model.modules()),
                          "grad_bytes": sum(p.numel() * p.element_size() for p in params),
                          "state_bytes": sum(t.numel() * t.element_size() for t in
                                             [*model.parameters(), *model.buffers()])}}


def _step(case: dict, model, group, control: bool) -> tuple[dict, torch.optim.Optimizer]:
    """``run_step``'s step on the replicated model: (its metrics, the
    optimizer)."""
    from muscle_tpu_torch.training import (
        IRNTrainConfig,
        MCLConfig,
        SegConfig,
        irn_train_step,
        make_adam,
        make_irn_sgd,
        mcl_train_step,
        mcl_views_step,
        minimize,
        seg_train_step,
    )
    from muscle_tpu_torch.training.mcl import _terms_a, decode_image

    kind = case["kind"]
    batch = {k: rows(v, group) if group is not None else torch.from_numpy(np.asarray(v))
             for k, v in case["batch"].items()}
    gen = torch.Generator().manual_seed(case["seed"])
    if kind == "irn":
        opt = make_irn_sgd(model, case["lr"], case["wd"])
        metrics = irn_train_step(model, opt, batch, IRNTrainConfig(crop_size=case["crop"]),
                                 group)
    else:
        opt = make_adam(model.trained_parameters(), case["lr"], case["wd"])
        if control:
            parallel.set_group(model, None)
            model.train()
            t = _terms_a(model, decode_image(batch, "img"), batch["label"],
                         MCLConfig(use_imc=True), gen)
            loss = sum(t.values()) / parallel.world(group)
            minimize(opt, loss, group=group)
            metrics = {"loss": parallel.all_reduce_sum(loss.detach().clone(), group)}
        elif kind == "mcl_a":
            metrics = mcl_train_step(model, opt, batch, MCLConfig(use_imc=True), gen, group=group)
        elif kind == "mcl_b":
            metrics = mcl_views_step(model, opt, batch, MCLConfig(True, True, True), gen,
                                     group=group)
        else:
            metrics = seg_train_step(model, opt, batch, SegConfig(**case["seg_cfg"]), gen,
                                     group=group)
    return metrics, opt


@contextlib.contextmanager
def _issued():
    """{kind: {"calls", "bytes"}} of the all-reduces, all-gathers (list
    form or into one tensor, under either of torch's names) and broadcasts
    that reach ``torch.distributed`` inside the block, the bytes being each
    call's own tensor (an all-gather's input)."""
    import torch.distributed as dist

    out = {k: {"calls": 0, "bytes": 0} for k in ("all_reduce", "all_gather", "broadcast")}
    names = {"all_reduce": ("all_reduce", 0), "broadcast": ("broadcast", 0),
             **{n: ("all_gather", 1) for n in ("all_gather", "all_gather_into_tensor",
                                               "all_gather_single") if hasattr(dist, n)}}
    real = {n: getattr(dist, n) for n in names}

    def counting(name, kind, pos):
        def call(*args, **kw):
            t = args[pos]
            out[kind]["calls"] += 1
            out[kind]["bytes"] += t.numel() * t.element_size()
            return real[name](*args, **kw)

        return call

    for name, (kind, pos) in names.items():
        setattr(dist, name, counting(name, kind, pos))
    try:
        yield out
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def train_checks(group, spec: dict) -> dict:
    """Every case of ``spec['cases']`` on this rank, then the negative
    control on ``spec['control']``; rank 0 keeps the tensors, the other
    ranks their parameter agreement with rank 0."""
    out = {}
    jobs = [(name, case, False) for name, case in spec["cases"].items()]
    jobs.append(("control", spec["control"], True))
    for name, case, control in jobs:
        res = run_step(case, group, control)
        if parallel.rank(group) != 0:
            res = {"rank_param_diff": res["rank_param_diff"]}
        out[name] = res
    return out
