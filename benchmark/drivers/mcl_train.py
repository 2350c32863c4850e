"""MCL training step A (``mcl_train_step``, the ``train_mcl`` loop from
epoch 4) with Adam, as the CLI drives it: each step's batch uploaded from
host arrays, the metrics fetched every ``log_every`` steps.  On several
cards (a ``group``), as ``train_mcl`` runs under torchrun: the model
``replicate``d, each rank stepping its rows of the global batch; the
window then ends at a metric fetch, where rank 0's clock decides for all.

Set-up builds the one model and optimizer the window then drives, and runs
its first REFERENCE_STEPS steps through the window's own call and feed
on distinct batches.  The reference follows those steps from the same
weights and drop-connect seed, and the check compares, each as the worst
over the steps or the leaves:

* ``loss_gap``: each step's loss, relative to the reference's;
* ``grad_gap``: each trained leaf's gradient norm as Adam took it in step
  1 (the program's from its first moment, m / (1 - beta1)), against the
  reference's, relative to the larger of that leaf's norm and the median
  leaf's;
* ``change_gap``: each leaf's change after the steps (parameters, and the
  batch norms' running statistics), the same way; parameters whose
  reference gradient is under a thousandth of the median leaf's are left
  out (they move by round-off alone under Adam).
"""

from __future__ import annotations

import gc
import statistics
import time

import torch
import torch.distributed as dist

from benchmark import gen, trace, weights
from benchmark.drivers.serve import program_muscle
from benchmark.reference import mcl as ref_mcl
from benchmark.reference import tf32

REFERENCE_STEPS = 3  # the steps the reference follows


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def _gaps(got: dict, want: dict, keys) -> dict:
    """|got - want| of each of ``keys``, against the larger of its own
    reference norm and the median one."""
    med = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys}


def _worst(gaps: dict) -> tuple[float, str]:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def _stats(model) -> dict:
    return {n: b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))}


class Driver:
    units = "steps"

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int, device,
                 group=None):
        self.cell, self.config, self.t, self.seed = cell, config, traffic, seed
        self.device = torch.device(device)
        self.group = group
        r, w = (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))
        n = traffic["batch"] // w  # traffic['batch'] is the global batch
        self.rows = slice(r * n, (r + 1) * n)

    def _rows(self, i: int) -> dict:
        """This rank's rows of global batch i (host arrays)."""
        return {k: v[self.rows] for k, v in self.traffic.batch(i).items()}

    def _step(self, i: int) -> dict:
        from muscle_tpu_torch.inference.upload import to_device
        from muscle_tpu_torch.training import mcl_train_step

        dev = {k: to_device(v, self.device) for k, v in self._rows(i).items()}
        return mcl_train_step(self.model, self.opt, dev, self.cfg, self.gen, group=self.group)

    def setup(self) -> None:
        from muscle_tpu_torch.parallel import replicate
        from muscle_tpu_torch.training import MCLConfig, make_adam

        clock = trace.Phases()
        self.traffic = gen.TrainTraffic(self.t, self.seed, self.device)
        clock.mark("traffic")
        self.reference = weights.make(self.config, self.seed, self.device)
        clock.mark("weights")
        self.model = program_muscle(self.config, self.reference.state_dict(), self.device)
        self.reference.to("cpu")  # the seed's weights, kept off the card for the check
        replicate(self.model, self.group)
        self.opt = make_adam(self.model.trained_parameters(), self.t["lr"],
                             self.t["weight_decay"])
        clock.mark("program")
        self.cfg = MCLConfig(use_imc=self.t["use_imc"])
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed % 2 ** 63)
        names = {id(p): n for n, p in self.model.named_parameters()}
        self.losses = []
        for i in range(REFERENCE_STEPS):
            self.losses.append(float(self._step(i)["loss"]))
            if i == 0:
                # Adam's first moment after one step is (1 - beta1) g
                self.grads = _norms({
                    names[id(p)]: self.opt.state.get(p, {}).get("exp_avg", torch.zeros(1)) / 0.1
                    for p in self.model.trained_parameters()})
        start = dict(self.reference.named_parameters()) | _stats(self.reference)
        now = {names[id(p)]: p for p in self.model.trained_parameters()} | _stats(self.model)
        self.changes = _norms({k: v.detach() - start[k].detach().to(self.device)
                               for k, v in now.items()})
        self.step_no = REFERENCE_STEPS
        self._sync()
        clock.mark("first steps")
        self.phases = clock.seconds

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stop(self, deadline: float) -> bool:
        """Whether the window is over: on one card at any step; over ranks
        at a metric fetch, by rank 0's clock, so every rank steps alike."""
        if self.group is None:
            return time.perf_counter() >= deadline
        if self.step_no % self.t["log_every"]:
            return False
        flag = torch.tensor([float(time.perf_counter() >= deadline)], device=self.device)
        dist.broadcast(flag, dist.get_global_rank(self.group, 0), group=self.group)
        return bool(flag.item())

    def _run(self, until) -> tuple[int, list]:
        """Steps until ``until(steps done)`` is true; (steps, per-step start
        events)."""
        cuda = self.device.type == "cuda"
        marks, n = [], 0
        while not until(n):
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            else:
                marks.append(time.perf_counter())
            metrics = self._step(self.step_no)
            if self.step_no % self.t["log_every"] == 0:  # the CLI's log line waits for them
                self.fetched = [float(v) for v in metrics.values()]
            self.step_no += 1
            n += 1
        return n, marks

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n, marks = self._run(lambda _: self._stop(deadline))
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:] + [end])]
        else:
            stamps = marks + [time.perf_counter()]
            ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        secs = time.perf_counter() - t0
        # images over all ranks: the global batch a step
        return {"steps": n, "images": n * self.t["batch"], "seconds": secs, "step_ms": ms,
                "attempted": n * self.t["batch"]}

    def stretch(self) -> trace.Summary:
        k = self.t["trace_steps"]
        return trace.profile(lambda: self._run(lambda n: n >= k), self.device, units=k)

    def free(self) -> None:
        del self.model, self.opt
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def follow(self, half: bool = False, exchange: bool = True) -> tuple[list, dict, dict]:
        """The reference's first steps from the seed's weights and
        drop-connect seed, over the ranks as the program ran: (losses,
        step-1 gradient norms, change norms).  Faults planted in the
        reference: ``half``, each step on the first half of its rows;
        ``exchange=False``, each rank on its own rows alone."""
        group = self.group if exchange else None
        model = weights.reference_model(self.config).to_empty(device=self.device)
        model.load_state_dict(self.reference.state_dict())
        params = dict(model.trained_parameters())
        start = {k: v.detach().clone() for k, v in (params | _stats(model)).items()}
        opt = ref_mcl.Adam(params.values(), self.t["lr"], self.t["weight_decay"])
        g = torch.Generator(device=self.device).manual_seed(self.seed % 2 ** 63)
        losses, grads = [], None
        for i in range(REFERENCE_STEPS):
            rows = slice(0, self.rows.stop - self.rows.start if not half
                         else (self.rows.stop - self.rows.start) // 2)
            batch = {k: torch.from_numpy(v[rows]).to(self.device)
                     for k, v in self._rows(i).items()}
            loss, taken = ref_mcl.step(model, opt, batch, g, group)
            losses.append(loss)
            if i == 0:
                grads = _norms(dict(zip(params, taken)))
        changes = _norms({k: v.detach() - start[k] for k, v in (params | _stats(model)).items()})
        return losses, grads, changes

    @staticmethod
    def readings(got, want) -> dict:
        """The numbers compared, of ``got``'s steps against ``want``'s."""
        (gl, gg, gc_), (wl, wg, wc) = got, want
        med = statistics.median(wg.values())
        moved = [k for k in wc if k not in wg or wg[k] >= 1e-3 * med]
        grad_gap, grad_leaf = _worst(_gaps(gg, wg, list(wg)))
        change_gap, change_leaf = _worst(_gaps(gc_, wc, moved))
        return {"whole": all(torch.isfinite(torch.tensor(gl)).tolist()),
                "loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(gl, wl)),
                "grad_gap": grad_gap, "change_gap": change_gap,
                "worst_leaves": [grad_leaf, change_leaf]}

    def check(self, control: bool = False):
        """The program's readings against the reference; with ``control``,
        also the control's (the reference at TF32) and a planted fault's
        (half of each batch left out)."""
        want = self.follow()
        got = self.readings((self.losses, self.grads, self.changes), want)
        if not control:
            return got, None
        with tf32():
            ctrl = self.readings(self.follow(), want)
        planted = {"control": ctrl, "half_batch": self.readings(self.follow(half=True), want)}
        if self.group is not None:
            planted["no_exchange"] = self.readings(self.follow(exchange=False), want)
        return got, planted
