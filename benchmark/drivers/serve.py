"""What the serving cells share: the seed's weights in the reference and
the program, the engine's stream fed for a fixed time, a traced stretch, the
device-only rate, and the choice of batches the reference checks."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import gen, trace, weights
from benchmark.reference import tf32

DEVICE_EXEC_CALLS = 10  # chained device-only calls timed together


def program_muscle(config: dict, state: dict, device):
    """The program's MuSCLe for ``config``, built without its host
    initialisation (on the meta device) and loaded with ``state``."""
    from muscle_tpu_torch.models import MuSCLe

    with torch.device("meta"):
        model = MuSCLe(num_classes=config["num_classes"], backbone_name=config["backbone"],
                       bifpn_layers=config["bifpn_layers"],
                       bifpn_channels=config["bifpn_channels"],
                       last_pooling=config["last_pooling"], mode=config["mode"],
                       fuse_mbconv=config["fuse_mbconv"])
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model


class ServeDriver:
    """A serving cell.  Subclasses give ``make_engine`` and
    ``reference_batch``/``readings``; the window feeds the batches after the
    warm-up's, in order, until ``seconds`` have passed and counts every image
    whose records came back."""

    units = "images"

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int, device,
                 group=None):
        if group is not None:
            raise ValueError("the serving cells run on one card")
        self.cell, self.config, self.t, self.seed = cell, config, traffic, seed
        self.device = torch.device(device)
        self.records: dict[int, list] = {}
        self.stretch_batches: list[int] = []
        self.device_only = None

    # ---- set-up ------------------------------------------------------------

    def setup(self) -> None:
        clock = trace.Phases()
        self.traffic = gen.ImageTraffic(self.t, self.seed, self.device)
        clock.mark("traffic")
        self.reference = weights.make(self.config, self.seed, self.device,
                                      self.traffic.pools[0][:2])
        clock.mark("weights")
        model = program_muscle(self.config, self.reference.state_dict(), self.device)
        self.reference.to("cpu")
        self.engine = self.make_engine(model)
        clock.mark("program")
        if self.config["fuse_mbconv"] and self.device.type == "cuda":
            # the MBConv library, built by nvcc in a checkout's first run and
            # loaded after: timed apart from the warm-up
            from muscle_tpu_torch.ops import build

            build.load("mbconv")
            clock.mark("kernels")
        # every shape the traffic uses: each size's canvases, twice
        warm = [self.fed(i) for i in range(len(self.traffic.sizes) * 2)]
        for _ in self.engine.run_stream(iter(warm)):
            pass
        self._sync()
        clock.mark("warm-up")
        self.phases = clock.seconds

    def fed(self, i: int) -> tuple:
        """What the engine's stream takes of batch i."""
        return self.traffic.batch(i)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- the measured window ---------------------------------------------------

    def window(self, seconds: float) -> dict:
        first = len(self.traffic.sizes) * 2  # the warm-up's batches came before
        t0 = time.perf_counter()
        deadline = t0 + seconds

        count = [0]

        def feed():
            while time.perf_counter() < deadline:
                batch = self.fed(first + count[0])
                count[0] += 1
                yield batch

        n = 0
        by_size: dict[tuple, int] = {}
        for k, recs in enumerate(self.engine.run_stream(feed())):
            self.records[first + k] = recs
            n += len(recs)
            size = self.traffic.sizes[(first + k) % len(self.traffic.sizes)]
            by_size[size] = by_size.get(size, 0) + len(recs)
        secs = time.perf_counter() - t0
        self.next_batch = first + len(self.records)
        return {"images": n, "seconds": secs, "images_by_size": by_size,
                "attempted": count[0] * self.t["batch"]}

    # ---- trace -----------------------------------------------------------------

    def stretch(self) -> trace.Summary:
        """The engine's device-only rate, then ``trace_batches`` more batches
        through the stream under the profiler."""
        idx = list(range(self.next_batch, self.next_batch + self.t["trace_batches"]))
        self.stretch_batches = idx
        batches = [self.fed(i) for i in idx]
        self.device_only = self._device_only(batches[0])

        def run():
            for _ in self.engine.run_stream(iter(batches)):
                pass

        return trace.profile(run, self.device, units=sum(len(b[0]) for b in batches))

    def _device_only(self, batch) -> float | None:
        """Images a second of the engine's device pipeline alone
        (``bench_device_exec``), over DEVICE_EXEC_CALLS chained calls
        timed with CUDA events, after one untimed call."""
        if self.device.type != "cuda":
            return None
        fn = self.device_exec(batch)
        fn()
        self._sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(DEVICE_EXEC_CALLS):
            fn()
        end.record()
        end.synchronize()
        return DEVICE_EXEC_CALLS * len(batch[0]) / (start.elapsed_time(end) / 1e3)

    def stretch_sizes(self) -> list[list[tuple[int, int]]]:
        """(h, w) of each image of each traced batch."""
        return [[img.shape[:2] for img in self.traffic.batch(i)[0]]
                for i in self.stretch_batches]

    # ---- the check ---------------------------------------------------------------

    def free(self) -> None:
        del self.engine
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list[int]:
        """The window's batches the reference checks, drawn from the seed."""
        done = sorted(self.records)
        k = min(self.t["check_batches"], len(done))
        rng = np.random.default_rng([self.seed % 2 ** 63, 104729])
        return sorted(int(i) for i in rng.choice(done, size=k, replace=False))

    def check(self, control: bool = False):
        """The readings of the program's records against the reference's
        on the sampled batches; with ``control``, also {'control': those of
        the reference at TF32 against the reference's}."""
        self.reference.to(self.device)
        got, ctrl = [], []
        for i in self.sample():
            batch = self.traffic.batch(i)
            want = self.reference_batch(self.reference, batch)
            got.append((self.records[i], want))
            if control:
                with tf32():
                    ctrl.append((self.reference_batch(self.reference, batch), want))
        return self.readings(got), ({"control": self.readings(ctrl)} if control else None)
