"""Threaded prefetching batch loader (port of ``muscle_tpu/data/loader.py``).

Decode and augmentation run on a pool of host threads while the previous
step runs on the card.  Each sample draws from its own numpy Generator,
spawned from one ``SeedSequence([seed, epoch, shard])`` as in the JAX
package, so one seed gives the same batches in both packages; the index
stream is sliced per shard for data parallelism.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _collate(samples: list[dict]) -> dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class PrefetchLoader:
    """Iterate shuffled, collated batches of ``dataset.get(idx, rng)`` dicts.

    Args:
      dataset: object with __len__ and get(idx, rng) -> dict of arrays.
      batch_size: per-process batch size.
      seed: stream seed; the epoch number is added to reshuffle per epoch.
      shard: (index, count) of this process's share of the index stream.
      drop_last: drop the trailing partial batch (the reference's setting).
      sample_weights: optional per-sample weights: draw with replacement
        (WeightedRandomSampler) instead of shuffling.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0, shuffle: bool = True,
                 drop_last: bool = True, num_threads: int = 8, prefetch: int = 4,
                 shard: tuple[int, int] = (0, 1), sample_weights=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.shard = shard
        self.sample_weights = (
            None if sample_weights is None else np.asarray(sample_weights, np.float64))

    def _indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + epoch)
        if self.sample_weights is not None:
            p = self.sample_weights / self.sample_weights.sum()
            idx = rng.choice(n, size=n, replace=True, p=p)
        elif self.shuffle:
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        pi, pc = self.shard
        return idx[pi::pc]

    def epoch(self, epoch: int = 0):
        """Yield the collated batches of one epoch."""
        idx = self._indices(epoch)
        bs = self.batch_size
        n_batches = len(idx) // bs if self.drop_last else (len(idx) + bs - 1) // bs
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                base = np.random.SeedSequence([self.seed, epoch, self.shard[0]])
                rngs = [np.random.default_rng(s) for s in base.spawn(len(idx))]
                with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        chunk = idx[b * bs: (b + 1) * bs]
                        samples = list(ex.map(
                            lambda args: self.dataset.get(int(args[0]), args[1]),
                            zip(chunk, rngs[b * bs: (b + 1) * bs])))
                        q.put(_collate(samples))
                q.put(None)
            except BaseException as e:  # handed to the consumer, which raises it
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
