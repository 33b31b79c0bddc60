"""Batch loader: host indexing with one prefetch thread.

Counterpart of dahitra_tpu/data/loader.py:19-61. Eval batches come in
dataset order (the reference's eval loader does not shuffle, utils.py:35);
training shuffles every epoch with ``np.random.default_rng(seed)`` (one
generator for the run, a new permutation per epoch), and ``drop_last``
drops a ragged last batch. The host stage is uint8 slicing (augmentation
runs on the device), so one thread keeps the device fed.
``pad_to_multiple`` serves the multi-device path and is not ported yet.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class BatchLoader:
    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        n = len(next(iter(arrays.values())))
        if any(len(v) != n for v in arrays.values()):
            raise ValueError("BatchLoader: arrays differ in length")
        self.arrays = arrays
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def _epoch_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        bs = self.batch_size
        stop = (self.n // bs) * bs if self.drop_last else self.n
        if not self.shuffle:
            for start in range(0, stop, bs):
                yield {k: v[start:start + bs] for k, v in self.arrays.items()}
            return
        order = self._rng.permutation(self.n)
        for start in range(0, stop, bs):
            idx = order[start:start + bs]
            yield {k: v[idx] for k, v in self.arrays.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch with a single batch of lookahead."""
        q: queue.Queue = queue.Queue(maxsize=2)
        sentinel = object()

        def worker():
            try:
                for b in self._epoch_batches():
                    q.put(b)
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
