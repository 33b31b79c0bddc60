"""Batch loader: host indexing with one prefetch thread.

Counterpart of dahitra_tpu/data/loader.py, eval form: batches in dataset
order (the reference's eval loader does not shuffle, utils.py:35), the last
one ragged. The host stage is uint8 slicing (normalisation runs on the
device), so one thread keeps the device fed. Shuffling comes with the
training slice.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class BatchLoader:
    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int):
        n = len(next(iter(arrays.values())))
        if any(len(v) != n for v in arrays.values()):
            raise ValueError("BatchLoader: arrays differ in length")
        self.arrays = arrays
        self.n = n
        self.batch_size = batch_size

    def __len__(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def _epoch_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        for start in range(0, self.n, self.batch_size):
            yield {k: v[start:start + self.batch_size]
                   for k, v in self.arrays.items()}

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
