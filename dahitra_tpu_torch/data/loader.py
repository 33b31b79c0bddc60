"""Batch loader: host indexing with one prefetch thread.

Counterpart of dahitra_tpu/data/loader.py:19-61. Eval batches come in
dataset order (the reference's eval loader does not shuffle, utils.py:35);
training shuffles every epoch with ``np.random.default_rng(seed)`` (one
generator for the run, a new permutation per epoch), and ``drop_last``
drops a ragged last batch. The host stage is uint8 slicing (augmentation
runs on the device), so one thread keeps the device fed.

For data parallelism (``core/mesh.py``), ``pad_to_multiple`` pads a ragged
batch as loader.py:46-61 does: the first sample repeated, its ``label``
(where there is one) set to the ignore value 255, and a per-sample ``valid``
vector (True for real samples) added to every batch. ``shard=(rank,
world)`` then yields the rank's contiguous rows [r B / W, (r + 1) B / W) of
each (padded) global batch, indexing only those rows; every rank shuffles
with the same seed, so the ranks' batches joined in rank order are the
batch one process sees.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


class BatchLoader:
    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False,
                 pad_to_multiple: Optional[int] = None,
                 shard: Optional[Tuple[int, int]] = None):
        n = len(next(iter(arrays.values())))
        if any(len(v) != n for v in arrays.values()):
            raise ValueError("BatchLoader: arrays differ in length")
        self.arrays = arrays
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_to_multiple = pad_to_multiple
        self.shard = shard
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def real_rows(self, i: int) -> int:
        """The real samples of the global batch ``i`` (no filler)."""
        return min(self.batch_size, self.n - i * self.batch_size)

    def _epoch_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        bs = self.batch_size
        stop = (self.n // bs) * bs if self.drop_last else self.n
        if not (self.shuffle or self.pad_to_multiple or self.shard):
            for start in range(0, stop, bs):
                yield {k: v[start:start + bs] for k, v in self.arrays.items()}
            return
        order = (self._rng.permutation(self.n) if self.shuffle
                 else np.arange(self.n))
        for start in range(0, stop, bs):
            idx = order[start:start + bs]
            valid = np.ones(len(idx), np.bool_)
            if self.pad_to_multiple:
                pad = (-len(idx)) % self.pad_to_multiple
                idx = np.concatenate([idx, np.repeat(idx[:1], pad)])
                valid = np.concatenate([valid, np.zeros(pad, np.bool_)])
            if self.shard:
                rank, world = self.shard
                if len(idx) % world:
                    raise ValueError(
                        f"BatchLoader: a batch of {len(idx)} rows does not "
                        f"split over {world} ranks (pad_to_multiple)")
                rows = slice(rank * len(idx) // world,
                             (rank + 1) * len(idx) // world)
                idx, valid = idx[rows], valid[rows]
            batch = {k: v[idx] for k, v in self.arrays.items()}
            if self.pad_to_multiple:
                if "label" in batch and not valid.all():
                    batch["label"][~valid] = 255
                batch["valid"] = valid
            yield batch

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
