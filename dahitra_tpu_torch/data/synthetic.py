"""A seeded synthetic LEVIR-CD directory, for tests and the chip smoke run.

The layout is LEVIR-CD's: ``{root}/LEVIR_CD/{split}/{A,B,label}/<name>.png``
with 0/255 label masks, so ``data/levir.py`` reads it as it reads the real
dataset. Images are blocky noise; B repeats A except in the changed blocks,
which the label marks.
"""
from __future__ import annotations

import os

import numpy as np
from PIL import Image


def write_synthetic_levir(root: str, n_tiles: int = 4, size: int = 1024,
                          split: str = "test", seed: int = 0,
                          block: int = 16) -> str:
    """Write ``n_tiles`` pairs of ``size`` x ``size`` tiles under
    ``root/LEVIR_CD/split``; returns ``root/LEVIR_CD``."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "LEVIR_CD")
    for sub in ("A", "B", "label"):
        os.makedirs(os.path.join(base, split, sub), exist_ok=True)
    cells = size // block

    def up(t):
        return np.repeat(np.repeat(t, block, axis=0), block, axis=1)

    for i in range(n_tiles):
        a = up(rng.randint(0, 256, (cells, cells, 3))).astype(np.uint8)
        changed = up(rng.rand(cells, cells) < 0.15)
        b = np.where(changed[..., None],
                     up(rng.randint(0, 256, (cells, cells, 3))),
                     a).astype(np.uint8)
        name = f"synthetic_{i}.png"
        Image.fromarray(a).save(os.path.join(base, split, "A", name))
        Image.fromarray(b).save(os.path.join(base, split, "B", name))
        Image.fromarray((changed * 255).astype(np.uint8)).save(
            os.path.join(base, split, "label", name))
    return base
