"""Seeded synthetic LEVIR-CD and xBD directories, for tests and the chip
smoke run.

``write_synthetic_levir``: LEVIR-CD's layout,
``{root}/LEVIR_CD/{split}/{A,B,label}/<name>.png`` with 0/255 label masks,
so ``data/levir.py`` reads it as it reads the real dataset. Images are
blocky noise; B repeats A except in the changed blocks, which the label
marks. ``write_synthetic_xbd``: xBD's layout, which ``data/xbd.py`` reads.
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


def write_synthetic_xbd(root: str, n_tiles: int = 8, size: int = 1024,
                        seed: int = 0, block: int = 32) -> str:
    """Write ``n_tiles`` seeded xBD pairs under ``root`` in xBD's layout:
    ``images/<name>_{pre,post}_disaster.png`` and the same names under
    ``masks/`` (pre: building footprints 0/255; post: damage classes 0-4 on
    the footprints). Buildings are blocks of ``block`` px on a grid, about a
    third of the cells; their classes cycle through 1-4 from a seeded
    offset, so every tile holds every class and any split has them all in
    train and val. A damaged building's post pixels change with its class.
    Returns ``root``."""
    rng = np.random.RandomState(seed)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    cells = size // block

    def up(t):
        return np.repeat(np.repeat(t, block, axis=0), block, axis=1)

    for i in range(n_tiles):
        ground = up(rng.randint(40, 120, (cells, cells, 3)))
        bldg = rng.rand(cells, cells) < 0.35
        cls = np.zeros((cells, cells), np.uint8)
        cls[bldg] = 1 + (np.arange(bldg.sum()) + rng.randint(4)) % 4
        roof = rng.randint(150, 256, (cells, cells, 3))
        pre = np.where(up(bldg)[..., None], up(roof), ground)
        # minor: dimmed roof, major: half the roof gone, destroyed: rubble
        shade = np.array([1.0, 1.0, 0.8, 0.55, 0.3])[up(cls)][..., None]
        post = np.where(up(cls > 0)[..., None], pre * shade,
                        ground).astype(np.uint8)
        name = f"synthetic-disaster_{i:08d}"
        for img, suffix in ((pre, "pre"), (post, "post")):
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(root, "images", f"{name}_{suffix}_disaster.png"))
        Image.fromarray((up(bldg) * 255).astype(np.uint8)).save(
            os.path.join(root, "masks", f"{name}_pre_disaster.png"))
        Image.fromarray(up(cls)).save(
            os.path.join(root, "masks", f"{name}_post_disaster.png"))
    return root
