"""LEVIR-CD pair dataset, decoded on the host to uint8.

Counterpart of dahitra_tpu/data/levir.py (the reference's
datasets/CD_dataset.py:59-134):

  * files are listed from ``{root}/{split}/A``; B and the label share the
    name (the label under ``{split}/label`` with a .png suffix);
  * label //= 255 when label_transform == 'norm';
  * cropping happens only when ``img_size < width // 2``, at the FIXED
    origin (256, 256) for every split, or at ``(256*(patch//4),
    256*(patch%4))`` for patch ``patch`` of eval_cd's 16-patch sweep
    (datasets/data_utils.py:51-81).

The host stage stops at uint8 numpy arrays; normalisation runs on the device
(data/augment.py).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image


@dataclasses.dataclass
class LevirPairs:
    """uint8 pair arrays (N, H, W, 3) and labels (N, H, W)."""

    names: List[str]
    a: np.ndarray
    b: np.ndarray
    label: np.ndarray

    def __len__(self) -> int:
        return len(self.names)


def crop_origin(img_width: int, img_size: int, patch: Optional[int] = None
                ) -> Optional[Tuple[int, int]]:
    """The reference's fixed crop origin (row, col), or None when no crop
    applies (datasets/data_utils.py:62-78)."""
    if img_size >= img_width // 2:
        return None
    if patch is not None:
        return (256 * (patch // 4), 256 * (patch % 4))
    return (256, 256)


def tile_width(root_dir: str, split: str) -> int:
    """Width of the split's first A tile, before any crop."""
    a_dir = os.path.join(root_dir, split, "A")
    with Image.open(os.path.join(a_dir, sorted(os.listdir(a_dir))[0])) as im:
        return im.size[0]


def load_levir_split(root_dir: str, split: str, img_size: int = 256,
                     label_transform: str = "norm",
                     patch: Optional[int] = None,
                     allow_missing_labels: bool = False) -> LevirPairs:
    """Decode a split. A missing label raises unless
    ``allow_missing_labels``, which substitutes an all-zero mask (for
    inference-only splits; their metrics mean nothing)."""
    names = sorted(os.listdir(os.path.join(root_dir, split, "A")))
    a_list, b_list, l_list = [], [], []
    for name in names:
        img_a = np.asarray(Image.open(
            os.path.join(root_dir, split, "A", name)).convert("RGB"))
        img_b = np.asarray(Image.open(
            os.path.join(root_dir, split, "B", name)).convert("RGB"))
        lbl_path = os.path.join(root_dir, split, "label",
                                name.replace(".jpg", ".png"))
        if os.path.exists(lbl_path):
            lbl = np.array(Image.open(lbl_path), dtype=np.uint8)
            if label_transform == "norm":
                lbl = lbl // 255
        elif allow_missing_labels:
            lbl = np.zeros(img_a.shape[:2], np.uint8)
        else:
            raise FileNotFoundError(
                f"label missing for {name} at {lbl_path}; pass "
                "allow_missing_labels=True for inference-only splits")
        origin = crop_origin(img_a.shape[1], img_size, patch)
        if origin is not None:
            y0, x0 = origin
            img_a = img_a[y0:y0 + img_size, x0:x0 + img_size]
            img_b = img_b[y0:y0 + img_size, x0:x0 + img_size]
            lbl = lbl[y0:y0 + img_size, x0:x0 + img_size]
        a_list.append(img_a)
        b_list.append(img_b)
        l_list.append(lbl)
    return LevirPairs(names=names,
                      a=np.stack(a_list).astype(np.uint8),
                      b=np.stack(b_list).astype(np.uint8),
                      label=np.stack(l_list).astype(np.uint8))
