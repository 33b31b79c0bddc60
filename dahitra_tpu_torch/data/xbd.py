"""xBD damage-assessment data: file scan, split, masks and host arrays.

Counterpart of dahitra_tpu/data/xbd.py (the reference's xBD_code/train.py
:79-235 and datasets/CD_dataset.py:137-276):

  * ``scan_xbd_files``: ``*_pre_disaster.png`` under ``{dir}/images``; the
    post image swaps the suffix, the masks live under ``{dir}/masks`` (pre
    mask: building footprints; post mask: damage classes 0-4).
  * ``split_and_upsample``: the 90/10 split, then class-presence upsampling
    (policy ``random``, the xBD trainer's, or ``multi``, xBDatasetMulti's).
    The JAX package draws the split with sklearn's ``train_test_split``;
    ``_train_test_split`` here is the same draw in numpy (ShuffleSplit:
    ``RandomState(seed).permutation(n)``, the first ceil(0.1 n) the test
    part), so the indices are the JAX package's.
  * ``build_damage_masks``: the 5-channel one-hot stack with the train
    variant's precedence rules, or the val variant; ``merge_34`` the
    4-channel domain-adaptation variant.
  * ``load_xbd_pairs``: decoded uint8 host arrays (``XBDPairs``), with the
    training random crop and the xBD -> IdaBD colour renormalization.
"""
from __future__ import annotations

import dataclasses
import math
import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image


def scan_xbd_files(train_dirs: Sequence[str],
                   disasters: Optional[Sequence[str]] = None) -> List[str]:
    """Pre-disaster image paths in name order (train.py:79-83); with
    ``disasters``, only names containing one of those substrings."""
    all_files = []
    for d in train_dirs:
        for f in sorted(os.listdir(os.path.join(d, "images"))):
            if "_pre_disaster.png" in f:
                if disasters and not any(k in f for k in disasters):
                    continue
                all_files.append(os.path.join(d, "images", f))
    return all_files


def post_image_path(pre_path: str) -> str:
    return pre_path.replace("_pre_disaster", "_post_disaster")


def post_mask_path(pre_path: str) -> str:
    return pre_path.replace("/images/", "/masks/").replace(
        "_pre_disaster", "_post_disaster")


def pre_mask_path(pre_path: str) -> str:
    return pre_path.replace("/images/", "/masks/")


def file_class_presence(all_files: Sequence[str]) -> np.ndarray:
    """(N, 4) bool: damage class c + 1 present in each post mask
    (train.py:397-407)."""
    out = np.zeros((len(all_files), 4), dtype=bool)
    for i, fn in enumerate(all_files):
        msk = np.array(Image.open(post_mask_path(fn)))
        for c in range(1, 5):
            out[i, c - 1] = bool((msk == c).any())
    return out


def _train_test_split(n: int, seed: int, test_size: float = 0.1
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn ``train_test_split(np.arange(n), test_size=test_size,
    random_state=seed)``: a ShuffleSplit permutation whose first
    ceil(test_size * n) entries are the test part. An empty train part
    raises, as sklearn's does."""
    n_test = math.ceil(test_size * n)
    if n_test >= n:
        raise ValueError(f"a split of {n} files with test_size {test_size} "
                         "leaves the train part empty")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def split_and_upsample(all_files: Sequence[str], seed: int = 0,
                       policy: str = "random"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idxs, val_idxs) with class-balance upsampling.

    ``random``: the xBD trainer's scheme (train.py:409-425): split first,
    keep the training files with any building, and duplicate those with
    damage with probability 0.5 (Python's ``random`` seeded ``seed + 321``).
    ``multi``: xBDatasetMulti's (CD_dataset.py:233-249): each file once,
    again if any damage class is present, again if minor or major damage
    is, THEN the 90/10 split."""
    file_classes = file_class_presence(all_files)
    if policy == "multi":
        idxs = list(range(len(all_files)))
        for i in range(len(file_classes)):
            if file_classes[i, 1:].max():
                idxs.append(i)
            if file_classes[i, 1:3].max():
                idxs.append(i)
        train_pos, val_pos = _train_test_split(len(idxs), seed)
        idxs = np.asarray(idxs, np.int64)
        return idxs[train_pos], np.unique(idxs[val_pos])
    train_idxs0, val_idxs = _train_test_split(len(all_files), seed)
    rng = random.Random(seed + 321)
    train_idxs = []
    for i in train_idxs0:
        if file_classes[i, :].max():
            train_idxs.append(i)
        if (rng.random() > 0.5) and file_classes[i, 1:].max():
            train_idxs.append(i)
    return np.asarray(train_idxs, np.int64), np.asarray(val_idxs, np.int64)


def ida_color_normalize(img: np.ndarray) -> np.ndarray:
    """xBD -> IdaBD colour-statistics renormalization
    (xBD_code/train_adapt.py:81-85)."""
    x = (img.astype(np.float64) - [87.4, 96.4, 74.7]) / [41.8, 37.8, 37.9]
    x = x * [44.7, 38.7, 33.8] + [75.1, 74.3, 56.4]
    return np.clip(x, 0, 255).astype(np.uint8)


def build_damage_masks(loc_msk: np.ndarray, dmg_msk: np.ndarray,
                       train: bool, merge_34: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The one-hot mask stack and the integer label map.

    ``loc_msk``: pre mask (footprints as 255); ``dmg_msk``: post mask, class
    ids 0-4. Channels: [loc, minor, major, destroyed, ...]: 5, or with
    ``merge_34`` 4 (classes 3 and 4 merged, train_adapt.py:147-153). The
    train variant applies train.py:162-174's precedence rules and rebuilds
    channel 0 from the damage channels; the val variant keeps the raw
    channels and labels the argmax over the damage channels only
    (train.py:233-235). Returns (msk (H, W, C) int32, lbl (H, W) int32)."""
    chans = [loc_msk]
    if merge_34:
        chans.append(np.where(dmg_msk == 1, 255, 0).astype(loc_msk.dtype))
        chans.append(np.where(dmg_msk == 2, 255, 0).astype(loc_msk.dtype))
        chans.append(np.where((dmg_msk == 3) | (dmg_msk == 4), 255,
                              0).astype(loc_msk.dtype))
        msk = np.stack(chans, axis=-1) > 127
        lbl = msk[..., 1:].argmax(axis=-1)
        return msk.astype(np.int32), lbl.astype(np.int32)
    for c in range(1, 5):
        chans.append(np.where(dmg_msk == c, 255, 0).astype(loc_msk.dtype))
    msk = np.stack(chans, axis=-1) > 127
    if train:
        msk[..., 0] = False
        msk[..., 1][msk[..., 2:].max(axis=-1)] = False
        msk[..., 3][msk[..., 2]] = False
        msk[..., 4][msk[..., 2]] = False
        msk[..., 4][msk[..., 3]] = False
        msk[..., 0][msk[..., 1:].max(axis=-1)] = True
        lbl_msk = msk.argmax(axis=-1)
    else:
        lbl_msk = msk[..., 1:].argmax(axis=-1)
    return msk.astype(np.int32), lbl_msk.astype(np.int32)


@dataclasses.dataclass
class XBDPairs:
    """Host arrays of one split: uint8 images and masks."""

    files: List[str]
    img_pre: np.ndarray   # (N, H, W, 3) uint8
    img_post: np.ndarray  # (N, H, W, 3) uint8
    msk: np.ndarray       # (N, H, W, 5) uint8 one-hot
    lbl_msk: np.ndarray   # (N, H, W) uint8

    def __len__(self):
        return len(self.files)

    def arrays(self) -> dict:
        return {"img_pre": self.img_pre, "img_post": self.img_post,
                "msk": self.msk, "lbl_msk": self.lbl_msk}


def load_xbd_pairs(files: Sequence[str], train: bool,
                   crop_size: Optional[int] = None, seed: int = 0,
                   merge_34: bool = False,
                   color_normalize: bool = False) -> XBDPairs:
    """Decode xBD tiles to host arrays. ``crop_size`` below the tile takes a
    random crop (``RandomState(seed)``, train.py:110-116; none at the native
    1024); ``color_normalize`` applies ``ida_color_normalize`` to both
    images. Pre masks stored as 0/1 are scaled to 0/255."""
    rng = np.random.RandomState(seed)
    pre_l, post_l, msk_l, lbl_l = [], [], [], []
    for fn in files:
        pre = np.array(Image.open(fn).convert("RGB"))
        post = np.array(Image.open(post_image_path(fn)).convert("RGB"))
        if color_normalize:
            pre = ida_color_normalize(pre)
            post = ida_color_normalize(post)
        loc = np.array(Image.open(pre_mask_path(fn)))
        dmg = np.array(Image.open(post_mask_path(fn)))
        if crop_size and crop_size < pre.shape[0]:
            y0 = rng.randint(0, pre.shape[0] - crop_size + 1)
            x0 = rng.randint(0, pre.shape[1] - crop_size + 1)
            pre, post, loc, dmg = (t[y0:y0 + crop_size, x0:x0 + crop_size]
                                   for t in (pre, post, loc, dmg))
        if loc.max() == 1:
            loc = loc * 255
        msk, lbl = build_damage_masks(loc, dmg, train, merge_34=merge_34)
        pre_l.append(pre)
        post_l.append(post)
        msk_l.append(msk.astype(np.uint8))
        lbl_l.append(lbl.astype(np.uint8))
    return XBDPairs(files=list(files),
                    img_pre=np.stack(pre_l).astype(np.uint8),
                    img_post=np.stack(post_l).astype(np.uint8),
                    msk=np.stack(msk_l), lbl_msk=np.stack(lbl_l))
