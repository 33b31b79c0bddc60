"""Pair normalisation on the device.

Counterpart of dahitra_tpu/data/augment.py. This slice ports the eval
branch of ``augment_pairs`` (augment.py:122-129): no flips, no blur, just
``x/255`` then ``(x - .5)/.5`` in the compute dtype, with each step rounded
to that dtype as the JAX package rounds it. The train branch (flips, rot90,
the always-on blur) comes with the training slice.
"""
from __future__ import annotations

from typing import Tuple

import torch


def normalize_images(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (..., 3) -> [-1, 1] in ``dtype`` (ToTensor + Normalize(.5, .5))."""
    x = x.to(dtype) / 255.0
    return (x - 0.5) / 0.5


def augment_pairs(a_u8: torch.Tensor, b_u8: torch.Tensor,
                  label_u8: torch.Tensor, train: bool = False,
                  dtype=torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) uint8 pairs and (B, H, W) uint8 labels -> normalised
    images in ``dtype`` and int64 labels, on the inputs' device."""
    if train:
        raise NotImplementedError(
            "train-mode augmentation (flips, blur) comes with the training "
            "slice; see ROADMAP.md section 1")
    return (normalize_images(a_u8, dtype), normalize_images(b_u8, dtype),
            label_u8.long())
