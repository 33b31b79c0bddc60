"""Pair augmentation and normalisation on the device.

Counterpart of dahitra_tpu/data/augment.py (the reference's
datasets/data_utils.py:26-113). Eval: ``x/255`` then ``(x - .5)/.5`` in the
compute dtype, each step rounded to that dtype as the JAX package rounds it.
Train (augment.py:76-129), per sample:

  * hflip and vflip, each with p = 0.5, applied to A, B and the label alike,
    on the uint8 arrays;
  * rot90 by 90, 180 or 270 degrees with p = 0.5 (implemented, off by
    default, as in every reference dataset config);
  * ``x/255`` in the compute dtype;
  * the always-on 7-tap separable Gaussian blur with sigma ~ U[0, 1), edge
    padding, each pass accumulated in fp32 and stored in the compute dtype
    (``_gaussian_kernel``, ``_separable_blur``, augment.py:38-73);
  * ``(x - .5)/.5``.

Every draw comes from the ``torch.Generator`` the caller passes, which lives
on the batch's device. The draws differ from the JAX package's keys; their
distributions are the same.
"""
from __future__ import annotations

from typing import Tuple

import torch

_BLUR_TAPS = 7


def normalize_images(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (..., 3) -> [-1, 1] in ``dtype`` (ToTensor + Normalize(.5, .5))."""
    x = x.to(dtype) / 255.0
    return (x - 0.5) / 0.5


def gaussian_kernel(sigma: torch.Tensor) -> torch.Tensor:
    """(B,) sigmas -> (B, 7) normalized fp32 taps; sigma -> 0 is the
    identity."""
    half = _BLUR_TAPS // 2
    offs = torch.arange(-half, half + 1, dtype=torch.float32,
                        device=sigma.device)
    sig = sigma.float().clamp_min(1e-4)[:, None]
    w = torch.exp(-0.5 * (offs / sig) ** 2)
    return w / w.sum(-1, keepdim=True)


def separable_blur(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Per-sample Gaussian blur of (B, H, W, C) images: rows, then columns,
    replicate-padded; each pass sums in fp32 and is stored in the images'
    dtype."""
    k = gaussian_kernel(sigma)[:, :, None, None, None]  # (B, 7, 1, 1, 1)
    half = _BLUR_TAPS // 2
    for axis in (1, 2):
        size = img.shape[axis]
        idx = torch.arange(-half, size + half, device=img.device)
        padded = img.index_select(axis, idx.clamp(0, size - 1))
        acc = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
        for i in range(_BLUR_TAPS):
            acc = acc + k[:, i] * padded.narrow(axis, i, size)
        img = acc.to(img.dtype)
    return img


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(mask.view(-1, *([1] * (a.dim() - 1))), a, b)


def augment_pairs(a_u8: torch.Tensor, b_u8: torch.Tensor,
                  label_u8: torch.Tensor, train: bool = False,
                  dtype=torch.float32, generator: torch.Generator = None,
                  blur: bool = True, rot: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) uint8 pairs and (B, H, W) uint8 labels -> normalised
    images in ``dtype`` and int64 labels, on the inputs' device. ``train``
    needs ``generator`` (on that device); ``blur`` and ``rot`` switch the
    blur and the rot90 draw of the train branch."""
    if train:
        if generator is None:
            raise ValueError("augment_pairs(train=True) needs a generator")
        n, dev = a_u8.shape[0], a_u8.device

        def coin():
            return torch.rand(n, generator=generator, device=dev) < 0.5

        for dim in (2, 1):  # hflip, then vflip
            do = coin()
            a_u8, b_u8, label_u8 = (_where(do, t.flip(dim), t) for t in
                                    (a_u8, b_u8, label_u8))
        if rot:
            do = coin()
            k90 = torch.randint(1, 4, (n,), generator=generator, device=dev)
            for k in (1, 2, 3):
                sel = do & (k90 == k)
                a_u8, b_u8, label_u8 = (
                    _where(sel, torch.rot90(t, k, (1, 2)), t)
                    for t in (a_u8, b_u8, label_u8))
        a = a_u8.to(dtype) / 255.0
        b = b_u8.to(dtype) / 255.0
        if blur:
            sigma = torch.rand(n, generator=generator, device=dev)
            a, b = separable_blur(a, sigma), separable_blur(b, sigma)
        return (a - 0.5) / 0.5, (b - 0.5) / 0.5, label_u8.long()
    return (normalize_images(a_u8, dtype), normalize_images(b_u8, dtype),
            label_u8.long())
