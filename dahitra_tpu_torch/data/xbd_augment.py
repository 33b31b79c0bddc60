"""xBD augmentation and normalisation on the device.

Counterpart of dahitra_tpu/data/xbd_augment.py (the reference's
xBD_code/train.py:118-142). With probability 0.3 per sample a block of
pair-consistent ops applies: hflip (p 0.7), vflip (p 0.7), a resized crop
(p 0.7: origin (x, y), x, y ~ U{0..min(200, H / 4)}, the bottom-right
remainder resized back to full size; bilinear for the images, nearest for
the masks, half-pixel sampling with edge clamp) and a colour jitter (p 0.3:
brightness, contrast, saturation factors ~ U[0.8, 1.2], in that order,
images only). The inputs are then scaled as x / 127 - 1 on the 0..255 scale
(xBD_code/utils.py:112-116), the 6-channel pre|post input.

The draws (``draw_xbd``) come from the ``torch.Generator`` the caller
passes, on the batch's device; they differ from the JAX package's keys,
their distributions are the same. ``apply_xbd`` runs the ops on given draws,
batched; the samplers, the crop grid and the jitter are the JAX internals'
arithmetic, op for op. With ``elastic`` (``--elastic``, the
UNet-transformer recipe's jitter, train_unettransformer.py:247-253) each
date of each sample then goes through ``data/xbd_cd_augment.py``
``elastic_gated`` on draws of its own (p about 0.017; images only, after the
colour jitter and outside the p 0.3 block), as the JAX ``_augment_one``
does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Draws = Dict[str, torch.Tensor]


def normalize_xbd(img_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 -> x / 127 - 1 in ``dtype``."""
    return img_u8.to(dtype) / 127.0 - 1.0


def bilinear_sample(img: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) images sampled at fractional (B, H', W') row and column
    grids, edge-clamped (``_bilinear_sample``, batched)."""
    b, h, w = img.shape[:3]
    r0 = rows.floor().long().clamp(0, h - 1)
    c0 = cols.floor().long().clamp(0, w - 1)
    r1 = (r0 + 1).clamp(0, h - 1)
    c1 = (c0 + 1).clamp(0, w - 1)
    fr = (rows - r0).clamp(0.0, 1.0)[..., None]
    fc = (cols - c0).clamp(0.0, 1.0)[..., None]
    bi = torch.arange(b, device=img.device).view(b, 1, 1)
    top = img[bi, r0, c0] * (1 - fc) + img[bi, r0, c1] * fc
    bot = img[bi, r1, c0] * (1 - fc) + img[bi, r1, c1] * fc
    return top * (1 - fr) + bot * fr


def nearest_sample(img: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor) -> torch.Tensor:
    """(B, H, W, ...) sampled at the nearest pixel of each grid point
    (``_nearest_sample``: round half to even, edge clamp)."""
    b, h, w = img.shape[:3]
    r = rows.round().long().clamp(0, h - 1)
    c = cols.round().long().clamp(0, w - 1)
    bi = torch.arange(b, device=img.device).view(b, 1, 1)
    return img[bi, r, c]


def resized_crop_grid(h: int, w: int, x: torch.Tensor, y: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-pixel sampling grids (B, h, w) that crop each sample at (x, y)
    (top, left; (B,) float32) to its bottom-right remainder and resize it
    back to (h, w) (``_resized_crop_grid``)."""
    x = x.float().view(-1, 1, 1)
    y = y.float().view(-1, 1, 1)
    i = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1)
    j = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w)
    rows = x + (i + 0.5) * ((h - x) / h) - 0.5
    cols = y + (j + 0.5) * ((w - y) / w) - 0.5
    return rows.expand(-1, h, w), cols.expand(-1, h, w)


def color_jitter(img: torch.Tensor, bright: torch.Tensor,
                 contrast: torch.Tensor, sat: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast, saturation with per-sample (B,) factors on
    (B, H, W, 3) images in [0, 1] (``_color_jitter``)."""
    def f(v):
        return v.view(-1, 1, 1, 1)

    img = img * f(bright)
    mean = img.mean((1, 2, 3), keepdim=True)
    img = (img - mean) * f(contrast) + mean
    gray = img.mean(-1, keepdim=True)
    img = (img - gray) * f(sat) + gray
    return img.clamp(0.0, 1.0)


def draw_xbd(n: int, h: int, generator: torch.Generator,
             device) -> Draws:
    """Per-sample draws of ``_augment_one`` for a batch of ``n`` tiles of
    ``h`` rows: the block's gate and each op's, the crop origin and the
    jitter factors."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    block = u(n) < 0.3
    max_off = min(200, h // 4)
    return {"hflip": block & (u(n) < 0.7), "vflip": block & (u(n) < 0.7),
            "crop": block & (u(n) < 0.7),
            "xy": torch.randint(0, max_off + 1, (n, 2), generator=generator,
                                device=device),
            "jitter": block & (u(n) < 0.3),
            "factors": 0.8 + 0.4 * u(n, 3)}


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(mask.view(-1, *([1] * (a.dim() - 1))), a, b)


def apply_xbd(pre: torch.Tensor, post: torch.Tensor, msk: torch.Tensor,
              lbl: torch.Tensor, draws: Draws):
    """``_augment_one`` over a batch with given draws: pre, post (B, H, W,
    3) in [0, 1], msk (B, H, W, C) and lbl (B, H, W)."""
    ts = [pre, post, msk, lbl[..., None]]
    ts = [_where(draws["hflip"], t.flip(2), t) for t in ts]
    ts = [_where(draws["vflip"], t.flip(1), t) for t in ts]
    pre, post, msk, lbl = ts
    h, w = pre.shape[1:3]
    zero = torch.zeros((), dtype=torch.long, device=pre.device)
    x = torch.where(draws["crop"], draws["xy"][:, 0], zero).float()
    y = torch.where(draws["crop"], draws["xy"][:, 1], zero).float()
    rows, cols = resized_crop_grid(h, w, x, y)
    pre = bilinear_sample(pre, rows, cols)
    post = bilinear_sample(post, rows, cols)
    msk = nearest_sample(msk, rows, cols)
    lbl = nearest_sample(lbl, rows, cols)[..., 0]
    fac = draws["factors"]
    pre, post = (_where(draws["jitter"],
                        color_jitter(t, fac[:, 0], fac[:, 1], fac[:, 2]), t)
                 for t in (pre, post))
    return pre, post, msk, lbl


def augment_xbd(pre_u8: torch.Tensor, post_u8: torch.Tensor,
                msk_u8: torch.Tensor, lbl_u8: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                train: bool = True, dtype=torch.float32,
                elastic: bool = False,
                shard: Optional[Tuple[int, int]] = None):
    """(B, H, W, 3) uint8 pre and post, (B, H, W, C) uint8 masks and
    (B, H, W) uint8 labels -> the normalized 6-channel input in ``dtype``,
    fp32 masks and int64 labels, on the inputs' device. ``train`` draws
    from ``generator`` (on that device) and augments; ``elastic`` adds the
    gated elastic jitter there; ``shard`` (rank, world) keeps the rank's
    rows of draws made for the global batch of ``world`` times B."""
    pre = pre_u8.float() / 255.0
    post = post_u8.float() / 255.0
    msk = msk_u8.float()
    lbl = lbl_u8.long()
    if train:
        if generator is None:
            raise ValueError("augment_xbd(train=True) needs a generator")
        n, h, w = pre.shape[:3]
        rank, world = shard or (0, 1)

        def own(draws: Draws) -> Draws:
            return {k: v[rank * n:(rank + 1) * n] for k, v in draws.items()}

        draws = own(draw_xbd(n * world, h, generator, pre.device))
        pre, post, msk, lbl = apply_xbd(pre, post, msk, lbl, draws)
        if elastic:
            from dahitra_tpu_torch.data.xbd_cd_augment import (
                draw_elastic_gated, elastic_gated)
            pre, post = (elastic_gated(t, own(draw_elastic_gated(
                n * world, h, w, generator, pre.device)))
                for t in (pre, post))
    img6 = torch.cat([pre, post], -1) * (255.0 / 127.0) - 1.0
    return img6.to(dtype), msk, lbl
