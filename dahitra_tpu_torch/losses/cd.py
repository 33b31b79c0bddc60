"""Change-detection (LEVIR) losses on NHWC logits.

Counterpart of dahitra_tpu/losses/cd.py:52-193 (the reference's
models/losses.py and models/trainer.py:254-261). ``logits`` are (B, H, W, C),
``target`` (B, H, W) integer class ids (a trailing singleton channel is
squeezed).

  * ``cross_entropy``: softmax CE with class weights (default ones) and the
    255 ignore label; the weighted mean divides by the summed weights of the
    valid pixels, as torch's reduction does.
  * ``focal_loss``: kornia's softmax focal loss with the one-hot ``+ 1e-6``
    quirk (every class of every pixel contributes), alpha 0.5, gamma 2;
    ``ignore_index`` drops pixels from the mean.
  * ``dice_argmax``: smp's binary dice on ``sigmoid(argmax(logits))``; the
    argmax carries no gradient, and the loss is 0 when the target is empty.
  * ``levir_train_loss``: dice + focal when the batch has more than one
    sample, else weighted CE (the trainer's actual choice);
  * the xBD members of the reference's losses.py (cd.py:155-190):
    ``focal_loss_xbd`` (per-class sigmoid focal over the 5 damage channels,
    ``focal_loss_2d_sigmoid`` clamping probabilities and targets to
    [1e-8, 1 - 1e-8], weights ``XBD_FOCAL_WEIGHTS``), ``multi_cross_entropy``
    (class weights 1, 5, 100, 90, 100) and ``ce_dice`` (0.5 CE + 0.5
    ``dice_argmax``; the reference builds a weight tensor and passes the
    unset one, so the CE is unweighted).

The logits must have the target's spatial size; ``multi_scale_loss``
(dahitra_tpu/train/engine.py:127-151) resizes the target for each head of
a multi-scale model (``changeFormerV6``) with ``resize_labels_nearest``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _squeeze_target(target: torch.Tensor) -> torch.Tensor:
    if target.dim() == 4 and target.shape[-1] == 1:
        target = target[..., 0]
    return target.long()


def _check_size(logits: torch.Tensor, target: torch.Tensor) -> None:
    if logits.shape[1:3] != target.shape[1:3]:
        raise ValueError(f"logits {tuple(logits.shape)} and target "
                         f"{tuple(target.shape)} differ in spatial size")


def cross_entropy(logits: torch.Tensor, target: torch.Tensor, weight=None,
                  ignore_index: int = 255) -> torch.Tensor:
    target = _squeeze_target(target)
    _check_size(logits, target)
    n_class = logits.shape[-1]
    weight = (torch.ones(n_class) if weight is None
              else torch.as_tensor(weight, dtype=torch.float32))
    weight = weight.to(logits.device, torch.float32)
    valid = (target != ignore_index) & (target >= 0) & (target < n_class)
    tgt = torch.where(valid, target, 0)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    w = weight[tgt] * valid.float()
    return (nll * w).sum() / w.sum().clamp_min(1e-12)


def _one_hot(target: torch.Tensor, n_class: int) -> torch.Tensor:
    """fp32 one-hot; an id outside [0, n_class) gives a zero row, as
    jax.nn.one_hot does."""
    return (target[..., None] == torch.arange(n_class, device=target.device)
            ).float()


def focal_loss(logits: torch.Tensor, target: torch.Tensor, alpha: float = 0.5,
               gamma: float = 2.0, ignore_index=None) -> torch.Tensor:
    target = _squeeze_target(target)
    logits = logits.float()
    p = torch.softmax(logits, dim=-1)
    logp = F.log_softmax(logits, dim=-1)
    focal = -alpha * torch.pow(1.0 - p, gamma) * logp
    if ignore_index is None:
        one_hot = _one_hot(target, logits.shape[-1]) + 1e-6
        return (one_hot * focal).sum(-1).mean()
    valid = (target != ignore_index).float()
    tgt = torch.where(target == ignore_index, 0, target)
    one_hot = _one_hot(tgt, logits.shape[-1]) + 1e-6
    per_px = (one_hot * focal).sum(-1) * valid
    return per_px.sum() / valid.sum().clamp_min(1.0)


@torch.no_grad()
def dice_argmax(logits: torch.Tensor, target: torch.Tensor,
                ignore_index=None) -> torch.Tensor:
    target_i = _squeeze_target(target)
    pred = torch.sigmoid(logits.argmax(-1).float())
    target_f = target_i.float()
    if ignore_index is not None:
        valid = (target_i != ignore_index).float()
        pred = pred * valid
        target_f = target_f * valid
    inter = (pred * target_f).sum()
    card = pred.sum() + target_f.sum()
    loss = 1.0 - 2.0 * inter / card.clamp_min(1e-7)
    return loss * (target_f.sum() > 0).float()


def levir_train_loss(logits: torch.Tensor, target: torch.Tensor,
                     batch_size: int) -> torch.Tensor:
    """The loss the LEVIR trainer optimizes; ``batch_size`` is the batch's
    own size, so a ragged last batch of one takes the CE branch. Label-255
    pixels are masked out of every term."""
    if batch_size != 1:
        return (dice_argmax(logits, target, ignore_index=255)
                + focal_loss(logits, target, ignore_index=255))
    return cross_entropy(logits, target)


# The multi-scale heads' weights, coarsest first (models/trainer.py:271-285).
MULTI_SCALE_WEIGHTS = (0.5, 0.5, 0.5, 0.8, 1.0)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC (float) resized to (h, w) the way ``jax.image.resize(...,
    "nearest")`` resizes: half-pixel centres, source index
    floor((i + 0.5) * H / h), which is ``mode="nearest-exact"`` (torch's
    ``"nearest"`` takes floor(i * H / h))."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w),
                      mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


def resize_labels_nearest(target: torch.Tensor, h: int, w: int
                          ) -> torch.Tensor:
    """(B, H, W) labels to (B, h, w), as ``resize_nearest``."""
    return resize_nearest(target[..., None].float(), h, w)[..., 0].to(
        target.dtype)


def multi_scale_loss(logits, target: torch.Tensor,
                     batch_size: int) -> torch.Tensor:
    """Deep supervision: the sum over the heads of ``levir_train_loss``
    weighted by ``MULTI_SCALE_WEIGHTS``, each head against the target
    resized to its size (fp32 logits)."""
    target = _squeeze_target(target)
    loss = 0.0
    for wt, lg in zip(MULTI_SCALE_WEIGHTS, logits):
        tgt = target if lg.shape[1:3] == target.shape[1:3] else \
            resize_labels_nearest(target, lg.shape[1], lg.shape[2])
        loss = loss + wt * levir_train_loss(lg.float(), tgt, batch_size)
    return loss


def focal_loss_2d_sigmoid(logits: torch.Tensor, target: torch.Tensor,
                          gamma: float = 2.0) -> torch.Tensor:
    """Single-channel sigmoid focal loss; probabilities and targets both
    clamped to [1e-8, 1 - 1e-8]."""
    p = torch.sigmoid(logits.float()).clamp(1e-8, 1.0 - 1e-8)
    t = target.float().clamp(1e-8, 1.0 - 1e-8)
    pt = (1.0 - t) * (1.0 - p) + t * p
    return (-torch.pow(1.0 - pt, gamma) * torch.log(pt)).mean()


XBD_FOCAL_WEIGHTS = (0.01, 0.1, 2.0, 1.5, 2.0)


def focal_loss_xbd(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """sum_c w_c * focal(logits[..., c], target == c) over the 5 damage
    channels of (B, H, W, 5) logits, ``target`` (B, H, W) class ids."""
    target = _squeeze_target(target)
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for c, w in enumerate(XBD_FOCAL_WEIGHTS):
        total = total + w * focal_loss_2d_sigmoid(logits[..., c],
                                                  (target == c).float())
    return total


def multi_cross_entropy(logits: torch.Tensor,
                        target: torch.Tensor) -> torch.Tensor:
    return cross_entropy(logits, target, weight=(1.0, 5.0, 100.0, 90.0, 100.0))


def ce_dice(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return 0.5 * cross_entropy(logits, target) + 0.5 * dice_argmax(logits,
                                                                   target)
