"""Change-detection (LEVIR) losses on NHWC logits.

Counterpart of dahitra_tpu/losses/cd.py:52-193 (the reference's
models/losses.py and models/trainer.py:254-261). ``logits`` are (B, H, W, C),
``target`` (B, H, W) integer class ids (a trailing singleton channel is
squeezed). The xBD losses wait for the xBD slice.

  * ``cross_entropy``: softmax CE with class weights (default ones) and the
    255 ignore label; the weighted mean divides by the summed weights of the
    valid pixels, as torch's reduction does.
  * ``focal_loss``: kornia's softmax focal loss with the one-hot ``+ 1e-6``
    quirk (every class of every pixel contributes), alpha 0.5, gamma 2;
    ``ignore_index`` drops pixels from the mean.
  * ``dice_argmax``: smp's binary dice on ``sigmoid(argmax(logits))``; the
    argmax carries no gradient, and the loss is 0 when the target is empty.
  * ``levir_train_loss``: dice + focal when the batch has more than one
    sample, else weighted CE (the trainer's actual choice).

The logits must have the target's spatial size: the JAX package resizes
only for multi-scale heads, which this model does not have.
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
