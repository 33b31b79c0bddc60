"""xBD segmentation losses (the xView2-solution family).

Counterpart of dahitra_tpu/losses/combo.py:30-195 (the reference's
xBD_code/losses.py):

  * ``soft_dice_loss`` and ``jaccard_loss`` (losses.py:14-45; per_image False
    flattens the batch), ``stable_bce`` on logits (:70-80), ``focal_loss_2d``
    on probabilities (:273-289, gamma 2, eps 1e-6, ignore 255),
    ``lovasz_hinge`` and ``lovasz_sigmoid`` (:129-226; ignored pixels sort
    last with no contribution, as in the JAX package) and ``mask_bceavg``;
  * ``ComboLoss`` (:95-126): a weighted sum of named members, the sigmoid
    taken once for those that expect probabilities;
  * the damage recipe ``xbd_damage_loss`` (train.py:316,348-353:
    per-channel ComboLoss{dice: 1, focal: 8} weighted ``XBD_CLASS_WEIGHTS``)
    and the localization recipe ``xbd_localization_loss`` (train_loc.py:310:
    {dice: 1, focal: 10}).

  * the adaptation recipe ``xbd_adapt_loss`` (train_adapt.py:320-340) and
    the GAN recipes ``xbd_gan_generator_loss`` (train_GAN.py:364-377, with
    the reference's detached adversarial term unless ``effective_gan``) and
    ``xbd_gan_discriminator_loss`` (:350-361), on ``bce_with_logits``
    (combo.py:196-286).

Inputs are channel-last; a per-class call takes (B, H, W) logits and
targets. Everything reduces in fp32. ``dual_hrnet_loss`` waits for the
dual HRNet (ROADMAP.md section 1, item 6).
"""
from __future__ import annotations

from typing import Dict

import torch

from dahitra_tpu_torch.losses.cd import cross_entropy

EPS = 1e-6


def stable_bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    x = logits.reshape(-1).float()
    t = target.reshape(-1).float()
    return (x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def soft_dice_loss(probs: torch.Tensor, target: torch.Tensor,
                   per_image: bool = False) -> torch.Tensor:
    b = probs.shape[0] if per_image else 1
    p = probs.reshape(b, -1).float()
    t = target.reshape(b, -1).float()
    inter = (p * t).sum(1)
    union = p.sum(1) + t.sum(1) + EPS
    return (1.0 - (2.0 * inter + EPS) / union).mean()


def jaccard_loss(probs: torch.Tensor, target: torch.Tensor,
                 per_image: bool = False) -> torch.Tensor:
    b = probs.shape[0] if per_image else 1
    p = probs.reshape(b, -1).float()
    t = target.reshape(b, -1).float()
    inter = (p * t).sum(1)
    union = p.sum(1) + t.sum(1) - inter + EPS
    return (1.0 - (inter + EPS) / union).mean()


def focal_loss_2d(probs: torch.Tensor, target: torch.Tensor,
                  gamma: float = 2.0, ignore_index: int = 255
                  ) -> torch.Tensor:
    """Binary focal loss on probabilities, pixels at ``ignore_index``
    masked out."""
    p = probs.reshape(-1).float()
    t_raw = target.reshape(-1).float()
    keep = (t_raw != ignore_index).float()
    p = p.clamp(EPS, 1.0 - EPS)
    t = t_raw.clamp(EPS, 1.0 - EPS)
    pt = (1.0 - t) * (1.0 - p) + t * p
    per_px = -torch.pow(1.0 - pt, gamma) * torch.log(pt)
    return (per_px * keep).sum() / keep.sum().clamp_min(1.0)


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension with respect to the sorted errors
    (losses.py:129-141)."""
    gts = gt_sorted.sum()
    intersection = gts - gt_sorted.cumsum(0)
    union = gts + (1.0 - gt_sorted).cumsum(0)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def _lovasz_flat(errors: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """relu(errors) sorted descending, dotted with the Lovasz gradient of
    the labels in that order (a constant); ignored entries get error -1e9
    and label 0, so they sort last and add nothing."""
    errors = torch.where(valid, errors, torch.full_like(errors, -1e9))
    labels = torch.where(valid, labels, torch.zeros_like(labels))
    order = torch.argsort(-errors, stable=True)
    grad = _lovasz_grad(labels[order])
    return torch.dot(torch.relu(errors[order]), grad.detach())


def lovasz_hinge(logits: torch.Tensor, target: torch.Tensor,
                 per_image: bool = False, ignore_index: int = 255
                 ) -> torch.Tensor:
    """Binary Lovasz hinge on logits (losses.py:144-177)."""
    b = logits.shape[0]
    lg = logits.reshape(b, -1).float()
    t = target.reshape(b, -1).float()
    valid = t != ignore_index

    def one(x, y, v):
        return _lovasz_flat(1.0 - x * (2.0 * y - 1.0), y, v)

    if per_image:
        return torch.stack([one(*a) for a in zip(lg, t, valid)]).mean()
    return one(lg.reshape(-1), t.reshape(-1), valid.reshape(-1))


def lovasz_sigmoid(probs: torch.Tensor, target: torch.Tensor,
                   per_image: bool = False, ignore_index: int = 255
                   ) -> torch.Tensor:
    """Lovasz on probabilities (losses.py:195-225)."""
    b = probs.shape[0]
    p = probs.reshape(b, -1).float()
    t = target.reshape(b, -1).float()
    valid = t != ignore_index

    def one(x, y, v):
        return _lovasz_flat((y - x).abs(), y, v)

    if per_image:
        return torch.stack([one(*a) for a in zip(p, t, valid)]).mean()
    return one(p.reshape(-1), t.reshape(-1), valid.reshape(-1))


def mask_bceavg(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on clipped probabilities."""
    p = probs.reshape(-1).clamp(EPS, 1.0 - EPS)
    t = target.reshape(-1).float()
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).mean()


class ComboLoss:
    """Weighted sum of named segmentation losses (losses.py:95-126);
    ``weights`` maps member names to scalar weights, zero weights skipped.
    The sigmoid is taken once and shared by the members that expect
    probabilities."""

    def __init__(self, weights: Dict[str, float], per_image: bool = False):
        self.weights = dict(weights)
        self.per_image = per_image

    def __call__(self, logits: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
        probs = torch.sigmoid(logits.float())
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for name, w in self.weights.items():
            if not w:
                continue
            if name == "bce":
                val = stable_bce(logits, target)
            elif name == "dice":
                val = soft_dice_loss(probs, target)
            elif name == "jaccard":
                val = jaccard_loss(probs, target)
            elif name == "focal":
                val = focal_loss_2d(probs, target)
            elif name == "lovasz":
                val = lovasz_hinge(logits, target, per_image=self.per_image)
            elif name == "lovasz_sigmoid":
                val = lovasz_sigmoid(probs, target, per_image=self.per_image)
            elif name == "mask_bceavg":
                val = mask_bceavg(probs, target)
            else:
                raise KeyError(f"unknown combo loss member: {name}")
            total = total + w * val
        return total


# The damage recipe's channel weights (xBD_code/train.py:316,348-353).
XBD_CLASS_WEIGHTS = (0.05, 0.2, 0.8, 0.7, 0.4)


def xbd_damage_loss(logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """sum_i w_i * ComboLoss{dice: 1, focal: 8}(logits[..., i], masks[..., i])
    over the 5 channels of (B, H, W, 5) logits and masks."""
    seg = ComboLoss({"dice": 1.0, "focal": 8.0})
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for i, w in enumerate(XBD_CLASS_WEIGHTS):
        total = total + w * seg(logits[..., i], masks[..., i])
    return total


def xbd_localization_loss(logits: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """ComboLoss{dice: 1, focal: 10} on the loc channel (train_loc.py:310);
    (B, H, W, C) logits read channel 0."""
    seg = ComboLoss({"dice": 1.0, "focal": 10.0})
    return seg(logits[..., 0] if logits.dim() == 4 else logits, mask)


def _masks_to_class_target(masks: torch.Tensor) -> torch.Tensor:
    """Channel 0 inverted, then the argmax over the channels (the first
    maximum): the CE target of the adaptation and GAN recipes
    (train_adapt.py:332-334, train_GAN.py:366-368)."""
    masks = masks.float()
    inv = torch.cat([1.0 - masks[..., :1], masks[..., 1:]], -1)
    return inv.argmax(-1)


def xbd_adapt_loss(logits: torch.Tensor, masks4: torch.Tensor) -> torch.Tensor:
    """sum_i w_i * ComboLoss{dice: 1, focal: 8} over the 4 merged channels,
    weights (0.1, 0.8, 2, 8), plus 5 times the CE against the class target
    with class weights (0.1, 0.5, 1.5, 1.5)."""
    seg = ComboLoss({"dice": 1.0, "focal": 8.0})
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for i, w in enumerate((0.1, 0.8, 2.0, 8.0)):
        total = total + w * seg(logits[..., i], masks4[..., i])
    return total + 5.0 * cross_entropy(logits, _masks_to_class_target(masks4),
                                       weight=(0.1, 0.5, 1.5, 1.5))


def bce_with_logits(logits: torch.Tensor,
                    target: torch.Tensor) -> torch.Tensor:
    return stable_bce(logits, target)


def xbd_gan_generator_loss(logits: torch.Tensor, masks5: torch.Tensor,
                           disc_fake_logits: torch.Tensor,
                           effective_gan: bool = False) -> torch.Tensor:
    """ComboLoss{dice: 1, focal: 8} on the loc channel, 5 times the CE with
    class weights (0.1, 0.5, 1.5, 1.5, 1.5), and 0.01 * BCE(D(pred), 1).
    The reference computes the adversarial term on detached logits
    (train_GAN.py:374), so no gradient reaches the generator from it: it is
    detached here too unless ``effective_gan`` (the caller decides where
    ``disc_fake_logits`` came from)."""
    seg = ComboLoss({"dice": 1.0, "focal": 8.0})
    loss = seg(logits[..., 0], masks5[..., 0])
    loss = loss + 5.0 * cross_entropy(logits, _masks_to_class_target(masks5),
                                      weight=(0.1, 0.5, 1.5, 1.5, 1.5))
    adv = bce_with_logits(disc_fake_logits, torch.ones_like(disc_fake_logits))
    if not effective_gan:
        adv = adv.detach()
    return loss + 0.01 * adv


def xbd_gan_discriminator_loss(real_logits: torch.Tensor,
                               fake_logits: torch.Tensor) -> torch.Tensor:
    """0.1 * (BCE(D(real), 1) + BCE(D(fake), 0)) / 2."""
    real = bce_with_logits(real_logits, torch.ones_like(real_logits))
    fake = bce_with_logits(fake_logits, torch.zeros_like(fake_logits))
    return 0.1 * (real + fake) / 2.0
