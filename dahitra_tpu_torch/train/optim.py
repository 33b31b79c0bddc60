"""Optimizer and epoch-indexed learning-rate schedules.

Counterpart of dahitra_tpu/train/optim.py (the reference's
models/trainer.py:39-40 and models/networks.py:22-49):

  * ``make_optimizer``: AdamW(lr, betas (0.9, 0.999), eps 1e-8, weight decay
    0.01) over ALL parameters (biases and norm affines decay too, as torch's
    AdamW does in the reference), with an optional global-norm clip applied
    BEFORE the step (optax ``clip_by_global_norm``: scale by
    ``max_norm / norm`` when the norm exceeds it). The LEVIR trainer does not
    clip: the reference clips after ``optimizer.step()``, which never touches
    an applied update.
  * ``epoch_lr`` (linear / step / multistep / constant), ``poly_lr`` and
    ``sgdr_lr``: the same curves as the JAX package.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

import torch

LEVIR_MULTISTEP_MILESTONES = (2, 4, 7, 11, 15, 25, 35, 47, 60, 70, 90, 110,
                              130, 150, 170, 180, 190)
XBD_MULTISTEP_MILESTONES = (5, 11, 23, 29, 33, 47, 50, 60, 70, 90, 110, 130,
                            150, 170, 180, 190)


def epoch_lr(base_lr: float, epoch: int, policy: str, max_epochs: int,
             milestones: Sequence[int] = LEVIR_MULTISTEP_MILESTONES,
             gamma: float = 0.5, after_epoch_step: bool = False) -> float:
    """LR of ``epoch`` under the reference's policies. ``after_epoch_step``
    is the xBD pattern ``scheduler.step(epoch)`` at the epoch's end: each
    multistep drop takes effect one epoch after its milestone."""
    if policy == "linear":
        return base_lr * (1.0 - epoch / float(max_epochs + 1))
    if policy == "step":
        step_size = max(max_epochs // 3, 1)
        return base_lr * (0.1 ** (epoch // step_size))
    if policy == "multistep":
        e = epoch - 1 if after_epoch_step else epoch
        n = sum(1 for m in milestones if e >= m)
        return base_lr * (gamma ** n)
    if policy == "constant":
        return base_lr
    raise NotImplementedError(
        f"learning rate policy [{policy}] is not implemented")


def poly_lr(base_lr: float, step: int, max_step: int,
            momentum: float = 0.9) -> float:
    """PolyOptimizer curve: lr * (1 - step/max_step)^0.9."""
    return base_lr * (1.0 - min(step, max_step) / float(max_step)) ** momentum


def sgdr_lr(base_lr: float, step: int, cycle_steps: int,
            min_lr_ratio: float = 0.0) -> float:
    """SGDR warm-restart cosine curve within each cycle."""
    t = (step % cycle_steps) / float(cycle_steps)
    lo = base_lr * min_lr_ratio
    return lo + 0.5 * (base_lr - lo) * (1.0 + math.cos(math.pi * t))


class AdamW(torch.optim.AdamW):
    """torch AdamW with an optional global-norm clip of the gradients before
    each step (``clip_norm``; None = no clip)."""

    def __init__(self, params, clip_norm: Optional[float] = None, **kwargs):
        super().__init__(params, **kwargs)
        self.clip_norm = clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        if self.clip_norm is not None:
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            norm = torch.sqrt(sum(gr.float().square().sum() for gr in grads))
            scale = self.clip_norm / torch.maximum(
                norm, torch.tensor(self.clip_norm, device=norm.device))
            for gr in grads:
                gr.mul_(scale)
        return super().step(closure)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 0.01, b1: float = 0.9,
                   b2: float = 0.999, clip_norm: Optional[float] = None
                   ) -> AdamW:
    return AdamW(params, clip_norm=clip_norm, lr=lr, betas=(b1, b2), eps=1e-8,
                 weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
