"""The reference's ``init_net`` post-initialization.

Counterpart of dahitra_tpu/nn/init.py ``init_weights_variables`` (:80-121;
the reference's models/networks.py:77-127): every ``define_g`` model is
re-initialized after construction with ``init_type`` (default 'normal',
gain 0.02):

  * Conv and Linear weights (the tokenizer's 1x1 conv included) ~ N(0, gain^2),
    or xavier-normal / kaiming-normal (fan_in, a = 0) / orthogonal with torch's
    fan conventions; their biases are 0;
  * BatchNorm weight ~ N(1, gain^2), bias 0;
  * LayerNorms and the positional embeddings are left as the constructor made
    them (ones and zeros; N(0, 1)).

Every draw comes from ``generator``. The draws differ from the JAX
package's (another generator); their distributions are the same.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from dahitra_tpu_torch.nn.blocks import BatchNorm, SemanticTokenizer


def _fans(w: torch.Tensor):
    receptive = w[0][0].numel() if w.dim() > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive


def _draw(w: torch.Tensor, init_type: str, gain: float,
          generator: torch.Generator) -> torch.Tensor:
    def normal(std):
        return std * torch.randn(w.shape, generator=generator)

    fan_in, fan_out = _fans(w)
    if init_type == "normal":
        return normal(gain)
    if init_type == "xavier":
        return normal(gain * math.sqrt(2.0 / (fan_in + fan_out)))
    if init_type == "kaiming":
        return normal(math.sqrt(2.0 / fan_in))
    if init_type == "orthogonal":
        rows = w.shape[0]
        flat = torch.randn(max(rows, fan_in), min(rows, fan_in),
                           generator=generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        q = q if rows >= fan_in else q.t()
        return gain * q.reshape(w.shape)
    raise NotImplementedError(
        f"initialization method [{init_type}] is not implemented")


@torch.no_grad()
def init_weights(model: nn.Module, init_type: str = "normal",
                 init_gain: float = 0.02,
                 generator: torch.Generator = None) -> nn.Module:
    """Re-initialize ``model`` in place as ``init_net`` does; 'none' leaves
    it as it is. Returns the model."""
    if init_type == "none":
        return model
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.weight.copy_(1.0 + init_gain * torch.randn(
                module.weight.shape, generator=gen))
            module.bias.zero_()
        elif isinstance(module, (nn.Conv2d, nn.Linear, SemanticTokenizer)):
            module.weight.copy_(_draw(module.weight, init_type, init_gain, gen))
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
    return model


@torch.no_grad()
def init_random(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights for a model without a checkpoint (runs on seeded
    weights): lecun-normal conv and linear kernels, zero biases, unit BN and
    LayerNorm scales, unit-normal positional embeddings, and BN running
    statistics near identity. Returns the model."""
    for name, p in model.named_parameters():
        if name.startswith("pos_embedding"):
            p.normal_(0.0, 1.0, generator=generator)
        elif p.dim() > 1:
            fan_in = p[0].numel()
            p.normal_(0.0, fan_in ** -0.5, generator=generator)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.normal_(0.0, 0.1, generator=generator)
        elif name.endswith("running_var"):
            buf.uniform_(0.5, 1.5, generator=generator)
    return model
