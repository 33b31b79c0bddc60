"""Primitive blocks of the DAHiTra eval and train paths.

Counterpart of dahitra_tpu/nn/blocks.py. Public layouts follow the JAX
package: NHWC images and (B, N, C) sequences; convolutions run through
channels-last views of the NHWC tensors, so no layout copy is made.
Parameters are fp32 and ``dtype`` is the compute type: products run in
``dtype``, LayerNorm and softmax in fp32.

Module trees reproduce the reference's ``state_dict`` names
(help_funcs.py: ``layers.i.0.fn.norm``, ``layers.i.0.fn.fn.to_q``, ...), so
a reference checkpoint loads as it is. Quirks kept:
  * attention scale ``dim ** -0.5`` on the model dim, not the head dim;
  * the decoder's PreNorm2 applies ONE LayerNorm to query and memory.

The TPU layout rewrites ``PhaseUpConv`` and ``PhasePackedConv``
(blocks.py:71-180) are the plain ``relu(conv3x3(up2(x)) + b)`` (``UpConv``)
and a plain 3x3 conv on the upsampled map.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dahitra_tpu_torch.kernels.fused_decoder import (ORDER, FusedDecoderFn,
                                                     pick_tile)
from dahitra_tpu_torch.kernels.fused_tokenizer import SemanticTokenizerFn
from dahitra_tpu_torch.nn.decoder_vjp import decoder_stack, pack_decoder_params


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding: int = 0, dtype=torch.float32) -> torch.Tensor:
    """NHWC conv with an OIHW weight, computed in ``dtype``."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), weight.to(dtype),
                 None if bias is None else bias.to(dtype), stride, padding)
    return y.permute(0, 2, 3, 1)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of NHWC (torch nn.Upsample default)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=factor,
                      mode="nearest")
    return y.permute(0, 2, 3, 1)


def upsample_bilinear(x: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """Bilinear upsample of NHWC with half-pixel centres (torch
    ``align_corners=False``, ``jax.image.resize`` "bilinear"). At the border
    jax renormalises its triangle weights and torch clamps the source index;
    both give the edge pixel there. Computed in x's dtype."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=factor,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, stride=2, padding=1) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """BatchNorm with fp32 statistics and arithmetic and its output in
    ``dtype``: dahitra_tpu/nn/resnet.py ``PairBatchNorm`` (:45-113) with
    ``_bn_out_dtype``.

    Eval (``train=False``) normalizes by the running statistics. Train takes
    the batch statistics over every axis but the last, with the biased
    variance ``max(E[x^2] - mu^2, 0)``, and updates the running statistics
    as flax does, ``ra <- 0.9 ra + 0.1 stat`` (the running variance takes
    the biased batch variance; ``nn.BatchNorm2d`` would feed it the unbiased
    one). ``pair=True`` reads the leading batch axis as [date1; date2]:
    each half is normalized by its own statistics and the running statistics
    take the two sequential updates, ``m (m ra + (1 - m) s1) + (1 - m) s2``.
    """

    momentum = 0.9

    def __init__(self, channels: int, dtype=torch.float32, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False,
                pair: bool = False) -> torch.Tensor:
        xf = x.float()
        mean, var = self.running_mean, self.running_var
        if train:
            xf = xf.reshape(2 if pair else 1, -1, x.shape[-1])
            gmean = xf.mean(1)
            gvar = ((xf * xf).mean(1) - gmean * gmean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                for s_mean, s_var in zip(gmean, gvar):
                    mean = m * mean + (1 - m) * s_mean
                    var = m * var + (1 - m) * s_var
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
            mean, var = gmean[:, None], gvar[:, None]
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).reshape(x.shape).to(self.dtype)


class TwoLayerConv(nn.Sequential):
    """conv3x3(no bias)-BN-ReLU-conv3x3 (help_funcs.py:7-15): keys 0, 1, 3."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__(
            nn.Conv2d(in_channels, in_channels, 3, padding=1, bias=False),
            BatchNorm(in_channels, dtype), nn.ReLU(),
            nn.Conv2d(in_channels, out_channels, 3, padding=1))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv2d_nhwc(x, self[0].weight, padding=1, dtype=self.dtype)
        x = torch.relu(self[1](x, train))
        return conv2d_nhwc(x, self[3].weight, self[3].bias, padding=1,
                           dtype=self.dtype)


class UpConv(nn.Sequential):
    """relu(conv3x3(nearest_up2(x)) + b): the math of PhaseUpConv
    (blocks.py:71), with the reference's ``Sequential(conv, relu)`` keys."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__(nn.Conv2d(in_channels, out_channels, 3, padding=1),
                         nn.ReLU())
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(conv2d_nhwc(upsample_nearest(x), self[0].weight,
                                      self[0].bias, padding=1,
                                      dtype=self.dtype))


def _dense(x: torch.Tensor, linear: nn.Linear, dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=dtype): inputs and weights cast to ``dtype``."""
    bias = None if linear.bias is None else linear.bias.to(dtype)
    return F.linear(x.to(dtype), linear.weight.to(dtype), bias)


class FeedForward(nn.Module):
    """Linear-GELU-Dropout-Linear-Dropout (help_funcs.py:52-63); the
    dropout rate is 0, so train and eval compute the same."""

    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(),
                                 nn.Dropout(0.0), nn.Linear(hidden_dim, dim),
                                 nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(_dense(x, self.net[0], self.dtype))
        return _dense(h, self.net[3], self.dtype)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, hd = t.shape
    return t.view(b, n, heads, hd // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def _attend(q, k, v, dim: int, softmax: bool = True) -> torch.Tensor:
    """Heads-split attention with the model-dim scale and fp32 softmax."""
    dots = torch.matmul(q, k.transpose(-1, -2)).float() * dim ** -0.5
    attn = torch.softmax(dots, dim=-1) if softmax else dots
    return _merge_heads(torch.matmul(attn.to(q.dtype), v))


class MultiHeadSelfAttention(nn.Module):
    """MHSA with a fused qkv projection (help_funcs.py:117-151)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_split_heads(t, self.heads) for t in
                   _dense(x, self.to_qkv, self.dtype).chunk(3, dim=-1))
        return _dense(_attend(q, k, v, self.dim), self.to_out[0], self.dtype)


class CrossAttention(nn.Module):
    """Query from x, key/value from memory m (help_funcs.py:66-114), with
    the max-shifted softmax; ``softmax=False`` mixes by the raw dots."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 softmax: bool = True, dtype=torch.float32):
        super().__init__()
        self.dim, self.heads, self.softmax, self.dtype = dim, heads, softmax, dtype
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        q, k, v = (_split_heads(_dense(t, lin, self.dtype), self.heads)
                   for t, lin in ((x, self.to_q), (m, self.to_k),
                                  (m, self.to_v)))
        out = _attend(q, k, v, self.dim, self.softmax)
        return _dense(out, self.to_out[0], self.dtype)


class PreNorm(nn.Module):
    """fn(LN(x), LN(m)...): one fp32 LayerNorm for the query and every
    memory argument (PreNorm and PreNorm2, help_funcs.py:30-49)."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x: torch.Tensor, *mem: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x.float()), *(self.norm(t.float()) for t in mem))


class Residual(nn.Module):
    """x + fn(x, ...) (Residual and Residual2, help_funcs.py:18-28)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor, *mem: torch.Tensor) -> torch.Tensor:
        return x + self.fn(x, *mem)


class TransformerEncoder(nn.Module):
    """depth x [x += MHSA(LN(x)); x += FF(LN(x))] (help_funcs.py:154-167)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            Residual(PreNorm(dim, MultiHeadSelfAttention(dim, heads, dim_head,
                                                         dtype))),
            Residual(PreNorm(dim, FeedForward(dim, mlp_dim, dtype))),
        ]) for _ in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ff in self.layers:
            x = ff(attn(x))
        return x


class TransformerDecoder(nn.Module):
    """depth x [x += CrossAttn(LN(x), LN(m)); x += FF(LN(x))]
    (help_funcs.py:170-186).

    Dispatch as in dahitra_tpu/nn/blocks.py:584-623. With ``pallas`` set
    (None means False, as in the JAX module), a softmax, a token count n
    that ``pick_tile`` takes, heads * tokens <= 128 and x's width ``dim``,
    the stack runs as ``FusedDecoderFn`` (the K4 kernel on the card; x as
    it comes, fp32 residual, output in x's dtype). Otherwise, with a
    softmax, at most 16 memory tokens, more than 4 queries per token and
    heads * tokens <= 128, it runs as ``decoder_stack`` (the K1 kernel on
    the card; "noshift" numerics, output in ``dtype``); otherwise layer by
    layer with the max-shifted softmax, residual in its input type.
    ``mlp_dim`` may differ from ``dim`` on every path, as in the JAX module;
    the kernels are built for ``mlp_dim`` 32 and 64 (BIT's decoder), so on
    the card the first two paths raise a ``ValueError`` naming ``mlp_dim``
    for any other width.
    """

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, softmax: bool = True, dtype=torch.float32,
                 pallas: Optional[bool] = None):
        super().__init__()
        self.dim, self.depth, self.heads = dim, depth, heads
        self.softmax, self.dtype, self.pallas = softmax, dtype, pallas
        self.layers = nn.ModuleList([nn.ModuleList([
            Residual(PreNorm(dim, CrossAttention(dim, heads, dim_head, softmax,
                                                 dtype))),
            Residual(PreNorm(dim, FeedForward(dim, mlp_dim, dtype))),
        ]) for _ in range(depth)])

    def uses_fused(self, n: int, n_kv: int, x_dim: int) -> bool:
        return bool(self.pallas and self.softmax and pick_tile(n) is not None
                    and self.heads * n_kv <= 128 and x_dim == self.dim)

    def uses_stack(self, n: int, n_kv: int, x_dim: int) -> bool:
        return (self.softmax and n_kv <= 16 and n > 4 * n_kv
                and self.heads * n_kv <= 128 and x_dim == self.dim)

    def forward(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        if self.uses_fused(x.shape[-2], m.shape[-2], x.shape[-1]):
            packed = pack_decoder_params(self)
            return FusedDecoderFn.apply(self.depth, self.heads, self.dtype, x,
                                        m, *(packed[k] for k in ORDER)
                                        ).to(x.dtype)
        if self.uses_stack(x.shape[-2], m.shape[-2], x.shape[-1]):
            return decoder_stack(x.to(self.dtype), m.to(self.dtype),
                                 pack_decoder_params(self), self.depth,
                                 self.heads, self.dtype)
        for attn, ff in self.layers:
            x = ff(attn(x, m))
        return x


class SemanticTokenizer(nn.Module):
    """Spatial-attention token pooling (networks.py:312-319): a 1x1 conv to
    L logits per pixel, a softmax over the pixels, attention-weighted sums
    of the features. Runs through the K3 kernel on the card, with its
    gradient in PyTorch operations (``SemanticTokenizerFn``). Its one
    parameter is the reference's ``conv_token`` weight (L, C, 1, 1)."""

    def __init__(self, dim: int, token_len: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(token_len, dim, 1, 1))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) -> tokens (B, L, C) in the compute dtype."""
        b, h, w, c = x.shape
        wt = self.weight.view(-1, c).t().to(self.dtype).contiguous()
        return SemanticTokenizerFn.apply(
            x.reshape(b, h * w, c).to(self.dtype).contiguous(), wt)
