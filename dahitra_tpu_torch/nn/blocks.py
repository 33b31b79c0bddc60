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

Dropout (blocks.py:340-517) is ``Dropout``: active only when the caller
runs the block with ``deterministic=False`` (train mode) at a rate above 0,
its mask drawn from the ``torch.Generator`` that ``set_dropout_generator``
gave the model (on the tensor's device), or from torch's default generator.
At rate 0 every block computes what it computes without dropout.

``DAHITRA_FAST_VJP=0`` in the environment at import (blocks.py:33), or
``TransformerDecoder(fast_vjp=False)``, sends the shapes that would take
the decoder stack to the layer loop instead.

Under a row-sharded grid (``nn/space.py``) the spatial ops take halos, as
GSPMD adds them: a k x k convolution of stride s and padding p gets p rows
from the rank above and k - s - p from the rank below (zeros at the global
edges) and then pads only the columns; the 3 x 3 / 2 max-pool 1 and 0
(-inf); the bilinear resizes one row each side (the edge row at the global
edges), cropping the factor's rows off each side of the result; a k x k
transposed convolution of stride s, padding p and output padding op whose
output has s times its input's rows (k - s - 2p + op = 0) (k - 1 - p) // s
rows from above and (p + s - 1) // s from below (zeros), cropping its
output to the rank's s h rows; ``upsample_nearest`` and ``max_pool_2x2``
read no row across a shard's edge. BatchNorm's statistics then sum over
every rank's distinct rows, the tokenizer's softmax spans the ranks (the
rank-split K3), the decoder gates read the global token count, and
``TransformerEncoder(..., width=rows)`` runs on tokens whose width is the
pixels, each rank holding its block (the channel-token transformers).
The pools go down a level and the upsamplings and strided transposed
convolutions up one through ``space.descend`` / ``space.ascend``; a
strided convolution's caller (a trunk's stem, a ResNet block) calls
``descend`` for it. At a whole level (``space.rows()`` None) every op,
BatchNorm, the tokenizer (the one-process K3) and the decoder gates run as
on one process.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dahitra_tpu_torch.core.mesh import (all_gather_rows, all_reduce_sum,
                                         world_size)
from dahitra_tpu_torch.kernels.fused_decoder import (ORDER, FusedDecoderFn,
                                                     pick_tile)
from dahitra_tpu_torch.kernels.fused_tokenizer import (
    SemanticTokenizerFn, SemanticTokenizerRanksFn)
from dahitra_tpu_torch.nn import space
from dahitra_tpu_torch.nn.decoder_vjp import decoder_stack, pack_decoder_params

# Read once at import, as the JAX package does (blocks.py:28-33).
_FAST_VJP_DEFAULT = os.environ.get("DAHITRA_FAST_VJP", "1") != "0"


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding: int = 0, dtype=torch.float32,
                groups: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW weight, computed in ``dtype``; under row
    sharding, on the rank's rows with their halos (with a stride, rows that
    ``space.descend`` passed)."""
    pad = padding
    r = space.rows()
    if r is not None:
        if x.shape[1] % stride:
            raise ValueError(f"conv2d_nhwc: {x.shape[1]} rows per space rank "
                             f"at stride {stride}; call space.descend first")
        x = space.halo(x, padding, weight.shape[2] - stride - padding,
                       "zero", r)
        pad = (0, padding)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), weight.to(dtype),
                 None if bias is None else bias.to(dtype), stride, pad,
                 1, groups)
    return y.permute(0, 2, 3, 1)


def apply_conv(conv: nn.Conv2d, x: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """``conv`` (its weight, bias, stride, padding and groups) on NHWC,
    computed in ``dtype``."""
    return conv2d_nhwc(x, conv.weight, conv.bias, conv.stride[0],
                       conv.padding[0], dtype, conv.groups)


def conv_transpose2d_nhwc(x: torch.Tensor, conv: nn.ConvTranspose2d,
                          dtype=torch.float32) -> torch.Tensor:
    """NHWC ``nn.ConvTranspose2d`` (its stride, padding and output padding),
    computed in ``dtype``; with a stride s, up a level (``space.ascend``).
    Under row sharding, on the rank's rows with their halos: output row o
    reads the input rows (o + p - t) / s of the taps t that divide, so
    where the output has s times the input's rows (k - s - 2p + op = 0) a
    rank takes (k - 1 - p) // s rows from the rank above and (p + s - 1)
    // s from the rank below (zeros at the global edges), runs the
    transposed convolution with no row padding and keeps its s h rows from
    row (k - 1 - p) // s * s + p on."""
    (k, _), (s, _) = conv.kernel_size, conv.stride
    p, op = conv.padding[0], conv.output_padding[0]
    bias = None if conv.bias is None else conv.bias.to(dtype)
    pad, out_pad = conv.padding, conv.output_padding
    r = space.rows()
    if r is not None:
        if k - s - 2 * p + op:
            raise ValueError(
                f"conv_transpose2d_nhwc: kernel {k}, stride {s}, padding "
                f"{p}, output padding {op} does not give each space rank "
                f"{s} times its rows")
        h, top = x.shape[1], (k - 1 - p) // s
        x = space.halo(x, top, (p + s - 1) // s, "zero", r)
        pad, out_pad = (0, conv.padding[1]), (0, conv.output_padding[1])
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dtype),
                           conv.weight.to(dtype), bias, conv.stride, pad,
                           out_pad)
    if r is not None:
        y = y[:, :, top * s + p:top * s + p + s * h]
    return space.ascend(y.permute(0, 2, 3, 1), s)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of NHWC (torch nn.Upsample default); up a
    level (``space.ascend``)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=factor,
                      mode="nearest")
    return space.ascend(y.permute(0, 2, 3, 1), factor)


def upsample_bilinear(x: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """Bilinear upsample of NHWC with half-pixel centres (torch
    ``align_corners=False``, ``jax.image.resize`` "bilinear"). At the border
    jax renormalises its triangle weights and torch clamps the source index;
    both give the edge pixel there. Computed in x's dtype; up a level
    (``space.ascend``)."""
    if space.rows() is not None:
        return resize_bilinear(x, factor * x.shape[1], factor * x.shape[2])
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=factor,
                      mode="bilinear", align_corners=False)
    return space.ascend(y.permute(0, 2, 3, 1), factor)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, stride=2, padding=1) on NHWC; down a level
    (``space.descend``), on the rank's rows with their halos where they
    split."""
    pad = 1
    x = space.descend(x, 2, 1)
    r = space.rows()
    if r is not None:
        x, pad = space.halo(x, 1, 0, "neg_inf", r), (0, 1)
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, pad).permute(0, 2, 3, 1)


def max_pool_3x3_s2_ceil(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, stride=2, ceil_mode=True) on NHWC: no padding,
    the last, clipped window kept (the SENet pool, blocks.py:204)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2,
                        ceil_mode=True).permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC resized to (h, w) bilinearly with half-pixel centres
    (``jax.image.resize`` "bilinear" when it enlarges; see
    ``upsample_bilinear``). Computed in x's dtype; up a level
    (``space.ascend``). Under row sharding ``h`` is the rank's rows of the
    result, a whole multiple f of x's: the rows with a halo of one each side
    (the edge row at the global edges), resized to f times as many, and f
    rows cropped off each side."""
    r = space.rows()
    if r is None:
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w),
                          mode="bilinear", align_corners=False)
        return space.ascend(y.permute(0, 2, 3, 1), h / x.shape[1])
    f = h // x.shape[1]
    if f * x.shape[1] != h:
        raise ValueError(f"resize_bilinear: {x.shape[1]} rows per space rank "
                         f"to {h} is not a whole factor")
    x = space.halo(x, 1, 1, "edge", r)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(f * x.shape[1], w),
                      mode="bilinear", align_corners=False)
    return space.ascend(y[:, :, f:f + h].permute(0, 2, 3, 1), f)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """torch F.max_pool2d(kernel_size=2, stride=2) on NHWC: an odd last row
    or column is dropped (blocks.py:220); down a level (``space.descend``)."""
    x = space.descend(x, 2)
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class Dropout(nn.Module):
    """Dropout at ``rate`` (flax ``nn.Dropout``): kept elements scaled by
    1 / (1 - rate). ``per`` picks the mask's shape from x's: "element"
    (``nn.Dropout``), "channel" (``Dropout2d`` on NHWC, one draw per sample
    and channel, flax ``broadcast_dims=(1, 2)``) or "sample" (drop path,
    one draw per sample). Identity when ``deterministic`` or at rate 0.
    ``generator`` (set by ``set_dropout_generator``) lies on the device of
    the tensors it drops from; None draws from torch's default generator."""

    def __init__(self, rate: float = 0.0, per: str = "element"):
        super().__init__()
        self.rate, self.per = float(rate), per
        self.generator: Optional[torch.Generator] = None

    def mask_shape(self, x: torch.Tensor):
        if self.per == "channel":
            return (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        if self.per == "sample":
            return (x.shape[0],) + (1,) * (x.dim() - 1)
        return x.shape

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                shard: Optional[space.Rows] = None,
                axis: int = -1) -> torch.Tensor:
        """``shard``: x's ``axis`` is the rank's block of one sharded over
        ``shard``'s group: the last, a token width (``TransformerEncoder(
        ..., width=)``); 1, the rows of an NHWC map; 2, the queries of a
        (B, heads, Nq, Nk) attention matrix (row-major, so a rank's queries
        are one block). The mask is drawn at the whole size and sliced to
        the block, as one process draws it; a mask that does not vary
        along that axis (per sample, per channel) is drawn as it is."""
        if deterministic or self.rate == 0.0:
            return x
        shape = list(self.mask_shape(x))
        axis %= x.dim()
        split = shard is not None and shape[axis] > 1
        if split:
            shape[axis] *= shard.size
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) >= self.rate
        if split:
            n = x.shape[axis]
            keep = keep.narrow(axis, shard.rank * n, n)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Draw every ``Dropout`` mask of ``model`` from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def _global_moments(xf: torch.Tensor, group=None):
    """Mean and biased variance of (G, n, C) per group over the rows of
    every rank of ``group`` (the world by default): one all-reduce of
    [sum x | sum x^2 | n] per group."""
    c = xf.shape[-1]
    n = xf.new_full((xf.shape[0], 1), float(xf.shape[1]))
    sums = all_reduce_sum(torch.cat([xf.sum(1), (xf * xf).sum(1), n], -1),
                          group)
    count = sums[:, 2 * c:]
    mean = sums[:, :c] / count
    var = (sums[:, c:2 * c] / count - mean * mean).clamp_min(0.0)
    return mean, var


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
    ``momentum`` is flax's (torch's 1 - momentum).

    Under a process group of more than one rank (``core/mesh.py``) the
    train statistics are those of the global batch, as GSPMD makes them on
    the JAX ``data`` axis: each rank's per-date sums of x and x^2 and its
    element count go through one differentiable all-reduce (in pair mode
    the date-1 statistics come from every rank's first half), and every
    rank takes the same running update. Filler rows of a padded batch enter
    them, as in the JAX package. Under a row-sharded grid every rank holds
    distinct rows, so the same world sum is GSPMD's statistic over the
    space axis too; on a replicated grid and at a whole level (every rank of
    a data row with the same whole rows) the sum runs over the data group
    (``nn/space.py`` ``stat_group``), so each pixel counts once.
    """

    def __init__(self, channels: int, dtype=torch.float32, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.momentum = momentum
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
            group = space.stat_group()
            if world_size(group) > 1:
                gmean, gvar = _global_moments(xf, group)
            else:
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


class ConvReluBN(nn.Module):
    """conv3x3 (padding 1)-BN-ReLU (networks.py:396-405; the JAX
    ``ConvReluBN``, blocks.py:322), with ``conv`` and ``bn`` submodules."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.bn = BatchNorm(out_channels, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv2d_nhwc(x, self.conv.weight, self.conv.bias, padding=1,
                        dtype=self.dtype)
        return torch.relu(self.bn(x, train))


class ConvRelu(nn.Module):
    """conv3x3 (padding 1) then ReLU (networks.py:408-416; the JAX
    ``ConvRelu``), with the reference's ``layer = Sequential(conv, relu)``
    keys (``layer.0.weight``, ``layer.0.bias``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layer = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, kernel_size,
                      padding=kernel_size // 2), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(apply_conv(self.layer[0], x, self.dtype))


def _dense(x: torch.Tensor, linear: nn.Linear, dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=dtype): inputs and weights cast to ``dtype``."""
    bias = None if linear.bias is None else linear.bias.to(dtype)
    return F.linear(x.to(dtype), linear.weight.to(dtype), bias)


# A token width sharded over a group (``TransformerEncoder``'s ``width``):
# each rank holds the contiguous block ``_width_block`` of every token.

def _width_block(width: space.Rows, n: int) -> slice:
    """The rank's block of a width of ``n`` per rank."""
    return slice(width.rank * n, (width.rank + 1) * n)


def _dense_in(x: torch.Tensor, linear: nn.Linear, dtype,
              width: Optional[space.Rows] = None) -> torch.Tensor:
    """``_dense``; with ``width``, of x whose last axis is the rank's block
    of the input width: its block by its columns of the weight, the partial
    products summed over the group in fp32, the bias added once after the
    sum."""
    if width is None:
        return _dense(x, linear, dtype)
    w = linear.weight[:, _width_block(width, x.shape[-1])]
    y = all_reduce_sum(F.linear(x.to(dtype), w.to(dtype)).float(),
                       width.group)
    return (y if linear.bias is None else y + linear.bias).to(dtype)


def _dense_out(x: torch.Tensor, linear: nn.Linear, dtype,
               width: Optional[space.Rows], n: int) -> torch.Tensor:
    """``_dense``; with ``width``, the rank's block (``n`` wide) of its
    output: its rows of the weight and of the bias."""
    if width is None:
        return _dense(x, linear, dtype)
    block = _width_block(width, n)
    bias = None if linear.bias is None else linear.bias[block].to(dtype)
    return F.linear(x.to(dtype), linear.weight[block].to(dtype), bias)


def _layer_norm_block(norm: nn.LayerNorm, x: torch.Tensor,
                      width: space.Rows) -> torch.Tensor:
    """``norm`` of fp32 x whose last axis is the rank's block of the
    normalized width: the global moments from every rank's block mean and
    sum of squared deviations (one gather over the group, combined as
    Chan's parallel variance), gamma and beta sliced to the block."""
    n = x.shape[-1]
    mean = x.mean(-1, keepdim=True)
    m2 = (x - mean).square().sum(-1, keepdim=True)
    parts = all_gather_rows(torch.stack([mean, m2]), width.group)
    means, m2s = parts[0::2], parts[1::2]
    g_mean = means.mean(0)
    var = (m2s.sum(0) + n * (means - g_mean).square().sum(0)) \
        / (n * width.size)
    block = _width_block(width, n)
    return ((x - g_mean) * torch.rsqrt(var + norm.eps) * norm.weight[block]
            + norm.bias[block])


class FeedForward(nn.Module):
    """Linear-GELU-Dropout-Linear-Dropout (help_funcs.py:52-63)."""

    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(),
                                 Dropout(dropout), nn.Linear(hidden_dim, dim),
                                 Dropout(dropout))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                width: Optional[space.Rows] = None) -> torch.Tensor:
        """``width``: x holds the rank's block of the model width
        (``TransformerEncoder``); the hidden units are whole on every
        rank, their dropout drawn as one process draws it."""
        h = self.net[2](F.gelu(_dense_in(x, self.net[0], self.dtype, width)),
                        deterministic)
        return self.net[4](_dense_out(h, self.net[3], self.dtype, width,
                                      x.shape[-1]), deterministic, width)


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
                 dtype=torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), Dropout(dropout))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                width: Optional[space.Rows] = None) -> torch.Tensor:
        """``width``: x holds the rank's block of the model width
        (``TransformerEncoder``); q, k, v and the attention are whole on
        every rank, the output the rank's block."""
        q, k, v = (_split_heads(t, self.heads) for t in _dense_in(
            x, self.to_qkv, self.dtype, width).chunk(3, dim=-1))
        out = _dense_out(_attend(q, k, v, self.dim), self.to_out[0],
                         self.dtype, width, x.shape[-1])
        return self.to_out[1](out, deterministic, width)


class CrossAttention(nn.Module):
    """Query from x, key/value from memory m (help_funcs.py:66-114), with
    the max-shifted softmax; ``softmax=False`` mixes by the raw dots."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 softmax: bool = True, dtype=torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.dim, self.heads, self.softmax, self.dtype = dim, heads, softmax, dtype
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), Dropout(dropout))

    def forward(self, x: torch.Tensor, m: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        q, k, v = (_split_heads(_dense(t, lin, self.dtype), self.heads)
                   for t, lin in ((x, self.to_q), (m, self.to_k),
                                  (m, self.to_v)))
        out = _attend(q, k, v, self.dim, self.softmax)
        return self.to_out[1](_dense(out, self.to_out[0], self.dtype),
                              deterministic)


class PreNorm(nn.Module):
    """fn(LN(x), LN(m)...): one fp32 LayerNorm for the query and every
    memory argument (PreNorm and PreNorm2, help_funcs.py:30-49)."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x: torch.Tensor, *mem: torch.Tensor,
                width: Optional[space.Rows] = None, **kw) -> torch.Tensor:
        if width is not None:  # no memory: TransformerEncoder's
            return self.fn(_layer_norm_block(self.norm, x.float(), width),
                           width=width, **kw)
        return self.fn(self.norm(x.float()),
                       *(self.norm(t.float()) for t in mem), **kw)


class Residual(nn.Module):
    """x + fn(x, ...) (Residual and Residual2, help_funcs.py:18-28)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor, *mem: torch.Tensor,
                **kw) -> torch.Tensor:
        return x + self.fn(x, *mem, **kw)


class TransformerEncoder(nn.Module):
    """depth x [x += MHSA(LN(x)); x += FF(LN(x))] (help_funcs.py:154-167).

    ``forward(..., width=rows)`` runs it on a token width sharded over
    ``rows``' group (the channel-token transformers on row-sharded maps,
    ``models/unet_change_transformer.py`` ``channel_tokens``), as GSPMD
    shards the width: x holds the rank's contiguous block of ``dim``; the
    LayerNorms take the global moments (one gather over the group) with
    gamma and beta sliced to the block; the products that contract over
    the width (``to_qkv``, the feed-forward's first) multiply the block by
    the weight's columns for it and sum the partial products over the
    group (``all_reduce_sum``, the bias added once after), so that q, k,
    v, the attention (scale ``dim ** -0.5`` on the whole width) and the
    hidden units are whole on every rank; the products that give the width
    (``to_out``, the feed-forward's second) give the rank's block from its
    rows of the weight and bias, and the residual stays on the block. The
    dropout masks of width-shaped tensors are drawn at the whole width and
    sliced, those of the hidden units whole, so the ranks draw as one
    process does. Each rank's backward carries its block's share of the
    gradient through the whole part, and the all-reduce's backward sums
    the shares, so every rank's block takes its whole gradient.
    """

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dtype=torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dim = dim
        self.layers = nn.ModuleList([nn.ModuleList([
            Residual(PreNorm(dim, MultiHeadSelfAttention(dim, heads, dim_head,
                                                         dtype, dropout))),
            Residual(PreNorm(dim, FeedForward(dim, mlp_dim, dtype, dropout))),
        ]) for _ in range(depth)])

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                width: Optional[space.Rows] = None) -> torch.Tensor:
        if width is not None and x.shape[-1] * width.size != self.dim:
            raise ValueError(f"TransformerEncoder: {width.size} blocks of "
                             f"{x.shape[-1]} are not its width {self.dim}")
        for attn, ff in self.layers:
            x = ff(attn(x, deterministic=deterministic, width=width),
                   deterministic=deterministic, width=width)
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
    for any other width. Both kernel paths also need ``deterministic`` or
    a ``dropout`` of 0; ``fast_vjp=False`` (or ``DAHITRA_FAST_VJP=0`` at
    import) closes the stack path (the JAX gates, blocks.py:585-600). Under
    row sharding the gates read the global token count, the rank's n times
    the space ranks, as GSPMD traces them on global shapes; the stack or K4
    then runs on the rank's rows, and the memory tokens' gradient a rank's
    backward gives is its rows' part, which the rank-split K3's backward
    sums over the space group. At a whole level (``space.rows()`` None) the
    gates read x's own count, the whole one.
    """

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, softmax: bool = True, dtype=torch.float32,
                 pallas: Optional[bool] = None, dropout: float = 0.0,
                 fast_vjp: Optional[bool] = None):
        super().__init__()
        self.dim, self.depth, self.heads = dim, depth, heads
        self.softmax, self.dtype, self.pallas = softmax, dtype, pallas
        self.dropout, self.fast_vjp = float(dropout), fast_vjp
        self.layers = nn.ModuleList([nn.ModuleList([
            Residual(PreNorm(dim, CrossAttention(dim, heads, dim_head, softmax,
                                                 dtype, dropout))),
            Residual(PreNorm(dim, FeedForward(dim, mlp_dim, dtype, dropout))),
        ]) for _ in range(depth)])

    def uses_fused(self, n: int, n_kv: int, x_dim: int,
                   deterministic: bool = True) -> bool:
        return bool(self.pallas and self.softmax
                    and (deterministic or self.dropout == 0.0)
                    and pick_tile(n) is not None
                    and self.heads * n_kv <= 128 and x_dim == self.dim)

    def uses_stack(self, n: int, n_kv: int, x_dim: int,
                   deterministic: bool = True) -> bool:
        return (self.fast_vjp is not False and _FAST_VJP_DEFAULT
                and self.softmax and (deterministic or self.dropout == 0.0)
                and n_kv <= 16 and n > 4 * n_kv
                and self.heads * n_kv <= 128 and x_dim == self.dim)

    def forward(self, x: torch.Tensor, m: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        r = space.rows()
        n = x.shape[-2] * (r.size if r is not None else 1)
        shape = (n, m.shape[-2], x.shape[-1], deterministic)
        if self.uses_fused(*shape):
            packed = pack_decoder_params(self)
            return FusedDecoderFn.apply(self.depth, self.heads, self.dtype, x,
                                        m, *(packed[k] for k in ORDER)
                                        ).to(x.dtype)
        if self.uses_stack(*shape):
            return decoder_stack(x.to(self.dtype), m.to(self.dtype),
                                 pack_decoder_params(self), self.depth,
                                 self.heads, self.dtype)
        for attn, ff in self.layers:
            x = ff(attn(x, m, deterministic=deterministic),
                   deterministic=deterministic)
        return x


class SemanticTokenizer(nn.Module):
    """Spatial-attention token pooling (networks.py:312-319): a 1x1 conv to
    L logits per pixel, a softmax over the pixels, attention-weighted sums
    of the features. Runs through the K3 kernel on the card, with its
    gradient in PyTorch operations (``SemanticTokenizerFn``); under row
    sharding the softmax spans the space ranks (``SemanticTokenizerRanksFn``,
    the rank-split K3), and every rank gets the same tokens; at a whole
    level every rank runs the one-process K3 on the whole rows. Its one
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
        seq = x.reshape(b, h * w, c).to(self.dtype).contiguous()
        r = space.rows()
        if r is not None:
            return SemanticTokenizerRanksFn.apply(seq, wt, r.group)
        return SemanticTokenizerFn.apply(seq, wt)
