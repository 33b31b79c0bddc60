"""The UNet change transformers (``unet_coupled_trans_256``,
``unet_coupled_two_trans_256``).

Counterpart of dahitra_tpu/models/unet_change_transformer.py (the
reference's models/networks.py:548-913): a siamese resnet34 encoder (the
xBD zoo's wrapped trunk, ``Res34Encoder``), a transformer over the fused
bottleneck whose TOKENS ARE THE CHANNELS (512 tokens of width
(img / 32)^2), and a decoder that concatenates both dates' skips, with the
reference's local decoder widths (48, 64, 96, 128, 320).

  * ``UNetChangeTransformer``: per-date channel attention on the global max
    with a final ReLU (``BottleneckChannelAttention``, a reference quirk
    kept), tanh fusion of the two dates (``ChannelAttentionFuse``), the
    transformer (depth 3, 4 heads, dropout 0.05), and a second fusion of
    its output with its input;
  * ``UNetChangeTwoTransformer``: the fusion gated by a softmax over the
    pixels of enc5_1 - enc5_2 (``spatial_softmax_gate``) before the
    transformer (dropout 0.01), and at 1/4 scale a second fusion, gate and
    transformer over 64 channel tokens of width (img / 4)^2 (depth 2, 2
    heads, dropout 0.001), whose output replaces both dates' 1/4 skips. Its
    ``ca_skip_2`` is the repair the JAX docstring explains: the reference's
    forward calls a module its ``__init__`` leaves out.

The module tree carries the reference's ``state_dict`` names, which
dahitra_tpu/core/torch_import.py ``convert_unet_change_transformer`` reads;
the modules the reference builds and never calls are not built. Both dates
run through the encoder batch-stacked, each BatchNorm taking per-date
statistics in train mode (the JAX module's two encoder calls). Dropout is
active in train mode (``set_dropout_generator``).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from dahitra_tpu_torch.models.res34_unet import ENCODER_FILTERS, Res34Encoder
from dahitra_tpu_torch.nn.blocks import (ConvRelu, TransformerEncoder,
                                         conv2d_nhwc, upsample_nearest)

DEC = (48, 64, 96, 128, 320)


class ChannelAttentionFuse(nn.Module):
    """conv3x3(2C -> C, no bias) of cat(a, b), then tanh
    (networks.py:419-431); ``activation="relu"`` is the xBD zoo's copy
    (zoo/models.py:993-1003)."""

    def __init__(self, channels: int, activation: str = "tanh",
                 dtype=torch.float32):
        super().__init__()
        self.activation, self.dtype = activation, dtype
        self.conv1 = nn.Conv2d(2 * channels, channels, 3, padding=1,
                               bias=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = conv2d_nhwc(torch.cat([a, b], -1), self.conv1.weight, padding=1,
                        dtype=self.dtype)
        return torch.tanh(x) if self.activation == "tanh" else torch.relu(x)


class BottleneckChannelAttention(nn.Module):
    """Squeeze-excite on the global max, ending in a ReLU, not a sigmoid
    (networks.py:516-545, att_type 'max')."""

    def __init__(self, channels: int, ratio: int = 16, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Conv2d(channels, channels // ratio, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // ratio, channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = x.amax(dim=(1, 2), keepdim=True)
        m = torch.relu(conv2d_nhwc(m, self.fc1.weight, dtype=self.dtype))
        return torch.relu(conv2d_nhwc(m, self.fc2.weight, dtype=self.dtype))


def channel_tokens(transformer: TransformerEncoder, x: torch.Tensor,
                   deterministic: bool) -> torch.Tensor:
    """The transformer over the channel axis: (B, H, W, C) -> tokens
    (B, C, H * W) -> back."""
    b, h, w, c = x.shape
    tokens = x.reshape(b, h * w, c).transpose(1, 2)
    tokens = transformer(tokens, deterministic=deterministic)
    return tokens.transpose(1, 2).reshape(b, h, w, c)


def spatial_softmax_gate(fused: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """``fused`` times the softmax over the pixels of (a - b), channel by
    channel, in fp32 (networks.py:846-850)."""
    bs, h, w, c = fused.shape
    att = torch.softmax((a - b).reshape(bs, h * w, c).float(), dim=1)
    return (att.to(fused.dtype) * fused.reshape(bs, h * w, c)).reshape(
        bs, h, w, c)


class _UNetChangeBase(Res34Encoder):
    """The encoder, the decoder convs ``conv6``-``conv10`` (their ``_2``
    read the upsampled map and both dates' skips, at the 1/4 level
    ``skip_8`` channels) and the 1x1 head ``res``."""

    def __init__(self, output_nc: int, dtype, skip_8: int):
        super().__init__(dtype)
        e = ENCODER_FILTERS
        ins = {6: e[4], 7: DEC[4], 8: DEC[3], 9: DEC[2], 10: DEC[1]}
        skips = {6: 2 * e[3], 7: 2 * e[2], 8: skip_8, 9: 2 * e[0]}
        outs = {6: DEC[4], 7: DEC[3], 8: DEC[2], 9: DEC[1], 10: DEC[0]}
        for i in range(6, 11):
            self.add_module(f"conv{i}", ConvRelu(ins[i], outs[i], dtype=dtype))
            if i < 10:
                self.add_module(f"conv{i}_2", ConvRelu(
                    outs[i] + skips[i], outs[i], dtype=dtype))
        self.res = nn.Conv2d(DEC[0], output_nc, 1)

    def dates(self, x1: torch.Tensor, x2: torch.Tensor, train: bool):
        """Each encoder level of both dates: ((enc1_1, enc1_2), ...)."""
        levels = self.encode(torch.cat([x1, x2], 0), train, pair=train)
        return [t.chunk(2, 0) for t in levels]

    def up(self, level: int, x: torch.Tensor, *skips: torch.Tensor
           ) -> torch.Tensor:
        """``conv{level}(up2(x))``, then ``conv{level}_2`` of it and the
        skips concatenated (none for level 10)."""
        x = getattr(self, f"conv{level}")(upsample_nearest(x, 2))
        if not skips:
            return x
        return getattr(self, f"conv{level}_2")(torch.cat([x, *skips], -1))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.res.weight, self.res.bias, dtype=self.dtype)


class UNetChangeTransformer(_UNetChangeBase):
    """``unet_coupled_trans_256``: NHWC images (B, H, W, 3) twice -> logits
    (B, H, W, output_nc) in the compute dtype."""

    def __init__(self, output_nc: int = 2, img_size: int = 256,
                 dtype=torch.float32):
        super().__init__(output_nc, dtype, 2 * ENCODER_FILTERS[1])
        dim = (img_size // 32) ** 2
        self.ca_bottle_max = BottleneckChannelAttention(512, dtype=dtype)
        self.ca_skip_5 = ChannelAttentionFuse(512, dtype=dtype)
        self.transformer = TransformerEncoder(dim, 3, 4, 64, 2 * dim, dtype,
                                              dropout=0.05)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        e1, e2, e3, e4, (e5_1, e5_2) = self.dates(x1, x2, train)
        e5_1 = self.ca_bottle_max(e5_1) * e5_1
        e5_2 = self.ca_bottle_max(e5_2) * e5_2
        enc5_c = self.ca_skip_5(e5_1, e5_2)
        enc5 = channel_tokens(self.transformer, enc5_c, not train)
        enc5 = self.ca_skip_5(enc5, enc5_c)
        d = self.up(6, enc5, *e4)
        d = self.up(7, d, *e3)
        d = self.up(8, d, *e2)
        d = self.up(9, d, *e1)
        return self.head(self.up(10, d))


class UNetChangeTwoTransformer(_UNetChangeBase):
    """``unet_coupled_two_trans_256``: NHWC images (B, H, W, 3) twice ->
    logits (B, H, W, output_nc) in the compute dtype."""

    def __init__(self, output_nc: int = 2, img_size: int = 256,
                 dtype=torch.float32):
        # The 1/4 level reads transformer2's output (64 channels), not both
        # dates' skips.
        super().__init__(output_nc, dtype, ENCODER_FILTERS[1])
        dim5, dim2 = (img_size // 32) ** 2, (img_size // 4) ** 2
        self.ca_skip_5 = ChannelAttentionFuse(512, dtype=dtype)
        self.ca_skip_2 = ChannelAttentionFuse(64, dtype=dtype)
        self.transformer = TransformerEncoder(dim5, 3, 4, 64, 2 * 64, dtype,
                                              dropout=0.01)
        self.transformer2 = TransformerEncoder(dim2, 2, 2, 64, dim2, dtype,
                                               dropout=0.001)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        e1, e2, e3, e4, e5 = self.dates(x1, x2, train)
        enc5 = spatial_softmax_gate(self.ca_skip_5(*e5), *e5)
        enc5 = channel_tokens(self.transformer, enc5, not train)
        d = self.up(6, enc5, *e4)
        d = self.up(7, d, *e3)
        enc2 = spatial_softmax_gate(self.ca_skip_2(*e2), *e2)
        enc2 = channel_tokens(self.transformer2, enc2, not train)
        d = self.up(8, d, enc2)
        d = self.up(9, d, *e1)
        return self.head(self.up(10, d))
