"""The xBD 6-channel UNet change transformers (``xbd_unet_change_transformer``,
``xbd_unet_change_transformer_bit``).

Counterpart of dahitra_tpu/models/xbd_unet_change_transformer.py (the
reference's xBD_code/zoo/models.py:1094-1368): the zoo's resnet34 trunk
(``Res34Encoder``) on both dates of the split 6-channel input, the two
dates fused at every skip level by ``ChannelAttentionFuse(activation=
"relu")``, and a UNet decoder (``DEC``, or ``DEC_BIT``) to 5 logits.
With ``use_bit`` the bottleneck of each date is first gated by
``BottleneckChannelAttention``, and the fused bottleneck goes through the
channel-token transformer (512 tokens of width dim = (img / 32)^2, depth
8, 4 heads, dim_head dim, mlp dim^2, dropout 0.05) and is fused again with
its input. The reference's quirk is kept: the finest skip is fused with
``ca_skip_2``, not a ``ca_skip_1`` (models.py:1205, :1352).

The module tree carries the reference's ``state_dict`` names, which
dahitra_tpu/core/torch_import.py ``convert_xbd_unet_change_transformer``
reads. Both dates run through the encoder batch-stacked, each BatchNorm
taking per-date statistics in train mode; dropout is active in train mode
(``set_dropout_generator``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from dahitra_tpu_torch.models.res34_unet import ENCODER_FILTERS, Res34Encoder
from dahitra_tpu_torch.models.unet_change_transformer import (
    BottleneckChannelAttention, ChannelAttentionFuse, channel_tokens)
from dahitra_tpu_torch.nn.blocks import (ConvRelu, TransformerEncoder,
                                         apply_conv, upsample_nearest)

# The variants' local decoder widths (zoo/models.py:1098, :1235).
DEC = (48, 64, 96, 160, 320)
DEC_BIT = (48, 64, 96, 128, 320)


class XBDUNetChangeTransformer(Res34Encoder):
    """NHWC (B, H, W, 6) pre|post (or two images) -> (B, H, W, output_nc)
    logits in the compute dtype."""

    def __init__(self, output_nc: int = 5, img_size: int = 1024,
                 use_bit: bool = False, dtype=torch.float32):
        super().__init__(dtype)
        self.use_bit = use_bit
        e = ENCODER_FILTERS
        for tag, c in (("5", e[4]), ("4", e[3]), ("3", e[2]), ("2", e[1])):
            self.add_module(f"ca_skip_{tag}", ChannelAttentionFuse(
                c, activation="relu", dtype=dtype))
        if use_bit:
            dim = (img_size // 32) ** 2
            self.ca_bottle_max = BottleneckChannelAttention(e[4], dtype=dtype)
            self.transformer = TransformerEncoder(dim, 8, 4, dim, dim * dim,
                                                  dtype, dropout=0.05)
        d = DEC_BIT if use_bit else DEC
        for level, i in zip(range(6, 10), range(4, 0, -1)):
            prev = e[4] if level == 6 else d[i + 1]
            self.add_module(f"conv{level}", ConvRelu(prev, d[i], dtype=dtype))
            self.add_module(f"conv{level}_2",
                            ConvRelu(d[i] + e[i - 1], d[i], dtype=dtype))
        self.conv10 = ConvRelu(d[1], d[0], dtype=dtype)
        self.res = nn.Conv2d(d[0], output_nc, 1)

    def forward(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        if x2 is None:
            x1, x2 = x1[..., :3], x1[..., 3:]
        levels = [t.chunk(2, 0) for t in self.encode(
            torch.cat([x1, x2], 0), train, pair=train)]
        e5_1, e5_2 = levels[4]
        if self.use_bit:
            e5_1 = self.ca_bottle_max(e5_1) * e5_1
            e5_2 = self.ca_bottle_max(e5_2) * e5_2
            enc5 = self.ca_skip_5(e5_1, e5_2)
            enc5 = self.ca_skip_5(channel_tokens(self.transformer, enc5,
                                                 not train), enc5)
        else:
            enc5 = self.ca_skip_5(e5_1, e5_2)
        y = enc5
        # the finest skip reuses ca_skip_2 (the reference's quirk)
        for level, tag, i in zip(range(6, 10), "4322", (3, 2, 1, 0)):
            skip = getattr(self, f"ca_skip_{tag}")(*levels[i])
            y = getattr(self, f"conv{level}")(upsample_nearest(y, 2))
            y = getattr(self, f"conv{level}_2")(torch.cat([y, skip], -1))
        y = self.conv10(upsample_nearest(y, 2))
        return apply_conv(self.res, y, self.dtype)
