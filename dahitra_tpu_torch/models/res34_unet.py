"""The xView2-winner ResNet34 UNets of the xBD stack.

Counterpart of dahitra_tpu/models/res34_unet.py:30-182 (the reference's
xBD_code/zoo/models.py): a resnet34 encoder at its standard strides, a
5-level UNet decoder (``ConvRelu`` at 320 / 160 / 96 / 64 / 48 channels,
nearest x2 upsampling, skip concatenations) and a 1x1 head ``res``:

  * ``Res34UnetLoc`` (models.py:491-563): one 3-channel image, 1 logit;
  * ``Res34UnetDouble`` (:565-646, the LEVIR ``siamUnet`` key): the shared
    encoder-decoder on both dates, the 48-channel maps concatenated, 5 (or 4)
    logits; a 6-channel pre|post input or two 3-channel images;
  * ``Res34UnetSingle`` (:320-393): one pass over a 3-channel image, 5
    logits;
  * ``Res34UnetDoubleModified`` (:854-991): both dates' features at every
    level, then a third pass over the 1x1-fused (``conv1d_1``-``conv1d_9``)
    concatenations of the fused stream with both dates' features; the head
    reads the fused and both dates' 48-channel maps.

The module tree carries the zoo's ``state_dict`` names, which
dahitra_tpu/core/torch_import.py ``convert_res34_unet`` and
``convert_res34_double_modified`` read: the wrapped trunk ``conv1`` =
(conv, bn, relu), ``conv2`` = (maxpool, layer1), ``conv3``-``conv5`` =
layers 2-4, the decoder ``conv6``-``conv10`` (``layer.0``) and ``res``. Each
date runs through the BatchNorms on its own, in order, as the flax modules
run them: in train mode each call normalizes by its own batch and moves the
running statistics once.

Under a row-sharded grid (``nn/space.py``) the levels whose rows split run
on the rank's rows and the coarser ones whole (at 64 px on four space
ranks, 1/32: layer 4 gathers the 1/16 level's single row a rank); each
decoder level's upsampling takes the rank's rows again where its skip has
them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from dahitra_tpu_torch.nn import space
from dahitra_tpu_torch.nn.blocks import (BatchNorm, ConvRelu, conv2d_nhwc,
                                         max_pool_3x3_s2, upsample_nearest)
from dahitra_tpu_torch.nn.resnet import ResNetLayer

ENCODER_FILTERS = (64, 64, 128, 256, 512)
DECODER_FILTERS = (48, 64, 96, 160, 320)
_BLOCKS = (3, 4, 6, 3)  # resnet34


class Res34Encoder(nn.Module):
    """The zoo's wrapped resnet34 (``conv1`` = (conv, bn, relu), ``conv2`` =
    (maxpool, layer1), ``conv3``-``conv5``), shared with the LEVIR UNet
    change transformers (models/unet_change_transformer.py)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        e = ENCODER_FILTERS
        self.conv1 = nn.Sequential(nn.Conv2d(3, e[0], 7, 2, 3, bias=False),
                                   BatchNorm(e[0], dtype), nn.ReLU())
        self.conv2 = nn.Sequential(
            nn.MaxPool2d(3, 2, 1), ResNetLayer(e[0], e[1], _BLOCKS[0], 1, dtype))
        self.conv3 = ResNetLayer(e[1], e[2], _BLOCKS[1], 2, dtype)
        self.conv4 = ResNetLayer(e[2], e[3], _BLOCKS[2], 2, dtype)
        self.conv5 = ResNetLayer(e[3], e[4], _BLOCKS[3], 2, dtype)

    def stem(self, x: torch.Tensor, train: bool,
             pair: bool = False) -> torch.Tensor:
        """relu(bn(conv 7x7 s2)): the 1/2-scale level, 64 channels."""
        conv, bn = self.conv1[0], self.conv1[1]
        x = space.descend(x, 2, 3)
        return torch.relu(bn(conv2d_nhwc(x, conv.weight, stride=2, padding=3,
                                         dtype=self.dtype), train, pair))

    def encode(self, x: torch.Tensor, train: bool, pair: bool = False):
        """enc1..enc5; with ``pair`` the batch is [date1; date2] and each
        BatchNorm takes per-date statistics in train mode."""
        enc1 = self.stem(x, train, pair)                          # 1/2, 64
        enc2 = self.conv2[1](max_pool_3x3_s2(enc1), train, pair)  # 1/4, 64
        enc3 = self.conv3(enc2, train, pair)                      # 1/8, 128
        enc4 = self.conv4(enc3, train, pair)                      # 1/16, 256
        enc5 = self.conv5(enc4, train, pair)                      # 1/32, 512
        return enc1, enc2, enc3, enc4, enc5


class _Res34Unet(Res34Encoder):
    """The shared encoder and decoder: ``features`` returns every level,
    ``core`` the 48-channel full-resolution map (``_Res34UnetCore``).
    ``space_stride``: the encoder's total stride; under a row-sharded grid
    the levels whose rows per rank it does not split run whole
    (``nn/space.py``)."""

    space_stride = 32

    def __init__(self, dtype=torch.float32):
        super().__init__(dtype)
        e, d = ENCODER_FILTERS, DECODER_FILTERS
        self.conv6 = ConvRelu(e[4], d[4], dtype=dtype)
        self.conv6_2 = ConvRelu(d[4] + e[3], d[4], dtype=dtype)
        self.conv7 = ConvRelu(d[4], d[3], dtype=dtype)
        self.conv7_2 = ConvRelu(d[3] + e[2], d[3], dtype=dtype)
        self.conv8 = ConvRelu(d[3], d[2], dtype=dtype)
        self.conv8_2 = ConvRelu(d[2] + e[1], d[2], dtype=dtype)
        self.conv9 = ConvRelu(d[2], d[1], dtype=dtype)
        self.conv9_2 = ConvRelu(d[1] + e[0], d[1], dtype=dtype)
        self.conv10 = ConvRelu(d[1], d[0], dtype=dtype)

    def decode(self, level: int, x: torch.Tensor, skip: torch.Tensor
               ) -> torch.Tensor:
        """``conv{level}_2(cat(conv{level}(up2(x)), skip))``, level 6-9."""
        up = getattr(self, f"conv{level}")(upsample_nearest(x, 2))
        return getattr(self, f"conv{level}_2")(torch.cat([up, skip], -1))

    def features(self, x: torch.Tensor, train: bool = False):
        """(enc1..enc5, dec6..dec10), zoo/models.py:899-928 forward1."""
        enc = self.encode(x, train)
        dec6 = self.decode(6, enc[4], enc[3])
        dec7 = self.decode(7, dec6, enc[2])
        dec8 = self.decode(8, dec7, enc[1])
        dec9 = self.decode(9, dec8, enc[0])
        dec10 = self.conv10(upsample_nearest(dec9, 2))
        return (*enc, dec6, dec7, dec8, dec9, dec10)

    def core(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.features(x, train)[-1]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.res.weight, self.res.bias, dtype=self.dtype)


def _dates(x1: torch.Tensor, x2: Optional[torch.Tensor]):
    """The two dates of a 6-channel pre|post input, or the two images."""
    return (x1[..., :3], x1[..., 3:]) if x2 is None else (x1, x2)


class Res34UnetLoc(_Res34Unet):
    """Building footprints: (B, H, W, 3) -> (B, H, W, 1) logits."""

    def __init__(self, dtype=torch.float32):
        super().__init__(dtype)
        self.res = nn.Conv2d(DECODER_FILTERS[0], 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.head(self.core(x, train))


class Res34UnetSingle(_Res34Unet):
    """One pass over a 3-channel image to ``output_nc`` logits."""

    def __init__(self, output_nc: int = 5, dtype=torch.float32):
        super().__init__(dtype)
        self.res = nn.Conv2d(DECODER_FILTERS[0], output_nc, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.head(self.core(x, train))


class Res34UnetDouble(_Res34Unet):
    """Siamese damage classifier: the shared core on each date, the two
    48-channel maps concatenated, a 1x1 conv to ``output_nc`` logits."""

    def __init__(self, output_nc: int = 5, dtype=torch.float32):
        super().__init__(dtype)
        self.res = nn.Conv2d(2 * DECODER_FILTERS[0], output_nc, 1)

    def forward(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        x1, x2 = _dates(x1, x2)
        return self.head(torch.cat([self.core(x1, train),
                                    self.core(x2, train)], -1))


class Res34UnetDoubleModified(_Res34Unet):
    """Both dates' features, then a third, fused pass through the shared
    trunk layers and decoder convs, fused with both dates at every level by
    the 1x1 convs ``conv1d_1``-``conv1d_9``; the head reads the fused and
    both dates' 48-channel maps (3 * 48 channels)."""

    def __init__(self, output_nc: int = 5, dtype=torch.float32):
        super().__init__(dtype)
        # 64, 64, 128, 256, 512, then 320, 160, 96, 64
        widths = ENCODER_FILTERS + DECODER_FILTERS[:0:-1]
        ins = (2 * ENCODER_FILTERS[0],) + tuple(3 * w for w in widths[1:])
        for i, (c_in, c_out) in enumerate(zip(ins, widths), 1):
            self.add_module(f"conv1d_{i}", nn.Conv2d(c_in, c_out, 1))
        self.res = nn.Conv2d(3 * DECODER_FILTERS[0], output_nc, 1)

    def _fuse(self, i: int, *xs: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, f"conv1d_{i}")
        return conv2d_nhwc(torch.cat(xs, -1), conv.weight, conv.bias,
                           dtype=self.dtype)

    def forward(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        x1, x2 = _dates(x1, x2)
        f1 = self.features(x1, train)
        f2 = self.features(x2, train)
        space.at_level(2)  # the fused pass starts at enc1's level
        enc = self._fuse(1, f1[0], f2[0])
        enc2 = self._fuse(2, self.conv2[1](max_pool_3x3_s2(enc), train),
                          f1[1], f2[1])
        levels = [enc, enc2]
        for i, layer in ((3, self.conv3), (4, self.conv4), (5, self.conv5)):
            levels.append(self._fuse(i, layer(levels[-1], train),
                                     f1[i - 1], f2[i - 1]))
        x = levels[4]
        for i, level in enumerate((6, 7, 8, 9)):
            x = self._fuse(level, self.decode(level, x, levels[3 - i]),
                           f1[5 + i], f2[5 + i])
        dec10 = self.conv10(upsample_nearest(x, 2))
        return self.head(torch.cat([dec10, f1[9], f2[9]], -1))
