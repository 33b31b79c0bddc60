"""SE-backbone UNets of the xView2 first-place solution.

Counterpart of dahitra_tpu/models/senet_unet.py (the reference's
xBD_code/zoo/senet.py and zoo/models.py:71-319, 648-802):

  * ``SEModule``: squeeze (global mean) and excite (1x1, ReLU, 1x1,
    sigmoid); ``SCSEModule``: the channel gate and a spatial gate
    (a 1x1 conv to one channel, sigmoid), concatenated (``concat=True``
    doubles the channels);
  * ``SEResNeXtBottleneck`` (1x1, grouped 3x3 at groups 32, base width 4,
    1x1 to 4 x planes, SE) and ``SEBottleneck`` (SENet154: 1x1 to 2 x
    planes, grouped 3x3 at groups 64 to 4 x planes, 1x1, SE), each with the
    projected identity where the shape changes (1x1, or 3x3 in SENet154's
    layers 2-4);
  * ``_SEUnet``: the stem (7x7/s2 for SE-ResNeXt50; SENet154's three 3x3
    convs to 128 channels), the ceil-mode 3x3/s2 pool, layers (3, 4, 6, 3)
    or (3, 8, 36, 3), and the UNet decoder ``conv6``-``conv10`` (nearest x2
    upsampling, skip concatenations) at ``SE_RESNEXT_DEC`` or
    ``SENET154_DEC``;
  * ``SeResNext50UnetLoc`` / ``SeNet154UnetLoc`` (one image, one logit) and
    ``SeResNext50UnetDouble`` / ``SeNet154UnetDouble`` (the shared core on
    both dates, the two maps concatenated before the 1x1 head ``res``).

The module tree carries the zoo's ``state_dict`` names, which
dahitra_tpu/core/torch_import.py ``convert_se_unet`` reads: ``conv1`` the
stem Sequential (conv, bn, relu, ...), ``conv2`` = (pool, layer1),
``conv3``-``conv5`` = layers 2-4, each block's ``conv1``-``conv3``,
``bn1``-``bn3``, ``se_module.fc1``/``fc2`` and ``downsample.0``/``.1``. The
BatchNorms are flax's ``nn.BatchNorm(dtype=float32)``: statistics and
output in fp32 (the next conv casts to the compute dtype). The Double
models run both dates batch-stacked, each BatchNorm taking per-date
statistics in train mode (the flax module's two core calls).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from dahitra_tpu_torch.nn.blocks import (BatchNorm, ConvRelu, apply_conv,
                                         max_pool_3x3_s2_ceil,
                                         upsample_nearest)

SE_RESNEXT_DEC = (32, 48, 64, 128, 256)   # models.py:76
SENET154_DEC = (48, 64, 96, 160, 320)     # models.py:653
# arch -> (stem width, blocks per layer)
_ARCHS = {"se_resnext50": (64, (3, 4, 6, 3)),
          "senet154": (128, (3, 8, 36, 3))}
_PLANES = (64, 128, 256, 512)


def _bn(channels: int) -> BatchNorm:
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``."""
    return BatchNorm(channels, torch.float32)


class SEModule(nn.Module):
    """x * sigmoid(fc2(relu(fc1(mean_hw(x))))) (senet.py:86-106)."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)

    def gate(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(1, 2), keepdim=True)
        s = torch.relu(apply_conv(self.fc1, s, self.dtype))
        return torch.sigmoid(apply_conv(self.fc2, s, self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gate(x)


class SCSEModule(SEModule):
    """The channel gate and the spatial gate, concatenated (senet.py:
    107-130, concat=True): 2 x channels out."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype=torch.float32):
        super().__init__(channels, reduction, dtype)
        self.spatial = nn.Conv2d(channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spa = torch.sigmoid(apply_conv(self.spatial, x, self.dtype))
        return torch.cat([x * self.gate(x), x * spa], -1)


class _SEBlock(nn.Module):
    """1x1 -> grouped 3x3 (stride) -> 1x1, each with BN, SE on the last,
    plus the identity (projected by ``downsample`` where the shape
    changes), then ReLU."""

    def __init__(self, in_channels: int, mid1: int, mid2: int, out: int,
                 groups: int, stride: int, downsample_kernel: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, mid1, 1, bias=False)
        self.bn1 = _bn(mid1)
        self.conv2 = nn.Conv2d(mid1, mid2, 3, stride, 1, groups=groups,
                               bias=False)
        self.bn2 = _bn(mid2)
        self.conv3 = nn.Conv2d(mid2, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.se_module = SEModule(out, dtype=dtype)
        self.downsample = None
        if stride != 1 or in_channels != out:
            k = downsample_kernel
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out, k, stride, k // 2, bias=False),
                _bn(out))

    def forward(self, x: torch.Tensor, train: bool = False,
                pair: bool = False) -> torch.Tensor:
        dt = self.dtype
        y = torch.relu(self.bn1(apply_conv(self.conv1, x, dt), train, pair))
        y = torch.relu(self.bn2(apply_conv(self.conv2, y, dt), train, pair))
        y = self.se_module(self.bn3(apply_conv(self.conv3, y, dt), train,
                                    pair))
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](
                apply_conv(self.downsample[0], x, dt), train, pair)
        return torch.relu(y + identity)


class SEResNeXtBottleneck(_SEBlock):
    """se_resnext50_32x4d's block (senet.py:241-268)."""

    def __init__(self, in_channels: int, planes: int, groups: int = 32,
                 base_width: int = 4, stride: int = 1,
                 downsample_kernel: int = 1, dtype=torch.float32):
        width = (planes * base_width // 64) * groups
        super().__init__(in_channels, width, width, planes * 4, groups,
                         stride, downsample_kernel, dtype)


class SEBottleneck(_SEBlock):
    """senet154's block (senet.py:168-195)."""

    def __init__(self, in_channels: int, planes: int, groups: int = 64,
                 stride: int = 1, downsample_kernel: int = 3,
                 dtype=torch.float32):
        super().__init__(in_channels, planes * 2, planes * 4, planes * 4,
                         groups, stride, downsample_kernel, dtype)


class _Layer(nn.Sequential):
    """A layer's blocks, each called with (train, pair)."""

    def forward(self, x: torch.Tensor, train: bool = False,
                pair: bool = False) -> torch.Tensor:
        for block in self:
            x = block(x, train, pair)
        return x


class _SEUnet(nn.Module):
    """The encoder and decoder shared by both SE backbones; ``core`` maps
    an image to the ``decoder_filters[0]``-channel full-resolution map."""

    def __init__(self, arch: str, decoder_filters, dtype=torch.float32):
        super().__init__()
        self.arch, self.dtype = arch, dtype
        stem, blocks = _ARCHS[arch]
        if arch == "se_resnext50":
            self.conv1 = nn.Sequential(nn.Conv2d(3, 64, 7, 2, 3, bias=False),
                                       _bn(64), nn.ReLU())
        else:
            self.conv1 = nn.Sequential(
                nn.Conv2d(3, 64, 3, 2, 1, bias=False), _bn(64), nn.ReLU(),
                nn.Conv2d(64, 64, 3, 1, 1, bias=False), _bn(64), nn.ReLU(),
                nn.Conv2d(64, 128, 3, 1, 1, bias=False), _bn(128), nn.ReLU())
        c = stem
        layers = []
        for idx, (planes, n) in enumerate(zip(_PLANES, blocks)):
            stride = 1 if idx == 0 else 2
            # layer1 downsamples with a 1x1 whatever the arch (senet.py:
            # 366-373); senet154's other layers with a 3x3 (:475-478).
            down_k = 1 if (idx == 0 or arch == "se_resnext50") else 3
            layer = []
            for b in range(n):
                block = (SEResNeXtBottleneck if arch == "se_resnext50"
                         else SEBottleneck)
                layer.append(block(c, planes, stride=stride if b == 0 else 1,
                                   downsample_kernel=down_k, dtype=dtype))
                c = planes * 4
            layers.append(_Layer(*layer))
        self.conv2 = nn.Sequential(nn.MaxPool2d(3, 2, ceil_mode=True),
                                   layers[0])
        self.conv3, self.conv4, self.conv5 = layers[1:]
        enc = (stem, 256, 512, 1024, 2048)
        d = decoder_filters
        for level, i in zip(range(6, 10), range(4, 0, -1)):
            prev = enc[4] if level == 6 else d[i + 1]
            self.add_module(f"conv{level}", ConvRelu(prev, d[i], dtype=dtype))
            self.add_module(f"conv{level}_2",
                            ConvRelu(d[i] + enc[i - 1], d[i], dtype=dtype))
        self.conv10 = ConvRelu(d[1], d[0], dtype=dtype)

    def stem(self, x: torch.Tensor, train: bool, pair: bool) -> torch.Tensor:
        for i in range(0, len(self.conv1), 3):
            conv, bn = self.conv1[i], self.conv1[i + 1]
            x = torch.relu(bn(apply_conv(conv, x, self.dtype), train, pair))
        return x

    def core(self, x: torch.Tensor, train: bool = False,
             pair: bool = False) -> torch.Tensor:
        enc1 = self.stem(x, train, pair)
        enc2 = self.conv2[1](max_pool_3x3_s2_ceil(enc1), train, pair)
        enc3 = self.conv3(enc2, train, pair)
        enc4 = self.conv4(enc3, train, pair)
        enc5 = self.conv5(enc4, train, pair)
        y = enc5
        for level, skip in zip(range(6, 10), (enc4, enc3, enc2, enc1)):
            y = getattr(self, f"conv{level}")(upsample_nearest(y, 2))
            y = getattr(self, f"conv{level}_2")(torch.cat([y, skip], -1))
        return self.conv10(upsample_nearest(y, 2))


class _Loc(nn.Module):
    """(B, H, W, 3) -> (B, H, W, 1) building logits."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return apply_conv(self.res, self.core(x, train), self.dtype)


class _Double(nn.Module):
    """A 6-channel pre|post input (or two images) -> ``output_nc`` logits:
    the shared core on both dates, batch-stacked, the two maps
    concatenated before the 1x1 head."""

    def forward(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        if x2 is None:
            x1, x2 = x1[..., :3], x1[..., 3:]
        d1, d2 = self.core(torch.cat([x1, x2], 0), train,
                           pair=train).chunk(2, 0)
        return apply_conv(self.res, torch.cat([d1, d2], -1), self.dtype)


class SeResNext50UnetLoc(_Loc, _SEUnet):
    def __init__(self, dtype=torch.float32):
        _SEUnet.__init__(self, "se_resnext50", SE_RESNEXT_DEC, dtype)
        self.res = nn.Conv2d(SE_RESNEXT_DEC[0], 1, 1)


class SeResNext50UnetDouble(_Double, _SEUnet):
    def __init__(self, output_nc: int = 5, dtype=torch.float32):
        _SEUnet.__init__(self, "se_resnext50", SE_RESNEXT_DEC, dtype)
        self.res = nn.Conv2d(2 * SE_RESNEXT_DEC[0], output_nc, 1)


class SeNet154UnetLoc(_Loc, _SEUnet):
    def __init__(self, dtype=torch.float32):
        _SEUnet.__init__(self, "senet154", SENET154_DEC, dtype)
        self.res = nn.Conv2d(SENET154_DEC[0], 1, 1)


class SeNet154UnetDouble(_Double, _SEUnet):
    def __init__(self, output_nc: int = 5, dtype=torch.float32):
        _SEUnet.__init__(self, "senet154", SENET154_DEC, dtype)
        self.res = nn.Conv2d(2 * SENET154_DEC[0], output_nc, 1)
