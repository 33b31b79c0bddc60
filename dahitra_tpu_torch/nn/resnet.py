"""ResNet trunk (torchvision layout), NHWC.

Counterpart of dahitra_tpu/nn/resnet.py: ``BasicBlock``, ``Bottleneck``
(resnet50's block, resnet.py:183), ``ResNetLayer`` and ``ResNetTrunk`` with ``BatchNorm`` (fp32 statistics, output in the
compute dtype, as ``_bn_out_dtype`` has it). ``train`` and ``pair`` thread
through every block as in resnet.py:130-290: in train mode with ``pair``,
the leading batch axis is [date1; date2] and each BatchNorm takes per-date
statistics (``PairBatchNorm(pair=True)``). Parameter names follow
torchvision (``conv1``, ``bn1``, ``layerN.M.conv1``, ``downsample.0/1``).

Quirk kept: the vendored torchvision BasicBlock resets dilation to 1, so
``replace_stride_with_dilation`` only removes a layer's stride
(resnet.py:8-11); the Bottleneck takes its stride on the 3x3 conv
(torchvision v1.5).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from dahitra_tpu_torch.nn.blocks import BatchNorm, conv2d_nhwc, max_pool_3x3_s2

# backbone -> (block, blocks per layer)
_CONFIGS = {"resnet18": ("basic", (2, 2, 2, 2)),
            "resnet34": ("basic", (3, 4, 6, 3)),
            "resnet50": ("bottleneck", (3, 4, 6, 3))}


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.conv1 = nn.Conv2d(in_channels, filters, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(filters, dtype)
        self.downsample = None
        if stride != 1 or in_channels != filters:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, filters, 1, stride, bias=False),
                BatchNorm(filters, dtype))

    def forward(self, x: torch.Tensor, train: bool = False,
                pair: bool = False) -> torch.Tensor:
        y = conv2d_nhwc(x, self.conv1.weight, stride=self.stride, padding=1,
                        dtype=self.dtype)
        y = torch.relu(self.bn1(y, train, pair))
        y = self.bn2(conv2d_nhwc(y, self.conv2.weight, padding=1,
                                 dtype=self.dtype), train, pair)
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](conv2d_nhwc(
                x, self.downsample[0].weight, stride=self.stride,
                dtype=self.dtype), train, pair)
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1 - 3x3 (stride) - 1x1 to ``4 * filters`` channels, each with
    BatchNorm, and the projected identity where the shape changes."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        out = filters * self.expansion
        self.conv1 = nn.Conv2d(in_channels, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(filters, dtype)
        self.conv3 = nn.Conv2d(filters, out, 1, bias=False)
        self.bn3 = BatchNorm(out, dtype)
        self.downsample = None
        if stride != 1 or in_channels != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out, 1, stride, bias=False),
                BatchNorm(out, dtype))

    def forward(self, x: torch.Tensor, train: bool = False,
                pair: bool = False) -> torch.Tensor:
        y = torch.relu(self.bn1(conv2d_nhwc(x, self.conv1.weight,
                                            dtype=self.dtype), train, pair))
        y = torch.relu(self.bn2(conv2d_nhwc(
            y, self.conv2.weight, stride=self.stride, padding=1,
            dtype=self.dtype), train, pair))
        y = self.bn3(conv2d_nhwc(y, self.conv3.weight, dtype=self.dtype),
                     train, pair)
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](conv2d_nhwc(
                x, self.downsample[0].weight, stride=self.stride,
                dtype=self.dtype), train, pair)
        return torch.relu(y + identity)


class ResNetLayer(nn.Sequential):
    """One torchvision ``layerN``: a stack of basic (or bottleneck)
    blocks."""

    def __init__(self, in_channels: int, filters: int, num_blocks: int,
                 stride: int, dtype=torch.float32, block: str = "basic"):
        cls = BasicBlock if block == "basic" else Bottleneck
        width = filters * getattr(cls, "expansion", 1)
        super().__init__(*[
            cls(in_channels if i == 0 else width, filters,
                stride if i == 0 else 1, dtype)
            for i in range(num_blocks)])

    def forward(self, x: torch.Tensor, train: bool = False,
                pair: bool = False) -> torch.Tensor:
        for block in self:
            x = block(x, train, pair)
        return x


class ResNetTrunk(nn.Module):
    """Stage-addressable ResNet feature extractor with ``num_layers`` of
    torchvision's four layers (DAHiTra uses three)."""

    def __init__(self, backbone: str = "resnet18",
                 replace_stride_with_dilation: Tuple[bool, bool, bool] = (
                     False, True, True),
                 in_channels: int = 3, num_layers: int = 4,
                 dtype=torch.float32):
        super().__init__()
        if backbone not in _CONFIGS:
            raise NotImplementedError(
                f"backbone {backbone!r}: available {sorted(_CONFIGS)}")
        self.dtype = dtype
        block, sizes = _CONFIGS[backbone]
        expansion = 4 if block == "bottleneck" else 1
        rswd = replace_stride_with_dilation
        strides = (1, 1 if rswd[0] else 2, 1 if rswd[1] else 2,
                   1 if rswd[2] else 2)
        widths = (64, 128, 256, 512)
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64, dtype)
        c_in = 64
        for i in range(num_layers):
            self.add_module(f"layer{i + 1}", ResNetLayer(
                c_in, widths[i], sizes[i], strides[i], dtype, block))
            c_in = widths[i] * expansion
        self.num_layers = num_layers

    def stem_preact(self, x: torch.Tensor, train: bool = False,
                    pair: bool = False) -> torch.Tensor:
        """conv1 -> bn1, without the ReLU."""
        return self.bn1(conv2d_nhwc(x, self.conv1.weight, stride=2, padding=3,
                                    dtype=self.dtype), train, pair)

    def stem(self, x: torch.Tensor, train: bool = False,
             pair: bool = False) -> torch.Tensor:
        """conv1 -> bn1 -> relu -> maxpool (torchvision stem)."""
        return max_pool_3x3_s2(torch.relu(self.stem_preact(x, train, pair)))

    def forward(self, x: torch.Tensor, num_stages: int = None,
                train: bool = False, pair: bool = False) -> torch.Tensor:
        x = self.stem(x, train, pair)
        for i in range(num_stages or self.num_layers):
            x = getattr(self, f"layer{i + 1}")(x, train, pair)
        return x
