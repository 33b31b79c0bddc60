"""The siamese dilated-ResNet change detector (``base_resnet18``).

Counterpart of dahitra_tpu/models/resnet_cd.py (the reference's
models/networks.py:176-257, class ResNet): a shared-weight trunk over both
dates, ``conv_pred`` to 32 channels, |f1 - f2|, x4 bilinear upsampling and
the ``TwoLayerConv`` classifier. The module tree carries the reference's
``state_dict`` names (``resnet.*``, ``conv_pred``, ``classifier.{0,1,3}``),
the names dahitra_tpu/core/torch_import.py ``convert_resnet_cd`` reads.

The trunk is resnet18 with ``replace_stride_with_dilation = (False, True,
True)``, whose quirk removes the stride of layers 3 and 4 without dilating
them (nn/resnet.py). Both dates run batch-stacked; in train mode every
BatchNorm takes per-date statistics (``pair=True``), which is what the JAX
module's two ``forward_single`` calls compute.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from dahitra_tpu_torch.nn.blocks import (TwoLayerConv, conv2d_nhwc,
                                         upsample_bilinear, upsample_nearest)
from dahitra_tpu_torch.nn.resnet import ResNetTrunk

# Output channels of the trunk by resnet_stages_num (networks.py:204-211).
_STAGE_WIDTH = {3: 128, 4: 256, 5: 512}
DIM = 32  # conv_pred's width


class SiameseTrunk(nn.Module):
    """The trunk and ``conv_pred`` that ResNetCD and BIT share: stem,
    layers 1-2, layer 3 when ``resnet_stages_num`` > 3 and layer 4 when it
    is 5, an optional x2 nearest upsampling, and a 3x3 conv to 32 channels
    (``forward_single``, networks.py:233-257)."""

    def __init__(self, backbone: str = "resnet18", resnet_stages_num: int = 5,
                 if_upsample_2x: bool = True, dtype=torch.float32):
        super().__init__()
        if resnet_stages_num not in _STAGE_WIDTH:
            raise NotImplementedError(
                f"resnet_stages_num {resnet_stages_num}: the reference takes "
                f"{sorted(_STAGE_WIDTH)}")
        self.dtype = dtype
        self.resnet_stages_num = resnet_stages_num
        self.if_upsample_2x = if_upsample_2x
        self.resnet = ResNetTrunk(backbone, (False, True, True), 3,
                                  num_layers=resnet_stages_num - 1,
                                  dtype=dtype)
        self.conv_pred = nn.Conv2d(_STAGE_WIDTH[resnet_stages_num], DIM, 3,
                                   padding=1)

    def forward_single(self, x: torch.Tensor, train: bool = False,
                       pair: bool = False) -> torch.Tensor:
        """NHWC images -> (B, H/4, W/4, 32) features (H/8 without the x2
        upsampling) in the compute dtype."""
        x = self.resnet(x, train=train, pair=pair)
        if self.if_upsample_2x:
            x = upsample_nearest(x, 2)
        return conv2d_nhwc(x, self.conv_pred.weight, self.conv_pred.bias,
                           padding=1, dtype=self.dtype)

    def head(self, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        """|f1 - f2| brought to the image's size: x2 nearest where the trunk
        did not upsample, then x4 bilinear."""
        x = (f1 - f2).abs()
        if not self.if_upsample_2x:
            x = upsample_nearest(x, 2)
        return upsample_bilinear(x, 4)


class ResNetCD(SiameseTrunk):
    """``base_resnet18``: NHWC images (B, H, W, 3) twice -> logits (B, H, W,
    output_nc) in the compute dtype (sigmoid applied with
    ``output_sigmoid``)."""

    def __init__(self, output_nc: int = 2, backbone: str = "resnet18",
                 resnet_stages_num: int = 5, if_upsample_2x: bool = True,
                 output_sigmoid: bool = False, dtype=torch.float32):
        super().__init__(backbone, resnet_stages_num, if_upsample_2x, dtype)
        self.output_sigmoid = output_sigmoid
        self.classifier = TwoLayerConv(DIM, output_nc, dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        f1, f2 = self.forward_single(torch.cat([x1, x2], 0), train,
                                     pair=train).chunk(2, 0)
        x = self.classifier(self.head(f1, f2), train)
        return torch.sigmoid(x) if self.output_sigmoid else x
