"""The GAN trainer's mask discriminator.

Counterpart of dahitra_tpu/models/discriminator.py:21 (the reference's
xBD_code/zoo/model_transformer_encoding.py:454-463): a 3x3 conv from the 5
damage channels to 3 with no padding (``pre_process``), a full resnet18
trunk at its standard strides (``backbone``, torchvision names), a global
average pool and ``fc`` to 1000 logits (the reference keeps the ImageNet
head as the GAN's label space, judged against all-ones or all-zeros
targets). The names follow the flax module's.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from dahitra_tpu_torch.nn.blocks import _dense, conv2d_nhwc
from dahitra_tpu_torch.nn.resnet import ResNetTrunk


class Discriminator(nn.Module):
    def __init__(self, input_nc: int = 5, num_logits: int = 1000,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pre_process = nn.Conv2d(input_nc, 3, 3)
        self.backbone = ResNetTrunk("resnet18", (False, False, False), 3,
                                    num_layers=4, dtype=dtype)
        self.fc = nn.Linear(512, num_logits)

    def forward(self, masks: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        """(B, H, W, input_nc) masks or probabilities -> (B, num_logits)
        logits in the compute dtype."""
        x = conv2d_nhwc(masks, self.pre_process.weight, self.pre_process.bias,
                        dtype=self.dtype)
        x = self.backbone(x, train=train)
        return _dense(x.mean((1, 2)), self.fc, self.dtype)
