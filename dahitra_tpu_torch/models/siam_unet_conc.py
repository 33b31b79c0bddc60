"""FC-Siam-conc (``siamUnet_conc``): the fully convolutional siamese UNet
with skip concatenation.

Counterpart of dahitra_tpu/models/siam_unet_conc.py (the reference's
models/networks.py:916-1082): four encoder stages of conv3x3-BN-ReLU-
``Dropout2d(0.2)`` (16, 32, 64, 128 channels; 2, 2, 3, 3 convs) with a 2x2
max pool after each, shared by both dates; a decoder of stride-2 up-convs
``ConvTranspose2d(k3, s2, p1, output_padding=1)`` applied to the second
date's pooled features, each followed by the concatenation of both dates'
skips and a stack of stride-1 "deconvs" ``ConvTranspose2d(k3, s1, p1)``
with BN, ReLU and ``Dropout2d``; the last deconv gives the logits, and the
output is their ``log_softmax`` in fp32 (:141).

The module tree carries the reference's ``state_dict`` names
(``conv11``/``bn11`` ... ``conv43``, ``upconv4``-``upconv1``,
``conv43d``/``bn43d`` ... ``conv11d``), which
dahitra_tpu/core/torch_import.py ``convert_siam_unet_conc`` reads; it turns
the stride-1 transposed convolutions into the JAX model's SAME convs with
flipped taps (``_ct_as_conv``). ``Dropout2d`` drops whole channels: one draw
per (sample, channel), active in train mode. Both dates run through the
encoder batch-stacked, each BatchNorm taking per-date statistics in train
mode (the JAX module's two ``encode`` calls).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from dahitra_tpu_torch.nn.blocks import (BatchNorm, Dropout, conv2d_nhwc,
                                         conv_transpose2d_nhwc, max_pool_2x2)

# Encoder convs: (name, in, out); a 2x2 max pool follows each stage.
_ENC = (("11", 3, 16), ("12", 16, 16), ("21", 16, 32), ("22", 32, 32),
        ("31", 32, 64), ("32", 64, 64), ("33", 64, 64), ("41", 64, 128),
        ("42", 128, 128), ("43", 128, 128))
_STAGES = (("11", "12"), ("21", "22"), ("31", "32", "33"),
           ("41", "42", "43"))
DROPOUT = 0.2  # Dropout2d after every conv-BN-ReLU
# Decoder levels: (up-conv, its width, deconvs (name, in, out)).
_DEC = (("4", 128, (("43", 384, 128), ("42", 128, 128), ("41", 128, 64))),
        ("3", 64, (("33", 192, 64), ("32", 64, 64), ("31", 64, 32))),
        ("2", 32, (("22", 96, 32), ("21", 32, 16))),
        ("1", 16, (("12", 48, 16),)))


class SiamUnetConc(nn.Module):
    """NHWC images (B, H, W, 3) twice -> fp32 log-probabilities (B, H, W,
    label_nbr); H and W multiples of 16."""

    def __init__(self, input_nbr: int = 3, label_nbr: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for name, c_in, c_out in _ENC:
            c_in = input_nbr if name == "11" else c_in
            self.add_module(f"conv{name}", nn.Conv2d(c_in, c_out, 3,
                                                     padding=1))
            self.add_module(f"bn{name}", BatchNorm(c_out, dtype))
            self.add_module(f"do{name}", Dropout(DROPOUT, per="channel"))
        for up, width, deconvs in _DEC:
            self.add_module(f"upconv{up}", nn.ConvTranspose2d(
                width, width, 3, padding=1, stride=2, output_padding=1))
            for name, c_in, c_out in deconvs:
                self.add_module(f"conv{name}d", nn.ConvTranspose2d(
                    c_in, c_out, 3, padding=1))
                self.add_module(f"bn{name}d", BatchNorm(c_out, dtype))
                self.add_module(f"do{name}d", Dropout(DROPOUT,
                                                      per="channel"))
        self.conv11d = nn.ConvTranspose2d(16, label_nbr, 3, padding=1)

    def _block(self, name: str, x: torch.Tensor, train: bool,
               pair: bool = False) -> torch.Tensor:
        """conv{name} (or the deconv conv{name}d) - BN - ReLU - Dropout2d."""
        conv = getattr(self, f"conv{name}")
        if isinstance(conv, nn.ConvTranspose2d):
            x = conv_transpose2d_nhwc(x, conv, self.dtype)
        else:
            x = conv2d_nhwc(x, conv.weight, conv.bias, padding=1,
                            dtype=self.dtype)
        x = torch.relu(getattr(self, f"bn{name}")(x, train, pair))
        return getattr(self, f"do{name}")(x, not train)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        x = torch.cat([x1, x2], 0)
        skips = []
        for stage in _STAGES:
            for name in stage:
                x = self._block(name, x, train, pair=train)
            skips.append(x.chunk(2, 0))
            x = max_pool_2x2(x)
        x = x.chunk(2, 0)[1]
        for (up, _, deconvs), (s1, s2) in zip(_DEC, reversed(skips)):
            x = conv_transpose2d_nhwc(x, getattr(self, f"upconv{up}"),
                                      self.dtype)
            x = torch.cat([x, s1, s2], -1)
            for name, _, _ in deconvs:
                x = self._block(f"{name}d", x, train)
        x = conv_transpose2d_nhwc(x, self.conv11d, self.dtype)
        return torch.log_softmax(x.float(), dim=-1)
