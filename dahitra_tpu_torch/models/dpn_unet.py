"""DPN92 UNets of the xView2 first-place solution.

Counterpart of dahitra_tpu/models/dpn_unet.py (the reference's
xBD_code/zoo/models.py:395-489 over the pretrainedmodels DPN92):

  * ``DualPathBlock``: pre-activation (BN-ReLU-conv); the ``proj`` and
    ``down`` types project the input with a 1x1 (stride 2 for ``down``)
    into a residual part ``bw`` and a dense part ``2 * inc``; then 1x1 to
    ``r``, grouped 3x3 (groups 32, the stride), 1x1 to ``bw + inc``; the
    residual parts add, the dense parts concatenate;
  * ``DPN92Trunk``: 7x7/s2 conv-BN-ReLU (64), the padded 3x3/s2 pool, four
    dual-path stages (``K_SEC``, ``INC``, ``BW``, ``R``); stage outputs 336
    / 704 / 1552 / 2688 channels (residual and dense concatenated);
  * ``_DPNUnetCore``: the UNet decoder ``conv6``-``conv10`` (``DPN_DEC``),
    an ``SCSEModule`` (channel-doubling) after each skip merge;
  * ``Dpn92UnetLoc`` (one image, one logit) and ``Dpn92UnetDouble`` (the
    shared core on both dates, concatenated before the 1x1 head ``res``).

The reference's DPN UNets cannot be built (zoo/models.py:256 names an
undefined ``dpn92``), so no reference checkpoint exists: the module tree
keeps the flax names (``core.trunk.s{stage}_b{block}.{bn_w, conv_w, bn_a,
conv_a, bn_b, conv_b, bn_c, conv_c}``, ``core.trunk.init_conv``,
``init_bn``, ``core.conv6``..., ``core.scse6``..., ``res``), with the
port's layouts (``ConvRelu``'s ``layer.0``). The BatchNorms are flax's
``momentum=0.999, epsilon=1e-3, dtype=float32``. The Double model runs
both dates batch-stacked, each BatchNorm taking per-date statistics in
train mode.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from dahitra_tpu_torch.models.senet_unet import SCSEModule, _Double, _Loc
from dahitra_tpu_torch.nn.blocks import (BatchNorm, ConvRelu, apply_conv,
                                         max_pool_3x3_s2, upsample_nearest)

K_SEC = (3, 4, 20, 3)
INC = (16, 32, 24, 128)
BW = (256, 512, 1024, 2048)
R = (96, 192, 384, 768)
GROUPS = 32
DPN_DEC = (32, 48, 64, 128, 256)


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, torch.float32, eps=1e-3, momentum=0.999)


class DualPathBlock(nn.Module):
    """Pre-activation dual-path block: (resid, dense) -> (resid, dense);
    ``dense`` is None at a stage's first block."""

    def __init__(self, in_channels: int, r: int, bw: int, inc: int,
                 block_type: str, dtype=torch.float32):
        super().__init__()
        self.bw, self.dtype = bw, dtype
        self.block_type = block_type
        stride = 2 if block_type == "down" else 1
        if block_type in ("proj", "down"):
            self.bn_w = _bn(in_channels)
            self.conv_w = nn.Conv2d(in_channels, bw + 2 * inc, 1, stride,
                                    bias=False)
        self.bn_a = _bn(in_channels)
        self.conv_a = nn.Conv2d(in_channels, r, 1, bias=False)
        self.bn_b = _bn(r)
        self.conv_b = nn.Conv2d(r, r, 3, stride, 1, groups=GROUPS, bias=False)
        self.bn_c = _bn(r)
        self.conv_c = nn.Conv2d(r, bw + inc, 1, bias=False)

    def forward(self, res_dense, train: bool = False, pair: bool = False):
        resid, dense = res_dense
        x_in = resid if dense is None else torch.cat([resid, dense], -1)
        dt = self.dtype

        def bnact_conv(bn, conv, x):
            return apply_conv(conv, torch.relu(bn(x, train, pair)), dt)

        if self.block_type in ("proj", "down"):
            s = bnact_conv(self.bn_w, self.conv_w, x_in)
            s_res, s_dense = s[..., :self.bw], s[..., self.bw:]
        else:
            s_res, s_dense = resid, dense
        y = bnact_conv(self.bn_a, self.conv_a, x_in)
        y = bnact_conv(self.bn_b, self.conv_b, y)
        y = bnact_conv(self.bn_c, self.conv_c, y)
        return (s_res + y[..., :self.bw],
                torch.cat([s_dense, y[..., self.bw:]], -1))


class DPN92Trunk(nn.Module):
    """(B, H, W, 3) -> (enc1..enc5) at 1/2 .. 1/32."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.init_conv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.init_bn = _bn(64)
        c = 64
        for stage in range(4):
            for b in range(K_SEC[stage]):
                kind = ("proj" if stage == 0 else "down") if b == 0 \
                    else "normal"
                self.add_module(f"s{stage}_b{b}", DualPathBlock(
                    c, R[stage], BW[stage], INC[stage], kind, dtype))
                c = BW[stage] + INC[stage] * (b + 3)

    def forward(self, x: torch.Tensor, train: bool = False,
                pair: bool = False):
        enc1 = torch.relu(self.init_bn(apply_conv(self.init_conv, x,
                                                  self.dtype), train, pair))
        state = (max_pool_3x3_s2(enc1), None)
        feats = [enc1]
        for stage in range(4):
            for b in range(K_SEC[stage]):
                state = getattr(self, f"s{stage}_b{b}")(state, train, pair)
            feats.append(torch.cat(state, -1))
        return tuple(feats)


class _DPNUnetCore(nn.Module):
    """The trunk and the SCSE-gated UNet decoder."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.trunk = DPN92Trunk(dtype)
        enc = (64, 336, 704, 1552, 2688)
        d = DPN_DEC
        for level, i in zip(range(6, 10), range(4, 0, -1)):
            # the up-conv reads the previous SCSE's doubled channels
            prev = enc[4] if level == 6 else 2 * d[i + 1]
            self.add_module(f"conv{level}", ConvRelu(prev, d[i], dtype=dtype))
            self.add_module(f"conv{level}_2",
                            ConvRelu(d[i] + enc[i - 1], d[i], dtype=dtype))
            self.add_module(f"scse{level}", SCSEModule(d[i], dtype=dtype))
        self.conv10 = ConvRelu(2 * d[1], d[0], dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                pair: bool = False) -> torch.Tensor:
        enc1, enc2, enc3, enc4, enc5 = self.trunk(x, train, pair)
        y = enc5
        for level, skip in zip(range(6, 10), (enc4, enc3, enc2, enc1)):
            y = getattr(self, f"conv{level}")(upsample_nearest(y, 2))
            y = getattr(self, f"conv{level}_2")(torch.cat([y, skip], -1))
            y = getattr(self, f"scse{level}")(y)
        return self.conv10(upsample_nearest(y, 2))


class Dpn92UnetLoc(_Loc):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.core = _DPNUnetCore(dtype)
        self.res = nn.Conv2d(DPN_DEC[0], 1, 1)


class Dpn92UnetDouble(_Double):
    def __init__(self, output_nc: int = 5, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.core = _DPNUnetCore(dtype)
        self.res = nn.Conv2d(2 * DPN_DEC[0], output_nc, 1)
