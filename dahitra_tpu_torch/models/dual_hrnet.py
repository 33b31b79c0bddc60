"""Dual-HRNet, the xView2-baseline two-stream HRNet-W32 (``dual_hrnet``,
``dual_hrnet_fpn``).

Counterpart of dahitra_tpu/models/dual_hrnet.py (the reference's
xBD_code/dual_hrnet.py and dual_hrnet_config.yaml): two HRNet-W32 streams,
``loc_net`` on the pre image and ``cls_net`` on the post image. After each
stage's transition both streams' branches are concatenated and projected
back per stream by 1x1 conv-BN-ReLU layers (``_FuseList``,
``fuse_{loc,cls}_stage{1,2,3}``). Each stream:

  * the stem conv1-bn1-conv2-relu-bn2-relu (no ReLU after ``bn1``, the
    DualHRNet quirk, dual_hrnet.py:662-672) to 1/4, ``layer1`` (4
    ``HRBottleneck``, 64 -> 256);
  * ``transitions`` (``Transition``: a 3x3 conv-BN-ReLU where a branch
    changes width, a 3x3/s2 chain for a new branch) and the stages
    ``stage2`` (1 ``HRModule`` of branches (32, 64)), ``stage3`` (4 of (32,
    64, 128)), ``stage4`` (3 of (32, 64, 128, 256)); each module runs 4
    ``HRBasicBlock`` per branch, then fuses all to all (coarser to finer:
    1x1 conv-BN and a bilinear upsample; finer to coarser: a chain of
    3x3/s2 conv-BN with a ReLU between);
  * the head ``last_layer``: the branches upsampled bilinearly to 1/4 and
    concatenated (480 channels), or with ``use_fpn`` the ``_FPN`` sum (32),
    then 1x1 conv-BN-ReLU and a 1x1 conv to 2 (loc) or 4 (cls) classes.

The output is ``{"loc": (B, H/4, W/4, 2), "cls": (B, H/4, W/4, 4)}``. The
BatchNorms are flax's ``momentum=0.99`` (torch's 0.01), ``epsilon=1e-5``,
``dtype=float32`` (statistics and output in fp32); the FPN's GroupNorms run
in fp32. The bilinear resizes have half-pixel centres (``jax.image.resize``
"bilinear", which only enlarges here). The module tree carries the
reference's ``state_dict`` names, which dahitra_tpu/core/torch_import.py
``convert_dual_hrnet`` reads (``conv1``, ``bn1``, ``layer1.{b}``,
``transitions.{t}.{i}``, ``stage{s}.{m}.branches.{b}.{k}``,
``stage{s}.{m}.fuse_layers.{i}.{j}``, ``last_layer.{0,1,3}``,
``fuse_*_stage*.{i}.{0,1}``, ``fpn_*.{branch}...``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dahitra_tpu_torch.nn.blocks import BatchNorm, apply_conv, resize_bilinear

BN_MOM = 0.99  # flax's; torch momentum 0.01 (dual_hrnet.py:25)
STAGE2_CH = (32, 64)
STAGE3_CH = (32, 64, 128)
STAGE4_CH = (32, 64, 128, 256)
STAGE3_MODULES = 4
STAGE4_MODULES = 3
BLOCKS_PER_BRANCH = 4


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, torch.float32, momentum=BN_MOM)


def _conv_bn(seq: nn.Sequential, x: torch.Tensor, train: bool,
             dtype) -> torch.Tensor:
    """``seq[1](seq[0](x))``: a conv and its BatchNorm."""
    return seq[1](apply_conv(seq[0], x, dtype), train)


def _conv_bn_relu(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, 1, bias=False),
                         _bn(cout), nn.ReLU())


class HRBasicBlock(nn.Module):
    """3x3-BN-ReLU-3x3-BN plus the identity, then ReLU."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, filters, 3, stride, 1, bias=False)
        self.bn1 = _bn(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = _bn(filters)
        self.downsample = None
        if stride != 1 or in_channels != filters:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, filters, 1, stride, bias=False),
                _bn(filters))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        y = torch.relu(self.bn1(apply_conv(self.conv1, x, dt), train))
        y = self.bn2(apply_conv(self.conv2, y, dt), train)
        identity = x if self.downsample is None else _conv_bn(
            self.downsample, x, train, dt)
        return torch.relu(y + identity)


class HRBottleneck(nn.Module):
    """1x1-BN-ReLU-3x3-BN-ReLU-1x1 (4 x filters)-BN plus the identity, then
    ReLU."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        out = 4 * filters
        self.conv1 = nn.Conv2d(in_channels, filters, 1, bias=False)
        self.bn1 = _bn(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride, 1, bias=False)
        self.bn2 = _bn(filters)
        self.conv3 = nn.Conv2d(filters, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.downsample = None
        if stride != 1 or in_channels != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out, 1, stride, bias=False), _bn(out))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        y = torch.relu(self.bn1(apply_conv(self.conv1, x, dt), train))
        y = torch.relu(self.bn2(apply_conv(self.conv2, y, dt), train))
        y = self.bn3(apply_conv(self.conv3, y, dt), train)
        identity = x if self.downsample is None else _conv_bn(
            self.downsample, x, train, dt)
        return torch.relu(y + identity)


class _Blocks(nn.Sequential):
    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for block in self:
            x = block(x, train)
        return x


class HRModule(nn.Module):
    """Parallel branches, then all-to-all fusion (dual_hrnet.py:170-314)."""

    def __init__(self, channels: Sequence[int], dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        ch = tuple(channels)
        self.branches = nn.ModuleList(
            _Blocks(*[HRBasicBlock(c, c, dtype=dtype)
                      for _ in range(BLOCKS_PER_BRANCH)]) for c in ch)
        self.fuse_layers = None
        if len(ch) > 1:
            rows = []
            for i in range(len(ch)):
                row = []
                for j in range(len(ch)):
                    if j == i:
                        row.append(None)
                    elif j > i:
                        row.append(nn.Sequential(
                            nn.Conv2d(ch[j], ch[i], 1, bias=False),
                            _bn(ch[i])))
                    else:
                        row.append(nn.Sequential(*[nn.Sequential(
                            nn.Conv2d(ch[j], ch[i] if k == i - j - 1
                                      else ch[j], 3, 2, 1, bias=False),
                            _bn(ch[i] if k == i - j - 1 else ch[j]))
                            for k in range(i - j)]))
                rows.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs: List[torch.Tensor],
                train: bool = False) -> List[torch.Tensor]:
        dt = self.dtype
        ys = [branch(x, train) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                if j == i:
                    t = ys[j]
                elif j > i:
                    t = resize_bilinear(_conv_bn(layer, ys[j], train, dt),
                                        ys[i].shape[1], ys[i].shape[2])
                else:
                    t = ys[j]
                    for k, step in enumerate(layer):
                        t = _conv_bn(step, t, train, dt)
                        if k < len(layer) - 1:
                            t = torch.relu(t)
                acc = t if acc is None else acc + t
            fused.append(torch.relu(acc))
        return fused


class Transition(nn.ModuleList):
    """New branches and channel changes between stages (dual_hrnet.py:
    406-440): entry i is None (the branch as it is), a flat 3x3
    conv-BN-ReLU (its width changes) or, for a new branch, a chain of 3x3/s2
    conv-BN-ReLU from the last branch."""

    def __init__(self, pre_channels: Sequence[int],
                 cur_channels: Sequence[int], dtype=torch.float32):
        layers = []
        n_pre = len(pre_channels)
        for i, ch in enumerate(cur_channels):
            if i < n_pre:
                layers.append(None if ch == pre_channels[i] else
                              _conv_bn_relu(pre_channels[i], ch))
            else:
                layers.append(nn.Sequential(*[_conv_bn_relu(
                    pre_channels[-1], ch if j == i - n_pre
                    else pre_channels[-1], 2) for j in range(i + 1 - n_pre)]))
        super().__init__(layers)
        self.n_pre, self.dtype = n_pre, dtype

    def forward(self, xs: List[torch.Tensor],
                train: bool = False) -> List[torch.Tensor]:
        out = []
        for i, layer in enumerate(self):
            if layer is None:
                out.append(xs[i])
            elif i < self.n_pre:
                out.append(torch.relu(_conv_bn(layer, xs[i], train,
                                               self.dtype)))
            else:
                t = xs[-1]
                for step in layer:
                    t = torch.relu(_conv_bn(step, t, train, self.dtype))
                out.append(t)
        return out


class HRNetStream(nn.Module):
    """One HRNet-W32 stream, stage by stage for the cross-stream fusion.
    ``head_width`` is the head's width (0: the concatenation's 480)."""

    def __init__(self, n_classes: int, dtype=torch.float32,
                 head_width: int = 0):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = _bn(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = _bn(64)
        self.layer1 = _Blocks(*[HRBottleneck(64 if i == 0 else 256, 64,
                                             dtype=dtype) for i in range(4)])
        self.transitions = nn.ModuleList([
            Transition((256,), STAGE2_CH, dtype),
            Transition(STAGE2_CH, STAGE3_CH, dtype),
            Transition(STAGE3_CH, STAGE4_CH, dtype)])
        self.stage2 = nn.ModuleList([HRModule(STAGE2_CH, dtype)])
        self.stage3 = nn.ModuleList([HRModule(STAGE3_CH, dtype)
                                     for _ in range(STAGE3_MODULES)])
        self.stage4 = nn.ModuleList([HRModule(STAGE4_CH, dtype)
                                     for _ in range(STAGE4_MODULES)])
        total = head_width or sum(STAGE4_CH)
        self.last_layer = nn.Sequential(
            nn.Conv2d(total, total, 1), _bn(total), nn.ReLU(),
            nn.Conv2d(total, n_classes, 1))

    def stem_stage1(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """The DualHRNet quirk: no ReLU after ``bn1``."""
        dt = self.dtype
        x = self.bn1(apply_conv(self.conv1, x, dt), train)
        x = torch.relu(apply_conv(self.conv2, x, dt))
        x = torch.relu(self.bn2(x, train))
        return self.layer1(x, train)

    def run_stage(self, idx: int, xs, train: bool):
        for m in (self.stage2, self.stage3, self.stage4)[idx - 2]:
            xs = m(xs, train)
        return xs

    def head(self, xs, train: bool) -> torch.Tensor:
        if isinstance(xs, (list, tuple)):
            h, w = xs[0].shape[1], xs[0].shape[2]
            xs = torch.cat([xs[0]] + [resize_bilinear(t, h, w)
                                      for t in xs[1:]], -1)
        y = torch.relu(_conv_bn(self.last_layer, xs, train, self.dtype))
        return apply_conv(self.last_layer[3], y, self.dtype)


class _FPN(nn.ModuleList):
    """The FPN head (dual_hrnet.py:634-663): branch 0 a 3x3 conv-GroupNorm
    (channels / 8 groups)-ReLU; branch i > 0 a chain of (3x3 conv to the
    next finer width, GroupNorm, ReLU, bilinear x2) down to 1/4; the
    branches summed."""

    def __init__(self, channels: Sequence[int], dtype=torch.float32):
        ch = tuple(channels)

        def step(cin, cout):
            return [nn.Conv2d(cin, cout, 3, padding=1),
                    nn.GroupNorm(cout // 8, cout, eps=1e-5), nn.ReLU()]

        super().__init__([nn.Sequential(*step(ch[0], ch[0]))] + [
            nn.Sequential(*[nn.Sequential(*step(ch[idx], ch[idx - 1]))
                            for idx in range(br, 0, -1)])
            for br in range(1, len(ch))])
        self.dtype = dtype

    def _step(self, seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        y = apply_conv(seq[0], x, self.dtype).permute(0, 3, 1, 2).float()
        gn = seq[1]
        y = F.group_norm(y, gn.num_groups, gn.weight, gn.bias, gn.eps)
        return torch.relu(y.permute(0, 2, 3, 1))

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        out = self._step(self[0], xs[0])
        for br in range(1, len(self)):
            t = xs[br]
            for seq in self[br]:
                t = self._step(seq, t)
                t = resize_bilinear(t, 2 * t.shape[1], 2 * t.shape[2])
            out = out + t
        return out


class _FuseList(nn.ModuleList):
    """Per-branch 1x1 conv-BN-ReLU over both streams' concatenated
    branches (dual_hrnet.py:609-622)."""

    def __init__(self, channels: Sequence[int], dtype=torch.float32):
        super().__init__([nn.Sequential(
            nn.Conv2d(2 * ch, ch, 1, bias=False), _bn(ch), nn.ReLU())
            for ch in channels])
        self.dtype = dtype

    def forward(self, xs: List[torch.Tensor],
                train: bool = False) -> List[torch.Tensor]:
        return [torch.relu(_conv_bn(seq, x, train, self.dtype))
                for seq, x in zip(self, xs)]


class DualHRNet(nn.Module):
    """(B, H, W, 6) pre|post (or two images) -> {"loc": (B, H/4, W/4, 2),
    "cls": (B, H/4, W/4, 4)} logits. ``use_fpn`` is the reference's
    USE_FPN branch with the JAX package's repair: a 32-channel head
    (dahitra_tpu/models/dual_hrnet.py:280-290)."""

    def __init__(self, dtype=torch.float32, use_fpn: bool = False):
        super().__init__()
        self.use_fpn = use_fpn
        hw = STAGE4_CH[0] if use_fpn else 0
        self.loc_net = HRNetStream(2, dtype, hw)
        self.cls_net = HRNetStream(4, dtype, hw)
        if use_fpn:
            self.fpn_loc = _FPN(STAGE4_CH, dtype)
            self.fpn_cls = _FPN(STAGE4_CH, dtype)
        for stream in ("loc", "cls"):
            for s, ch in enumerate((STAGE2_CH, STAGE3_CH, STAGE4_CH), 1):
                self.add_module(f"fuse_{stream}_stage{s}",
                                _FuseList(ch, dtype))

    def forward(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None,
                train: bool = False) -> dict:
        if x2 is None:
            x1, x2 = x1[..., :3], x1[..., 3:]
        loc, cls = self.loc_net, self.cls_net
        a = loc.transitions[0]([loc.stem_stage1(x1, train)], train)
        b = cls.transitions[0]([cls.stem_stage1(x2, train)], train)
        for s in range(3):
            cat = [torch.cat([p, q], -1) for p, q in zip(a, b)]
            a = loc.run_stage(s + 2, getattr(
                self, f"fuse_loc_stage{s + 1}")(cat, train), train)
            b = cls.run_stage(s + 2, getattr(
                self, f"fuse_cls_stage{s + 1}")(cat, train), train)
            if s < 2:
                a = loc.transitions[s + 1](a, train)
                b = cls.transitions[s + 1](b, train)
        if self.use_fpn:
            a, b = self.fpn_loc(a), self.fpn_cls(b)
        return {"loc": loc.head(a, train), "cls": cls.head(b, train)}
