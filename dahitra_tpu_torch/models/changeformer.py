"""ChangeFormer (``changeFormer``) and ChangeFormerV6 (``changeFormerV6``),
the SegFormer-style siamese change detectors.

Counterpart of dahitra_tpu/models/changeformer.py (the reference's
models/ChangeFormer.py):

  * ``EncoderTransformerV3``: four stages of ``OverlapPatchEmbed`` (7x7 /
    s4, then ``patch_size`` / s2; LayerNorm eps 1e-6) and ``SegformerBlock``s
    (spatial-reduction attention with sr ratios 8/4/2/1 and 1/2/4/8 heads,
    then the Mix-FFN: Linear, depthwise 3x3, exact GELU, Linear; per-sample
    drop path from the linear ramp to ``drop_path_rate``), each stage
    closed by a LayerNorm; the residual stream stays fp32;
  * ``DecoderTransformerV3`` (V6): per scale a Linear to 256 shared by both
    dates, ``ConvDiff`` on their concatenation, the coarser scale's map
    added after a bilinear x2, a ``MakePrediction`` head; the four maps
    brought to 1/4 scale, ``linear_fuse`` (1x1 conv and BN), two
    ``UpsampleConvX2`` (``ConvTranspose2d(k4, s2, p1)``) each followed by a
    ``ResidualBlock01``, and a 3x3 conv: the list of five logits [p4, p3,
    p2, p1, full];
  * ``ConvProjectionBase`` (V1): the transposed-conv ladder over the
    per-scale |f1 - f2| with skip additions, and a 3x3 head.

Attention runs as the port's other attention does, with matmul and an
fp32 softmax, so the CPU and the card compute the same arithmetic. The
module tree carries the reference's ``state_dict`` names (V6: ``Tenc_x2``,
``TDec_x2``; V1: ``Tenc``, ``convproj``, ``change_probability``), which
dahitra_tpu/core/torch_import.py ``convert_changeformer`` reads; V1's
intra-patch modules, which its forward never calls, are not built, nor is
the JAX modules' ``decoder_softmax`` option, which no registry key sets.
Both dates run through the encoder batch-stacked (it has no BatchNorm).
Dropout and drop path are active in train mode (``set_dropout_generator``).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dahitra_tpu_torch.nn.blocks import (BatchNorm, Dropout, _dense,
                                         conv2d_nhwc, conv_transpose2d_nhwc)


def _resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC bilinear resize with half-pixel centres (``jax.image.resize``
    "bilinear" when upsampling)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """An NHWC ``nn.Conv2d`` with its own stride, padding and groups."""
    return conv2d_nhwc(x, conv.weight, conv.bias, conv.stride[0],
                       conv.padding[0], dtype, conv.groups)


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return norm(x.float())


class OverlapPatchEmbed(nn.Module):
    def __init__(self, patch_size: int, stride: int, in_chans: int,
                 embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride,
                              patch_size // 2)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ln(self.norm, _conv(x, self.proj, self.dtype))


class DWConv(nn.Module):
    """The depthwise 3x3 of the Mix-FFN, under the reference's name."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)


class MixFFN(nn.Module):
    """fc1 -> depthwise 3x3 -> GELU (exact) -> dropout -> fc2 -> dropout."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        x = _conv(_dense(x, self.fc1, self.dtype), self.dwconv.dwconv,
                  self.dtype)
        x = self.drop(F.gelu(x), deterministic)
        return self.drop(_dense(x, self.fc2, self.dtype), deterministic)


class SRAttention(nn.Module):
    """Spatial-reduction attention (ChangeFormer.py:298-358): queries from
    every pixel, keys and values from the map reduced by an sr x sr conv
    (and a LayerNorm) where ``sr_ratio`` > 1; scale head_dim^-0.5."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        b, h, w, c = x.shape
        heads, hd = self.num_heads, self.dim // self.num_heads
        q = _dense(x, self.q, self.dtype).reshape(b, h * w, heads, hd)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = _ln(self.norm, _conv(x, self.sr, self.dtype))
        kv = _dense(kv_in, self.kv, self.dtype).reshape(b, -1, 2, heads, hd)
        q, k, v = q.transpose(1, 2), kv[:, :, 0].transpose(1, 2), \
            kv[:, :, 1].transpose(1, 2)
        dots = torch.matmul(q, k.transpose(-1, -2)).float() * hd ** -0.5
        attn = self.attn_drop(torch.softmax(dots, -1).to(q.dtype),
                              deterministic)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, h, w, self.dim)
        return self.proj_drop(_dense(out, self.proj, self.dtype),
                              deterministic)


class SegformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: int = 4, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SRAttention(dim, num_heads, sr_ratio, attn_drop, drop,
                                dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, dim * mlp_ratio, drop, dtype)
        self.drop_path = Dropout(drop_path, per="sample")

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        x = x + self.drop_path(self.attn(_ln(self.norm1, x), deterministic),
                               deterministic)
        return x + self.drop_path(self.mlp(_ln(self.norm2, x), deterministic),
                                  deterministic)


class EncoderTransformerV3(nn.Module):
    """(B, H, W, 3) -> the four stage maps (B, H/4, W/4, 64) ... (B, H/32,
    W/32, 512), fp32."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 4, 8),
                 depths: Sequence[int] = (3, 3, 4, 3),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1), patch_size: int = 7,
                 drop: float = 0.1, attn_drop: float = 0.1,
                 drop_path_rate: float = 0.1, in_chans: int = 3,
                 dtype=torch.float32):
        super().__init__()
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        cur = 0
        for s in range(4):
            self.add_module(f"patch_embed{s + 1}", OverlapPatchEmbed(
                7 if s == 0 else patch_size, 4 if s == 0 else 2,
                in_chans if s == 0 else embed_dims[s - 1], embed_dims[s],
                dtype))
            self.add_module(f"block{s + 1}", nn.ModuleList([
                SegformerBlock(embed_dims[s], num_heads[s], sr_ratios[s], 4,
                               drop, attn_drop, dpr[cur + i], dtype)
                for i in range(depths[s])]))
            self.add_module(f"norm{s + 1}",
                            nn.LayerNorm(embed_dims[s], eps=1e-6))
            cur += depths[s]

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> List[torch.Tensor]:
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"patch_embed{s}")(x)
            for block in getattr(self, f"block{s}"):
                x = block(x, not train)
            x = _ln(getattr(self, f"norm{s}"), x)
            outs.append(x)
        return outs


class _Conv(nn.Module):
    """The reference's ``ConvLayer`` / ``UpsampleConvLayer``: one conv under
    the name ``conv2d``."""

    def __init__(self, conv: nn.Module, dtype):
        super().__init__()
        self.conv2d, self.dtype = conv, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.conv2d, nn.ConvTranspose2d):
            return conv_transpose2d_nhwc(x, self.conv2d, self.dtype)
        return _conv(x, self.conv2d, self.dtype)


def upsample_conv_x2(c_in: int, c_out: int, dtype) -> _Conv:
    """``ConvTranspose2d(k4, s2, p1)``: an exact x2 upsampling."""
    return _Conv(nn.ConvTranspose2d(c_in, c_out, 4, 2, 1), dtype)


class ResidualBlock01(nn.Module):
    """x + 0.1 conv2(relu(conv1(x))), 3x3 convs
    (ChangeFormerBaseNetworks.py:108-121)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = _Conv(nn.Conv2d(channels, channels, 3, 1, 1), dtype)
        self.conv2 = _Conv(nn.Conv2d(channels, channels, 3, 1, 1), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(torch.relu(self.conv1(x))) * 0.1


class _ConvBNStack(nn.Sequential):
    """conv3 - ReLU - BN - conv3 [- ReLU]: ``ConvDiff`` with the final ReLU
    (ChangeFormer.py:1129-1137), ``MakePrediction`` without it (:1139-1146;
    its BN runs over the output width)."""

    def __init__(self, c_in: int, c_out: int, final_relu: bool, dtype):
        layers = [nn.Conv2d(c_in, c_out, 3, padding=1), nn.ReLU(),
                  BatchNorm(c_out, dtype),
                  nn.Conv2d(c_out, c_out, 3, padding=1)]
        super().__init__(*(layers + [nn.ReLU()] * final_relu))
        self.final_relu, self.dtype = final_relu, dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.relu(_conv(x, self[0], self.dtype))
        x = _conv(self[2](x, train), self[3], self.dtype)
        return torch.relu(x) if self.final_relu else x


class _LinearEmbed(nn.Module):
    """The reference's ``MLP``: one Linear under the name ``proj``."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.proj = nn.Linear(c_in, c_out)


class DecoderTransformerV3(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (64, 128, 320, 512),
                 embedding_dim: int = 256, output_nc: int = 2,
                 dtype=torch.float32):
        super().__init__()
        e = embedding_dim
        self.dtype = dtype
        for tag, c in zip("1234", in_channels):
            self.add_module(f"linear_c{tag}", _LinearEmbed(c, e))
        for tag in "4321":
            self.add_module(f"diff_c{tag}", _ConvBNStack(2 * e, e, True,
                                                         dtype))
            self.add_module(f"make_pred_c{tag}",
                            _ConvBNStack(e, output_nc, False, dtype))
        self.linear_fuse = nn.Sequential(nn.Conv2d(4 * e, e, 1),
                                         BatchNorm(e, dtype))
        self.convd2x = upsample_conv_x2(e, e, dtype)
        self.dense_2x = nn.Sequential(ResidualBlock01(e, dtype))
        self.convd1x = upsample_conv_x2(e, e, dtype)
        self.dense_1x = nn.Sequential(ResidualBlock01(e, dtype))
        self.change_probability = _Conv(
            nn.Conv2d(e, output_nc, 3, 1, 1), dtype)

    def forward(self, feats1: List[torch.Tensor], feats2: List[torch.Tensor],
                train: bool = False) -> List[torch.Tensor]:
        h1, w1 = feats1[0].shape[1:3]
        outputs, cs_up, prev = [], [], None
        for s in (3, 2, 1, 0):
            tag = str(s + 1)
            lin = getattr(self, f"linear_c{tag}").proj
            pair = torch.cat([_dense(feats1[s], lin, self.dtype),
                              _dense(feats2[s], lin, self.dtype)], -1)
            d = getattr(self, f"diff_c{tag}")(pair, train)
            if prev is not None:
                d = d + _resize_bilinear(prev, d.shape[1], d.shape[2])
            outputs.append(getattr(self, f"make_pred_c{tag}")(d, train))
            prev = d
            cs_up.append(d if s == 0 else _resize_bilinear(d, h1, w1))
        fused = _conv(torch.cat(cs_up, -1), self.linear_fuse[0], self.dtype)
        fused = self.linear_fuse[1](fused, train)
        x = self.dense_2x(self.convd2x(fused))
        x = self.dense_1x(self.convd1x(x))
        outputs.append(self.change_probability(x))
        return outputs


class ConvProjectionBase(nn.Module):
    """The difference-image decoder of V1 (ChangeFormer.py:590-641)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        for name, c_in, c_out in (("convd16x", 512, 320),
                                  ("convd8x", 320, 128),
                                  ("convd4x", 128, 64), ("convd2x", 64, 16),
                                  ("convd1x", 16, 8)):
            self.add_module(name, upsample_conv_x2(c_in, c_out, dtype))
        for name, c in (("dense_4", 320), ("dense_3", 128), ("dense_2", 64),
                        ("dense_1", 16)):
            self.add_module(name, nn.Sequential(ResidualBlock01(c, dtype)))

    def forward(self, di: List[torch.Tensor]) -> torch.Tensor:
        def crop_to(x, ref):
            return x[:, :ref.shape[1], :ref.shape[2]]

        y = self.dense_4(crop_to(self.convd16x(di[3]), di[2])) + di[2]
        y = self.dense_3(crop_to(self.convd8x(y), di[1])) + di[1]
        y = self.dense_2(crop_to(self.convd4x(y), di[0])) + di[0]
        y = self.dense_1(self.convd2x(y))
        return self.convd1x(y)


def _encode_dates(encoder: EncoderTransformerV3, x1: torch.Tensor,
                  x2: torch.Tensor, train: bool):
    feats = encoder(torch.cat([x1, x2], 0), train)
    return [f.chunk(2, 0)[0] for f in feats], [f.chunk(2, 0)[1] for f in feats]


class ChangeFormerV1(nn.Module):
    """``changeFormer`` (ChangeFormer.py:643-674): NHWC images twice ->
    logits (B, H, W, output_nc)."""

    def __init__(self, output_nc: int = 2, dtype=torch.float32):
        super().__init__()
        self.Tenc = EncoderTransformerV3(
            depths=(3, 4, 6, 3), patch_size=3, drop=0.0, attn_drop=0.0,
            drop_path_rate=0.1, dtype=dtype)
        self.convproj = ConvProjectionBase(dtype)
        self.change_probability = _Conv(nn.Conv2d(8, output_nc, 3, 1, 1),
                                        dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        f1, f2 = _encode_dates(self.Tenc, x1, x2, train)
        di = [(a - b).abs() for a, b in zip(f1, f2)]
        return self.change_probability(self.convproj(di))


class ChangeFormerV6(nn.Module):
    """``changeFormerV6`` (ChangeFormer.py:1657-1687): NHWC images twice ->
    the list of logits [p4, p3, p2, p1, full] (1/32 to full scale)."""

    def __init__(self, output_nc: int = 2, dtype=torch.float32):
        super().__init__()
        self.Tenc_x2 = EncoderTransformerV3(
            depths=(3, 3, 4, 3), patch_size=7, drop=0.1, attn_drop=0.1,
            drop_path_rate=0.1, dtype=dtype)
        self.TDec_x2 = DecoderTransformerV3(output_nc=output_nc, dtype=dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                train: bool = False) -> List[torch.Tensor]:
        f1, f2 = _encode_dates(self.Tenc_x2, x1, x2, train)
        return self.TDec_x2(f1, f2, train)
