"""DAHiTra, the hierarchical-transformer UNet change detector
(``newUNetTrans``), eval and train forward.

Counterpart of dahitra_tpu/models/dahitra.py (``DAHiTraUNet`` and
``TransDiffModule``, :67-322). The module tree carries the reference's
``BASE_Transformer_UNet`` names (models/networks.py:1142-1357), the names
dahitra_tpu/core/torch_import.py ``convert_dahitra`` reads, so a reference
checkpoint loads as it is. The transformer-difference module of each scale
is ``_trans_diff`` over the flat per-scale attributes (``conv_squeeze_3``,
``conv_token_3``, ``transformer_3``, ``transformer_decoder_3``, ...).

Scales: 1/4 ("3", 64 ch, decoder depth 8, 8 heads), 1/8 ("4", 128 ch, depth
4, 4 heads), 1/16 ("5", 256 ch, depth 4, 4 heads); every width is 32.
Per forward, the K3 tokenizer runs once per scale and the decoder stack
twice per scale (the two dates batch-stacked, then the difference): K1
without saves in eval, K1 with saves and then K2 in a training step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from dahitra_tpu_torch.nn.blocks import (SemanticTokenizer, TransformerDecoder,
                                         TransformerEncoder, TwoLayerConv,
                                         UpConv, conv2d_nhwc, max_pool_3x3_s2,
                                         upsample_nearest)
from dahitra_tpu_torch.nn.init import init_random
from dahitra_tpu_torch.nn.resnet import ResNetTrunk

# scale -> (input channels, encoder heads, decoder depth, decoder heads,
# stride below the image)
_SCALES: Dict[str, Tuple[int, int, int, int, int]] = {
    "3": (64, 8, 8, 8, 4), "4": (128, 4, 4, 4, 8), "5": (256, 4, 4, 4, 16)}
_DIM = 32
_TOKENS = 4
_DIM_HEAD = 64  # encoder and decoder heads


class DAHiTraUNet(nn.Module):
    """``newUNetTrans``: 4 tokens, one encoder layer, learned token and
    decoder positional embeddings.

    ``forward`` also takes the xBD single 6-channel pre|post tensor
    (``input_nc=6`` in the JAX model). ``pos_coarsest_only`` is the xBD
    quirk: positional embeddings only at the coarsest scale, read from the
    suffix-3 parameters. ``decode_dates=False`` skips the per-date decoder
    passes (the xBD copy); by default it follows ``not pos_coarsest_only``
    as in the JAX model. The positional embeddings are drawn N(0, 1) from
    ``generator`` (seed 0 when none is given), as the flax initializer
    does; ``nn/init.py`` leaves them as they are.
    """

    def __init__(self, output_nc: int = 2, img_size: int = 256,
                 pos_coarsest_only: bool = False,
                 decode_dates: Optional[bool] = None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        dim = _DIM
        self.dtype = dtype
        self.decode_dates = (not pos_coarsest_only if decode_dates is None
                             else decode_dates)
        self.resnet = ResNetTrunk("resnet18", (False, True, True), 3,
                                  num_layers=3, dtype=dtype)
        # scale -> suffix of the positional parameters it reads (or None).
        self.pos_ref = {r: ("3" if r == "5" else None) if pos_coarsest_only
                        else r for r in _SCALES}
        for r, (c_in, enc_heads, dec_depth, dec_heads, stride) in _SCALES.items():
            self.add_module(f"conv_squeeze_{r}", nn.Sequential(
                nn.Conv2d(c_in, dim, 1, bias=False), nn.ReLU()))
            self.add_module(f"conv_token_{r}",
                            SemanticTokenizer(dim, _TOKENS, dtype))
            self.add_module(f"transformer_{r}", TransformerEncoder(
                dim, 1, enc_heads, _DIM_HEAD, dim, dtype))
            self.add_module(f"transformer_decoder_{r}", TransformerDecoder(
                dim, dec_depth, dec_heads, _DIM_HEAD, dim, dtype=dtype))
            self.add_module(f"conv_decode_{r}",
                            nn.Conv2d(2 * dim, dim, 3, padding=1, bias=False))
            p = self.pos_ref[r]
            if p is not None:
                self.register_parameter(f"pos_embedding_{p}", nn.Parameter(
                    torch.randn(1, 2 * _TOKENS, dim, generator=gen)))
                s = img_size // stride
                self.register_parameter(f"pos_embedding_decoder_{p}",
                                        nn.Parameter(torch.randn(
                                            1, dim, s, s, generator=gen)))
        self.conv_layer2_0 = TwoLayerConv(128, dim, dtype)
        self.conv_layer2 = UpConv(dim, dim, dtype)
        self.conv_layer3 = UpConv(dim, dim, dtype)
        self.conv_layer4 = UpConv(dim, dim, dtype)
        self.classifier = nn.Conv2d(dim, output_nc, 3, padding=1)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (``nn/init.py`` ``init_random``):
        lecun-normal conv and linear kernels, zero biases, unit-normal
        positional embeddings, and BN running statistics near identity."""
        init_random(self, generator)

    def _decode(self, r: str, x: torch.Tensor, tokens: torch.Tensor):
        """The decoder positional embedding is added on every decoder call
        (networks.py:1286-1294)."""
        b, h, w, c = x.shape
        pos = getattr(self, f"pos_embedding_decoder_{self.pos_ref[r]}", None)
        if pos is not None:
            x = x + pos.permute(0, 2, 3, 1)
        seq = getattr(self, f"transformer_decoder_{r}")(x.reshape(b, h * w, c),
                                                        tokens)
        return seq.reshape(b, h, w, c)

    def _trans_diff(self, r: str, x1: torch.Tensor, x2: torch.Tensor):
        """TransDiffModule.__call__ (dahitra.py:121-152): squeeze, tokens,
        joint encoder, per-date decode, difference decode. Both dates run
        batch-stacked."""
        b = x1.shape[0]
        x12 = torch.relu(conv2d_nhwc(
            torch.cat([x1, x2], 0),
            getattr(self, f"conv_squeeze_{r}")[0].weight, dtype=self.dtype))
        t12 = getattr(self, f"conv_token_{r}")(x12)
        tokens = torch.cat([t12[:b], t12[b:]], 1)
        pos = getattr(self, f"pos_embedding_{self.pos_ref[r]}", None)
        if pos is not None:
            tokens = tokens + pos
        tokens = getattr(self, f"transformer_{r}")(tokens)
        t1, t2 = tokens.chunk(2, dim=1)
        if self.decode_dates:
            xd = self._decode(r, x12, torch.cat([t1, t2], 0))
            x1d, x2d = xd[:b], xd[b:]
        else:
            x1d, x2d = x12[:b], x12[b:]
        diff_x = conv2d_nhwc(torch.cat([x1d, x2d], -1),
                             getattr(self, f"conv_decode_{r}").weight,
                             padding=1, dtype=self.dtype)
        return self._decode(r, diff_x, (t2 - t1).abs())

    def forward_single(self, x: torch.Tensor, train: bool = False,
                       pair: bool = False):
        """4-scale trunk (networks.py:1118-1138); the maxpool reads the
        post-ReLU stem (the reference's in-place ReLU)."""
        r = self.resnet
        x_2 = torch.relu(r.stem_preact(x, train, pair))
        x_4 = r.layer1(max_pool_3x3_s2(x_2), train, pair)
        x_8 = r.layer2(x_4, train, pair)
        x_16 = r.layer3(max_pool_3x3_s2(x_8), train, pair)
        return x_2, x_4, x_8, x_16

    def forward(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        """NHWC images (B, H, W, 3) twice, or one (B, H, W, 6) -> logits
        (B, H, W, output_nc) in the compute dtype.

        ``train=True`` is dahitra.py:278-304 in the split-heads form: one
        [date1; date2] trunk pass whose BatchNorms take per-date batch
        statistics, the trans modules on the split halves, and
        ``conv_layer2_0``'s BatchNorm over the channel-concatenated pair."""
        if x2 is None:
            x1, x2 = x1[..., :3], x1[..., 3:]
        feats = self.forward_single(torch.cat([x1, x2], 0), train, pair=train)
        (a2, b2), (a4, b4), (a8, b8), (a16, b16) = (f.chunk(2, 0) for f in feats)
        out5 = upsample_nearest(self._trans_diff("5", a16, b16))
        out4 = self.conv_layer4(self._trans_diff("4", a8, b8) + out5)
        out3 = self.conv_layer3(self._trans_diff("3", a4, b4) + out4)
        out2 = self.conv_layer2_0(torch.cat([a2, b2], -1), train)
        out2 = self.conv_layer2(out2 + out3)
        return conv2d_nhwc(out2, self.classifier.weight, self.classifier.bias,
                           padding=1, dtype=self.dtype)
