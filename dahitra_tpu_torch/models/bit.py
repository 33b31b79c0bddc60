"""BIT, the bitemporal image transformer change detector
(``base_transformer_pos_s4*``).

Counterpart of dahitra_tpu/models/bit.py (the reference's
models/networks.py:260-392, class BASE_Transformer): the ``ResNetCD`` trunk
and ``conv_pred`` over both dates, the semantic tokenizer (``token_len``
tokens per date, the K3 kernel on the card), one transformer encoder over the
two dates' tokens with a learned positional embedding (1, 2 L, 32), the
cross-attention decoder projecting each date's tokens back onto its pixels
(``TransformerDecoder`` with ``mlp_dim`` 64: the K1 kernel in eval, K1 with
saves and K2 in training, K4 with ``pallas = True``), |f1 - f2|, x4 bilinear
upsampling and the ``TwoLayerConv`` classifier.

The module tree carries the reference's ``state_dict`` names, the names
dahitra_tpu/core/torch_import.py ``convert_bit`` reads: ``resnet.*``,
``conv_pred``, ``conv_a`` (the tokenizer), ``pos_embedding``,
``pos_embedding_decoder`` (NCHW, with ``with_decoder_pos``),
``transformer.layers.*``, ``transformer_decoder.layers.*`` and
``classifier.{0,1,3}``.

Per forward, as in the JAX module: the trunk over both dates batch-stacked
(per-date BatchNorm statistics in train mode, the JAX module's two
``forward_single`` calls), the tokenizer once per date and the decoder once
per date (``_decode``, bit.py:116-117), so K3 and the decoder kernels launch
twice each.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from dahitra_tpu_torch.models.resnet_cd import DIM, SiameseTrunk
from dahitra_tpu_torch.nn.blocks import (SemanticTokenizer, TransformerDecoder,
                                         TransformerEncoder, TwoLayerConv)


class BIT(SiameseTrunk):
    """NHWC images (B, H, W, 3) twice, or one (B, H, W, 6) pre|post tensor
    (the xBD convention) -> logits (B, H, W, output_nc) in the compute dtype.

    Fields as in the JAX module. ``pos_embedding`` (with ``with_pos ==
    "learned"``) and ``pos_embedding_decoder`` (with ``with_decoder_pos`` in
    "learned", "fix") are drawn N(0, 1) from ``generator`` (seed 0 when none
    is given), as the reference's ``torch.randn`` and the flax initializer
    draw them; ``nn/init.py`` ``init_weights`` leaves them as they are."""

    def __init__(self, output_nc: int = 2, token_len: int = 4,
                 resnet_stages_num: int = 4, enc_depth: int = 1,
                 dec_depth: int = 1, dim_head: int = 64,
                 decoder_dim_head: int = 64, heads: int = 8,
                 backbone: str = "resnet18", with_pos: Optional[str] = "learned",
                 with_decoder_pos: Optional[str] = None,
                 decoder_softmax: bool = True, if_upsample_2x: bool = True,
                 token_trans: bool = True, with_decoder: bool = True,
                 output_sigmoid: bool = False, decoder_pos_size: int = 64,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(backbone, resnet_stages_num, if_upsample_2x, dtype)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.token_trans, self.with_decoder = token_trans, with_decoder
        self.output_sigmoid = output_sigmoid
        self.conv_a = SemanticTokenizer(DIM, token_len, dtype)
        if with_pos == "learned":
            self.pos_embedding = nn.Parameter(
                torch.randn(1, 2 * token_len, DIM, generator=gen))
        else:
            self.pos_embedding = None
        if with_decoder_pos in ("learned", "fix"):
            self.pos_embedding_decoder = nn.Parameter(torch.randn(
                1, DIM, decoder_pos_size, decoder_pos_size, generator=gen))
        else:
            self.pos_embedding_decoder = None
        self.transformer = TransformerEncoder(DIM, enc_depth, heads, dim_head,
                                              2 * DIM, dtype)
        self.transformer_decoder = TransformerDecoder(
            DIM, dec_depth, heads, decoder_dim_head, 2 * DIM,
            softmax=decoder_softmax, dtype=dtype)
        self.classifier = TwoLayerConv(DIM, output_nc, dtype)

    def _decode(self, x: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if self.pos_embedding_decoder is not None:
            x = x + self.pos_embedding_decoder.permute(0, 2, 3, 1)
        seq = self.transformer_decoder(x.reshape(b, h * w, c), tokens)
        return seq.reshape(b, h, w, c)

    def forward(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        if x2 is None:
            x1, x2 = x1[..., :3], x1[..., 3:]
        f1, f2 = self.forward_single(torch.cat([x1, x2], 0), train,
                                     pair=train).chunk(2, 0)
        t1, t2 = self.conv_a(f1), self.conv_a(f2)
        if self.token_trans:
            tokens = torch.cat([t1, t2], 1)
            if self.pos_embedding is not None:
                tokens = tokens + self.pos_embedding
            t1, t2 = self.transformer(tokens).chunk(2, dim=1)
        if self.with_decoder:
            f1, f2 = self._decode(f1, t1), self._decode(f2, t2)
        else:
            # The simple decoder adds the summed tokens to every pixel
            # (networks.py:349-356).
            f1 = f1 + t1.sum(1)[:, None, None, :]
            f2 = f2 + t2.sum(1)[:, None, None, :]
        x = self.classifier(self.head(f1, f2), train)
        return torch.sigmoid(x) if self.output_sigmoid else x
