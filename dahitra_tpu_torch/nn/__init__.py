"""Blocks, ResNet trunk and the decoder stack of the port."""
from dahitra_tpu_torch.nn.blocks import (ConvRelu, ConvReluBN, CrossAttention,
                                         Dropout, FeedForward,
                                         MultiHeadSelfAttention,
                                         SemanticTokenizer, TransformerDecoder,
                                         TransformerEncoder, TwoLayerConv,
                                         max_pool_2x2, max_pool_3x3_s2,
                                         max_pool_3x3_s2_ceil,
                                         resize_bilinear, upsample_bilinear,
                                         upsample_nearest)
from dahitra_tpu_torch.nn.resnet import BasicBlock, Bottleneck, ResNetTrunk

__all__ = [
    "ConvRelu",
    "ConvReluBN",
    "CrossAttention",
    "Dropout",
    "FeedForward",
    "MultiHeadSelfAttention",
    "SemanticTokenizer",
    "TransformerDecoder",
    "TransformerEncoder",
    "TwoLayerConv",
    "max_pool_2x2",
    "max_pool_3x3_s2",
    "max_pool_3x3_s2_ceil",
    "resize_bilinear",
    "upsample_bilinear",
    "upsample_nearest",
    "BasicBlock",
    "Bottleneck",
    "ResNetTrunk",
]
