"""Weights from the JAX package's parameter trees, and reference checkpoints.

``flax_to_state_dict`` is the inverse of dahitra_tpu/core/torch_import.py
``convert_dahitra``: it takes the numpy ``params`` and ``batch_stats`` trees
of ``dahitra_tpu``'s ``DAHiTraUNet`` and returns the port's ``state_dict``,
whose keys are the reference ``BASE_Transformer_UNet`` keys.
``bit_flax_to_state_dict`` and ``resnet_cd_flax_to_state_dict`` are the
inverses of ``convert_bit`` and ``convert_resnet_cd``, for ``BIT`` and
``ResNetCD`` (the reference's ``BASE_Transformer`` and ``ResNet`` keys).
Conventions:

  * conv kernels HWIO -> OIHW, Dense kernels (in, out) -> Linear (out, in);
  * BN scale/bias/mean/var -> weight/bias/running_mean/running_var;
  * the decoder positional embedding NHWC -> NCHW.

The trees are read as nested mappings of array-likes; nothing here imports
JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from dahitra_tpu_torch.core.checkpoint import StateDict, model_state_dict

# (flax TransDiffModule name, reference suffix)
_SCALES = (("trans_3", "3"), ("trans_4", "4"), ("trans_5", "5"))


def _conv(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _linear(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (1, 0))


def _count(tree: Mapping, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


class _Writer:
    """Fills a ``state_dict`` from flax subtrees, one helper per layout."""

    def __init__(self):
        self.sd: StateDict = {}

    def put(self, key, value):
        self.sd[key] = torch.tensor(np.asarray(value, np.float32))

    def conv(self, key, p):
        """Conv kernel HWIO -> ``key.weight`` OIHW, and its bias if any."""
        self.put(f"{key}.weight", _conv(p["kernel"]))
        if "bias" in p:
            self.put(f"{key}.bias", p["bias"])

    def bn(self, key, p, s):
        self.put(f"{key}.weight", p["scale"])
        self.put(f"{key}.bias", p["bias"])
        self.put(f"{key}.running_mean", s["mean"])
        self.put(f"{key}.running_var", s["var"])

    def ln(self, key, p):
        self.put(f"{key}.weight", p["scale"])
        self.put(f"{key}.bias", p["bias"])

    def dense(self, key, p):
        self.put(f"{key}.weight", _linear(p["kernel"]))
        if "bias" in p:
            self.put(f"{key}.bias", p["bias"])

    def feed_forward(self, base, p):
        self.dense(f"{base}.fn.fn.net.0", p["fc1"])
        self.dense(f"{base}.fn.fn.net.3", p["fc2"])

    def trunk(self, rp, rs):
        """``ResNetTrunk`` -> ``resnet.*`` (torchvision names)."""
        self.put("resnet.conv1.weight", _conv(rp["conv1"]["kernel"]))
        self.bn("resnet.bn1", rp["bn1"], rs["bn1"])
        for layer in sorted(k for k in rp if k.startswith("layer")):
            for block in rp[layer]:
                key = f"resnet.{layer}.{block[len('block'):]}"
                p, s = rp[layer][block], rs[layer][block]
                for i in (1, 2):
                    self.put(f"{key}.conv{i}.weight",
                             _conv(p[f"conv{i}"]["kernel"]))
                    self.bn(f"{key}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
                if "down_conv" in p:
                    self.put(f"{key}.downsample.0.weight",
                             _conv(p["down_conv"]["kernel"]))
                    self.bn(f"{key}.downsample.1", p["down_bn"], s["down_bn"])

    def encoder(self, prefix, enc):
        """``TransformerEncoder`` -> ``<prefix>.layers.i.*``."""
        for i in range(_count(enc, "attn_norm_")):
            base = f"{prefix}.layers.{i}"
            self.ln(f"{base}.0.fn.norm", enc[f"attn_norm_{i}"])
            self.dense(f"{base}.0.fn.fn.to_qkv", enc[f"attn_{i}"]["to_qkv"])
            self.dense(f"{base}.0.fn.fn.to_out.0", enc[f"attn_{i}"]["to_out"])
            self.ln(f"{base}.1.fn.norm", enc[f"ff_norm_{i}"])
            self.feed_forward(f"{base}.1", enc[f"ff_{i}"])

    def decoder(self, prefix, dec):
        """``TransformerDecoder`` -> ``<prefix>.layers.i.*``."""
        for i in range(_count(dec, "attn_norm_")):
            base = f"{prefix}.layers.{i}"
            self.ln(f"{base}.0.fn.norm", dec[f"attn_norm_{i}"])
            for t in ("to_q", "to_k", "to_v"):
                self.dense(f"{base}.0.fn.fn.{t}", dec[f"attn_{i}"][t])
            self.dense(f"{base}.0.fn.fn.to_out.0", dec[f"attn_{i}"]["to_out"])
            self.ln(f"{base}.1.fn.norm", dec[f"ff_norm_{i}"])
            self.feed_forward(f"{base}.1", dec[f"ff_{i}"])

    def two_layer_conv(self, key, p, s):
        """``TwoLayerConv`` -> ``<key>.{0,1,3}``."""
        self.conv(f"{key}.0", p["conv1"])
        self.bn(f"{key}.1", p["bn"], s["bn"])
        self.conv(f"{key}.3", p["conv2"])


def flax_to_state_dict(params: Mapping, batch_stats: Mapping,
                       xbd: bool = False) -> StateDict:
    """``DAHiTraUNet`` variables -> the port's fp32 ``state_dict``.

    ``xbd=True`` is the coarsest-only positional quirk of ``xbd_dahitra``
    (the trans_5 embeddings carry the suffix-3 keys)."""
    w = _Writer()
    w.trunk(params["resnet"], batch_stats["resnet"])
    for ours, ref in _SCALES:
        tp = params[ours]
        w.put(f"conv_squeeze_{ref}.0.weight",
              _conv(tp["conv_squeeze"]["kernel"]))
        w.put(f"conv_token_{ref}.weight",
              _conv(tp["tokenizer"]["conv_token"]["kernel"]))
        w.put(f"conv_decode_{ref}.weight", _conv(tp["conv_decode"]["kernel"]))
        pos_ref = ("3" if ref == "5" else None) if xbd else ref
        if "pos_embedding" in tp:
            w.put(f"pos_embedding_{pos_ref}", tp["pos_embedding"])
        if "pos_embedding_decoder" in tp:
            w.put(f"pos_embedding_decoder_{pos_ref}",
                  np.transpose(np.asarray(tp["pos_embedding_decoder"]),
                               (0, 3, 1, 2)))
        w.encoder(f"transformer_{ref}", tp["transformer"])
        w.decoder(f"transformer_decoder_{ref}", tp["decoder"])

    head = params["conv_layer2_0"]
    w.put("conv_layer2_0.0.weight", _conv(head["conv1"]["kernel"]))
    w.bn("conv_layer2_0.1", head["bn"], batch_stats["conv_layer2_0"]["bn"])
    w.put("conv_layer2_0.3.weight", _conv(head["conv2"]["kernel"]))
    w.put("conv_layer2_0.3.bias", head["conv2"]["bias"])
    for n in ("conv_layer2", "conv_layer3", "conv_layer4"):
        w.put(f"{n}.0.weight", _conv(params[n]["kernel"]))
        w.put(f"{n}.0.bias", params[n]["bias"])
    w.put("classifier.weight", _conv(params["classifier"]["kernel"]))
    w.put("classifier.bias", params["classifier"]["bias"])
    return w.sd


def resnet_cd_flax_to_state_dict(params: Mapping,
                                 batch_stats: Mapping) -> StateDict:
    """``ResNetCD`` variables -> the port's fp32 ``state_dict`` (the inverse
    of ``convert_resnet_cd``)."""
    w = _Writer()
    w.trunk(params["resnet"], batch_stats["resnet"])
    w.conv("conv_pred", params["conv_pred"])
    w.two_layer_conv("classifier", params["classifier"],
                     batch_stats["classifier"])
    return w.sd


def bit_flax_to_state_dict(params: Mapping, batch_stats: Mapping) -> StateDict:
    """``BIT`` variables -> the port's fp32 ``state_dict`` (the inverse of
    ``convert_bit``): the tokenizer's kernel is ``conv_a.weight``, the
    decoder positional embedding NHWC -> NCHW."""
    w = _Writer()
    w.trunk(params["resnet"], batch_stats["resnet"])
    w.conv("conv_pred", params["conv_pred"])
    w.put("conv_a.weight", _conv(params["tokenizer"]["conv_token"]["kernel"]))
    if "pos_embedding" in params:
        w.put("pos_embedding", params["pos_embedding"])
    if "pos_embedding_decoder" in params:
        w.put("pos_embedding_decoder",
              np.transpose(np.asarray(params["pos_embedding_decoder"]),
                           (0, 3, 1, 2)))
    w.encoder("transformer", params["transformer"])
    w.decoder("transformer_decoder", params["transformer_decoder"])
    w.two_layer_conv("classifier", params["classifier"],
                     batch_stats["classifier"])
    return w.sd


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model weights of a reference ``.pt`` (its ``model_G_state_dict``,
    ``module.`` stripped), ready for ``core.checkpoint.load_weights``."""
    return model_state_dict(torch.load(path, map_location="cpu",
                                       weights_only=False))
