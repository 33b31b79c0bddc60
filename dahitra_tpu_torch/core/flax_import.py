"""Weights from the JAX package's parameter trees, and reference checkpoints.

``flax_to_state_dict`` is the inverse of dahitra_tpu/core/torch_import.py
``convert_dahitra``: it takes the numpy ``params`` and ``batch_stats`` trees
of ``dahitra_tpu``'s ``DAHiTraUNet`` and returns the port's ``state_dict``,
whose keys are the reference ``BASE_Transformer_UNet`` keys. Conventions:

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


def flax_to_state_dict(params: Mapping, batch_stats: Mapping,
                       xbd: bool = False) -> StateDict:
    """``DAHiTraUNet`` variables -> the port's fp32 ``state_dict``.

    ``xbd=True`` is the coarsest-only positional quirk of ``xbd_dahitra``
    (the trans_5 embeddings carry the suffix-3 keys)."""
    sd: StateDict = {}

    def put(key, value):
        sd[key] = torch.tensor(np.asarray(value, np.float32))

    def bn(key, p, s):
        put(f"{key}.weight", p["scale"])
        put(f"{key}.bias", p["bias"])
        put(f"{key}.running_mean", s["mean"])
        put(f"{key}.running_var", s["var"])

    def ln(key, p):
        put(f"{key}.weight", p["scale"])
        put(f"{key}.bias", p["bias"])

    def dense(key, p):
        put(f"{key}.weight", _linear(p["kernel"]))
        if "bias" in p:
            put(f"{key}.bias", p["bias"])

    def feed_forward(base, p):
        dense(f"{base}.fn.fn.net.0", p["fc1"])
        dense(f"{base}.fn.fn.net.3", p["fc2"])

    rp, rs = params["resnet"], batch_stats["resnet"]
    put("resnet.conv1.weight", _conv(rp["conv1"]["kernel"]))
    bn("resnet.bn1", rp["bn1"], rs["bn1"])
    for layer in sorted(k for k in rp if k.startswith("layer")):
        for block in rp[layer]:
            key = f"resnet.{layer}.{block[len('block'):]}"
            p, s = rp[layer][block], rs[layer][block]
            for i in (1, 2):
                put(f"{key}.conv{i}.weight", _conv(p[f"conv{i}"]["kernel"]))
                bn(f"{key}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
            if "down_conv" in p:
                put(f"{key}.downsample.0.weight", _conv(p["down_conv"]["kernel"]))
                bn(f"{key}.downsample.1", p["down_bn"], s["down_bn"])

    for ours, ref in _SCALES:
        tp = params[ours]
        put(f"conv_squeeze_{ref}.0.weight", _conv(tp["conv_squeeze"]["kernel"]))
        put(f"conv_token_{ref}.weight",
            _conv(tp["tokenizer"]["conv_token"]["kernel"]))
        put(f"conv_decode_{ref}.weight", _conv(tp["conv_decode"]["kernel"]))
        pos_ref = ("3" if ref == "5" else None) if xbd else ref
        if "pos_embedding" in tp:
            put(f"pos_embedding_{pos_ref}", tp["pos_embedding"])
        if "pos_embedding_decoder" in tp:
            put(f"pos_embedding_decoder_{pos_ref}",
                np.transpose(np.asarray(tp["pos_embedding_decoder"]),
                             (0, 3, 1, 2)))
        enc = tp["transformer"]
        for i in range(_count(enc, "attn_norm_")):
            base = f"transformer_{ref}.layers.{i}"
            ln(f"{base}.0.fn.norm", enc[f"attn_norm_{i}"])
            dense(f"{base}.0.fn.fn.to_qkv", enc[f"attn_{i}"]["to_qkv"])
            dense(f"{base}.0.fn.fn.to_out.0", enc[f"attn_{i}"]["to_out"])
            ln(f"{base}.1.fn.norm", enc[f"ff_norm_{i}"])
            feed_forward(f"{base}.1", enc[f"ff_{i}"])
        dec = tp["decoder"]
        for i in range(_count(dec, "attn_norm_")):
            base = f"transformer_decoder_{ref}.layers.{i}"
            ln(f"{base}.0.fn.norm", dec[f"attn_norm_{i}"])
            for t in ("to_q", "to_k", "to_v"):
                dense(f"{base}.0.fn.fn.{t}", dec[f"attn_{i}"][t])
            dense(f"{base}.0.fn.fn.to_out.0", dec[f"attn_{i}"]["to_out"])
            ln(f"{base}.1.fn.norm", dec[f"ff_norm_{i}"])
            feed_forward(f"{base}.1", dec[f"ff_{i}"])

    head = params["conv_layer2_0"]
    put("conv_layer2_0.0.weight", _conv(head["conv1"]["kernel"]))
    bn("conv_layer2_0.1", head["bn"], batch_stats["conv_layer2_0"]["bn"])
    put("conv_layer2_0.3.weight", _conv(head["conv2"]["kernel"]))
    put("conv_layer2_0.3.bias", head["conv2"]["bias"])
    for n in ("conv_layer2", "conv_layer3", "conv_layer4"):
        put(f"{n}.0.weight", _conv(params[n]["kernel"]))
        put(f"{n}.0.bias", params[n]["bias"])
    put("classifier.weight", _conv(params["classifier"]["kernel"]))
    put("classifier.bias", params["classifier"]["bias"])
    return sd


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model weights of a reference ``.pt`` (its ``model_G_state_dict``,
    ``module.`` stripped), ready for ``core.checkpoint.load_weights``."""
    return model_state_dict(torch.load(path, map_location="cpu",
                                       weights_only=False))
