"""Weights from the JAX package's parameter trees, and reference checkpoints.

``flax_to_state_dict`` is the inverse of dahitra_tpu/core/torch_import.py
``convert_dahitra``: it takes the numpy ``params`` and ``batch_stats`` trees
of ``dahitra_tpu``'s ``DAHiTraUNet`` and returns the port's ``state_dict``,
whose keys are the reference ``BASE_Transformer_UNet`` keys.
``bit_flax_to_state_dict`` and ``resnet_cd_flax_to_state_dict`` are the
inverses of ``convert_bit`` and ``convert_resnet_cd``, for ``BIT`` and
``ResNetCD`` (the reference's ``BASE_Transformer`` and ``ResNet`` keys);
``res34_unet_flax_to_state_dict`` of ``convert_res34_unet`` and
``convert_res34_double_modified``, for every ResNet34 UNet (the xBD zoo's
wrapped-trunk keys); ``discriminator_flax_to_state_dict`` carries the GAN
trainer's ``Discriminator`` (its own flax names);
``unet_change_transformer_flax_to_state_dict``,
``siam_unet_conc_flax_to_state_dict`` and ``changeformer_flax_to_state_dict``
are the inverses of ``convert_unet_change_transformer``,
``convert_siam_unet_conc`` and ``convert_changeformer``;
``se_unet_flax_to_state_dict``, ``xbd_unet_change_transformer_flax_to_state_dict``
and ``dual_hrnet_flax_to_state_dict`` of ``convert_se_unet``,
``convert_xbd_unet_change_transformer`` and ``convert_dual_hrnet``;
``dpn_unet_flax_to_state_dict`` carries the DPN92 UNets, which have no
reference checkpoint and keep their flax names.
Conventions:

  * conv kernels HWIO -> OIHW, Dense kernels (in, out) -> Linear (out, in);
  * BN scale/bias/mean/var -> weight/bias/running_mean/running_var;
  * the decoder positional embedding NHWC -> NCHW;
  * a flax ``ConvTranspose`` kernel (``transpose_kernel=True``) goes back
    with the conv rule to the (in, out, kh, kw) of ``nn.ConvTranspose2d``;
    the SAME convs that stand for stride-1 transposed convs
    (``_ct_as_conv``) go back with their taps flipped.

The trees are read as nested mappings of array-likes; nothing here imports
JAX.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import re

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
        self.sd[key] = torch.tensor(np.ascontiguousarray(value, np.float32))

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

    def trunk(self, rp, rs, names=None):
        """``ResNetTrunk`` -> ``resnet.*`` (torchvision names), or to the
        names ``names`` makes of the stem's conv and BN and each layer."""
        names = names or {"conv1": "resnet.conv1", "bn1": "resnet.bn1",
                          **{f"layer{i}": f"resnet.layer{i}"
                             for i in range(1, 5)}}
        self.put(f"{names['conv1']}.weight", _conv(rp["conv1"]["kernel"]))
        self.bn(names["bn1"], rp["bn1"], rs["bn1"])
        for layer in sorted(k for k in rp if k.startswith("layer")):
            for block in rp[layer]:
                key = f"{names[layer]}.{block[len('block'):]}"
                p, s = rp[layer][block], rs[layer][block]
                for i in (1, 2, 3)[:3 if "conv3" in p else 2]:
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


# The zoo's wrapped resnet34 (zoo/models.py:586-597): conv1 = (conv, bn,
# relu), conv2 = (maxpool, layer1), conv3..conv5 = layer2..layer4.
_ZOO_TRUNK = {"conv1": "conv1.0", "bn1": "conv1.1", "layer1": "conv2.1",
              "layer2": "conv3", "layer3": "conv4", "layer4": "conv5"}


def res34_unet_flax_to_state_dict(params: Mapping,
                                  batch_stats: Mapping) -> StateDict:
    """Any ResNet34 UNet's variables (``Res34UnetLoc``, ``_Double``,
    ``_Single``, ``_DoubleModified``) -> the port's fp32 ``state_dict``:
    the inverse of ``convert_res34_unet`` (and, with the ``conv1d_N``
    fusion convs, of ``convert_res34_double_modified``)."""
    w = _Writer()
    core = params["core"]
    w.trunk(core["resnet"], batch_stats["core"]["resnet"], _ZOO_TRUNK)
    for name in sorted(k for k in core if k != "resnet"):
        w.conv(f"{name}.layer.0", core[name]["conv"])
    for name in sorted(k for k in params if k.startswith("conv1d_")):
        w.conv(name, params[name])
    w.conv("res", params["res"])
    return w.sd


def discriminator_flax_to_state_dict(params: Mapping,
                                     batch_stats: Mapping) -> StateDict:
    """``Discriminator`` variables -> the port's fp32 ``state_dict``."""
    w = _Writer()
    w.conv("pre_process", params["pre_process"])
    w.trunk(params["backbone"], batch_stats["backbone"],
            {"conv1": "backbone.conv1", "bn1": "backbone.bn1",
             **{f"layer{i}": f"backbone.layer{i}" for i in range(1, 5)}})
    w.dense("fc", params["fc"])
    return w.sd


def unet_change_transformer_flax_to_state_dict(
        params: Mapping, batch_stats: Mapping, two: bool = False) -> StateDict:
    """``UNetChangeTransformer`` (or, with ``two``,
    ``UNetChangeTwoTransformer``) variables -> the port's fp32
    ``state_dict``."""
    w = _Writer()
    w.trunk(params["encoder"]["resnet"], batch_stats["encoder"]["resnet"],
            _ZOO_TRUNK)
    fuses = ("ca_skip_5", "ca_skip_2") if two else ("ca_skip_5",)
    for name in fuses:
        w.conv(f"{name}.conv1", params[name]["conv1"])
    if not two:
        for fc in ("fc1", "fc2"):
            w.conv(f"ca_bottle_max.{fc}", params["ca_bottle_max"][fc])
    for name in ("transformer", "transformer2") if two else ("transformer",):
        w.encoder(name, params[name]["transformer"])
    for name in sorted(k for k in params if k.startswith("conv")):
        w.conv(f"{name}.layer.0", params[name]["conv"])
    w.conv("res", params["res"])
    return w.sd


def siam_unet_conc_flax_to_state_dict(params: Mapping,
                                      batch_stats: Mapping) -> StateDict:
    """``SiamUnetConc`` variables -> the port's fp32 ``state_dict``: the
    encoder's ``encNM`` to ``convNM``/``bnNM``, the up-convs as they are,
    the decoder's SAME convs ``decNM`` back to the stride-1 transposed
    convs ``convNMd`` (taps flipped, in and out swapped) with ``bnNMd``."""
    w = _Writer()
    for name, p in params.items():
        if name.startswith("enc"):
            w.conv(f"conv{name[3:]}", p["conv"])
            w.bn(f"bn{name[3:]}", p["bn"], batch_stats[name]["bn"])
        elif name.startswith("upconv"):
            w.conv(name, p["upconv"])
        elif name.startswith("dec"):
            conv = p if name == "dec11" else p["conv"]
            w.put(f"conv{name[3:]}d.weight", np.transpose(
                np.asarray(conv["kernel"]), (2, 3, 0, 1))[:, :, ::-1, ::-1])
            w.put(f"conv{name[3:]}d.bias", conv["bias"])
            if name != "dec11":
                w.bn(f"bn{name[3:]}d", p["bn"], batch_stats[name]["bn"])
    return w.sd


def changeformer_flax_to_state_dict(params: Mapping, batch_stats: Mapping,
                                    v6: bool = True) -> StateDict:
    """``ChangeFormerV6`` (or, with ``v6=False``, ``ChangeFormerV1``)
    variables -> the port's fp32 ``state_dict`` (``Tenc_x2``/``TDec_x2``,
    or ``Tenc``/``convproj``/``change_probability``)."""
    w = _Writer()
    enc = params["Tenc"]
    ep = "Tenc_x2" if v6 else "Tenc"
    for name, p in enc.items():
        if name.startswith("patch_embed"):
            w.conv(f"{ep}.{name}.proj", p["proj"])
            w.ln(f"{ep}.{name}.norm", p["norm"])
        elif name.startswith("norm"):
            w.ln(f"{ep}.{name}", p)
        else:  # blockS_I
            stage, i = name[len("block"):].split("_")
            base = f"{ep}.block{stage}.{i}"
            for ln in ("norm1", "norm2"):
                w.ln(f"{base}.{ln}", p[ln])
            for lin in ("q", "kv", "proj"):
                w.dense(f"{base}.attn.{lin}", p["attn"][lin])
            if "sr" in p["attn"]:
                w.conv(f"{base}.attn.sr", p["attn"]["sr"])
                w.ln(f"{base}.attn.norm", p["attn"]["sr_norm"])
            w.dense(f"{base}.mlp.fc1", p["mlp"]["fc1"])
            w.conv(f"{base}.mlp.dwconv.dwconv", p["mlp"]["dwconv"])
            w.dense(f"{base}.mlp.fc2", p["mlp"]["fc2"])

    def residual(key, p):
        w.conv(f"{key}.0.conv1.conv2d", p["conv1"])
        w.conv(f"{key}.0.conv2.conv2d", p["conv2"])

    if not v6:
        for name, p in params["convproj"].items():
            if name.startswith("dense"):
                residual(f"convproj.{name}", p)
            else:
                w.conv(f"convproj.{name}.conv2d", p["conv"])
        w.conv("change_probability.conv2d", params["change_probability"])
        return w.sd
    dec, stats = params["TDec"], batch_stats["TDec"]
    for tag in "4321":
        w.dense(f"TDec_x2.linear_c{tag}.proj", dec[f"linear_c{tag}"])
        for mod in (f"diff_c{tag}", f"make_pred_c{tag}"):
            w.conv(f"TDec_x2.{mod}.0", dec[mod]["conv1"])
            w.bn(f"TDec_x2.{mod}.2", dec[mod]["bn"], stats[mod]["bn"])
            w.conv(f"TDec_x2.{mod}.3", dec[mod]["conv2"])
    w.conv("TDec_x2.linear_fuse.0", dec["linear_fuse"])
    w.bn("TDec_x2.linear_fuse.1", dec["linear_fuse_bn"],
         stats["linear_fuse_bn"])
    for name in ("convd2x", "convd1x"):
        w.conv(f"TDec_x2.{name}.conv2d", dec[name]["conv"])
    for name in ("dense_2x", "dense_1x"):
        residual(f"TDec_x2.{name}", dec[name])
    w.conv("TDec_x2.change_probability.conv2d", dec["change_probability"])
    return w.sd


def _leaf_modules(params: Mapping, stats: Mapping, prefix: Tuple = ()
                  ) -> Iterator[Tuple[Tuple[str, ...], Mapping, Mapping]]:
    """(path, params, batch_stats) of every module of a flax tree that
    holds arrays (a conv, a norm); ``batch_stats`` is None where it has
    none."""
    for name, p in params.items():
        path, s = prefix + (name,), (stats or {}).get(name)
        if any(not isinstance(v, Mapping) for v in p.values()):
            yield path, p, s
        else:
            yield from _leaf_modules(p, s or {}, path)


def _write_renamed(params: Mapping, stats: Mapping, key_of) -> StateDict:
    """Every leaf module of the tree under the name ``key_of(path)`` gives
    it: a conv (kernel), a BatchNorm (scale with statistics) or a
    GroupNorm (scale without)."""
    w = _Writer()
    for path, p, s in _leaf_modules(params, stats):
        key = key_of(path)
        if "kernel" in p:
            w.conv(key, p)
        elif s is not None:
            w.bn(key, p, s)
        else:
            w.ln(key, p)
    return w.sd


# A ResNet-style block's projection -> the reference's names.
_DOWN = {"down_conv": "downsample.0", "down_bn": "downsample.1",
         "se": "se_module"}
# The SE UNets' layer N -> the zoo's wrapped module (zoo/models.py:72-148).
_SE_LAYERS = {"1": "conv2.1", "2": "conv3", "3": "conv4", "4": "conv5"}


def _se_key(path) -> str:
    if path[0] == "res":
        return "res"
    mod, rest = path[1], path[2:]
    stem = re.fullmatch(r"stem_(conv|bn)(\d)", mod)
    if stem:  # conv1 = Sequential(conv, bn, relu[, conv, bn, relu, ...])
        return f"conv1.{3 * (int(stem[2]) - 1) + (stem[1] == 'bn')}"
    block = re.fullmatch(r"layer(\d)_block(\d+)", mod)
    if block:
        return ".".join((_SE_LAYERS[block[1]], block[2],
                         *(_DOWN.get(n, n) for n in rest)))
    return f"{mod}.layer.0"  # the decoder's ConvRelu


def se_unet_flax_to_state_dict(params: Mapping,
                               batch_stats: Mapping) -> StateDict:
    """Any SE-ResNeXt50 or SENet154 UNet's variables (``Loc`` or
    ``Double``) -> the port's fp32 ``state_dict``: the inverse of
    ``convert_se_unet``."""
    return _write_renamed(params, batch_stats, _se_key)


def _dpn_key(path) -> str:
    """The flax names, ``ConvRelu``'s ``conv`` as ``layer.0``."""
    return re.sub(r"(conv\d+(_2)?)\.conv$", r"\1.layer.0", ".".join(path))


def dpn_unet_flax_to_state_dict(params: Mapping,
                                batch_stats: Mapping) -> StateDict:
    """``Dpn92UnetLoc`` or ``Dpn92UnetDouble`` variables -> the port's
    fp32 ``state_dict`` (``_dpn_key``)."""
    return _write_renamed(params, batch_stats, _dpn_key)


def xbd_unet_change_transformer_flax_to_state_dict(
        params: Mapping, batch_stats: Mapping) -> StateDict:
    """``XBDUNetChangeTransformer`` variables (either variant) -> the
    port's fp32 ``state_dict``: the inverse of
    ``convert_xbd_unet_change_transformer``."""
    w = _Writer()
    w.trunk(params["resnet"], batch_stats["resnet"], _ZOO_TRUNK)
    for name, p in params.items():
        if name.startswith("ca_"):
            for conv, q in p.items():
                w.conv(f"{name}.{conv}", q)
        elif name == "transformer":
            w.encoder(name, p["transformer"])
        elif name.startswith("conv"):
            w.conv(f"{name}.layer.0", p["conv"])
    w.conv("res", params["res"])
    return w.sd


def _hrnet_key(path) -> str:
    head, mod, rest = path[0], path[1], path[2:]

    def seq(*idx):
        return ".".join(str(i) for i in idx if i != "")

    m = re.fullmatch(r"fuse(\d+)_(conv|bn)", mod)
    if head.startswith("fuse_"):  # _FuseList: Sequential(conv, bn, relu)
        return f"{head}.{seq(m[1], int(m[2] == 'bn'))}"
    m = re.fullmatch(r"fpn(\d+)_(conv|gn)(\d*)", mod)
    if m:  # branch 0 flat, branch i > 0 a Sequential per chain step
        return f"{head}.{seq(m[1], m[3], int(m[2] == 'gn'))}"
    if mod in ("conv1", "bn1", "conv2", "bn2"):
        return f"{head}.{mod}"
    if mod.startswith("last_"):
        return f"{head}.last_layer." + {"last_conv1": "0", "last_bn": "1",
                                        "last_conv2": "3"}[mod]
    if mod.startswith("layer1_block"):
        return ".".join((head, "layer1", mod[len("layer1_block"):],
                         *(_DOWN.get(n, n) for n in rest)))
    m = re.fullmatch(r"transition(\d)", mod)
    if m:
        t = re.fullmatch(r"trans(\d+)_(conv|bn)(\d*)", rest[0])
        return (f"{head}.transitions.{int(m[1]) - 1}."
                f"{seq(t[1], t[3], int(t[2] == 'bn'))}")
    s, mi = re.fullmatch(r"stage(\d)_m(\d+)", mod).groups()
    base = f"{head}.stage{s}.{mi}"
    b = re.fullmatch(r"branch(\d+)_block(\d+)", rest[0])
    if b:
        return f"{base}.branches.{b[1]}.{b[2]}.{rest[1]}"
    f = re.fullmatch(r"fuse(\d+)_(\d+)_(conv|bn)(\d*)", rest[0])
    return f"{base}.fuse_layers.{seq(f[1], f[2], f[4], int(f[3] == 'bn'))}"


def dual_hrnet_flax_to_state_dict(params: Mapping,
                                  batch_stats: Mapping) -> StateDict:
    """``DualHRNet`` variables (with or without the FPN) -> the port's fp32
    ``state_dict``: the inverse of ``convert_dual_hrnet``."""
    return _write_renamed(params, batch_stats, _hrnet_key)


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model weights of a reference ``.pt`` (its ``model_G_state_dict``,
    ``module.`` stripped), ready for ``core.checkpoint.load_weights``."""
    return model_state_dict(torch.load(path, map_location="cpu",
                                       weights_only=False))
