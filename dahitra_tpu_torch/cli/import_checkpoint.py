"""Reference checkpoint import: ``python -m dahitra_tpu_torch.cli.import_checkpoint``.

Counterpart of dahitra_tpu/cli/import_checkpoint.py. The port's models carry
the reference's ``state_dict`` names, so a reference ``.pt``
(``{model_G_state_dict: ...}`` from models/trainer.py:150-158, or the xBD
``{state_dict: ...}`` from xBD_code/train.py:298-303, possibly with
DataParallel's ``module.`` prefix) loads by name: this CLI reads it through
``core/flax_import.py`` ``load_reference_checkpoint``, builds ``--net_G``,
drops the keys of the modules the reference builds and never calls (the
ones dahitra_tpu/core/torch_import.py ignores for that key, ``_DEAD``) and
BatchNorm's ``num_batches_tracked``, refuses every other missing, unexpected
or misshaped key by name, and writes the port's ``best_ckpt.pt`` under
``--out``, which ``eval_cd``, ``demo`` and ``xbd_train --warm_start_from``
read.

    python -m dahitra_tpu_torch.cli.import_checkpoint ref_best_ckpt.pt \\
        --net_G newUNetTrans --out checkpoints/imported

``--trunk_only`` reads a torchvision ResNet ``state_dict`` (``.pth``) and
writes a trunk-only warm start under the names of the xBD zoo's wrapped
trunk (``conv1.0``, ``conv1.1``, ``conv2.1.*``, ``conv3``-``conv5``; JAX's
``params/core/resnet``), which ``xbd_train --warm_start_from`` copies into
the ResNet34 UNets (the reference's ``pretrained=True`` encoder,
zoo/models.py:586-597). The Dpn92 UNets raise as in the JAX package
(torch_import.py:747-752): no reference checkpoint of them can exist.
``dual_hrnet_fpn`` refuses a checkpoint without the FPN's weights, as the
JAX importer does (torch_import.py:733-738): import it as ``dual_hrnet``.
"""
from __future__ import annotations

import os
import re
from argparse import ArgumentParser

import torch

from dahitra_tpu_torch.core.checkpoint import save_checkpoint
from dahitra_tpu_torch.core.flax_import import load_reference_checkpoint
from dahitra_tpu_torch.models.registry import define_g

# Keys of the reference's modules that its forward never calls, by --net_G:
# the torchvision layers past the ones used, DAHiTra's 4th (finest)
# transformer (networks.py:1233-1236) and the xBD copy's unused positional
# embeddings, the UNet change transformers' unused attention, decoder and
# classifier modules (torch_import.py:371-376), ChangeFormer V1's
# intra-patch blocks (:480), the xBD UNet change transformer's transformer.
_TRUNK_TAIL = r"^resnet\.(layer4|fc)\."
_DAHITRA_FINEST = (r"^(conv_squeeze|conv_token|transformer|transformer_decoder"
                   r"|conv_decode)_2\.|^pos_embedding(_decoder)?_2$")
_UNET_DEAD = (r"^(ca_skip_[431]|ca_bottle_avg\w*|ca_bottle_min\w*|linearb"
              r"|transformer_decoder|classifier|conv0)\.")
_DEAD = {
    "newUNetTrans": (_TRUNK_TAIL, _DAHITRA_FINEST),
    "xbd_dahitra": (_TRUNK_TAIL, _DAHITRA_FINEST,
                    r"^pos_embedding(_decoder)?_[45]$"),
    "xbd_adapt_dahitra": (_TRUNK_TAIL, _DAHITRA_FINEST,
                          r"^pos_embedding(_decoder)?_[45]$"),
    "base_resnet18": (_TRUNK_TAIL,),
    "unet_coupled_trans_256": (_UNET_DEAD,),
    "unet_coupled_two_trans_256": (_UNET_DEAD, r"^ca_bottle_max\."),
    "changeFormer": (r"^Tenc\.(.*\.)?(patch_block|pnorm)",),
    # the xBD UNet change transformer's bottleneck transformer: its forward
    # comments the call out (torch_import.py:553-556)
    "xbd_unet_change_transformer": (r"^transformer\.",),
}
for _key in ("xbd_bit", "base_transformer_pos_s4", "base_transformer_pos_s4_dd8",
             "base_transformer_pos_s4_dd8_o5",
             "base_transformer_pos_s4_dd8_dedim8",
             "base_transformer_pos_s4_dd8_t8_e2d4"):
    _DEAD[_key] = (_TRUNK_TAIL,)

# torchvision resnet names -> the zoo's wrapped trunk (zoo/models.py:586-597).
_ZOO_TRUNK = (("conv1.", "conv1.0."), ("bn1.", "conv1.1."),
              ("layer1.", "conv2.1."), ("layer2.", "conv3."),
              ("layer3.", "conv4."), ("layer4.", "conv5."))


def is_dead(net_g: str, key: str) -> bool:
    """Whether the reference key ``key`` belongs to a module that ``net_g``'s
    forward never calls (or is BatchNorm's step counter)."""
    return key.endswith("num_batches_tracked") or any(
        re.search(p, key) for p in _DEAD.get(net_g, ()))


def convert_reference(sd: dict, net_g: str, img_size: int = 256) -> dict:
    """The reference ``state_dict`` ``sd`` as the port's ``--net_G``
    weights: dead keys dropped; raises ``KeyError`` naming every missing or
    unexpected key, ``ValueError`` naming every misshaped one."""
    if net_g.startswith("xbd_dpn92"):
        raise NotImplementedError(
            "the reference's Dpn92 UNets are unconstructable as shipped: "
            "zoo/models.py:256 uses an undefined 'dpn92' symbol (NameError "
            "at construction), so no reference checkpoint of them can "
            "exist to import")
    if net_g == "dual_hrnet_fpn" and not any(k.startswith("fpn_loc.")
                                             for k in sd):
        raise ValueError(
            "checkpoint has no fpn_loc/fpn_cls weights (and its head is the "
            "480-ch concat, not the 32-ch FPN head): import it as --net_G "
            "dual_hrnet instead")
    with torch.device("meta"):
        own = define_g(net_g, img_size=img_size).state_dict()
    unexpected = sorted(k for k in sd if k not in own and not is_dead(net_g, k))
    missing = sorted(k for k in own if k not in sd)
    if unexpected or missing:
        raise KeyError(f"{net_g}: checkpoint keys the model does not have: "
                       f"{unexpected}; model keys the checkpoint lacks: "
                       f"{missing}")
    shapes = sorted(f"{k} {tuple(sd[k].shape)} != {tuple(v.shape)}"
                    for k, v in own.items() if sd[k].shape != v.shape)
    if shapes:
        raise ValueError(f"{net_g}: misshaped keys: {shapes}")
    return {k: sd[k].float() for k in own}


def trunk_state_dict(sd: dict) -> dict:
    """A torchvision ResNet ``state_dict`` under the zoo's wrapped-trunk
    names (``fc`` and ``num_batches_tracked`` dropped)."""
    if "conv1.weight" not in sd or "layer1.0.conv1.weight" not in sd:
        raise ValueError(
            "not a torchvision resnet state_dict (expected conv1.weight / "
            "layer1.*.conv1.weight keys); for whole-model reference "
            "checkpoints use --net_G instead of --trunk_only")
    out = {}
    for k, v in sd.items():
        for src, dst in _ZOO_TRUNK:
            if k.startswith(src) and not k.endswith("num_batches_tracked"):
                out[dst + k[len(src):]] = v.float()
    return out


def main(argv=None) -> str:
    """Writes the checkpoint; returns its path."""
    parser = ArgumentParser()
    parser.add_argument("pt_path", help="reference .pt checkpoint file, or "
                        "a raw torchvision resnet .pth with --trunk_only")
    parser.add_argument("--net_G", default=None,
                        help="registry key the weights belong to")
    parser.add_argument("--trunk_only", action="store_true",
                        help="read pt_path as a raw torchvision resnet "
                        "state_dict and write a trunk-only warm start for "
                        "the xBD ResNet34 UNets")
    parser.add_argument("--img_size", default=256, type=int,
                        help="the image size the weights were trained at "
                        "(DAHiTra's decoder positional embeddings and the "
                        "UNet change transformers' token width)")
    parser.add_argument("--out", required=True,
                        help="output checkpoint directory (--checkpoint_dir "
                        "of eval_cd and demo, or --warm_start_from)")
    parser.add_argument("--name", default="best_ckpt",
                        help="checkpoint name inside --out")
    args = parser.parse_args(argv)
    sd = load_reference_checkpoint(args.pt_path)
    if args.trunk_only:
        weights, what = trunk_state_dict(sd), "imagenet trunk"
    elif args.net_G:
        weights = convert_reference(sd, args.net_G, args.img_size)
        what = args.net_G
    else:
        parser.error("one of --net_G or --trunk_only is required")
    path = save_checkpoint(args.out, weights, name=args.name)
    n = sum(v.numel() for v in weights.values())
    print(f"imported {what}: {n:,} values -> {path}")
    return path


if __name__ == "__main__":
    main()
