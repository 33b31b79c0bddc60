"""Model registry: ``define_g`` keyed by the reference's ``--net_G`` flags.

Counterpart of dahitra_tpu/models/registry.py. Ported: ``newUNetTrans``, the
BIT keys ``base_transformer_pos_s4*`` and ``base_resnet18``, with the JAX
registry's arguments (registry.py:33-65), and the xBD damage models
``xbd_dahitra`` (DAHiTra, 5 classes, the 6-channel pre|post input,
positional embeddings at the coarsest scale only, so no per-date decode)
and ``xbd_bit`` (BIT, 5 classes; registry.py:106-112,220-224), the
adaptation model ``xbd_adapt_dahitra`` (the same DAHiTra at 4 classes), and
the ResNet34 UNets of the xBD zoo (registry.py:98-152): ``xbd_res34_loc``,
``xbd_res34_double``, ``xbd_res34_single``, ``xbd_res34_double_modified``,
``xbd_adapt_res34`` (the double model at 4 classes) and the LEVIR key
``siamUnet`` (the double model at 5), and the rest of the LEVIR zoo
(registry.py:73-96): ``unet_coupled_trans_256``,
``unet_coupled_two_trans_256`` (``img_size`` sets their token width),
``changeFormer``, ``changeFormerV6`` (a list of five logits) and
``siamUnet_conc``; every other key of the JAX registry raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch

from dahitra_tpu_torch.models.bit import BIT
from dahitra_tpu_torch.models.changeformer import (ChangeFormerV1,
                                                   ChangeFormerV6)
from dahitra_tpu_torch.models.dahitra import DAHiTraUNet
from dahitra_tpu_torch.models.res34_unet import (Res34UnetDouble,
                                                 Res34UnetDoubleModified,
                                                 Res34UnetLoc, Res34UnetSingle)
from dahitra_tpu_torch.models.resnet_cd import ResNetCD
from dahitra_tpu_torch.models.siam_unet_conc import SiamUnetConc
from dahitra_tpu_torch.models.unet_change_transformer import (
    UNetChangeTransformer, UNetChangeTwoTransformer)

# BIT keys -> their arguments beside resnet_stages_num = 4.
_BIT = {
    "base_transformer_pos_s4": dict(output_nc=2, token_len=4),
    "base_transformer_pos_s4_dd8": dict(output_nc=2, token_len=4,
                                        enc_depth=1, dec_depth=8),
    "base_transformer_pos_s4_dd8_o5": dict(output_nc=5, token_len=4,
                                           enc_depth=1, dec_depth=8),
    "base_transformer_pos_s4_dd8_dedim8": dict(output_nc=2, token_len=4,
                                               enc_depth=1, dec_depth=8,
                                               decoder_dim_head=8),
    "base_transformer_pos_s4_dd8_t8_e2d4": dict(output_nc=2, token_len=8,
                                                enc_depth=2, dec_depth=4,
                                                decoder_dim_head=8),
}

# The ResNet34 UNets -> (class, output_nc).
_RES34 = {"xbd_res34_loc": (Res34UnetLoc, None),
          "xbd_res34_double": (Res34UnetDouble, 5),
          "xbd_res34_single": (Res34UnetSingle, 5),
          "xbd_res34_double_modified": (Res34UnetDoubleModified, 5),
          "xbd_adapt_res34": (Res34UnetDouble, 4),
          "siamUnet": (Res34UnetDouble, 5)}
# DAHiTra on the xBD tiles -> classes.
_XBD_DAHITRA = {"xbd_dahitra": 5, "xbd_adapt_dahitra": 4}

# The rest of the LEVIR zoo -> its constructor (dtype, img_size).
_ZOO = {
    "unet_coupled_trans_256": lambda dt, img: UNetChangeTransformer(
        2, img, dt),
    "unet_coupled_two_trans_256": lambda dt, img: UNetChangeTwoTransformer(
        2, img, dt),
    "changeFormer": lambda dt, img: ChangeFormerV1(2, dtype=dt),
    "changeFormerV6": lambda dt, img: ChangeFormerV6(2, dtype=dt),
    "siamUnet_conc": lambda dt, img: SiamUnetConc(3, 2, dt),
}

# Keys of the JAX registry not ported yet -> ROADMAP.md section 1 item.
_PENDING = {k: "Rest of the zoo" for k in (
    "xbd_seresnext50_loc", "xbd_seresnext50_double", "xbd_senet154_loc",
    "xbd_senet154_double", "xbd_dpn92_loc", "xbd_dpn92_double",
    "xbd_unet_change_transformer", "xbd_unet_change_transformer_bit",
    "dual_hrnet", "dual_hrnet_fpn")}

PORTED = ("newUNetTrans", "base_resnet18", "xbd_bit", *_XBD_DAHITRA, *_BIT,
          *_RES34, *_ZOO)


def define_g(net_g: str, dtype=torch.float32, img_size: int = 256,
             output_nc: int = 2,
             generator: Optional[torch.Generator] = None
             ) -> torch.nn.Module:
    """Build a model by its reference ``--net_G`` key (random weights; the
    draws the port makes itself come from ``generator``). ``img_size`` and
    ``output_nc`` are read by ``newUNetTrans`` only (``img_size`` also by
    the xBD DAHiTra keys), as in the JAX registry."""
    if net_g == "newUNetTrans":
        return DAHiTraUNet(output_nc=output_nc, img_size=img_size, dtype=dtype,
                           generator=generator)
    if net_g in _XBD_DAHITRA:
        return DAHiTraUNet(output_nc=_XBD_DAHITRA[net_g], img_size=img_size,
                           pos_coarsest_only=True, dtype=dtype,
                           generator=generator)
    if net_g in _RES34:
        cls, nc = _RES34[net_g]
        return cls(dtype=dtype) if nc is None else cls(nc, dtype=dtype)
    if net_g == "xbd_bit":
        return BIT(output_nc=5, token_len=4, resnet_stages_num=4, enc_depth=1,
                   dec_depth=8, dtype=dtype, generator=generator)
    if net_g == "base_resnet18":
        return ResNetCD(output_nc=2, dtype=dtype)
    if net_g in _BIT:
        return BIT(resnet_stages_num=4, dtype=dtype, generator=generator,
                   **_BIT[net_g])
    if net_g in _ZOO:
        return _ZOO[net_g](dtype, img_size)
    if net_g in _PENDING:
        raise NotImplementedError(
            f"--net_G {net_g} is not ported yet: ROADMAP.md section 1, "
            f"item '{_PENDING[net_g]}'")
    raise NotImplementedError(
        f"Generator model name [{net_g}] is not recognized. Available: "
        f"{sorted(PORTED)}")


def final_logits(out):
    """The full-resolution logits of a model's output: the last entry of a
    multi-scale list (``changeFormerV6``), as the JAX evaluator takes it
    (evaluator.py:73-74)."""
    return out[-1] if isinstance(out, (list, tuple)) else out
