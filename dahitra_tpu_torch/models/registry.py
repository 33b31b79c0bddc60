"""Model registry: ``define_g`` keyed by the reference's ``--net_G`` flags.

Counterpart of dahitra_tpu/models/registry.py. Ported: ``newUNetTrans``, the
BIT keys ``base_transformer_pos_s4*`` and ``base_resnet18``, with the JAX
registry's arguments (registry.py:33-65); every other key of the JAX
registry raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch

from dahitra_tpu_torch.models.bit import BIT
from dahitra_tpu_torch.models.dahitra import DAHiTraUNet
from dahitra_tpu_torch.models.resnet_cd import ResNetCD

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

# Keys of the JAX registry not ported yet -> ROADMAP.md section 1 item.
_PENDING = {
    **{k: "Rest of the zoo" for k in (
        "unet_coupled_trans_256", "unet_coupled_two_trans_256", "changeFormer",
        "changeFormerV6", "siamUnet_conc", "siamUnet", "xbd_res34_loc",
        "xbd_res34_double", "xbd_res34_single", "xbd_res34_double_modified",
        "xbd_adapt_res34", "xbd_seresnext50_loc", "xbd_seresnext50_double",
        "xbd_senet154_loc", "xbd_senet154_double", "xbd_dpn92_loc",
        "xbd_dpn92_double", "xbd_unet_change_transformer",
        "xbd_unet_change_transformer_bit", "dual_hrnet", "dual_hrnet_fpn")},
    **{k: "xBD stack" for k in ("xbd_dahitra", "xbd_adapt_dahitra",
                                "xbd_bit")},
}

PORTED = ("newUNetTrans", "base_resnet18", *_BIT)


def define_g(net_g: str, dtype=torch.float32, img_size: int = 256,
             output_nc: int = 2,
             generator: Optional[torch.Generator] = None
             ) -> torch.nn.Module:
    """Build a model by its reference ``--net_G`` key (random weights; the
    draws the port makes itself come from ``generator``). ``img_size`` and
    ``output_nc`` are read by ``newUNetTrans`` only, as in the JAX
    registry."""
    if net_g == "newUNetTrans":
        return DAHiTraUNet(output_nc=output_nc, img_size=img_size, dtype=dtype,
                           generator=generator)
    if net_g == "base_resnet18":
        return ResNetCD(output_nc=2, dtype=dtype)
    if net_g in _BIT:
        return BIT(resnet_stages_num=4, dtype=dtype, generator=generator,
                   **_BIT[net_g])
    if net_g in _PENDING:
        raise NotImplementedError(
            f"--net_G {net_g} is not ported yet: ROADMAP.md section 1, "
            f"item '{_PENDING[net_g]}'")
    raise NotImplementedError(
        f"Generator model name [{net_g}] is not recognized. Available: "
        f"{sorted(PORTED)}")
