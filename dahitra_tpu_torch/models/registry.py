"""Model registry: ``define_g`` keyed by the reference's ``--net_G`` flags.

Counterpart of dahitra_tpu/models/registry.py. This slice ports
``newUNetTrans``; every other key of the JAX registry raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch

from dahitra_tpu_torch.models.dahitra import DAHiTraUNet

# Keys of the JAX registry not ported yet -> ROADMAP.md section 1 item.
_PENDING = {
    **{k: "BIT and the registry" for k in (
        "base_resnet18", "base_transformer_pos_s4", "base_transformer_pos_s4_dd8",
        "base_transformer_pos_s4_dd8_o5", "base_transformer_pos_s4_dd8_dedim8",
        "base_transformer_pos_s4_dd8_t8_e2d4", "xbd_bit")},
    **{k: "Rest of the zoo" for k in (
        "unet_coupled_trans_256", "unet_coupled_two_trans_256", "changeFormer",
        "changeFormerV6", "siamUnet_conc", "siamUnet", "xbd_res34_loc",
        "xbd_res34_double", "xbd_res34_single", "xbd_res34_double_modified",
        "xbd_adapt_res34", "xbd_seresnext50_loc", "xbd_seresnext50_double",
        "xbd_senet154_loc", "xbd_senet154_double", "xbd_dpn92_loc",
        "xbd_dpn92_double", "xbd_unet_change_transformer",
        "xbd_unet_change_transformer_bit", "dual_hrnet", "dual_hrnet_fpn")},
    **{k: "xBD stack" for k in ("xbd_dahitra", "xbd_adapt_dahitra")},
}


def define_g(net_g: str, dtype=torch.float32, img_size: int = 256,
             output_nc: int = 2,
             generator: Optional[torch.Generator] = None
             ) -> torch.nn.Module:
    """Build a model by its reference ``--net_G`` key (random weights; the
    draws the port makes itself come from ``generator``)."""
    if net_g == "newUNetTrans":
        return DAHiTraUNet(output_nc=output_nc, img_size=img_size, dtype=dtype,
                           generator=generator)
    if net_g in _PENDING:
        raise NotImplementedError(
            f"--net_G {net_g} is not ported yet: ROADMAP.md section 1, "
            f"item '{_PENDING[net_g]}'")
    raise NotImplementedError(
        f"Generator model name [{net_g}] is not recognized. Available: "
        "['newUNetTrans']")
