"""Trainable-parameter counter: ``python -m dahitra_tpu_torch.cli.count_params``.

Counterpart of dahitra_tpu/cli/count_params.py (the reference's
get_epoch_data.py:14-24). Each model is built on the ``meta`` device, so no
weight is allocated or drawn on any device, and the count is that of its
parameters (BatchNorm running statistics are buffers and do not count).

    python -m dahitra_tpu_torch.cli.count_params newUNetTrans changeFormerV6 \\
        [--img_size 64]
"""
from __future__ import annotations

from argparse import ArgumentParser

import torch

from dahitra_tpu_torch.models.registry import define_g


def count(net_g: str, img_size: int = 64) -> int:
    """The trainable parameters of ``net_g`` at ``img_size``."""
    with torch.device("meta"):
        model = define_g(net_g, img_size=img_size)
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def main(argv=None) -> dict:
    """Prints and returns {key: count} (a key that fails prints why)."""
    parser = ArgumentParser()
    parser.add_argument("models", nargs="*",
                        default=["newUNetTrans", "base_transformer_pos_s4_dd8"])
    parser.add_argument("--img_size", default=64, type=int)
    args = parser.parse_args(argv)
    counts = {}
    for name in args.models:
        try:
            counts[name] = count(name, args.img_size)
            print(f"{name}: {counts[name]:,} trainable parameters")
        except Exception as e:  # noqa: BLE001
            print(f"{name}: failed ({e})")
    return counts


if __name__ == "__main__":
    main()
