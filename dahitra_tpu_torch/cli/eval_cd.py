"""Checkpoint evaluation CLI: ``python -m dahitra_tpu_torch.cli.eval_cd``.

Counterpart of dahitra_tpu/cli/eval_cd.py, with the same flags plus
``--device`` (default ``cuda``; ``cpu`` must be asked for). The reference
loops over the 16 fixed 256 px patches of each 1024 px tile re-creating its
loader (eval_cd.py:49-55); confusion matrices add, so every requested patch
is evaluated in one pass and both per-patch and total scores are reported.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np

from dahitra_tpu_torch.data.levir import (crop_origin, load_levir_split,
                                          tile_width)
from dahitra_tpu_torch.data.registry import get_data_config
from dahitra_tpu_torch.evalx.evaluator import CDEvaluator
from dahitra_tpu_torch.utils import resolve_device

_PRINTED = ("acc", "miou", "mf1", "F1_1", "iou_1")


def main(argv=None) -> dict:
    parser = ArgumentParser()
    parser.add_argument("--gpu_ids", type=str, default="0",
                        help="accepted for the reference's command lines; "
                        "the card is chosen by --device")
    parser.add_argument("--project_name", default="test", type=str)
    parser.add_argument("--checkpoint_root", default="checkpoints", type=str)
    parser.add_argument("--data_name", default="LEVIR", type=str)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--split", default="test", type=str)
    parser.add_argument("--img_size", default=256, type=int)
    parser.add_argument("--n_class", default=2, type=int)
    parser.add_argument("--net_G", default="newUNetTrans", type=str)
    parser.add_argument("--num_patches", default=16, type=int,
                        help="fixed 256px patches per tile (eval_cd.py:49)")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--save_vis", action="store_true")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    resolve_device(args.device)  # a missing card fails before any loading
    args.checkpoint_dir = os.path.join(args.checkpoint_root, args.project_name)
    args.vis_dir = os.path.join("vis", args.project_name)

    cfg = get_data_config(args.data_name)
    split = args.split
    if not os.path.isdir(os.path.join(cfg.root_dir, split, "A")):
        split = "val" if os.path.isdir(os.path.join(cfg.root_dir, "val", "A")) \
            else "train"
        print(f"WARNING: split '{args.split}' not found under "
              f"{cfg.root_dir}; evaluating '{split}' instead")

    # The sweep applies where the reference's loader crops: tiles wider than
    # twice img_size. (The JAX CLI decides from the already-cropped probe,
    # so it never sweeps; ROADMAP.md section 3.)
    patched = crop_origin(tile_width(cfg.root_dir, split),
                          args.img_size) is not None
    chunks = []
    for patch in (range(args.num_patches) if patched else (None,)):
        p = load_levir_split(cfg.root_dir, split, args.img_size,
                             cfg.label_transform, patch=patch)
        chunks.append({"a": p.a, "b": p.b, "label": p.label})
    arrays = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    # Dataset position -> source patch, for the per-patch score blocks.
    group_of = np.concatenate([np.full(len(c["a"]), i, np.int32)
                               for i, c in enumerate(chunks)]) \
        if patched else None

    evaluator = CDEvaluator(args, arrays, device=args.device)
    scores = evaluator.eval_models(save_vis=args.save_vis, group_of=group_of)
    for g in scores.get("per_group", []):
        print({k: (round(v, 5) if isinstance(v, float) else v)
               for k, v in g.items() if k in ("patch",) + _PRINTED})
    print({k: round(v, 5) for k, v in scores.items()
           if k in _PRINTED + ("imps",)})
    return scores


if __name__ == "__main__":
    main()
