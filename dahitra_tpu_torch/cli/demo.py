"""Prediction demo: ``python -m dahitra_tpu_torch.cli.demo``.

Counterpart of dahitra_tpu/cli/demo.py (the reference's demo.py:20-85 and
models/basic_model.py:63-76), with ``--device`` (default ``cuda``; without a
card it raises, the CPU is asked for with ``--device cpu``). It loads
``<checkpoint_root>/<project_name>/best_ckpt.pt`` into ``--net_G``, runs
every pair of ``--split`` (labels optional: they are not read) through the
eval forward one pair at a time, and writes argmax * 255 of the
full-resolution logits as a PNG under the pair's name in
``--output_folder``.

    python -m dahitra_tpu_torch.cli.demo --project_name demo \\
        --checkpoint_root checkpoints --data_name LEVIR --split test \\
        --output_folder samples/predict [--bf16] [--device cpu]
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch
from PIL import Image

from dahitra_tpu_torch.core.checkpoint import load_checkpoint, load_weights
from dahitra_tpu_torch.data.augment import normalize_images
from dahitra_tpu_torch.data.levir import load_levir_split
from dahitra_tpu_torch.data.registry import get_data_config
from dahitra_tpu_torch.models.registry import define_g, final_logits
from dahitra_tpu_torch.utils import disable_tf32, resolve_device


def main(argv=None) -> list:
    """Writes the predictions; returns the names written."""
    parser = ArgumentParser()
    parser.add_argument(
        "--project_name",
        default="CROP_newUNetTrans_LEVIR_b4_lr0.001_train_val_200_linear_ce")
    parser.add_argument("--checkpoint_root", default="checkpoints", type=str)
    parser.add_argument("--data_name", default="quick_start", type=str)
    parser.add_argument("--split", default="train", type=str)
    parser.add_argument("--img_size", default=256, type=int)
    parser.add_argument("--net_G", default="newUNetTrans", type=str)
    parser.add_argument("--output_folder", default="samples/predict",
                        type=str)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    ckpt_dir = os.path.join(args.checkpoint_root, args.project_name)
    restored = load_checkpoint(ckpt_dir, "best_ckpt")
    if restored is None:
        raise FileNotFoundError(f"no such checkpoint best_ckpt.pt in "
                                f"{ckpt_dir}")
    model = define_g(args.net_G, dtype=dtype, img_size=args.img_size)
    load_weights(model, restored[0])
    model.to(device).eval()

    cfg = get_data_config(args.data_name)
    pairs = load_levir_split(cfg.root_dir, args.split, args.img_size,
                             cfg.label_transform, allow_missing_labels=True)
    os.makedirs(args.output_folder, exist_ok=True)
    written = []
    for i, name in enumerate(pairs.names):
        a, b = (normalize_images(torch.from_numpy(t[i:i + 1]).to(device),
                                 dtype) for t in (pairs.a, pairs.b))
        with torch.inference_mode():
            pred = final_logits(model(a, b)).argmax(-1)[0].cpu().numpy()
        Image.fromarray((pred * 255).astype(np.uint8)).save(
            os.path.join(args.output_folder, name))
        written.append(name)
        print("wrote", name)
    return written


if __name__ == "__main__":
    main()
