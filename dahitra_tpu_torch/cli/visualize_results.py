"""Damage visualisation: ``python -m dahitra_tpu_torch.cli.visualize_results``.

Counterpart of dahitra_tpu/cli/visualize_results.py (the reference's
xBD_code/visualize_results.py), with ``--device`` (default ``cuda``; without
a card it raises, the CPU is asked for with ``--device cpu``). A
localization model (``--loc_net_G``, the pre image) and a damage model
(``--dmg_net_G``, the 6-channel pair) run over the 4 flip views of each tile
(``cli/xbd_predict.py`` ``tta_views``, the mean of the sigmoids with each
flip undone); ``fuse_loc_damage`` joins them with the reference's three
thresholds (visualize_results.py:33,207)

    loc = (p_loc > 0.38) | ((p_loc > 0.13) & (dmg in {2, 3}))
          | ((p_loc > 0.14) & (dmg > 1))

and each tile's grid [pre | post | ground truth | prediction] (the classes
in ``PALETTE``, RGB) is written as ``<tile>_vis_...png``. The input scaling
is the JAX tool's own, x / 127 - 1, and so is its crop: tiles wider than
``--img_size`` are cut at (y0, y0), y0 = (H - img_size) // 2, on both axes.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch
from PIL import Image

from dahitra_tpu_torch.cli.xbd_predict import load_model, tta_views, untta_mean
from dahitra_tpu_torch.data.xbd import (post_image_path, post_mask_path,
                                        scan_xbd_files)
from dahitra_tpu_torch.utils import disable_tf32, resolve_device

THRESHOLDS = (0.38, 0.13, 0.14)
# class id -> RGB (the reference stores BGR for cv2; :159-164).
PALETTE = np.array([[0, 0, 0], [0, 255, 0], [255, 255, 0],
                    [255, 127, 0], [255, 0, 0]], np.uint8)


def assign_color(class_map: np.ndarray) -> np.ndarray:
    return PALETTE[np.clip(class_map, 0, 4)]


def fuse_loc_damage(p_loc: np.ndarray, dmg_probs: np.ndarray,
                    thr=THRESHOLDS) -> tuple:
    """(loc mask (H, W) uint8, damage class (H, W) in 1..4) from the loc
    probability and the (H, W, 5) damage probabilities."""
    msk_dmg = dmg_probs[..., 1:].argmax(-1) + 1
    msk_loc = ((p_loc > thr[0])
               | ((p_loc > thr[1]) & (msk_dmg > 1) & (msk_dmg < 4))
               | ((p_loc > thr[2]) & (msk_dmg > 1))).astype(np.uint8)
    return msk_loc, msk_dmg


@torch.inference_mode()
def predict(loc_model, dmg_model, img6: torch.Tensor, dtype):
    """(H, W, 6) scaled input on the device -> (p_loc (H, W), damage
    probabilities (H, W, 5)), fp32 means over the 4 views."""
    views = tta_views(img6).to(dtype)
    dmg = untta_mean(torch.sigmoid(dmg_model(views).float()))
    loc = untta_mean(torch.sigmoid(loc_model(views[..., :3]).float()))[..., 0]
    return loc, dmg


def main(argv=None) -> list:
    """Write every tile's grid; returns the names written."""
    parser = ArgumentParser()
    parser.add_argument("--test_root", default="xbd/test")
    parser.add_argument("--loc_ckpt", required=True,
                        help="checkpoint directory (best_ckpt.pt) or .pt")
    parser.add_argument("--loc_net_G", default="xbd_res34_loc")
    parser.add_argument("--dmg_ckpt", required=True)
    parser.add_argument("--dmg_net_G", default="xbd_dahitra")
    parser.add_argument("--img_size", default=1024, type=int)
    parser.add_argument("--out_dir", default="outputs")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    os.makedirs(args.out_dir, exist_ok=True)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    loc_model = load_model(args.loc_net_G, args.loc_ckpt, args.img_size,
                           dtype, device)
    dmg_model = load_model(args.dmg_net_G, args.dmg_ckpt, args.img_size,
                           dtype, device)
    written = []
    s = args.img_size
    for fn in scan_xbd_files([args.test_root]):
        pre = np.array(Image.open(fn).convert("RGB"))
        post = np.array(Image.open(post_image_path(fn)).convert("RGB"))
        gt = np.array(Image.open(post_mask_path(fn)))
        if pre.shape[0] > s:
            y0 = (pre.shape[0] - s) // 2
            pre, post, gt = (t[y0:y0 + s, y0:y0 + s] for t in (pre, post, gt))
        img6 = torch.from_numpy(np.concatenate([pre, post], -1)).to(
            device, torch.float32) / 127.0 - 1.0
        p_loc, dmg_probs = (t.cpu().numpy() for t in
                            predict(loc_model, dmg_model, img6, dtype))
        msk_loc, msk_dmg = fuse_loc_damage(p_loc, dmg_probs)
        grid = np.concatenate([pre, post, assign_color(gt),
                               assign_color(msk_dmg * msk_loc)], axis=1)
        name = os.path.basename(fn).replace("_pre_", "_vis_")
        Image.fromarray(grid).save(os.path.join(args.out_dir, name))
        written.append(name)
        print("wrote", name, flush=True)
    return written


if __name__ == "__main__":
    main()
