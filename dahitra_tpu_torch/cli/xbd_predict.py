"""xBD test-set predictor with 4-way flip TTA:
``python -m dahitra_tpu_torch.cli.xbd_predict``.

Counterpart of dahitra_tpu/cli/xbd_predict.py (the reference's
xBD_code/predict_test_cls.py:32-101), with its flags plus ``--device``
(default ``cuda``; ``--device cpu`` on a host without a card). For each pre
| post pair under ``--test_root``: the 4 views (identity, flip up-down,
flip left-right, both) folded into one batch, one forward per checkpoint,
the sigmoids un-flipped and averaged over the views and over the ensemble
of ``--checkpoints`` (port checkpoints: a directory holding
``best_ckpt.pt``, or a ``.pt`` file). Tiles larger than ``--img_size`` are
center-cropped (the positional embeddings fix the input size). Writes
``<name>_part1.png`` (the loc probability x 255) and ``<name>_part2.png``
(the damage argmax over the four classes, 0 where loc <= ``--thr``).

    python -m dahitra_tpu_torch.cli.xbd_predict --test_root xbd/test \\
        --net_G xbd_dahitra --checkpoints weights/xbd_dahitra \\
        --out_dir predictions [--bf16]
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch
from PIL import Image

from dahitra_tpu_torch.core.checkpoint import load_checkpoint, load_weights
from dahitra_tpu_torch.data.xbd import post_image_path, scan_xbd_files
from dahitra_tpu_torch.data.xbd_augment import normalize_xbd
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.utils import disable_tf32, resolve_device


def tta_views(img6: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (4, H, W, C): identity, up-down, left-right, both
    (predict_test_cls.py:69-75)."""
    return torch.stack([img6, img6.flip(0), img6.flip(1), img6.flip(0, 1)])


def untta_mean(probs4: torch.Tensor) -> torch.Tensor:
    """Each view's flip undone, then the mean (predict_test_cls.py:79-91)."""
    return (probs4[0] + probs4[1].flip(0) + probs4[2].flip(1)
            + probs4[3].flip(0, 1)) / 4.0


def load_model(net_g: str, ckpt: str, img_size: int, dtype, device):
    """``net_g`` with the weights of ``ckpt`` (a checkpoint directory's
    ``best_ckpt.pt``, or a ``.pt`` file), in eval mode on ``device``."""
    d, name = (os.path.dirname(ckpt), os.path.basename(ckpt)[:-3]) \
        if ckpt.endswith(".pt") else (ckpt.rstrip("/"), "best_ckpt")
    restored = load_checkpoint(d, name)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint at {ckpt}")
    model = define_g(net_g, dtype=dtype, img_size=img_size)
    load_weights(model, restored[0])
    return model.to(device).eval()


@torch.inference_mode()
def predict(models, img6_u8: torch.Tensor, dtype) -> torch.Tensor:
    """(H, W, 6) uint8 on the device -> (H, W, 5) fp32 probabilities, the
    mean over the 4 views and the models."""
    views = tta_views(normalize_xbd(img6_u8, dtype))
    return sum(untta_mean(torch.sigmoid(m(views).float()))
               for m in models) / len(models)


def main(argv=None) -> list:
    """Predict every pair; returns the names of the PNGs written."""
    parser = ArgumentParser()
    parser.add_argument("--test_root", default="xbd/test")
    parser.add_argument("--net_G", default="xbd_dahitra")
    parser.add_argument("--img_size", default=1024, type=int)
    parser.add_argument("--checkpoints", nargs="+", required=True,
                        help="one or more checkpoints (ensemble mean)")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--thr", default=0.3, type=float)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    os.makedirs(args.out_dir, exist_ok=True)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    models = [load_model(args.net_G, ck, args.img_size, dtype, device)
              for ck in args.checkpoints]
    written = []
    for fn in scan_xbd_files([args.test_root]):
        pre = np.array(Image.open(fn).convert("RGB"))
        post = np.array(Image.open(post_image_path(fn)).convert("RGB"))
        s = args.img_size
        if pre.shape[0] > s:
            y0, x0 = (pre.shape[0] - s) // 2, (pre.shape[1] - s) // 2
            pre = pre[y0:y0 + s, x0:x0 + s]
            post = post[y0:y0 + s, x0:x0 + s]
        img6 = torch.from_numpy(np.concatenate([pre, post], -1)).to(device)
        probs = predict(models, img6, dtype).cpu().numpy()
        base = os.path.basename(fn)
        loc = (probs[..., 0] * 255).astype(np.uint8)
        dmg = probs[..., 1:].argmax(-1).astype(np.uint8) \
            * (probs[..., 0] > args.thr)
        for img, part in ((loc, "part1"), (dmg.astype(np.uint8), "part2")):
            out = base.replace(".png", f"_{part}.png")
            Image.fromarray(img).save(os.path.join(args.out_dir, out))
            written.append(out)
        print("wrote", base, flush=True)
    return written


if __name__ == "__main__":
    main()
