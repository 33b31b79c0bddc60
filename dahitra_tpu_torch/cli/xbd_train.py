"""xBD training CLI: ``python -m dahitra_tpu_torch.cli.xbd_train``.

Counterpart of dahitra_tpu/cli/xbd_train.py, with its flags plus
``--device`` (default ``cuda``; without a card it raises, and the CPU must
be asked for with ``--device cpu``). It scans ``--data_root`` (``--disasters``
filters the names), splits 90/10 with the class-presence upsampling
(``data/xbd.py``), decodes both parts and trains, validating and gating
``best_ckpt.pt`` every ``--eval_every`` epochs:

  * ``--task damage`` (default): ``XBDTrainer``, DAHiTra (``xbd_dahitra``)
    or another 5-class model on 1024 px tiles;
  * ``--task loc``: the footprint model on the pre image (``--net_G`` left
    at its default becomes ``xbd_res34_loc``, as in the JAX CLI);
  * ``--task adapt``: the 4-class adaptation recipe (default net
    ``xbd_adapt_res34``; ``xbd_adapt_dahitra`` runs DAHiTra), masks with
    classes 3 and 4 merged and both images colour-normalised;
  * ``--task gan``: ``GANTrainer``, the damage model against the mask
    discriminator (``best_ckpt_D.pt`` beside), ``--effective_gan`` giving
    the generator the adversarial gradient the reference detaches.

``--elastic`` adds the UNet-transformer recipe's gated elastic jitter.

    python -m dahitra_tpu_torch.cli.xbd_train --data_root xbd/train \\
        --net_G xbd_dahitra --img_size 1024 --batch_size 1 --max_epochs 100 \\
        --checkpoint_root weights --project_name xbd_dahitra [--bf16]

``--task hrnet`` raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

from dahitra_tpu_torch.data.xbd import (load_xbd_pairs, scan_xbd_files,
                                        split_and_upsample)
from dahitra_tpu_torch.train.xbd_engine import (GANTrainer, XBDTrainer,
                                                pending_task)
from dahitra_tpu_torch.utils import resolve_device

_NO_EFFECT = "accepted for the JAX package's command lines; no effect here"


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--data_root", default="xbd/train")
    parser.add_argument("--task", default="damage",
                        choices=["damage", "loc", "adapt", "gan", "hrnet"])
    parser.add_argument("--disasters", nargs="*", default=None,
                        help="filter file names by substrings")
    parser.add_argument("--effective_gan", action="store_true",
                        help="give the GAN generator the adversarial "
                        "gradient (the reference detaches it)")
    parser.add_argument("--net_G", default="xbd_dahitra")
    parser.add_argument("--img_size", default=1024, type=int,
                        help="crop size (1024 = the whole tile)")
    parser.add_argument("--batch_size", default=1, type=int)
    parser.add_argument("--val_batch_size", default=1, type=int)
    parser.add_argument("--lr", default=0.0, type=float,
                        help="0 = the task's reference default (1e-4 for "
                        "damage and gan, 1.5e-4 otherwise)")
    parser.add_argument("--max_epochs", default=100, type=int)
    parser.add_argument("--checkpoint_root", default="weights")
    parser.add_argument("--project_name", default="xbd_dahitra")
    parser.add_argument("--warm_start_from", default=None,
                        help="checkpoint dir (or .pt) to copy the "
                        "size-matched weights from")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (parameters stay fp32)")
    parser.add_argument("--elastic", action="store_true",
                        help="the UNet-transformer recipe's per-date "
                        "elastic jitter at p about 0.017")
    parser.add_argument("--scan_epoch", action="store_true",
                        help="TPU dispatch workaround (chunked lax.scan "
                        "epochs); " + _NO_EFFECT)
    parser.add_argument("--scan_chunk_batches", default=0, type=int,
                        help=_NO_EFFECT)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--eval_every", default=2, type=int)
    parser.add_argument("--gpu_ids", default="0", type=str,
                        help="accepted for the reference's command lines; "
                        "the card is chosen by --device")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default; raises without a card) or cpu")
    return parser


# The task's model where --net_G is left at its default (the JAX CLI's).
DEFAULT_NET = {"loc": "xbd_res34_loc", "adapt": "xbd_adapt_res34"}


def main(argv=None) -> list:
    """Train; returns the per-epoch lines of ``train_models``."""
    args = build_parser().parse_args(argv)
    pending_task(args.task)
    resolve_device(args.device)  # a missing card fails before any loading
    if args.net_G == "xbd_dahitra":
        args.net_G = DEFAULT_NET.get(args.task, args.net_G)
    args.checkpoint_dir = os.path.join(args.checkpoint_root, args.project_name)
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    files = scan_xbd_files([args.data_root], disasters=args.disasters)
    train_idx, val_idx = split_and_upsample(files, seed=args.seed)
    merge = args.task == "adapt"
    pairs = [load_xbd_pairs([files[i] for i in idx], train=train,
                            crop_size=args.img_size, seed=args.seed,
                            merge_34=merge, color_normalize=merge).arrays()
             for idx, train in ((train_idx, True), (val_idx, False))]
    if args.task == "gan":
        trainer = GANTrainer(args, *pairs, device=args.device,
                             effective_gan=args.effective_gan)
    else:
        trainer = XBDTrainer(args, *pairs, device=args.device, task=args.task)
    return trainer.train_models(eval_every=args.eval_every)


if __name__ == "__main__":
    main()
