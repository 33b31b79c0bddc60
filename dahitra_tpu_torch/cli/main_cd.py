"""Train + test CLI: ``python -m dahitra_tpu_torch.cli.main_cd``.

Counterpart of dahitra_tpu/cli/main_cd.py, with every flag of it plus
``--device`` (default ``cuda``; without a card it raises, and the CPU must
be asked for with ``--device cpu``). It trains ``CDTrainer`` on ``--split``,
validates on ``--split_val`` every epoch, then, unless ``--skip_test``,
scores ``best_ckpt.pt`` on the test split through the port's
``CDEvaluator`` (on ``--split_val`` when the data has no test split).

    python -m dahitra_tpu_torch.cli.main_cd --data_name LEVIR \\
        --net_G newUNetTrans --img_size 256 --batch_size 8 --max_epochs 2 \\
        --lr 0.0005 --checkpoint_root checkpoints --project_name demo [--bf16]
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

from dahitra_tpu_torch.data.levir import load_levir_split
from dahitra_tpu_torch.data.registry import get_data_config
from dahitra_tpu_torch.evalx.evaluator import CDEvaluator
from dahitra_tpu_torch.train.engine import CDTrainer
from dahitra_tpu_torch.utils import resolve_device

_NO_EFFECT = "accepted for the JAX package's command lines; no effect here"


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--gpu_ids", type=str, default="0",
                        help="accepted for the reference's command lines; "
                        "the card is chosen by --device")
    parser.add_argument("--project_name", default="test", type=str)
    parser.add_argument("--checkpoint_root", default="checkpoints", type=str)
    parser.add_argument("--num_workers", default=4, type=int,
                        help="recorded; the loader is one host thread")
    parser.add_argument("--dataset", default="CDDataset", type=str)
    parser.add_argument("--data_name", default="LEVIR", type=str)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--split", default="train", type=str)
    parser.add_argument("--split_val", default="val", type=str)
    parser.add_argument("--img_size", default=256, type=int)
    parser.add_argument("--n_class", default=2, type=int)
    parser.add_argument("--net_G", default="newUNetTrans", type=str)
    parser.add_argument("--loss", default="ce", type=str,
                        help="recorded; the trainer optimizes dice+focal "
                        "(batch > 1) or CE (batch 1) as the reference does "
                        "(trainer.py:254-261)")
    parser.add_argument("--optimizer", default="adamw", type=str)
    parser.add_argument("--lr", default=0.0005, type=float)
    parser.add_argument("--max_epochs", default=100, type=int)
    parser.add_argument("--lr_policy", default="linear", type=str)
    parser.add_argument("--lr_decay_iters", default=100, type=int)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (parameters stay fp32)")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--profile_dir", default=None, type=str,
                        help="write a torch.profiler trace of epoch 0 here "
                        "(trace.json)")
    parser.add_argument("--scan_epoch", action="store_true",
                        help="TPU dispatch workaround (one lax.scan per "
                        "epoch); " + _NO_EFFECT)
    parser.add_argument("--log_every", default=100, type=int,
                        help="progress line every N batches (0 = off)")
    parser.add_argument("--log_chunks", default=1, type=int,
                        help="TPU dispatch workaround (scan chunks); "
                        + _NO_EFFECT)
    parser.add_argument("--vis_train_every", default=0, type=int,
                        help="training vis grid every N batches (0 = off)")
    parser.add_argument("--multi_scale_loss", action="store_true",
                        help="deep supervision over multi-scale heads; "
                        "newUNetTrans has one head, so no effect with it")
    parser.add_argument("--init_type", default="normal", type=str,
                        help="init_net weight init: normal|xavier|kaiming|"
                        "orthogonal|none (networks.py:77-127)")
    parser.add_argument("--init_gain", default=0.02, type=float)
    parser.add_argument("--allow_missing_labels", action="store_true",
                        help="substitute all-zero labels for splits without "
                        "a label dir (their metrics mean nothing)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default; raises without a card) or cpu")
    return parser


def _arrays(cfg, split, args) -> dict:
    p = load_levir_split(cfg.root_dir, split, args.img_size,
                         cfg.label_transform,
                         allow_missing_labels=args.allow_missing_labels)
    return {"a": p.a, "b": p.b, "label": p.label}


def train(args) -> list:
    cfg = get_data_config(args.data_name)
    trainer = CDTrainer(args, _arrays(cfg, args.split, args),
                        _arrays(cfg, args.split_val, args), device=args.device)
    return trainer.train_models()


def test(args) -> dict:
    cfg = get_data_config(args.data_name)
    split = "test"
    if not os.path.isdir(os.path.join(cfg.root_dir, split, "A")):
        split = args.split_val  # no test split: score the validation split
    evaluator = CDEvaluator(args, _arrays(cfg, split, args),
                            device=args.device)
    return evaluator.eval_models()


def main(argv=None) -> list:
    """Train (and test); returns the per-epoch train scores of this run."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # a missing card fails before any loading
    args.checkpoint_dir = os.path.join(args.checkpoint_root, args.project_name)
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    args.vis_dir = os.path.join(args.checkpoint_dir, "vis")
    history = train(args)
    if not args.skip_test:
        test(args)
    return history


if __name__ == "__main__":
    main()
