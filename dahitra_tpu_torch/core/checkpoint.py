"""Checkpoints as ``torch.save`` dicts in the reference trainer's format.

Counterpart of dahitra_tpu/core/checkpoint.py, which keeps an Orbax pytree
and a JSON sidecar. The port writes what the reference trainer wrote
(models/trainer.py:150-158): one file ``<checkpoint_dir>/<name>.pt`` holding
``model_G_state_dict``, ``best_val_acc`` and ``best_epoch_id`` and, from a
training run, ``epoch_id`` and ``optimizer_G_state_dict``, so reference
checkpoints and the port's own load through the same path and a
``best_ckpt.pt`` resumes a run (dahitra_tpu/train/engine.py ``_maybe_resume``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

StateDict = Dict[str, torch.Tensor]


def checkpoint_path(checkpoint_dir: str, name: str = "best_ckpt") -> str:
    return os.path.join(checkpoint_dir, f"{name}.pt")


def save_checkpoint(checkpoint_dir: str, state_dict: StateDict,
                    best_val_acc: float = 0.0, best_epoch_id: int = 0,
                    name: str = "best_ckpt", epoch_id: Optional[int] = None,
                    optimizer_state: Optional[dict] = None) -> str:
    """Write the reference-format dict; returns the file's path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    ckpt = {"model_G_state_dict": {k: v.detach().cpu()
                                   for k, v in state_dict.items()},
            "best_val_acc": float(best_val_acc),
            "best_epoch_id": int(best_epoch_id)}
    if epoch_id is not None:
        ckpt["epoch_id"] = int(epoch_id)
    if optimizer_state is not None:
        ckpt["optimizer_G_state_dict"] = optimizer_state
    path = checkpoint_path(checkpoint_dir, name)
    torch.save(ckpt, path)
    return path


def model_state_dict(ckpt) -> StateDict:
    """The model weights of a loaded checkpoint: ``model_G_state_dict`` (or
    ``state_dict``) when present, with DataParallel's ``module.`` prefix
    stripped, as the reference's loaders do (xBD_code/train.py:450-456)."""
    for key in ("model_G_state_dict", "state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in ckpt.items()}


def load_checkpoint(checkpoint_dir: str, name: str = "best_ckpt"
                    ) -> Optional[Tuple[StateDict, dict]]:
    """(state_dict, metadata) of ``<checkpoint_dir>/<name>.pt``; None if
    the file is absent. The metadata holds whichever of ``best_val_acc``,
    ``best_epoch_id``, ``epoch_id`` and ``optimizer_G_state_dict`` the file
    has."""
    path = checkpoint_path(checkpoint_dir, name)
    if not os.path.exists(path):
        return None
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    meta = {k: ckpt[k] for k in ("best_val_acc", "best_epoch_id", "epoch_id",
                                 "optimizer_G_state_dict")
            if isinstance(ckpt, dict) and k in ckpt}
    return model_state_dict(ckpt), meta


def load_weights(model: torch.nn.Module, state_dict: StateDict) -> None:
    """Load ``state_dict`` into ``model``. Keys the model does not have
    (the reference's unused layer4/fc, BN ``num_batches_tracked``, its dead
    finest-scale transformer) are ignored; a key the model needs and the
    checkpoint lacks raises."""
    missing, _ = model.load_state_dict(state_dict, strict=False)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} model keys, e.g. "
                       f"{missing[:5]}")
