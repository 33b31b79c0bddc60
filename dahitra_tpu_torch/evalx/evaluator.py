"""CDEvaluator: checkpoint evaluation with the confusion matrix kept on the
device.

Counterpart of dahitra_tpu/evalx/evaluator.py (the reference's
models/evaluator.py:20-182 and eval_cd.py's 16-patch sweep). One batch at a
time: uint8 pairs go to the device (all at once first with
``device_cache``), are normalised there, run through the model, and the
argmax of the full-resolution logits (the last entry of a multi-scale list)
feeds a batch or per-sample confusion matrix that stays on the device until
the end of the pass. The JAX package's one-dispatch ``lax.scan`` epoch
has no counterpart: PyTorch runs eagerly.

Artifacts as the reference writes them: the scores line in
``log_test.txt``, the ``<mf1>.txt`` marker and ``scores_dict.npy``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from dahitra_tpu_torch.core.checkpoint import load_checkpoint, load_weights
from dahitra_tpu_torch.data.augment import augment_pairs
from dahitra_tpu_torch.data.loader import BatchLoader
from dahitra_tpu_torch.metrics.confusion import (batch_confusion_matrix,
                                                 cm2score,
                                                 per_sample_confusion_matrix)
from dahitra_tpu_torch.models.registry import define_g, final_logits
from dahitra_tpu_torch.utils import Logger, Timer, disable_tf32, resolve_device


class CDEvaluator:
    def __init__(self, args, arrays: Dict[str, np.ndarray],
                 device="cuda", state_dict: Optional[dict] = None):
        self.args = args
        self.n_class = args.n_class
        self.checkpoint_dir = args.checkpoint_dir
        self.device = resolve_device(device)
        disable_tf32()
        self.dtype = torch.bfloat16 if getattr(args, "bf16", False) \
            else torch.float32
        self.logger = Logger(os.path.join(args.checkpoint_dir, "log_test.txt"))
        self.loader = BatchLoader(arrays, args.batch_size)
        if state_dict is None:
            restored = load_checkpoint(self.checkpoint_dir, "best_ckpt")
            if restored is None:
                raise FileNotFoundError(
                    f"no such checkpoint best_ckpt.pt in {self.checkpoint_dir}")
            state_dict, meta = restored
            self.logger.write(
                f"Eval Historical_best_acc = {meta.get('best_val_acc', 0):.4f} "
                f"(at epoch {meta.get('best_epoch_id', 0)})\n\n")
        self.model = define_g(args.net_G, dtype=self.dtype,
                              img_size=args.img_size)
        load_weights(self.model, state_dict)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def eval_step(self, a_u8: torch.Tensor, b_u8: torch.Tensor,
                  l_u8: torch.Tensor, per_sample: bool = False):
        """(confusion matrix, prediction) of one uint8 batch on the device;
        per-sample (B, C, C) matrices when ``per_sample``."""
        a, b, label = augment_pairs(a_u8, b_u8, l_u8, train=False,
                                    dtype=self.dtype)
        pred = final_logits(self.model(a, b)).argmax(-1)
        cm_fn = per_sample_confusion_matrix if per_sample \
            else batch_confusion_matrix
        return cm_fn(pred, label, self.n_class), pred

    def _to_device(self, batch: Dict[str, np.ndarray]):
        return tuple(torch.from_numpy(batch[k]).to(self.device)
                     for k in ("a", "b", "label"))

    def stage_on_device(self) -> list:
        """The whole uint8 eval set on the device, batch by batch."""
        return [self._to_device(batch) for batch in self.loader]

    def eval_models(self, save_vis: bool = False, device_cache: bool = False,
                    group_of: Optional[np.ndarray] = None) -> dict:
        """Score the split. ``device_cache`` stages the dataset on the
        device before the pass. ``group_of`` (the patch of each dataset
        position) switches to per-sample matrices so that the result also
        carries a reference-style score block per patch (``per_group``).
        The summed matrix stays on ``self.confusion_matrix``."""
        self.logger.write("Begin evaluation...\n")
        timer = Timer()
        grouped = group_of is not None
        batches = (self.stage_on_device() if device_cache
                   else (self._to_device(b) for b in self.loader))
        cms, n_img = [], 0
        for a, b, l in batches:
            cm, pred = self.eval_step(a, b, l, per_sample=grouped)
            cms.append(cm)
            n_img += a.shape[0]
            if save_vis:
                self._save_vis(a, b, l, pred, n_img)
        if grouped:
            all_ps = torch.cat(cms).cpu().numpy()
            total = all_ps.sum(axis=0)
        else:
            total = torch.stack(cms).sum(0).cpu().numpy()
        imps = timer.images_per_sec(n_img)
        scores = cm2score(total)
        if grouped:
            group_of = np.asarray(group_of)[: len(all_ps)]
            per_group = []
            for gid in np.unique(group_of):
                g_scores = cm2score(all_ps[group_of == gid].sum(axis=0))
                per_group.append({"patch": int(gid), **g_scores})
                self.logger.write(
                    f"patch {int(gid)}: "
                    + " ".join(f"{k}: {v:.5f}" for k, v in g_scores.items())
                    + "\n")
            scores["per_group"] = per_group
        self.logger.write(
            " ".join(f"{k}: {v:.5f}" for k, v in scores.items()
                     if not isinstance(v, list))
            + f" imps: {imps:.2f}\n\n")
        with open(os.path.join(self.checkpoint_dir, f"{scores['mf1']}.txt"),
                  "a"):
            pass
        np.save(os.path.join(self.checkpoint_dir, "scores_dict.npy"), scores)
        scores["imps"] = imps
        self.confusion_matrix = total
        return scores

    def _save_vis(self, a, b, label, pred, tag) -> None:
        """4-row comparison grid (models/evaluator.py:118-131), opt-in."""
        from PIL import Image

        vis_dir = getattr(self.args, "vis_dir",
                          os.path.join(self.checkpoint_dir, "vis"))
        os.makedirs(vis_dir, exist_ok=True)

        def row(t):
            return np.concatenate(list(t.cpu().numpy()), axis=1)

        p = np.stack([row(pred.to(torch.uint8) * 255)] * 3, -1)
        g = np.stack([row(label.to(torch.uint8) * 255)] * 3, -1)
        grid = np.concatenate([row(a), row(b), p, g], axis=0)
        Image.fromarray(grid).save(os.path.join(vis_dir, f"eval_{tag}.jpg"))
