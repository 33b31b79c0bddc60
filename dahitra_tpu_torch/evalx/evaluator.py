"""CDEvaluator: checkpoint evaluation with the confusion matrix kept on the
device.

Counterpart of dahitra_tpu/evalx/evaluator.py (the reference's
models/evaluator.py:20-182 and eval_cd.py's 16-patch sweep). One batch at a
time: uint8 pairs go to the device (all at once first with
``device_cache``), are normalised there, run through the model, and the
argmax of the full-resolution logits (the last entry of a multi-scale list)
feeds a batch or per-sample confusion matrix that stays on the device until
the end of the pass. ``scan=True`` is the counterpart of the JAX
package's one-dispatch ``eval_epoch_scan`` (evaluator.py:132-180): the
full batches are staged on the device once and each is one replay of a
captured eval forward (``train/graph.py`` ``EvalScan``; eagerly on the
CPU), the ragged tail runs per batch, and ``save_vis`` switches it off.

Artifacts as the reference writes them: the scores line in
``log_test.txt``, the ``<mf1>.txt`` marker and ``scores_dict.npy``.

With a ``mesh`` (``core/mesh.py``) each rank scores its rows of every
batch, padded to the world size (the first sample repeated, label 255, a
``valid`` vector): the batch matrices are summed over the ranks (the 255
filler enters no class), per-sample matrices are gathered in dataset order
with the filler rows dropped, and only rank 0 writes the artifacts. On a (data,
space) grid the ranks of a data row score the same samples: each pass runs
them replicated, or with ``eval_models(spatial=True)`` row-sharded
(``nn/space.py``: each space rank's rows through the model, the predictions
gathered over the rows); either way the matrices are summed and gathered
over the data group only (evaluator.py:125, 152).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from dahitra_tpu_torch.core.checkpoint import load_checkpoint, load_weights
from dahitra_tpu_torch.core.mesh import all_gather_rows, reduce_sum_
from dahitra_tpu_torch.data.augment import augment_pairs
from dahitra_tpu_torch.data.loader import BatchLoader
from dahitra_tpu_torch.metrics.confusion import (batch_confusion_matrix,
                                                 cm2score,
                                                 per_sample_confusion_matrix)
from dahitra_tpu_torch.models.registry import define_g, final_logits
from dahitra_tpu_torch.nn import space
from dahitra_tpu_torch.train.graph import EvalScan
from dahitra_tpu_torch.utils import Logger, Timer, disable_tf32, resolve_device


def stage_full_batches(loader: BatchLoader, keys, device):
    """The loader's full batches (``batch_size`` real samples) stacked on
    ``device``, one (n, B, ...) tensor per key, or None without one; and
    the other batches, as the loader yields them."""
    full, tail = [], []
    for i, batch in enumerate(loader):
        (full if loader.real_rows(i) == loader.batch_size else tail).append(
            batch)
    stack = tuple(torch.from_numpy(np.stack([b[k] for b in full])).to(device)
                  for k in keys) if full else None
    return stack, tail


class CDEvaluator:
    def __init__(self, args, arrays: Dict[str, np.ndarray],
                 device="cuda", state_dict: Optional[dict] = None,
                 mesh=None):
        self.args = args
        self.n_class = args.n_class
        self.checkpoint_dir = args.checkpoint_dir
        self.mesh = mesh
        self.main = mesh is None or mesh.is_main
        self.device = resolve_device(mesh.device if mesh else device)
        disable_tf32()
        self.dtype = torch.bfloat16 if getattr(args, "bf16", False) \
            else torch.float32
        self.logger = Logger(os.path.join(args.checkpoint_dir, "log_test.txt"),
                             enabled=self.main)
        n_data = mesh.n_data if mesh else 1
        self.data = mesh.data_group if mesh else None  # gathers and sums
        self.loader = BatchLoader(arrays, args.batch_size,
                                  pad_to_multiple=n_data if n_data > 1
                                  else None,
                                  shard=mesh.shard if mesh else None)
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
                  l_u8: torch.Tensor, per_sample: bool = False,
                  spatial: bool = False):
        """(confusion matrix, prediction) of one uint8 batch on the device
        (whole images); per-sample (B, C, C) matrices when ``per_sample``.
        With ``spatial`` on a grid the forward runs on the space rank's rows
        and the prediction is gathered over the rows."""
        a, b, label = augment_pairs(a_u8, b_u8, l_u8, train=False,
                                    dtype=self.dtype)
        with space.grid(self.mesh, spatial):
            a, b = space.shard_rows(self.model, a, b)
            pred = space.gather_rows(final_logits(self.model(a, b)).argmax(-1))
        cm_fn = per_sample_confusion_matrix if per_sample \
            else batch_confusion_matrix
        return cm_fn(pred, label, self.n_class), pred

    def _to_device(self, batch: Dict[str, np.ndarray]):
        """(a, b, label, valid) on the device; ``valid`` None unpadded."""
        valid = batch.get("valid")
        return (*(torch.from_numpy(batch[k]).to(self.device)
                  for k in ("a", "b", "label")),
                None if valid is None else
                torch.from_numpy(valid).to(self.device))

    def stage_on_device(self) -> list:
        """The whole uint8 eval set on the device, batch by batch."""
        return [self._to_device(batch) for batch in self.loader]

    def eval_models(self, save_vis: bool = False, device_cache: bool = False,
                    scan: bool = False,
                    group_of: Optional[np.ndarray] = None,
                    spatial: bool = False) -> dict:
        """Score the split. ``device_cache`` stages the dataset on the
        device before the pass. ``scan`` runs the full batches as replays of
        a captured forward (module docstring); ``save_vis`` turns it into
        ``device_cache``, as in JAX (evaluator.py:154-159). ``group_of``
        (the patch of each dataset position) switches to per-sample
        matrices so that the result also carries a reference-style score
        block per patch (``per_group``). ``spatial`` runs every forward
        row-sharded on a grid (``eval_step``). The summed matrix stays on
        ``self.confusion_matrix``."""
        self.logger.write("Begin evaluation...\n")
        timer = Timer()
        grouped = group_of is not None
        if scan and save_vis:  # the replays keep no prediction to draw
            scan, device_cache = False, True
        cms, n_img = [], 0
        if scan:
            stack, tail = stage_full_batches(self.loader, ("a", "b", "label"),
                                             self.device)
            if stack is not None:
                out = EvalScan(
                    lambda a, b, l: self.eval_step(a, b, l, grouped,
                                                   spatial)[0],
                    stack, self.n_class, self.device, grouped)()
                # per full batch, every rank's matrices; or the sum
                cms += [all_gather_rows(ps, self.data) for ps in out] \
                    if grouped else [out]
                n_img += stack[0].shape[0] * self.loader.batch_size
            batches = (self._to_device(b) for b in tail)
        else:
            batches = (self.stage_on_device() if device_cache
                       else (self._to_device(b) for b in self.loader))
        for a, b, l, valid in batches:
            cm, pred = self.eval_step(a, b, l, per_sample=grouped,
                                      spatial=spatial)
            if valid is not None:
                keep = all_gather_rows(valid.byte(), self.data) > 0
                n_img += int(keep.sum())
                if grouped:  # every rank's matrices, filler dropped
                    cm = all_gather_rows(cm, self.data)[keep]
            else:  # unpadded: one process (or a mesh of one)
                n_img += a.shape[0]
            cms.append(cm)
            if save_vis and self.main:
                self._save_vis(a, b, l, pred, n_img)
        if grouped:
            all_ps = torch.cat(cms).cpu().numpy()
            total = all_ps.sum(axis=0)
        else:
            total = torch.stack(cms).sum(0)
            if self.mesh:
                reduce_sum_(total, self.data)
            total = total.cpu().numpy()
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
        if self.main:
            with open(os.path.join(self.checkpoint_dir,
                                   f"{scores['mf1']}.txt"), "a"):
                pass
            np.save(os.path.join(self.checkpoint_dir, "scores_dict.npy"),
                    scores)
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
