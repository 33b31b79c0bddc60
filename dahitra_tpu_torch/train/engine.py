"""CDTrainer: the LEVIR-CD training engine.

Counterpart of dahitra_tpu/train/engine.py:51-499 (the reference's
models/trainer.py:21-335), per-batch path. Each step: the uint8 batch goes
to the device, is augmented there (flips, blur, normalisation), runs the
train-mode forward (per-date BatchNorm statistics; the decoder stacks
through K1 with saves), ``levir_train_loss`` on the fp32 logits with the
batch's own size (a ragged batch of one takes the CE branch), backward (K2
for the decoder stacks) and the AdamW step. The confusion matrix and the
losses stay on the device until a log line needs them. The learning rate
is set per epoch.

Artifacts as the reference writes them: ``log.txt`` (the argument line,
progress every ``--log_every`` batches, the epoch lines with ``imps``),
``train_acc.npy`` / ``val_acc.npy`` and ``best_ckpt.pt``, gated on the
validation mF1; a ``best_ckpt.pt`` already in the checkpoint directory
resumes the run after its epoch, optimizer state included.

``--scan_epoch`` and ``--log_chunks`` are TPU dispatch workarounds
(engine.py:187-258) and have no effect here. ``--profile_dir`` writes a
torch.profiler trace of epoch 0 (``trace.json``).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from dahitra_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from dahitra_tpu_torch.data.augment import augment_pairs
from dahitra_tpu_torch.data.loader import BatchLoader
from dahitra_tpu_torch.losses.cd import levir_train_loss
from dahitra_tpu_torch.metrics.confusion import batch_confusion_matrix, cm2score
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.nn.init import init_weights
from dahitra_tpu_torch.train.optim import (epoch_lr, make_optimizer,
                                           set_learning_rate)
from dahitra_tpu_torch.utils import Logger, Timer, disable_tf32, resolve_device


class CDTrainer:
    def __init__(self, args, train_arrays: Dict[str, np.ndarray],
                 val_arrays: Dict[str, np.ndarray], device="cuda"):
        self.args = args
        self.n_class = args.n_class
        self.checkpoint_dir = args.checkpoint_dir
        self.max_epochs = args.max_epochs
        self.device = resolve_device(device)
        disable_tf32()
        self.dtype = torch.bfloat16 if getattr(args, "bf16", False) \
            else torch.float32
        seed = getattr(args, "seed", 0)
        self.logger = Logger(os.path.join(self.checkpoint_dir, "log.txt"))
        self.logger.write_dict(vars(args))

        gen = torch.Generator().manual_seed(seed)
        self.model = define_g(args.net_G, dtype=self.dtype,
                              img_size=args.img_size, generator=gen)
        init_weights(self.model, getattr(args, "init_type", "normal"),
                     getattr(args, "init_gain", 0.02), gen)
        self.model.to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), args.lr,
                                        weight_decay=0.01)
        self.aug_generator = torch.Generator(device=self.device)
        self.aug_generator.manual_seed(seed)

        self.train_loader = BatchLoader(train_arrays, args.batch_size,
                                        shuffle=True, seed=seed)
        self.val_loader = BatchLoader(val_arrays, args.batch_size)

        self.epoch_to_start = 0
        self.best_val_acc = 0.0
        self.best_epoch_id = 0
        self.train_acc_curve: list = []
        self.val_acc_curve: list = []
        self._maybe_resume()

    def _to_device(self, batch):
        return tuple(torch.from_numpy(batch[k]).to(self.device)
                     for k in ("a", "b", "label"))

    def train_step(self, a_u8, b_u8, l_u8):
        """One optimizer step on a uint8 batch already on the device;
        returns (loss, confusion matrix), both device tensors."""
        a, b, label = augment_pairs(a_u8, b_u8, l_u8, train=True,
                                    dtype=self.dtype,
                                    generator=self.aug_generator)
        logits = self.model(a, b, train=True)
        loss = levir_train_loss(logits.float(), label, a.shape[0])
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        cm = batch_confusion_matrix(logits.detach().argmax(-1), label,
                                    self.n_class)
        return loss.detach(), cm

    def train_one_epoch(self, epoch: int) -> dict:
        lr = epoch_lr(self.args.lr, epoch, self.args.lr_policy,
                      self.max_epochs)
        set_learning_rate(self.optimizer, lr)
        self.logger.write(f"lr: {lr:.7f}\n")
        profile_dir = getattr(self.args, "profile_dir", None)
        prof = None
        if profile_dir and epoch == 0:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
        log_every = int(getattr(self.args, "log_every", 100) or 0)
        vis_every = int(getattr(self.args, "vis_train_every", 0) or 0)
        n_batches = len(self.train_loader)
        cm_dev = torch.zeros((self.n_class,) * 2, dtype=torch.long,
                             device=self.device)
        losses, n_img = [], 0
        timer = Timer()
        for bi, batch in enumerate(self.train_loader):
            loss, cm = self.train_step(*self._to_device(batch))
            cm_dev += cm
            losses.append(loss)
            n_img += len(batch["a"])
            if log_every and (bi + 1) % log_every == 0:
                el = timer.elapsed()
                rem = (n_batches - bi - 1) + n_batches * max(
                    self.max_epochs - 1 - epoch, 0)
                self.logger.write(
                    f"Is_training: True. [{epoch},{bi + 1}][{n_batches}], "
                    f"imps: {n_img / max(el, 1e-9):.2f}, "
                    f"est: {el / (bi + 1) * rem / 3600.0:.4f}h, "
                    f"G_loss: {torch.stack(losses).mean().item():.5f}, "
                    f"running_mf1: {cm2score(cm_dev.cpu().numpy())['mf1']:.5f}"
                    "\n")
            if vis_every and (bi + 1) % vis_every == 0:
                self._save_train_vis(batch, epoch, bi + 1)
        scores = cm2score(cm_dev.cpu().numpy())
        imps = timer.images_per_sec(n_img)
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            self.logger.write(f"profiler trace written to {profile_dir}\n")
        mean_loss = torch.stack(losses).mean().item() if losses else 0.0
        self.logger.write(
            f"Is_training: True. Epoch {epoch} / {self.max_epochs - 1}, "
            f"epoch_mF1= {scores['mf1']:.5f}, imps: {imps:.2f}, "
            f"G_loss: {mean_loss:.5f}\n")
        self.train_acc_curve.append(scores["mf1"])
        np.save(os.path.join(self.checkpoint_dir, "train_acc.npy"),
                np.asarray(self.train_acc_curve, np.float32))
        return {**scores, "imps": imps, "loss": mean_loss}

    def _save_train_vis(self, batch, epoch: int, batch_id: int) -> None:
        """A | B | GT rows of one batch as a JPEG (models/trainer.py:196-204)."""
        from PIL import Image

        vis_dir = getattr(self.args, "vis_dir", None) or os.path.join(
            self.checkpoint_dir, "vis")
        os.makedirs(vis_dir, exist_ok=True)
        a = np.concatenate(list(batch["a"]), axis=1)
        b = np.concatenate(list(batch["b"]), axis=1)
        g = np.concatenate(list(batch["label"].astype(np.uint8) * 255), axis=1)
        grid = np.concatenate([a, b, np.stack([g] * 3, -1)], axis=0)
        Image.fromarray(grid).save(
            os.path.join(vis_dir, f"train_e{epoch}_b{batch_id}.jpg"))

    @torch.inference_mode()
    def validate(self, epoch: int) -> dict:
        """The eval forward (running statistics; K1 without saves)."""
        cm = torch.zeros((self.n_class,) * 2, dtype=torch.long,
                         device=self.device)
        for batch in self.val_loader:
            a_u8, b_u8, l_u8 = self._to_device(batch)
            a, b, label = augment_pairs(a_u8, b_u8, l_u8, train=False,
                                        dtype=self.dtype)
            cm += batch_confusion_matrix(self.model(a, b).argmax(-1), label,
                                         self.n_class)
        scores = cm2score(cm.cpu().numpy())
        self.logger.write(
            f"Is_training: False. Epoch {epoch} / {self.max_epochs - 1}, "
            f"epoch_mF1= {scores['mf1']:.5f}\n")
        self.logger.write(" ".join(f"{k}: {v:.5f}" for k, v in scores.items())
                          + "\n\n")
        self.val_acc_curve.append(scores["mf1"])
        np.save(os.path.join(self.checkpoint_dir, "val_acc.npy"),
                np.asarray(self.val_acc_curve, np.float32))
        return scores

    def _maybe_resume(self) -> None:
        restored = load_checkpoint(self.checkpoint_dir, "best_ckpt")
        if restored is None:
            self.logger.write("training from scratch...\n")
            return
        state_dict, meta = restored
        self.model.load_state_dict(state_dict)
        if "optimizer_G_state_dict" in meta:
            self.optimizer.load_state_dict(meta["optimizer_G_state_dict"])
        self.epoch_to_start = int(meta.get("epoch_id", -1)) + 1
        self.best_val_acc = float(meta.get("best_val_acc", 0.0))
        self.best_epoch_id = int(meta.get("best_epoch_id", 0))
        self.logger.write(
            f"Epoch_to_start = {self.epoch_to_start}, "
            f"Historical_best_acc = {self.best_val_acc:.4f} "
            f"(at epoch {self.best_epoch_id})\n\n")

    def _update_checkpoints(self, epoch: int, val_acc: float) -> None:
        self.logger.write(
            f"Lastest model updated. Epoch_acc={val_acc:.4f}, "
            f"Historical_best_acc={self.best_val_acc:.4f} "
            f"(at epoch {self.best_epoch_id})\n\n")
        if val_acc > self.best_val_acc:
            self.best_val_acc = val_acc
            self.best_epoch_id = epoch
            save_checkpoint(self.checkpoint_dir, self.model.state_dict(),
                            best_val_acc=val_acc, best_epoch_id=epoch,
                            epoch_id=epoch,
                            optimizer_state=self.optimizer.state_dict())
            self.logger.write("*" * 10 + "Best model updated!\n\n")

    def train_models(self) -> list:
        """Every remaining epoch: train, validate, gate the checkpoint.
        Returns each epoch's train scores (with ``imps`` and ``loss``)."""
        history = []
        for epoch in range(self.epoch_to_start, self.max_epochs):
            history.append(self.train_one_epoch(epoch))
            self.logger.write("Begin evaluation...\n")
            scores = self.validate(epoch)
            self._update_checkpoints(epoch, scores["mf1"])
        return history
