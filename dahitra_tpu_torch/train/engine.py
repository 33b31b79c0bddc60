"""CDTrainer: the LEVIR-CD training engine.

Counterpart of dahitra_tpu/train/engine.py:51-499 (the reference's
models/trainer.py:21-335), per-batch path. Each step: the uint8 batch goes
to the device, is augmented there (flips, blur, normalisation), runs the
train-mode forward (per-date BatchNorm statistics; the decoder stacks
through K1 with saves; dropout drawn from the trainer's dropout generator,
seeded from ``--seed`` + 1 on the device), ``levir_train_loss`` on the fp32
logits with the batch's own size (a ragged batch of one takes the CE
branch), backward (K2 for the decoder stacks) and the AdamW step. A model
that returns a list of multi-scale logits (``changeFormerV6``) trains on
its full-resolution head, or with ``--multi_scale_loss`` on the weighted
sum over its heads (``losses/cd.py`` ``multi_scale_loss``,
engine.py:127-151); its last entry is what validation scores. The confusion matrix and the
losses stay on the device until a log line needs them. The learning rate
is set per epoch.

Artifacts as the reference writes them: ``log.txt`` (the argument line,
progress every ``--log_every`` batches, the epoch lines with ``imps``),
``train_acc.npy`` / ``val_acc.npy`` and ``best_ckpt.pt``, gated on the
validation mF1; a ``best_ckpt.pt`` already in the checkpoint directory
resumes the run after its epoch, optimizer state and the augmentation and
dropout generators' states included.

With a ``mesh`` (``core/mesh.py``; ``--gpu_ids`` with several ordinals)
each rank holds the model in ``DistributedDataParallel`` and takes its data
shard's samples of every batch, padded to the mesh's data axis (n_data) as
the JAX trainer pads them (engine.py:95-101: the first sample repeated,
label 255). BatchNorm takes
the global batch's statistics, the augmentation draws are the global
batch's (``shard``), and the fp32 logits and the labels are gathered so that
every rank computes the loss and the confusion matrix of the global batch,
``batch_size`` its padded size as in JAX. The ranks' joined step is then
the one-process step on the joined batch, with one difference: dropout
masks come from a generator per rank (seed + 1 + 1000 rank), so a model
with dropout draws other masks than one process. Only rank 0 writes
``log.txt``, the ``*.npy`` curves, checkpoints and visualisations; every
rank resumes from the same checkpoint; ``imps`` counts the real pairs of all
ranks.

On a (data, space) grid (``n_space > 1``) the ranks of a data row take the
same samples. The epoch loops place them replicated (``spatial=False``, as
JAX's do, engine.py:214, 292): every space rank runs the whole images,
BatchNorm sums over the data group and the gathers run over it.
``train_step(..., spatial=True)`` is the row-sharded step
(``batch_sharding(spatial=True)``): each space rank augments its whole
images with the draws its data row shares, keeps its rows
(``nn/space.py``; the levels whose rows a strided op cannot split run
whole on every rank of the row) and runs the forward on them; the fp32
logits, the rank's rows of the full image, are gathered over rows, then
over samples, before the unchanged loss and confusion matrix, so that every
rank's loss is the global loss and the gathers' backward gives the factor
n_data * n_space that cancels DDP's mean.

``--scan_epoch`` is the host-free epoch (engine.py:327-384): the training
set is staged on the device once (``_stage_train``, trimmed to a multiple
of the world size, each rank holding its contiguous shard), each epoch is
ordered by ``_epoch_perm`` (the JAX draw, a permutation per shard under a
mesh, the ragged last batch dropped), and every step gathers its batch from
the staged arrays by an index row and runs ``train_step``, the gather and
the step captured together as one CUDA graph (``train/graph.py``; AdamW
``capturable`` with its learning rate a device tensor). ``--log_chunks N``
splits the epoch into N chunks with a progress line after each but the
last, in JAX's format; the per-batch losses are kept exactly. Validation
then replays a captured eval forward over the staged full batches and runs
the ragged tail per batch (engine.py:434-446). On the CPU the same staged
loop runs eagerly, with no graph. A batch size the world size does not
divide takes the per-batch path, as in JAX (``scan_ok``); two gloo ranks on
CUDA tensors (collectives staged through host memory, ``core/mesh.py``)
cannot be captured and raise. ``--profile_dir`` writes a torch.profiler
trace of epoch 0 (``trace.json``) on either path.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from dahitra_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from dahitra_tpu_torch.core.mesh import (all_gather_rows, reduce_sum_,
                                         wrap_ddp)
from dahitra_tpu_torch.data.augment import augment_pairs
from dahitra_tpu_torch.data.loader import BatchLoader
from dahitra_tpu_torch.evalx.evaluator import stage_full_batches
from dahitra_tpu_torch.losses.cd import levir_train_loss, multi_scale_loss
from dahitra_tpu_torch.metrics.confusion import batch_confusion_matrix, cm2score
from dahitra_tpu_torch.models.registry import define_g, final_logits
from dahitra_tpu_torch.nn import space
from dahitra_tpu_torch.nn.blocks import set_dropout_generator
from dahitra_tpu_torch.nn.init import init_weights
from dahitra_tpu_torch.train.graph import EvalScan, StepGraph
from dahitra_tpu_torch.train.optim import (epoch_lr, make_optimizer,
                                           set_learning_rate)
from dahitra_tpu_torch.utils import Logger, Timer, disable_tf32, resolve_device


class CDTrainer:
    def __init__(self, args, train_arrays: Dict[str, np.ndarray],
                 val_arrays: Dict[str, np.ndarray], device="cuda",
                 mesh=None):
        self.args = args
        self.n_class = args.n_class
        self.checkpoint_dir = args.checkpoint_dir
        self.max_epochs = args.max_epochs
        self.mesh = mesh
        self.main = mesh is None or mesh.is_main
        self.device = resolve_device(mesh.device if mesh else device)
        disable_tf32()
        self.dtype = torch.bfloat16 if getattr(args, "bf16", False) \
            else torch.float32
        seed = getattr(args, "seed", 0)
        rank, world = mesh.shard if mesh else (0, 1)
        self.logger = Logger(os.path.join(self.checkpoint_dir, "log.txt"),
                             enabled=self.main)
        self.logger.write_dict(vars(args))

        gen = torch.Generator().manual_seed(seed)
        self.model = define_g(args.net_G, dtype=self.dtype,
                              img_size=args.img_size, generator=gen)
        init_weights(self.model, getattr(args, "init_type", "normal"),
                     getattr(args, "init_gain", 0.02), gen)
        self.model.to(self.device)
        self.scan = bool(getattr(args, "scan_epoch", False))
        # the module each step runs: DDP over the ranks, or the model
        self.net = wrap_ddp(self.model, mesh, capture=self.scan)
        if self.scan and mesh and mesh.backend == "gloo" \
                and self.device.type == "cuda":
            raise ValueError(
                "--scan_epoch: gloo stages collectives on CUDA tensors "
                "through host memory, which a CUDA graph cannot capture; "
                "run the ranks under NCCL")
        self.optimizer = make_optimizer(
            self.model.parameters(), args.lr, weight_decay=0.01,
            capturable_on=self.device
            if self.scan and self.device.type == "cuda" else None)
        self.aug_generator = torch.Generator(device=self.device)
        self.aug_generator.manual_seed(seed)
        self.dropout_generator = torch.Generator(device=self.device)
        self.dropout_generator.manual_seed(seed + 1 + 1000 * rank)
        set_dropout_generator(self.model, self.dropout_generator)
        self.multi_scale = getattr(args, "multi_scale_loss", False)

        pad = world if world > 1 else None
        shard = mesh.shard if mesh else None
        self.train_loader = BatchLoader(train_arrays, args.batch_size,
                                        shuffle=True, seed=seed,
                                        pad_to_multiple=pad, shard=shard)
        self.val_loader = BatchLoader(val_arrays, args.batch_size,
                                      pad_to_multiple=pad, shard=shard)

        self._train_arrays = train_arrays
        self._staged_train = None  # the scan path's staged data and steps
        self._train_graph = None
        self._val_scan = self._val_tail = None
        self.last_epoch_losses = None  # each batch's loss, last epoch
        self.epoch_to_start = 0
        self.best_val_acc = 0.0
        self.best_epoch_id = 0
        self.train_acc_curve: list = []
        self.val_acc_curve: list = []
        self._maybe_resume()

    def _to_device(self, batch):
        return tuple(torch.from_numpy(batch[k]).to(self.device)
                     for k in ("a", "b", "label"))

    def train_step(self, a_u8, b_u8, l_u8, spatial: bool = False):
        """One optimizer step on a uint8 batch already on the device (the
        rank's data shard under a mesh, whole images); returns (loss,
        confusion matrix) of the global batch, both device tensors. With
        ``spatial`` on a grid, the forward runs on the space rank's rows."""
        data = self.mesh.data_group if self.mesh else None
        with space.grid(self.mesh, spatial):
            a, b, label = augment_pairs(a_u8, b_u8, l_u8, train=True,
                                        dtype=self.dtype,
                                        generator=self.aug_generator,
                                        shard=self.mesh.shard if self.mesh
                                        else None)
            image = a.shape[1:3]
            a, b = space.shard_rows(self.model, a, b)
            out = self.net(a, b, train=True)
            label = all_gather_rows(label, data)
            if self.multi_scale and isinstance(out, (list, tuple)):
                # each head once: one of a whole level is not the rank's
                out = [space.gather_head(lg.float(), self.mesh, image)
                       for lg in out]
                logits = out[-1]
                loss = multi_scale_loss(out, label, label.shape[0])
            else:
                logits = space.gather_batch(final_logits(out).float(),
                                            self.mesh)
                loss = levir_train_loss(logits, label, label.shape[0])
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        self.optimizer.step()
        cm = batch_confusion_matrix(logits.detach().argmax(-1), label,
                                    self.n_class)
        return loss.detach(), cm

    def _stage_train(self) -> None:
        """The training set on the device once (engine.py:208-221): trimmed
        to a multiple of the world size; each rank holds its contiguous
        shard, as the JAX arrays shard over ``data``."""
        rank, world = self.mesh.shard if self.mesh else (0, 1)
        n = len(self._train_arrays["a"])
        self._staged_n = (n // world) * world
        local = self._staged_n // world
        self._staged_train = tuple(
            torch.from_numpy(np.ascontiguousarray(
                self._train_arrays[k][rank * local:(rank + 1) * local]))
            .to(self.device) for k in ("a", "b", "label"))

    def _epoch_perm(self, epoch: int, n_batches: int, bs: int) -> np.ndarray:
        """Shuffled batch indices (n_batches, bs), JAX's draw
        (engine.py:223-245): one global permutation, or under a mesh of d
        data ranks (``n_data``, not the world size: the staged set shards
        over ``data`` only, engine.py:60-67) each shard permuted alone and
        every batch taking bs / d shard-local indices from each shard, rank
        order."""
        rng = np.random.default_rng(
            getattr(self.args, "seed", 0) * 100003 + epoch)
        d = self.mesh.n_data if self.mesh else 1
        if d == 1:
            return rng.permutation(self._staged_n)[: n_batches * bs].reshape(
                n_batches, bs)
        n_local = self._staged_n // d
        per_dev = bs // d
        cols = []
        for _ in range(d):
            cols.append(rng.permutation(n_local)[: n_batches * per_dev]
                        .reshape(n_batches, per_dev))
        return np.concatenate(cols, axis=1)

    def _scan_step(self, n_batches: int, per_rank: int) -> StepGraph:
        """The captured step over the staged data (built once): the batch
        gather by the epoch's index row ``slot`` and ``train_step``, the
        loss and matrix written to buffers on the device."""
        if self._train_graph is None:
            dev = self.device
            self._perm = torch.zeros((n_batches, per_rank), dtype=torch.long,
                                     device=dev)
            self._losses = torch.zeros(n_batches, device=dev)
            self._cm = torch.zeros((self.n_class,) * 2, dtype=torch.long,
                                   device=dev)

            def body(slot):
                i = slot.view(1)
                idx = self._perm.index_select(0, i).view(-1)
                loss, cm = self.train_step(
                    *(t.index_select(0, idx) for t in self._staged_train))
                self._losses.index_copy_(0, i, loss.view(1))
                self._cm.add_(cm)

            self._train_graph = StepGraph(
                body, dev, "train step",
                generators=(self.aug_generator, self.dropout_generator),
                keep=(self.model,), optimizer=self.optimizer,
                warmup=11 if self.mesh else 3)
        return self._train_graph

    def _progress_line(self, epoch, timer, done_img, done, total, mf1,
                       loss) -> None:
        el = timer.elapsed()
        rem = (total - done) + total * max(self.max_epochs - 1 - epoch, 0)
        self.logger.write(
            f"Is_training: True. [{epoch},{done}][{total}], "
            f"imps: {done_img / max(el, 1e-9):.2f}, "
            f"est: {el / max(done, 1) * rem / 3600.0:.4f}h, "
            f"G_loss: {loss:.5f}, running_mf1: {mf1:.5f}\n")

    def _scan_epoch(self, epoch: int, timer: Timer):
        """The staged epoch (engine.py:327-384): ``log_chunks`` chunks of
        steps, a progress line after each but the last. Returns (matrix,
        per-batch losses, pairs)."""
        if self._staged_train is None:
            self._stage_train()
        bs = self.args.batch_size
        rank, world = self.mesh.shard if self.mesh else (0, 1)
        per = bs // world
        n_batches = self._staged_n // bs
        cm = torch.zeros((self.n_class,) * 2, dtype=torch.long,
                         device=self.device)
        if n_batches == 0:
            return cm, torch.zeros(0), 0
        perm = self._epoch_perm(epoch, n_batches, bs)
        step = self._scan_step(n_batches, per)
        self._perm.copy_(torch.from_numpy(
            np.ascontiguousarray(perm[:, rank * per:(rank + 1) * per])))
        self._cm.zero_()
        step.reset()
        chunks = max(int(getattr(self.args, "log_chunks", 1) or 1), 1)
        chunk = max(1, -(-n_batches // chunks))
        for start in range(0, n_batches, chunk):
            end = min(start + chunk, n_batches)
            for _ in range(start, end):
                step()
            if end < n_batches:  # the epoch line follows the last chunk
                self._progress_line(
                    epoch, timer, end * bs, end, n_batches,
                    cm2score(self._cm.cpu().numpy())["mf1"],
                    self._losses[:end].mean().item())
        return self._cm.clone(), self._losses.clone(), n_batches * bs

    def train_one_epoch(self, epoch: int) -> dict:
        lr = epoch_lr(self.args.lr, epoch, self.args.lr_policy,
                      self.max_epochs)
        set_learning_rate(self.optimizer, lr)
        self.logger.write(f"lr: {lr:.7f}\n")
        profile_dir = getattr(self.args, "profile_dir", None)
        prof = None
        if profile_dir and epoch == 0 and self.main:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
        timer = Timer()
        n_data = self.mesh.n_data if self.mesh else 1
        if self.scan and self.args.batch_size % n_data == 0:  # scan_ok
            cm_dev, losses, n_img = self._scan_epoch(epoch, timer)
        else:
            cm_dev, losses, n_img = self._loader_epoch(epoch, timer)
        scores = cm2score(cm_dev.cpu().numpy())
        imps = timer.images_per_sec(n_img)
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            self.logger.write(f"profiler trace written to {profile_dir}\n")
        self.last_epoch_losses = losses
        mean_loss = losses.mean().item() if len(losses) else 0.0
        self.logger.write(
            f"Is_training: True. Epoch {epoch} / {self.max_epochs - 1}, "
            f"epoch_mF1= {scores['mf1']:.5f}, imps: {imps:.2f}, "
            f"G_loss: {mean_loss:.5f}\n")
        self.train_acc_curve.append(scores["mf1"])
        if self.main:
            np.save(os.path.join(self.checkpoint_dir, "train_acc.npy"),
                    np.asarray(self.train_acc_curve, np.float32))
        return {**scores, "imps": imps, "loss": mean_loss}

    def _loader_epoch(self, epoch: int, timer: Timer):
        """The per-batch epoch: the loader's batches copied to the device
        one by one. Returns (matrix, per-batch losses, pairs)."""
        log_every = int(getattr(self.args, "log_every", 100) or 0)
        vis_every = int(getattr(self.args, "vis_train_every", 0) or 0)
        n_batches = len(self.train_loader)
        cm_dev = torch.zeros((self.n_class,) * 2, dtype=torch.long,
                             device=self.device)
        losses, n_img = [], 0
        for bi, batch in enumerate(self.train_loader):
            loss, cm = self.train_step(*self._to_device(batch))
            cm_dev += cm
            losses.append(loss)
            n_img += self.train_loader.real_rows(bi)
            if log_every and (bi + 1) % log_every == 0:
                self._progress_line(
                    epoch, timer, n_img, bi + 1, n_batches,
                    cm2score(cm_dev.cpu().numpy())["mf1"],
                    torch.stack(losses).mean().item())
            if vis_every and (bi + 1) % vis_every == 0 and self.main:
                self._save_train_vis(batch, epoch, bi + 1)
        losses = torch.stack(losses) if losses else torch.zeros(0)
        return cm_dev, losses, n_img

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

    def _eval_cm(self, a_u8, b_u8, l_u8, spatial: bool = False
                 ) -> torch.Tensor:
        """The confusion matrix of the eval forward (running statistics;
        K1 without saves) on one uint8 batch on the device (whole images);
        with ``spatial`` on a grid, the forward on the space rank's rows and
        the predictions gathered over the rows."""
        a, b, label = augment_pairs(a_u8, b_u8, l_u8, train=False,
                                    dtype=self.dtype)
        with space.grid(self.mesh, spatial):
            a, b = space.shard_rows(self.model, a, b)
            pred = space.gather_rows(final_logits(self.model(a, b)).argmax(-1))
        return batch_confusion_matrix(pred, label, self.n_class)

    @torch.inference_mode()
    def validate(self, epoch: int) -> dict:
        """Every validation batch through ``_eval_cm``; under
        ``--scan_epoch`` the full batches, staged once, as replays of a
        captured forward (``EvalScan``) and the ragged tail per batch. The
        summed matrix stays on ``self.confusion_matrix``."""
        cm = torch.zeros((self.n_class,) * 2, dtype=torch.long,
                         device=self.device)
        batches = self.val_loader
        if self.scan:
            if self._val_tail is None:
                stack, self._val_tail = stage_full_batches(
                    self.val_loader, ("a", "b", "label"), self.device)
                if stack is not None:
                    self._val_scan = EvalScan(self._eval_cm, stack,
                                              self.n_class, self.device)
            if self._val_scan is not None:
                cm += self._val_scan()
            batches = self._val_tail
        for batch in batches:
            cm += self._eval_cm(*self._to_device(batch))
        if self.mesh:  # filler rows carry label 255, which no class counts
            reduce_sum_(cm, self.mesh.data_group)
        self.confusion_matrix = cm.cpu().numpy()
        scores = cm2score(self.confusion_matrix)
        self.logger.write(
            f"Is_training: False. Epoch {epoch} / {self.max_epochs - 1}, "
            f"epoch_mF1= {scores['mf1']:.5f}\n")
        self.logger.write(" ".join(f"{k}: {v:.5f}" for k, v in scores.items())
                          + "\n\n")
        self.val_acc_curve.append(scores["mf1"])
        if self.main:
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
        for name, state in meta.get("generator_states", {}).items():
            getattr(self, f"{name}_generator").set_state(state)
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
            if self.main:
                save_checkpoint(
                    self.checkpoint_dir, self.model.state_dict(),
                    best_val_acc=val_acc, best_epoch_id=epoch, epoch_id=epoch,
                    optimizer_state=self.optimizer.state_dict(),
                    generator_states={
                        "aug": self.aug_generator.get_state(),
                        "dropout": self.dropout_generator.get_state()})
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
