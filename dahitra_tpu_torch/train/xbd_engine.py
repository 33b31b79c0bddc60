"""XBDTrainer and GANTrainer: the xBD training engines.

Counterpart of dahitra_tpu/train/xbd_engine.py (``XBDTrainer`` :62-445 and
``GANTrainer`` :446-574; the reference's xBD_code/train.py:247-470,
train_loc.py, train_adapt.py and train_GAN.py). Tasks:

  * ``damage``: each step the uint8 batch goes to the device and is
    augmented there (``data/xbd_augment.py``, with ``--elastic`` the gated
    elastic jitter), the train-mode forward (K1 with saves for DAHiTra's
    decoder stacks), ``xbd_damage_loss`` on the fp32 logits (per-channel
    ComboLoss{dice: 1, focal: 8} weighted [0.05, 0.2, 0.8, 0.7, 0.4]),
    backward (K2), the global-norm clip at 0.999 BEFORE the step and AdamW
    (lr 1e-4, weight decay 1e-6); the learning rate follows the xBD
    multistep schedule (gamma 0.6, each drop an epoch after its milestone);
  * ``loc``: the pre image alone (the first 3 channels),
    ``xbd_localization_loss`` (ComboLoss{dice: 1, focal: 10}) on the one
    logit, lr 1.5e-4; validation scores the localization dice alone;
  * ``adapt``: the 4 merged channels (the caller loads the masks with
    ``merge_34``), ``xbd_adapt_loss``, lr 1.5e-4; the damage scores over 3
    classes;
  * ``hrnet``: Dual-HRNet (``dual_hrnet``, ``dual_hrnet_fpn``), whose
    {"loc", "cls"} heads at 1/4 resolution go to ``dual_hrnet_loss``
    (:230-231), lr 1.5e-4; validation resizes both heads bilinearly to the
    masks and scores the loc head's softmax (channel 1) beside the cls
    head's sigmoids (:253-261);
  * ``GANTrainer`` (task ``gan``): the damage model against the mask
    ``Discriminator``, which has its own AdamW (1e-4, weight decay 1e-6, no
    clip), seeded from seed + 99, and updates before the generator at every
    batch index i of the epoch with i % 8 == 0 on
    ``xbd_gan_discriminator_loss``; the generator step adds the adversarial
    term of ``xbd_gan_generator_loss``. Its BatchNorm rules are the JAX
    step's (:499-553): the generator forward of the discriminator step and
    the discriminator pass of the generator step run in train mode with
    their running-statistics updates thrown away (``_running_stats_kept``);
    the discriminator step's fake pass takes the running statistics its
    real pass left. ``best_ckpt_D.pt`` is saved beside ``best_ckpt.pt`` and
    resumed.

``--scan_epoch`` (``XBDTrainer``, every task above; xbd_engine.py:310-365)
trains the epoch in chunks, in JAX's order: ``_scan_chunks`` draws the
epoch's permutation (``seed * 100003 + epoch``), drops the ragged last
batch and cuts ``--scan_chunk_batches`` batches a chunk (by default
ceil(256 / batch size)); each chunk is copied into buffers on the device and
each of its steps is one replay of a CUDA graph that selects the step's
batch and runs ``train_step`` (``train/graph.py``; AdamW ``capturable``),
eagerly on the CPU. A progress line follows each chunk but the last.
``GANTrainer``'s epoch has no such path in JAX (:555-574), and
``--scan_epoch`` changes nothing there. Validation is per batch, as in JAX.

``validate``: per image the localization dice at threshold ``loc_thr``
(0.3), and per damage class tp / fp / fn over the ground-truth building
pixels of the damage argmax gated by the predicted footprint; the xView2
score 0.3 * dice + 0.7 * harmonic F1, and beside it the harmonic F1 over the
classes present (``damage_f1_present``), as the JAX package reports it. The
masking is the intended ``loc_gt > 0`` (the JAX package's documented
divergence from the reference's row selection). ``evaluate_and_checkpoint``
writes ``best_ckpt.pt`` (``core/checkpoint.py``) when the score improves; a
``best_ckpt.pt`` already in the checkpoint directory resumes the run after
its epoch, optimizer included; ``warm_start_from`` copies the size-matched
weights of another checkpoint (train.py:446-462).

The weights start from ``nn/init.py`` ``init_random`` with identity BN
statistics, the counterpart of the flax initializer the JAX trainer starts
from, then ``zoo_ctor_init`` as the JAX trainer applies
``zoo_ctor_init_variables`` (:96-101): the ResNet34 UNets' decoder convs
``conv6``-``conv10`` and ``res`` head get Kaiming draws, the DAHiTra, BIT
and Dual-HRNet models have no such module. Dropout masks (the
``xbd_unet_change_transformer_bit`` transformer's) come from the trainer's
``dropout_generator`` on the device, seeded from seed + 1. The losses run
with no ignore value, so the loader drops a ragged last batch.

With a ``mesh`` (``core/mesh.py``) the trainers run as ``CDTrainer`` does
under one: DDP on the model, the rank's rows of each batch, global
BatchNorm statistics, augmentation draws of the global batch, the loss of
the gathered logits and masks, dropout masks from a generator per rank (seed
+ 1 + 1000 rank), and only rank 0 writing the log and checkpoints. A
``--batch_size`` that is not a multiple of the world size is refused, as
the JAX trainer refuses it (xbd_engine.py:113-123). Validation batches are
padded to the mesh's data axis with a ``valid`` vector: the filler enters no
dice and no tp / fp / fn count. On a (data, space) grid the ranks of a data
row take the same samples, replicated in the epoch loops (xbd_engine.py:290;
BatchNorm and the gathers over the data group), and ``train_step`` /
``eval_step`` with ``spatial=True`` run the row-sharded step as
``CDTrainer.train_step`` does (``nn/space.py``): the whole images augmented
with the data row's draws, the rank's rows through the model, the fp32
logits gathered over rows, then samples, before the loss on the gathered
masks. The GAN's discriminator has a DDP of its own,
used only in its update; the generator step runs the bare discriminator,
whose parameters then take no gradient.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict

import numpy as np
import torch

from dahitra_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from dahitra_tpu_torch.core.mesh import (all_gather_rows, reduce_sum_,
                                         wrap_ddp)
from dahitra_tpu_torch.data.loader import BatchLoader
from dahitra_tpu_torch.data.xbd_augment import augment_xbd
from dahitra_tpu_torch.losses.combo import (dual_hrnet_loss, xbd_adapt_loss,
                                            xbd_damage_loss,
                                            xbd_gan_discriminator_loss,
                                            xbd_gan_generator_loss,
                                            xbd_localization_loss)
from dahitra_tpu_torch.models.discriminator import Discriminator
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.nn import space
from dahitra_tpu_torch.nn.blocks import resize_bilinear, set_dropout_generator
from dahitra_tpu_torch.nn.init import init_random, zoo_ctor_init
from dahitra_tpu_torch.train.graph import StepGraph
from dahitra_tpu_torch.train.optim import (XBD_MULTISTEP_MILESTONES, epoch_lr,
                                           make_optimizer, set_learning_rate)
from dahitra_tpu_torch.utils import Logger, Timer, disable_tf32, resolve_device

TASKS = ("damage", "loc", "adapt", "hrnet")
N_DAMAGE = 4
# The recipe's loss of each task on fp32 logits (Dual-HRNet's dict of
# heads) and the float masks.
_LOSSES = {"damage": xbd_damage_loss, "adapt": xbd_adapt_loss,
           "hrnet": dual_hrnet_loss,
           "loc": lambda logits, masks: xbd_localization_loss(
               logits, masks[..., 0])}


@contextlib.contextmanager
def _running_stats_kept(model: torch.nn.Module):
    """Train-mode passes inside the block leave every BatchNorm's running
    statistics as they were (a flax apply whose batch_stats are thrown
    away)."""
    kept = {k: v.clone() for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}
    try:
        yield
    finally:
        bufs = dict(model.named_buffers())
        with torch.no_grad():
            for k, v in kept.items():
                bufs[k].copy_(v)


def dice_per_image(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """2 |A n B| / (|A| + |B|) per image of (B, H, W) bools; empty against
    empty is 1 (xBD_code/utils.py:124-154)."""
    p = pred.reshape(pred.shape[0], -1).float()
    g = gt.reshape(gt.shape[0], -1).float()
    inter = (p * g).sum(1)
    s = p.sum(1) + g.sum(1)
    return torch.where(s == 0, torch.ones_like(s), 2.0 * inter / s.clamp_min(1.0))


def damage_counts(probs: torch.Tensor, masks: torch.Tensor,
                  lbl: torch.Tensor, thr: float, valid=None):
    """(dice (B,), tp, fp, fn (4,)) of one batch: ``probs`` (B, H, W, 5)
    sigmoids, ``masks`` (B, H, W, 5), ``lbl`` (B, H, W) the damage class of
    each pixel (val variant, 0-3); samples whose ``valid`` (B,) is False
    (padding filler) enter no count."""
    loc_gt = masks[..., 0] > 0
    loc_pred = probs[..., 0] > thr
    dices = dice_per_image(loc_pred, loc_gt)
    dmg_pred = probs[..., 1:].argmax(-1) * loc_pred
    gt_px = loc_gt if valid is None else loc_gt & valid[:, None, None]
    counts = torch.zeros((3, N_DAMAGE), dtype=torch.long, device=probs.device)
    for c in range(masks.shape[-1] - 1):
        p_c = (dmg_pred == c) & gt_px
        t_c = (lbl == c) & gt_px
        counts[0, c] = (p_c & t_c).sum()
        counts[1, c] = (p_c & ~t_c).sum()
        counts[2, c] = (~p_c & t_c).sum()
    return dices, counts[0], counts[1], counts[2]


def xview2_scores(dice: float, tp, fp, fn) -> Dict[str, object]:
    """The xView2 score from the loc dice and the per-class counts
    (train.py:279-287), and the harmonic F1 over the classes present."""
    tp, fp, fn = (np.asarray(v, np.int64) for v in (tp, fp, fn))
    n = len(tp)
    f1_sc = 2 * tp / np.maximum(2 * tp + fp + fn, 1)
    f1 = float(n) / np.sum(1.0 / (f1_sc + 1e-6))
    present = (tp + fn) > 0
    f1_present = (float(present.sum()) / np.sum(1.0 / (f1_sc[present] + 1e-6))
                  if present.any() else 0.0)
    return {"score": float(0.3 * dice + 0.7 * f1), "dice_loc": float(dice),
            "damage_f1": float(f1), "damage_f1_present": float(f1_present),
            "classes_present": int(present.sum()),
            "class_f1": f1_sc.tolist()}


class XBDTrainer:
    # --scan_epoch takes the chunked epoch (the GAN's epoch has none)
    has_scan_path = True

    def __init__(self, args, train_arrays: Dict[str, np.ndarray],
                 val_arrays: Dict[str, np.ndarray], device="cuda",
                 task: str = "damage", mesh=None):
        if task not in TASKS:
            raise ValueError(f"unknown xBD task {task!r}")
        rank, world = mesh.shard if mesh else (0, 1)
        if args.batch_size % world:
            raise ValueError(
                f"--batch_size {args.batch_size} must be a multiple of the "
                f"mesh data axis ({world}) for xBD training: "
                f"pad filler has no ignore value in the ComboLoss recipes "
                f"and would skew gradients")
        self.args = args
        self.task = task
        self.elastic = bool(getattr(args, "elastic", False))
        self.checkpoint_dir = args.checkpoint_dir
        self.max_epochs = args.max_epochs
        self.thr = getattr(args, "loc_thr", 0.3)
        self.mesh = mesh
        self.main = mesh is None or mesh.is_main
        self.device = resolve_device(mesh.device if mesh else device)
        disable_tf32()
        self.dtype = torch.bfloat16 if getattr(args, "bf16", False) \
            else torch.float32
        seed = getattr(args, "seed", 0)
        self.logger = Logger(os.path.join(self.checkpoint_dir, "log.txt"),
                             enabled=self.main)

        gen = torch.Generator().manual_seed(seed)
        self.model = define_g(args.net_G, dtype=self.dtype,
                              img_size=args.img_size, generator=gen)
        init_random(self.model, gen, running_stats=False)
        zoo_ctor_init(self.model, gen)
        warm = getattr(args, "warm_start_from", None)
        if warm:
            self.warm_start_from(warm)
        self.model.to(self.device)
        self.scan = bool(getattr(args, "scan_epoch", False)) \
            and self.has_scan_path
        # the module each step runs: DDP over the ranks, or the model
        self.net = wrap_ddp(self.model, mesh, capture=self.scan)
        self.base_lr = args.lr if args.lr else (
            1e-4 if task == "damage" else 1.5e-4)
        if self.scan and mesh and mesh.backend == "gloo" \
                and self.device.type == "cuda":
            raise ValueError(
                "--scan_epoch: gloo stages collectives on CUDA tensors "
                "through host memory, which a CUDA graph cannot capture; "
                "run the ranks under NCCL")
        self.optimizer = make_optimizer(
            self.model.parameters(), self.base_lr, weight_decay=1e-6,
            clip_norm=0.999, capturable_on=self.device
            if self.scan and self.device.type == "cuda" else None)
        self.aug_generator = torch.Generator(device=self.device)
        self.aug_generator.manual_seed(seed)
        self.dropout_generator = torch.Generator(device=self.device)
        self.dropout_generator.manual_seed(seed + 1 + 1000 * rank)
        set_dropout_generator(self.model, self.dropout_generator)

        shard = mesh.shard if mesh else None
        self.train_loader = BatchLoader(train_arrays, args.batch_size,
                                        shuffle=True, seed=seed,
                                        drop_last=True, shard=shard)
        self.val_loader = BatchLoader(
            val_arrays, getattr(args, "val_batch_size", args.batch_size),
            pad_to_multiple=world if world > 1 else None, shard=shard)
        self._train_arrays = train_arrays
        self._chunk = self._chunk_step = None  # the scan path's buffers, step
        self.last_epoch_losses = None  # each batch's loss, last epoch
        self.best_score = 0.0
        self.epoch_to_start = 0
        self._maybe_resume()

    def _maybe_resume(self) -> None:
        """Resume a run from this checkpoint directory's ``best_ckpt.pt``:
        weights, optimizer, the next epoch and the best score (the JAX
        trainer's full-state resume)."""
        restored = load_checkpoint(self.checkpoint_dir, "best_ckpt")
        if restored is None:
            return
        state_dict, meta = restored
        self.model.load_state_dict(state_dict)
        if "optimizer_G_state_dict" in meta:
            self.optimizer.load_state_dict(meta["optimizer_G_state_dict"])
        self.epoch_to_start = int(meta.get("epoch_id", -1)) + 1
        self.best_score = float(meta.get("best_val_acc", 0.0))
        self.logger.write(
            f"resumed best_ckpt: epoch_to_start={self.epoch_to_start}, "
            f"best_score={self.best_score:.5f}\n")

    def warm_start_from(self, ckpt: str) -> None:
        """Copy the weights of ``ckpt`` (a checkpoint directory's
        ``best_ckpt.pt``, or a ``.pt`` file) whose shapes match the model's
        (train.py:446-462); the others keep their values."""
        d, name = (os.path.dirname(ckpt), os.path.basename(ckpt)[:-3]) \
            if ckpt.endswith(".pt") else (ckpt, "best_ckpt")
        restored = load_checkpoint(d or self.checkpoint_dir, name)
        if restored is None:
            self.logger.write(f"warm start: no checkpoint at {ckpt}\n")
            return
        src = restored[0]
        own = self.model.state_dict()
        take = {k: v for k, v in src.items()
                if k in own and tuple(v.shape) == tuple(own[k].shape)}
        self.model.load_state_dict({**own, **take})
        self.logger.write(f"warm start: copied {len(take)} leaves, "
                          f"kept {len(own) - len(take)}\n")

    def _to_device(self, batch):
        return tuple(torch.from_numpy(batch[k]).to(self.device)
                     for k in ("img_pre", "img_post", "msk", "lbl_msk"))

    def _forward(self, img6: torch.Tensor, train: bool = False, net=None):
        """The model (or ``net``, its DDP) on the task's input: the pre
        image for ``loc``, the 6-channel pair otherwise."""
        return (net or self.model)(
            img6[..., :3] if self.task == "loc" else img6, train=train)

    def _augment(self, pre, post, msk, lbl):
        return augment_xbd(pre, post, msk, lbl, self.aug_generator,
                           train=True, dtype=self.dtype, elastic=self.elastic,
                           shard=self.mesh.shard if self.mesh else None)

    def train_step(self, pre, post, msk, lbl, spatial: bool = False
                   ) -> torch.Tensor:
        """One optimizer step on a uint8 batch already on the device (the
        rank's data shard under a mesh, whole tiles); returns the global
        batch's loss, a device tensor. With ``spatial`` on a grid, the
        forward runs on the space rank's rows."""
        with space.grid(self.mesh, spatial):
            img6, masks, _ = self._augment(pre, post, msk, lbl)
            img6, = space.shard_rows(self.model, img6)
            out = self._forward(img6, True, self.net)
            out = ({k: space.gather_batch(v, self.mesh)
                    for k, v in out.items()} if isinstance(out, dict)
                   else space.gather_batch(out.float(), self.mesh))
            loss = _LOSSES[self.task](out, all_gather_rows(
                masks, self.mesh.data_group if self.mesh else None))
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.inference_mode()
    def eval_step(self, pre, post, msk, lbl, valid=None,
                  spatial: bool = False):
        """(dice (B,), tp, fp, fn (4,)) of one uint8 batch on the device;
        the counts are 0 for ``loc``; filler samples (``valid`` False) enter
        no count. With ``spatial`` on a grid, the forward runs on the space
        rank's rows and its logits are gathered over the rows."""
        img6, masks, lbl_i = augment_xbd(pre, post, msk, lbl, train=False,
                                         dtype=self.dtype)
        with space.grid(self.mesh, spatial):
            out = self._forward(*space.shard_rows(self.model, img6))
            out = ({k: space.gather_rows(v) for k, v in out.items()}
                   if isinstance(out, dict) else space.gather_rows(out))
        if isinstance(out, dict):
            h, w = masks.shape[1], masks.shape[2]
            loc, cls = (resize_bilinear(out[k].float(), h, w)
                        for k in ("loc", "cls"))
            probs = torch.cat([torch.softmax(loc, -1)[..., 1:2],
                               torch.sigmoid(cls)], -1)
        else:
            probs = torch.sigmoid(out.float())
        if self.task == "loc":
            zero = torch.zeros(N_DAMAGE, dtype=torch.long, device=probs.device)
            loc = dice_per_image(probs[..., 0] > self.thr, masks[..., 0] > 0)
            return loc, zero, zero, zero
        return damage_counts(probs, masks, lbl_i, self.thr, valid)

    def _scan_chunks(self, epoch: int):
        """Host chunks of stacked shuffled batches (k, B, ...) per key, in
        JAX's order (xbd_engine.py:310-329): ``drop_last``, chunks of
        ``scan_chunk_batches`` batches or ceil(256 / B)."""
        bs = self.args.batch_size
        n = len(next(iter(self._train_arrays.values())))
        n_batches = n // bs  # drop_last, like the loader
        rng = np.random.default_rng(
            getattr(self.args, "seed", 0) * 100003 + epoch)
        order = rng.permutation(n)[: n_batches * bs]
        chunk_b = max(1, int(getattr(self.args, "scan_chunk_batches", 0))
                      or min(n_batches, max(1, (256 + bs - 1) // bs)))
        keys = ("img_pre", "img_post", "msk", "lbl_msk")
        for start in range(0, n_batches, chunk_b):
            idx = order[start * bs:(start + chunk_b) * bs]
            k = len(idx) // bs
            yield tuple(
                self._train_arrays[key][idx].reshape(
                    (k, bs) + self._train_arrays[key].shape[1:])
                for key in keys)

    def _chunk_graph(self) -> StepGraph:
        """The captured step over the chunk buffers (built once, after the
        first chunk is copied in): the ``slot``-th batch of the chunk
        through ``train_step``, its loss written to a buffer on the
        device."""
        if self._chunk_step is None:
            self._chunk_losses = torch.zeros(self._chunk[0].shape[0],
                                             device=self.device)

            def body(slot):
                i = slot.view(1)
                loss = self.train_step(
                    *(t.index_select(0, i)[0] for t in self._chunk))
                self._chunk_losses.index_copy_(0, i, loss.view(1))

            self._chunk_step = StepGraph(
                body, self.device, "xBD train step",
                generators=(self.aug_generator, self.dropout_generator),
                keep=(self.model,), optimizer=self.optimizer,
                warmup=11 if self.mesh else 3)
        return self._chunk_step

    def _scan_epoch(self, epoch: int, timer: Timer) -> list:
        """The chunked epoch (xbd_engine.py:338-365): each chunk (the
        rank's rows of its batches) copied into buffers on the device sized
        by the first, then one step per batch. Returns each batch's loss."""
        rank, world = self.mesh.shard if self.mesh else (0, 1)
        bs = self.args.batch_size
        rows = slice(rank * bs // world, (rank + 1) * bs // world)
        n_total = len(self._train_arrays["img_pre"]) // bs
        losses = []
        for chunk in self._scan_chunks(epoch):
            chunk = [torch.from_numpy(np.ascontiguousarray(c[:, rows]))
                     for c in chunk]
            if self._chunk is None:
                self._chunk = [torch.empty(c.shape, dtype=c.dtype,
                                           device=self.device) for c in chunk]
            k = chunk[0].shape[0]
            for buf, c in zip(self._chunk, chunk):
                buf[:k].copy_(c)
            step = self._chunk_graph()
            step.reset()
            for _ in range(k):
                step()
            losses += self._chunk_losses[:k].tolist()
            if len(losses) < n_total:  # mid-epoch progress line
                self.logger.write(
                    f"epoch {epoch} [{len(losses)}/{n_total}] "
                    f"imps: {len(losses) * bs / max(timer.elapsed(), 1e-9):.2f}"
                    f", Loss {float(np.mean(losses)):.4f}\n")
        return losses

    def train_one_epoch(self, epoch: int) -> dict:
        lr = epoch_lr(self.base_lr, epoch, "multistep", self.max_epochs,
                      milestones=XBD_MULTISTEP_MILESTONES, gamma=0.6,
                      after_epoch_step=True)
        set_learning_rate(self.optimizer, lr)
        timer = Timer()
        if self.scan:
            losses = torch.tensor(self._scan_epoch(epoch, timer))
            n_img = len(losses) * self.args.batch_size
        else:
            losses, n_img = [], 0
            for bi, batch in enumerate(self.train_loader):
                losses.append(self.train_step(*self._to_device(batch)))
                n_img += self.train_loader.real_rows(bi)
            losses = torch.stack(losses) if losses else torch.zeros(0)
        self.last_epoch_losses = losses
        mean_loss = losses.mean().item() if len(losses) else 0.0
        imps = timer.images_per_sec(n_img)
        self.logger.write(f"epoch: {epoch}; lr {lr:.7f}; Loss {mean_loss:.4f}; "
                          f"imps: {imps:.2f}\n")
        return {"loss": mean_loss, "imps": imps, "pairs": n_img}

    def validate(self) -> dict:
        dices, counts = [], []
        n_dmg = N_DAMAGE
        for batch in self.val_loader:
            # adapt merges classes 3 and 4: loc and 3 damage channels
            n_dmg = batch["msk"].shape[-1] - 1
            valid = torch.from_numpy(batch["valid"]).to(self.device) \
                if "valid" in batch else None
            d, tp, fp, fn = self.eval_step(*self._to_device(batch), valid)
            if valid is not None:  # every rank's dice, filler dropped
                data = self.mesh.data_group
                d = all_gather_rows(d, data)[
                    all_gather_rows(valid.byte(), data) > 0]
            dices.append(d)
            counts.append(torch.stack([tp, fp, fn]))
        if self.mesh and counts:
            counts = [reduce_sum_(torch.stack(counts).sum(0),
                                  self.mesh.data_group)]
        dice = torch.cat(dices).mean().item() if dices else 0.0
        if self.task == "loc":
            self.logger.write(f"Val Dice: {dice:.5f}\n")
            return {"score": dice, "dice_loc": dice}
        tp, fp, fn = (torch.stack(counts).sum(0).cpu().numpy() if counts
                      else np.zeros((3, N_DAMAGE), np.int64))[:, :n_dmg]
        scores = xview2_scores(dice, tp, fp, fn)
        self.logger.write(
            f"Val Score: {scores['score']:.5f}, Dice: {dice:.5f}, "
            f"F1: {scores['damage_f1']:.5f}, F1_present: "
            f"{scores['damage_f1_present']:.5f} "
            f"({scores['classes_present']}/{n_dmg} classes), "
            + ", ".join(f"F1_{c}: {v:.5f}"
                        for c, v in enumerate(scores["class_f1"])) + "\n")
        return scores

    def evaluate_and_checkpoint(self, epoch: int) -> dict:
        scores = self.validate()
        if scores["score"] > self.best_score:
            self.best_score = scores["score"]
            if self.main:
                save_checkpoint(self.checkpoint_dir, self.model.state_dict(),
                                best_val_acc=self.best_score,
                                best_epoch_id=epoch, epoch_id=epoch,
                                optimizer_state=self.optimizer.state_dict())
        self.logger.write(
            f"score: {scores['score']}\tscore_best: {self.best_score}\n")
        return scores

    def train_models(self, eval_every: int = 2) -> list:
        """Every remaining epoch: train, and every ``eval_every``-th validate
        and gate the checkpoint. Returns each epoch's train line, with the
        validation scores where it validated."""
        history = []
        for epoch in range(self.epoch_to_start, self.max_epochs):
            out = self.train_one_epoch(epoch)
            if epoch % eval_every == 0:
                out["val"] = self.evaluate_and_checkpoint(epoch)
            history.append(out)
        return history


class GANTrainer(XBDTrainer):
    """The adversarial damage trainer (train_GAN.py:310-395; module
    docstring): ``XBDTrainer`` on the damage task plus the mask
    ``Discriminator`` and its own AdamW."""

    # The discriminator updates at the epoch's batch indices i % 8 == 0.
    disc_every = 8
    has_scan_path = False

    def __init__(self, args, train_arrays, val_arrays, device="cuda",
                 effective_gan: bool = False, mesh=None):
        super().__init__(args, train_arrays, val_arrays, device=device,
                         task="damage", mesh=mesh)
        self.effective_gan = effective_gan
        gen = torch.Generator().manual_seed(getattr(args, "seed", 0) + 99)
        self.disc = init_random(Discriminator(5, dtype=self.dtype), gen,
                                running_stats=False).to(self.device)
        # the discriminator update's module, which runs it twice before one
        # backward (every parameter used); the generator step runs the bare
        # discriminator (no parameter of it takes a gradient there)
        self.d_net = wrap_ddp(self.disc, mesh, static_graph=False)
        self.d_optimizer = make_optimizer(self.disc.parameters(), 1e-4,
                                          weight_decay=1e-6)
        restored = load_checkpoint(self.checkpoint_dir, "best_ckpt_D")
        if restored is not None:
            self.disc.load_state_dict(restored[0])
            if "optimizer_G_state_dict" in restored[1]:
                self.d_optimizer.load_state_dict(
                    restored[1]["optimizer_G_state_dict"])
            self.logger.write("resumed best_ckpt_D (discriminator)\n")

    def evaluate_and_checkpoint(self, epoch: int) -> dict:
        prev_best = self.best_score
        scores = super().evaluate_and_checkpoint(epoch)
        if scores["score"] > prev_best and self.main:  # G was just saved
            save_checkpoint(self.checkpoint_dir, self.disc.state_dict(),
                            name="best_ckpt_D", epoch_id=epoch,
                            optimizer_state=self.d_optimizer.state_dict())
        return scores

    def gan_step(self, pre, post, msk, lbl, update_disc: bool):
        """One step on a uint8 batch on the device: with ``update_disc``
        first the discriminator's (on the generator's detached train-mode
        logits, whose BN updates are thrown away), then the generator's
        (the discriminator's pass in train mode, its BN updates thrown
        away). Returns (generator loss, discriminator loss), device
        tensors."""
        with space.grid(self.mesh):  # replicated on a grid
            return self._gan_step(pre, post, msk, lbl, update_disc)

    def _gan_step(self, pre, post, msk, lbl, update_disc: bool):
        def gather(t):
            return all_gather_rows(t, self.mesh.data_group if self.mesh
                                   else None)

        img6, masks, _ = self._augment(pre, post, msk, lbl)
        d_loss = torch.zeros((), device=img6.device)
        if update_disc:
            with torch.no_grad(), _running_stats_kept(self.model):
                fake = self.model(img6, train=True)
            real_logits = self.d_net(masks.to(self.dtype), train=True)
            fake_logits = self.d_net(fake, train=True)
            d_loss = xbd_gan_discriminator_loss(
                gather(real_logits.float()), gather(fake_logits.float()))
            self.d_optimizer.zero_grad(set_to_none=True)
            d_loss.backward()
            self.d_optimizer.step()
        logits = self.net(img6, train=True).float()
        fake_in = logits if self.effective_gan else logits.detach()
        self.disc.requires_grad_(False)
        try:
            with _running_stats_kept(self.disc):
                fake_logits = self.disc(fake_in.to(self.dtype), train=True)
            loss = xbd_gan_generator_loss(
                gather(logits), gather(masks), gather(fake_logits.float()),
                effective_gan=self.effective_gan)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        finally:
            self.disc.requires_grad_(True)
        self.optimizer.step()
        return loss.detach(), d_loss.detach()

    def train_step(self, pre, post, msk, lbl) -> torch.Tensor:
        return self.gan_step(pre, post, msk, lbl, False)[0]

    def train_one_epoch(self, epoch: int) -> dict:
        lr = epoch_lr(self.base_lr, epoch, "multistep", self.max_epochs,
                      milestones=XBD_MULTISTEP_MILESTONES, gamma=0.6,
                      after_epoch_step=True)
        set_learning_rate(self.optimizer, lr)
        g_losses, d_losses, n_img = [], [], 0
        timer = Timer()
        for i, batch in enumerate(self.train_loader):
            g, d = self.gan_step(*self._to_device(batch),
                                 update_disc=i % self.disc_every == 0)
            g_losses.append(g)
            d_losses.append(d)
            n_img += self.train_loader.real_rows(i)
        g = torch.stack(g_losses).mean().item() if g_losses else 0.0
        d = torch.stack(d_losses).mean().item() if d_losses else 0.0
        imps = timer.images_per_sec(n_img)
        self.logger.write(f"epoch: {epoch}; lr {lr:.7f}; Loss {g:.4f}; "
                          f"loss_D {d:.4f}; imps: {imps:.2f}\n")
        return {"loss": g, "loss_D": d, "imps": imps, "pairs": n_img,
                "disc_updates": -(-len(g_losses) // self.disc_every)}
