"""The host-free step against the eager one.

Each ``*_steps`` function takes a fresh trainer built with ``--scan_epoch``
(``cd_trainer``, ``xbd_trainer``) and runs epoch 0 of its training set
either through the scan path (``train_one_epoch``: on a card every step is
a CUDA-graph replay, on the CPU the same staged loop eagerly) or as eager
``train_step`` calls on the same batches in the same order (``_epoch_perm``
for ``CDTrainer``, ``_scan_chunks`` for ``XBDTrainer``). Two trainers of one
configuration start from the same weights and generator states, so the two
runs must leave the same bits: each batch's loss, every parameter and
buffer, and the augmentation and dropout generators' states (``state``).
``tests/test_torch_scan.py`` holds them on the CPU, ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 20 on the card, where ``time_steps`` and
``profile_replay`` also time the two and count a replay's kernels.

Imports no JAX.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict

import numpy as np
import torch

# Kernel-name fragments (torch.profiler rows) of each hand-written kernel.
KERNEL_ROWS = {
    "k1": ("decoder_stack_fwd_rows_mma<float, false,",
           "decoder_stack_fwd_rows_mma<__nv_bfloat16, false,"),
    "k1_save": ("decoder_stack_fwd_rows_mma<float, true,",
                "decoder_stack_fwd_rows_mma<__nv_bfloat16, true,"),
    "k2": ("decoder_stack_bwd",),
    "k3": ("stats_kernel", "pool_kernel"),
    "k4": ("fused_decoder_prologue", "fused_decoder_rows")}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_pallas(model: torch.nn.Module) -> None:
    """``pallas = True`` on every decoder stack (K4 and the plain-stack
    backward), as a JAX user sets the field."""
    from dahitra_tpu_torch.nn.blocks import TransformerDecoder

    for m in model.modules():
        if isinstance(m, TransformerDecoder):
            m.pallas = True


def cd_trainer(cfg: dict, arrays: Dict[str, np.ndarray], mesh=None,
               pallas: bool = False):
    """A ``CDTrainer`` of ``cfg`` (the CLI's arguments, ``device`` among
    them) with ``--scan_epoch``, training and validating on ``arrays``."""
    from dahitra_tpu_torch.train.engine import CDTrainer

    tr = CDTrainer(argparse.Namespace(**{**cfg, "scan_epoch": True}), arrays,
                   arrays, device=cfg["device"], mesh=mesh)
    if pallas:
        set_pallas(tr.model)
    return tr


def xbd_trainer(cfg: dict, arrays: Dict[str, np.ndarray], task="damage"):
    """An ``XBDTrainer`` of ``cfg`` with ``--scan_epoch``."""
    from dahitra_tpu_torch.train.xbd_engine import XBDTrainer

    return XBDTrainer(argparse.Namespace(**{**cfg, "scan_epoch": True}),
                      arrays, arrays, device=cfg["device"], task=task)


def state(trainer) -> dict:
    """CPU copies of every parameter and buffer and the generators'
    states."""
    return {"params": {k: p.detach().cpu().clone()
                       for k, p in trainer.model.named_parameters()},
            "buffers": {k: b.detach().cpu().clone()
                        for k, b in trainer.model.named_buffers()},
            "generators": {"aug": trainer.aug_generator.get_state(),
                           "dropout": trainer.dropout_generator.get_state()}}


def differing(a: dict, b: dict) -> list:
    """The entries of two ``*_steps`` results whose bits differ."""
    out = [] if torch.equal(a["loss"], b["loss"]) else ["loss"]
    for part in ("params", "buffers", "generators"):
        out += [f"{part}.{k}" for k in a[part]
                if not torch.equal(a[part][k], b[part][k])]
    return out


def _epoch0_lr(trainer) -> None:
    from dahitra_tpu_torch.train.optim import epoch_lr, set_learning_rate

    args = trainer.args
    set_learning_rate(trainer.optimizer, epoch_lr(
        args.lr, 0, args.lr_policy, trainer.max_epochs))


def cd_steps(trainer, graphed: bool) -> dict:
    """Epoch 0 of a ``cd_trainer``: the scan path, or eager ``train_step``s
    in ``_epoch_perm`` order (the ragged last batch dropped)."""
    if graphed:
        trainer.train_one_epoch(0)
        loss, cm = trainer.last_epoch_losses, trainer._cm
    else:
        _epoch0_lr(trainer)
        trainer._stage_train()
        bs = trainer.args.batch_size
        rank, world = trainer.mesh.shard if trainer.mesh else (0, 1)
        per = bs // world
        perm = trainer._epoch_perm(0, trainer._staged_n // bs, bs)
        losses, cm = [], 0
        for row in perm[:, rank * per:(rank + 1) * per]:
            idx = torch.from_numpy(row).to(trainer.device)
            loss, c = trainer.train_step(
                *(t.index_select(0, idx) for t in trainer._staged_train))
            losses.append(loss)
            cm = cm + c
        loss = torch.stack(losses)
    _sync(trainer.device)
    return {"loss": loss.cpu().float(), "cm": cm.cpu(), **state(trainer)}


def xbd_steps(trainer, graphed: bool) -> dict:
    """Epoch 0 of an ``xbd_trainer``: the chunked scan path, or eager
    ``train_step``s over ``_scan_chunks``' batches in order."""
    if graphed:
        trainer.train_one_epoch(0)
        loss = trainer.last_epoch_losses
    else:
        from dahitra_tpu_torch.train.optim import (XBD_MULTISTEP_MILESTONES,
                                                   epoch_lr, set_learning_rate)

        set_learning_rate(trainer.optimizer, epoch_lr(
            trainer.base_lr, 0, "multistep", trainer.max_epochs,
            milestones=XBD_MULTISTEP_MILESTONES, gamma=0.6,
            after_epoch_step=True))
        losses = []
        for chunk in trainer._scan_chunks(0):
            for j in range(chunk[0].shape[0]):
                losses.append(trainer.train_step(
                    *(torch.from_numpy(c[j]).to(trainer.device)
                      for c in chunk)))
        loss = torch.stack(losses) if losses else torch.zeros(0)
    _sync(trainer.device)
    return {"loss": loss.cpu().float(), **state(trainer)}


def _graph(trainer):
    return getattr(trainer, "_train_graph", None) \
        or getattr(trainer, "_chunk_step", None)


def graphed_call(trainer):
    """One more step of a trainer whose scan path ran: a replay of its
    captured step on the first staged batch."""
    g = _graph(trainer)

    def call():
        g.reset()
        g()
    return call


def eager_call(trainer, batch):
    """One more eager ``train_step`` on ``batch`` (device tensors)."""
    return lambda: trainer.train_step(*batch)


def time_steps(call, device: torch.device, reps: int = 8) -> dict:
    """``reps`` warm calls, each on the host clock between synchronizations
    (one call first to warm up): the median and the range in ms."""
    call()
    _sync(device)
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def profile_replay(call, call_ms: float) -> dict:
    """torch.profiler over one call: the device-busy time (kernel rows),
    the idle share against ``call_ms`` and each hand-written kernel's
    launches (``KERNEL_ROWS``) in the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the first window warms the tracer
        call()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("Optimizer.")]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    counts = {k: sum(e.count for e in rows if any(f in e.key for f in frags))
              for k, frags in KERNEL_ROWS.items()}
    return {"device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / call_ms),
            "kernel_rows": counts, "kernels": sum(e.count for e in rows)}


def first_batch(trainer) -> tuple:
    """The first staged batch of a ``cd_trainer`` whose scan path ran."""
    bs = trainer.args.batch_size
    idx = torch.arange(bs, device=trainer.device)
    return tuple(t.index_select(0, idx) for t in trainer._staged_train)


def scan_steps(mesh, cfg: dict, arrays: Dict[str, np.ndarray],
               pallas: bool = False) -> dict:
    """``cd_steps(graphed=True)`` of a ``cd_trainer`` under ``mesh``
    (``core.mesh.launch``; DistributedDataParallel), cuDNN deterministic;
    whether the step ran in DDP and as a graph."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tr = cd_trainer(cfg, arrays, mesh=mesh, pallas=pallas)
        out = cd_steps(tr, graphed=True)
        out["ddp"] = type(tr.net).__name__ == "DistributedDataParallel"
        out["graphed"] = tr._train_graph.graph is not None
        return out
    finally:
        torch.backends.cudnn.deterministic = det
