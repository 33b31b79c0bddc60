"""Steps of the trainers and the evaluator under a mesh, to hold against one
process.

Each function takes ``(mesh, cfg, ...)``, as ``core.mesh.launch`` calls it
(``mesh`` None for one process with no group; on a (data, space) grid the
rank's data shard is ``mesh.shard``, (data rank, n_data), and ``spatial``
runs the row-sharded steps; ``tools/space_checks.py`` adds the space
axis's own cases), builds the trainer or
evaluator the CLI would build from ``cfg`` (the CLI's arguments as a dict,
``device`` among them) and returns what the rank holds afterwards: losses,
confusion matrices, each parameter's gradient of the last step, the
running statistics, scores and the kernels' launches in the run (every
counter set to 0 just before the run and read just after it). Run with
several ranks, the ranks' results must equal one process's on the joined
batch (``tests/test_torch_mesh.py``, and on the card ``chip_smoke.py``
phase 19).

``rank_sums(world)`` makes one process sum every train-mode BatchNorm's
statistics as ``world`` ranks do, so that a step whose rounding that
order decides can be held to one process that rounds as the ranks do
(PERF.md, PR 16); ``token_cancellation`` measures why such a step is
sensitive to it.
"""
from __future__ import annotations

import argparse
import contextlib
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from dahitra_tpu_torch.kernels import (folded_decoder, fused_decoder,
                                       fused_tokenizer)


def reset_launches() -> None:
    """Set every kernel launch counter of this process to 0."""
    fd = folded_decoder
    fd.launches = fd.launches_save = fd.launches_bwd = 0
    fd.launches_pad = fd.launches_save_pad = fd.launches_bwd_pad = 0
    fused_tokenizer.launches = fused_tokenizer.launches_ranks = 0
    fused_decoder.launches = fused_decoder.launches_pad = 0


def launches() -> Dict[str, int]:
    """The kernel launch counters of this process: K1, K1-save, K2, K3
    (one process), K3 split over the space ranks, K4 and the
    padded-token-count ones."""
    fd = folded_decoder
    return {"k1": fd.launches, "k1_save": fd.launches_save,
            "k2": fd.launches_bwd, "k3": fused_tokenizer.launches,
            "k3_ranks": fused_tokenizer.launches_ranks,
            "k4": fused_decoder.launches, "k1_pad": fd.launches_pad,
            "k1_save_pad": fd.launches_save_pad,
            "k2_pad": fd.launches_bwd_pad,
            "k4_pad": fused_decoder.launches_pad}


@contextlib.contextmanager
def rank_sums(world: int) -> Iterator[None]:
    """Inside, one process takes every train-mode ``BatchNorm``'s
    statistics as ``world`` ranks of ``core/mesh.py`` do on its batch split
    into ``world`` contiguous row blocks: each block's [sum x | sum x^2 | n]
    alone, the blocks' sums added in rank order (the all-reduce of two
    ranks), then the global mean and variance. The values are those of one
    process; only the rounding follows the ranks."""
    from dahitra_tpu_torch.nn import blocks

    def moments(xf: torch.Tensor, group=None):
        c = xf.shape[-1]
        sums = None
        for part in xf.chunk(world, 1):
            part = part.contiguous()
            n = part.new_full((part.shape[0], 1), float(part.shape[1]))
            s = torch.cat([part.sum(1), (part * part).sum(1), n], -1)
            sums = s if sums is None else sums + s
        count = sums[:, 2 * c:]
        mean = sums[:, :c] / count
        return mean, (sums[:, c:2 * c] / count - mean * mean).clamp_min(0.0)

    saved = blocks.world_size, blocks._global_moments
    blocks.world_size, blocks._global_moments = (
        lambda group=None: world), moments
    try:
        yield
    finally:
        blocks.world_size, blocks._global_moments = saved


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state(model: torch.nn.Module) -> dict:
    return {"grads": {k: p.grad.detach().clone()
                      for k, p in model.named_parameters()
                      if p.grad is not None},
            "stats": {k: b.detach().clone()
                      for k, b in model.named_buffers()
                      if k.endswith(("running_mean", "running_var"))}}


def _rows(mesh, n: int) -> slice:
    """The rank's data shard of ``n`` samples."""
    rank, n_data = mesh.shard if mesh else (0, 1)
    return slice(rank * n // n_data, (rank + 1) * n // n_data)


def bn_rows(mesh, x: np.ndarray, dy: np.ndarray, params: Dict[str, np.ndarray],
            pair: bool) -> dict:
    """A train-mode ``BatchNorm`` on the rank's rows of the joined batch
    ``x`` (in pair mode [date 1; date 2], the rank's rows of each date) and
    the gradients of sum(y * dy) over the joined batch: the rank's y and dx,
    the parameters' gradients summed over the ranks, the running
    statistics."""
    from dahitra_tpu_torch.core.mesh import reduce_sum_
    from dahitra_tpu_torch.nn.blocks import BatchNorm

    bn = BatchNorm(x.shape[-1])
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(params[key]))
    halves = (x[:len(x) // 2], x[len(x) // 2:]) if pair else (x,)
    dys = (dy[:len(dy) // 2], dy[len(dy) // 2:]) if pair else (dy,)
    rows = _rows(mesh, len(halves[0]))
    xl = torch.from_numpy(np.concatenate([h[rows] for h in halves]))
    dyl = torch.from_numpy(np.concatenate([h[rows] for h in dys]))
    xl.requires_grad_(True)
    y = bn(xl, train=True, pair=pair)
    (y * dyl).sum().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    if mesh is not None:
        for g in grads:
            reduce_sum_(g)
    return {"y": y.detach(), "dx": xl.grad, "dweight": grads[0],
            "dbias": grads[1], "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone()}


def loss_rows(mesh, logits: np.ndarray, label: np.ndarray) -> dict:
    """``levir_train_loss`` as the trainers compute it under a mesh: the
    rank's rows of the joined fp32 ``logits`` gathered with their labels,
    the loss of the gathered batch at its size; returns the loss and the
    rank's logit gradient divided by the world size (what DDP's mean makes
    of it)."""
    from dahitra_tpu_torch.core.mesh import all_gather_rows
    from dahitra_tpu_torch.losses.cd import levir_train_loss

    rows = _rows(mesh, len(logits))
    z = torch.from_numpy(logits[rows]).requires_grad_(True)
    zg = all_gather_rows(z)
    lg = all_gather_rows(torch.from_numpy(label[rows]).long())
    loss = levir_train_loss(zg, lg, zg.shape[0])
    loss.backward()
    world = mesh.world_size if mesh else 1
    return {"loss": loss.detach(), "grad": z.grad / world}


def run_cases(mesh, cases, deterministic: bool = False) -> list:
    """Each ``(function name, args)`` of ``cases`` in turn on this rank (one
    launch for several checks; cuDNN deterministic where asked), then the
    rank's count of collectives staged through host memory
    (``core.mesh.STAGED``)."""
    from dahitra_tpu_torch.core import mesh as mesh_mod

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        out = [globals()[name](mesh, *args) for name, args in cases]
    finally:
        torch.backends.cudnn.deterministic = det
    return out + [mesh_mod.STAGED]


def cd_steps(mesh, cfg: dict, train_arrays: Dict[str, np.ndarray],
             steps: int = 1, pad_to: Optional[int] = None,
             spatial: bool = False) -> dict:
    """``steps`` ``CDTrainer.train_step`` calls on the first batches of
    epoch 0 (row-sharded on a (data, space) grid with ``spatial``): their
    losses and (global) confusion matrices, the last step's gradients and
    the running statistics after it. ``pad_to`` pads one process's batches
    as a mesh of that size pads the joined batch."""
    from dahitra_tpu_torch.data.loader import BatchLoader
    from dahitra_tpu_torch.train.engine import CDTrainer

    trainer = CDTrainer(argparse.Namespace(**cfg), train_arrays, train_arrays,
                        device=cfg["device"], mesh=mesh)
    if pad_to and mesh is None:
        trainer.train_loader = BatchLoader(
            train_arrays, cfg["batch_size"], shuffle=True,
            seed=cfg.get("seed", 0), pad_to_multiple=pad_to)
    reset_launches()
    losses, cms = [], []
    for _, batch in zip(range(steps), trainer.train_loader):
        loss, cm = trainer.train_step(*trainer._to_device(batch),
                                      spatial=spatial)
        losses.append(loss)
        cms.append(cm)
    _sync(trainer.device)
    return {"loss": torch.stack(losses), "cm": torch.stack(cms),
            **_state(trainer.model), "launches": launches()}


def xbd_steps(mesh, cfg: dict, train_arrays: Dict[str, np.ndarray],
              steps: int = 1, task: str = "damage",
              sums_of: int = 1, spatial: bool = False) -> dict:
    """As ``cd_steps`` for ``XBDTrainer.train_step`` on ``task``; one
    process with ``sums_of`` > 1 runs under ``rank_sums(sums_of)``."""
    from dahitra_tpu_torch.train.xbd_engine import XBDTrainer

    trainer = XBDTrainer(argparse.Namespace(**cfg), train_arrays,
                         train_arrays, device=cfg["device"], task=task,
                         mesh=mesh)
    order = rank_sums(sums_of) if mesh is None and sums_of > 1 \
        else contextlib.nullcontext()
    reset_launches()
    with order:
        losses = [trainer.train_step(*trainer._to_device(batch),
                                     spatial=spatial)
                  for _, batch in zip(range(steps), trainer.train_loader)]
    _sync(trainer.device)
    return {"loss": torch.stack(losses), **_state(trainer.model),
            "launches": launches()}


def xbd_validate(mesh, cfg: dict, val_arrays: Dict[str, np.ndarray],
                 task: str = "damage") -> dict:
    """``XBDTrainer.validate`` of the seeded weights: the scores and the
    tp / fp / fn counts."""
    from dahitra_tpu_torch.train.xbd_engine import XBDTrainer

    trainer = XBDTrainer(argparse.Namespace(**cfg), val_arrays, val_arrays,
                         device=cfg["device"], task=task, mesh=mesh)
    counts = []
    eval_step = trainer.eval_step

    def recording(*a):
        out = eval_step(*a)
        counts.append(torch.stack(out[1:]))
        return out

    trainer.eval_step = recording
    scores = trainer.validate()
    local = torch.stack(counts).sum(0)
    if mesh is not None:
        from dahitra_tpu_torch.core.mesh import reduce_sum_

        reduce_sum_(local, mesh.data_group)
    return {"scores": scores, "counts": local}


def token_cancellation(cfg: dict, train_arrays: Dict[str, np.ndarray]
                       ) -> Dict[str, float]:
    """For each DAHiTra trans module r, max|t2 - t1| / max|t| of the
    tokens its transformer gives the two dates in the train forward of the
    first augmented batch: the cancellation in its decoder memory
    |t2 - t1| (1 for dates with nothing in common, near 0 for dates whose
    tokens agree)."""
    from dahitra_tpu_torch.train.xbd_engine import XBDTrainer

    trainer = XBDTrainer(argparse.Namespace(**cfg), train_arrays,
                         train_arrays, device=cfg["device"])
    out, hooks = {}, []
    for name, mod in trainer.model.named_children():
        if name.startswith("transformer_") and "decoder" not in name:
            def keep(m, args, t, r=name.split("_")[-1]):
                t1, t2 = t.float().chunk(2, dim=1)
                out[r] = float((t2 - t1).abs().max() / t.float().abs().max())
            hooks.append(mod.register_forward_hook(keep))
    batch = next(iter(trainer.train_loader))
    with torch.no_grad():
        trainer._forward(trainer._augment(*trainer._to_device(batch))[0],
                         True)
    for h in hooks:
        h.remove()
    return dict(sorted(out.items()))


def gan_epoch(mesh, cfg: dict, train_arrays: Dict[str, np.ndarray]) -> dict:
    """One ``GANTrainer`` epoch (a discriminator update at batches 0, 8,
    ...): the generator's and the discriminator's loss of every step, the
    running statistics of both networks after it."""
    from dahitra_tpu_torch.train.xbd_engine import GANTrainer

    trainer = GANTrainer(argparse.Namespace(**cfg), train_arrays,
                         train_arrays, device=cfg["device"], mesh=mesh)
    g, d = [], []
    for i, batch in enumerate(trainer.train_loader):
        gl, dl = trainer.gan_step(*trainer._to_device(batch),
                                  update_disc=i % trainer.disc_every == 0)
        g.append(gl)
        d.append(dl)
    return {"g_loss": torch.stack(g), "d_loss": torch.stack(d),
            "stats": _state(trainer.model)["stats"],
            "disc_stats": _state(trainer.disc)["stats"]}


def cd_eval(mesh, cfg: dict, arrays: Dict[str, np.ndarray],
            state_dict: Optional[dict] = None,
            group_of: Optional[np.ndarray] = None,
            spatial: bool = False) -> dict:
    """``CDEvaluator.eval_models`` of ``state_dict`` (or of the checkpoint
    in ``cfg["checkpoint_dir"]``; row-sharded on a (data, space) grid with
    ``spatial``): the summed confusion matrix, the scores, and the
    launches."""
    from dahitra_tpu_torch.evalx.evaluator import CDEvaluator

    ev = CDEvaluator(argparse.Namespace(**cfg), arrays, device=cfg["device"],
                     state_dict=state_dict, mesh=mesh)
    reset_launches()
    scores = ev.eval_models(group_of=group_of, spatial=spatial)
    _sync(ev.device)
    return {"cm": torch.from_numpy(np.asarray(ev.confusion_matrix)),
            "scores": scores, "launches": launches()}
