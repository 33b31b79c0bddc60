"""The ``space`` axis's cases, run on each rank of a (data, space) grid and
held against one process.

Each function takes ``(mesh, ...)``, as ``core.mesh.launch`` calls it
(``mesh`` None for one process with no group), runs on the rank's part of a
global batch given whole (numpy, seeded by the caller) and returns what the
rank holds afterwards. Imports no JAX: ``tests/test_torch_space.py`` runs
these on gloo CPU ranks, ``chip_smoke.py`` phase 21 on two gloo ranks
sharing the card, ``tests/test_torch_space_kernels.py`` and phase 22 the
decoder kernels' cases (BIT, ``xbd_bit``, ``pallas = True``),
``tests/test_torch_space_uneven.py`` (eight ranks, 2 x 4) and phase
21f-h the uneven rows, whose coarse levels run whole (``forward_rows``'
output shapes and gate paths show which),
``tests/test_torch_space_zoo.py`` and phase 23 ``siamUnet_conc`` and the
UNet change transformers (with ``pixel_ops``, ``width_encoder`` and the
transposed convolutions of ``halo_op``),
``tests/test_torch_space_changeformer.py`` and phase 23 ChangeFormer V1
and V6 (with ``rows_dropout`` and ``sr_attention``). The trainers'
row-sharded steps are ``trainer_steps`` here and ``tools/mesh_checks.py``
``cd_steps`` / ``xbd_steps`` with ``spatial=True``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dahitra_tpu_torch.tools.mesh_checks import launches, reset_launches

# name -> (kernel, stride, padding) of the convolutions ``halo_ops`` runs;
# the rest are the pools and resizes of nn/blocks.py
CONVS = {"conv3x3_s1": (3, 1, 1), "conv3x3_s2": (3, 2, 1),
         "stem7x7_s2": (7, 2, 3), "conv1x1_s2": (1, 2, 0)}
HALO_OPS = tuple(CONVS) + ("maxpool3x3_s2", "bilinear_x4")
# name -> (kernel, stride, padding, output padding) of the transposed
# convolutions ``halo_op`` also runs: siamUnet_conc's deconvs and up-convs
TRANSPOSED = {"deconv3x3_s1": (3, 1, 1, 0), "upconv3x3_s2": (3, 2, 1, 1)}


def _dev(mesh, device):
    return mesh.device if mesh is not None else torch.device(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def halo_op(op: str, x: torch.Tensor, weight: Optional[torch.Tensor]):
    """One spatial op of ``nn/blocks.py`` on NHWC x (its rows with halos
    under row sharding)."""
    from dahitra_tpu_torch.nn import blocks

    if op in CONVS:
        _, stride, pad = CONVS[op]
        return blocks.conv2d_nhwc(x, weight, stride=stride, padding=pad)
    if op in TRANSPOSED:
        from types import SimpleNamespace

        k, stride, pad, out_pad = TRANSPOSED[op]
        return blocks.conv_transpose2d_nhwc(x, SimpleNamespace(
            weight=weight, bias=None, kernel_size=(k, k),
            stride=(stride, stride), padding=(pad, pad),
            output_padding=(out_pad, out_pad)))
    if op == "maxpool3x3_s2":
        return blocks.max_pool_3x3_s2(x)
    return blocks.upsample_bilinear(x, 4)


def halo_ops(mesh, cases, device: str = "cpu") -> list:
    """Each ``(op, x, dy, weight)`` (whole NHWC arrays; ``weight`` None for
    the pools and resizes) on the rank's rows under the row-sharded grid:
    the rank's output y, the gradient of sum(y * dy) with respect to its
    rows of x, and the weight's gradient summed over the ranks."""
    from dahitra_tpu_torch.core.mesh import reduce_sum_, shard_batch
    from dahitra_tpu_torch.nn import space

    dev = _dev(mesh, device)
    out = []
    for op, x, dy, weight in cases:
        part = shard_batch({"x": x}, mesh, spatial=True)
        xl = torch.from_numpy(np.ascontiguousarray(part["x"])).to(dev)
        xl.requires_grad_(True)
        w = None if weight is None else torch.from_numpy(weight).to(
            dev).requires_grad_(True)
        with space.grid(mesh, spatial=True):
            y = halo_op(op, xl, w)
            (y * space.local_rows(torch.from_numpy(dy).to(dev))).sum(
                ).backward()
        dw = None
        if w is not None:
            dw = w.grad if mesh is None else reduce_sum_(w.grad.clone())
        out.append({"y": y.detach(), "dx": xl.grad, "dw": dw})
    return out


def pixel_ops(mesh, x: np.ndarray, dy: np.ndarray,
              device: str = "cpu") -> dict:
    """``space.pixel_max`` and ``space.pixel_softmax`` of the rank's rows of
    NHWC x under the row-sharded grid: the max (B, 1, 1, C), the rank's
    rows of the softmax over the pixels, and the gradient of max.sum() +
    sum(softmax * dy) with respect to its rows of x (the max's gradient
    taken once: the rank's share, 1 / S of it)."""
    from dahitra_tpu_torch.core.mesh import shard_batch
    from dahitra_tpu_torch.nn import space

    dev = _dev(mesh, device)
    xl = torch.from_numpy(np.ascontiguousarray(shard_batch(
        {"x": x}, mesh, spatial=True)["x"])).to(dev).requires_grad_(True)
    with space.grid(mesh, spatial=True):
        r = space.rows()
        m = space.pixel_max(xl)
        b, h, w, c = xl.shape
        soft = space.pixel_softmax(xl.reshape(b, h * w, c))
        dyl = space.local_rows(torch.from_numpy(dy).to(dev))
        share = 1.0 / (r.size if r is not None else 1)
        (m.sum() * share + (soft * dyl.reshape(b, h * w, c)).sum()
         ).backward()
    return {"max": m.detach(), "softmax": soft.detach().reshape(b, h, w, c),
            "dx": xl.grad}


def width_encoder(mesh, x: np.ndarray, dy: np.ndarray, seed: int,
                  dim: int, depth: int, heads: int, mlp: int,
                  dropout: float = 0.0, device: str = "cpu") -> dict:
    """A ``TransformerEncoder(dim, depth, heads, 64, mlp, dropout=)``
    with ``seeded_weights(seed)`` on tokens x (B, C, dim), train mode
    (dropout drawn from a generator seeded by ``seed``): under the
    row-sharded grid on the rank's block of the width (``width``), else
    whole. Its output block, the gradient of sum(y * dy) with respect to
    its block of x, every parameter's gradient summed over the ranks, and
    the shapes its sublayers' outputs had."""
    from dahitra_tpu_torch.core.mesh import reduce_sum_
    from dahitra_tpu_torch.nn import space
    from dahitra_tpu_torch.nn.blocks import (TransformerEncoder,
                                             set_dropout_generator)

    dev = _dev(mesh, device)
    enc = TransformerEncoder(dim, depth, heads, 64, mlp, dropout=dropout)
    seeded_weights(enc, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # LayerNorm scales off 1, so their blocks show
        for name, p in enc.named_parameters():
            if name.endswith("norm.weight"):
                p.uniform_(0.5, 1.5, generator=gen)
    enc.to(dev)
    set_dropout_generator(enc, torch.Generator(device=dev).manual_seed(seed))
    shapes, hooks = _shapes(enc)
    with space.grid(mesh, spatial=True):
        r = space.rows()
        n = dim // (r.size if r is not None else 1)
        block = slice(r.rank * n, (r.rank + 1) * n) if r is not None \
            else slice(None)
        xl = torch.from_numpy(np.ascontiguousarray(x[..., block])).to(
            dev).requires_grad_(True)
        y = enc(xl, deterministic=False, width=r)
        (y * torch.from_numpy(np.ascontiguousarray(dy[..., block])).to(dev)
         ).sum().backward()
    for h in hooks:
        h.remove()
    grads = {k: p.grad.clone() for k, p in enc.named_parameters()}
    if r is not None:
        grads = {k: reduce_sum_(g, r.group) for k, g in grads.items()}
    return {"y": y.detach(), "dx": xl.grad, "grads": grads,
            "shapes": shapes}


def _block(t: torch.Tensor, r, axis: int = 1) -> torch.Tensor:
    """The rank's block of whole ``t`` along ``axis`` (all of it without
    row sharding)."""
    if r is None:
        return t
    n = t.shape[axis] // r.size
    return t.narrow(axis, r.rank * n, n).contiguous()


def rows_dropout(mesh, shape, rate: float, seed: int,
                 device: str = "cpu") -> list:
    """``Dropout(rate)`` masks on the rank's block of whole ones tensors
    (train mode, one generator seeded by ``seed``), drawn in turn: an NHWC
    map ``shape`` (rows, axis 1), an attention matrix (B, 2, N, N) of its
    pixels (queries, axis 2), the map again per sample (drop path) and per
    channel: the rank's outputs under the row-sharded grid, one process's
    whole ones without."""
    from dahitra_tpu_torch.nn import space
    from dahitra_tpu_torch.nn.blocks import Dropout

    dev = _dev(mesh, device)
    b, h, w, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    with space.grid(mesh, spatial=True):
        r = space.rows()
        for per, full, axis in (("element", shape, 1),
                                ("element", (b, 2, h * w, h * w), 2),
                                ("sample", shape, 1), ("channel", shape, 1)):
            drop = Dropout(rate, per)
            drop.generator = gen
            x = _block(torch.ones(full, device=dev), r, axis)
            out.append(drop(x, False, r, axis))
    return out


def sr_attention(mesh, cases, device: str = "cpu") -> list:
    """Each ``(x, dy, sr, seed)`` (whole NHWC x (B, H, W, C), C / 8 heads)
    through an ``SRAttention(C, C // 8, sr, attn_drop=0.2, proj_drop=0.2)``
    with ``seeded_weights(seed)``, train mode (dropout from a generator
    seeded by ``seed``), on the rank's rows under the row-sharded grid:
    its output rows, the gradient of sum(y * dy) with respect to its rows
    of x and every parameter's gradient summed over the ranks."""
    from dahitra_tpu_torch.core.mesh import reduce_sum_
    from dahitra_tpu_torch.models.changeformer import SRAttention
    from dahitra_tpu_torch.nn import space

    dev = _dev(mesh, device)
    out = []
    for x, dy, sr, seed in cases:
        attn = SRAttention(x.shape[-1], x.shape[-1] // 8, sr, 0.2, 0.2)
        seeded_weights(attn, seed)
        attn.to(dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        attn.attn_drop.generator = attn.proj_drop.generator = gen
        with space.grid(mesh, spatial=True):
            r = space.rows()
            xl = _block(torch.from_numpy(x).to(dev), r).requires_grad_(True)
            y = attn(xl, deterministic=False)
            (y * _block(torch.from_numpy(dy).to(dev), r)).sum().backward()
        grads = {k: p.grad.clone() for k, p in attn.named_parameters()}
        if r is not None:
            grads = {k: reduce_sum_(g, r.group) for k, g in grads.items()}
        out.append({"y": y.detach(), "dx": xl.grad, "grads": grads})
    return out


def k3_inputs(b: int, h: int, w: int, l: int, seed: int):
    """Seeded (x (b, h, w, 32) feature maps, w (32, l), dt (b, l, 32) a
    token cotangent), numpy fp32."""
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(b, h, w, 32)).astype(np.float32),
            (rng.normal(size=(32, l)) * 32 ** -0.5).astype(np.float32),
            rng.normal(size=(b, l, 32)).astype(np.float32))


def k3_ranks(mesh, cases, device: str = "cpu") -> list:
    """Each ``(b, h, w, l, seed, dtype)``: ``k3_inputs`` through
    ``SemanticTokenizerRanksFn`` on the rank's rows (its h w / S pixels)
    over the space group, each rank taking 1 / S of dt (the ranks' shares
    sum to dt): the tokens (the same bits on every rank), the rank's pixel
    gradient and its partial dw; and the launches."""
    from dahitra_tpu_torch.kernels.fused_tokenizer import (
        SemanticTokenizerRanksFn)
    from dahitra_tpu_torch.nn import space

    dev = _dev(mesh, device)
    reset_launches()
    out = []
    for b, h, w, l, seed, dname in cases:
        x, wk, dt = k3_inputs(b, h, w, l, seed)
        dtype = getattr(torch, dname)
        with space.grid(mesh, spatial=True):
            r = space.rows()
            xl = space.local_rows(torch.from_numpy(x).to(dev, dtype))
            hl = xl.shape[1]
            seq = xl.reshape(b, hl * w, 32).contiguous().requires_grad_(True)
            wt = torch.from_numpy(wk).to(dev, dtype).requires_grad_(True)
            tokens = SemanticTokenizerRanksFn.apply(seq, wt, r.group)
            share = torch.from_numpy(dt).to(dev, torch.float32) / r.size
            (tokens.float() * share).sum().backward()
        out.append({"tokens": tokens.detach(),
                    "dx": seq.grad.reshape(b, hl, w, 32), "dw": wt.grad})
    _sync(dev)
    return out + [launches()]


def set_pallas(model: torch.nn.Module, on: bool = True) -> int:
    """``pallas = on`` on every ``TransformerDecoder`` of ``model`` (the K4
    path, as a JAX user sets the field; no flag selects it): how many."""
    from dahitra_tpu_torch.nn.blocks import TransformerDecoder

    decs = [m for m in model.modules() if isinstance(m, TransformerDecoder)]
    for dec in decs:
        dec.pallas = on
    return len(decs)


def _decoder_paths(model: torch.nn.Module):
    """Per ``TransformerDecoder`` of ``model``, the path its gate sent the
    last call to: "fused" (K4), "stack" (K1; K1-save and K2 in training)
    or "layers"; and a function that puts the gates back."""
    from dahitra_tpu_torch.nn.blocks import TransformerDecoder

    paths, decs = {}, []
    for name, dec in model.named_modules():
        if not isinstance(dec, TransformerDecoder):
            continue

        def fused(*a, dec=dec, name=name, **k):
            took = TransformerDecoder.uses_fused(dec, *a, **k)
            paths[name] = "fused" if took else "layers"
            return took

        def stack(*a, dec=dec, name=name, **k):
            took = TransformerDecoder.uses_stack(dec, *a, **k)
            if took:
                paths[name] = "stack"
            return took

        dec.uses_fused, dec.uses_stack = fused, stack
        decs.append(dec)

    def restore():
        for dec in decs:
            del dec.uses_fused, dec.uses_stack

    return paths, restore


def _shapes(model: torch.nn.Module):
    """Forward hooks that record each submodule's tensor output shape."""
    shapes, hooks = {}, []
    for name, mod in model.named_modules():
        if not name:
            continue

        def keep(m, args, out, name=name):
            if isinstance(out, torch.Tensor):
                shapes[name] = tuple(out.shape)

        hooks.append(mod.register_forward_hook(keep))
    return shapes, hooks


def seeded_weights(model: torch.nn.Module, seed: int) -> dict:
    """``model``'s state dict after ``nn/init.py`` ``init_random`` from
    ``seed``, with 0.1 N(0, 1) added to every bias (numpy's draws from the
    same seed): the same on every process."""
    from dahitra_tpu_torch.nn.init import init_random

    init_random(model, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(torch.from_numpy(
                    0.1 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def forward_rows(mesh, net_g, img: int, state_dict,
                 inputs: Dict[str, np.ndarray], dname: str = "float32",
                 train: bool = False, loss: Optional[str] = None,
                 spatial: bool = True, device: str = "cpu",
                 pallas: bool = False) -> dict:
    """``net_g`` (a registry key, or a callable that builds the model from
    ``dtype``) with ``state_dict`` (or, an int, ``seeded_weights`` from
    that seed: no weights to send to the ranks) on the rank's part of
    ``inputs``
    (whole normalized NHWC images: "a" and "b", or "x" the 6-channel pair;
    row-sharded with ``spatial``): its logits, the global batch's logits
    (gathered over rows, then samples; for a multi-scale list also each
    head's, ``heads``, through ``space.gather_head``), every submodule's
    output shape, the
    path each decoder's gate took, and the launches and the peak device
    memory. ``train`` runs the train-mode forward; with ``loss`` ("levir"
    on "label", "damage" on "masks") the loss of the gathered logits, the gradients averaged over the ranks
    (DDP's mean) and the running statistics after the forward; without,
    one eval forward first warms the card (its algorithm choices), and the
    second is the one returned. ``pallas`` sets every decoder's ``pallas``
    (K4)."""
    from dahitra_tpu_torch.core.checkpoint import load_weights
    from dahitra_tpu_torch.core.mesh import (all_gather_rows, reduce_sum_,
                                             shard_batch, world_size)
    from dahitra_tpu_torch.models.registry import define_g, final_logits
    from dahitra_tpu_torch.nn import space

    dev = _dev(mesh, device)
    dtype = getattr(torch, dname)
    model = net_g(dtype=dtype) if callable(net_g) else define_g(
        net_g, dtype=dtype, img_size=img)
    if isinstance(state_dict, int):
        state_dict = seeded_weights(model, state_dict)
    load_weights(model, state_dict)
    set_pallas(model, pallas)
    model.to(dev).train(train)
    part = shard_batch(inputs, mesh, spatial=False)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in part.items()}
    grad = torch.enable_grad() if loss else torch.no_grad()
    with grad, space.grid(mesh, spatial):
        xs = [t[k].to(dtype) for k in (("a", "b") if "a" in t else ("x",))]
        image = xs[0].shape[1:3]
        xs = space.shard_rows(model, *xs)
        if not loss and not train:
            model(*xs)
        shapes, hooks = _shapes(model)
        paths, restore = _decoder_paths(model)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        heads = model(*xs, train=train)
        logits = final_logits(heads).float()
        whole = space.gather_batch(logits, mesh)
        out = {"logits": logits.detach(), "whole": whole.detach()}
        if isinstance(heads, (list, tuple)):  # each head's global batch
            out["heads"] = [space.gather_head(h.float(), mesh, image
                                              ).detach() for h in heads]
        if loss:
            data = mesh.data_group if mesh else None
            if loss == "levir":
                from dahitra_tpu_torch.losses.cd import levir_train_loss

                label = all_gather_rows(t["label"].long(), data)
                value = levir_train_loss(whole, label, label.shape[0])
            else:
                from dahitra_tpu_torch.losses.combo import xbd_damage_loss

                value = xbd_damage_loss(whole, all_gather_rows(
                    t["masks"].float(), data))
            value.backward()
            world = world_size()
            out["loss"] = value.detach()
            out["grads"] = {k: (reduce_sum_(p.grad.clone()) / world
                                if mesh is not None else p.grad.clone())
                            for k, p in model.named_parameters()
                            if p.grad is not None}
            out["stats"] = {k: b.detach().clone()
                            for k, b in model.named_buffers()
                            if k.endswith(("running_mean", "running_var"))}
    for h in hooks:
        h.remove()
    restore()
    _sync(dev)
    return {**out, "shapes": shapes, "paths": paths, "launches": launches(),
            "peak_bytes": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0}


def trainer_steps(mesh, kind: str, cfg: dict,
                  train_arrays: Dict[str, np.ndarray], spatial: bool = True,
                  timed: int = 0, pallas: bool = False,
                  no_dropout: bool = False) -> dict:
    """A ``CDTrainer`` (``kind`` "cd") or ``XBDTrainer`` ("xbd", damage)
    built from ``cfg`` (with ``no_dropout`` every ``Dropout`` rate of its
    model 0): one ``train_step`` (row-sharded with ``spatial``)
    on the first batch of epoch 0, its loss (and confusion matrix), the
    gradients, the running statistics after it, the launches in it, every
    submodule's output shape in it and the
    peak device memory over it (``torch.cuda.max_memory_allocated``, 0 on
    the CPU); then ``timed`` more steps on the same batch, each on the host
    clock around a synchronized call: their median, their peak device
    memory and the collectives staged through host memory per step."""
    import argparse
    import statistics
    import time

    from dahitra_tpu_torch.core import mesh as mesh_mod
    from dahitra_tpu_torch.tools.mesh_checks import _state

    if kind == "cd":
        from dahitra_tpu_torch.train.engine import CDTrainer as cls
    else:
        from dahitra_tpu_torch.train.xbd_engine import XBDTrainer as cls
    trainer = cls(argparse.Namespace(**cfg), train_arrays, train_arrays,
                  device=cfg["device"], mesh=mesh)
    set_pallas(trainer.model, pallas)
    if no_dropout:
        from dahitra_tpu_torch.nn.blocks import Dropout

        for m in trainer.model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    dev = trainer.device
    batch = trainer._to_device(next(iter(trainer.train_loader)))
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    shapes, hooks = _shapes(trainer.model)
    out = trainer.train_step(*batch, spatial=spatial)
    _sync(dev)
    for h in hooks:
        h.remove()
    loss, cm = out if isinstance(out, tuple) else (out, None)
    res = {"loss": loss.view(1).clone(), **_state(trainer.model),
           "launches": launches(), "shapes": shapes,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)
           if dev.type == "cuda" else 0}
    if cm is not None:
        res["cm"] = cm.clone()
    times, staged = [], mesh_mod.STAGED
    if timed and dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(timed):
        t0 = time.perf_counter()
        trainer.train_step(*batch, spatial=spatial)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    if timed:
        res["step_s"] = statistics.median(times)
        res["step_samples"] = timed
        res["warm_peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        res["staged_per_step"] = (mesh_mod.STAGED - staged) / timed
    return res


def grid_of(mesh) -> dict:
    """The rank's place on the grid and its groups' members, read back
    through the groups: every rank's global rank gathered over its space
    group and over its data group."""
    from dahitra_tpu_torch.core.mesh import gather_parts

    me = torch.tensor([mesh.rank])
    return {"rank": mesh.rank, "data_rank": mesh.data_rank,
            "space_rank": mesh.space_rank, "n_data": mesh.n_data,
            "n_space": mesh.n_space, "shard": mesh.shard,
            "space_members": [int(p) for p in gather_parts(
                me, mesh.space_group)],
            "data_members": [int(p) for p in gather_parts(
                me, mesh.data_group)]}


def run_cases(mesh, cases, deterministic: bool = False) -> list:
    """Each ``(function name, args)`` of ``cases`` in turn on this rank (one
    launch for several checks; TF32 off, as the trainers set it, and cuDNN
    deterministic where asked), then the rank's count of collectives staged
    through host memory (``core.mesh.STAGED``)."""
    from dahitra_tpu_torch.core import mesh as mesh_mod
    from dahitra_tpu_torch.tools import mesh_checks
    from dahitra_tpu_torch.utils import disable_tf32

    def fn(name):
        return globals().get(name) or getattr(mesh_checks, name)

    disable_tf32()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        out = [fn(name)(mesh, *args) for name, args in cases]
    finally:
        torch.backends.cudnn.deterministic = det
    return out + [mesh_mod.STAGED]
