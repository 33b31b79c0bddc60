"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main paths, LEVIR-CD evaluation and training of DAHiTra
(``newUNetTrans``) at its published width, at 256 px and then at 512 and
1024 px, and of BIT (``base_transformer_pos_s4_dd8``) and ``base_resnet18``
at 256 px, through the user's entry points ``dahitra_tpu_torch.cli.eval_cd``
and ``dahitra_tpu_torch.cli.main_cd``, and xBD damage training and
prediction at 1024 px (``xbd_dahitra``, ``xbd_bit``) through
``dahitra_tpu_torch.cli.xbd_train`` and ``xbd_predict``, the rest of
the xBD stack (``xbd_train --task loc | adapt | gan``, ``--elastic``,
``visualize_results``), and the rest of the LEVIR-CD zoo with ``demo``,
``import_checkpoint`` and ``count_params``. Phases, each fatal on failure:

  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from ``dahitra_tpu_torch/csrc`` (one nvcc per
     source, all started together, beside one more nvcc of each decoder
     source, K1's, K2's and K4's, with ``-Xptxas -v``), and print the
     registers, spills and ``HMMA.16816.F32.BF16`` instructions
     (``cuobjdump -sass``) of the row kernels' instances (K1 and K1-save,
     K2; fp32 and bf16; K4's four; each at mlp_dim 32 and 64, the suffix
     ``_mlp64`` naming BIT's; the PAD instances ``_pad``; K2's fp32 WIDE
     instances, 2-warp CTAs for a padded hl whose 64-row tiles do not fit,
     ``_wide``) and the CTAs per SM of each at every main-path hl (16 and
     32 for DAHiTra's, 32 and 64 for BIT's; the PAD instances also at the
     padded hl of ``WIDE_SHAPES``, the WIDE ones at 224; CUDA's occupancy
     calculator, which sizes K2's grid);
  3. hold each kernel against its plain PyTorch version on the card at every
     shape the main paths give it, in fp32 and bf16, and time the kernel,
     the plain version and, where one exists, a single PyTorch call that
     computes the same function: K1 and K1-save (the decoder-stack forward
     without and with saves) and K2 (its backward, from K1-save's saves),
     each rerun for the same bits and also timed behind queued work
     (``device_ms``; all three on tensor cores, fp32 as three bf16 pieces), K3
     (the tokenizer) and K4 (the fused decoder of
     ``TransformerDecoder(pallas=True)``, in the fp32 and the bf16 model's
     mode, and its bf16-I/O instance at one shape; rerun for the same bits,
     timed also behind queued work, its prologue and row kernel apart, and
     the prologue's A and Z held against ``fused_decoder_az_plain``); the
     decoder kernels also
     at the 1/4-scale dates shape of 512 px, and K3 at the three scales of
     512 px at batch 8 and of 1024 px at batch 2, each K3 call twice for the
     same bits and timed a second time behind a queue of other work
     (``device_ms``), where the host's launch rate does not hide the device
     time (an empty kernel's launch time is printed beside); then K4's
     gradients
     (``FusedDecoderFn``) on the card against autograd of
     ``plain_decoder_stack`` on the CPU at the 1/4-scale dates shape; then
     the mlp_dim-64 instances of K1, K1-save, K2 and K4 (both model modes)
     at BIT's shapes (``BIT_SHAPES``: ``_dd8`` at 256 and 512 px, hl 32,
     and ``_t8_e2d4``, hl 64), against their plain versions, rerun for the
     same bits and timed as above; then K1, K1-save, K2 and K4 at token
     counts per head the mma tiles do not hold as they are (``PAD_SHAPES``,
     the wrappers pad them: 3 tokens at 8 heads, 16 at 8 heads, 1 at 7
     heads, and for K4 32 at 4 heads, on the 1/4-scale dates shape of 256
     px), against their plain versions on the unpadded operands, rerun for
     the same bits and timed as above; then K1, K1-save and K2 at padded hl
     above 128 (``WIDE_SHAPES``: 9 heads of 9 tokens, hl 144; 14 of 9, 224;
     33 of 3, 132; 127 of 1, 128 with one zero head; 25 of 5, 200), the
     same way; then K1, K1-save, K2 and K3 at the
     xBD path's shapes (``XBD_K1_SHAPES``, ``XBD_BIT_SHAPES`` and the xBD
     rows of ``K3_SHAPES``: the decoder at 1024 px, batch 1 for training and
     validation and 4 for the prediction's views; ``xbd_bit``'s mlp_dim-64
     instances at N 65536), against their plain versions, rerun for the same
     bits and timed as above;
  4. write a seeded synthetic LEVIR tree (4 tiles of 1024 px = 64 patches of
     256 px) and a seeded ``best_ckpt.pt``;
  5. run ``eval_cd`` on the card at batch 8, once in fp32 and once with
     ``--bf16``, with every launch counter set to 0 just before each run and
     read just after: K1 must launch 6 times and K3 3 times per forward, and
     K1-save and K2 never;
  6. hold the card's fp32 forward (kernels) against the port's plain path on
     the CPU for two patches;
  7. write seeded synthetic ``train`` (32 pairs) and ``val`` (8 pairs) splits
     at 256 px and run ``main_cd`` on the card at batch 8 for 2 epochs, once
     in fp32 and once with ``--bf16``, with every launch counter set to 0
     just before each run: 8 steps x (6 K1-save, 6 K2, 3 K3) and 2
     validation batches x (6 K1, 3 K3);
  8. hold the card's fp32 training gradients (kernels) against the port's
     plain path on the CPU: one batch of 2 at 256 px, no augmentation, every
     parameter's gradient and the updated BN running statistics;
  9. the pallas eval forward: ``newUNetTrans`` from phase 4's checkpoint
     with ``pallas = True`` on its three decoders, 8 batch-8 forwards over
     the 64 synthetic patches, fp32 then bf16: 6 K4 and 3 K3 launches per
     forward, no K1, K1-save or K2; in fp32 the logits against the default
     (K1) path of the same weights on the card;
 10. the pallas train step: a ``CDTrainer`` with ``pallas = True`` on its
     decoders, 4 batch-8 steps per dtype: 6 K4 and 3 K3 launches per step,
     no K1, K1-save or K2, finite losses; the default path's step time on
     the same trainer beside it;
 11. phase 8 with ``pallas = True`` on both sides (the CPU side runs
     ``fused_decoder_plain`` and the ``plain_decoder_stack`` backward);
 12. ``eval_cd --img_size 512`` at batch 8 over 16 synthetic 512 px tiles
     and ``eval_cd --img_size 1024`` at batch 2 over phase 4's four 1024 px
     tiles (the reference's loader crops only tiles wider than twice
     ``img_size``, so each size reads tiles of its own width), fp32 then
     bf16: 2 forwards each, 6 K1 and 3 K3 launches per forward, finite
     scores; then the card's fp32 forward of one 512 px pair against the
     plain path on the CPU;
 13. ``main_cd --img_size 512`` at batch 4 for one epoch over 8 synthetic
     512 px ``train`` pairs and 4 ``val`` pairs, fp32 then bf16: 2 steps x
     (6 K1-save, 6 K2, 3 K3) and one validation forward (6 K1, 3 K3); then
     one ``CDTrainer.train_step`` at 1024 px on a seeded batch per dtype, on
     the default path (6 K1-save, 6 K2, 3 K3) and with ``pallas = True``
     (6 K4, 3 K3): finite loss, step time and peak memory;
 14. BIT and ResNetCD (``run_bit_phase``): seeded ``base_transformer_pos_s4
     _dd8`` and ``base_resnet18`` checkpoints; ``eval_cd --net_G
     base_transformer_pos_s4_dd8`` at batch 8 over phase 4's 64 patches,
     fp32 then bf16 (2 K1 and 2 K3 per forward, the decoder and the
     tokenizer once per date); its fp32 forward of two patches against the
     CPU plain path; ``main_cd`` with that key for 2 epochs on phase 7's
     splits in both dtypes (2 K1-save, 2 K2, 2 K3 per step); its fp32
     training gradients and BN statistics against the CPU plain path; its
     pallas forwards (2 K4, 2 K3; fp32 logits within 1e-3 of the K1 path);
     one ``eval_cd --net_G base_resnet18`` forward per dtype (no decoder or
     tokenizer kernel). BIT's decoder has mlp_dim 64, so these phases launch
     the mlp_dim-64 instances and no other decoder instance;
 15. xBD (``run_xbd_phase``): 8 seeded synthetic 1024 px tiles (every
     damage class in each) and 2 more to predict; per dtype ``xbd_train
     --task damage --net_G xbd_dahitra --img_size 1024 --batch_size 1
     --max_epochs 1 --eval_every 1`` (3 K1-save, 3 K2 and 3 K3 per step, 3
     K1 and 3 K3 per validation forward: one difference decode and one
     tokenizer call per scale), ``xbd_predict`` with its checkpoint (one
     forward of the 4 TTA views per tile: 3 K1 and 3 K3; both PNGs of the
     right shape and range) and its warm rate (one tile's views, the model
     loaded, median of 5), 5 warm ``XBDTrainer.train_step`` calls of
     ``xbd_dahitra`` and of ``xbd_bit`` (2 K1-save, 2 K2, 2 K3 each: the
     mlp_dim-64 instances) with the median step time, its range and peak
     memory, and ``xbd_predict`` of ``xbd_bit`` (2 K1, 2 K3 per tile);
     then the card's fp32 damage-task gradients and BN statistics against
     the CPU plain path at 256 px, batch 1 (1e-3 of the gradient's scale,
     1e-4);
 16. the rest of the xBD stack (``run_xbd_tasks_phase``) on phase 15's
     tiles at 1024 px, batch 1, fp32 then bf16: one epoch of ``xbd_train
     --task loc`` (``xbd_res34_loc``: no decoder or tokenizer launch),
     ``--task adapt`` (``xbd_adapt_res34``, none; ``--net_G
     xbd_adapt_dahitra``: 3 K1-save, 3 K2, 3 K3 a step, 3 K1, 3 K3 a
     validation forward), ``--task gan`` (``xbd_dahitra`` against the mask
     discriminator, 11 steps: a discriminator update at steps 0 and 8 adds
     the generator's forward, 3 K1 and 3 K3, to the step's 3 K1-save, 3 K2,
     3 K3; ``best_ckpt_D.pt``) and ``--task damage --elastic``;
     ``visualize_results`` with the loc checkpoint and phase 15's damage
     one over 2 tiles (3 K1, 3 K3 a tile; grids of (1024, 4096, 3)); 5 warm
     steps of each task (the GAN's also with a discriminator update) with
     their median time and peak memory, and one ``--effective_gan`` step
     whose adversarial gradient is nonzero; then the card's fp32 gradients
     and BN statistics of the ``loc`` step and of a GAN step that updates
     the discriminator (both networks) against the CPU plain path at 256 px,
     batch 1 (1e-3 of the gradient's scale, or twice the CPU path's own
     largest move under four 1e-6 input moves where larger; 1e-4);
 17. the rest of the LEVIR-CD zoo and the last LEVIR CLIs
     (``run_zoo_phase``) at 256 px: for each of ``unet_coupled_trans_256``,
     ``unet_coupled_two_trans_256``, ``siamUnet_conc``, ``changeFormer`` and
     ``changeFormerV6`` a seeded model's fp32 forward of two patches against
     the CPU plain path, then per dtype one epoch of ``main_cd`` at batch 8
     on phase 7's splits (``--multi_scale_loss`` for ``changeFormerV6``),
     ``eval_cd`` on its checkpoint and 5 warm ``CDTrainer.train_step`` calls
     (median, range, peak memory), none launching K1, K1-save, K2, K3 or K4;
     the card's fp32 gradients and BN statistics at batch 2 with every
     dropout rate 0 against the CPU (as phase 16 holds them); one train step
     with dropout on, twice from the same seed (cuDNN deterministic): a
     finite loss, the same bits. Then ``demo --net_G newUNetTrans`` with phase 4's checkpoint (6
     K1 and 3 K3 a forward, PNGs of the right shape), phase 4's checkpoint
     written as a reference ``.pt`` (``module.`` prefix, under
     ``model_G_state_dict``), ``import_checkpoint`` and ``eval_cd`` on the
     result (phase 5's fp32 confusion matrix exactly), phase 8's forward
     with ``fast_vjp = False`` (0 K1, logits within 1e-3 of the K1 path's)
     and ``count_params`` for every ported key (the card's allocated memory
     unchanged).

Every launch counter is set to 0 just before each main-path run (phases 5,
7, 9, 10, 12, 13, 14, 15, 16, 17) and read just after; the counters of the padded
token counts (``NO_PAD``) must read 0 in every one of them. ``--profile`` adds a torch.profiler
breakdown of the batch-8 forward and of one batch-8 training step by kernel
class, with the device's idle share, on the default path and with
``pallas = True``.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Exits non-zero, printing neither, when no
CUDA device is present or the port's package is missing. Needs one card;
imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
BATCH = 8
IMG = 256
# Scale-normalized max-error tolerances: fp32 allows summation-order noise;
# bf16 allows a flipped rounding that a depth-8 stack carries forward
# (gradients: tests/test_decoder_vjp.py:27-30).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GTOL = {"float32": 1e-4, "bfloat16": 6e-2}
TRAIN_PAIRS, VAL_PAIRS, EPOCHS = 32, 8, 2
# Decoder calls per forward at batch 8: (name, batch, tokens, depth, heads).
# The dates decode runs both dates batch-stacked, the difference decode once.
K1_SHAPES = [(f"{r}/{what}", b, n, depth, heads)
             for r, n, depth, heads in (("s4", 4096, 8, 8), ("s8", 1024, 4, 4),
                                        ("s16", 256, 4, 4))
             for what, b in (("dates", 2 * BATCH), ("diff", BATCH))]
# The 1/4-scale dates decode of 512 px at batch 8: the decoder kernels' first
# N above 4096.
K1_SHAPE_512 = ("512/s4/dates", 2 * BATCH, (512 // 4) ** 2, 8, 8)
# Tokenizer calls per forward (both dates batch-stacked): (name, batch,
# pixels) at 256 and 512 px batch 8 and 1024 px batch 2.
K3_SHAPES = [(f"{img}/s{s}", 2 * b, (img // s) ** 2)
             for img, b in ((IMG, BATCH), (512, BATCH), (1024, 2))
             for s in (4, 8, 16)]
# Off the main paths: 1024 px at batch 4, whose 1/4-scale x (67 MB in fp32)
# is the first to exceed the card's 50 MB L2, so the kernel's second read of
# x comes from device memory.
K3_SHAPES.append(("1024b4/s4", 8, (1024 // 4) ** 2))
# The xBD path at 1024 px (phase 15): xbd_dahitra decodes the difference
# once per scale at the batch (1 in training and validation, the 4 TTA views
# in prediction) and tokenizes both dates batch-stacked; xbd_bit decodes and
# tokenizes each date at 1/4 scale with its mlp_dim-64 instances. (name,
# batch, pixels N, depth, heads[, tokens, dim_head]); the training shapes
# are those at batch 1.
XBD_K1_SHAPES = [(f"xbd{view}/{r}", b, n, depth, heads)
                 for view, b in (("", 1), ("_tta", 4))
                 for r, n, depth, heads in (("s4", 65536, 8, 8),
                                            ("s8", 16384, 4, 4),
                                            ("s16", 4096, 4, 4))]
XBD_BIT_SHAPES = [(f"xbd_bit{view}/s4", b, 65536, 8, 8, 4, 64)
                  for view, b in (("", 1), ("_tta", 4))]
K3_SHAPES += [(f"xbd{view}/s{s}", 2 * b, (1024 // s) ** 2)
              for view, b in (("", 1), ("_tta", 4)) for s in (4, 8, 16)]
K3_SHAPES += [(name, b, n) for name, b, n, *_ in XBD_BIT_SHAPES]
STEP_1024_BATCH = 2  # pairs per batch of the 1024 px train step
TOKENS = 4
DIM = 32
# BIT's decoder (mlp_dim 64), called once per date at batch 8: (name, batch,
# pixels N, depth, heads, memory tokens, dim_head). "bit/dd8" is the main
# path (base_transformer_pos_s4_dd8 at 256 px, 2 calls per forward);
# "bit_t8/s4" base_transformer_pos_s4_dd8_t8_e2d4 (8 tokens per head, hl
# 64); "bit512/dd8" the main path's key at 512 px.
BIT_MLP = 64
BIT_SHAPES = [("bit/dd8", BATCH, 4096, 8, 8, 4, 64),
              ("bit_t8/s4", BATCH, 4096, 4, 8, 8, 8),
              ("bit512/dd8", BATCH, (512 // 4) ** 2, 8, 8, 4, 64)]
BIT_KEY = "base_transformer_pos_s4_dd8"
# Token counts per head that the mma tiles do not hold as they are (fault
# 3.2), on DAHiTra's 1/4-scale dates shape at 256 px (B 16, N 4096, depth
# 8): 3 tokens at 8 heads (padded to 4, masked), 16 at 8 heads (hl 128, the
# PAD instances' 16-column groups) and 1 at 7 heads (odd hl, run as 2); K4
# also 32 at 4 heads (a group of two 16-column slices). No model of the
# registry sends them, so the main paths launch these instances 0 times.
PAD_SHAPES = [(f"pad/l{tokens}h{heads}", 2 * BATCH, 4096, 8, heads, tokens, 64)
              for heads, tokens in ((8, 3), (8, 16), (7, 1))]
PAD_SHAPES_K4 = PAD_SHAPES + [("pad/l32h4", 2 * BATCH, 4096, 8, 4, 32, 64)]
# Token counts whose padded hl passes 128 (fault 3.2, closed), on the same
# shape, for K1, K1-save and K2: 9 heads of 9 tokens (padded to 16: hl 144),
# 14 of 9 (hl 224, the most the JAX gate sends), 33 of 3 (to 4: hl 132), 127
# of 1 (odd hl: one zero head more, hl 128) and 25 of 5 (to 8: hl 200, K2's
# WIDE instance without PAD in fp32). No model sends them.
WIDE_SHAPES = [(f"wide/l{tokens}h{heads}", 2 * BATCH, 4096, 8, heads, tokens,
                64) for heads, tokens in ((9, 9), (14, 9), (33, 3), (127, 1),
                                          (25, 5))]
# Calls of a shape per forward or step, where more than one.
CALLS = {"bit/dd8": 2, "xbd_bit/s4": 2, "xbd_bit_tta/s4": 2}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, torch, reps: int = 10, rounds: int = 5,
            queued: bool = False) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after one warm-up call. With ``queued`` each
    round first queues about 5 ms of other work (two 4096^2 fp32 products),
    so the host enqueues the calls while the device is busy and the events
    bracket device time alone: for a call whose kernels take less time than
    the host needs to enqueue them."""
    fn()
    blocker = torch.zeros(4096, 4096, device="cuda") if queued else None
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.mm(blocker, blocker)
            torch.mm(blocker, blocker)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)


def bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scaled_err(got, ref):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-3)


def _size_of(name: str) -> str:
    """Image-size group of a shape name: "512/s4/dates" -> "512",
    "1024b4/s4" -> "1024b4", "xbd_tta/s4" -> "xbd_tta", "s4/dates" -> "256"."""
    head = name.split("/")[0]
    return str(IMG) if head.startswith("s") else head


def _reps(n: int) -> dict:
    """Fewer timed calls at the large shapes, whose plain versions take
    tens of milliseconds."""
    return {"reps": 3, "rounds": 3} if n > 4096 else {}


def _reset_counts() -> None:
    from dahitra_tpu_torch.kernels import folded_decoder as fd
    from dahitra_tpu_torch.kernels import fused_decoder as kd
    from dahitra_tpu_torch.kernels import fused_tokenizer as ft

    fd.launches = fd.launches_save = fd.launches_bwd = ft.launches = 0
    fd.launches_pad = fd.launches_save_pad = fd.launches_bwd_pad = 0
    kd.launches = kd.launches_pad = 0


# The pad counters (the main-path runs send no token count that the kernels
# pad): every main-path run must read them 0.
NO_PAD = {"k1_pad": 0, "k1_save_pad": 0, "k2_pad": 0, "k4_pad": 0}


def _read_counts() -> dict:
    from dahitra_tpu_torch.kernels import folded_decoder as fd
    from dahitra_tpu_torch.kernels import fused_decoder as kd
    from dahitra_tpu_torch.kernels import fused_tokenizer as ft

    return {"k1": fd.launches, "k1_save": fd.launches_save,
            "k2": fd.launches_bwd, "k3": ft.launches, "k4": kd.launches,
            "k1_pad": fd.launches_pad, "k1_save_pad": fd.launches_save_pad,
            "k2_pad": fd.launches_bwd_pad, "k4_pad": kd.launches_pad}


def _set_pallas(model, on: bool, n_decoders: int = 3) -> None:
    """``pallas = on`` on the model's decoder stacks (DAHiTra's three,
    BIT's one), as a JAX user sets the field (no flag selects it)."""
    from dahitra_tpu_torch.nn.blocks import TransformerDecoder

    decs = [mod for mod in model.modules() if isinstance(mod, TransformerDecoder)]
    if len(decs) != n_decoders:
        fail(f"expected {n_decoders} TransformerDecoders, found {len(decs)}")
    for dec in decs:
        dec.pallas = on


def _shape(shape):
    """(name, b, n, depth, heads, tokens, dim_head) of a shape entry; the
    DAHiTra shapes leave out the 4 tokens and dim_head 64."""
    name, b, n, depth, heads, *rest = shape
    return (name, b, n, depth, heads, *(rest or (TOKENS, 64)))


def _decoder_operands(torch, dtype, gen, b, n, depth, heads, mlp=DIM,
                      tokens=TOKENS, dim_head=64):
    """Seeded kernel operands (x, a, z, w1, w2, vecs) of one decoder call,
    a cotangent dy and b1 (D, mlp) fp32 where mlp != 32 (else None), on
    the card in ``dtype``."""
    from dahitra_tpu_torch.nn.blocks import TransformerDecoder
    from dahitra_tpu_torch.nn.decoder_vjp import (_operands, _split_b1,
                                                  pack_decoder_params)

    dec = TransformerDecoder(DIM, depth, heads, dim_head, mlp)
    with torch.no_grad():
        for prm in dec.parameters():
            prm.add_(0.1 * torch.randn(prm.shape, generator=gen))
        x, m, dy = (torch.randn(b, k, DIM, generator=gen).cuda().to(dtype)
                    for k in (n, tokens, n))
        packed = pack_decoder_params(dec.cuda())
        ops = _operands(x, m, packed, depth, heads, dtype)
        b1 = _split_b1(packed)
    return ops, dy, None if b1 is None else b1.contiguous()


# How the row kernels' products run, per instance (the kernels line).
K1_DESIGN = {
    "float32": "tensor cores: mma.sync m16n8k16 bf16, each fp32 operand split "
               "exactly into three bf16 pieces, six piece products for each "
               "of the four per-row products (hn.A, attn.Z, g.W1, h.W2), a "
               "warp per 16 rows kept in registers across the layers",
    "bfloat16": "tensor cores: mma.sync m16n8k16 bf16, the four per-row "
                "products (hn.A, attn.Z, g.W1, h.W2), a warp per 16 rows kept "
                "in registers across the layers"}
K4_DESIGN = {
    "float32": "prologue: grid (layer, head, 4-sample chunk), the head's weight "
               "slices staged in shared memory, fp32 FMA; rows: tensor cores, "
               "mma.sync m16n8k16 bf16, each fp32 operand split exactly into "
               "three bf16 pieces, six piece products for each of the four "
               "per-row products, a warp per 16 rows kept in registers across "
               "the layers, the max-shifted group softmax inside the quad",
    "bfloat16": "prologue: grid (layer, head, 4-sample chunk), the head's "
                "weight slices staged in shared memory, fp32 FMA; rows: tensor "
                "cores, mma.sync m16n8k16 bf16 operands with fp32 "
                "accumulation for the four per-row products, a warp per 16 "
                "rows kept in registers across the layers, the max-shifted "
                "group softmax inside the quad"}
K2_DESIGN = {
    "float32": "tensor cores: mma.sync m16n8k16 bf16, each fp32 operand split "
               "exactly into three bf16 pieces, six piece products per "
               "product, for the per-row products and the weight-side sums",
    "bfloat16": "tensor cores: mma.sync m16n8k16 bf16, the per-row products "
                "and the weight-side sums"}
# Row-kernel instances whose registers, spills, tensor-core instructions
# and CTAs per SM phase 2 reports, per source: (instance, its mangled
# template arguments, dtype, flags of the source's occupancy entry, mlp_dim,
# pad). The mlp_dim-64 instances (BIT's decoder) carry the suffix "_mlp64",
# the PAD instances (token counts the tiles do not hold as they are) "_pad",
# K2's WIDE instances (fp32 at a padded hl whose 64-row tiles pass the shared
# memory a block may have: 2-warp CTAs) "_wide".
_MANGLED = {"float32": "f", "bfloat16": "13__nv_bfloat16"}
_MLPS = ((DIM, ""), (BIT_MLP, f"_mlp{BIT_MLP}"))
_PADS = ((0, ""), (1, "_pad"))
ROW_KERNELS = {
    "decoder_fwd": [(dname + "_save" * save + sfx + psfx,
                     f"rows_mmaI{_MANGLED[dname]}Lb{save}ELi{mlp}ELb{pad}EE",
                     dname, (save, mlp, pad), mlp, pad)
                    for pad, psfx in _PADS for mlp, sfx in _MLPS
                    for dname in ("float32", "bfloat16") for save in (0, 1)],
    "decoder_bwd": [(dname + sfx + psfx + "_wide" * wide,
                     f"rows_mmaI{_MANGLED[dname]}Li{mlp}ELb{pad}ELb{wide}EE",
                     dname, (mlp, pad), mlp, pad)
                    for wide in (0, 1) for pad, psfx in _PADS
                    for mlp, sfx in _MLPS
                    for dname in ("float32", "bfloat16")[:2 - wide]],
    # K4: (x's dtype, precise), named as its C entries.
    "fused_decoder": [(f"{io}_{ops}{sfx}{psfx}",
                       f"fused_decoder_rows_mmaI{_MANGLED[dname]}Lb{int(pr)}"
                       f"ELi{mlp}ELb{pad}EE", dname, (pr, mlp, pad), mlp, pad)
                      for pad, psfx in _PADS for mlp, sfx in _MLPS
                      for io, dname in (("f32", "float32"), ("bf16", "bfloat16"))
                      for ops, pr in (("precise", True), ("bf16ops", False))]}
# The K4 row-kernel instance of each model: fp32 I/O in both, operands fp32
# (precise) in the fp32 model and bf16 in the bf16 one; the bf16 model's
# bf16-I/O instance beside it.
K4_INSTANCES = {"float32": ("f32_precise",),
                "bfloat16": ("f32_bf16ops", "bf16_bf16ops")}


def start_ptxas_report(tmp, source):
    """One more nvcc of ``csrc/<source>.cu`` with the build's flags and
    ``-Xptxas -v``, started beside the build; ``row_kernel_resources`` reads
    it."""
    from dahitra_tpu_torch.kernels import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           os.path.join(tmp, f"{source}_ptxas.so"),
           str(_build._CSRC / f"{source}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _ctas_per_sm(torch, source, dname, flags, hl) -> int:
    """CTAs per SM of a row-kernel instance of ``ROW_KERNELS[source]`` at
    this hl, from the source's occupancy entry."""
    from dahitra_tpu_torch.kernels import folded_decoder as fd
    from dahitra_tpu_torch.kernels import fused_decoder as kd

    if source == "fused_decoder":
        precise, mlp, pad = flags
        return kd.ctas_per_sm(getattr(torch, dname), precise, mlp, hl, pad)
    return fd._ctas_per_sm(source, getattr(torch, dname), hl, *flags)


# hl of the main paths' decoder calls: DAHiTra's (16, 32) for the mlp_dim-32
# instances, BIT's (32, 64) for the mlp_dim-64 ones; for the PAD instances
# the padded hl of phase 3's new token counts (16, 32, 128) and, for K1's,
# also the WIDE_SHAPES' (132, 144, 200, 224, run by the same instances); for
# K2's, whose entry takes its WIDE instances there in fp32, the most the gate
# sends (224) for the WIDE instances and 144 for the bf16 PAD one.
MAIN_HLS = {DIM: sorted({_shape(s)[4] * _shape(s)[5]
                         for s in K1_SHAPES + [K1_SHAPE_512]}),
            BIT_MLP: sorted({_shape(s)[4] * _shape(s)[5] for s in BIT_SHAPES})}
PAD_HLS = (16, 32, 128)
WIDE_HLS = (132, 144, 200, 224)


def _resource_hls(source, inst, mlp, pad):
    """The hl at which phase 2 reports an instance's CTAs per SM."""
    if inst.endswith("_wide"):
        return (224,)
    if not pad:
        return MAIN_HLS[mlp]
    if source == "decoder_fwd":
        return PAD_HLS + WIDE_HLS
    return PAD_HLS + ((144,) if inst.startswith("bfloat16") else ())


def row_kernel_resources(torch, tmp, source, proc) -> dict:
    """Registers and spill bytes (ptxas) and ``HMMA.16816.F32.BF16``
    instructions (``cuobjdump -sass``) of each instance of
    ``ROW_KERNELS[source]``, and its CTAs per SM at every main-path hl (the
    source's occupancy entry; it sizes K2's grid)."""
    from dahitra_tpu_torch.kernels import _build

    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc -Xptxas -v of {source}.cu failed:\n{log}")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
         os.path.join(tmp, f"{source}_ptxas.so")],
        capture_output=True, text=True, check=True).stdout
    instances = ROW_KERNELS[source]

    def instance(line):
        return next((inst for inst, frag, *_ in instances if frag in line), None)

    out, inst = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            inst = instance(entry.group(1))
            continue
        if inst is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        regs = re.search(r"Used (\d+) registers", line)
        if spill:
            out.setdefault(inst, {}).update(
                spill_store_bytes=int(spill.group(1)),
                spill_load_bytes=int(spill.group(2)))
        if regs:
            out.setdefault(inst, {})["registers"] = int(regs.group(1))
    inst = None
    for line in sass.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            inst = instance(func.group(1))
        elif inst is not None and "HMMA.16816.F32.BF16" in line:
            out.setdefault(inst, {})["hmma"] = out[inst].get("hmma", 0) + 1
    for inst, _, dname, flags, mlp, pad in instances:
        if "registers" not in out.get(inst, {}) or not out[inst].get("hmma"):
            fail(f"no ptxas report or no HMMA.16816.F32.BF16 of {source}.cu's "
                 f"{inst} row kernel:\n{log}")
        out[inst]["ctas_per_sm"] = {
            hl: _ctas_per_sm(torch, source, dname, flags, hl)
            for hl in _resource_hls(source, inst, mlp, pad)}
    return out


def _k1_ops(b, n, depth, hl, mlp=DIM):
    """K1's operations: per row and layer the four products (2*32*hl twice,
    2*32*mlp twice) plus about 1400 + 5*hl elementwise operations at mlp 32
    (two LayerNorms, the clamped exp and divide, GELU, bias and residual
    adds) and about 20 more per hidden column beyond 32 (bias, GELU, the
    roundings)."""
    return b * n * depth * (4 * DIM * hl + 4 * DIM * mlp + 1400 + 5 * hl
                            + 20 * (mlp - DIM))


def _k2_ops(b, n, depth, hl, mlp=DIM):
    """K2's operations: per row and layer ten products (recomputed attn.Z
    and g.W1, dy.W2^T, dt.W1^T, dx1.Z^T, dl.A^T and the four weight-side
    sums), five of 2*32*hl and five of 2*32*mlp, plus about 2200 + 10*hl
    elementwise operations at mlp 32 (two LayerNorms and their backward,
    GELU and its derivative, the softmax backward, the vector sums) and
    about 30 more per hidden column beyond 32."""
    return b * n * depth * (10 * DIM * mlp + 10 * DIM * hl + 2200 + 10 * hl
                            + 30 * (mlp - DIM))


def _row(name, b, n, depth, hl, **kw):
    """A check line's shape fields, with its calls per forward or step."""
    return {"shape": name, "B": b, "N": n, "depth": depth, "hl": hl,
            "calls": CALLS.get(name, 1), **kw}


def check_k1(torch, dtype, gen, shapes=None, mlp=DIM):
    """K1 (its mlp_dim ``mlp`` instance) against its plain version at every
    decoder shape of ``shapes`` (the DAHiTra main paths' by default), and a
    rerun for the same bits."""
    from dahitra_tpu_torch.kernels import folded_decoder as fd

    dname = str(dtype).split(".")[-1]
    rows = []
    for shape in shapes or K1_SHAPES + [K1_SHAPE_512]:
        name, b, n, depth, heads, tokens, dim_head = _shape(shape)
        ops_in, _, b1 = _decoder_operands(torch, dtype, gen, b, n, depth,
                                          heads, mlp, tokens, dim_head)

        def k1():
            return fd.decoder_stack_fwd(*ops_in, depth, heads, dtype, b1=b1)

        got = k1()
        ref = fd.decoder_stack_fwd_plain(*ops_in, depth, heads, dtype, b1=b1)
        torch.cuda.synchronize()
        err, serr = scaled_err(got, ref)
        if not (torch.isfinite(got.float()).all() and serr <= TOL[dname]):
            fail(f"K1 {name} {dname}: scaled error {serr:.3e} > {TOL[dname]}")
        if not torch.equal(got, k1()):
            fail(f"K1 {name} {dname}: a second run gave other bits")
        hl = heads * tokens
        size = torch.finfo(dtype).bits // 8
        nbytes = (2 * b * n * DIM + sum(t.numel() for t in ops_in[1:5])) * size \
            + (ops_in[5].numel() + (0 if b1 is None else b1.numel())) * 4
        bms, by = bound(nbytes, _k1_ops(b, n, depth, hl, mlp), dname)
        rows.append(_row(
            name, b, n, depth, hl, max_abs_err=err, scaled_err=serr,
            ms=time_ms(k1, torch, **_reps(n)),
            device_ms=time_ms(k1, torch, queued=True, **_reps(n)),
            plain_ms=time_ms(lambda: fd.decoder_stack_fwd_plain(
                *ops_in, depth, heads, dtype, b1=b1), torch, **_reps(n)),
            bound_ms=bms, bound_by=by, library_ms=None))
    return rows


def check_k1_save_k2(torch, dtype, gen, shapes=None, mlp=DIM):
    """K1 with saves (y and both saves) and K2 (every gradient, from the
    kernel's own saves), their mlp_dim ``mlp`` instances, against their
    plain versions at every decoder shape of ``shapes`` (the DAHiTra
    training paths' by default), and a rerun of each for the same bits; no
    single PyTorch call computes either, so no library yardstick."""
    from dahitra_tpu_torch.kernels import folded_decoder as fd

    dname = str(dtype).split(".")[-1]
    size = torch.finfo(dtype).bits // 8
    fwd_rows, bwd_rows = [], []
    for shape in shapes or K1_SHAPES + [K1_SHAPE_512]:
        name, b, n, depth, heads, tokens, dim_head = _shape(shape)
        ops_in, dy, b1 = _decoder_operands(torch, dtype, gen, b, n, depth,
                                           heads, mlp, tokens, dim_head)
        hl = heads * tokens

        def k1_save():
            return fd.decoder_stack_fwd(*ops_in, depth, heads, dtype,
                                        save=True, b1=b1)

        def k2():
            return fd.decoder_stack_bwd(got[1], got[2], dy, *ops_in[1:], depth,
                                        heads, dtype, b1=b1)

        got = k1_save()
        ref = fd.decoder_stack_fwd_plain(*ops_in, depth, heads, dtype,
                                         save=True, b1=b1)
        grads = k2()
        gref = fd.decoder_stack_bwd_plain(got[1], got[2], dy, *ops_in[1:],
                                          depth, heads, dtype, b1=b1)
        torch.cuda.synchronize()
        if not torch.equal(got[0], fd.decoder_stack_fwd(*ops_in, depth, heads,
                                                        dtype, b1=b1)):
            fail(f"K1-save {name} {dname}: y differs from K1's")
        if not all(torch.equal(g, h) for g, h in zip(got, k1_save())):
            fail(f"K1-save {name} {dname}: a second run gave other bits")
        if not all(torch.equal(g, h) for g, h in zip(grads, k2())):
            fail(f"K2 {name} {dname}: a second run gave other bits")
        errs = [scaled_err(g, r) for g, r in zip(got, ref)]
        gerrs = [scaled_err(g, r) for g, r in zip(grads, gref)]
        if not (len(grads) == len(gref)
                and all(torch.isfinite(g.float()).all() for g in got + grads)
                and max(e[1] for e in errs) <= TOL[dname]
                and max(e[1] for e in gerrs) <= GTOL[dname]):
            fail(f"K1-save/K2 {name} {dname}: scaled errors "
                 f"{[e[1] for e in errs]} (tolerance {TOL[dname]}), "
                 f"{[e[1] for e in gerrs]} (tolerance {GTOL[dname]})")
        weights = sum(t.numel() for t in ops_in[1:5]) * size \
            + (ops_in[5].numel() + (0 if b1 is None else b1.numel())) * 4
        saves = depth * b * n * (DIM + hl) * size
        # K1-save: K1's reads and writes plus the saves.
        nbytes = 2 * b * n * DIM * size + weights + saves
        bms, by = bound(nbytes, _k1_ops(b, n, depth, hl, mlp), dname)
        fwd_rows.append(_row(
            name, b, n, depth, hl, max_abs_err=max(e[0] for e in errs),
            scaled_err=max(e[1] for e in errs),
            ms=time_ms(k1_save, torch, **_reps(n)),
            device_ms=time_ms(k1_save, torch, queued=True, **_reps(n)),
            plain_ms=time_ms(lambda: fd.decoder_stack_fwd_plain(
                *ops_in, depth, heads, dtype, save=True, b1=b1), torch,
                **_reps(n)),
            bound_ms=bms, bound_by=by, library_ms=None))
        # K2: reads the saves, dy and the weights; writes dx, dA, dZ (T)
        # and dW1, dW2, dvecs and db1 (fp32).
        nbytes = saves + 2 * b * n * DIM * size + weights \
            + (ops_in[1].numel() + ops_in[2].numel()) * size \
            + (2 * depth * DIM * mlp + depth * 7 * DIM
               + (0 if b1 is None else b1.numel())) * 4
        bms, by = bound(nbytes, _k2_ops(b, n, depth, hl, mlp), dname)
        bwd_rows.append(_row(
            name, b, n, depth, hl, max_abs_err=max(e[0] for e in gerrs),
            scaled_err=max(e[1] for e in gerrs),
            ms=time_ms(k2, torch, **_reps(n)),
            device_ms=time_ms(k2, torch, queued=True, **_reps(n)),
            plain_ms=time_ms(lambda: fd.decoder_stack_bwd_plain(
                got[1], got[2], dy, *ops_in[1:], depth, heads, dtype, b1=b1),
                torch, **_reps(n)),
            bound_ms=bms, bound_by=by, library_ms=None))
    return fwd_rows, bwd_rows


def empty_launch_ms(torch) -> float:
    """One launch of an empty kernel (``csrc/launch_floor.cu``), back to
    back on the current stream behind queued work: the floor under any
    kernel's time."""
    import ctypes

    from dahitra_tpu_torch.kernels import _build

    fn = _build.load("launch_floor").empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        _build.check(fn(stream), "empty_launch")

    return time_ms(launch, torch, reps=100, queued=True)


def check_k3(torch, dtype, gen):
    """K3 against its plain version at every main-path tokenizer shape (256
    and 512 px at batch 8, 1024 px at batch 2, the xBD path's at 1024 px
    batch 1 and 4); a second call must give the
    same bits. ``ms`` is timed as every kernel's is, the calls made back to
    back on an idle card, which at these sizes is mostly the host's time to
    enqueue two kernels; ``device_ms`` is the same calls enqueued behind
    queued work, device time alone. The library
    yardstick is one scaled_dot_product_attention call with the L
    token-logit columns as queries and the pixels as keys and values."""
    import torch.nn.functional as F

    from dahitra_tpu_torch.kernels import fused_tokenizer as ft

    dname = str(dtype).split(".")[-1]
    rows = []
    for name, b, n in K3_SHAPES:
        x = torch.randn(b, n, DIM, generator=gen).cuda().to(dtype)
        w = (torch.randn(DIM, TOKENS, generator=gen) * DIM ** -0.5).cuda().to(dtype)
        got = ft.semantic_tokenizer(x, w)
        ref = ft.semantic_tokenizer_plain(x, w)
        torch.cuda.synchronize()
        err, serr = scaled_err(got, ref)
        if not (torch.isfinite(got.float()).all() and serr <= TOL[dname]):
            fail(f"K3 {name} {dname}: scaled error {serr:.3e} > {TOL[dname]}")
        if not torch.equal(got, ft.semantic_tokenizer(x, w)):
            fail(f"K3 {name} {dname}: a second run gave other bits")
        q = w.t().unsqueeze(0).expand(b, TOKENS, DIM)
        lib = F.scaled_dot_product_attention(q, x, x, scale=1.0)
        _, lib_err = scaled_err(lib, ref)
        if lib_err > 10 * TOL[dname]:
            fail(f"K3 {name}: library yardstick disagrees ({lib_err:.3e})")
        itemsize = torch.finfo(dtype).bits // 8
        nbytes = (b * n * DIM + DIM * TOKENS + b * TOKENS * DIM) * itemsize
        # logits and pooling products, plus max, exp, sum and scale per
        # logit.
        ops = b * n * (4 * DIM * TOKENS + 5 * TOKENS)
        bms, by = bound(nbytes, ops, dname)
        rows.append({
            "shape": name, "B": b, "N": n, "L": TOKENS,
            "calls": CALLS.get(name, 1),
            "max_abs_err": err, "scaled_err": serr,
            "ms": time_ms(lambda: ft.semantic_tokenizer(x, w), torch),
            "device_ms": time_ms(lambda: ft.semantic_tokenizer(x, w), torch,
                                 queued=True),
            "plain_ms": time_ms(lambda: ft.semantic_tokenizer_plain(x, w), torch),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, x, x, scale=1.0), torch)})
    return rows


def _k4_operands(torch, gen, b, n, depth, heads, io_dtype, mlp=DIM,
                 tokens=TOKENS, dim_head=64):
    """Seeded x (B, N, 32) in ``io_dtype``, fp32 memory tokens m (B, tokens,
    32) and the packed fp32 weights of one decoder call, on the card."""
    from dahitra_tpu_torch.nn.blocks import TransformerDecoder
    from dahitra_tpu_torch.nn.decoder_vjp import pack_decoder_params

    dec = TransformerDecoder(DIM, depth, heads, dim_head, mlp)
    with torch.no_grad():
        for prm in dec.parameters():
            prm.add_(0.1 * torch.randn(prm.shape, generator=gen))
        packed = {k: v.cuda() for k, v in pack_decoder_params(dec).items()}
    x = torch.randn(b, n, DIM, generator=gen).cuda().to(io_dtype)
    m = torch.randn(b, tokens, DIM, generator=gen).cuda()
    return x, m, packed


def _k4_cost(b, n, depth, heads, io_size, mlp=DIM, tokens=TOKENS,
             dim_head=64):
    """K4's bytes (x read and y written, m and the fp32 weights read once)
    and operations: K1's row work plus the memory side once per sample and
    layer (k and v, 2 * 2 * L * 32 * inner; A and Z, 2 * 2 * heads * L *
    dim_head * 32)."""
    hl, inner = heads * tokens, heads * dim_head
    nbytes = 2 * b * n * DIM * io_size + b * tokens * DIM * 4 \
        + depth * (4 * DIM * inner + 2 * DIM * mlp + 6 * DIM + mlp) * 4
    ops = _k1_ops(b, n, depth, hl, mlp) + b * depth * (
        2 * 2 * tokens * DIM * inner + 2 * 2 * heads * tokens * dim_head * DIM)
    return nbytes, ops


def check_k4(torch, dtype, gen, shapes=None, mlp=DIM):
    """K4 (its mlp_dim ``mlp`` instance) against ``fused_decoder_plain`` at
    every decoder shape of ``shapes`` (the DAHiTra main paths' by default)
    in the mode of the ``dtype`` model: fp32 I/O (the decoder input is fp32
    in both models, after the positional add), operands fp32 (``precise``)
    in the fp32 model and bf16 in the bf16 one; a rerun for the same bits;
    the prologue's A and Z (``fused_decoder_az``) against
    ``fused_decoder_az_plain``. Timed as K1 is, and behind queued work
    (``device_ms``), with the prologue (``prologue_ms``) and the row kernel
    on its A and Z (``rows_ms``) timed apart, behind queued work. No single
    PyTorch call computes the stack, so no library yardstick. Returns the
    per-forward rows and, for the bf16 model on the default shapes, the
    bf16-I/O instance at s4/diff."""
    from dahitra_tpu_torch.kernels import fused_decoder as kd

    dname = str(dtype).split(".")[-1]
    precise = dtype == torch.float32
    cases = [(shape, torch.float32)
             for shape in shapes or K1_SHAPES + [K1_SHAPE_512]]
    if not precise and shapes is None:
        cases.append((K1_SHAPES[1], torch.bfloat16))
    rows, io_rows = [], []
    for shape, io in cases:
        name, b, n, depth, heads, tokens, dim_head = _shape(shape)
        x, m, packed = _k4_operands(torch, gen, b, n, depth, heads, io, mlp,
                                    tokens, dim_head)

        def k4():
            return kd.fused_transformer_decoder(x, m, packed, depth, heads,
                                                precise)

        got = k4()
        ref = kd.fused_decoder_plain(x, m, packed, depth, heads, precise)
        a, z = kd.fused_decoder_az(m, packed, depth, heads, precise)
        ref_a, ref_z = kd.fused_decoder_az_plain(m, packed, depth, heads,
                                                 precise)
        torch.cuda.synchronize()
        err, serr = scaled_err(got, ref)
        az_err = max(scaled_err(a, ref_a)[1], scaled_err(z, ref_z)[1])
        if not (got.dtype == io and torch.isfinite(got.float()).all()
                and serr <= TOL[dname] and az_err <= TOL[dname]):
            fail(f"K4 {name} {dname} (I/O {io}): scaled error {serr:.3e}, "
                 f"prologue's {az_err:.3e} > {TOL[dname]}")
        if not torch.equal(got, k4()):
            fail(f"K4 {name} {dname} (I/O {io}): a second run gave other bits")
        vecs = kd._vecs(packed)
        # The row kernel alone runs on the memory side of the padded tokens
        # where the wrapper pads them (fault 3.2's counts).
        lp = kd._group(tokens)
        mp = torch.cat([m, m.new_zeros(b, lp - tokens, DIM)], 1)
        ap, zp = kd.fused_decoder_az(mp, packed, depth, heads, precise)
        nbytes, ops = _k4_cost(b, n, depth, heads, torch.finfo(io).bits // 8,
                               mlp, tokens, dim_head)
        bms, by = bound(nbytes, ops, dname)
        row = _row(name, b, n, depth, heads * tokens,
                   io=str(io).split(".")[-1], max_abs_err=err,
                   scaled_err=serr, prologue_scaled_err=az_err,
                   ms=time_ms(k4, torch, **_reps(n)),
                   device_ms=time_ms(k4, torch, queued=True, **_reps(n)),
                   prologue_ms=time_ms(lambda: kd.fused_decoder_az(
                       m, packed, depth, heads, precise), torch, queued=True),
                   rows_ms=time_ms(lambda: kd._rows(
                       x, ap, zp, packed, vecs, depth, heads, precise,
                       tokens), torch, queued=True, **_reps(n)),
                   plain_ms=time_ms(lambda: kd.fused_decoder_plain(
                       x, m, packed, depth, heads, precise), torch,
                       **_reps(n)),
                   bound_ms=bms, bound_by=by, library_ms=None)
        (rows if io == torch.float32 else io_rows).append(row)
    return rows, io_rows


def check_k4_grads(torch, gen) -> dict:
    """``FusedDecoderFn``'s gradients on the card (x, m and all 13 packed
    tensors; the backward is autograd of ``plain_decoder_stack`` there)
    against autograd of ``plain_decoder_stack`` on the CPU, fp32, at the
    1/4-scale dates shape, each to GTOL scale-normalized. Also times one
    forward and backward on the card."""
    from dahitra_tpu_torch.kernels import fused_decoder as kd

    name, b, n, depth, heads = K1_SHAPES[0]
    x, m, packed = _k4_operands(torch, gen, b, n, depth, heads, torch.float32)
    dy = torch.randn(b, n, DIM, generator=gen)

    def grads(dev, fn):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in (x, m, *(packed[k] for k in kd.ORDER))]
        return torch.autograd.grad(fn(leaves), leaves, dy.to(dev))

    def card(leaves):
        return kd.FusedDecoderFn.apply(depth, heads, torch.float32, *leaves)

    def cpu(leaves):
        return kd.plain_decoder_stack(leaves[0], leaves[1],
                                      dict(zip(kd.ORDER, leaves[2:])), depth,
                                      heads, torch.float32)

    got = grads("cuda", card)
    ref = grads("cpu", cpu)
    torch.cuda.synchronize()
    errs = {k: scaled_err(g.cpu(), r)[1]
            for k, g, r in zip(("x", "m", *kd.ORDER), got, ref)}
    worst = max((e, k) for k, e in errs.items())
    if not (all(torch.isfinite(g).all() for g in got)
            and worst[0] <= GTOL["float32"]):
        fail(f"K4 gradients on the card disagree with the CPU: {errs}")
    return {"k4_grads_vs_cpu_plain": {
        "shape": name, "worst_scaled_err": worst[0], "at": worst[1],
        "tolerance": GTOL["float32"],
        "fwd_bwd_ms": time_ms(lambda: grads("cuda", card), torch, reps=3,
                              rounds=3)}}


def _sums(rows) -> dict:
    """Times and bounds summed over the rows, each row ``calls`` times (its
    calls per forward or step); errors the worst."""
    def total(k):
        return sum(r[k] * r.get("calls", 1) for r in rows)

    lib = [r["library_ms"] for r in rows]
    bound_ms = total("bound_ms")
    by_ops = sum(r["bound_ms"] * r.get("calls", 1) for r in rows
                 if r["bound_by"] == "operations")
    device = {k: total(k)
              for k in ("device_ms", "prologue_ms", "rows_ms") if k in rows[0]}
    return {
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "scaled_err": max(r["scaled_err"] for r in rows),
        "ms": total("ms"), **device,
        "plain_ms": total("plain_ms"),
        "bound_ms": bound_ms,
        "bound_by": "operations" if by_ops >= bound_ms / 2 else "bytes",
        "library_ms": None if None in lib else total("library_ms"),
    }


def summarize(name, source, replaces, dname, rows, launches, tol,
              by_phase=None, main_size=str(IMG), **extra):
    """One kernel entry: times summed over the kernel's launches in one
    batch-8 forward (K1, K3, K4) or training step (K1-save, K2) of the main
    path (DAHiTra at 256 px; BIT's for the mlp_dim-64 instances,
    ``main_size`` "bit"), errors the worst over those shapes; the other
    shapes under ``other_sizes``, summed per image size or model;
    ``launches_by_phase`` the kernel's count in every main-path run."""
    by_size = {}
    for r in rows:
        by_size.setdefault(_size_of(r["shape"]), []).append(r)
    main = by_size.pop(main_size)
    return {
        "name": f"{name}[{dname}]", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        **_sums(main), "tolerance": tol[dname],
        "per_forward_shapes": main,
        "other_sizes": {k: {**_sums(v), "shapes": v}
                        for k, v in by_size.items()},
        "launches_by_phase": by_phase or {}, **extra,
    }


# Kernel-name fragments -> class, first match wins (torch.profiler names).
_CLASSES = (("K4 prologue", ("fused_decoder_prologue",)),
            ("K4 rows", ("fused_decoder_rows",)),
            ("K1-save decoder_stack_fwd (save)",
             ("decoder_stack_fwd_rows_mma<float, true,",
              "decoder_stack_fwd_rows_mma<__nv_bfloat16, true,")),
            ("K1 decoder_stack_fwd", ("decoder_stack_fwd",)),
            ("K2 decoder_stack_bwd", ("decoder_stack_bwd",)),
            ("K3 semantic_tokenizer", ("stats_kernel", "pool_kernel")),
            ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad",
                                     "implicit", "fft", "winograd",
                                     "complex")),
            ("matmul (cuBLAS)", ("gemm", "Gemm", "cutlass")),
            ("softmax / layer norm", ("softmax", "norm")))


def _profile(torch, fn, reps: int) -> dict:
    """Device time by kernel class over ``reps`` calls of ``fn``, the
    device's idle share against the CUDA-event time of one call, and each
    kernel's launches per call (its counter over the profiled calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call_ms = time_ms(fn, torch, reps=reps, rounds=3)
    # A process's first profiler window starts the tracer inside its
    # window and inflates that window's device times: spend one first.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    _reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launches = {k: c / reps for k, c in _read_counts().items()}
    # Device-side kernel events only: an operator row (aten::...) repeats
    # the time of the kernels it launched, and a user annotation's device
    # range ("Optimizer.step#AdamW.step") spans kernels already counted.
    kernels = [(e.key, e.self_device_time_total / reps / 1e3, e.count / reps)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("Optimizer.")]
    by_class = {}
    for name, ms, _ in kernels:
        cls = next((c for c, frags in _CLASSES
                    if any(f in name for f in frags)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    busy = sum(ms for _, ms, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    return {"batch": BATCH, "call_ms": call_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / call_ms),
            "by_class_ms": by_class, "launches_per_call": launches,
            "top": [{"kernel": n[:90], "ms": ms, "calls": c}
                    for n, ms, c in kernels[:12]]}


def _batch(torch, n, seed, img: int = IMG):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 256, (n, img, img, 3), generator=g,
                          dtype=torch.uint8).cuda(),
            torch.randint(0, 256, (n, img, img, 3), generator=g,
                          dtype=torch.uint8).cuda(),
            torch.randint(0, 2, (n, img, img), generator=g,
                          dtype=torch.uint8).cuda())


def profile_forward(torch, state_dict, dtype, pallas: bool = False,
                    net_g: str = "newUNetTrans", n_decoders: int = 3) -> dict:
    """torch.profiler over five batch-8 forwards of the port's model."""
    from dahitra_tpu_torch.core.checkpoint import load_weights
    from dahitra_tpu_torch.data.augment import normalize_images
    from dahitra_tpu_torch.models.registry import define_g

    model = define_g(net_g, dtype=dtype, img_size=IMG)
    load_weights(model, state_dict)
    model.cuda().eval()
    _set_pallas(model, pallas, n_decoders)
    a_u8, b_u8, _ = _batch(torch, BATCH, 1)
    a, b = normalize_images(a_u8, dtype), normalize_images(b_u8, dtype)
    with torch.inference_mode():
        out = _profile(torch, lambda: model(a, b), reps=5)
    return {"profile": "forward", "net_G": net_g,
            "dtype": str(dtype).split(".")[-1], "pallas": pallas, **out}


def _trainer(torch, tmp, dtype, tag, img: int = IMG, batch: int = BATCH,
             net_g: str = "newUNetTrans"):
    """A ``CDTrainer`` on the card with no data of its own, for
    ``train_step`` on a seeded batch."""
    import types

    from dahitra_tpu_torch.train.engine import CDTrainer

    args = types.SimpleNamespace(
        n_class=2, checkpoint_dir=os.path.join(tmp, f"{tag}_{dtype}"),
        max_epochs=1, bf16=dtype == torch.bfloat16, seed=0,
        net_G=net_g, img_size=img, lr=5e-4, batch_size=batch)
    empty = {k: np.zeros((0, 1), np.uint8) for k in ("a", "b", "label")}
    return CDTrainer(args, empty, empty, device="cuda")


def profile_train_step(torch, tmp, dtype, pallas: bool = False,
                       net_g: str = "newUNetTrans", n_decoders: int = 3) -> dict:
    """torch.profiler over three batch-8 training steps of ``CDTrainer``
    (augmentation, train forward, loss, backward, AdamW)."""
    trainer = _trainer(torch, tmp, dtype, f"profile_{net_g}", net_g=net_g)
    _set_pallas(trainer.model, pallas, n_decoders)
    batch = _batch(torch, BATCH, 2)
    out = _profile(torch, lambda: trainer.train_step(*batch), reps=3)
    return {"profile": "train_step", "net_G": net_g,
            "dtype": str(dtype).split(".")[-1], "pallas": pallas, **out}


def _patches(torch, tmp):
    """The 64 synthetic 256 px test patches (4 tiles of 1024 px, 16 patches
    each) as uint8 pairs on the card."""
    from dahitra_tpu_torch.data.levir import load_levir_split

    tiles = load_levir_split(os.path.join(tmp, "data", "LEVIR_CD"), "test",
                             4 * IMG)
    k = 4 * IMG // IMG
    return [torch.from_numpy(t.reshape(-1, k, IMG, k, IMG, 3)
                             .transpose(0, 1, 3, 2, 4, 5)
                             .reshape(-1, IMG, IMG, 3).copy()).cuda()
            for t in (tiles.a, tiles.b)]


def run_pallas_eval(torch, tmp, dtype, net_g: str = "newUNetTrans",
                    project: str = "smoke", per_forward=(6, 3),
                    n_decoders: int = 3) -> dict:
    """Batch-8 forwards of ``net_g`` (the checkpoint of phase 4, or of the
    BIT phase) over the 64 synthetic patches with ``pallas = True`` on its
    decoders, launch counters set to 0 just before and read just after:
    ``per_forward`` (K4, K3) launches per forward (DAHiTra 6 and 3, BIT 2
    and 2), no K1, K1-save or K2. One default-path pass warms up first; the
    rates are means over two passes of each path taken in turns (pallas,
    default, default, pallas; the first is the counted one). In fp32 the
    pallas logits must agree with the default (K1) path's on the same
    weights to 1e-3 scale-normalized, with argmax agreement >= 99.9 %."""
    from dahitra_tpu_torch.core.checkpoint import load_checkpoint, load_weights
    from dahitra_tpu_torch.data.augment import normalize_images
    from dahitra_tpu_torch.models.registry import define_g

    dname = str(dtype).split(".")[-1]
    model = define_g(net_g, dtype=dtype, img_size=IMG)
    load_weights(model, load_checkpoint(os.path.join(tmp, "ckpt", project))[0])
    model.cuda().eval()
    a, b = _patches(torch, tmp)

    def run(pallas):
        _set_pallas(model, pallas, n_decoders)
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            out = torch.cat([model(normalize_images(a[i:i + BATCH], dtype),
                                   normalize_images(b[i:i + BATCH], dtype))
                             for i in range(0, len(a), BATCH)])
        torch.cuda.synchronize()
        return out, len(a) / (time.time() - t0)

    run(False)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    logits, rate = run(True)
    got = _read_counts()
    n_fwd = len(a) // BATCH
    want = {"k1": 0, "k1_save": 0, "k2": 0, "k3": per_forward[1] * n_fwd,
            "k4": per_forward[0] * n_fwd}
    if got != {**NO_PAD, **want} or not torch.isfinite(logits.float()).all():
        fail(f"pallas eval {net_g} {dname}: launches {got} != {want} or "
             "logits not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ref, d1 = run(False)
    d2, p2 = run(False)[1], run(True)[1]
    out = {"pallas_eval": dname, "net_G": net_g,
           "pairs_per_s": (rate + p2) / 2,
           "default_path_pairs_per_s": (d1 + d2) / 2,
           "peak_mem_gib": peak, "launches": got}
    if dtype == torch.float32:
        _, serr = scaled_err(logits, ref)
        agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
        out["vs_k1_path"] = {"scaled_err": serr, "argmax_agreement": agree}
        if not (serr <= 1e-3 and agree >= 0.999):
            fail(f"pallas eval {net_g} fp32 disagrees with the K1 path: {out}")
    return out


def run_pallas_train(torch, tmp, dtype, steps: int = 4) -> dict:
    """``steps`` batch-8 ``CDTrainer.train_step`` calls with ``pallas = True``
    on the model's decoders, launch counters set to 0 just before and read
    just after: 6 K4 and 3 K3 per step, no K1, K1-save or K2, finite
    losses. One default-path step warms up first; the step times are means
    over two runs of ``steps`` steps of each path on the same trainer,
    taken in turns (pallas, default, default, pallas; the first is the
    counted one)."""
    dname = str(dtype).split(".")[-1]
    trainer = _trainer(torch, tmp, dtype, "pallas")
    batch = _batch(torch, BATCH, 2)

    def run(pallas):
        _set_pallas(trainer.model, pallas)
        torch.cuda.synchronize()
        t0 = time.time()
        losses = [trainer.train_step(*batch)[0] for _ in range(steps)]
        torch.cuda.synchronize()
        return [v.item() for v in losses], (time.time() - t0) / steps * 1e3

    trainer.train_step(*batch)
    _reset_counts()
    losses, step_ms = run(True)
    got = _read_counts()
    want = {"k1": 0, "k1_save": 0, "k2": 0, "k3": 3 * steps, "k4": 6 * steps}
    if got != {**NO_PAD, **want} or not all(np.isfinite(losses)):
        fail(f"pallas train {dname}: launches {got} != {want} or losses "
             f"{losses}")
    d1, d2, p2 = run(False)[1], run(False)[1], run(True)[1]
    return {"pallas_train": dname, "step_ms": (step_ms + p2) / 2,
            "default_path_step_ms": (d1 + d2) / 2, "losses": losses,
            "launches": got}


def run_eval(torch, data_root, ckpt_root, project, flag, dname, img, batch,
             n_pairs, patches=None, net_g: str = "newUNetTrans",
             per_forward=(6, 3)) -> dict:
    """``eval_cd --net_G net_g`` on the card over ``n_pairs`` pairs of
    ``img`` px, launch counters set to 0 just before and read just after:
    ``per_forward`` (K1, K3) launches per forward (DAHiTra 6 and 3, BIT 2
    and 2, ResNetCD none), no K1-save, K2 or K4; scores in range, and a
    score block per patch where the patch sweep applies."""
    from dahitra_tpu_torch.cli import eval_cd

    os.environ["DAHITRA_DATA_ROOT"] = data_root
    argv = ["--checkpoint_root", ckpt_root, "--project_name", project,
            "--data_name", "LEVIR", "--split", "test", "--img_size", str(img),
            "--batch_size", str(batch), "--num_patches", str(patches or 16),
            "--net_G", net_g, "--device", "cuda", *flag]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    scores = eval_cd.main(argv)
    torch.cuda.synchronize()
    got = _read_counts()
    n_forward = -(-n_pairs // batch)
    want = {"k1": per_forward[0] * n_forward, "k1_save": 0, "k2": 0,
            "k3": per_forward[1] * n_forward, "k4": 0}
    if got != {**NO_PAD, **want}:
        fail(f"eval {net_g} {img} px {dname}: launches {got} != {want}")
    in_range = all(0.0 <= scores[k] <= 1.0 for k in ("acc", "miou", "mf1"))
    if not in_range or len(scores.get("per_group", [])) != (patches or 0):
        fail(f"eval {net_g} {img} px {dname}: scores out of range or patch "
             f"blocks missing: {scores}")
    return {"eval": dname, "net_G": net_g, "img_size": img, "batch": batch,
            "pairs": n_pairs,
            "pairs_per_s": scores["imps"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": got,
            "scores": {k: scores[k] for k in ("acc", "miou", "mf1", "F1_1",
                                              "iou_1")}}


def check_forward_vs_cpu(torch, model, data_root, img, n_pairs, patch=None
                         ) -> dict:
    """The card's fp32 forward (kernels) of ``n_pairs`` test pairs against
    the port's plain path on the CPU: <= 1e-3 scale-normalized, argmax
    agreement >= 99.9 %. Leaves ``model`` on the card."""
    from dahitra_tpu_torch.data.augment import normalize_images
    from dahitra_tpu_torch.data.levir import load_levir_split

    pairs = load_levir_split(os.path.join(data_root, "LEVIR_CD"), "test", img,
                             patch=patch)
    a_u8 = torch.from_numpy(pairs.a[:n_pairs])
    b_u8 = torch.from_numpy(pairs.b[:n_pairs])
    with torch.inference_mode():
        ref = model.cpu().eval()(normalize_images(a_u8), normalize_images(b_u8))
        got = model.cuda()(normalize_images(a_u8.cuda()),
                           normalize_images(b_u8.cuda())).cpu()
    _, serr = scaled_err(got, ref)
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    out = {"forward_vs_cpu_plain": {"img_size": img, "pairs": n_pairs,
                                    "scaled_err": serr,
                                    "argmax_agreement": agree}}
    if not (torch.isfinite(got).all() and serr <= 1e-3 and agree >= 0.999):
        fail(f"card forward disagrees with the CPU plain path: {out} "
             "(tolerance 1e-3, agreement 0.999)")
    return out


def run_training(torch, root, flag, dname, img: int = IMG, batch: int = BATCH,
                 epochs: int = EPOCHS, train_pairs: int = TRAIN_PAIRS,
                 val_pairs: int = VAL_PAIRS, net_g: str = "newUNetTrans",
                 per_call=(6, 3)) -> dict:
    """``main_cd --net_G net_g`` for ``epochs`` epochs on the synthetic
    splits under ``root``, launch counters set to 0 just before and read
    just after: ``per_call`` (decoder, K3) launches per training step (K1-save
    and K2) and per validation forward (K1); DAHiTra 6 and 3, BIT 2 and 2."""
    from dahitra_tpu_torch.cli import main_cd

    project = f"train_{dname}" if net_g == "newUNetTrans" \
        else f"train_{net_g}_{dname}"
    os.environ["DAHITRA_DATA_ROOT"] = os.path.join(root, "data")
    argv = ["--checkpoint_root", os.path.join(root, "ckpt"),
            "--project_name", project, "--data_name", "LEVIR",
            "--img_size", str(img), "--batch_size", str(batch),
            "--max_epochs", str(epochs), "--log_every", "2", "--skip_test",
            "--net_G", net_g, "--device", "cuda", *flag]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    history = main_cd.main(argv)
    torch.cuda.synchronize()
    got = _read_counts()
    steps = epochs * train_pairs // batch
    vals = epochs * val_pairs // batch
    dec, k3 = per_call
    want = {"k1": dec * vals, "k1_save": dec * steps, "k2": dec * steps,
            "k3": k3 * (steps + vals), "k4": 0}
    if got != {**NO_PAD, **want}:
        fail(f"training {net_g} {img} px {dname}: launches {got} != {want}")
    ckpt = os.path.join(root, "ckpt", project)
    missing = [f for f in ("best_ckpt.pt", "log.txt", "train_acc.npy",
                           "val_acc.npy")
               if not os.path.exists(os.path.join(ckpt, f))]
    losses = [h["loss"] for h in history]
    if missing or len(history) != epochs \
            or not all(np.isfinite(losses)):
        fail(f"training {net_g} {img} px {dname}: artifacts missing "
             f"{missing} or losses {losses}")
    return {"train": dname, "net_G": net_g, "img_size": img, "batch": batch,
            "pairs_per_s_by_epoch": [h["imps"] for h in history],
            "loss_by_epoch": losses,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": got}


def run_step_1024(torch, tmp, dtype, pallas: bool) -> dict:
    """One ``CDTrainer.train_step`` at 1024 px on a seeded batch (a first
    step warms up and lets cuDNN choose), launch counters set to 0 just
    before and read just after: 6 K1-save, 6 K2 and 3 K3 on the default
    path, 6 K4 and 3 K3 with ``pallas = True``; finite loss."""
    dname = str(dtype).split(".")[-1]
    batch = STEP_1024_BATCH
    torch.cuda.empty_cache()
    trainer = _trainer(torch, tmp, dtype, f"step1024_{int(pallas)}", img=1024,
                       batch=batch)
    _set_pallas(trainer.model, pallas)
    data = _batch(torch, batch, 4, img=1024)
    trainer.train_step(*data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.time()
    loss = trainer.train_step(*data)[0].item()
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) * 1e3
    got = _read_counts()
    want = {"k1": 0, "k1_save": 0, "k2": 0, "k3": 3, "k4": 6} if pallas else \
        {"k1": 0, "k1_save": 6, "k2": 6, "k3": 3, "k4": 0}
    if got != {**NO_PAD, **want} or not np.isfinite(loss):
        fail(f"1024 px step {dname} pallas={pallas}: launches {got} != {want} "
             f"or loss {loss}")
    return {"train_step_1024": dname, "pallas": pallas, "batch": batch,
            "step_ms": step_ms, "loss": loss,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": got}


def check_train_grads(torch, root, pallas: bool = False,
                      net_g: str = "newUNetTrans", n_decoders: int = 3) -> dict:
    """The card's fp32 training gradients against the port's plain path on
    the CPU: one batch of 2 at 256 px, no augmentation, train-mode forward,
    ``levir_train_loss`` and backward. Every parameter's gradient must agree
    to 1e-3 of the gradient's scale (its largest element over all
    parameters) and the updated BN running statistics to 1e-4,
    scale-normalized per tensor.

    The scale is the whole gradient's, not each tensor's own: fp32
    summation order moves a few ReLU inputs that lie within ~1e-6 of zero
    across the kink, and each such flip moves the gradients of the
    convolutions below it by about 1 % of their own largest element
    (tests/test_torch_dahitra.py::test_train_grads_match_flax measures the
    same on JAX alone). The worst per-tensor error on its own scale is
    printed beside. With ``pallas`` both models set ``pallas = True`` on
    their decoders (K4 and the plain-stack backward on the card, their plain
    versions on the CPU)."""
    import copy

    from dahitra_tpu_torch.data.augment import augment_pairs
    from dahitra_tpu_torch.data.levir import load_levir_split
    from dahitra_tpu_torch.losses.cd import levir_train_loss
    from dahitra_tpu_torch.models.registry import define_g
    from dahitra_tpu_torch.nn.init import init_weights

    pairs = load_levir_split(os.path.join(root, "data", "LEVIR_CD"), "train",
                             IMG)
    batch = [torch.from_numpy(t[:2]) for t in (pairs.a, pairs.b, pairs.label)]
    gen = torch.Generator().manual_seed(3)
    model = init_weights(define_g(net_g, img_size=IMG, generator=gen),
                         "normal", 0.02, gen)
    _set_pallas(model, pallas, n_decoders)
    models = {"cpu": model, "cuda": copy.deepcopy(model).cuda()}
    for dev, m in models.items():
        a, b, label = augment_pairs(*(t.to(dev) for t in batch), train=False)
        levir_train_loss(m(a, b, train=True).float(), label, 2).backward()
    torch.cuda.synchronize()
    cuda_params = dict(models["cuda"].named_parameters())
    scale = max(p.grad.abs().max().item() for p in model.parameters())
    errs = {k: ((cuda_params[k].grad.cpu() - p.grad).abs().max().item(),
                p.grad.abs().max().item())
            for k, p in model.named_parameters()}
    worst = max((e / scale, k) for k, (e, _) in errs.items())
    worst_own = max((e / max(own, 1e-30), k) for k, (e, own) in errs.items())
    cuda_bufs = dict(models["cuda"].named_buffers())
    worst_stat = max((scaled_err(cuda_bufs[k].cpu(), v)[1], k)
                     for k, v in model.named_buffers())
    out = {"train_grads_vs_cpu_plain" + ("_pallas" if pallas else ""): {
        "net_G": net_g, "pallas": pallas,
        "worst_grad_err_over_scale": worst[0], "at": worst[1],
        "grad_scale": scale, "worst_grad_err_own_scale": worst_own[0],
        "own_at": worst_own[1], "n_params": len(errs),
        "worst_bn_stat_scaled_err": worst_stat[0], "stat_at": worst_stat[1]}}
    if worst[0] > 1e-3 or worst_stat[0] > 1e-4:
        fail(f"card training gradients disagree with the CPU plain path: "
             f"{out}")
    return out


def run_bit_phase(torch, tmp, train_root, dtypes) -> dict:
    """Phase 14: BIT's main path (``base_transformer_pos_s4_dd8``, its decoder
    at mlp_dim 64) and ``base_resnet18``, through the entry points. Writes
    seeded checkpoints of both (``nn/init.py`` ``init_random``); runs
    ``eval_cd`` at batch 8 over phase 4's 64 patches in fp32 and bf16 (2 K1
    and 2 K3 per forward: the decoder and the tokenizer once per date); holds
    the card's fp32 forward of two patches against the CPU plain path; runs
    ``main_cd`` for 2 epochs at batch 8 on phase 7's splits in both dtypes
    (2 K1-save, 2 K2 and 2 K3 per step; 2 K1 and 2 K3 per validation
    forward); holds the card's fp32 training gradients and BN statistics
    against the CPU plain path; runs the pallas forwards (2 K4 and 2 K3 per
    forward; fp32 logits within 1e-3 of the K1 path); and one ``eval_cd
    --net_G base_resnet18`` forward (no decoder or tokenizer kernel).
    Returns the launch counts by dtype and phase."""
    from dahitra_tpu_torch.core.checkpoint import save_checkpoint
    from dahitra_tpu_torch.models.registry import define_g
    from dahitra_tpu_torch.nn.init import init_random

    data = os.path.join(tmp, "data")
    ckpt = os.path.join(tmp, "ckpt")
    models = {}
    for key, seed in ((BIT_KEY, 14), ("base_resnet18", 15)):
        models[key] = init_random(define_g(key),
                                  torch.Generator().manual_seed(seed))
        save_checkpoint(os.path.join(ckpt, key), models[key].state_dict(),
                        best_val_acc=0.0, best_epoch_id=0)
    by_phase = {"float32": {}, "bfloat16": {}}
    for flag, dname in dtypes:
        out = run_eval(torch, data, ckpt, BIT_KEY, flag, dname, IMG, BATCH, 64,
                       patches=16, net_g=BIT_KEY, per_forward=(2, 2))
        by_phase[dname]["bit_eval_256"] = out["launches"]
        print(json.dumps(out), flush=True)
    print(json.dumps(check_forward_vs_cpu(torch, models[BIT_KEY], data, IMG, 2,
                                          patch=5)), flush=True)
    for flag, dname in dtypes:
        out = run_training(torch, train_root, flag, dname, net_g=BIT_KEY,
                           per_call=(2, 2))
        by_phase[dname]["bit_train_256"] = out["launches"]
        print(json.dumps(out), flush=True)
    print(json.dumps(check_train_grads(torch, train_root, net_g=BIT_KEY,
                                       n_decoders=1)), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        out = run_pallas_eval(torch, tmp, dtype, net_g=BIT_KEY, project=BIT_KEY,
                              per_forward=(2, 2), n_decoders=1)
        by_phase[dname]["bit_pallas_eval_256"] = out["launches"]
        print(json.dumps(out), flush=True)
    for flag, dname in dtypes:
        out = run_eval(torch, data, ckpt, "base_resnet18", flag, dname, IMG,
                       BATCH, 4, patches=1, net_g="base_resnet18",
                       per_forward=(0, 0))
        by_phase[dname]["resnet_eval_256"] = out["launches"]
        print(json.dumps(out), flush=True)
    return by_phase


# xBD (phase 15): 8 synthetic 1024 px tiles for training (about a tenth for
# validation), 2 more for prediction; decoder and K3 launches per forward:
# xbd_dahitra one difference decode and one tokenizer call per scale,
# xbd_bit one of each per date (its mlp_dim-64 instances).
XBD_IMG = 1024
XBD_TILES, XBD_PREDICT_TILES = 8, 2
XBD_CALLS = {"xbd_dahitra": 3, "xbd_bit": 2, "xbd_adapt_dahitra": 3}
XBD_GRAD_IMG = 256
# Warm timings: train steps, and prediction forwards of one tile's 4 views,
# after one warm-up each (the median and the range are printed).
XBD_TIMED = 5


def _xbd_trainer(torch, tmp, net_g, dtype, arrays, tag):
    """An ``XBDTrainer`` (task damage) on the card over ``arrays`` (train
    and val alike), for ``train_step``."""
    import types

    from dahitra_tpu_torch.train.xbd_engine import XBDTrainer

    args = types.SimpleNamespace(
        checkpoint_dir=os.path.join(tmp, "xbd_ckpt", tag), max_epochs=1,
        bf16=dtype == torch.bfloat16, seed=0, net_G=net_g, img_size=XBD_IMG,
        lr=0.0, batch_size=1, val_batch_size=1)
    return XBDTrainer(args, arrays, arrays, device="cuda")


def run_xbd_train(torch, data_root, ckpt_root, flag, dname, n_val) -> dict:
    """``xbd_train --task damage --net_G xbd_dahitra`` at 1024 px, batch 1,
    one epoch with a validation, launch counters set to 0 just before and
    read just after: 3 K1-save, 3 K2 and 3 K3 per step, 3 K1 and 3 K3 per
    validation forward; finite loss and score, ``best_ckpt.pt`` written."""
    from dahitra_tpu_torch.cli import xbd_train

    project = f"xbd_dahitra_{dname}"
    argv = ["--data_root", data_root, "--task", "damage", "--net_G",
            "xbd_dahitra", "--img_size", str(XBD_IMG), "--batch_size", "1",
            "--max_epochs", "1", "--eval_every", "1", "--checkpoint_root",
            ckpt_root, "--project_name", project, "--device", "cuda", *flag]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.time()
    history = xbd_train.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = _read_counts()
    steps, dec = history[0]["pairs"], XBD_CALLS["xbd_dahitra"]
    want = {"k1": dec * n_val, "k1_save": dec * steps, "k2": dec * steps,
            "k3": dec * (steps + n_val), "k4": 0}
    if got != {**NO_PAD, **want}:
        fail(f"xbd_train {dname}: launches {got} != {want}")
    val = history[0].get("val", {})
    if not (np.isfinite(history[0]["loss"]) and np.isfinite(val.get("score",
                                                                    np.nan))
            and os.path.exists(os.path.join(ckpt_root, project,
                                            "best_ckpt.pt"))):
        fail(f"xbd_train {dname}: loss {history[0]['loss']}, scores {val} or "
             "no best_ckpt.pt")
    return {"xbd_train": dname, "net_G": "xbd_dahitra", "img_size": XBD_IMG,
            "batch": 1, "steps": steps, "val_pairs": n_val,
            "pairs_per_s_epoch0": history[0]["imps"],
            "loss": history[0]["loss"], "val": val, "wall_s": wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": got}


def _spread(ms) -> dict:
    """The median of host-clocked times (ms) and their range."""
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def run_xbd_step(torch, tmp, net_g, dtype, arrays) -> tuple:
    """``XBD_TIMED`` warm ``XBDTrainer.train_step`` calls of ``net_g`` at
    1024 px, batch 1 (a first step warms up), each timed alone, launch
    counters set to 0 just before and read just after: ``XBD_CALLS[net_g]``
    K1-save, K2 and K3 per step; finite losses, step times and peak memory.
    Returns (the line, the trainer)."""
    dname = str(dtype).split(".")[-1]
    trainer = _xbd_trainer(torch, tmp, net_g, dtype, arrays, f"{net_g}_{dname}")
    batch = [torch.from_numpy(arrays[k][:1]).cuda()
             for k in ("img_pre", "img_post", "msk", "lbl_msk")]
    trainer.train_step(*batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, times = [], []
    for _ in range(XBD_TIMED):
        t0 = time.time()
        losses.append(trainer.train_step(*batch).item())
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    got = _read_counts()
    dec = XBD_CALLS[net_g] * XBD_TIMED
    want = {"k1": 0, "k1_save": dec, "k2": dec, "k3": dec, "k4": 0}
    if got != {**NO_PAD, **want} or not np.isfinite(losses).all():
        fail(f"xBD step {net_g} {dname}: launches {got} != {want} or losses "
             f"{losses}")
    return ({"xbd_step": dname, "net_G": net_g, "img_size": XBD_IMG,
             "batch": 1, "steps": XBD_TIMED, "step_ms": _spread(times),
             "losses": losses,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": got}, trainer)


def run_xbd_predict(torch, test_root, out_dir, net_g, ckpt, flag, dname):
    """``xbd_predict`` over the ``XBD_PREDICT_TILES`` test tiles with one
    checkpoint, launch counters set to 0 just before and read just after:
    one forward of the 4 TTA views per tile (``XBD_CALLS[net_g]`` K1 and K3
    each); both PNGs of every tile, 1024 x 1024 uint8, damage in 0..3. Then
    the warm rate: ``predict`` on the first tile, once to warm up and
    ``XBD_TIMED`` times timed alone, the model already built and loaded;
    ``cli_pairs_per_s`` is the whole CLI run's, model build, checkpoint load
    and the first calls' algorithm searches included."""
    from PIL import Image

    from dahitra_tpu_torch.cli import xbd_predict
    from dahitra_tpu_torch.data.xbd import post_image_path, scan_xbd_files

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.time()
    written = xbd_predict.main(["--test_root", test_root, "--net_G", net_g,
                                "--img_size", str(XBD_IMG), "--checkpoints",
                                ckpt, "--out_dir", out_dir, "--device",
                                "cuda", *flag])
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = _read_counts()
    dec = XBD_CALLS[net_g] * XBD_PREDICT_TILES
    want = {"k1": dec, "k1_save": 0, "k2": 0, "k3": dec, "k4": 0}
    pngs = [np.array(Image.open(os.path.join(out_dir, w))) for w in written]
    ok = len(pngs) == 2 * XBD_PREDICT_TILES and all(
        p.shape == (XBD_IMG, XBD_IMG) and p.dtype == np.uint8
        and (p.max() <= 3 or name.endswith("_part1.png"))
        for p, name in zip(pngs, written))
    if got != {**NO_PAD, **want} or not ok:
        fail(f"xbd_predict {net_g} {dname}: launches {got} != {want} or PNGs "
             f"{[(n, p.shape, p.dtype, p.max()) for n, p in zip(written, pngs)]}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dtype = getattr(torch, dname)
    model = xbd_predict.load_model(net_g, ckpt, XBD_IMG, dtype, "cuda")
    fn = scan_xbd_files([test_root])[0]
    img6 = torch.from_numpy(np.concatenate(
        [np.array(Image.open(f).convert("RGB"))
         for f in (fn, post_image_path(fn))], -1)).cuda()
    xbd_predict.predict([model], img6, dtype)
    times = []
    for _ in range(XBD_TIMED):
        torch.cuda.synchronize()
        t0 = time.time()
        xbd_predict.predict([model], img6, dtype)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    del model
    return {"xbd_predict": dname, "net_G": net_g, "img_size": XBD_IMG,
            "pairs": XBD_PREDICT_TILES, "views_per_forward": 4,
            "pairs_per_s": 1e3 / statistics.median(times),
            "pair_ms": _spread(times), "cli_pairs_per_s":
            XBD_PREDICT_TILES / wall,
            "loc_mean": float(np.mean([p.mean() for p, n in zip(pngs, written)
                                       if n.endswith("_part1.png")])),
            "peak_mem_gib": peak, "launches": got}


def check_xbd_grads(torch, data_root) -> dict:
    """Phase 8 for the damage task: ``xbd_dahitra`` at 256 px (a crop of a
    synthetic tile), batch 1, no augmentation, the train-mode forward,
    ``xbd_damage_loss`` and backward in fp32, on the card and on the CPU
    plain path: every gradient to 1e-3 of the whole gradient's scale, the
    updated BN statistics to 1e-4."""
    import copy

    from dahitra_tpu_torch.data.xbd import (load_xbd_pairs, scan_xbd_files)
    from dahitra_tpu_torch.data.xbd_augment import augment_xbd
    from dahitra_tpu_torch.losses.combo import xbd_damage_loss
    from dahitra_tpu_torch.models.registry import define_g
    from dahitra_tpu_torch.nn.init import init_random

    pairs = load_xbd_pairs(scan_xbd_files([data_root])[:1], train=False,
                           crop_size=XBD_GRAD_IMG, seed=0)
    batch = [torch.from_numpy(v) for v in pairs.arrays().values()]
    gen = torch.Generator().manual_seed(5)
    model = init_random(define_g("xbd_dahitra", img_size=XBD_GRAD_IMG,
                                 generator=gen), gen, running_stats=False)
    models = {"cpu": model, "cuda": copy.deepcopy(model).cuda()}
    for dev, m in models.items():
        img6, masks, _ = augment_xbd(*(t.to(dev) for t in batch), train=False)
        xbd_damage_loss(m(img6, train=True).float(), masks).backward()
    torch.cuda.synchronize()
    cuda_params = dict(models["cuda"].named_parameters())
    scale = max(p.grad.abs().max().item() for p in model.parameters())
    err = max((cuda_params[k].grad.cpu() - p.grad).abs().max().item()
              for k, p in model.named_parameters()) / scale
    cuda_bufs = dict(models["cuda"].named_buffers())
    bn_err = max(scaled_err(cuda_bufs[k].cpu(), v)[1]
                 for k, v in model.named_buffers())
    out = {"xbd_grads_vs_cpu_plain": {
        "img_size": XBD_GRAD_IMG, "batch": 1, "worst_over_scale": err,
        "tolerance": 1e-3, "bn_stats_worst_scaled_err": bn_err}}
    if not (err <= 1e-3 and bn_err <= 1e-4):
        fail(f"xBD gradients on the card disagree with the CPU: {out}")
    return out


def run_xbd_phase(torch, tmp, dtypes) -> dict:
    """Phase 15: the xBD damage path at 1024 px on seeded synthetic tiles.
    ``xbd_train`` (xbd_dahitra) and ``xbd_predict`` with its checkpoint per
    dtype, one warm step of each model, xbd_bit's prediction from its
    trainer's weights, and the card's gradients against the CPU. Returns
    the launch counts by dtype and phase."""
    from dahitra_tpu_torch.core.checkpoint import save_checkpoint
    from dahitra_tpu_torch.data.synthetic import write_synthetic_xbd
    from dahitra_tpu_torch.data.xbd import (load_xbd_pairs, scan_xbd_files,
                                            split_and_upsample)

    t0 = time.time()
    root = os.path.join(tmp, "xbd")
    data_root = write_synthetic_xbd(os.path.join(root, "train"), XBD_TILES,
                                    XBD_IMG, seed=0)
    test_root = write_synthetic_xbd(os.path.join(root, "test"),
                                    XBD_PREDICT_TILES, XBD_IMG, seed=1)
    files = scan_xbd_files([data_root])
    n_val = len(split_and_upsample(files, seed=0)[1])
    one = load_xbd_pairs(files[:1], train=True).arrays()
    print(f"xBD setup: {XBD_TILES} + {XBD_PREDICT_TILES} synthetic tiles in "
          f"{time.time() - t0:.1f} s", flush=True)
    by_phase = {"float32": {}, "bfloat16": {}}
    ckpt_root = os.path.join(root, "ckpt")
    for flag, dname in dtypes:
        dtype = getattr(torch, dname)
        out = run_xbd_train(torch, data_root, ckpt_root, flag, dname, n_val)
        by_phase[dname]["xbd_train_1024"] = out["launches"]
        print(json.dumps(out), flush=True)
        out = run_xbd_predict(torch, test_root, os.path.join(
            root, f"pred_{dname}"), "xbd_dahitra",
            os.path.join(ckpt_root, f"xbd_dahitra_{dname}"), flag, dname)
        by_phase[dname]["xbd_predict_1024"] = out["launches"]
        print(json.dumps(out), flush=True)
        for net_g, ph in (("xbd_dahitra", "xbd_step_1024"),
                          ("xbd_bit", "bit_xbd_step_1024")):
            out, trainer = run_xbd_step(torch, tmp, net_g, dtype, one)
            by_phase[dname][ph] = out["launches"]
            print(json.dumps(out), flush=True)
        ckpt = save_checkpoint(trainer.checkpoint_dir,
                               trainer.model.state_dict())
        del trainer
        out = run_xbd_predict(torch, test_root, os.path.join(
            root, f"pred_bit_{dname}"), "xbd_bit", ckpt, flag, dname)
        by_phase[dname]["bit_xbd_predict_1024"] = out["launches"]
        print(json.dumps(out), flush=True)
    print(json.dumps(check_xbd_grads(torch, data_root)), flush=True)
    print(f"xBD phase: {time.time() - t0:.1f} s", flush=True)
    return by_phase


# xBD tasks (phase 16) at 1024 px, batch 1, on phase 15's tiles: (task,
# --net_G or None for the task's default, extra flags). The ResNet34 UNets
# (loc, adapt's default) launch no decoder or tokenizer kernel; the DAHiTra
# networks (adapt with xbd_adapt_dahitra, gan's generator, damage) launch
# XBD_CALLS of each per forward.
XBD_TASKS = (("loc", None, []), ("adapt", None, []),
             ("adapt", "xbd_adapt_dahitra", []), ("gan", None, []),
             ("damage", None, ["--elastic"]))


def _task_launches(net_g, steps, forwards):
    """Launch counts of ``steps`` train steps and ``forwards`` forwards
    without saves (validation; a GAN discriminator update's generator
    forward) of ``net_g``: 3 K1-save, 3 K2 and 3 K3 a DAHiTra step, 3 K1
    and 3 K3 a forward; none for the ResNet34 UNets."""
    dec = XBD_CALLS.get(net_g, 0)
    return {"k1": dec * forwards, "k1_save": dec * steps, "k2": dec * steps,
            "k3": dec * (steps + forwards), "k4": 0}


def run_xbd_task(torch, data_root, ckpt_root, task, net_g, extra, flag,
                 dname, n_val) -> dict:
    """``xbd_train --task <task>`` at 1024 px, batch 1, one epoch with a
    validation, launch counters set to 0 just before and read just after;
    finite loss and score, ``best_ckpt.pt`` (and for gan ``best_ckpt_D.pt``,
    with a discriminator update at batches 0 and 8 of the 11) written."""
    from dahitra_tpu_torch.cli import xbd_train

    net = net_g or xbd_train.DEFAULT_NET.get(task, "xbd_dahitra")
    project = f"{task}_{net}{'_elastic' if extra else ''}_{dname}"
    argv = ["--data_root", data_root, "--task", task, "--img_size",
            str(XBD_IMG), "--batch_size", "1", "--max_epochs", "1",
            "--eval_every", "1", "--checkpoint_root", ckpt_root,
            "--project_name", project, "--device", "cuda", *extra, *flag,
            *(["--net_G", net_g] if net_g else [])]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.time()
    history = xbd_train.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = _read_counts()
    h = history[0]
    updates = h.get("disc_updates", 0)
    want = _task_launches(net, h["pairs"], n_val + updates)
    ckpts = ["best_ckpt.pt"] + (["best_ckpt_D.pt"] if task == "gan" else [])
    if got != {**NO_PAD, **want}:
        fail(f"xbd_train --task {task} {net} {dname}: launches {got} != "
             f"{want}")
    if not (np.isfinite(h["loss"]) and np.isfinite(h.get("val", {}).get(
            "score", np.nan)) and all(os.path.exists(os.path.join(
                ckpt_root, project, c)) for c in ckpts)
            and (task != "gan" or updates == -(-h["pairs"] // 8))):
        fail(f"xbd_train --task {task} {net} {dname}: {h} or no {ckpts}")
    return {"xbd_task": task, "net_G": net, "flags": extra, "dtype": dname,
            "img_size": XBD_IMG, "batch": 1, "steps": h["pairs"],
            "disc_updates": updates, "val_pairs": n_val,
            "pairs_per_s_epoch0": h["imps"], "loss": h["loss"],
            "val": h["val"], "wall_s": wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": got, "checkpoint": os.path.join(ckpt_root, project)}


def _task_trainer(torch, tmp, task, net_g, dtype, arrays, img=None,
                  device="cuda"):
    """An ``XBDTrainer`` of ``task`` (``GANTrainer`` for gan) over
    ``arrays`` (train and val alike)."""
    import types

    from dahitra_tpu_torch.train.xbd_engine import GANTrainer, XBDTrainer

    dname = str(dtype).split(".")[-1]
    args = types.SimpleNamespace(
        checkpoint_dir=os.path.join(tmp, "xbd_task_ckpt",
                                    f"{task}_{net_g}_{dname}_{device}"),
        max_epochs=1, bf16=dtype == torch.bfloat16, seed=0, net_G=net_g,
        img_size=img or XBD_IMG, lr=0.0, batch_size=1, val_batch_size=1)
    if task == "gan":
        return GANTrainer(args, arrays, arrays, device=device)
    return XBDTrainer(args, arrays, arrays, device=device, task=task)


def run_xbd_task_steps(torch, tmp, task, net_g, dtype, arrays) -> dict:
    """``XBD_TIMED`` warm train steps of ``task`` at 1024 px, batch 1 (the
    GAN's without a discriminator update, then ``XBD_TIMED`` with one), each
    timed alone on the host clock after a warm-up, launch counters set to 0
    just before and read just after; for gan also one ``--effective_gan``
    step, whose adversarial gradient (its generator gradient less that of
    the same step without it) must be nonzero."""
    dname = str(dtype).split(".")[-1]
    trainer = _task_trainer(torch, tmp, task, net_g, dtype, arrays)
    batch = [torch.from_numpy(arrays[k][:1]).cuda()
             for k in ("img_pre", "img_post", "msk", "lbl_msk")]
    kinds = {"step": lambda: trainer.train_step(*batch)}
    if task == "gan":
        kinds["step_with_disc_update"] = lambda: trainer.gan_step(
            *batch, update_disc=True)[0]
    out = {"xbd_task_steps": task, "net_G": net_g, "dtype": dname,
           "img_size": XBD_IMG, "batch": 1}
    for kind, fn in kinds.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        losses, times = [], []
        for _ in range(XBD_TIMED):
            t0 = time.time()
            losses.append(fn().item())
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
        got = _read_counts()
        want = _task_launches(net_g, XBD_TIMED, XBD_TIMED * (kind != "step"))
        if got != {**NO_PAD, **want} or not np.isfinite(losses).all():
            fail(f"xBD {task} {kind} {net_g} {dname}: launches {got} != "
                 f"{want} or losses {losses}")
        out[kind] = {"step_ms": _spread(times), "losses": losses,
                     "peak_mem_gib": torch.cuda.max_memory_allocated()
                     / 2 ** 30, "launches": got}
    if task == "gan":
        out["effective_gan"] = check_effective_gan(torch, trainer, batch)
    return out


def check_effective_gan(torch, trainer, batch) -> dict:
    """One generator step with ``--effective_gan`` and the same step
    without, from the same weights and augmentation draws: the adversarial
    gradient, their difference, must be finite and nonzero."""
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    grads = {}
    for eff in (False, True):
        trainer.model.load_state_dict(state)
        trainer.effective_gan = eff
        trainer.aug_generator.manual_seed(7)
        trainer.gan_step(*batch, update_disc=False)
        grads[eff] = torch.cat([p.grad.flatten().float()
                                for p in trainer.model.parameters()])
    trainer.effective_gan = False
    adv = (grads[True] - grads[False]).abs().max().item()
    scale = grads[False].abs().max().item()
    if not (np.isfinite(adv) and adv > 0):
        fail(f"--effective_gan: adversarial gradient {adv}")
    return {"adversarial_grad_max": adv, "grad_scale": scale}


def run_visualize(torch, test_root, out_dir, loc_ckpt, dmg_ckpt, flag,
                  dname) -> dict:
    """``visualize_results`` over the ``XBD_PREDICT_TILES`` test tiles with
    a loc (xbd_res34_loc) and a damage (xbd_dahitra) checkpoint, launch
    counters set to 0 just before and read just after: the damage model's
    4 views a tile (3 K1, 3 K3), nothing from the loc model; one (1024,
    4096, 3) grid a tile."""
    from PIL import Image

    from dahitra_tpu_torch.cli import visualize_results

    _reset_counts()
    t0 = time.time()
    written = visualize_results.main([
        "--test_root", test_root, "--loc_ckpt", loc_ckpt, "--dmg_ckpt",
        dmg_ckpt, "--img_size", str(XBD_IMG), "--out_dir", out_dir,
        "--device", "cuda", *flag])
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = _read_counts()
    want = _task_launches("xbd_dahitra", 0, XBD_PREDICT_TILES)
    shapes = [np.array(Image.open(os.path.join(out_dir, w))).shape
              for w in written]
    if got != {**NO_PAD, **want} or len(shapes) != XBD_PREDICT_TILES \
            or any(sh != (XBD_IMG, 4 * XBD_IMG, 3) for sh in shapes):
        fail(f"visualize_results {dname}: launches {got} != {want} or grids "
             f"{shapes}")
    return {"visualize_results": dname, "grids": shapes, "wall_s": wall,
            "launches": got}


# Input moves of 1e-6 under which the CPU plain path's own gradients are
# taken (ROADMAP fault 5), for phase 16's gradient check.
GRAD_MOVES = 4


def _grad_blocks(ref, grads, scale) -> dict:
    """Each (tensor, output channel) of the gradients ``ref``: the largest
    distance of ``grads`` from it, over ``scale``."""
    out = {}
    for k, r in ref.items():
        d = (grads[k].cpu() - r).abs().reshape(len(r), -1).amax(1) / scale
        out.update({(k, c): v for c, v in enumerate(d.tolist())})
    return out


def check_task_grads(torch, tmp, data_root) -> dict:
    """Phase 15's gradient check for the ``loc`` step (xbd_res34_loc) and a
    GAN step that updates the discriminator (xbd_dahitra against the
    discriminator), at 256 px (a crop of a synthetic tile), batch 1, no
    augmentation, fp32, on the card and on the CPU plain path, each from
    the same seeded trainer; the updated BN statistics to 1e-4. The
    gradients of each network to 1e-3 of its whole gradient's scale, or,
    where larger, to twice the largest distance the CPU path's own gradient
    moves under ``GRAD_MOVES`` input moves of 1e-6 (ROADMAP fault 5): the
    ResNet34 UNet's ReLUs flip within fp32 rounding of zero, and the
    discriminator reads binary masks, whose flat regions put equal values
    into its max-pool windows and ReLUs, so tiny moves of its input move
    its gradient by a few 1e-2 of the scale (the CPU path's own moves are
    printed); the card and the CPU break those ties their own ways. Each
    network's worst (tensor, output channel) is printed beside the rest."""
    import copy

    from dahitra_tpu_torch.data.xbd import load_xbd_pairs, scan_xbd_files
    from dahitra_tpu_torch.data.xbd_augment import augment_xbd

    arrays = load_xbd_pairs(scan_xbd_files([data_root])[:1], train=False,
                            crop_size=XBD_GRAD_IMG, seed=0).arrays()

    def augment(move):
        """The eval branch, the input moved by 1e-6 N(0, 1) for move > 0."""
        def fn(*batch):
            img6, masks, lbl = augment_xbd(*batch, train=False)
            if move:
                img6 = img6 + 1e-6 * torch.randn(
                    img6.shape, generator=torch.Generator().manual_seed(move)
                ).to(img6.device)
            return img6, masks, lbl
        return fn

    out = {}
    for task, net_g in (("loc", "xbd_res34_loc"), ("gan", "xbd_dahitra")):
        nets = {"generator": "model", "discriminator": "disc"} \
            if task == "gan" else {"model": "model"}
        runs = {}  # (device, move) -> {label: (grads, buffers)}
        for dev in ("cpu", "cuda"):
            tr = _task_trainer(torch, tmp, task, net_g, torch.float32, arrays,
                               XBD_GRAD_IMG, dev)
            init = {a: copy.deepcopy(getattr(tr, a).state_dict())
                    for a in nets.values()}
            batch = [torch.from_numpy(v).to(dev) for v in arrays.values()]
            for move in range(GRAD_MOVES + 1 if dev == "cpu" else 1):
                for a, sd in init.items():
                    getattr(tr, a).load_state_dict(sd)
                tr._augment = augment(move)
                if task == "gan":
                    tr.gan_step(*batch, update_disc=True)
                else:
                    tr.train_step(*batch)
                runs[dev, move] = {
                    label: ({k: p.grad.detach().cpu().clone() for k, p in
                             getattr(tr, a).named_parameters()},
                            {k: b.cpu().clone() for k, b in
                             getattr(tr, a).named_buffers()})
                    for label, a in nets.items()}
        for label in nets:
            ref, ref_bufs = runs["cpu", 0][label]
            scale = max(g.abs().max().item() for g in ref.values())
            port = _grad_blocks(ref, runs["cuda", 0][label][0], scale)
            own = [max(_grad_blocks(ref, runs["cpu", m][label][0],
                                    scale).values())
                   for m in range(1, GRAD_MOVES + 1)]
            bound = max(1e-3, 2 * max(own))
            worst = max(port, key=port.get)
            rest = max((v for b, v in port.items() if b != worst), default=0.0)
            card_bufs = runs["cuda", 0][label][1]
            bn_err = max(scaled_err(card_bufs[k], v)[1]
                         for k, v in ref_bufs.items())
            out[f"{task}_{label}"] = {
                "worst_over_scale": port[worst], "worst_block": list(worst),
                "rest_worst_over_scale": rest, "cpu_own_moves": own,
                "bound": bound, "bn_stats_worst_scaled_err": bn_err}
            if not (port[worst] <= bound and bn_err <= 1e-4):
                fail(f"xBD {task} {label} gradients on the card disagree "
                     f"with the CPU: {out}")
    return {"xbd_task_grads_vs_cpu_plain": {
        "img_size": XBD_GRAD_IMG, "batch": 1, "tolerance": 1e-3, **out}}


def run_xbd_tasks_phase(torch, tmp, dtypes) -> dict:
    """Phase 16: the rest of the xBD stack at 1024 px on phase 15's tiles,
    fp32 then bf16: ``xbd_train`` for every run of ``XBD_TASKS``,
    ``visualize_results`` with the loc and phase 15's damage checkpoints,
    warm steps of each task; then the card's loc and GAN gradients against
    the CPU. Returns the launch counts by dtype and phase."""
    from dahitra_tpu_torch.data.xbd import (load_xbd_pairs, scan_xbd_files,
                                            split_and_upsample)

    t0 = time.time()
    root = os.path.join(tmp, "xbd")
    data_root, test_root = (os.path.join(root, s) for s in ("train", "test"))
    ckpt_root = os.path.join(root, "ckpt")
    files = scan_xbd_files([data_root])
    n_val = len(split_and_upsample(files, seed=0)[1])
    one = {merge: load_xbd_pairs(files[:1], train=True, merge_34=merge,
                                 color_normalize=merge).arrays()
           for merge in (False, True)}
    by_phase = {"float32": {}, "bfloat16": {}}
    for flag, dname in dtypes:
        dtype = getattr(torch, dname)
        ckpts = {}
        for task, net_g, extra in XBD_TASKS:
            out = run_xbd_task(torch, data_root, ckpt_root, task, net_g, extra,
                               flag, dname, n_val)
            ckpts.setdefault(task, out["checkpoint"])
            by_phase[dname][f"xbd_{task}_{out['net_G']}_1024"] = \
                out["launches"]
            print(json.dumps(out), flush=True)
        out = run_visualize(torch, test_root, os.path.join(
            root, f"vis_{dname}"), ckpts["loc"], os.path.join(
                ckpt_root, f"xbd_dahitra_{dname}"), flag, dname)
        by_phase[dname]["xbd_visualize_1024"] = out["launches"]
        print(json.dumps(out), flush=True)
        for task, net_g in (("loc", "xbd_res34_loc"),
                            ("adapt", "xbd_adapt_res34"),
                            ("adapt", "xbd_adapt_dahitra"),
                            ("gan", "xbd_dahitra")):
            out = run_xbd_task_steps(torch, tmp, task, net_g, dtype,
                                     one[task == "adapt"])
            for kind in ("step", "step_with_disc_update"):
                if kind in out:
                    by_phase[dname][f"xbd_{task}_{net_g}_{kind}s_1024"] = \
                        out[kind]["launches"]
            print(json.dumps(out), flush=True)
    print(json.dumps(check_task_grads(torch, tmp, data_root)), flush=True)
    print(f"xBD tasks phase: {time.time() - t0:.1f} s", flush=True)
    return by_phase


# The rest of the LEVIR-CD zoo (phase 17), at 256 px: none of these models
# has a decoder stack or a tokenizer, so every run launches no kernel.
ZOO_KEYS = ("unet_coupled_trans_256", "unet_coupled_two_trans_256",
            "siamUnet_conc", "changeFormer", "changeFormerV6")
MULTI_SCALE_KEY = "changeFormerV6"
ZOO_TIMED = 5
NO_KERNELS = {"k1": 0, "k1_save": 0, "k2": 0, "k3": 0, "k4": 0}
# Confusion matrices of the eval_cd runs, in order: phase 17 holds the
# imported checkpoint's against phase 5's fp32 one.
EVAL_CMS = []


def _record_confusion_matrices() -> None:
    """Keep each ``CDEvaluator.eval_models`` run's summed matrix in
    ``EVAL_CMS``."""
    from dahitra_tpu_torch.evalx import evaluator

    run = evaluator.CDEvaluator.eval_models

    def recorded(self, *args, **kwargs):
        out = run(self, *args, **kwargs)
        EVAL_CMS.append(np.array(self.confusion_matrix))
        return out

    evaluator.CDEvaluator.eval_models = recorded


def check_zoo_forward_vs_cpu(torch, key, data_root) -> dict:
    """A seeded model's fp32 eval forward of two test patches of phase 4's
    tiles on the card against the CPU: <= 1e-3 of the logits' scale (the
    full-resolution logits of changeFormerV6's list), argmax agreement >=
    99.9 %, no kernel launched."""
    from dahitra_tpu_torch.data.augment import normalize_images
    from dahitra_tpu_torch.data.levir import load_levir_split
    from dahitra_tpu_torch.models.registry import define_g, final_logits
    from dahitra_tpu_torch.nn.init import init_random

    pairs = load_levir_split(os.path.join(data_root, "LEVIR_CD"), "test", IMG,
                             patch=5)
    a, b = (normalize_images(torch.from_numpy(t[:2])) for t in (pairs.a,
                                                                  pairs.b))
    model = init_random(define_g(key, img_size=IMG),
                        torch.Generator().manual_seed(17))
    _reset_counts()
    with torch.inference_mode():
        ref = final_logits(model.eval()(a, b))
        got = final_logits(model.cuda()(a.cuda(), b.cuda())).cpu()
    torch.cuda.synchronize()
    counts = _read_counts()
    _, serr = scaled_err(got, ref)
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    out = {"zoo_forward_vs_cpu_plain": key, "img_size": IMG, "pairs": 2,
           "scaled_err": serr, "argmax_agreement": agree, "launches": counts}
    if not (torch.isfinite(got).all() and serr <= 1e-3 and agree >= 0.999
            and counts == {**NO_PAD, **NO_KERNELS}):
        fail(f"{key}: card forward disagrees with the CPU plain path or "
             f"launched a kernel: {out}")
    return out


def run_zoo_steps(torch, tmp, key, dtype) -> dict:
    """``ZOO_TIMED`` warm ``CDTrainer.train_step`` calls of ``key`` at 256
    px, batch 8 (changeFormerV6 with the multi-scale loss), each timed on the
    host clock after a warm-up, launch counters set to 0 just before and
    read just after: no kernel, finite losses."""
    dname = str(dtype).split(".")[-1]
    trainer = _trainer(torch, tmp, dtype, f"zoo_{key}", img=IMG,
                       batch=BATCH, net_g=key)
    trainer.multi_scale = key == MULTI_SCALE_KEY
    data = _batch(torch, BATCH, 17, IMG)
    trainer.train_step(*data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, times = [], []
    for _ in range(ZOO_TIMED):
        t0 = time.time()
        losses.append(trainer.train_step(*data)[0].item())
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    got = _read_counts()
    if got != {**NO_PAD, **NO_KERNELS} or not np.isfinite(losses).all():
        fail(f"{key} {dname} warm steps: launches {got} or losses {losses}")
    return {"zoo_steps": key, "dtype": dname, "img_size": IMG,
            "batch": BATCH, "multi_scale_loss": trainer.multi_scale,
            "step_ms": _spread(times), "losses": losses,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": got}


def check_zoo_grads(torch, train_root, key) -> dict:
    """The card's fp32 training gradients and updated BN statistics of
    ``key`` against the CPU plain path: a batch of 2 of phase 7's train
    split at 256 px, no augmentation, every dropout rate 0, the multi-scale
    loss for changeFormerV6. The gradients to 1e-3 of the whole gradient's
    scale or, where larger, twice the CPU path's own largest move under
    ``GRAD_MOVES`` input moves of 1e-6 (taken only then), as phase 16; the
    BN statistics to 1e-4."""
    import copy

    from dahitra_tpu_torch.data.augment import augment_pairs
    from dahitra_tpu_torch.data.levir import load_levir_split
    from dahitra_tpu_torch.losses.cd import levir_train_loss, multi_scale_loss
    from dahitra_tpu_torch.models.registry import define_g, final_logits
    from dahitra_tpu_torch.nn.blocks import Dropout
    from dahitra_tpu_torch.nn.init import init_weights

    pairs = load_levir_split(os.path.join(train_root, "data", "LEVIR_CD"),
                             "train", IMG)
    batch = [torch.from_numpy(t[:2]) for t in (pairs.a, pairs.b, pairs.label)]
    gen = torch.Generator().manual_seed(3)
    init = init_weights(define_g(key, img_size=IMG, generator=gen), "normal",
                        0.02, gen)
    for m in init.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0

    def run(dev, move=0):
        model = copy.deepcopy(init).to(dev)
        a, b, label = augment_pairs(*(t.to(dev) for t in batch), train=False)
        if move:
            a = a + 1e-6 * torch.randn(
                a.shape, generator=torch.Generator().manual_seed(move)).to(dev)
        out = model(a, b, train=True)
        loss = multi_scale_loss(out, label, 2) if key == MULTI_SCALE_KEY \
            else levir_train_loss(final_logits(out).float(), label, 2)
        loss.backward()
        return ({k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()},
                {k: v.cpu() for k, v in model.named_buffers()})

    ref, ref_bufs = run("cpu")
    grads, bufs = run("cuda")
    torch.cuda.synchronize()
    scale = max(g.abs().max().item() for g in ref.values())
    port = _grad_blocks(ref, grads, scale)
    worst = max(port, key=port.get)
    own = []
    if port[worst] > 1e-3:
        own = [max(_grad_blocks(ref, run("cpu", m)[0], scale).values())
               for m in range(1, GRAD_MOVES + 1)]
    bound = max([1e-3] + [2 * o for o in own])
    bn_err = max([0.0] + [scaled_err(bufs[k], v)[1]
                          for k, v in ref_bufs.items()])
    out = {"zoo_train_grads_vs_cpu_plain": key, "img_size": IMG, "batch": 2,
           "worst_over_scale": port[worst], "worst_block": list(worst),
           "cpu_own_moves": own, "bound": bound,
           "bn_stats_worst_scaled_err": bn_err}
    if not (port[worst] <= bound and bn_err <= 1e-4):
        fail(f"{key} gradients on the card disagree with the CPU: {out}")
    return out


def check_zoo_dropout_step(torch, tmp, key) -> dict:
    """One train step with dropout on (the models' own rates), from two
    trainers of the same seed, each built on a freed card, with cuDNN held
    to deterministic algorithms (without that the two may pick different
    convolution algorithms: ``changeFormerV6``'s loss differed in its 20th
    bit, call 2, PR 14): the loss is finite and the same bits, and the
    dropout generators drew masks and end in the same state."""
    losses, states, drew = [], [], []
    torch.backends.cudnn.deterministic = True
    for run in range(2):
        torch.cuda.empty_cache()
        trainer = _trainer(torch, tmp, torch.float32,
                           f"zoo_dropout_{key}_{run}", img=IMG, net_g=key)
        fresh = trainer.dropout_generator.get_state()
        losses.append(trainer.train_step(*_batch(torch, 2, 18, IMG))[0]
                      .item())
        states.append(trainer.dropout_generator.get_state())
        drew.append(not torch.equal(fresh, states[-1]))
        del trainer
    torch.backends.cudnn.deterministic = False
    out = {"zoo_dropout_step": key, "losses": [float.hex(v) for v in losses],
           "masks_drawn": drew,
           "generator_states_equal": torch.equal(*states)}
    if not (np.isfinite(losses[0]) and losses[0] == losses[1] and all(drew)
            and out["generator_states_equal"]):
        fail(f"{key}: dropout step not reproducible: {out}")
    return out


def run_demo(torch, tmp, flag, dname) -> dict:
    """``demo --net_G newUNetTrans`` with phase 4's checkpoint over phase
    4's test tiles (one 256 px crop each), launch counters set to 0 just
    before and read just after: 6 K1 and 3 K3 a forward; PNGs (256, 256)
    in {0, 255}."""
    from PIL import Image

    from dahitra_tpu_torch.cli import demo

    os.environ["DAHITRA_DATA_ROOT"] = os.path.join(tmp, "data")
    out_dir = os.path.join(tmp, f"demo_{dname}")
    _reset_counts()
    t0 = time.time()
    names = demo.main(["--project_name", "smoke", "--checkpoint_root",
                       os.path.join(tmp, "ckpt"), "--data_name", "LEVIR",
                       "--split", "test", "--img_size", str(IMG),
                       "--output_folder", out_dir, "--device", "cuda", *flag])
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = _read_counts()
    want = {**NO_KERNELS, "k1": 6 * len(names), "k3": 3 * len(names)}
    pngs = [np.array(Image.open(os.path.join(out_dir, n))) for n in names]
    if got != {**NO_PAD, **want} or not names or any(
            p.shape != (IMG, IMG) or not set(np.unique(p)) <= {0, 255}
            for p in pngs):
        fail(f"demo {dname}: launches {got} != {want} or PNGs "
             f"{[p.shape for p in pngs]}")
    return {"demo": dname, "pairs": len(names), "wall_s": wall,
            "launches": got}


def check_import(torch, tmp, cm5) -> dict:
    """Phase 4's checkpoint written as a reference ``.pt`` (``module.``
    prefix under ``model_G_state_dict``), imported with ``import_checkpoint
    --net_G newUNetTrans``, then ``eval_cd`` as phase 5 ran it in fp32: the
    same launches and the same confusion matrix, element for element."""
    from dahitra_tpu_torch.cli import import_checkpoint
    from dahitra_tpu_torch.core.checkpoint import load_checkpoint

    sd = load_checkpoint(os.path.join(tmp, "ckpt", "smoke"))[0]
    pt = os.path.join(tmp, "reference_smoke.pt")
    torch.save({"model_G_state_dict": {f"module.{k}": v
                                       for k, v in sd.items()},
                "best_val_acc": 0.0}, pt)
    import_checkpoint.main([pt, "--net_G", "newUNetTrans", "--img_size",
                            str(IMG), "--out",
                            os.path.join(tmp, "ckpt", "imported")])
    out = run_eval(torch, os.path.join(tmp, "data"), os.path.join(tmp, "ckpt"),
                   "imported", [], "float32", IMG, BATCH, 64, patches=16)
    cm = EVAL_CMS[-1]
    out["confusion_matrix"] = cm.tolist()
    out["equals_phase5"] = bool(np.array_equal(cm, cm5))
    if not out["equals_phase5"]:
        fail(f"imported checkpoint: confusion matrix {cm.tolist()} != phase "
             f"5's {cm5.tolist()}")
    return out


def check_fast_vjp_off(torch, train_root) -> dict:
    """Phase 8's model and batch, eval forward on the card: with the
    defaults 6 K1 and 3 K3; with ``fast_vjp = False`` on its decoders 0 K1
    (the layer loop) and 3 K3, logits within 1e-3 of the K1 path's."""
    from dahitra_tpu_torch.data.augment import augment_pairs
    from dahitra_tpu_torch.data.levir import load_levir_split
    from dahitra_tpu_torch.models.registry import define_g
    from dahitra_tpu_torch.nn.blocks import TransformerDecoder
    from dahitra_tpu_torch.nn.init import init_weights

    pairs = load_levir_split(os.path.join(train_root, "data", "LEVIR_CD"),
                             "train", IMG)
    batch = [torch.from_numpy(t[:2]).cuda()
             for t in (pairs.a, pairs.b, pairs.label)]
    gen = torch.Generator().manual_seed(3)
    model = init_weights(define_g("newUNetTrans", img_size=IMG,
                                  generator=gen), "normal", 0.02, gen)
    model.cuda().eval()
    a, b, _ = augment_pairs(*batch, train=False)
    outs, counts = [], []
    for fast in (None, False):
        for m in model.modules():
            if isinstance(m, TransformerDecoder):
                m.fast_vjp = fast
        _reset_counts()
        with torch.inference_mode():
            outs.append(model(a, b))
        torch.cuda.synchronize()
        counts.append(_read_counts())
    _, serr = scaled_err(outs[1], outs[0])
    out = {"fast_vjp_off": {"launches_default": counts[0],
                            "launches_fast_vjp_false": counts[1],
                            "scaled_err_vs_k1_path": serr}}
    want = [{**NO_KERNELS, "k1": 6, "k3": 3}, {**NO_KERNELS, "k3": 3}]
    if counts != [{**NO_PAD, **w} for w in want] or serr > 1e-3:
        fail(f"fast_vjp=False: {out}")
    return out


def check_count_params(torch) -> dict:
    """``count_params`` over every ported key: each counted, the card's
    allocated memory the same before and after."""
    from dahitra_tpu_torch.cli import count_params
    from dahitra_tpu_torch.models.registry import PORTED

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    counts = count_params.main(list(PORTED))
    after = torch.cuda.memory_allocated()
    if set(counts) != set(PORTED) or after != before:
        fail(f"count_params: {len(counts)} of {len(PORTED)} keys, allocated "
             f"{before} -> {after}")
    return {"count_params": counts, "allocated_before": before,
            "allocated_after": after}


def run_zoo_phase(torch, tmp, train_root, dtypes, cm5) -> dict:
    """Phase 17: the five LEVIR zoo keys at 256 px (``main_cd`` one epoch
    on phase 7's splits, ``eval_cd`` on its checkpoint, the card's forward
    against the CPU, warm steps; fp32 then bf16; no kernel launched), their
    fp32 gradients against the CPU, a reproducible dropout step; then
    ``demo``, ``import_checkpoint`` against phase 5, the ``fast_vjp=False``
    forward and ``count_params``. Returns the launch counts by dtype and
    phase."""
    t0 = time.time()
    data = os.path.join(tmp, "data")
    by_phase = {"float32": {}, "bfloat16": {}}
    for key in ZOO_KEYS:
        print(json.dumps(check_zoo_forward_vs_cpu(torch, key, data)),
              flush=True)
        for flag, dname in dtypes:
            extra = ["--multi_scale_loss"] if key == MULTI_SCALE_KEY else []
            out = run_training(torch, train_root, flag + extra, dname,
                               img=IMG, batch=BATCH, epochs=1,
                               train_pairs=TRAIN_PAIRS, val_pairs=VAL_PAIRS,
                               net_g=key, per_call=(0, 0))
            by_phase[dname][f"zoo_{key}_train_256"] = out["launches"]
            print(json.dumps({**out, "multi_scale_loss": bool(extra)}),
                  flush=True)
            out = run_eval(torch, os.path.join(train_root, "data"),
                           os.path.join(train_root, "ckpt"),
                           f"train_{key}_{dname}", flag, dname, IMG, BATCH,
                           VAL_PAIRS, net_g=key, per_forward=(0, 0))
            by_phase[dname][f"zoo_{key}_eval_256"] = out["launches"]
            print(json.dumps(out), flush=True)
            out = run_zoo_steps(torch, tmp, key, getattr(torch, dname))
            by_phase[dname][f"zoo_{key}_steps_256"] = out["launches"]
            print(json.dumps(out), flush=True)
        print(json.dumps(check_zoo_grads(torch, train_root, key)), flush=True)
        print(json.dumps(check_zoo_dropout_step(torch, tmp, key)), flush=True)
    for flag, dname in dtypes:
        out = run_demo(torch, tmp, flag, dname)
        by_phase[dname]["demo_256"] = out["launches"]
        print(json.dumps(out), flush=True)
    out = check_import(torch, tmp, cm5)
    by_phase["float32"]["import_eval_256"] = out["launches"]
    print(json.dumps(out), flush=True)
    out = check_fast_vjp_off(torch, train_root)
    by_phase["float32"]["fast_vjp_off_256"] = \
        out["fast_vjp_off"]["launches_fast_vjp_false"]
    print(json.dumps(out), flush=True)
    print(json.dumps(check_count_params(torch)), flush=True)
    print(f"zoo phase: {time.time() - t0:.1f} s", flush=True)
    return by_phase


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    try:
        from dahitra_tpu_torch.core.checkpoint import (load_checkpoint,
                                                        save_checkpoint)
        from dahitra_tpu_torch.data.synthetic import write_synthetic_levir
        from dahitra_tpu_torch.kernels import _build
        from dahitra_tpu_torch.models.registry import define_g
        from dahitra_tpu_torch.utils import disable_tf32
    except ImportError as e:
        fail(f"the port's package is missing beside this script ({e})")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    disable_tf32()

    # 2. build, and the decoder row kernels' registers, spills, HMMA
    # instructions and CTAs per SM
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    ptxas = {src: start_ptxas_report(tmp, src) for src in ROW_KERNELS}
    _build.build(_build.sources())
    print(f"build: {_build.sources()} in {time.time() - t0:.1f} s", flush=True)
    resources = {src: row_kernel_resources(torch, tmp, src, proc)
                 for src, proc in ptxas.items()}
    print(json.dumps({"row_kernel_resources": resources}), flush=True)

    # 3. kernels against their plain versions
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    floor_ms = empty_launch_ms(torch)
    print(json.dumps({"empty_launch_ms": floor_ms}), flush=True)
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        train = [sh for sh in XBD_K1_SHAPES if sh[1] == 1]
        checks[("k1", dname)] = check_k1(torch, dtype, gen) + check_k1(
            torch, dtype, gen, XBD_K1_SHAPES)
        checks[("k1_save", dname)], checks[("k2", dname)] = (
            a + b for a, b in zip(check_k1_save_k2(torch, dtype, gen),
                                  check_k1_save_k2(torch, dtype, gen, train)))
        checks[("k3", dname)] = check_k3(torch, dtype, gen)
        checks[("k4", dname)], io_rows = check_k4(torch, dtype, gen)
        checks[("k4_io", dname)] = io_rows
        # the mlp_dim-64 instances at BIT's shapes
        checks[("k1_mlp64", dname)] = check_k1(
            torch, dtype, gen, BIT_SHAPES + XBD_BIT_SHAPES, BIT_MLP)
        checks[("k1_save_mlp64", dname)], checks[("k2_mlp64", dname)] = \
            check_k1_save_k2(torch, dtype, gen,
                             BIT_SHAPES + XBD_BIT_SHAPES[:1], BIT_MLP)
        checks[("k4_mlp64", dname)] = check_k4(torch, dtype, gen, BIT_SHAPES,
                                               BIT_MLP)[0]
        # token counts the tiles do not hold as they are (fault 3.2)
        checks[("k1_pad", dname)] = check_k1(torch, dtype, gen, PAD_SHAPES)
        checks[("k1_save_pad", dname)], checks[("k2_pad", dname)] = \
            check_k1_save_k2(torch, dtype, gen, PAD_SHAPES)
        checks[("k4_pad", dname)] = check_k4(torch, dtype, gen,
                                             PAD_SHAPES_K4)[0]
        # padded hl above 128 (fault 3.2, closed)
        checks[("k1_wide", dname)] = check_k1(torch, dtype, gen, WIDE_SHAPES)
        checks[("k1_save_wide", dname)], checks[("k2_wide", dname)] = \
            check_k1_save_k2(torch, dtype, gen, WIDE_SHAPES)
        for kid in ("k1", "k1_save", "k2", "k3", "k4", "k4_io", "k1_mlp64",
                    "k1_save_mlp64", "k2_mlp64", "k4_mlp64", "k1_pad",
                    "k1_save_pad", "k2_pad", "k4_pad", "k1_wide",
                    "k1_save_wide", "k2_wide"):
            for r in checks[(kid, dname)]:
                print(json.dumps({"check": f"{kid}[{dname}]", **r}),
                      flush=True)
    print(json.dumps(check_k4_grads(torch, gen)), flush=True)

    # 4. synthetic LEVIR and a seeded checkpoint
    t0 = time.time()
    write_synthetic_levir(os.path.join(tmp, "data"), n_tiles=4, size=1024,
                          seed=0)
    model = define_g("newUNetTrans", img_size=IMG)
    model.init_weights(torch.Generator().manual_seed(0))
    save_checkpoint(os.path.join(tmp, "ckpt", "smoke"), model.state_dict(),
                    best_val_acc=0.0, best_epoch_id=0)
    print(f"setup: synthetic LEVIR + checkpoint in {time.time() - t0:.1f} s",
          flush=True)

    # 5. the eval path, fp32 then bf16
    dtypes = (([], "float32"), (["--bf16"], "bfloat16"))
    by_phase = {"float32": {}, "bfloat16": {}}
    _record_confusion_matrices()
    for flag, dname in dtypes:
        out = run_eval(torch, os.path.join(tmp, "data"),
                       os.path.join(tmp, "ckpt"), "smoke", flag, dname, IMG,
                       BATCH, 64, patches=16)
        by_phase[dname]["eval_256"] = out["launches"]
        print(json.dumps(out), flush=True)
        if dname == "float32":
            cm5 = EVAL_CMS[-1]

    # 6. the card's forward (kernels) against the plain path on the CPU
    print(json.dumps(check_forward_vs_cpu(torch, model,
                                          os.path.join(tmp, "data"), IMG, 2,
                                          patch=5)), flush=True)

    # 7. the training path, fp32 then bf16
    train_root = os.path.join(tmp, "train")
    for split, n, seed in (("train", TRAIN_PAIRS, 1), ("val", VAL_PAIRS, 2)):
        write_synthetic_levir(os.path.join(train_root, "data"), n_tiles=n,
                              size=IMG, split=split, seed=seed)
    for flag, dname in dtypes:
        out = run_training(torch, train_root, flag, dname)
        by_phase[dname]["train_256"] = out["launches"]
        print(json.dumps(out), flush=True)

    # 8. the card's training gradients against the plain path on the CPU
    print(json.dumps(check_train_grads(torch, train_root)), flush=True)

    # 9-10. the pallas path (K4): eval forwards, then train steps
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        out = run_pallas_eval(torch, tmp, dtype)
        by_phase[dname]["pallas_eval_256"] = out["launches"]
        print(json.dumps(out), flush=True)
        out = run_pallas_train(torch, tmp, dtype)
        by_phase[dname]["pallas_train_256"] = out["launches"]
        print(json.dumps(out), flush=True)

    # 11. the pallas path's training gradients against the CPU
    print(json.dumps(check_train_grads(torch, train_root, pallas=True)),
          flush=True)

    # 12. eval at 512 px (16 tiles of 512 px, batch 8) and at 1024 px (phase
    # 4's tiles, batch 2), each with a seeded checkpoint of its size
    del model
    root512 = os.path.join(tmp, "px512")
    write_synthetic_levir(os.path.join(root512, "data"), n_tiles=16, size=512,
                          seed=3)
    models = {}
    for img in (512, 1024):
        models[img] = define_g("newUNetTrans", img_size=img)
        models[img].init_weights(torch.Generator().manual_seed(img))
        save_checkpoint(os.path.join(tmp, "ckpt", f"smoke{img}"),
                        models[img].state_dict(), best_val_acc=0.0,
                        best_epoch_id=0)
    for img, batch, n_pairs, data in (
            (512, BATCH, 16, os.path.join(root512, "data")),
            (1024, 2, 4, os.path.join(tmp, "data"))):
        for flag, dname in dtypes:
            out = run_eval(torch, data, os.path.join(tmp, "ckpt"),
                           f"smoke{img}", flag, dname, img, batch, n_pairs)
            by_phase[dname][f"eval_{img}"] = out["launches"]
            print(json.dumps(out), flush=True)
    print(json.dumps(check_forward_vs_cpu(torch, models[512],
                                          os.path.join(root512, "data"), 512,
                                          1)), flush=True)
    del models

    # 13. training at 512 px (batch 4, one epoch over 8 pairs, 4 val pairs),
    # then one train step at 1024 px per dtype and path
    for split, n, seed in (("train", 8, 4), ("val", 4, 5)):
        write_synthetic_levir(os.path.join(root512, "data"), n_tiles=n,
                              size=512, split=split, seed=seed)
    for flag, dname in dtypes:
        out = run_training(torch, root512, flag, dname, img=512, batch=4,
                           epochs=1, train_pairs=8, val_pairs=4)
        by_phase[dname]["train_512"] = out["launches"]
        print(json.dumps(out), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for pallas in (False, True):
            out = run_step_1024(torch, tmp, dtype, pallas)
            by_phase[dname]["pallas_step_1024" if pallas
                            else "step_1024"] = out["launches"]
            print(json.dumps(out), flush=True)

    # 14. BIT (base_transformer_pos_s4_dd8, mlp_dim 64) and base_resnet18
    by_phase_bit = run_bit_phase(torch, tmp, train_root, dtypes)
    for dname, phases in by_phase_bit.items():
        by_phase[dname].update(phases)

    # 15. xBD: xbd_train and xbd_predict (xbd_dahitra), one step and a
    # prediction of xbd_bit, at 1024 px; the card's gradients at 256 px
    for dname, phases in run_xbd_phase(torch, tmp, dtypes).items():
        by_phase[dname].update(phases)

    # 16. the rest of the xBD stack: xbd_train --task loc, adapt (both
    # networks), gan and damage --elastic, visualize_results, warm steps, the
    # card's loc and GAN gradients at 256 px
    for dname, phases in run_xbd_tasks_phase(torch, tmp, dtypes).items():
        by_phase[dname].update(phases)

    # 17. the rest of the LEVIR zoo (no decoder or tokenizer kernel), demo,
    # import_checkpoint, fast_vjp=False and count_params
    for dname, phases in run_zoo_phase(torch, tmp, train_root, dtypes,
                                       cm5).items():
        by_phase[dname].update(phases)

    if "--profile" in sys.argv[1:]:
        for net_g, project, n_dec in (("newUNetTrans", "smoke", 3),
                                      (BIT_KEY, BIT_KEY, 1)):
            sd = load_checkpoint(os.path.join(tmp, "ckpt", project))[0]
            for dtype in (torch.float32, torch.bfloat16):
                for pallas in (False, True):
                    print(json.dumps(profile_forward(
                        torch, sd, dtype, pallas, net_g, n_dec)), flush=True)
                    print(json.dumps(profile_train_step(
                        torch, tmp, dtype, pallas, net_g, n_dec)), flush=True)

    kernels = []
    src = "dahitra_tpu_torch/csrc/"
    fwd_res = resources["decoder_fwd"]
    k1_res = {d: fwd_res[d] for d in ("float32", "bfloat16")}
    k1_save_res = {d: fwd_res[d + "_save"] for d in ("float32", "bfloat16")}
    k4_res = {d: {i: resources["fused_decoder"][i] for i in K4_INSTANCES[d]}
              for d in ("float32", "bfloat16")}
    sfx = f"_mlp{BIT_MLP}"
    k1w_res = {d: fwd_res[d + sfx] for d in ("float32", "bfloat16")}
    k1w_save_res = {d: fwd_res[d + "_save" + sfx]
                    for d in ("float32", "bfloat16")}
    k2w_res = {d: resources["decoder_bwd"][d + sfx]
               for d in ("float32", "bfloat16")}
    k4w_res = {d: {i + sfx: resources["fused_decoder"][i + sfx]
                   for i in K4_INSTANCES[d][:1]}
               for d in ("float32", "bfloat16")}
    pad_res = {kid: {d: res[d + "_pad"] for d in ("float32", "bfloat16")}
               for kid, res in (("k1", fwd_res), ("k2", resources["decoder_bwd"]))}
    pad_res["k1_save"] = {d: fwd_res[d + "_save_pad"]
                          for d in ("float32", "bfloat16")}
    pad_res["k4"] = {d: {i + "_pad": resources["fused_decoder"][i + "_pad"]
                         for i in K4_INSTANCES[d][:1]}
                     for d in ("float32", "bfloat16")}
    # The WIDE_SHAPES run K1's PAD instances and K2's instances by their
    # group (PAD at 16 tokens), in fp32 its WIDE ones where the 64-row tiles
    # do not fit (hl 200 and 224).
    bwd_res = resources["decoder_bwd"]
    k2_wide_res = {"float32": {i: bwd_res[i] for i in
                               ("float32", "float32_pad", "float32_wide",
                                "float32_pad_wide")},
                   "bfloat16": {i: bwd_res[i] for i in
                                ("bfloat16", "bfloat16_pad")}}
    # (name, source, TPU kernel, checks, the 256 px phase whose count is
    # ``launches``, counter, tolerances, extra keys)
    table = (
        ("decoder_stack_fwd", "decoder_fwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:180", "k1", "eval_256", "k1",
         TOL, {"design": K1_DESIGN, "resources": k1_res}),
        ("decoder_stack_fwd_save", "decoder_fwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:180", "k1_save", "train_256",
         "k1_save", TOL, {"design": K1_DESIGN, "resources": k1_save_res}),
        ("decoder_stack_bwd", "decoder_bwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:320", "k2", "train_256", "k2",
         GTOL, {"design": K2_DESIGN, "resources": resources["decoder_bwd"]}),
        ("semantic_tokenizer", "tokenizer.cu",
         "dahitra_tpu/pallas/fused_tokenizer.py:42", "k3", "eval_256", "k3",
         TOL, {"empty_launch_ms": {"float32": floor_ms,
                                   "bfloat16": floor_ms}}),
        ("fused_decoder", "fused_decoder.cu",
         "dahitra_tpu/pallas/fused_decoder.py:102", "k4", "pallas_eval_256",
         "k4", TOL, {"design": K4_DESIGN, "resources": k4_res}),
        # the mlp_dim-64 instances, launched by the BIT phases
        ("decoder_stack_fwd" + sfx, "decoder_fwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:180", "k1_mlp64",
         "bit_eval_256", "k1", TOL,
         {"design": K1_DESIGN, "resources": k1w_res}),
        ("decoder_stack_fwd_save" + sfx, "decoder_fwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:180", "k1_save_mlp64",
         "bit_train_256", "k1_save", TOL,
         {"design": K1_DESIGN, "resources": k1w_save_res}),
        ("decoder_stack_bwd" + sfx, "decoder_bwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:320", "k2_mlp64",
         "bit_train_256", "k2", GTOL,
         {"design": K2_DESIGN, "resources": k2w_res}),
        ("fused_decoder" + sfx, "fused_decoder.cu",
         "dahitra_tpu/pallas/fused_decoder.py:102", "k4_mlp64",
         "bit_pallas_eval_256", "k4", TOL,
         {"design": K4_DESIGN, "resources": k4w_res}),
        # the token counts of fault 3.2 (PAD_SHAPES, one call each): no main
        # path sends them, so their counters read 0 in every phase
        ("decoder_stack_fwd_pad", "decoder_fwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:180", "k1_pad", "eval_256",
         "k1_pad", TOL, {"design": K1_DESIGN, "resources": pad_res["k1"]}),
        ("decoder_stack_fwd_save_pad", "decoder_fwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:180", "k1_save_pad",
         "train_256", "k1_save_pad", TOL,
         {"design": K1_DESIGN, "resources": pad_res["k1_save"]}),
        ("decoder_stack_bwd_pad", "decoder_bwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:320", "k2_pad", "train_256",
         "k2_pad", GTOL, {"design": K2_DESIGN, "resources": pad_res["k2"]}),
        ("fused_decoder_pad", "fused_decoder.cu",
         "dahitra_tpu/pallas/fused_decoder.py:102", "k4_pad",
         "pallas_eval_256", "k4_pad", TOL,
         {"design": K4_DESIGN, "resources": pad_res["k4"]}),
        # padded hl above 128 (WIDE_SHAPES, one call each): counted, as the
        # padded counts are, by the pad counters, which read 0 everywhere
        ("decoder_stack_fwd_wide", "decoder_fwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:180", "k1_wide", "eval_256",
         "k1_pad", TOL, {"design": K1_DESIGN, "resources": pad_res["k1"]}),
        ("decoder_stack_fwd_save_wide", "decoder_fwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:180", "k1_save_wide",
         "train_256", "k1_save_pad", TOL,
         {"design": K1_DESIGN, "resources": pad_res["k1_save"]}),
        ("decoder_stack_bwd_wide", "decoder_bwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:320", "k2_wide", "train_256",
         "k2_pad", GTOL, {"design": K2_DESIGN, "resources": k2_wide_res}))
    for dname in ("float32", "bfloat16"):
        for name, source, replaces, kid, phase, counter, tol, extra in table:
            # The BIT phases launch the decoder kernels' mlp_dim-64 instances
            # only, the others their mlp_dim-32 ones; K3 runs in both.
            mlp64 = kid.endswith("_mlp64")
            pad = kid.endswith(("_pad", "_wide"))
            phases = {ph: c[counter] for ph, c in by_phase[dname].items()
                      if kid == "k3" or pad or ph == "resnet_eval_256"
                      or ph.startswith("bit_") == mlp64}
            kernels.append(summarize(
                name, src + source, replaces, dname, checks[(kid, dname)],
                by_phase[dname][phase][counter], tol, phases,
                main_size="bit" if mlp64 else kid.rsplit("_", 1)[1] if pad
                else str(IMG), **{k: v[dname] for k, v in extra.items()}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
