"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--phases 1-3,19] [--profile]

Drives the port's main paths, LEVIR-CD evaluation and training of DAHiTra
(``newUNetTrans``) at its published width, at 256 px and then at 512 and
1024 px, and of BIT (``base_transformer_pos_s4_dd8``) and ``base_resnet18``
at 256 px, through the user's entry points ``dahitra_tpu_torch.cli.eval_cd``
and ``dahitra_tpu_torch.cli.main_cd``, and xBD damage training and
prediction at 1024 px (``xbd_dahitra``, ``xbd_bit``) through
``dahitra_tpu_torch.cli.xbd_train`` and ``xbd_predict``, the rest of
the xBD stack (``xbd_train --task loc | adapt | gan``, ``--elastic``,
``visualize_results``), the rest of the LEVIR-CD zoo with ``demo``,
``import_checkpoint`` and ``count_params``, and the xBD half of the zoo
(SE-ResNeXt50, SENet154 and DPN92 UNets, the xBD UNet change transformers,
Dual-HRNet with ``xbd_train --task hrnet``), data parallelism
(``core/mesh.py``: ``--gpu_ids``, DDP, global BatchNorm statistics, the
padded loader), the host-free step (``--scan_epoch``,
``eval_models(scan=True)``: CUDA-graph replays of the train and eval
steps), and the space axis (``nn/space.py``: image rows sharded over the
ranks of a grid, with halo exchanges and the rank-split K3; BIT,
``xbd_bit``, ``pallas = True``, ``siamUnet_conc`` and the UNet change
transformers on a rank's rows). ``--phases`` runs the phases it lists (every phase
without it), with the phases whose output they read (``PHASE_NEEDS``) and
phase 1; the kernels are built in every selection. Phases, each fatal on
failure:

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
     loaded, median of 3), 3 warm ``XBDTrainer.train_step`` calls of
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
     one over 2 tiles (3 K1, 3 K3 a tile; grids of (1024, 4096, 3)); 3 warm
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
     ``eval_cd`` on its checkpoint and 3 warm ``CDTrainer.train_step`` calls
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
     unchanged);
 18. the xBD half of the zoo (``run_xbd_zoo_phase``) on 4 seeded 1024 px
     tiles of its own (phase 15's test tiles to predict), batch 1, cuDNN deterministic, fp32 then bf16: one epoch of ``xbd_train
     --task damage`` with ``xbd_seresnext50_double``, ``xbd_senet154_double``,
     ``xbd_dpn92_double`` and ``xbd_unet_change_transformer`` at 1024 px and
     ``xbd_unet_change_transformer_bit`` at 256 px (its feed-forward is
     dim^2 wide, dim = (img / 32)^2), ``--task loc`` with the three ``_loc``
     keys and ``--task hrnet`` with ``dual_hrnet`` and ``dual_hrnet_fpn``,
     each but the ``_loc`` keys and ``dual_hrnet_fpn`` with one warm step
     (time, peak memory), none launching
     K1, K1-save, K2, K3 or K4; ``xbd_predict`` with the SENet154 double
     checkpoint over 2 tiles; the fp32 SENet154 double and Dual-HRNet
     checkpoints written as reference ``.pt`` files and imported, the
     logits bit for bit those of the checkpoints; the card's fp32 eval
     forward (1e-3, argmax) and train-step gradients and BN statistics
     (1e-3 and 1e-4, or phase 16's rule where larger) of
     ``xbd_seresnext50_double``,
     ``xbd_dpn92_double``, ``xbd_unet_change_transformer_bit`` (dropout
     rate 0) and ``dual_hrnet`` at 128 px against the CPU plain path; two
     same-seed train steps of the ``_bit`` model with dropout on: the same
     loss bits;
 19. data parallelism (``run_mesh_phase``): ``CDTrainer`` of
     ``newUNetTrans`` in ``DistributedDataParallel`` under NCCL at world
     size 1 against the plain trainer (the same bits over 2 steps, the warm
     step of both); two gloo ranks on the card (collectives staged through
     host memory) against one process on the joined batch: a
     ``newUNetTrans`` step at joined batch 8 and an ``xbd_dahitra`` damage
     step at 256 px, joined batch 2, fp32 and bf16 (the loss, every
     gradient, the running statistics; K1-save, K2 and K3 launched on each
     rank as in one step of phases 7 and 15), and ``CDEvaluator`` over 5
     padded patches at batch 4 (one process's matrix exactly); then
     ``main_cd``, ``xbd_train`` and ``eval_cd`` with ``--gpu_ids 0``: no
     process group, the same results as their bodies run directly;
 20. the host-free step (``run_graph_phase``, ``train/graph.py``), cuDNN
     deterministic: (a) two ``newUNetTrans`` trainers of one seed with
     ``--scan_epoch`` at 256 px, batch 8, fp32 then bf16, ``GRAPH_STEPS``
     steps of epoch 0 in ``_epoch_perm`` order, one as CUDA-graph replays
     of the captured step (K1-save, K2, K3 inside), one as eager
     ``train_step`` calls: the same loss, parameter, buffer and generator
     bits; the warm step of each (median of ``GRAPH_TIMED``), one replay's
     and one eager step's device-busy time and idle share (torch.profiler),
     a replay's kernel rows (6 K1-save, 6 K2 of 2 kernels, 3 K3 of 2);
     (b) the same with ``pallas = True`` (6 K4 of 2 kernels, 3 K3; the
     plain-stack backward in the graph); (f) the captured step in
     ``DistributedDataParallel`` under NCCL at world size 1: (a)'s fp32
     bits; (c) ``main_cd --scan_epoch --log_chunks 2`` for 2 epochs on
     phase 7's splits: a progress line after the 2nd of 4 steps in each
     epoch, then a trainer with its weights at batch 3 (a tail of 2): the
     replayed validation matrix equals the per-batch one; (d)
     ``CDEvaluator.eval_models(scan=True)`` over phase 4's 64 patches at
     batch 8: phase 5's matrix exactly, its pairs/s beside phase 5's, the
     warm replays' rate and a replay's kernel rows (6 K1, 3 K3); (e)
     ``xbd_dahitra`` damage at 1024 px, batch 1, over phase 15's 8 tiles,
     fp32 then bf16, graphed against eager as (a) (3 K1-save, 3 K2, 3 K3 a
     replay). The launch counters, set to 0 before each graphed run, count
     the ``GRAPH_WARMUP`` warm-up steps and the capture, never a replay
     (the Python wrappers do not run then); the profiler's kernel rows
     count a replay's launches (``launches_per_replay`` in the kernels
     line);
 21. the space axis (``run_space_phase``, ``nn/space.py``), cuDNN
     deterministic: two gloo ranks on cuda:0 (n_data 1, n_space 2; halos,
     gathers and all-reduces staged through host memory), each holding half
     the rows, against one process on the same card, weights and data: (a)
     the ``newUNetTrans`` eval forward at 256 px, batch 8; (b) its
     row-sharded ``CDTrainer.train_step`` on pairs with a painted change;
     (c) ``xbd_dahitra``'s damage step at 1024 px, batch 1; (d) the
     rank-split K3 at every tokenizer shape (a)-(c) send (the same token
     bits on both ranks); (e) the replicated grid (``spatial=False``), each
     in fp32 and bf16 ((e) fp32): the logits, the loss, every gradient leaf,
     the updated BatchNorm statistics, each rank's launches (the rank-split
     K3 3 a forward and the one-process K3 0 in the row-sharded runs, K1 6,
     K1-save 6, K2 6), peak memory and warm step beside one process's;
     then the rank-split K3's per-rank launches timed with two
     ranks simulated in one process (``semantic_tokenizer_ranks`` in the
     kernels line). In the same launch, uneven rows (a rank's rows not a
     multiple of the model's stride; the coarse levels gathered and run
     whole on both ranks): (f) ``newUNetTrans`` at 240 px, batch 8, eval
     and train step, both dtypes (1/16 whole: the one-process K3 1 and the
     rank-split K3 2 a forward); (g) ``xbd_res34_double``'s damage step at
     224 px, batch 2 (1/32 whole); (h) ``base_resnet18`` and BIT ``_dd8``
     eval at 232 px (1/8 whole); each rank's launches printed by kernel,
     and K3 (both), K1, K1-save and K2 timed at (f)'s shapes a rank
     (the ``_uneven`` entries of the kernels line);
 22. the decoder kernels on the space axis (``run_space_kernels_phase``),
     cuDNN deterministic: two gloo ranks on cuda:0, half the rows each,
     against one process on the same card, weights and data, fp32 and
     bf16: (a) ``base_transformer_pos_s4_dd8`` at 256 px, batch 8, its eval
     forward (each rank: the rank-split K3 2, K1 at mlp_dim 64 2) and its
     row-sharded ``CDTrainer.train_step`` on pairs with a painted change
     (K1-save 2, K2 2, K3 2); (b) ``_t8_e2d4``'s eval forward (8 tokens,
     hl 64); (c) ``xbd_bit``'s damage step at 1024 px, batch 1; (d) with
     ``pallas = True``, ``newUNetTrans``'s eval forward and step at 256 px
     (K4 6 a rank, K3 3), ``xbd_dahitra``'s damage step at 1024 px (K4 3 a
     rank, as one process's pallas step) and the ``_dd8`` eval forward (K4
     at mlp_dim 64, 2): the gathered logits (bf16: 2e-2, BIT's fixed
     ``SPACE22_BIT_BF16_TOL``, as its |f1 - f2| head cancels), every
     decoder's gate as one process's, the steps' loss, gradients and BN
     statistics (``_check_two_ranks``; the bf16 steps at batch 1 a rank
     also against one process in the ranks' BN order),
     each rank's launches, its peak memory and warm step beside one
     process's; then K1, K1-save and K2 at mlp_dim 64 and
     K4 at mlp_dim 32 and 64 at a rank's shapes (``RANK_*_SHAPES``)
     against their plain versions, rerun for the same bits and timed (the
     ``_rank`` entries of the kernels line);
 23. ``siamUnet_conc``, the UNet change transformers and ChangeFormer V1
     and V6 on the space axis (``run_space_zoo_phase``), cuDNN
     deterministic: two gloo ranks on cuda:0, half the rows each, against
     one process on the same card, seeded weights and data, at 256 px,
     batch 8: each key's fp32 eval forward (1e-5 of scale, every head of
     V6's list), one fp32 row-sharded ``CDTrainer.train_step`` with
     dropout active (V6 on its five heads; ``_check_two_ranks``) and a warm
     step, and its bf16 eval forward (2e-2); then at 224 px
     ``unet_coupled_two_trans_256`` (1/32 whole: its ``transformer`` on the
     whole level, ``transformer2`` on the rank's block of the 1/4 level)
     and ``changeFormerV6`` (every sr conv on its level's rows gathered,
     1/32 and the p4 head whole), fp32 eval and step; each channel-token
     transformer on the rank's block of the token width where its level
     splits, no kernel launched, each rank's peak memory, warm step and
     staged collectives beside one process's.

Every launch counter is set to 0 just before each main-path run (phases 5,
7, 9, 10, 12, 13, 14, 15, 16, 17, 18, 20, 21, 22, 23) and read just after
(phases 19, 21, 22 and 23 read each rank's counters before and after its
run);
the counters of the padded token counts and of the rank-split K3
(``NO_PAD``) must read 0 in every one of them but the row-sharded runs of
phases 21 and 22, which launch the rank-split K3 (and there the
one-process K3 0). ``--profile`` adds a torch.profiler
breakdown of the batch-8 forward and of one batch-8 training step by kernel
class, with the device's idle share, on the default path and with
``pallas = True``, and of one 1024 px xBD step of ``xbd_senet154_double``
and ``dual_hrnet`` in each dtype.

``{"phase_seconds": {...}}`` gives each phase's wall time (9 and 10 as one,
``profile`` the ``--profile`` breakdowns). The line before the last is
``{"kernels": [...]}`` (a phase that did not
run gives ``null`` launches, and without phase 3 every measured number is
``null``); the last is
``{"ok": true, "device": {...}}``. Exits non-zero, printing neither, when no
CUDA device is present or the port's package is missing. Needs one card;
imports nothing of JAX.
"""
from __future__ import annotations

import collections
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


PHASES = range(1, 24)
# What a phase reads from another: phase 4's tree and checkpoint, phase 5's
# confusion matrix, phase 15's damage checkpoints. (Phase 7's splits and
# phase 15's tiles are written for whichever phase reads them.)
PHASE_NEEDS = {5: {4}, 6: {4}, 9: {4}, 10: {4}, 12: {4}, 14: {4}, 16: {15},
               17: {4, 5}, 19: {4, 5}, 20: {4, 5}}


def selected_phases(argv) -> set:
    """The phases of ``--phases`` (for example ``1-3,19``; every phase
    without it), with the phases they read from and phase 1; the kernels'
    build (phase 2's ``_build.build``) runs in every selection."""
    spec = None
    for i, a in enumerate(argv):
        if a == "--phases" and i + 1 < len(argv):
            spec = argv[i + 1]
        elif a.startswith("--phases="):
            spec = a.split("=", 1)[1]
    if spec is None:
        return set(PHASES)
    sel = {1}
    try:
        for part in filter(None, (p.strip() for p in spec.split(","))):
            lo, _, hi = part.partition("-")
            sel.update(range(int(lo), int(hi or lo) + 1))
    except ValueError:
        fail(f"--phases {spec!r}: not a list of phases and ranges")
    if not sel <= set(PHASES):
        fail(f"--phases {spec!r}: phases run from 1 to {PHASES[-1]}")
    while True:
        more = set().union(*(PHASE_NEEDS.get(p, set()) for p in sel)) - sel
        if not more:
            return sel
        sel |= more


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


# Timed calls of a plain version (``plain_ms``): 2 a round, median of 3
# rounds, after one warm-up. The plain versions take 3-60 ms a call: timed
# 51 times each, they took 70 of phase 3's 112 s on an H100 whose phases
# ran a third slower than usual, and the script 1210 s of its 1200.
PLAIN_REPS = {"reps": 2, "rounds": 3}


def _reset_counts() -> None:
    from dahitra_tpu_torch.tools.mesh_checks import reset_launches

    reset_launches()


# The pad counters (the main-path runs send no token count that the kernels
# pad) and the rank-split K3's (only the row-sharded runs of phases 21 and
# 22 split the tokenizer over ranks): every other main-path run must read
# them 0.
NO_PAD = {"k1_pad": 0, "k1_save_pad": 0, "k2_pad": 0, "k4_pad": 0,
          "k3_ranks": 0}


def _read_counts() -> dict:
    from dahitra_tpu_torch.tools.mesh_checks import launches

    return launches()


def _set_pallas(model, on: bool, n_decoders: int = 3) -> None:
    """``pallas = on`` on the model's decoder stacks (DAHiTra's three,
    BIT's one), as a JAX user sets the field (no flag selects it)."""
    from dahitra_tpu_torch.tools.space_checks import set_pallas

    found = set_pallas(model, on)
    if found != n_decoders:
        fail(f"expected {n_decoders} TransformerDecoders, found {found}")


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
                *ops_in, depth, heads, dtype, b1=b1), torch, **PLAIN_REPS),
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
                **PLAIN_REPS),
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
                torch, **PLAIN_REPS),
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


def check_k3(torch, dtype, gen, shapes=None):
    """K3 against its plain version at every tokenizer shape of ``shapes``
    (by default the main paths': 256 and 512 px at batch 8, 1024 px at
    batch 2, the xBD path's at 1024 px batch 1 and 4); a second call must
    give the same bits. ``ms`` is timed as every kernel's is, the calls made
    back to back on an idle card, which at these sizes is mostly the host's
    time to enqueue two kernels; ``device_ms`` is the same calls enqueued
    behind queued work, device time alone. The library
    yardstick is one scaled_dot_product_attention call with the L
    token-logit columns as queries and the pixels as keys and values."""
    import torch.nn.functional as F

    from dahitra_tpu_torch.kernels import fused_tokenizer as ft

    dname = str(dtype).split(".")[-1]
    rows = []
    for name, b, n in shapes or K3_SHAPES:
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
            "plain_ms": time_ms(lambda: ft.semantic_tokenizer_plain(x, w),
                                torch, **PLAIN_REPS),
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
                       **PLAIN_REPS),
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
    if not rows:  # phase 3 not selected: every measured number null
        return {"name": f"{name}[{dname}]", "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                **{k: None for k in ("max_abs_err", "scaled_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
                "tolerance": tol[dname], "launches_by_phase": by_phase or {},
                **extra}
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
# after one warm-up each (the median and the range are printed); 3 keep
# the whole script inside its time on a slow card.
XBD_TIMED = 3


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
    each, none for a model without a decoder); both PNGs of every tile, 1024 x 1024 uint8, damage in 0..3. Then
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
    dec = XBD_CALLS.get(net_g, 0) * XBD_PREDICT_TILES
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


def xbd_tiles(tmp) -> tuple:
    """Phase 15's seeded synthetic tiles, ``XBD_TILES`` to train on and
    ``XBD_PREDICT_TILES`` to predict, under ``<tmp>/xbd``, written once
    (phases 18 and 19 read them without phase 15)."""
    from dahitra_tpu_torch.data.synthetic import write_synthetic_xbd

    root = os.path.join(tmp, "xbd")
    roots = tuple(os.path.join(root, s) for s in ("train", "test"))
    if not os.path.isdir(roots[0]):
        write_synthetic_xbd(roots[0], XBD_TILES, XBD_IMG, seed=0)
        write_synthetic_xbd(roots[1], XBD_PREDICT_TILES, XBD_IMG, seed=1)
    return roots


def run_xbd_phase(torch, tmp, dtypes) -> dict:
    """Phase 15: the xBD damage path at 1024 px on seeded synthetic tiles.
    ``xbd_train`` (xbd_dahitra) and ``xbd_predict`` with its checkpoint per
    dtype, one warm step of each model, xbd_bit's prediction from its
    trainer's weights, and the card's gradients against the CPU. Returns
    the launch counts by dtype and phase."""
    from dahitra_tpu_torch.core.checkpoint import save_checkpoint
    from dahitra_tpu_torch.data.xbd import (load_xbd_pairs, scan_xbd_files,
                                            split_and_upsample)

    t0 = time.time()
    root = os.path.join(tmp, "xbd")
    data_root, test_root = xbd_tiles(tmp)
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
                 dname, n_val, img: int = XBD_IMG) -> dict:
    """``xbd_train --task <task>`` at ``img`` px (1024: the whole tiles),
    batch 1, one epoch with a
    validation, launch counters set to 0 just before and read just after;
    finite loss and score, ``best_ckpt.pt`` (and for gan ``best_ckpt_D.pt``,
    with a discriminator update at batches 0 and 8 of the 11) written."""
    from dahitra_tpu_torch.cli import xbd_train

    net = net_g or xbd_train.DEFAULT_NET.get(task, "xbd_dahitra")
    project = f"{task}_{net}{'_elastic' if extra else ''}_{dname}"
    argv = ["--data_root", data_root, "--task", task, "--img_size",
            str(img), "--batch_size", "1", "--max_epochs", "1",
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
            "img_size": img, "batch": 1, "steps": h["pairs"],
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


def run_xbd_task_steps(torch, tmp, task, net_g, dtype, arrays,
                       img: int = XBD_IMG, timed: int = XBD_TIMED) -> dict:
    """``timed`` warm train steps of ``task`` at ``img`` px (``arrays``
    of that size), batch 1 (the
    GAN's without a discriminator update, then ``timed`` with one), each
    timed alone on the host clock after a warm-up, launch counters set to 0
    just before and read just after; for gan also one ``--effective_gan``
    step, whose adversarial gradient (its generator gradient less that of
    the same step without it) must be nonzero."""
    dname = str(dtype).split(".")[-1]
    trainer = _task_trainer(torch, tmp, task, net_g, dtype, arrays, img)
    batch = [torch.from_numpy(arrays[k][:1]).cuda()
             for k in ("img_pre", "img_post", "msk", "lbl_msk")]
    kinds = {"step": lambda: trainer.train_step(*batch)}
    if task == "gan":
        kinds["step_with_disc_update"] = lambda: trainer.gan_step(
            *batch, update_disc=True)[0]
    out = {"xbd_task_steps": task, "net_G": net_g, "dtype": dname,
           "img_size": img, "batch": 1}
    for kind, fn in kinds.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        losses, times = [], []
        for _ in range(timed):
            t0 = time.time()
            losses.append(fn().item())
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
        got = _read_counts()
        want = _task_launches(net_g, timed, timed * (kind != "step"))
        if got != {**NO_PAD, **want} or not np.isfinite(losses).all():
            fail(f"xBD {task} {kind} {net_g} {dname}: launches {got} != "
                 f"{want} or losses {losses}")
        out[kind] = {"step_ms": _spread(times), "samples": timed,
                     "losses": losses,
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
ZOO_TIMED = 3  # warm steps a key
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


def _heads(out) -> dict:
    """A model's logits as a dict of heads (Dual-HRNet's loc and cls)."""
    return out if isinstance(out, dict) else {"logits": out}


def _no_dropout(model) -> None:
    from dahitra_tpu_torch.nn.blocks import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0


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
    from dahitra_tpu_torch.nn.init import init_weights

    pairs = load_levir_split(os.path.join(train_root, "data", "LEVIR_CD"),
                             "train", IMG)
    batch = [torch.from_numpy(t[:2]) for t in (pairs.a, pairs.b, pairs.label)]
    gen = torch.Generator().manual_seed(3)
    init = init_weights(define_g(key, img_size=IMG, generator=gen), "normal",
                        0.02, gen)
    _no_dropout(init)

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


# The xBD half of the zoo (phase 18), batch 1: (task,
# --net_G, image size). None of these models runs a decoder stack or a
# tokenizer. xbd_unet_change_transformer_bit trains at 256 px: its channel
# tokens are (img / 32)^2 wide and its feed-forward dim^2, 17.2 G parameters
# at 1024 px (ROADMAP.md section 3).
XBD_ZOO_BIT_IMG = 256
XBD_ZOO_RUNS = (
    ("damage", "xbd_seresnext50_double", XBD_IMG),
    ("damage", "xbd_senet154_double", XBD_IMG),
    ("damage", "xbd_dpn92_double", XBD_IMG),
    ("damage", "xbd_unet_change_transformer", XBD_IMG),
    ("damage", "xbd_unet_change_transformer_bit", XBD_ZOO_BIT_IMG),
    ("loc", "xbd_seresnext50_loc", XBD_IMG),
    ("loc", "xbd_senet154_loc", XBD_IMG),
    ("loc", "xbd_dpn92_loc", XBD_IMG),
    ("hrnet", "dual_hrnet", XBD_IMG),
    ("hrnet", "dual_hrnet_fpn", XBD_IMG))
# One key of each family against the CPU plain path, at 128 px.
XBD_ZOO_CHECKS = (("damage", "xbd_seresnext50_double"),
                  ("damage", "xbd_dpn92_double"),
                  ("damage", "xbd_unet_change_transformer_bit"),
                  ("hrnet", "dual_hrnet"))
XBD_ZOO_CHECK_IMG = 128
XBD_ZOO_PREDICT = "xbd_senet154_double"
# Phase 18's own seeded training tiles: half of phase 15's 8, so that an
# epoch of each run is half as long and phases 1-21 stay inside the 1200 s
# a smoke run may take (941 s with 8 tiles).
XBD_ZOO_TILES = 4
# Warm steps per run of phase 18: 1, so that phases 1-22 stay inside the
# 1200 s a smoke run may take (3 took the script to 1210 s on a card whose
# phases ran a third slower than usual).
XBD_ZOO_TIMED = 1
# Runs of phase 18 without warm steps (their epoch of ``xbd_train`` stays):
# the ``_loc`` keys and ``dual_hrnet_fpn``, whose trunks the damage and
# ``dual_hrnet`` runs time, and the SE-ResNeXt50, DPN92 and change-
# transformer doubles (SENet154's double, the ``_bit`` model and
# ``dual_hrnet`` keep theirs), so that phases 1-23 with phase 23's
# ChangeFormer cases stay inside the 1200 s.
XBD_ZOO_UNTIMED = ("xbd_seresnext50_loc", "xbd_senet154_loc",
                   "xbd_dpn92_loc", "dual_hrnet_fpn",
                   "xbd_seresnext50_double", "xbd_dpn92_double",
                   "xbd_unet_change_transformer")
XBD_ZOO_IMPORTS = ("xbd_senet154_double", "dual_hrnet")


def check_xbd_zoo_vs_cpu(torch, tmp, data_root) -> dict:
    """For one key of each family (``XBD_ZOO_CHECKS``) at 128 px, batch 1
    (a crop of a synthetic tile), fp32, the card against the CPU plain
    path: a seeded model's eval forward, each head within 1e-3 of its scale
    and the same argmax at >= 99.9 % of the pixels; then one train step of
    the key's task from the same seeded trainer (no augmentation, dropout
    rate 0): the gradients within 1e-3 of the whole gradient's scale or,
    where larger, twice the CPU path's own largest move under
    ``GRAD_MOVES`` input moves of 1e-6 (taken only then; phase 16's rule),
    the updated BN statistics within 1e-4 or, where larger, twice the CPU
    path's own largest move under the same input moves: at 128 px, batch
    1, Dual-HRNet's coarsest branch is 4 x 4 pixels, and the train-mode
    statistics there move about 1e-3 of their scale under the CPU's own
    1e-6 input moves (ROADMAP.md section 3, fault 5)."""
    import copy

    from dahitra_tpu_torch.data.xbd import load_xbd_pairs, scan_xbd_files
    from dahitra_tpu_torch.data.xbd_augment import augment_xbd
    from dahitra_tpu_torch.models.registry import define_g
    from dahitra_tpu_torch.nn.init import init_random

    img = XBD_ZOO_CHECK_IMG
    arrays = load_xbd_pairs(scan_xbd_files([data_root])[:1], train=False,
                            crop_size=img, seed=0).arrays()
    host = [torch.from_numpy(v) for v in arrays.values()]
    out = {}
    for task, key in XBD_ZOO_CHECKS:
        model = init_random(define_g(key, img_size=img),
                            torch.Generator().manual_seed(19)).eval()
        img6 = augment_xbd(*host, train=False)[0]
        with torch.inference_mode():
            ref = _heads(model(img6))
            got = _heads(copy.deepcopy(model).cuda()(img6.cuda()))
        fwd = {h: {"scaled_err": scaled_err(got[h].cpu(), r)[1],
                   "argmax_agreement": (got[h].cpu().argmax(-1)
                                        == r.argmax(-1)).float().mean()
                   .item()} for h, r in ref.items()}
        del model

        def step(dev, move=0):
            tr = _task_trainer(torch, tmp, task, key, torch.float32, arrays,
                               img, dev)
            _no_dropout(tr.model)

            def augment(*batch):
                img6, masks, lbl = augment_xbd(*batch, train=False)
                if move:
                    img6 = img6 + 1e-6 * torch.randn(
                        img6.shape, generator=torch.Generator().manual_seed(
                            move)).to(img6.device)
                return img6, masks, lbl

            tr._augment = augment
            tr.train_step(*(t.to(dev) for t in host))
            # Dual-HRNet's loc head gets no gradient (the loss reads its
            # argmax): JAX's zeros
            return ({k: (torch.zeros_like(p) if p.grad is None else p.grad)
                     .detach().cpu() for k, p in
                     tr.model.named_parameters()},
                    {k: b.cpu() for k, b in tr.model.named_buffers()})

        def bn_worst(bufs):
            return max(scaled_err(bufs[k], v)[1] for k, v in ref_b.items())

        ref_g, ref_b = step("cpu")
        card_g, card_b = step("cuda")
        torch.cuda.synchronize()
        scale = max(g.abs().max().item() for g in ref_g.values())
        port = _grad_blocks(ref_g, card_g, scale)
        worst = max(port, key=port.get)
        bn_err = bn_worst(card_b)
        own, own_bn = [], []
        if port[worst] > 1e-3 or bn_err > 1e-4:
            for m in range(1, GRAD_MOVES + 1):
                g, b = step("cpu", m)
                own.append(max(_grad_blocks(ref_g, g, scale).values()))
                own_bn.append(bn_worst(b))
        bound = max([1e-3] + [2 * o for o in own])
        bn_bound = max([1e-4] + [2 * o for o in own_bn])
        out[key] = {"task": task, "forward": fwd,
                    "grad_worst_over_scale": port[worst],
                    "worst_block": list(worst), "cpu_own_moves": own,
                    "bound": bound, "bn_stats_worst_scaled_err": bn_err,
                    "bn_cpu_own_moves": own_bn, "bn_bound": bn_bound}
        print(json.dumps({"xbd_zoo_vs_cpu_plain": key, **out[key]}),
              flush=True)
        if not (all(f["scaled_err"] <= 1e-3 and f["argmax_agreement"] >= 0.999
                    for f in fwd.values())
                and port[worst] <= bound and bn_err <= bn_bound):
            fail(f"{key}: the card disagrees with the CPU plain path: "
                 f"{out[key]}")
    return {"xbd_zoo_vs_cpu_plain": {"img_size": img, "batch": 1, **out}}


def check_xbd_zoo_dropout_step(torch, tmp, arrays) -> dict:
    """``xbd_unet_change_transformer_bit``'s transformer drops at 0.05 in
    training: one train step at 256 px from two trainers of the same seed,
    each built on a freed card (cuDNN deterministic, set by the phase): the
    loss is finite and the same bits, the dropout generators drew masks and
    end in the same state."""
    import gc

    key = "xbd_unet_change_transformer_bit"
    losses, states, drew = [], [], []
    for _ in range(2):
        gc.collect()
        torch.cuda.empty_cache()
        tr = _task_trainer(torch, tmp, "damage", key, torch.float32, arrays,
                           XBD_ZOO_BIT_IMG)
        fresh = tr.dropout_generator.get_state()
        losses.append(tr.train_step(*(torch.from_numpy(arrays[k][:1]).cuda()
                                      for k in ("img_pre", "img_post", "msk",
                                                "lbl_msk"))).item())
        states.append(tr.dropout_generator.get_state())
        drew.append(not torch.equal(fresh, states[-1]))
        del tr
    out = {"xbd_zoo_dropout_step": key, "img_size": XBD_ZOO_BIT_IMG,
           "losses": [float.hex(v) for v in losses], "masks_drawn": drew,
           "generator_states_equal": torch.equal(*states)}
    if not (np.isfinite(losses[0]) and losses[0] == losses[1] and all(drew)
            and out["generator_states_equal"]):
        fail(f"{key}: dropout step not reproducible: {out}")
    return out


def check_xbd_zoo_import(torch, tmp, ckpts) -> dict:
    """For each of ``XBD_ZOO_IMPORTS``: its fp32 checkpoint from this phase
    written as a reference ``.pt`` (``state_dict``, ``module.`` prefix),
    imported with ``import_checkpoint --net_G``; the imported weights'
    logits (every head) on the card equal, bit for bit, those of the
    checkpoint they came from, on a seeded 256 px pair."""
    from dahitra_tpu_torch.cli import import_checkpoint
    from dahitra_tpu_torch.core.checkpoint import (load_checkpoint,
                                                    load_weights)
    from dahitra_tpu_torch.models.registry import define_g

    x = torch.from_numpy(np.random.RandomState(18).uniform(
        -1, 1, (1, 256, 256, 6)).astype(np.float32)).cuda()
    out = {}
    for key in XBD_ZOO_IMPORTS:
        sd = load_checkpoint(ckpts[key, "float32"])[0]
        pt = os.path.join(tmp, f"reference_{key}.pt")
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   pt)
        dst = os.path.join(tmp, "imported", key)
        import_checkpoint.main([pt, "--net_G", key, "--img_size",
                                str(XBD_IMG), "--out", dst])
        logits = []
        for weights in (sd, load_checkpoint(dst)[0]):
            model = define_g(key, img_size=XBD_IMG)
            load_weights(model, weights)
            with torch.inference_mode():
                logits.append(_heads(model.cuda().eval()(x)))
            del model
        out[key] = {"tensors": len(sd), "logits_equal": all(
            torch.equal(logits[0][h], logits[1][h]) for h in logits[0])}
        if not out[key]["logits_equal"]:
            fail(f"import_checkpoint {key}: logits differ from the "
                 f"checkpoint's: {out[key]}")
    return {"xbd_zoo_import": out}


# Phase 18's steps that --profile breaks down: the slowest fp32 step and
# the most host-bound one.
XBD_ZOO_PROFILED = (("damage", "xbd_senet154_double"), ("hrnet", "dual_hrnet"))


def profile_xbd_zoo_steps(torch, tmp) -> dict:
    """``--profile``: device time by kernel class, device busy and idle
    share of one warm ``XBDTrainer.train_step`` at 1024 px, batch 1, per
    key of ``XBD_ZOO_PROFILED`` and dtype, on phase 15's first tile."""
    import gc

    from dahitra_tpu_torch.data.xbd import load_xbd_pairs, scan_xbd_files

    arrays = load_xbd_pairs(scan_xbd_files([os.path.join(
        tmp, "xbd", "train")])[:1], train=True).arrays()
    out = {}
    for task, key in XBD_ZOO_PROFILED:
        for dtype in (torch.float32, torch.bfloat16):
            gc.collect()
            torch.cuda.empty_cache()
            trainer = _task_trainer(torch, tmp, task, key, dtype, arrays)
            batch = [torch.from_numpy(arrays[k][:1]).cuda()
                     for k in ("img_pre", "img_post", "msk", "lbl_msk")]
            prof = _profile(torch, lambda: trainer.train_step(*batch), 3)
            out[f"{key}/{str(dtype).split('.')[-1]}"] = {**prof, "batch": 1}
            del trainer
    return {"profile_xbd_zoo_step_1024": out}


def run_xbd_zoo_phase(torch, tmp, dtypes) -> dict:
    """Phase 18: the xBD half of the zoo on ``XBD_ZOO_TILES`` seeded tiles
    of its own (phase 15's test tiles to predict), batch 1,
    cuDNN deterministic, fp32 then bf16: for every run of
    ``XBD_ZOO_RUNS`` one epoch of ``xbd_train`` with a validation and,
    but for ``XBD_ZOO_UNTIMED``, ``XBD_ZOO_TIMED`` warm steps (one sample,
    ``samples`` printed; peak memory; no decoder or tokenizer launch),
    ``xbd_predict`` with the
    SENet154 double checkpoint;
    then the imported checkpoints, the card against the CPU plain path
    and the dropout step. Returns the launch counts by dtype and phase."""
    import gc

    from dahitra_tpu_torch.data.xbd import (load_xbd_pairs, scan_xbd_files,
                                            split_and_upsample)

    from dahitra_tpu_torch.data.synthetic import write_synthetic_xbd

    t0 = time.time()
    root = os.path.join(tmp, "xbd")
    test_root = xbd_tiles(tmp)[1]
    data_root = os.path.join(root, "zoo_train")
    write_synthetic_xbd(data_root, XBD_ZOO_TILES, XBD_IMG, seed=0)
    ckpt_root = os.path.join(root, "ckpt_zoo")
    files = scan_xbd_files([data_root])
    n_val = len(split_and_upsample(files, seed=0)[1])
    arrays = {img: load_xbd_pairs(files[:1], train=True,
                                  crop_size=img).arrays()
              for img in (XBD_IMG, XBD_ZOO_BIT_IMG)}
    torch.backends.cudnn.deterministic = True
    by_phase = {"float32": {}, "bfloat16": {}}
    ckpts = {}
    for flag, dname in dtypes:
        dtype = getattr(torch, dname)
        for task, net_g, img in XBD_ZOO_RUNS:
            gc.collect()
            out = run_xbd_task(torch, data_root, ckpt_root, task, net_g, [],
                               flag, dname, n_val, img)
            ckpts[net_g, dname] = out["checkpoint"]
            by_phase[dname][f"{net_g}_{task}_{img}"] = out["launches"]
            if net_g in XBD_ZOO_UNTIMED:
                print(json.dumps(out), flush=True)
                continue
            gc.collect()
            steps = run_xbd_task_steps(torch, tmp, task, net_g, dtype,
                                       arrays[img], img,
                                       XBD_ZOO_TIMED)["step"]
            by_phase[dname][f"{net_g}_{task}_steps_{img}"] = \
                steps["launches"]
            print(json.dumps({**out, "warm_steps": steps}), flush=True)
        gc.collect()
        out = run_xbd_predict(torch, test_root, os.path.join(
            root, f"pred_zoo_{dname}"), XBD_ZOO_PREDICT,
            ckpts[XBD_ZOO_PREDICT, dname], flag, dname)
        by_phase[dname]["xbd_zoo_predict_1024"] = out["launches"]
        print(json.dumps(out), flush=True)
    gc.collect()
    print(json.dumps(check_xbd_zoo_import(torch, tmp, ckpts)), flush=True)
    print(json.dumps(check_xbd_zoo_vs_cpu(torch, tmp, data_root)), flush=True)
    print(json.dumps(check_xbd_zoo_dropout_step(
        torch, tmp, arrays[XBD_ZOO_BIT_IMG])), flush=True)
    torch.backends.cudnn.deterministic = False
    print(f"xBD zoo phase: {time.time() - t0:.1f} s", flush=True)
    return by_phase


# Phase 19: data parallelism (core/mesh.py) on the one card. Decoder (K1,
# K1-save, K2) and K3 calls per forward of each model, as phases 7 and 15
# count them; 5 timed warm steps; the patches of the padded evaluation.
MESH_CALLS = {"newUNetTrans": (6, 3), "xbd_dahitra": (XBD_CALLS["xbd_dahitra"],
                                                      3)}
MESH_TIMED = 5
MESH_EVAL_PATCHES, MESH_EVAL_BATCH = 5, 4
MESH_XBD_IMG = 256
# xbd_dahitra's leaves on the path of its trans modules 3 and 4 (their own
# parameters, the trunk that feeds them, the heads that read their
# decoders). With seeded weights the two dates' tokens there nearly agree,
# so the difference memory |t2 - t1| of their decoders cancels: a bf16
# rounding that a per-forward batch of 1 or a BatchNorm summation order
# decides moves these leaves' bf16 gradients by a large part of the
# gradient's scale within one process. The post tiles carry a painted
# change; the tokens still agree to about a tenth there (phase 19c prints
# the reading; PERF.md). Phase 19c holds the other leaves to the flat bf16
# bound and prints how many of these are within it.
MESH_BF16_UNHELD = ("resnet.conv1.", "resnet.bn1.", "resnet.layer1.",
                    "resnet.layer2.", "conv_layer2.", "conv_layer3.",
                    "conv_layer4.", "classifier.")


def _trans34_path(name: str) -> bool:
    return (name.split(".")[0].endswith(("_3", "_4"))
            or name.startswith(MESH_BF16_UNHELD))


# Phase 22d's bf16 pallas ``xbd_dahitra`` step at batch 1 a rank: besides
# trans modules 3-4's path, the second feed-forward weight of trans module
# 5's encoder, which one process moves by 6.05e-2 of scale when it sums
# BatchNorm's statistics in the ranks' order (the ranks lie 6.04e-2 from
# the plain one there, H100 80GB HBM3 at 700 W); it stays held against the
# ordered one.
SPACE22_BF16_UNHELD = ("transformer_5.layers.0.1.fn.fn.net.3.weight",)


def _trans34_path_pallas(name: str) -> bool:
    return _trans34_path(name) or name in SPACE22_BF16_UNHELD


def _mesh_cfg(tmp, tag, net_g, img, batch, dname, **kw) -> dict:
    return dict(n_class=2, checkpoint_dir=os.path.join(tmp, "mesh", tag),
                max_epochs=1, net_G=net_g, img_size=img, lr=1e-3,
                batch_size=batch, lr_policy="linear", device="cuda:0",
                seed=0, bf16=dname == "bfloat16", **kw)


def _ddp_world1(mesh, cfgs, arrays) -> dict:
    """A plain ``CDTrainer`` and one in ``DistributedDataParallel`` under
    ``mesh`` (``cfgs``: the two configurations), each two ``train_step``
    calls on epoch 0's first batches (cuDNN deterministic): their losses,
    the last step's gradients and the running statistics; then each
    trainer's warm step timed alone by CUDA events, ``MESH_TIMED`` pairs
    taken in turns (plain first, then DDP first), the medians."""
    import argparse

    import torch

    from dahitra_tpu_torch.tools.mesh_checks import _state
    from dahitra_tpu_torch.train.engine import CDTrainer

    out, steps = {}, {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for tag, m in (("plain", None), ("ddp", mesh)):
            tr = CDTrainer(argparse.Namespace(**cfgs[tag]), arrays, arrays,
                           device="cuda:0", mesh=m)
            batches = [tr._to_device(b)
                       for _, b in zip(range(2), tr.train_loader)]
            losses = torch.stack([tr.train_step(*b)[0] for b in batches])
            torch.cuda.synchronize()
            out[tag] = {"loss": losses, **_state(tr.model),
                        "ddp": type(tr.net).__name__ ==
                        "DistributedDataParallel"}
            steps[tag] = (lambda tr=tr, b=batches[0]: tr.train_step(*b))
    finally:
        torch.backends.cudnn.deterministic = det
    times = {"plain": [], "ddp": []}
    for r in range(MESH_TIMED + 1):  # the first pair warms up
        for tag in (("plain", "ddp") if r % 2 else ("ddp", "plain")):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            s.record()
            steps[tag]()
            e.record()
            e.synchronize()
            if r:
                times[tag].append(s.elapsed_time(e))
    for tag in times:
        out[tag]["step_ms"] = statistics.median(times[tag])
    return out


def _same_bits(a: dict, b: dict) -> bool:
    import torch

    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _scaled_max(got: dict, ref: dict, keep=None) -> float:
    """The largest difference over the tensors of ``ref`` (those whose name
    ``keep`` accepts, where given) over the largest element of any of them
    (the whole gradient's scale)."""
    if got.keys() != ref.keys():
        fail(f"mesh: tensors differ: {sorted(set(got) ^ set(ref))}")
    if not ref:  # a model without BatchNorm: no running statistics
        return 0.0
    scale = max(float(v.float().abs().max()) for v in ref.values())
    return max(float((got[k].float().cpu() - ref[k].float().cpu()).abs()
                     .max()) for k in ref if keep is None or keep(k)) \
        / max(scale, 1e-12)


def _worst(got: dict, ref: dict, keep) -> str:
    """The name of the tensor that ``keep`` accepts with the largest
    difference."""
    return max((k for k in ref if keep(k)), key=lambda k: float(
        (got[k].float().cpu() - ref[k].float().cpu()).abs().max()))


def _own_moves(torch, base, fn, module, name, n_images) -> tuple:
    """The one-process step's (``base``) largest own moves of its gradients
    and running statistics (scale-normalized) under four 1e-6 moves of the
    augmented images: ``fn()`` runs the step again with ``module.name`` (the
    augmentation, whose first ``n_images`` outputs are images) wrapped so
    that its images move."""
    aug = getattr(module, name)
    moves = []
    for i in range(4):
        g = torch.Generator(device="cuda").manual_seed(100 + i)

        def moved(*a, **k):
            out = aug(*a, **k)
            return tuple(t + (1e-6 * torch.randn(
                t.shape, generator=g, device="cuda")).to(t.dtype)
                if j < n_images else t for j, t in enumerate(out))

        setattr(module, name, moved)
        try:
            mv = fn()
        finally:
            setattr(module, name, aug)
        moves.append((_scaled_max(mv["grads"], base["grads"]),
                      _scaled_max(mv["stats"], base["stats"])))
    return max(m[0] for m in moves), max(m[1] for m in moves)


def _check_two_ranks(torch, got, ref, line, dname, moves=None, order=None,
                     held=None, order_rounds_as_ranks=False) -> dict:
    """Two ranks' results ``got`` against the one-process step ``ref``
    (phases 19b-c and 21b, c and e): the loss, every gradient leaf and the
    running statistics after the step at the flat bounds (fp32 1e-5, 1e-4
    of scale, 1e-5; bf16 2e-2, 6e-2, 2e-2), in fp32, where a flat bound is
    passed, ROADMAP rule 5 with ``moves()`` (twice the one-process step's
    own largest move under four 1e-6 moves of its augmented images); both
    ranks with the same gradient and statistics bits. Printed beside them:
    each rank's launches, and where the runs measured them its peak memory,
    warm step and staged collectives, and the confusion matrix's agreement.
    Returns ``line`` with the readings and "ok".

    ``order`` is (one process that sums BatchNorm's statistics in the
    ranks' order, the tokens' cancellation or None); in fp32 the flat
    bounds hold against it too. ``held`` names leaves (bf16
    ``xbd_dahitra``: trans modules 3-4's path, whose dates' tokens nearly
    cancel; in 22d also ``SPACE22_BF16_UNHELD``) that are printed against
    ``ref``, not held (the worst, how many
    within the flat bound); the other leaves are held (the worst printed).
    With ``order_rounds_as_ranks`` and an ``order`` (phases 21c and 22c-d:
    rows split at batch 1, which ``order`` rounds as the ranks do) the loss
    and every leaf are held at the flat bounds against ``order``, and the
    loss against ``ref`` is printed beside ``order``'s own move from it;
    otherwise (phase 19c, the ranks at batch 1 where ``order`` runs 2,
    which cuDNN rounds otherwise in bf16) the loss is held against
    ``ref``."""
    bf16 = dname == "bfloat16"
    l_tol, g_flat, s_flat = ((TOL["bfloat16"], GTOL["bfloat16"],
                              TOL["bfloat16"]) if bf16 else (1e-5, 1e-4, 1e-5))

    def loss_rel(a, b):
        return abs(float(a["loss"][0]) - float(b["loss"][0])) \
            / abs(float(b["loss"][0]))

    keep = None if held is None else (lambda k: not held(k))
    loss_err = max(loss_rel(g, ref) for g in got)
    g_err = max(_scaled_max(g["grads"], ref["grads"], keep) for g in got)
    s_err = max(_scaled_max(g["stats"], ref["stats"]) for g in got)
    g_move = s_move = None
    if moves is not None and not bf16 and (g_err > g_flat or s_err > s_flat):
        g_move, s_move = moves()
    g_tol = g_flat if g_move is None else max(g_flat, 2 * g_move)
    s_tol = s_flat if s_move is None else max(s_flat, 2 * s_move)
    out = {**line, "dtype": dname, "loss": float(ref["loss"][0]),
           "loss_rel_err": loss_err, "loss_tol": l_tol, "grad_err": g_err,
           "grad_tol": g_tol,
           "leaves_held": sum(keep is None or keep(k) for k in ref["grads"]),
           "grad_bound": "flat" if g_tol == g_flat else
           "rule 5: twice the one-process step's own largest move",
           "own_grad_move": g_move, "stats_err": s_err, "stats_tol": s_tol,
           "own_stats_move": s_move,
           "ranks_same_grads": _same_bits(got[0]["grads"], got[1]["grads"]),
           "ranks_same_stats": _same_bits(got[0]["stats"], got[1]["stats"]),
           "launches_per_rank": [g["launches"] for g in got],
           "launches_one_process": ref["launches"]}
    by_order = order is not None and order_rounds_as_ranks
    ok = loss_err <= l_tol or by_order
    if order is not None:
        oref, cancel = order
        if cancel is not None:
            out["token_cancellation"] = cancel
        ro = out["rank_order"] = {
            "loss_rel_err": max(loss_rel(g, oref) for g in got),
            "grad_err": max(_scaled_max(g["grads"], oref["grads"])
                            for g in got),
            "stats_err": max(_scaled_max(g["stats"], oref["stats"])
                             for g in got),
            "one_process_order_move": {
                "loss_rel": loss_rel(oref, ref),
                "grads": _scaled_max(oref["grads"], ref["grads"]),
                "grads_held": _scaled_max(oref["grads"], ref["grads"], keep)}}
        if not bf16 or by_order:
            ok = (ok and ro["loss_rel_err"] <= l_tol
                  and ro["grad_err"] <= g_flat and ro["stats_err"] <= s_flat)
        out["loss_held"] = ("against one process in the ranks' BN order"
                            if by_order else "against one process")
    if held is not None:
        scale = max(float(v.float().abs().max())
                    for v in ref["grads"].values())

        def leaf_err(k):
            return max(float((g["grads"][k].float().cpu()
                              - ref["grads"][k].float().cpu()).abs().max())
                       for g in got) / scale

        out["held_worst_leaf"] = _worst(got[0]["grads"], ref["grads"], keep)
        out["held_outside_flat"] = sorted(
            k for k in ref["grads"] if keep(k) and leaf_err(k) > g_flat)
        out["unheld_leaves"] = sum(held(k) for k in ref["grads"])
        out["unheld_grad_err"] = max(_scaled_max(g["grads"], ref["grads"],
                                                 held) for g in got)
        out["unheld_worst_leaf"] = _worst(got[0]["grads"], ref["grads"],
                                          held)
        out["unheld_within_flat"] = sum(held(k) and leaf_err(k) <= g_flat
                                        for k in ref["grads"])
        out["unheld_outside_flat"] = sorted(
            k for k in ref["grads"] if held(k) and leaf_err(k) > g_flat)
    if "peak_bytes" in ref:
        out.update({"peak_gib_per_rank": [g["peak_bytes"] / 2 ** 30
                                          for g in got],
                    "peak_gib_one_process": ref["peak_bytes"] / 2 ** 30})
    if "step_s" in ref:
        out.update({"warm_step_samples": ref["step_samples"],
                    "warm_step_s_per_rank": [g["step_s"] for g in got],
                    "warm_step_s_one_process": ref["step_s"],
                    "warm_peak_gib_per_rank": [g["warm_peak_bytes"] / 2 ** 30
                                               for g in got],
                    "warm_peak_gib_one_process":
                        ref["warm_peak_bytes"] / 2 ** 30,
                    "staged_per_step_per_rank": [g["staged_per_step"]
                                                 for g in got]})
    if "cm" in ref and not bf16:
        out["same_confusion_matrix"] = all(
            torch.equal(g["cm"].cpu(), ref["cm"].cpu()) for g in got)
        out["confusion_matrix_flips"] = max(int(
            (g["cm"].cpu() - ref["cm"].cpu()).abs().sum()) // 2 for g in got)
    same = out["ranks_same_grads"] and out["ranks_same_stats"]
    out["ok"] = bool(ok and g_err <= g_tol and s_err <= s_tol and same)
    return out


def run_mesh_phase(torch, tmp, train_root, cm5) -> dict:
    """Phase 19 (``core/mesh.py``). (a) ``CDTrainer`` of ``newUNetTrans`` at
    256 px, batch 8, in ``DistributedDataParallel`` under NCCL at world size
    1 (``launch`` in this process) against the plain trainer, cuDNN
    deterministic: 2 steps with the same loss, gradient and statistics bits;
    the warm step of both, timed in turns. (b-d) Two gloo ranks on cuda:0
    (spawned, CUDA tensors staged through host memory for gloo's
    collectives) against one process on the joined batch, cuDNN
    deterministic on both sides (``_check_two_ranks``): (b) one step of
    ``newUNetTrans``, joined batch 8 (4 a rank), fp32 and bf16; (c) one
    ``--task damage`` step of ``xbd_dahitra`` at 256 px, joined batch 2,
    also against one process that sums BatchNorm's statistics in the ranks'
    order; both ranks with the same statistics bits and each rank's
    K1-save, K2 and K3 launches those of one step of phases 7 and 15; (d)
    ``CDEvaluator`` of phase 4's checkpoint over 5 patches at batch 4,
    padded (each rank 2 rows, then 1 and a filler): the confusion matrix
    exactly one process's, both at the ranks' per-forward batch of 2 and at
    the joined batch of 4.
    (e) ``main_cd``, ``xbd_train`` (one epoch each on phase 7's splits and
    phase 15's tiles) and ``eval_cd`` (phase 4's patches) with ``--gpu_ids
    0``: no process group, and the same confusion matrices, losses and
    scores, bit for bit (cuDNN deterministic), as the same runs through the
    CLIs' bodies with no launcher; ``eval_cd``'s matrix phase 5's where it
    ran."""
    import shutil

    import torch.distributed as dist

    from dahitra_tpu_torch.core import mesh as mesh_mod
    from dahitra_tpu_torch.data.levir import load_levir_split
    from dahitra_tpu_torch.tools import mesh_checks
    from dahitra_tpu_torch.train import engine, xbd_engine

    t_phase = time.time()
    by_phase = {"float32": {}, "bfloat16": {}}
    lev = load_levir_split(os.path.join(train_root, "data", "LEVIR_CD"),
                           "train", IMG)
    arrays = {"a": lev.a, "b": lev.b, "label": lev.label}
    rng = np.random.default_rng(19)
    s = MESH_XBD_IMG
    # the post tiles with a painted change: the dates' tokens must differ
    xarrays = {"img_pre": rng.integers(0, 255, (2, s, s, 3), dtype=np.uint8),
               "img_post": paint_change(rng.integers(0, 255, (2, s, s, 3),
                                                     dtype=np.uint8)),
               "msk": rng.integers(0, 2, (2, s, s, 5)).astype(np.uint8),
               "lbl_msk": rng.integers(0, 4, (2, s, s)).astype(np.uint8)}

    # (a) NCCL at world size 1 against the plain trainer
    cfgs = {tag: _mesh_cfg(tmp, f"a_{tag}", "newUNetTrans", IMG, BATCH,
                           "float32") for tag in ("plain", "ddp")}
    both = mesh_mod.launch(_ddp_world1, (cfgs, arrays), devices=["cuda:0"],
                           backend="nccl", timeout=300)[0]
    plain, ddp = both["plain"], both["ddp"]
    same = {k: _same_bits(ddp[k], plain[k]) if isinstance(plain[k], dict)
            else bool(torch.equal(ddp[k], plain[k]))
            for k in ("loss", "grads", "stats")}
    out_a = {"mesh": "a_nccl_world1", "ddp": ddp["ddp"], "same_bits": same,
             "loss": plain["loss"].tolist(),
             "step_ms_plain": plain["step_ms"], "step_ms_ddp": ddp["step_ms"],
             "ddp_overhead_ms": ddp["step_ms"] - plain["step_ms"]}
    print(json.dumps(out_a), flush=True)
    if not (ddp["ddp"] and all(same.values())):
        fail(f"mesh (a): DDP at world size 1 differs from the plain step: "
             f"{same}")

    # (b-d) one-process references in this process, then one launch of two
    # gloo ranks on cuda:0 for every case; cuDNN deterministic on both sides
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cases, refs = [], []
        for dname in ("float32", "bfloat16"):
            cfg = _mesh_cfg(tmp, f"b_{dname}", "newUNetTrans", IMG, BATCH,
                            dname)
            xcfg = _mesh_cfg(tmp, f"c_{dname}", "xbd_dahitra", s, 2, dname,
                             val_batch_size=2)
            for kind, c, arr, fn, mod, aug, n_img in (
                    ("b", cfg, arrays, mesh_checks.cd_steps, engine,
                     "augment_pairs", 2),
                    ("c", xcfg, xarrays, mesh_checks.xbd_steps, xbd_engine,
                     "augment_xbd", 1)):
                step = (lambda fn=fn, c=c, arr=arr: fn(None, c, arr, 1))
                cases.append((fn.__name__, (c, arr, 1)))
                # c: also one process summing BatchNorm's statistics in the
                # ranks' order, and in bf16 the tokens' cancellation
                order = None if kind == "b" else (
                    mesh_checks.xbd_steps(None, c, arr, 1, sums_of=2),
                    mesh_checks.token_cancellation(c, arr)
                    if dname == "bfloat16" else None)
                refs.append((kind, dname, c["net_G"], step(), order, step,
                             mod, aug, n_img))
        ev_dir = os.path.join(tmp, "mesh", "d")
        os.makedirs(ev_dir, exist_ok=True)
        shutil.copy(os.path.join(tmp, "ckpt", "smoke", "best_ckpt.pt"),
                    ev_dir)
        ecfg = dict(n_class=2, checkpoint_dir=ev_dir, net_G="newUNetTrans",
                    img_size=IMG, batch_size=MESH_EVAL_BATCH, device="cuda:0")
        tiles = os.path.join(tmp, "data", "LEVIR_CD")
        parts = [load_levir_split(tiles, "test", IMG, patch=p)
                 for p in (0, 1)]
        patches = {k: np.concatenate([getattr(p, k) for p in parts])[
            :MESH_EVAL_PATCHES] for k in ("a", "b", "label")}
        ev_one = {b: mesh_checks.cd_eval(None, {**ecfg, "batch_size": b},
                                         patches)
                  for b in (2, MESH_EVAL_BATCH)}
        cases.append(("cd_eval", (ecfg, patches)))
        t0 = time.time()
        ranks = mesh_mod.launch(mesh_checks.run_cases, (cases, True),
                                devices=["cuda:0", "cuda:0"],
                                backend="gloo", timeout=600)
        launch_s = time.time() - t0
        print(json.dumps({"mesh": "two_gloo_ranks_launch",
                          "launch_s": launch_s, "cases": len(cases)}),
              flush=True)
        for i, (kind, dname, net_g, ref, order, step, mod, aug,
                n_img) in enumerate(refs):
            got = [r[i] for r in ranks]
            line = _check_two_ranks(
                torch, got, ref,
                {"mesh": f"{kind}_two_gloo_ranks", "net_G": net_g,
                 "joined_batch": BATCH if kind == "b" else 2}, dname,
                lambda: _own_moves(torch, ref, step, mod, aug, n_img), order,
                _trans34_path if dname == "bfloat16" and kind == "c"
                else None)
            print(json.dumps(line), flush=True)
            dec, k3 = MESH_CALLS[net_g]
            want = {**NO_PAD, "k1": 0, "k1_save": dec, "k2": dec, "k3": k3,
                    "k4": 0}
            if got[0]["launches"] == got[1]["launches"]:
                by_phase[dname][f"mesh_{kind}"] = got[0]["launches"]
            if not (line["ok"] and all(g["launches"] == want for g in got)):
                fail(f"mesh ({kind}) {net_g} {dname}: {line}")
    finally:
        torch.backends.cudnn.deterministic = det
    ev = [r[-2] for r in ranks]
    cm = ev[0]["cm"].numpy()
    out_d = {"mesh": "d_padded_eval", "patches": MESH_EVAL_PATCHES,
             "batch": MESH_EVAL_BATCH, "cm": cm.tolist(),
             "equal_one_process_batch2": bool(np.array_equal(
                 cm, ev_one[2]["cm"].numpy())),
             "equal_one_process_batch4": bool(np.array_equal(
                 cm, ev_one[MESH_EVAL_BATCH]["cm"].numpy())),
             "ranks_agree": bool(np.array_equal(cm, ev[1]["cm"].numpy())),
             "pairs_counted": ev[0]["scores"]["imps"] > 0,
             "launches_per_rank": [e["launches"] for e in ev],
             "collectives_staged_through_host_per_rank": [
                 r[-1] for r in ranks],
             "launch_s": launch_s}
    print(json.dumps(out_d), flush=True)
    want = {**NO_PAD, "k1": 6 * 2, "k1_save": 0, "k2": 0, "k3": 3 * 2,
            "k4": 0}
    if not (out_d["equal_one_process_batch2"]
            and out_d["equal_one_process_batch4"] and out_d["ranks_agree"]
            and all(e["launches"] == want for e in ev)):
        fail(f"mesh (d): padded evaluation: {out_d}")

    # (e) the CLIs with --gpu_ids 0: no group, the same results
    from dahitra_tpu_torch.cli import eval_cd, main_cd, xbd_train

    groups = mesh_mod.GROUPS_STARTED
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    os.environ["DAHITRA_DATA_ROOT"] = os.path.join(train_root, "data")
    out_e = {"mesh": "e_cli_gpu_ids_0"}
    try:
        def levir(project, *extra):
            return main_cd.build_parser().parse_args([
                "--checkpoint_root", os.path.join(tmp, "mesh", "e"),
                "--project_name", project, "--img_size", str(IMG),
                "--batch_size", str(BATCH), "--max_epochs", "1",
                "--skip_test", "--device", "cuda", *extra])

        cli = main_cd.main(["--checkpoint_root",
                            os.path.join(tmp, "mesh", "e"), "--project_name",
                            "main_cd_cli", "--img_size", str(IMG),
                            "--batch_size", str(BATCH), "--max_epochs", "1",
                            "--skip_test", "--device", "cuda",
                            "--gpu_ids", "0"])
        args = levir("main_cd_direct")
        args.checkpoint_dir = os.path.join(args.checkpoint_root,
                                           args.project_name)
        direct = main_cd.train(args)
        vals = [np.load(os.path.join(tmp, "mesh", "e", p, "val_acc.npy"))
                for p in ("main_cd_cli", "main_cd_direct")]
        strip = [{k: v for k, v in h.items() if k != "imps"}
                 for h in (cli[0], direct[0])]
        out_e["main_cd_same"] = strip[0] == strip[1] and bool(
            np.array_equal(*vals))
        out_e["main_cd_epoch0"] = strip[0]

        xroot = os.path.join(tmp, "xbd", "train")
        xargv = ["--data_root", xroot, "--task", "damage", "--net_G",
                 "xbd_dahitra", "--img_size", str(XBD_IMG), "--batch_size",
                 "1", "--max_epochs", "1", "--eval_every", "1",
                 "--checkpoint_root", os.path.join(tmp, "mesh", "e"),
                 "--device", "cuda"]
        xcli = xbd_train.main(xargv + ["--project_name", "xbd_cli",
                                       "--gpu_ids", "0"])
        xargs = xbd_train.build_parser().parse_args(
            xargv + ["--project_name", "xbd_direct"])
        xargs.checkpoint_dir = os.path.join(xargs.checkpoint_root,
                                            xargs.project_name)
        xargs.device = "cuda:0"
        os.makedirs(xargs.checkpoint_dir, exist_ok=True)
        xdirect = xbd_train._run(None, xargs)
        xs = [{k: v for k, v in h[0].items() if k != "imps"}
              for h in (xcli, xdirect)]
        out_e["xbd_train_same"] = xs[0] == xs[1]
        out_e["xbd_train_epoch0"] = xs[0]

        os.environ["DAHITRA_DATA_ROOT"] = os.path.join(tmp, "data")
        eargv = ["--checkpoint_root", os.path.join(tmp, "ckpt"),
                 "--project_name", "smoke", "--split", "test", "--img_size",
                 str(IMG), "--batch_size", str(BATCH), "--device", "cuda"]
        eval_cd.main(eargv + ["--gpu_ids", "0"])
        ecm = EVAL_CMS[-1]
        out_e["eval_cd_cm"] = ecm.tolist()
        if cm5 is not None:
            out_e["eval_cd_same_as_phase5"] = bool(np.array_equal(ecm, cm5))
    finally:
        torch.backends.cudnn.deterministic = det
    out_e["process_groups_started"] = mesh_mod.GROUPS_STARTED - groups
    out_e["group_initialized"] = dist.is_initialized()
    out_e["phase_s"] = time.time() - t_phase
    print(json.dumps(out_e), flush=True)
    if not (out_e["main_cd_same"] and out_e["xbd_train_same"]
            and out_e.get("eval_cd_same_as_phase5", True)
            and out_e["process_groups_started"] == 0
            and not out_e["group_initialized"]):
        fail(f"mesh (e): --gpu_ids 0 differs from the direct run: {out_e}")
    return by_phase


# Phase 21: the space axis (nn/space.py) on the one card: two gloo ranks of
# one data row, each holding half the rows, against one process.
# Warm steps timed after each step case of phases 21-22: one sample each,
# so that phases 1-22 keep headroom inside the 1200 s a smoke run may take.
SPACE_TIMED = 1
# Phase 22's bf16 BIT logits, held from one process's bf16 and fp32 logits:
# fixed bounds, 1.25 times one process's own bf16 distance from its fp32
# logits on an H100 80GB HBM3 at 700 W (5.9e-2 / 5.7e-2 / 4.3e-2), rounded
# down, where the ranks read 6.4e-2 / 5.6e-2 / 4.8e-2 and one process moves
# 5.5e-2 / 4.9e-2 / 3.9e-2 when it halves its batch: BIT's |f1 - f2| head
# cancels, and no two bf16 paths meet the flat 2e-2 there.
SPACE22_BIT_BF16_TOL = {"a_bit_eval": 7.3e-2, "b_bit_t8_eval": 7.0e-2,
                        "d_bit_pallas_eval": 5.3e-2}
# Tokenizer inputs a forward sends at (a)-(b) (256 px, batch 8: both dates
# batch-stacked) and (c) (1024 px, batch 1), as (name, B, H, W) feature maps
SPACE_K3 = [(f"r{img}/s{s}", 2 * b, img // s, img // s)
            for img, b in ((IMG, BATCH), (XBD_IMG, 1)) for s in (4, 8, 16)]
# Phase 21f-h, uneven rows: sizes at which a rank's rows stop splitting
# above a model's last stride, so the coarse levels run whole on both
# ranks. ``newUNetTrans`` at 240 px, batch 8: 1/4 and 1/8 on the rank's
# rows (30 and 15), 1/16 whole (15 rows, the last max-pool meets 15 rows a
# rank); the ``xbd_res34_double`` damage step at 224 px, batch 2: 1/32
# whole (7 rows); ``base_resnet18`` and BIT ``_dd8`` eval at 232 px: 1/8
# whole (layer 2 meets 29 rows a rank at 1/4).
UNEVEN_IMG, UNEVEN_R34_IMG, UNEVEN_FWD_IMG = 240, 224, 232
# The kernels at 21f's shapes a rank (two ranks): the decoder calls (name,
# batch, pixels N, depth, heads; N a rank's at 1/4 and 1/8, the whole
# level's at 1/16), the rank-split K3's (name, B, H, W: the whole map) and
# the one-process K3's on the whole 1/16 level (name, B, N).
UNEVEN_K1_SHAPES = [
    (f"u{UNEVEN_IMG}/{r}/{what}", b, n, depth, heads)
    for r, n, depth, heads in (("s4", (UNEVEN_IMG // 4) ** 2 // 2, 8, 8),
                               ("s8", (UNEVEN_IMG // 8) ** 2 // 2, 4, 4),
                               ("s16", (UNEVEN_IMG // 16) ** 2, 4, 4))
    for what, b in (("dates", 2 * BATCH), ("diff", BATCH))]
UNEVEN_K3_RANKS = [(f"u{UNEVEN_IMG}/s{s}", 2 * BATCH, UNEVEN_IMG // s,
                    UNEVEN_IMG // s) for s in (4, 8)]
UNEVEN_K3 = [(f"u{UNEVEN_IMG}/s16", 2 * BATCH, (UNEVEN_IMG // 16) ** 2)]


def space_arrays(n: int, img: int, seed: int, xbd: bool = False) -> dict:
    """Seeded uint8 pairs: 16-pixel blocks of colour, the post image with a
    building painted into its middle quarter (``paint_change``, the change
    label)."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, 256, (n, img // 16, img // 16, 3), dtype=np.uint8)
    pre = np.repeat(np.repeat(pre, 16, 1), 16, 2)
    post = paint_change(pre)
    label = np.zeros((n, img, img), np.uint8)
    q = img // 4
    label[:, q:3 * q, q:3 * q] = 1
    if not xbd:
        return {"a": pre, "b": post, "label": label}
    msk = np.zeros((n, img, img, 5), np.uint8)
    msk[..., 0] = msk[..., 2] = label
    return {"img_pre": pre, "img_post": post, "msk": msk, "lbl_msk": label}


def paint_change(post: np.ndarray) -> np.ndarray:
    """``post`` with a building painted into its middle quarter, so that
    the two dates' tokens differ there (ROADMAP §3, the bf16 xbd_dahitra
    cancellation)."""
    post = post.copy()
    q = post.shape[1] // 4
    post[:, q:3 * q, q:3 * q] = (200, 60, 30)
    return post


def check_k3_ranks(torch, dtype, gen, shapes=None) -> list:
    """The rank-split K3 at ``shapes`` (phase 21's, ``SPACE_K3``, by
    default), two ranks
    simulated in one process: per rank the statistics and pool launches on
    its half of the pixels; the gathered statistics are the two ranks'
    joined. Held against ``semantic_tokenizer_ranks_plain`` (and the ranks'
    M and S bit for bit); ``ms`` (back to back), ``device_ms`` (behind
    queued work) and ``plain_ms`` are one rank's two launches and its plain
    steps, ``library_ms`` one scaled_dot_product_attention call on the
    rank's pixels; the bound is one rank's bytes and operations."""
    import torch.nn.functional as F

    from dahitra_tpu_torch.kernels import fused_tokenizer as ft

    dname = str(dtype).split(".")[-1]
    rows = []
    for name, b, h, w in shapes or SPACE_K3:
        n = h * w // 2
        x = torch.randn(b, 2 * n, DIM, generator=gen).cuda().to(dtype)
        wk = (torch.randn(DIM, TOKENS, generator=gen) * DIM ** -0.5
              ).cuda().to(dtype)
        parts = [p.contiguous() for p in x.split(n, 1)]
        chunk = ft._chunk(b, n, ft._n_sm(0))
        scratch = [ft._scratch(b, n, TOKENS, chunk, x.device) for _ in parts]
        stats = torch.cat([ft.ranks_stats(p, wk, chunk, s)
                           for p, s in zip(parts, scratch)], 1)
        pooled = [ft.ranks_pool(p, wk, stats, chunk, s)
                  for p, s in zip(parts, scratch)]
        got = ft.sum_in_order([p for p, _ in pooled]).to(dtype)
        ref = ft.semantic_tokenizer_ranks_plain(parts, wk, chunk)
        torch.cuda.synchronize()
        err, serr = scaled_err(got, ref)
        if not (torch.isfinite(got.float()).all() and serr <= TOL[dname]
                and torch.equal(pooled[0][1], pooled[1][1])):
            fail(f"K3 ranks {name} {dname}: scaled error {serr:.3e} > "
                 f"{TOL[dname]}, or the ranks' M and S differ")
        x0, s0 = parts[0], scratch[0]
        # both ranks' statistics, gathered once outside the timed calls
        plain_stats = torch.cat([ft.chunk_stats_plain(p, wk, chunk)
                                 for p in parts], 1)

        def rank_launches():
            ft.ranks_stats(x0, wk, chunk, s0)
            ft.ranks_pool(x0, wk, stats, chunk, s0)

        def rank_plain():
            ft.chunk_stats_plain(x0, wk, chunk)
            m, s = ft.combine_stats_plain(plain_stats)
            ft.pool_plain(x0, wk, m, s, chunk)

        q = wk.t().unsqueeze(0).expand(b, TOKENS, DIM)
        itemsize = torch.finfo(dtype).bits // 8
        nbytes = (b * n * DIM + DIM * TOKENS) * itemsize + b * TOKENS * DIM * 4
        ops = b * n * (4 * DIM * TOKENS + 5 * TOKENS)
        bms, by = bound(nbytes, ops, dname)
        rows.append({
            "shape": name, "B": b, "N_rank": n, "ranks": 2, "L": TOKENS,
            "max_abs_err": err, "scaled_err": serr,
            "ms": time_ms(rank_launches, torch, **_reps(n)),
            "device_ms": time_ms(rank_launches, torch, queued=True,
                                 **_reps(n)),
            "plain_ms": time_ms(rank_plain, torch, **PLAIN_REPS),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, x0, x0, scale=1.0), torch, **_reps(n))})
    return rows


def run_space_phase(torch, tmp) -> tuple:
    """Phase 21 (``nn/space.py``), cuDNN deterministic on both sides. One
    launch of two gloo ranks on cuda:0 (n_data 1, n_space 2; every halo,
    gather and all-reduce staged through host memory) against one process
    on the same card, weights and data: (a) the ``newUNetTrans`` eval
    forward at 256 px, batch 8, fp32 and bf16 (the gathered logits at 1e-5
    and 2e-2, beside one process's own move when it runs the batch in two
    halves; each rank's launches: the rank-split K3 3, the one-process K3
    0, K1 6); (b) its row-sharded ``CDTrainer.train_step`` on seeded pairs
    with a painted change, both dtypes (``_check_two_ranks``: loss, every
    gradient leaf, updated BN statistics; the rank-split K3 3, K1-save 6,
    K2 6 a rank) and ``SPACE_TIMED`` warm steps on the host
    clock; (c) ``xbd_dahitra``'s ``--task damage`` step at 1024 px, batch 1,
    both dtypes; (d) the rank-split K3 in the ranks at every tokenizer
    shape (a)-(c) send, fp32 and bf16: the same tokens bit for bit on both
    ranks, tokens against the plain tokenizer of all the pixels and the
    gradients against the one-process ``SemanticTokenizerFn`` on the card;
    (e) the replicated grid (``spatial=False``), one ``newUNetTrans`` step
    against one process. Uneven rows, in the same launch (``UNEVEN_*``):
    (f) ``newUNetTrans`` at 240 px, batch 8, the eval forward and the
    ``CDTrainer`` step, fp32 and bf16 (1/16 whole: each rank's launches the
    one-process K3 1 and the rank-split K3 2, K1 6 or K1-save 6 and K2 6);
    (g) ``xbd_res34_double``'s damage step at 224 px, batch 2, both dtypes
    (1/32 whole); (h) the ``base_resnet18`` and BIT ``_dd8`` eval forwards
    at 232 px, fp32 (1/8 whole; BIT's rank-split K3 2, K1 2), held as (a)
    and (b); then K3 (one-process and rank-split), K1, K1-save and K2 at
    (f)'s shapes a rank against their plain versions, timed. Returns (the
    launches per dtype and run, the K3 rank-split rows per dtype, the
    kernel rows at (f)'s shapes by (kernel, dtype) for the kernels
    line)."""
    from dahitra_tpu_torch.core import mesh as mesh_mod
    from dahitra_tpu_torch.kernels import fused_tokenizer as ft
    from dahitra_tpu_torch.models.registry import define_g as _define_g
    from dahitra_tpu_torch.tools import mesh_checks
    from dahitra_tpu_torch.tools import space_checks as sc
    from dahitra_tpu_torch.train import engine, xbd_engine

    t_phase = time.time()
    by_phase = {"float32": {}, "bfloat16": {}}
    model = _define_g("newUNetTrans", img_size=IMG)
    model.init_weights(torch.Generator().manual_seed(21))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    rng = np.random.default_rng(21)
    fwd_in = {k: rng.uniform(-1, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)
              for k in ("a", "b")}
    cd_arrays = space_arrays(BATCH, IMG, 21)
    xbd_arrays = space_arrays(1, XBD_IMG, 22, xbd=True)
    k3 = [(b, h, w, TOKENS, 30 + i, d)
          for d in ("float32", "bfloat16")
          for i, (_, b, h, w) in enumerate(SPACE_K3)]
    u_in = {k: rng.uniform(-1, 1, (BATCH, UNEVEN_IMG, UNEVEN_IMG, 3)
                           ).astype(np.float32) for k in ("a", "b")}
    u_fwd_in = {k: rng.uniform(-1, 1, (2, UNEVEN_FWD_IMG, UNEVEN_FWD_IMG, 3)
                               ).astype(np.float32) for k in ("a", "b")}
    u_arrays = space_arrays(BATCH, UNEVEN_IMG, 23)
    r34_arrays = space_arrays(2, UNEVEN_R34_IMG, 24, xbd=True)

    def cfg(tag, net_g, img, batch, dname, **kw):
        return _mesh_cfg(tmp, f"space_{tag}_{dname}", net_g, img, batch,
                         dname, **kw)

    cases, refs = [], []
    for dname in ("float32", "bfloat16"):
        cases.append(("forward_rows", ("newUNetTrans", IMG, sd, fwd_in, dname,
                                       False, None, True, "cuda:0")))
        c = cfg("b", "newUNetTrans", IMG, BATCH, dname)
        cases.append(("trainer_steps", ("cd", c, cd_arrays, True,
                                        SPACE_TIMED)))
        x = cfg("c", "xbd_dahitra", XBD_IMG, 1, dname, val_batch_size=1)
        cases.append(("trainer_steps", ("xbd", x, xbd_arrays, True,
                                        SPACE_TIMED)))
    cases.append(("k3_ranks", (k3, "cuda:0")))
    e_cfg = cfg("e", "newUNetTrans", IMG, BATCH, "float32")
    cases.append(("trainer_steps", ("cd", e_cfg, cd_arrays, False, 0)))
    # (f)-(h), uneven rows: (tag, case); the weights drawn on each rank
    # from a seed (``space_checks.seeded_weights``)
    n_main = len(cases)
    uneven = []
    for dname in ("float32", "bfloat16"):
        uneven.append(("f_uneven_eval_240", ("forward_rows", (
            "newUNetTrans", UNEVEN_IMG, 211, u_in, dname, False, None, True,
            "cuda:0"))))
        uneven.append(("f_uneven_step_240", ("trainer_steps", (
            "cd", cfg("f", "newUNetTrans", UNEVEN_IMG, BATCH, dname),
            u_arrays, True, 0))))
        uneven.append(("g_uneven_r34_224", ("trainer_steps", (
            "xbd", cfg("g", "xbd_res34_double", UNEVEN_R34_IMG, 2, dname,
                       val_batch_size=2), r34_arrays, True, 0))))
    for i, key in enumerate(("base_resnet18", BIT_KEY)):
        uneven.append((f"h_uneven_eval_{UNEVEN_FWD_IMG}", ("forward_rows", (
            key, UNEVEN_FWD_IMG, 212 + i, u_fwd_in, "float32", False, None,
            True, "cuda:0"))))
    cases += [c for _, c in uneven]
    for c in cases:
        if isinstance(c[1][1], dict) and "checkpoint_dir" in c[1][1]:
            os.makedirs(c[1][1]["checkpoint_dir"], exist_ok=True)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.time()
        ranks = mesh_mod.launch(sc.run_cases, (cases, True),
                                devices=["cuda:0", "cuda:0"], backend="gloo",
                                timeout=600, n_space=2)
        launch_s = time.time() - t0
        # one-process references, the same functions with no mesh
        for j, (name, args) in enumerate(cases):
            if j >= n_main:
                refs.append(getattr(sc, name)(None, *args))
                _free(torch)
                continue
            if name == "k3_ranks":
                refs.append(None)
                continue
            if name == "forward_rows":
                refs.append(sc.forward_rows(None, *args))
                # one process on the batch in two halves: how far other
                # shapes (cuDNN's choices) move the logits, no rows split
                halves = [sc.forward_rows(None, *args[:3], {
                    k: v[h] for k, v in args[3].items()}, *args[4:])["logits"]
                    for h in (slice(0, BATCH // 2), slice(BATCH // 2, None))]
                refs[-1]["batch_split_move"] = scaled_err(
                    torch.cat(halves), refs[-1]["logits"])[1]
            else:
                refs.append(sc.trainer_steps(None, *args))
                if args[0] == "xbd" and args[1].get("bf16"):
                    # one process summing BatchNorm's statistics in the
                    # ranks' order, and the tokens' cancellation
                    with mesh_checks.rank_sums(2):
                        order = sc.trainer_steps(None, *args[:4])
                    refs[-1]["order"] = (order, mesh_checks.token_cancellation(
                        args[1], args[2]))
            _free(torch)
    finally:
        torch.backends.cudnn.deterministic = det
    print(json.dumps({"space": "two_gloo_ranks_launch", "launch_s": launch_s,
                      "cases": len(cases), "staged_per_rank": [
                          r[-1] for r in ranks]}), flush=True)
    ok = True
    dec, k3n = MESH_CALLS["newUNetTrans"]
    xdec, xk3 = MESH_CALLS["xbd_dahitra"]
    for i, (name, args) in enumerate(cases[:n_main]):
        got = [r[i] for r in ranks]
        ref = refs[i]
        if name == "forward_rows":
            dname = args[4]
            errs = [scaled_err(g["whole"], ref["logits"].cpu())[1]
                    for g in got]
            tol = 1e-5 if dname == "float32" else TOL[dname]
            want = {**NO_PAD, "k1": dec, "k1_save": 0, "k2": 0, "k3": 0,
                    "k3_ranks": k3n, "k4": 0}
            line = {"space": "a_eval_forward", "dtype": dname,
                    "logits_scaled_err": max(errs), "tol": tol,
                    "one_process_batch_split_move": ref["batch_split_move"],
                    "rows_per_rank": [int(g["logits"].shape[1]) for g in got],
                    "launches_per_rank": [g["launches"] for g in got],
                    "launches_one_process": ref["launches"],
                    "peak_gib_per_rank": [g["peak_bytes"] / 2 ** 30
                                          for g in got],
                    "peak_gib_one_process": ref["peak_bytes"] / 2 ** 30}
            line["ok"] = bool(max(errs) <= tol and all(
                g["launches"] == want for g in got) and all(
                    r == IMG // 2 for r in line["rows_per_rank"]))
            by_phase[dname]["space_eval_256"] = got[0]["launches"]
        elif name == "k3_ranks":
            line = _space_k3_line(torch, ft, sc, args[0], got)
        else:
            kind, c, arrays, spatial = args[:4]
            dname = "bfloat16" if c.get("bf16") else "float32"
            tag = ("e_replicated" if not spatial else
                   "b_train_step" if kind == "cd" else "c_xbd_damage_1024")

            def moves(kind=kind, args=args, ref=ref):
                mod, aug, n_img = ((engine, "augment_pairs", 2)
                                   if kind == "cd" else
                                   (xbd_engine, "augment_xbd", 1))
                return _own_moves(torch, ref, lambda: sc.trainer_steps(
                    None, *args[:4], 0), mod, aug, n_img)

            bf16_xbd = kind == "xbd" and dname == "bfloat16"
            line = _check_two_ranks(
                torch, got, ref, {"space": tag}, dname, moves,
                ref.get("order"), _trans34_path if bf16_xbd else None,
                order_rounds_as_ranks=True)
            n_dec, n_k3 = (dec, k3n) if kind == "cd" else (xdec, xk3)
            # the row-sharded runs split K3 over the ranks; the replicated
            # one runs the one-process K3
            want = {**NO_PAD, "k1": 0, "k1_save": n_dec, "k2": n_dec,
                    "k3": 0 if spatial else n_k3,
                    "k3_ranks": n_k3 if spatial else 0, "k4": 0}
            line["ok"] = line["ok"] and line.get(
                "same_confusion_matrix", True) and all(
                    g["launches"] == want for g in got)
            key = {"b_train_step": "space_train_256",
                   "c_xbd_damage_1024": "space_xbd_1024",
                   "e_replicated": "grid_replicated_256"}[tag]
            by_phase[dname][key] = got[0]["launches"]
        print(json.dumps(line), flush=True)
        ok = ok and line["ok"]
    for j, (tag, (name, args)) in enumerate(uneven, n_main):
        line = _uneven_line(torch, tag, name, args, [r[j] for r in ranks],
                            refs[j], engine, xbd_engine, sc)
        dname = args[4] if name == "forward_rows" else (
            "bfloat16" if args[1].get("bf16") else "float32")
        key = "space_" + tag.split("_", 1)[1] + (
            "_" + args[0] if tag.startswith("h_") else "")
        by_phase[dname][key] = [r[j] for r in ranks][0]["launches"]
        print(json.dumps(line), flush=True)
        ok = ok and line["ok"]
    k3_rows, u_rows = {}, {}
    gen = torch.Generator().manual_seed(21)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        k3_rows[dname] = check_k3_ranks(torch, dtype, gen)
        for r in k3_rows[dname]:
            print(json.dumps({"check": f"k3_ranks[{dname}]", **r}), flush=True)
        u_rows[("k3_ranks", dname)] = check_k3_ranks(torch, dtype, gen,
                                                     UNEVEN_K3_RANKS)
        u_rows[("k3", dname)] = check_k3(torch, dtype, gen, UNEVEN_K3)
        u_rows[("k1", dname)] = check_k1(torch, dtype, gen, UNEVEN_K1_SHAPES)
        u_rows[("k1_save", dname)], u_rows[("k2", dname)] = \
            check_k1_save_k2(torch, dtype, gen, UNEVEN_K1_SHAPES)
        for kid in ("k3", "k3_ranks", "k1", "k1_save", "k2"):
            for r in u_rows[(kid, dname)]:
                print(json.dumps({"check": f"{kid}_uneven[{dname}]", **r}),
                      flush=True)
    print(json.dumps({"space": "phase_s", "seconds": time.time() - t_phase}),
          flush=True)
    if not ok:
        fail("space (phase 21): a row-sharded run differs from one process "
             "(the lines above)")
    return by_phase, k3_rows, u_rows


# A rank's launches in phase 21f-h, by kernel: the one-process K3 and the
# rank-split K3 apart, then the decoder stack's.
UNEVEN_COUNTERS = (("k3_one_process", "k3"), ("k3_rank_split", "k3_ranks"),
                   ("k1", "k1"), ("k1_save", "k1_save"), ("k2", "k2"))


def _uneven_line(torch, tag, name, args, got, ref, engine, xbd_engine,
                 sc) -> dict:
    """Phase 21f-h: two ranks at uneven rows against one process. A forward
    (f, h): the gathered logits (fp32 1e-5, bf16 2e-2), each rank its rows,
    each decoder's gate as one process's; a step (f, g): ``_check_two_ranks``
    (rule 5 in fp32). Each rank's launches as ``UNEVEN_COUNTERS`` reads
    them, against what the levels send: ``newUNetTrans`` at 240 px the
    one-process K3 1 (1/16 whole) and the rank-split K3 2 a forward, K1 6
    (eval) or K1-save 6 and K2 6 (step); BIT ``_dd8`` at 232 px the
    rank-split K3 2 and K1 2; the ResNets none."""
    net_g = args[0] if name == "forward_rows" else args[1]["net_G"]
    counts = {"newUNetTrans": (1, 2, 6), BIT_KEY: (0, 2, 2)}.get(
        net_g, (0, 0, 0))
    train = name == "trainer_steps"
    want = {**NO_PAD, "k3": counts[0], "k3_ranks": counts[1],
            "k1": 0 if train else counts[2],
            "k1_save": counts[2] if train else 0,
            "k2": counts[2] if train else 0, "k4": 0}
    per_rank = [{k: g["launches"][c] for k, c in UNEVEN_COUNTERS}
                for g in got]
    if not train:
        dname = args[4]
        errs = [scaled_err(g["whole"], ref["logits"].cpu())[1] for g in got]
        tol = 1e-5 if dname == "float32" else TOL[dname]
        line = {"space": tag, "net_G": net_g, "img": args[1], "dtype": dname,
                "logits_scaled_err": max(errs), "tol": tol,
                "rows_per_rank": [int(g["logits"].shape[1]) for g in got],
                "paths": ref["paths"]}
        line["ok"] = bool(max(errs) <= tol and all(
            g["paths"] == ref["paths"] for g in got) and all(
                r == args[1] // 2 for r in line["rows_per_rank"]))
    else:
        kind = args[0]
        dname = "bfloat16" if args[1].get("bf16") else "float32"
        mod, aug, n_img = ((engine, "augment_pairs", 2) if kind == "cd"
                           else (xbd_engine, "augment_xbd", 1))
        line = _check_two_ranks(
            torch, got, ref, {"space": tag, "net_G": net_g,
                              "img": args[1]["img_size"]}, dname,
            lambda: _own_moves(torch, ref, lambda: sc.trainer_steps(
                None, *args[:4], 0), mod, aug, n_img))
        line["ok"] = line["ok"] and line.get("same_confusion_matrix", True)
        line["grad_worst_leaf"] = _worst(got[0]["grads"], ref["grads"],
                                         lambda k: True)
    line["launches_per_rank"] = per_rank
    line["launches_one_process"] = {k: ref["launches"][c]
                                    for k, c in UNEVEN_COUNTERS}
    line["launches_want"] = {k: want[c] for k, c in UNEVEN_COUNTERS}
    line["ok"] = bool(line["ok"] and all(g["launches"] == want for g in got))
    return line


def _space_k3_line(torch, ft, sc, cases, got) -> dict:
    """Phase 21d: the ranks' rank-split K3 at each case against the plain
    tokenizer of all the pixels (tokens) and the one-process
    ``SemanticTokenizerFn`` on the card (the joined pixel gradients, the
    summed dw)."""
    worst = {"tokens": 0.0, "dx": 0.0, "dw": 0.0}
    same = True
    ok = True
    for j, (b, h, w, l, seed, dname) in enumerate(cases):
        dtype = getattr(torch, dname)
        x, wk, dt = sc.k3_inputs(b, h, w, l, seed)
        xt = torch.from_numpy(x).cuda().to(dtype).reshape(b, h * w, 32)
        xt.requires_grad_(True)
        wt = torch.from_numpy(wk).cuda().to(dtype).requires_grad_(True)
        tokens = ft.SemanticTokenizerFn.apply(xt, wt)
        (tokens.float() * torch.from_numpy(dt).cuda()).sum().backward()
        plain = ft.semantic_tokenizer_plain(xt.detach(), wt.detach())
        r0, r1 = got[0][j], got[1][j]
        same = same and bool(torch.equal(r0["tokens"], r1["tokens"]))
        errs = {"tokens": scaled_err(r0["tokens"].cuda(), plain)[1],
                "dx": scaled_err(torch.cat([r0["dx"], r1["dx"]], 1).cuda()
                                 .reshape(b, h * w, 32), xt.grad)[1],
                "dw": scaled_err((r0["dw"].float() + r1["dw"].float()).cuda(),
                                 wt.grad)[1]}
        ok = ok and errs["tokens"] <= TOL[dname] and max(
            errs["dx"], errs["dw"]) <= GTOL[dname]
        for k in worst:
            worst[k] = max(worst[k], errs[k])
    want = {**NO_PAD, "k1": 0, "k1_save": 0, "k2": 0, "k3": 0,
            "k3_ranks": len(cases), "k4": 0}
    launches = [g[-1] for g in got]
    return {"space": "d_k3_rank_split", "cases": len(cases),
            "shapes": SPACE_K3, "worst_scaled_err": worst,
            "ranks_same_token_bits": same, "launches_per_rank": launches,
            "ok": bool(ok and same and all(n == want for n in launches))}


# Phase 22: the decoder kernels on the space axis: BIT, xbd_bit and the K4
# path (``pallas = True``), two gloo ranks of one data row on cuda:0, each
# holding half the rows, against one process.
BIT_T8_KEY = "base_transformer_pos_s4_dd8_t8_e2d4"
# The decoder kernels' shapes on a rank, half of one process's rows: (name,
# batch, pixels N a rank, depth, heads[, tokens, dim_head]); "rank256" the
# 256 px batch-8 runs of the main path (BIT ``_dd8``, DAHiTra),
# "rank256t8" ``_t8_e2d4``'s, "rank1024" the 1024 px batch-1 xBD steps.
RANK_BIT_SHAPES = [(f"rank{IMG}/bit/dd8", BATCH, (IMG // 4) ** 2 // 2, 8, 8,
                    4, 64),
                   (f"rank{IMG}t8/bit_t8/s4", BATCH, (IMG // 4) ** 2 // 2, 4,
                    8, 8, 8)]
RANK_BIT_TRAIN_SHAPES = [RANK_BIT_SHAPES[0],
                         (f"rank{XBD_IMG}/xbd_bit/s4", 1,
                          (XBD_IMG // 4) ** 2 // 2, 8, 8, 4, 64)]
RANK_K4_SHAPES = [(f"rank{IMG}/{name}", b, n // 2, depth, heads)
                  for name, b, n, depth, heads in K1_SHAPES] + [
    (f"rank{XBD_IMG}/xbd/{name}", 1, n // 2, depth, heads)
    for name, _, n, depth, heads in XBD_K1_SHAPES[:3]]
CALLS.update({name: 2 for name, *_ in RANK_BIT_TRAIN_SHAPES + RANK_BIT_SHAPES})


def _rank_want(k1=0, k1_save=0, k2=0, k4=0, k3_ranks=0) -> dict:
    """A rank's launch counters in a row-sharded run: the one-process K3 and
    the padded counts 0."""
    return {**NO_PAD, "k1": k1, "k1_save": k1_save, "k2": k2, "k3": 0,
            "k3_ranks": k3_ranks, "k4": k4}


def run_space_kernels_phase(torch, tmp) -> tuple:
    """Phase 22 (``nn/space.py`` with the decoder kernels), cuDNN
    deterministic on both sides. One launch of two gloo ranks on cuda:0
    (n_data 1, n_space 2; collectives staged through host memory) against
    one process on the same card, weights and data, fp32 and bf16: (a)
    ``base_transformer_pos_s4_dd8`` at 256 px, batch 8: the eval forward
    (each rank: the rank-split K3 2, K1 at mlp_dim 64 2) and
    ``CDTrainer.train_step(spatial=True)`` on pairs with a painted change
    (K1-save 2, K2 2, K3 2); (b) ``_t8_e2d4``'s eval forward (8 tokens, hl
    64); (c) ``xbd_bit``'s damage ``XBDTrainer.train_step(spatial=True)`` at
    1024 px, batch 1; (d) ``pallas = True``: ``newUNetTrans``'s eval forward
    and train step at 256 px, batch 8 (K4 6 a rank, K3 3), ``xbd_dahitra``'s
    damage step at 1024 px, batch 1 (K4 a rank as one process's pallas
    step), and the ``_dd8`` eval forward (K4 at mlp_dim 64, 2). Held: the
    gathered logits (fp32 1e-5; bf16 2e-2 from one process's bf16 and fp32
    logits, BIT's ``SPACE22_BIT_BF16_TOL``) and each decoder's gate as one
    process's; the steps by ``_check_two_ranks`` (loss, every gradient
    leaf, the BN statistics; rule 5 in fp32; the bf16 steps at batch 1 a
    rank against one process in the ranks' BN order, and their kept leaves
    and statistics against the plain one as phase 21c's); each rank's
    launches
    as listed, the one-process K3 and the padded counts 0. Printed: peak
    memory and the warm step (``SPACE_TIMED``) a rank beside one process,
    one process's own move when it runs the batch in two halves, and the
    confusion matrix's flipped pixels.
    Then K1, K1-save and K2 at mlp_dim 64 and K4 at mlp_dim 32 and 64 at a
    rank's shapes (``RANK_*_SHAPES``) against their plain versions, timed.
    Returns (the launches per dtype and run, the rank-shape kernel rows)."""
    from dahitra_tpu_torch.core import mesh as mesh_mod
    from dahitra_tpu_torch.models.registry import define_g as _define_g
    from dahitra_tpu_torch.nn.init import init_random
    from dahitra_tpu_torch.tools import mesh_checks
    from dahitra_tpu_torch.tools import space_checks as sc
    from dahitra_tpu_torch.train import engine, xbd_engine

    t_phase = time.time()
    by_phase = {"float32": {}, "bfloat16": {}}
    sds = {}
    for i, key in enumerate((BIT_KEY, BIT_T8_KEY, "newUNetTrans")):
        model = init_random(_define_g(key, img_size=IMG),
                            torch.Generator().manual_seed(220 + i))
        sds[key] = {k: v.detach().clone()
                    for k, v in model.state_dict().items()}
    del model
    rng = np.random.default_rng(22)
    fwd_in = {k: rng.uniform(-1, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)
              for k in ("a", "b")}
    cd_arrays = space_arrays(BATCH, IMG, 22)
    xbd_arrays = space_arrays(1, XBD_IMG, 23, xbd=True)

    def cfg(tag, net_g, img, batch, dname, **kw):
        c = _mesh_cfg(tmp, f"space22_{tag}_{dname}", net_g, img, batch,
                      dname, **kw)
        os.makedirs(c["checkpoint_dir"], exist_ok=True)
        return c

    def fwd(key, dname, pallas=False):
        return ("forward_rows", (key, IMG, sds[key], fwd_in, dname, False,
                                 None, True, "cuda:0", pallas))

    # (tag, (function, args), a rank's launches)
    cases = []
    for dname in ("float32", "bfloat16"):
        cases += [
            ("a_bit_eval", fwd(BIT_KEY, dname), _rank_want(k1=2, k3_ranks=2)),
            ("a_bit_step", ("trainer_steps", (
                "cd", cfg("a", BIT_KEY, IMG, BATCH, dname), cd_arrays, True,
                SPACE_TIMED)), _rank_want(k1_save=2, k2=2, k3_ranks=2)),
            ("b_bit_t8_eval", fwd(BIT_T8_KEY, dname),
             _rank_want(k1=2, k3_ranks=2)),
            ("c_xbd_bit_step", ("trainer_steps", (
                "xbd", cfg("c", "xbd_bit", XBD_IMG, 1, dname,
                           val_batch_size=1), xbd_arrays, True, SPACE_TIMED)),
             _rank_want(k1_save=2, k2=2, k3_ranks=2)),
            ("d_pallas_eval", fwd("newUNetTrans", dname, True),
             _rank_want(k4=6, k3_ranks=3)),
            ("d_pallas_step", ("trainer_steps", (
                "cd", cfg("d", "newUNetTrans", IMG, BATCH, dname), cd_arrays,
                True, SPACE_TIMED, True)), _rank_want(k4=6, k3_ranks=3)),
            ("d_pallas_xbd_step", ("trainer_steps", (
                "xbd", cfg("dx", "xbd_dahitra", XBD_IMG, 1, dname,
                           val_batch_size=1), xbd_arrays, True, SPACE_TIMED,
                True)), _rank_want(k4=XBD_CALLS["xbd_dahitra"], k3_ranks=3)),
            ("d_bit_pallas_eval", fwd(BIT_KEY, dname, True),
             _rank_want(k4=2, k3_ranks=2))]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    refs = []
    try:
        t0 = time.time()
        ranks = mesh_mod.launch(sc.run_cases, ([c[1] for c in cases], True),
                                devices=["cuda:0", "cuda:0"], backend="gloo",
                                timeout=600, n_space=2)
        launch_s = time.time() - t0
        # one-process references, the same functions with no mesh
        for tag, (name, args), _ in cases:
            refs.append(getattr(sc, name)(None, *args))
            if name == "forward_rows":
                # one process on the batch in two halves: how far other
                # shapes (cuDNN's choices) move its logits, no rows split
                halves = [sc.forward_rows(None, *args[:3], {
                    k: v[h] for k, v in args[3].items()}, *args[4:])["logits"]
                    for h in (slice(0, BATCH // 2), slice(BATCH // 2, None))]
                refs[-1]["batch_split_move"] = scaled_err(
                    torch.cat(halves), refs[-1]["logits"])[1]
            if name == "trainer_steps" and args[0] == "xbd" \
                    and args[1].get("bf16"):
                # one process summing BatchNorm's statistics in the ranks'
                # order (phase 21c), and for DAHiTra the tokens' cancellation
                with mesh_checks.rank_sums(2):
                    order = sc.trainer_steps(None, *args[:4], 0, *args[5:])
                refs[-1]["order"] = (order, mesh_checks.token_cancellation(
                    args[1], args[2]) if args[1]["net_G"] == "xbd_dahitra"
                    else None)
            _free(torch)
    finally:
        torch.backends.cudnn.deterministic = det
    print(json.dumps({"space22": "two_gloo_ranks_launch", "launch_s": launch_s,
                      "cases": len(cases), "staged_per_rank": [
                          r[-1] for r in ranks]}), flush=True)
    ok = True
    for i, (tag, (name, args), want) in enumerate(cases):
        got = [r[i] for r in ranks]
        ref = refs[i]
        if name == "forward_rows":
            dname = args[4]
            errs = [scaled_err(g["whole"], ref["logits"].cpu())[1]
                    for g in got]
            tol = 1e-5 if dname == "float32" else \
                SPACE22_BIT_BF16_TOL.get(tag, TOL[dname])
            line = {"space22": tag, "dtype": dname,
                    "logits_scaled_err": max(errs),
                    "one_process_batch_split_move": ref["batch_split_move"],
                    "rows_per_rank": [int(g["logits"].shape[1]) for g in got],
                    "paths_per_rank": [g["paths"] for g in got],
                    "paths_one_process": ref["paths"],
                    "launches_per_rank": [g["launches"] for g in got],
                    "launches_one_process": ref["launches"],
                    "peak_gib_per_rank": [g["peak_bytes"] / 2 ** 30
                                          for g in got],
                    "peak_gib_one_process": ref["peak_bytes"] / 2 ** 30}
            if dname == "bfloat16":
                # held from one process's fp32 logits too, its own bf16
                # distance from them printed beside
                ref32 = refs[[c[0] for c in cases].index(tag)]["logits"]
                own = scaled_err(ref["logits"], ref32)[1]
                errs += [scaled_err(g["whole"], ref32.cpu())[1] for g in got]
                line.update({"one_process_bf16_from_fp32": own,
                             "logits_from_fp32_scaled_err": max(errs[2:])})
            line["tol"] = tol
            line["ok"] = bool(max(errs) <= tol and all(
                g["launches"] == want and g["paths"] == ref["paths"]
                and g["logits"].shape[1] == IMG // 2 for g in got))
        else:
            kind, c = args[:2]
            dname = "bfloat16" if c.get("bf16") else "float32"

            def moves(kind=kind, args=args, ref=ref):
                mod, aug, n_img = ((engine, "augment_pairs", 2)
                                   if kind == "cd" else
                                   (xbd_engine, "augment_xbd", 1))
                return _own_moves(torch, ref, lambda: sc.trainer_steps(
                    None, *args[:4], 0, *args[5:]), mod, aug, n_img)

            held = _trans34_path_pallas if (c["net_G"] == "xbd_dahitra"
                                            and dname == "bfloat16") else None
            line = _check_two_ranks(torch, got, ref, {"space22": tag}, dname,
                                    moves, ref.get("order"), held,
                                    order_rounds_as_ranks=True)
            # the confusion matrix is printed, not held: a pixel whose
            # logits tie within rounding is counted either way
            same_k4 = all(g["launches"]["k4"] == ref["launches"]["k4"]
                          for g in got)
            line["ok"] = bool(line["ok"] and same_k4 and all(
                g["launches"] == want for g in got))
        by_phase[dname][f"space_k_{tag[2:]}"] = got[0]["launches"]
        print(json.dumps(line), flush=True)
        ok = ok and line["ok"]
    rows = {}
    gen = torch.Generator().manual_seed(22)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        rows[("k1_mlp64_rank", dname)] = check_k1(torch, dtype, gen,
                                                  RANK_BIT_SHAPES, BIT_MLP)
        rows[("k1_save_mlp64_rank", dname)], rows[("k2_mlp64_rank", dname)] = \
            check_k1_save_k2(torch, dtype, gen, RANK_BIT_TRAIN_SHAPES, BIT_MLP)
        rows[("k4_rank", dname)] = check_k4(torch, dtype, gen,
                                            RANK_K4_SHAPES)[0]
        rows[("k4_mlp64_rank", dname)] = check_k4(
            torch, dtype, gen, RANK_BIT_SHAPES[:1], BIT_MLP)[0]
        for kid in ("k1_mlp64_rank", "k1_save_mlp64_rank", "k2_mlp64_rank",
                    "k4_rank", "k4_mlp64_rank"):
            for r in rows[(kid, dname)]:
                print(json.dumps({"check": f"{kid}[{dname}]", **r}),
                      flush=True)
    print(json.dumps({"space22": "phase_s", "seconds": time.time() - t_phase}),
          flush=True)
    if not ok:
        fail("space kernels (phase 22): a row-sharded run differs from one "
             "process, or a rank's launches are not as listed (the lines "
             "above)")
    return by_phase, rows


# Phase 23: siamUnet_conc, the UNet change transformers and ChangeFormer V1
# and V6 (V6 on its five heads, ``--multi_scale_loss``) on the space axis,
# two gloo ranks on the one card at 256 px, batch 8; then the uneven cases
# at 224 px: unet_coupled_two_trans_256, where layer 4 meets 7 rows a rank
# at 1/16, so 1/32 (its ``transformer``) runs whole while ``transformer2``
# stays on the rank's block of the 1/4 level, and changeFormerV6, whose sr
# convs meet 28 / 14 / 7 rows a rank (not multiples of 8 / 4 / 2: each
# gathers its level) and whose stage-4 patch embed leaves 1/32 (and the
# p4 head) whole.
SPACE_ZOO_KEYS = ("siamUnet_conc", "unet_coupled_trans_256",
                  "unet_coupled_two_trans_256", "changeFormer",
                  "changeFormerV6")
SPACE_ZOO_UNEVEN = (("unet_coupled_two_trans_256", 224),
                    ("changeFormerV6", 224))
# The keys trained on every head of their multi-scale output.
SPACE_ZOO_MULTI_SCALE = ("changeFormerV6",)
# Where each channel-token transformer of an uneven case runs.
SPACE_ZOO_UNEVEN_WIDTH = {"unet_coupled_two_trans_256": {
    "transformer.layers.0.0": "whole", "transformer2.layers.0.0": "block"}}
# A sublayer of each channel-token transformer: its output is the rank's
# block of the token width where its level splits, the whole width where
# the level runs whole.
SPACE_ZOO_BLOCKS = ("transformer.layers.0.0", "transformer2.layers.0.0")


def _width_of(got: dict, ref: dict) -> dict:
    """Per channel-token transformer sublayer (``SPACE_ZOO_BLOCKS``) that
    ran, "block" where a rank's output held half of one process's token
    width, "whole" where all of it."""
    out = {}
    for name in SPACE_ZOO_BLOCKS:
        if name in ref["shapes"]:
            mine, one = got["shapes"][name][-1], ref["shapes"][name][-1]
            out[name] = ("whole" if mine == one else
                         "block" if 2 * mine == one else f"{mine} of {one}")
    return out


def run_space_zoo_phase(torch, tmp) -> None:
    """Phase 23 (``nn/space.py`` for ``siamUnet_conc``, the UNet change
    transformers and ChangeFormer), cuDNN deterministic on both sides. One
    launch of two gloo ranks on cuda:0 (n_data 1, n_space 2; collectives
    staged through host memory) against one process on the same card,
    seeded weights and data, for each of ``SPACE_ZOO_KEYS`` at 256 px,
    batch 8: the fp32 eval forward (the gathered logits 1e-5 of scale,
    every head of a multi-scale list), one fp32
    ``CDTrainer.train_step(spatial=True)`` with dropout active and the
    trainer's generator on both sides (``SPACE_ZOO_MULTI_SCALE`` on every
    head; ``_check_two_ranks``: loss 1e-5 relative, every gradient leaf
    1e-4 of scale or rule 5 with its witness, BN statistics 1e-5, both
    ranks with the same bits) and ``SPACE_TIMED`` warm steps, and the bf16
    eval forward (the full-resolution logits at the flat 2e-2, a coarser
    head at it or twice one process's own bf16 distance from its fp32 head
    where larger); then ``SPACE_ZOO_UNEVEN``'s fp32
    eval forwards and steps at 224 px (1/32 whole). Held also: each rank's
    rows of the logits, its launches (no kernel: every counter 0), and
    where each channel-token transformer ran (the rank's block of the
    width at a level that splits, the whole width at 1/32 of 224 px).
    Printed: peak memory and the warm step a rank beside one process, the
    staged collectives a step."""
    from dahitra_tpu_torch.core import mesh as mesh_mod
    from dahitra_tpu_torch.tools import space_checks as sc
    from dahitra_tpu_torch.train import engine

    t_phase = time.time()
    rng = np.random.default_rng(23)
    fwd_in = {k: rng.uniform(-1, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)
              for k in ("a", "b")}
    u_in = {img: {k: rng.uniform(-1, 1, (BATCH, img, img, 3)).astype(
        np.float32) for k in ("a", "b")} for img in {
            img for _, img in SPACE_ZOO_UNEVEN}}

    def cfg(tag, net_g, img):
        c = _mesh_cfg(tmp, f"space23_{tag}", net_g, img, BATCH, "float32",
                      multi_scale_loss=net_g in SPACE_ZOO_MULTI_SCALE)
        os.makedirs(c["checkpoint_dir"], exist_ok=True)
        return c

    def fwd(key, img, seed, inputs, dname):
        return ("forward_rows", (key, img, seed, inputs, dname, False, None,
                                 True, "cuda:0"))

    # (tag, key, image size, (function, args)); weights drawn on each rank
    # from a seed (``space_checks.seeded_weights``)
    cases = []
    for i, key in enumerate(SPACE_ZOO_KEYS):
        cases += [
            ("eval", key, IMG, fwd(key, IMG, 230 + i, fwd_in, "float32")),
            ("step", key, IMG, ("trainer_steps", (
                "cd", cfg(f"step_{i}", key, IMG),
                space_arrays(BATCH, IMG, 23), True, SPACE_TIMED))),
            ("eval", key, IMG, fwd(key, IMG, 230 + i, fwd_in, "bfloat16"))]
    for i, (key_u, img_u) in enumerate(SPACE_ZOO_UNEVEN):
        cases += [
            ("uneven_eval", key_u, img_u, fwd(key_u, img_u, 233 + 10 * i,
                                              u_in[img_u], "float32")),
            ("uneven_step", key_u, img_u, ("trainer_steps", (
                "cd", cfg(f"uneven_{i}", key_u, img_u),
                space_arrays(BATCH, img_u, 24), True, 0)))]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    refs = []
    try:
        t0 = time.time()
        ranks = mesh_mod.launch(sc.run_cases, ([c[3] for c in cases], True),
                                devices=["cuda:0", "cuda:0"], backend="gloo",
                                timeout=600, n_space=2)
        launch_s = time.time() - t0
        # one-process references, the same functions with no mesh
        for _, _, _, (name, args) in cases:
            refs.append(getattr(sc, name)(None, *args))
            _free(torch)
    finally:
        torch.backends.cudnn.deterministic = det
    print(json.dumps({"space23": "two_gloo_ranks_launch", "launch_s": launch_s,
                      "cases": len(cases), "staged_per_rank": [
                          r[-1] for r in ranks]}), flush=True)
    want_launches = _rank_want()
    ok = True
    for i, (tag, key, img, (name, args)) in enumerate(cases):
        got = [r[i] for r in ranks]
        ref = refs[i]
        width = [_width_of(g, ref) for g in got]
        want_width = {n: "block" for n in SPACE_ZOO_BLOCKS
                      if n in ref["shapes"]}
        if tag.startswith("uneven"):
            want_width = SPACE_ZOO_UNEVEN_WIDTH.get(key, {})
        if name == "forward_rows":
            dname = args[4]
            # every head of a multi-scale list, else the logits
            heads = ref.get("heads", [ref["logits"]])
            head_errs = [max(scaled_err(g.get("heads", [g["whole"]])[j],
                                        h.cpu())[1] for g in got)
                         for j, h in enumerate(heads)]
            err = max(head_errs)
            tol = 1e-5 if dname == "float32" else TOL[dname]
            head_tols = [tol] * len(heads)
            if dname == "bfloat16" and len(heads) > 1:
                # the full-resolution logits at the flat bound; a coarser
                # head at it or, where larger, twice one process's own
                # bf16 move from its fp32 head (rule 5 as
                # ``_check_two_ranks`` takes it: twice the own move)
                head_tols[:-1] = [max(tol, 2 * scaled_err(h, h32)[1])
                                  for h, h32 in zip(heads[:-1],
                                                    refs[i - 2]["heads"])]
            line = {"space23": tag, "net_G": key, "img": img,
                    "dtype": dname, "logits_scaled_err": err,
                    "head_scaled_errs": head_errs, "head_tols": head_tols,
                    "tol": tol,
                    "rows_per_rank": [int(g["logits"].shape[1]) for g in got],
                    "token_width_per_rank": width,
                    "launches_per_rank": [g["launches"] for g in got],
                    "peak_gib_per_rank": [g["peak_bytes"] / 2 ** 30
                                          for g in got],
                    "peak_gib_one_process": ref["peak_bytes"] / 2 ** 30}
            if dname == "bfloat16":
                # one process's own bf16 distance from its fp32 logits
                ref32 = refs[i - 2]["logits"]
                line.update({
                    "one_process_bf16_from_fp32": scaled_err(
                        ref["logits"], ref32)[1],
                    "one_process_bf16_from_fp32_heads": [
                        scaled_err(h, h32)[1] for h, h32 in zip(
                            heads, refs[i - 2].get("heads", [ref32]))],
                    "logits_from_fp32_scaled_err": max(scaled_err(
                        g["whole"], ref32.cpu())[1] for g in got)})
            line["ok"] = bool(all(
                e <= t for e, t in zip(head_errs, head_tols)) and all(
                torch.isfinite(g["whole"]).all() for g in got) and all(
                g["launches"] == want_launches
                and g["logits"].shape[1] == img // 2 for g in got)
                and all(w == want_width for w in width))
        else:
            def moves(args=args, ref=ref):
                return _own_moves(torch, ref, lambda: sc.trainer_steps(
                    None, *args[:4], 0), engine, "augment_pairs", 2)

            line = _check_two_ranks(
                torch, got, ref, {"space23": tag, "net_G": key, "img": img},
                "float32", moves)
            line["token_width_per_rank"] = width
            line["ok"] = bool(line["ok"] and all(
                torch.isfinite(g["loss"]).all()
                and g["launches"] == want_launches for g in got)
                and all(w == want_width for w in width))
        print(json.dumps(line), flush=True)
        ok = ok and line["ok"]
    print(json.dumps({"space23": "phase_s", "seconds": time.time() - t_phase}),
          flush=True)
    if not ok:
        fail("space zoo (phase 23): a row-sharded run differs from one "
             "process, launched a kernel or ran a transformer on other "
             "columns (the lines above)")


# Phase 20, the host-free step: graphed steps against eager ones.
GRAPH_STEPS = 8  # replays (and eager steps) per comparison, >= 8
GRAPH_TIMED = 3  # warm calls per timing: phases 1-22 share the 1200 s
GRAPH_WARMUP = 3  # StepGraph's warm-up steps before the capture, one process
# The profiler's kernel rows of one replay: 256 px default train step (6
# K1-save, 6 K2 of 2 kernels, 3 K3 of 2), its pallas step (6 K4 of 2
# kernels: prologue and rows), the eval forward (6 K1, 3 K3).
GRAPH_ROWS = {"train": {"k1": 0, "k1_save": 6, "k2": 12, "k3": 6, "k4": 0},
              "pallas": {"k1": 0, "k1_save": 0, "k2": 0, "k3": 6, "k4": 12},
              "eval": {"k1": 6, "k1_save": 0, "k2": 0, "k3": 6, "k4": 0},
              "xbd": {"k1": 0, "k1_save": 3, "k2": 6, "k3": 6, "k4": 0}}
# Launches per replay (kernel rows per kernel id, calls of 2 kernels
# halved) for the kernels line: dtype -> kernel id -> count.
REPLAY_LAUNCHES = {"float32": {}, "bfloat16": {}}


def _free(torch) -> None:
    """Collect the trainers of a finished part (a captured step and its
    trainer reference each other) and return their memory, graph pools
    included, to the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _graph_arrays(n: int, img: int, seed: int) -> dict:
    """``n`` seeded uint8 LEVIR pairs of ``img`` px with blocky labels."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 2, (n, img // 16, img // 16), dtype=np.uint8)
    return {"a": rng.integers(0, 256, (n, img, img, 3), dtype=np.uint8),
            "b": rng.integers(0, 256, (n, img, img, 3), dtype=np.uint8),
            "label": lab.repeat(16, 1).repeat(16, 2)}


def _graph_cfg(tmp, tag, dtype, **kw) -> dict:
    import torch

    return {"n_class": 2, "checkpoint_dir": os.path.join(tmp, "graph", tag),
            "max_epochs": 1, "net_G": "newUNetTrans", "img_size": IMG,
            "lr": 5e-4, "batch_size": BATCH, "lr_policy": "linear",
            "device": "cuda", "seed": 0, "bf16": dtype == torch.bfloat16,
            **kw}


def _per_replay(rows: dict) -> dict:
    """Kernel rows of one replay as launches (K2, K3 and K4 run 2 kernels
    a launch)."""
    return {k: v // (2 if k in ("k2", "k3", "k4") else 1)
            for k, v in rows.items()}


def _graph_vs_eager(torch, make, steps_fn, tag, want_rows, want_counts,
                    batch_of) -> tuple:
    """Two trainers from ``make()`` (same seed): epoch 0 through the scan
    path (graph replays) on one, eager ``train_step``s in the same order on
    the other, cuDNN deterministic; the same bits or a failure. Then each
    trainer's warm step timed (``GRAPH_TIMED`` calls, the median) and one
    graphed and one eager step profiled (device busy, idle share, kernel
    rows; a replay's rows must be ``want_rows``). The launch counters read
    over the graphed epoch count the warm-up and capture
    (``want_counts``), never a replay. Returns (the line, the eager
    run's state)."""
    from dahitra_tpu_torch.tools import graph_checks as gc

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        graphed = make()
        _reset_counts()
        got = steps_fn(graphed, True)
        counts = _read_counts()
        if counts != {**NO_PAD, **want_counts}:
            fail(f"graph {tag}: launches over warm-up and capture {counts} "
                 f"!= {want_counts}")
        eager = make()
        ref = steps_fn(eager, False)
        diff = gc.differing(got, ref)
        if diff or len(got["loss"]) < GRAPH_STEPS \
                or not torch.isfinite(got["loss"]).all():
            fail(f"graph {tag}: replays against eager steps differ in "
                 f"{diff[:8]} ({len(diff)} entries), losses {got['loss']} / "
                 f"{ref['loss']}")
        g_call = gc.graphed_call(graphed)
        e_call = gc.eager_call(eager, batch_of(eager))
        times = {"eager": gc.time_steps(e_call, graphed.device, GRAPH_TIMED),
                 "graphed": gc.time_steps(g_call, graphed.device,
                                          GRAPH_TIMED)}
        prof = {"graphed": gc.profile_replay(
                    g_call, times["graphed"]["median"]),
                "eager": gc.profile_replay(e_call, times["eager"]["median"])}
        if prof["graphed"]["kernel_rows"] != want_rows:
            fail(f"graph {tag}: a replay's kernel rows "
                 f"{prof['graphed']['kernel_rows']} != {want_rows}")
        line = {"graph": tag, "steps": len(got["loss"]),
                "same_bits": True, "loss": got["loss"].tolist(),
                "step_ms": times,
                "speedup": times["eager"]["median"]
                / times["graphed"]["median"],
                "profile": prof, "capture_launches": counts,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        return line, ref
    finally:
        torch.backends.cudnn.deterministic = det
        graphed = eager = g_call = e_call = None
        _free(torch)


def check_scan_cli(torch, train_root, tmp) -> dict:
    """(c) ``main_cd --scan_epoch --log_chunks 2`` for 2 epochs on phase
    7's splits (4 steps an epoch, a progress line after the 2nd), launch
    counters over the run: the train step's and the eval forward's warm-up
    and capture (``GRAPH_WARMUP`` + 1 steps each); then the validation
    matrix of a trainer with the run's weights at batch 3 (two full batches
    and a tail of 2) through the replays against the per-batch pass."""
    from dahitra_tpu_torch.cli import main_cd
    from dahitra_tpu_torch.core.checkpoint import load_checkpoint
    from dahitra_tpu_torch.data.levir import load_levir_split
    from dahitra_tpu_torch.data.registry import get_data_config
    from dahitra_tpu_torch.tools import graph_checks as gc

    root = os.path.join(train_root, "ckpt")
    os.environ["DAHITRA_DATA_ROOT"] = os.path.join(train_root, "data")
    argv = ["--checkpoint_root", root, "--project_name", "scan",
            "--data_name", "LEVIR", "--img_size", str(IMG), "--batch_size",
            str(BATCH), "--max_epochs", "2", "--skip_test", "--scan_epoch",
            "--log_chunks", "2", "--device", "cuda"]
    _reset_counts()
    t0 = time.time()
    history = main_cd.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = _read_counts()
    w = GRAPH_WARMUP + 1
    want = {"k1": 6 * w, "k1_save": 6 * w, "k2": 6 * w, "k3": 3 * 2 * w,
            "k4": 0}
    if got != {**NO_PAD, **want}:
        fail(f"main_cd --scan_epoch: launches {got} != {want}")
    log = open(os.path.join(root, "scan", "log.txt")).read()
    steps = TRAIN_PAIRS // BATCH
    lines = re.findall(
        r"Is_training: True\. \[(\d+),(\d+)\]\[(\d+)\], imps: [\d.]+, "
        r"est: [\d.]+h, G_loss: [\d.]+, running_mf1: [\d.]+\n", log)
    epochs = re.findall(r"Is_training: True\. Epoch (\d) / 1, epoch_mF1= "
                        r"[\d.]+, imps: [\d.]+, G_loss: [\d.]+\n", log)
    want_lines = [(str(e), str(steps // 2), str(steps)) for e in (0, 1)]
    if lines != want_lines or epochs != ["0", "1"] \
            or not all(np.isfinite([h["loss"] for h in history])):
        fail(f"main_cd --scan_epoch: progress lines {lines} != {want_lines}"
             f", epoch lines {epochs} or losses {history}")
    cfg_data = get_data_config("LEVIR")
    p = load_levir_split(cfg_data.root_dir, "val", IMG,
                         cfg_data.label_transform)
    arrays = {"a": p.a, "b": p.b, "label": p.label}
    tr = gc.cd_trainer(_graph_cfg(tmp, "scan_val", torch.float32,
                                  batch_size=3), arrays)
    tr.model.load_state_dict(load_checkpoint(os.path.join(root, "scan"))[0])
    tr.validate(0)
    cm_scan = tr.confusion_matrix
    tr.scan = False
    tr.validate(0)
    if not np.array_equal(cm_scan, tr.confusion_matrix):
        fail(f"scan validation matrix {cm_scan.tolist()} != per-batch "
             f"{tr.confusion_matrix.tolist()}")
    del tr
    _free(torch)
    return {"scan_cli": "main_cd --scan_epoch --log_chunks 2", "epochs": 2,
            "pairs_per_s_by_epoch": [h["imps"] for h in history],
            "loss_by_epoch": [h["loss"] for h in history], "wall_s": wall,
            "progress_lines": len(lines), "launches": got,
            "val_matrix": cm_scan.tolist(), "val_matrix_equal": True}


def check_eval_scan(torch, tmp, cm5, pairs_per_s5) -> dict:
    """(d) ``CDEvaluator.eval_models(scan=True)`` on phase 4's checkpoint
    over the 64 patches at batch 8, fp32, the patch blocks on: phase 5's
    matrix exactly; the run's pairs/s (capture included) beside phase 5's,
    then the warm replays alone (``EvalScan`` over the staged batches,
    median of 3) and one replay's kernel rows."""
    import types

    from dahitra_tpu_torch.data.levir import load_levir_split
    from dahitra_tpu_torch.data.registry import get_data_config
    from dahitra_tpu_torch.evalx.evaluator import (CDEvaluator,
                                                   stage_full_batches)
    from dahitra_tpu_torch.tools import graph_checks as gc
    from dahitra_tpu_torch.train.graph import EvalScan

    os.environ["DAHITRA_DATA_ROOT"] = os.path.join(tmp, "data")
    cfg = get_data_config("LEVIR")
    chunks = [load_levir_split(cfg.root_dir, "test", IMG, cfg.label_transform,
                               patch=i) for i in range(16)]
    arrays = {k: np.concatenate([getattr(c, k) for c in chunks])
              for k in ("a", "b", "label")}
    group_of = np.concatenate([np.full(len(c.a), i, np.int32)
                               for i, c in enumerate(chunks)])
    args = types.SimpleNamespace(
        n_class=2, checkpoint_dir=os.path.join(tmp, "ckpt", "smoke"),
        net_G="newUNetTrans", img_size=IMG, batch_size=BATCH, bf16=False)
    ev = CDEvaluator(args, arrays, device="cuda")
    _reset_counts()
    scores = ev.eval_models(scan=True, group_of=group_of)
    torch.cuda.synchronize()
    got = _read_counts()
    w = GRAPH_WARMUP + 1
    want = {"k1": 6 * w, "k1_save": 0, "k2": 0, "k3": 3 * w, "k4": 0}
    if got != {**NO_PAD, **want}:
        fail(f"eval_models(scan=True): launches {got} != {want}")
    if cm5 is not None and not np.array_equal(ev.confusion_matrix, cm5):
        fail(f"eval_models(scan=True) matrix {ev.confusion_matrix.tolist()} "
             f"!= phase 5's {cm5.tolist()}")
    if len(scores.get("per_group", [])) != 16:
        fail("eval_models(scan=True): patch blocks missing")
    stack, _ = stage_full_batches(ev.loader, ("a", "b", "label"), ev.device)
    es = EvalScan(lambda a, b, l: ev.eval_step(a, b, l)[0], stack, 2,
                  ev.device)
    ms = gc.time_steps(es, ev.device, 3)["median"]
    one = gc.profile_replay(lambda: (es.step.reset(), es.step()),
                            ms / len(stack[0]))
    if one["kernel_rows"] != GRAPH_ROWS["eval"]:
        fail(f"eval replay kernel rows {one['kernel_rows']} != "
             f"{GRAPH_ROWS['eval']}")
    REPLAY_LAUNCHES["float32"]["k1"] = _per_replay(one["kernel_rows"]).get("k1")
    del ev, es, stack
    _free(torch)
    return {"eval_scan": "float32", "pairs": len(arrays["a"]),
            "matrix_equal_phase5": cm5 is not None,
            "pairs_per_s": scores["imps"], "phase5_pairs_per_s": pairs_per_s5,
            "warm_replays_pairs_per_s": len(arrays["a"]) / (ms / 1e3),
            "replay": one, "launches": got}


def _xbd_graph_arrays(tmp) -> dict:
    """Phase 15's 8 training tiles at 1024 px, decoded as ``xbd_train``
    decodes them."""
    from dahitra_tpu_torch.data.xbd import load_xbd_pairs, scan_xbd_files

    files = scan_xbd_files([xbd_tiles(tmp)[0]])
    return load_xbd_pairs(files, train=True, crop_size=XBD_IMG,
                          seed=0).arrays()


def run_graph_phase(torch, tmp, train_root, cm5, pairs_per_s5) -> dict:
    """Phase 20: the host-free step (module docstring). Returns the
    launches per dtype and run for the kernels line."""
    from dahitra_tpu_torch.core.mesh import launch
    from dahitra_tpu_torch.tools import graph_checks as gc

    out = {"float32": {}, "bfloat16": {}}
    arrays = _graph_arrays(GRAPH_STEPS * BATCH, IMG, 20)
    w = GRAPH_WARMUP + 1
    ref32 = None
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for pallas in (False, True):
            kind = "pallas" if pallas else "train"
            tag = f"{kind}_{dname}"
            want = ({"k1": 0, "k1_save": 0, "k2": 0, "k3": 3 * w, "k4": 6 * w}
                    if pallas else
                    {"k1": 0, "k1_save": 6 * w, "k2": 6 * w, "k3": 3 * w,
                     "k4": 0})
            line, ref = _graph_vs_eager(
                torch, lambda: gc.cd_trainer(_graph_cfg(tmp, tag, dtype),
                                             arrays, pallas=pallas),
                gc.cd_steps, tag, GRAPH_ROWS[kind], want, gc.first_batch)
            print(json.dumps(line), flush=True)
            out[dname][f"graph_{kind}_256"] = line["capture_launches"]
            per = _per_replay(line["profile"]["graphed"]["kernel_rows"])
            for k, v in per.items():
                if v:
                    REPLAY_LAUNCHES[dname][k] = v
            if dtype == torch.float32 and not pallas:
                ref32 = ref
            del ref
    # (f) DDP under NCCL at world size 1, captured: (a)'s fp32 bits
    ddp = launch(gc.scan_steps, (_graph_cfg(tmp, "ddp", torch.float32),
                                arrays), devices=["cuda:0"],
                 backend="nccl")[0]
    diff = gc.differing(ddp, ref32)
    if diff or not (ddp["ddp"] and ddp["graphed"]):
        fail(f"graph ddp: DDP replays against (a)'s eager fp32 steps differ "
             f"in {diff[:8]} ({len(diff)} entries) or not captured under "
             f"DDP ({ddp['ddp']}, {ddp['graphed']})")
    print(json.dumps({"graph": "ddp_nccl_world1", "same_bits_as_a": True,
                      "loss": ddp["loss"].tolist()}), flush=True)
    del ref32, ddp
    _free(torch)
    # (c) the CLI, (d) the evaluator
    line = check_scan_cli(torch, train_root, tmp)
    out["float32"]["scan_cli_256"] = line["launches"]
    print(json.dumps(line), flush=True)
    line = check_eval_scan(torch, tmp, cm5, pairs_per_s5)
    out["float32"]["eval_scan_256"] = line["launches"]
    print(json.dumps(line), flush=True)
    # (e) xbd_dahitra damage at 1024 px, batch 1
    xbd = _xbd_graph_arrays(tmp)
    dec = XBD_CALLS["xbd_dahitra"]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]

        def make(dtype=dtype, dname=dname):
            return gc.xbd_trainer(dict(
                checkpoint_dir=os.path.join(tmp, "graph", f"xbd_{dname}"),
                max_epochs=1, net_G="xbd_dahitra", img_size=XBD_IMG, lr=0.0,
                batch_size=1, val_batch_size=1, device="cuda", seed=0,
                bf16=dtype == torch.bfloat16), xbd)

        line, _ = _graph_vs_eager(
            torch, make, gc.xbd_steps, f"xbd_{dname}", GRAPH_ROWS["xbd"],
            {"k1": 0, "k1_save": dec * w, "k2": dec * w, "k3": dec * w,
             "k4": 0},
            lambda tr: tuple(torch.from_numpy(xbd[k][:1]).cuda() for k in
                             ("img_pre", "img_post", "msk", "lbl_msk")))
        out[dname]["graph_xbd_1024"] = line["capture_launches"]
        print(json.dumps(line), flush=True)
    return out


def main() -> None:
    sel = selected_phases(sys.argv[1:])
    started = {}  # phase -> time.time() at its start, for phase_seconds
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

    started["1"] = time.time()
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    disable_tf32()

    started["2"] = time.time()
    # 2. build, and the decoder row kernels' registers, spills, HMMA
    # instructions and CTAs per SM
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    print(json.dumps({"phases": sorted(sel)}), flush=True)
    ptxas = {src: start_ptxas_report(tmp, src) for src in ROW_KERNELS} \
        if 2 in sel else {}
    _build.build(_build.sources())
    print(f"build: {_build.sources()} in {time.time() - t0:.1f} s", flush=True)
    resources = {src: row_kernel_resources(torch, tmp, src, proc)
                 for src, proc in ptxas.items()}
    if 2 in sel:
        print(json.dumps({"row_kernel_resources": resources}), flush=True)

    started["3"] = time.time()
    # 3. kernels against their plain versions
    checks = {}
    floor_ms = None
    if 3 in sel:
        torch.manual_seed(0)
        gen = torch.Generator().manual_seed(0)
        floor_ms = empty_launch_ms(torch)
        print(json.dumps({"empty_launch_ms": floor_ms}), flush=True)
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

    started["4"] = time.time()
    # 4. synthetic LEVIR and a seeded checkpoint
    if 4 in sel:
        t0 = time.time()
        write_synthetic_levir(os.path.join(tmp, "data"), n_tiles=4,
                              size=1024, seed=0)
        model = define_g("newUNetTrans", img_size=IMG)
        model.init_weights(torch.Generator().manual_seed(0))
        save_checkpoint(os.path.join(tmp, "ckpt", "smoke"),
                        model.state_dict(), best_val_acc=0.0,
                        best_epoch_id=0)
        print(f"setup: synthetic LEVIR + checkpoint in "
              f"{time.time() - t0:.1f} s", flush=True)
    # phase 7's splits, which phases 8, 11, 14, 17 and 19 also read
    train_root = os.path.join(tmp, "train")
    if sel & {7, 8, 11, 14, 17, 19, 20}:
        for split, n, seed in (("train", TRAIN_PAIRS, 1),
                               ("val", VAL_PAIRS, 2)):
            write_synthetic_levir(os.path.join(train_root, "data"), n_tiles=n,
                                  size=IMG, split=split, seed=seed)

    started["5"] = time.time()
    # 5. the eval path, fp32 then bf16
    dtypes = (([], "float32"), (["--bf16"], "bfloat16"))
    by_phase = {"float32": {}, "bfloat16": {}}
    _record_confusion_matrices()
    cm5 = p5 = None
    for flag, dname in dtypes if 5 in sel else ():
        out = run_eval(torch, os.path.join(tmp, "data"),
                       os.path.join(tmp, "ckpt"), "smoke", flag, dname, IMG,
                       BATCH, 64, patches=16)
        by_phase[dname]["eval_256"] = out["launches"]
        print(json.dumps(out), flush=True)
        if dname == "float32":
            cm5 = EVAL_CMS[-1]
            p5 = out["pairs_per_s"]

    started["6"] = time.time()
    # 6. the card's forward (kernels) against the plain path on the CPU
    if 6 in sel:
        print(json.dumps(check_forward_vs_cpu(
            torch, model, os.path.join(tmp, "data"), IMG, 2, patch=5)),
            flush=True)
    if 4 in sel:
        del model

    started["7"] = time.time()
    # 7. the training path, fp32 then bf16
    for flag, dname in dtypes if 7 in sel else ():
        out = run_training(torch, train_root, flag, dname)
        by_phase[dname]["train_256"] = out["launches"]
        print(json.dumps(out), flush=True)

    started["8"] = time.time()
    # 8. the card's training gradients against the plain path on the CPU
    if 8 in sel:
        print(json.dumps(check_train_grads(torch, train_root)), flush=True)

    started["9-10"] = time.time()
    # 9-10. the pallas path (K4): eval forwards, then train steps
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        if 9 in sel:
            out = run_pallas_eval(torch, tmp, dtype)
            by_phase[dname]["pallas_eval_256"] = out["launches"]
            print(json.dumps(out), flush=True)
        if 10 in sel:
            out = run_pallas_train(torch, tmp, dtype)
            by_phase[dname]["pallas_train_256"] = out["launches"]
            print(json.dumps(out), flush=True)

    started["11"] = time.time()
    # 11. the pallas path's training gradients against the CPU
    if 11 in sel:
        print(json.dumps(check_train_grads(torch, train_root, pallas=True)),
              flush=True)

    started["12"] = time.time()
    # 12. eval at 512 px (16 tiles of 512 px, batch 8) and at 1024 px (phase
    # 4's tiles, batch 2), each with a seeded checkpoint of its size
    root512 = os.path.join(tmp, "px512")
    if 12 in sel:
        write_synthetic_levir(os.path.join(root512, "data"), n_tiles=16,
                              size=512, seed=3)
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
        print(json.dumps(check_forward_vs_cpu(
            torch, models[512], os.path.join(root512, "data"), 512, 1)),
            flush=True)
        del models

    started["13"] = time.time()
    # 13. training at 512 px (batch 4, one epoch over 8 pairs, 4 val pairs),
    # then one train step at 1024 px per dtype and path
    if 13 in sel:
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

    started["14"] = time.time()
    # 14. BIT (base_transformer_pos_s4_dd8, mlp_dim 64) and base_resnet18
    if 14 in sel:
        for dname, phases in run_bit_phase(torch, tmp, train_root,
                                           dtypes).items():
            by_phase[dname].update(phases)

    started["15"] = time.time()
    # 15. xBD: xbd_train and xbd_predict (xbd_dahitra), one step and a
    # prediction of xbd_bit, at 1024 px; the card's gradients at 256 px
    if 15 in sel:
        for dname, phases in run_xbd_phase(torch, tmp, dtypes).items():
            by_phase[dname].update(phases)

    started["16"] = time.time()
    # 16. the rest of the xBD stack: xbd_train --task loc, adapt (both
    # networks), gan and damage --elastic, visualize_results, warm steps, the
    # card's loc and GAN gradients at 256 px
    if 16 in sel:
        for dname, phases in run_xbd_tasks_phase(torch, tmp, dtypes).items():
            by_phase[dname].update(phases)

    started["17"] = time.time()
    # 17. the rest of the LEVIR zoo (no decoder or tokenizer kernel), demo,
    # import_checkpoint, fast_vjp=False and count_params
    if 17 in sel:
        for dname, phases in run_zoo_phase(torch, tmp, train_root, dtypes,
                                           cm5).items():
            by_phase[dname].update(phases)

    started["18"] = time.time()
    # 18. the xBD half of the zoo (no decoder or tokenizer kernel):
    # xbd_train --task damage | loc | hrnet, xbd_predict, import_checkpoint,
    # the card against the CPU at 128 px, a reproducible dropout step
    if 18 in sel:
        xbd_tiles(tmp)
        for dname, phases in run_xbd_zoo_phase(torch, tmp, dtypes).items():
            by_phase[dname].update(phases)

    started["19"] = time.time()
    # 19. data parallelism (core/mesh.py): DDP under NCCL at world size 1,
    # two gloo ranks on the card against one process, a padded evaluation,
    # the CLIs with --gpu_ids 0
    if 19 in sel:
        xbd_tiles(tmp)
        for dname, phases in run_mesh_phase(torch, tmp, train_root,
                                            cm5).items():
            by_phase[dname].update(phases)

    started["20"] = time.time()
    # 20. the host-free step: graphed train steps against eager ones
    # (default and pallas path, both dtypes), DDP captured under NCCL,
    # main_cd --scan_epoch, eval_models(scan=True), xBD at 1024 px
    if 20 in sel:
        for dname, phases in run_graph_phase(torch, tmp, train_root, cm5,
                                             p5).items():
            by_phase[dname].update(phases)

    started["21"] = time.time()
    # 21. the space axis: two gloo ranks on the card, each holding half the
    # rows, against one process; the rank-split K3
    space_k3, space_uneven = {}, {}
    if 21 in sel:
        phases, space_k3, space_uneven = run_space_phase(torch, tmp)
        for dname, ph in phases.items():
            by_phase[dname].update(ph)

    started["22"] = time.time()
    # 22. the decoder kernels on the space axis: BIT, xbd_bit and pallas =
    # True on two gloo ranks against one process; the kernels at a rank's
    # shapes
    rank_checks = {}
    if 22 in sel:
        phases, rank_checks = run_space_kernels_phase(torch, tmp)
        for dname, ph in phases.items():
            by_phase[dname].update(ph)

    started["23"] = time.time()
    # 23. siamUnet_conc, the UNet change transformers and ChangeFormer on the
    # space axis:
    # two gloo ranks against one process, no kernel
    if 23 in sel:
        run_space_zoo_phase(torch, tmp)

    started["profile"] = time.time()
    if "--profile" in sys.argv[1:]:
        for net_g, project, n_dec in (("newUNetTrans", "smoke", 3),
                                      (BIT_KEY, BIT_KEY, 1)):
            if not sel & ({5, 7} if n_dec == 3 else {14}):
                continue
            sd = load_checkpoint(os.path.join(tmp, "ckpt", project))[0]
            for dtype in (torch.float32, torch.bfloat16):
                for pallas in (False, True):
                    print(json.dumps(profile_forward(
                        torch, sd, dtype, pallas, net_g, n_dec)), flush=True)
                    print(json.dumps(profile_train_step(
                        torch, tmp, dtype, pallas, net_g, n_dec)), flush=True)
        if 18 in sel:
            print(json.dumps(profile_xbd_zoo_steps(torch, tmp)), flush=True)

    started["end"] = time.time()
    names = list(started)
    print(json.dumps({"phase_seconds": {
        a: round(started[b] - started[a], 1)
        for a, b in zip(names, names[1:])}}), flush=True)

    kernels = []
    src = "dahitra_tpu_torch/csrc/"
    if 2 not in sel:  # no resource report: every instance's entry null
        resources = collections.defaultdict(
            lambda: collections.defaultdict(lambda: None))
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
    rank_table = (
        ("decoder_stack_fwd" + sfx + "_rank", "decoder_fwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:180", "k1_mlp64_rank",
         "space_k_bit_eval", "k1", TOL,
         {"design": K1_DESIGN, "resources": k1w_res}),
        ("decoder_stack_fwd_save" + sfx + "_rank", "decoder_fwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:180", "k1_save_mlp64_rank",
         "space_k_bit_step", "k1_save", TOL,
         {"design": K1_DESIGN, "resources": k1w_save_res}),
        ("decoder_stack_bwd" + sfx + "_rank", "decoder_bwd.cu",
         "dahitra_tpu/pallas/folded_decoder.py:320", "k2_mlp64_rank",
         "space_k_bit_step", "k2", GTOL,
         {"design": K2_DESIGN, "resources": k2w_res}),
        ("fused_decoder_rank", "fused_decoder.cu",
         "dahitra_tpu/pallas/fused_decoder.py:102", "k4_rank",
         "space_k_pallas_eval", "k4", TOL,
         {"design": K4_DESIGN, "resources": k4_res}),
        ("fused_decoder" + sfx + "_rank", "fused_decoder.cu",
         "dahitra_tpu/pallas/fused_decoder.py:102", "k4_mlp64_rank",
         "space_k_bit_pallas_eval", "k4", TOL,
         {"design": K4_DESIGN, "resources": k4w_res}))
    for dname in ("float32", "bfloat16"):
        for name, source, replaces, kid, phase, counter, tol, extra in table:
            # The BIT phases launch the decoder kernels' mlp_dim-64 instances
            # only, the others their mlp_dim-32 ones; K3 runs in both.
            mlp64 = kid.endswith("_mlp64")
            pad = kid.endswith(("_pad", "_wide"))
            phases = {ph: c[counter] for ph, c in by_phase[dname].items()
                      if (kid == "k3" or pad or ph == "resnet_eval_256"
                          or ph.startswith("bit_") == mlp64)
                      and not ph.startswith("space_")}
            # null launches where the phase did not run (--phases)
            kernels.append(summarize(
                name, src + source, replaces, dname, checks.get((kid, dname)),
                by_phase[dname].get(phase, {}).get(counter), tol, phases,
                main_size="bit" if mlp64 else kid.rsplit("_", 1)[1] if pad
                else str(IMG),
                launches_per_replay=REPLAY_LAUNCHES[dname].get(kid),
                **{k: v[dname] for k, v in extra.items()}))
        # K3 split over the space ranks (phase 21): per rank, at 256 px
        # batch 8; launches from each rank's row-sharded train step (the
        # replicated grid, "grid_replicated_256", runs the one-process K3)
        kernels.append(summarize(
            "semantic_tokenizer_ranks", src + "tokenizer.cu",
            "dahitra_tpu/pallas/fused_tokenizer.py:42", dname,
            space_k3.get(dname), by_phase[dname].get(
                "space_train_256", {}).get("k3_ranks"), TOL,
            {ph: c["k3_ranks"] for ph, c in by_phase[dname].items()
             if ph.startswith("space_")}, main_size=f"r{IMG}",
            empty_launch_ms=floor_ms))
        # The kernels at uneven rows (phase 21f): per rank, newUNetTrans at
        # 240 px batch 8 (1/4 and 1/8 a rank's rows, 1/16 whole: the
        # one-process K3 there); launches from each rank's eval forward (K3,
        # K1) and train step (K1-save, K2) of 21f.
        for name, source, replaces, kid, phase, tol in (
                ("semantic_tokenizer_uneven", "tokenizer.cu",
                 "dahitra_tpu/pallas/fused_tokenizer.py:42", "k3",
                 "space_uneven_eval_240", TOL),
                ("semantic_tokenizer_ranks_uneven", "tokenizer.cu",
                 "dahitra_tpu/pallas/fused_tokenizer.py:42", "k3_ranks",
                 "space_uneven_eval_240", TOL),
                ("decoder_stack_fwd_uneven", "decoder_fwd.cu",
                 "dahitra_tpu/pallas/folded_decoder.py:180", "k1",
                 "space_uneven_eval_240", TOL),
                ("decoder_stack_fwd_save_uneven", "decoder_fwd.cu",
                 "dahitra_tpu/pallas/folded_decoder.py:180", "k1_save",
                 "space_uneven_step_240", TOL),
                ("decoder_stack_bwd_uneven", "decoder_bwd.cu",
                 "dahitra_tpu/pallas/folded_decoder.py:320", "k2",
                 "space_uneven_step_240", GTOL)):
            kernels.append(summarize(
                name, src + source, replaces, dname,
                space_uneven.get((kid, dname)),
                by_phase[dname].get(phase, {}).get(kid), tol,
                {ph: c[kid] for ph, c in by_phase[dname].items()
                 if ph.startswith("space_uneven_")},
                main_size=f"u{UNEVEN_IMG}"))
        # The decoder kernels at a rank's shapes (phase 22): per rank, 256 px
        # batch 8 (``rank1024``: the xBD steps at 1024 px, batch 1);
        # launches from each rank's row-sharded runs of phase 22.
        for name, source, replaces, kid, phase, counter, tol, extra in (
                rank_table):
            bit = "mlp64" in kid
            kernels.append(summarize(
                name, src + source, replaces, dname,
                rank_checks.get((kid, dname)),
                by_phase[dname].get(phase, {}).get(counter), tol,
                {ph: c[counter] for ph, c in by_phase[dname].items()
                 if ph.startswith("space_k_") and ("bit" in ph) == bit},
                main_size=f"rank{IMG}",
                **{k: v[dname] for k, v in extra.items()}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
