"""The port's host-free step (``--scan_epoch``, ``--log_chunks``,
``--scan_chunk_batches``, ``eval_models(scan=True)``) on the CPU.

On the CPU the scan path runs the staged loop eagerly (``train/graph.py``:
the graph's plain version); on a card each step is a CUDA-graph replay of
the same body (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 20).
Here the batch order is held against the JAX package's own functions,
called unbound on a namespace (``CDTrainer._epoch_perm``,
``XBDTrainer._scan_chunks``), the confusion matrices against its metrics,
and the staged epoch against eager ``train_step`` calls in that order: the
same bits (one process, one summation order). Two gloo ranks against one
process on the joined batches: the losses 1e-5 relative (tests/
test_torch_mesh.py's bound for a step; a split batch sums BatchNorm's
moments in another order), the same matrices, both ranks' parameters equal.
Small: ``newUNetTrans`` at 32 px, ``xbd_dahitra`` and ``base_resnet18`` at
64 px, torch on 2 threads.
"""
import os
import re
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dahitra_tpu.metrics import confusion as jconf
from dahitra_tpu.train.engine import CDTrainer as JaxCDTrainer
from dahitra_tpu.train.xbd_engine import XBDTrainer as JaxXBDTrainer
from dahitra_tpu_torch.core.mesh import launch
from dahitra_tpu_torch.evalx import evaluator as ev_mod
from dahitra_tpu_torch.evalx.evaluator import CDEvaluator
from dahitra_tpu_torch.metrics import confusion as tconf
from dahitra_tpu_torch.tools import graph_checks as gc
from dahitra_tpu_torch.train.engine import CDTrainer
from dahitra_tpu_torch.train.xbd_engine import XBDTrainer


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cd_arrays(n, s, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8),
            "b": rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8),
            "label": rng.integers(0, 2, (n, s, s)).astype(np.uint8)}


def _xbd_arrays(n, s, seed):
    rng = np.random.default_rng(seed)
    return {"img_pre": rng.integers(0, 255, (n, s, s, 3), dtype=np.uint8),
            "img_post": rng.integers(0, 255, (n, s, s, 3), dtype=np.uint8),
            "msk": rng.integers(0, 2, (n, s, s, 5)).astype(np.uint8),
            "lbl_msk": rng.integers(0, 4, (n, s, s)).astype(np.uint8)}


def _cd_cfg(tmp, net="newUNetTrans", img=32, bs=2, **kw):
    return dict(n_class=2, checkpoint_dir=str(tmp), max_epochs=1, net_G=net,
                img_size=img, lr=1e-3, batch_size=bs, lr_policy="linear",
                device="cpu", seed=0, **kw)


@pytest.mark.parametrize("world,seed,epoch,n,bs", [
    (1, 0, 0, 10, 3), (1, 7, 4, 17, 4), (2, 0, 0, 10, 4), (2, 3, 5, 17, 2),
    (4, 1, 2, 23, 4)])
def test_epoch_perm_matches_jax(world, seed, epoch, n, bs):
    """The port's ``_epoch_perm`` (a world of ranks) is JAX's (a ``data``
    axis of that size) on the same staged count."""
    staged = (n // world) * world
    n_batches = staged // bs
    jns = types.SimpleNamespace(args=types.SimpleNamespace(seed=seed),
                                n_data=world, _staged_n=staged)
    tns = types.SimpleNamespace(
        args=types.SimpleNamespace(seed=seed), _staged_n=staged,
        mesh=types.SimpleNamespace(world_size=world, n_data=world)
        if world > 1 else None)
    want = JaxCDTrainer._epoch_perm(jns, epoch, n_batches, bs)
    got = CDTrainer._epoch_perm(tns, epoch, n_batches, bs)
    assert got.shape == (n_batches, bs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,bs,chunk,epoch", [(7, 1, 0, 0), (10, 3, 2, 1),
                                              (9, 2, 1, 3), (300, 1, 0, 2)])
def test_scan_chunks_match_jax(n, bs, chunk, epoch):
    """``_scan_chunks``: the same permutation, ``drop_last`` and chunk
    sizes (``scan_chunk_batches``, or ceil(256 / B)) as JAX's."""
    arrays = _xbd_arrays(n, 2, 0)
    ns = types.SimpleNamespace(
        args=types.SimpleNamespace(batch_size=bs, seed=5,
                                   scan_chunk_batches=chunk),
        _train_arrays=arrays)
    want = list(JaxXBDTrainer._scan_chunks(ns, epoch))
    got = list(XBDTrainer._scan_chunks(ns, epoch))
    assert len(got) == len(want) and len(got) >= 1
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_class", [2, 5])
def test_confusion_matrices_match_jax(n_class):
    """The fixed-size ``scatter_add_`` counts equal the JAX metrics, the
    255 ignore label dropped, in the batch and the per-sample form."""
    rng = np.random.default_rng(n_class)
    pred = rng.integers(0, n_class, (3, 9, 7))
    gt = rng.integers(0, n_class, (3, 9, 7))
    gt[rng.random(gt.shape) < 0.2] = 255
    got = tconf.batch_confusion_matrix(torch.from_numpy(pred),
                                       torch.from_numpy(gt), n_class)
    want = jconf.batch_confusion_matrix(jnp.asarray(pred), jnp.asarray(gt),
                                        n_class)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tconf.per_sample_confusion_matrix(torch.from_numpy(pred),
                                            torch.from_numpy(gt), n_class)
    want = jconf.per_sample_confusion_matrix(jnp.asarray(pred),
                                             jnp.asarray(gt), n_class)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_PROGRESS = re.compile(  # JAX's progress_line (engine.py:316-325)
    r"Is_training: True\. \[(\d+),(\d+)\]\[(\d+)\], imps: \d+\.\d{2}, "
    r"est: \d+\.\d{4}h, G_loss: \d+\.\d{5}, running_mf1: \d+\.\d{5}$")


def test_cd_scan_epoch_equals_eager_steps(tmp_path, few_threads):
    """A ``--scan_epoch`` epoch (7 pairs, batch 2: the ragged pair dropped)
    is eager ``train_step`` in ``_epoch_perm`` order, bit for bit: each
    batch's loss, every parameter and buffer, the generators' states; its
    ``--log_chunks 2`` progress line has JAX's format."""
    arrays = _cd_arrays(7, 32, 1)
    cfg = _cd_cfg(tmp_path / "g", log_chunks=2)
    got = gc.cd_steps(gc.cd_trainer(cfg, arrays), graphed=True)
    want = gc.cd_steps(gc.cd_trainer(_cd_cfg(tmp_path / "e"), arrays),
                       graphed=False)
    assert len(got["loss"]) == 3
    assert gc.differing(got, want) == []
    lines = (tmp_path / "g" / "log.txt").read_text().splitlines()
    progress = [m.groups() for m in map(_PROGRESS.match, lines) if m]
    assert progress == [("0", "2", "3")]
    assert any(line.startswith("Is_training: True. Epoch 0 / 0") for line in
               lines)


@pytest.mark.parametrize("task,net", [("damage", "xbd_dahitra"),
                                      ("loc", "xbd_res34_loc")])
def test_xbd_scan_epoch_equals_eager_steps(tmp_path, few_threads, task, net):
    """``xbd_train --scan_epoch --scan_chunk_batches 1`` (5 tiles at batch
    2: 2 chunks of one batch, the ragged tile dropped) is eager
    ``train_step`` over ``_scan_chunks``' batches, bit for bit, with JAX's
    mid-epoch line after the first chunk."""
    arrays = _xbd_arrays(5, 64, 2)
    cfg = dict(checkpoint_dir=str(tmp_path), max_epochs=1, net_G=net,
               img_size=64, lr=0.0, batch_size=2, val_batch_size=2,
               device="cpu", seed=0, scan_chunk_batches=1)
    got = gc.xbd_steps(gc.xbd_trainer(cfg, arrays, task), graphed=True)
    want = gc.xbd_steps(gc.xbd_trainer(cfg, arrays, task), graphed=False)
    assert len(got["loss"]) == 2
    assert gc.differing(got, want) == []
    log = (tmp_path / "log.txt").read_text()
    assert re.search(r"^epoch 0 \[1/2\] imps: \d+\.\d{2}, Loss \d+\.\d{4}$",
                     log, re.M)


def test_gan_scan_epoch_changes_nothing(tmp_path, few_threads):
    """``--task gan --scan_epoch`` keeps the per-batch epoch (JAX's GAN
    epoch has no scan path) and a non-capturable optimizer."""
    from dahitra_tpu_torch.train.xbd_engine import GANTrainer

    args = types.SimpleNamespace(
        checkpoint_dir=str(tmp_path), max_epochs=1, net_G="xbd_dahitra",
        img_size=64, lr=0.0, batch_size=2, val_batch_size=2, seed=0,
        scan_epoch=True)
    tr = GANTrainer(args, _xbd_arrays(2, 64, 0), _xbd_arrays(2, 64, 1),
                    device="cpu")
    assert not tr.scan and not tr.optimizer.param_groups[0]["capturable"]


def test_validate_and_eval_models_scan_equal_per_batch(tmp_path, few_threads,
                                                       monkeypatch):
    """5 validation pairs at batch 2 (2 staged full batches, a ragged pair
    per batch): ``validate`` and ``eval_models(scan=True)``, summed and
    per patch, give the per-batch matrices; ``save_vis`` turns the scan
    off (no ``EvalScan`` is built, the grids are written)."""
    arrays = _cd_arrays(5, 32, 3)
    tr = gc.cd_trainer(_cd_cfg(tmp_path / "t"), arrays)
    tr.validate(0)
    scan_cm = tr.confusion_matrix
    assert tr._val_scan is not None and len(tr._val_tail) == 1
    tr.scan = False
    tr.validate(0)
    np.testing.assert_array_equal(scan_cm, tr.confusion_matrix)

    args = types.SimpleNamespace(n_class=2, checkpoint_dir=str(tmp_path),
                                 net_G="newUNetTrans", img_size=32,
                                 batch_size=2, vis_dir=str(tmp_path / "vis"))
    ev = CDEvaluator(args, arrays, device="cpu",
                     state_dict=tr.model.state_dict())
    group_of = np.array([0, 1, 0, 1, 1])
    for grouped in (None, group_of):
        scan = ev.eval_models(scan=True, group_of=grouped)
        scan_cm = ev.confusion_matrix
        plain = ev.eval_models(group_of=grouped)
        np.testing.assert_array_equal(scan_cm, ev.confusion_matrix)
        assert scan.get("per_group") == plain.get("per_group")

    def refused(*a, **k):
        raise AssertionError("save_vis must switch the scan off")

    monkeypatch.setattr(ev_mod, "EvalScan", refused)
    ev.eval_models(scan=True, save_vis=True)
    assert len(os.listdir(tmp_path / "vis")) == 3


def test_optimizer_state_loads_across_modes(tmp_path):
    """A capturable optimizer's checkpoint (tensor learning rate) loads
    into the per-batch trainer's optimizer and back, each keeping its own
    mode."""
    from dahitra_tpu_torch.train.optim import make_optimizer

    p = [torch.nn.Parameter(torch.ones(3))]
    plain = make_optimizer(p, 1e-3)
    p[0].grad = torch.ones(3)
    plain.step()
    sd = plain.state_dict()
    assert isinstance(sd["param_groups"][0]["lr"], float)
    other = make_optimizer(p, 5e-4)
    other.load_state_dict(sd)
    assert other.param_groups[0]["lr"] == 1e-3
    assert not other.param_groups[0]["capturable"]
    assert other.state[p[0]]["step"].device.type == "cpu"


def _joined_steps(cfg, arrays, world):
    """One process's eager steps on the batches ``world`` ranks join under
    ``--scan_epoch``: each rank's shard-local columns of ``_epoch_perm``,
    mapped to the staged positions of its contiguous shard."""
    tr = gc.cd_trainer(cfg, arrays)
    gc._epoch0_lr(tr)
    tr._stage_train()
    bs = cfg["batch_size"]
    staged = (len(arrays["a"]) // world) * world
    ns = types.SimpleNamespace(args=tr.args, _staged_n=staged,
                               mesh=types.SimpleNamespace(world_size=world,
                                                         n_data=world))
    perm = CDTrainer._epoch_perm(ns, 0, staged // bs, bs)
    per, local = bs // world, staged // world
    losses, cms = [], []
    for row in perm:
        idx = np.concatenate([row[r * per:(r + 1) * per] + r * local
                              for r in range(world)])
        loss, cm = tr.train_step(*(t.index_select(0, torch.from_numpy(idx))
                                   for t in tr._staged_train))
        losses.append(loss)
        cms.append(cm)
    return torch.stack(losses), torch.stack(cms).sum(0)


def test_scan_epoch_on_two_gloo_ranks_equals_the_joined_batches(tmp_path,
                                                               monkeypatch):
    """Two gloo ranks under ``--scan_epoch`` (9 pairs, staged 8, joined
    batch 4, 2 steps), each staging its contiguous shard and taking its
    columns of ``_epoch_perm``, against one process on the joined batches
    of JAX's shard-local order."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    arrays = _cd_arrays(9, 64, 4)
    # Adam's first update moves every weight by about lr whatever the size
    # of its gradient, so a near-0 gradient whose sign the split's
    # summation order flips moves the next loss by an lr-sized amount (at
    # lr 1e-3: 1.4e-4 relative); at 1e-6 the next batch's loss stays within
    # the step's 1e-5, and the batches still differ in their data.
    cfg = dict(_cd_cfg(tmp_path, net="base_resnet18", img=64, bs=4), lr=1e-6)
    ranks = launch(gc.scan_steps, (cfg, arrays), devices=["cpu", "cpu"],
                   timeout=240)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses, cm = _joined_steps(cfg, arrays, 2)
    finally:
        torch.set_num_threads(n)
    for r in ranks:
        assert len(r["loss"]) == 2
        torch.testing.assert_close(r["loss"], losses, rtol=1e-5, atol=0)
        assert torch.equal(r["cm"], cm)
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in ranks[0]["params"])
