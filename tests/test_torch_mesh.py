"""The port's data parallelism (``core/mesh.py``) against the JAX package's
mesh and against one process, with two gloo ranks on the CPU.

Every multi-rank check spawns its ranks through ``core.mesh.launch``; the
ranks run ``dahitra_tpu_torch/tools/mesh_checks.py``, which imports no JAX,
on one thread each (``OMP_NUM_THREADS=1``), and each launch has a time limit
of its own so that a hang fails its test. The one-process references run in
the test's process, and the JAX ones on the 8 virtual CPU devices of
``tests/conftest.py``.

Tolerances, scale-normalized: BatchNorm's outputs and running statistics
1e-5, its gradients 1e-4 (against JAX ``PairBatchNorm`` under
``jax.value_and_grad`` on a 2-device mesh); the padded loss and its logit
gradient 1e-6 (against JAX ``levir_train_loss``); a ``CDTrainer`` step's
loss 1e-5 relative and its gradients 1e-4 of the whole gradient's scale,
or, where larger (``base_resnet18``), ROADMAP section 3 rule 5: the median
of the one-process step's own moves under four 1e-6 input moves (each
test names the bound it used); xBD validation's tp / fp / fn exactly and
its dice 1e-6; an ``XBDTrainer`` step as a ``CDTrainer`` step in fp32 and
at 2e-2 / 6e-2 in bf16; the GAN epoch's losses 1e-5 relative; the padded
``CDEvaluator``'s matrices exactly those of one process at the ranks'
per-forward batch. Both ranks must hold equal running statistics, bit for
bit.
"""
import argparse
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dahitra_tpu.core.mesh import make_mesh, mesh_from_gpu_ids
from dahitra_tpu.data.loader import BatchLoader as JaxBatchLoader
from dahitra_tpu.losses.cd import levir_train_loss as jax_levir_train_loss
from dahitra_tpu.nn.resnet import PairBatchNorm
from dahitra_tpu_torch.cli import main_cd
from dahitra_tpu_torch.core.mesh import Mesh, devices_from_gpu_ids, launch
from dahitra_tpu_torch.data.loader import BatchLoader
from dahitra_tpu_torch.data.synthetic import write_synthetic_levir
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.nn.init import init_random
from dahitra_tpu_torch.tools import mesh_checks
from dahitra_tpu_torch.train import engine
from dahitra_tpu_torch.train.xbd_engine import XBDTrainer

TWO = ["cpu", "cpu"]
LIMIT = 240  # seconds, per launch


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """The ranks and the one-process references on one thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(got, ref):
    got, ref = (np.asarray(v, np.float32) for v in (got, ref))
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def _grad_err(got: dict, ref: dict) -> float:
    assert got.keys() == ref.keys()
    scale = max(float(v.abs().max()) for v in ref.values())
    return max(float((got[k] - ref[k]).abs().max()) / scale for k in ref)


def _stats_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------- --gpu_ids

GPU_IDS = ["0", "0,1", "0,1,2,3", "99", "0,0", "1,1,0", " 3 , ,5", "7,8,9",
           "-1,2"]


@pytest.mark.parametrize("ids", GPU_IDS)
def test_devices_from_gpu_ids_match_mesh_from_gpu_ids(ids, capsys):
    """The strings of tests/test_sharding.py and a few more, with 8 visible
    devices: the same kept count and the same warnings on stdout."""
    want = mesh_from_gpu_ids(ids).devices.size
    want_out = capsys.readouterr().out
    got = devices_from_gpu_ids(ids, "cuda", visible=8)
    assert len(got) == want
    assert capsys.readouterr().out == want_out
    assert all(d.type == "cuda" for d in got)
    cpu = devices_from_gpu_ids(ids, "cpu", visible=8)
    assert len(cpu) == want and all(d.type == "cpu" for d in cpu)
    capsys.readouterr()


def test_devices_from_gpu_ids_refuses_what_mesh_from_gpu_ids_refuses(capsys):
    for ids in ("junk", "0,x"):
        with pytest.raises(ValueError) as want:
            mesh_from_gpu_ids(ids)
        with pytest.raises(ValueError) as got:
            devices_from_gpu_ids(ids, "cuda", visible=8)
        assert str(got.value) == str(want.value)
    mesh_from_gpu_ids("0,0")
    want = capsys.readouterr().out
    devices_from_gpu_ids("0,0", visible=8)
    assert "duplicate" in want and capsys.readouterr().out == want
    assert [d.index for d in devices_from_gpu_ids("2,0,2", visible=4)] == [2, 0]


# --------------------------------------------------------------- loader

def _arrays(n, s=4, seed=0, label=True):
    rng = np.random.RandomState(seed)
    out = {"a": rng.randint(0, 256, (n, s, s, 3)).astype(np.uint8),
           "b": rng.randint(0, 256, (n, s, s, 3)).astype(np.uint8)}
    if label:
        out["label"] = rng.randint(0, 2, (n, s, s)).astype(np.uint8)
    else:
        out["msk"] = rng.randint(0, 2, (n, s, s, 5)).astype(np.uint8)
    return out


@pytest.mark.parametrize("n,bs,pad,shuffle,drop_last,label", [
    (5, 4, 2, False, False, True),   # ragged: 1 real + 1 filler
    (5, 4, 4, True, False, True),    # ragged, shuffled: 1 + 3 filler
    (8, 4, 2, True, False, True),    # not ragged
    (7, 3, 2, True, True, True),     # drop_last: no ragged batch
    (5, 8, 2, False, False, False),  # no label key (xBD): valid only
    (3, 3, 4, True, False, True)])   # one batch padded past the batch size
def test_padded_loader_is_bit_equal_to_the_jax_loader(n, bs, pad, shuffle,
                                                      drop_last, label):
    """``pad_to_multiple``: every batch bit-equal to the JAX loader's (the
    first sample repeated, label 255, a ``valid`` vector) over two epochs;
    sharded over ``pad`` ranks, the ranks' batches joined in rank order are
    the same batches."""
    arrays = _arrays(n, label=label)
    kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last,
              pad_to_multiple=pad)
    want_l = JaxBatchLoader(arrays, bs, **kw)
    got_l = BatchLoader(arrays, bs, **kw)
    shards = [BatchLoader(arrays, bs, shard=(r, pad), **kw) for r in range(pad)]
    for _ in range(2):
        want = list(want_l._epoch_batches())
        got = list(got_l)
        parts = [list(s) for s in shards]
        assert len(got) == len(want) == len(got_l)
        for i, (w, g) in enumerate(zip(want, got)):
            assert w.keys() == g.keys() and "valid" in g
            for k in w:
                assert w[k].dtype == g[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
                joined = np.concatenate([p[i][k] for p in parts])
                np.testing.assert_array_equal(joined, w[k])
            assert got_l.real_rows(i) == int(w["valid"].sum())
        if label and any((~w["valid"]).any() for w in want):
            assert any((g["label"][~g["valid"]] == 255).all() for g in got)


# ------------------------------------------------------ launch 1: BN, loss

def _bn_case(pair, seed):
    """A joined batch of 4 rows (per date in pair mode) whose last row is
    filler (a repeat of the first), channel statistics far from (0, 1)."""
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(8 if pair else 4, 5, 3, 16)) * 2 + 0.5)
    if pair:
        x[4:] = x[4:] * 3 - 1
        x[3], x[7] = x[0], x[4]
    else:
        x[3] = x[0]
    dy = rng.normal(size=x.shape)
    params = {"scale": rng.normal(size=16), "bias": rng.normal(size=16),
              "mean": 0.1 * rng.normal(size=16),
              "var": rng.uniform(0.5, 1.5, 16)}
    return (x.astype(np.float32), dy.astype(np.float32),
            {k: v.astype(np.float32) for k, v in params.items()}, pair)


def _loss_case(b, seed):
    """Joined fp32 logits and labels of ``b`` rows, the last one filler
    (label 255) where ``b`` is 4."""
    rng = np.random.RandomState(seed)
    logits = rng.normal(size=(b, 8, 8, 2)).astype(np.float32)
    label = rng.randint(0, 2, (b, 8, 8)).astype(np.uint8)
    if b == 4:
        logits[3], label[3] = logits[0], 255
    return logits, label


@pytest.fixture(scope="module")
def small_launch():
    cases = [("bn_rows", _bn_case(False, 0)), ("bn_rows", _bn_case(True, 1)),
             ("loss_rows", _loss_case(4, 2)), ("loss_rows", _loss_case(2, 3))]
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        ranks = launch(mesh_checks.run_cases, (cases,), devices=TWO,
                       timeout=LIMIT)
    finally:
        del os.environ["OMP_NUM_THREADS"]
    return cases, ranks


def _jax_bn(x, dy, params, pair):
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    place = NamedSharding(mesh, P("data"))
    xs, dys = (jax.device_put(jnp.asarray(v), place) for v in (x, dy))
    stats = {"mean": params["mean"], "var": params["var"]}

    def f(p, xx):
        y, mut = PairBatchNorm().apply(
            {"params": p, "batch_stats": stats}, xx, False, pair,
            mutable=["batch_stats"])
        return jnp.sum(y * dys), (y, mut["batch_stats"])

    (_, (y, new)), (dp, dx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
        {"scale": params["scale"], "bias": params["bias"]}, xs)
    return y, dx, dp, new


def _joined(ranks, key, pair):
    """The ranks' rows of ``key`` back in the joined batch's order."""
    parts = [r[key].numpy() for r in ranks]
    if not pair:
        return np.concatenate(parts)
    halves = [np.split(p, 2) for p in parts]
    return np.concatenate([h[0] for h in halves] + [h[1] for h in halves])


@pytest.mark.parametrize("which", [0, 1], ids=["batch", "pair"])
def test_global_batchnorm_matches_pair_batchnorm_on_a_mesh(small_launch,
                                                           which):
    """Two ranks, each with half the joined batch (a filler row among it):
    outputs and running statistics 1e-5, input and parameter gradients 1e-4
    against JAX on the joined batch; both ranks hold the same running
    statistics."""
    cases, ranks = small_launch
    x, dy, params, pair = cases[which][1]
    got = [r[which] for r in ranks]
    y, dx, dp, new = _jax_bn(x, dy, params, pair)
    assert _scaled(_joined(got, "y", pair), y) < 1e-5
    assert _scaled(_joined(got, "dx", pair), dx) < 1e-4
    for k, jk in (("dweight", "scale"), ("dbias", "bias")):
        assert _scaled(got[0][k], dp[jk]) < 1e-4
        assert torch.equal(got[0][k], got[1][k])
    for k in ("mean", "var"):
        assert _scaled(got[0][k], new[k]) < 1e-5
        assert torch.equal(got[0][k], got[1][k])


@pytest.mark.parametrize("which", [2, 3], ids=["padded_b4", "b2_on_2"])
def test_gathered_loss_matches_jax_on_the_padded_batch(small_launch, which):
    """``levir_train_loss`` of the gathered logits at the joined batch's
    size: a padded batch of 4 (one row label 255) and a global batch of 2
    on 2 ranks, which must take the dice + focal branch (one process on a
    rank's single row would take CE); value and logit gradient 1e-6."""
    cases, ranks = small_launch
    logits, label = cases[which][1]
    b = len(logits)
    want, grad = jax.value_and_grad(
        lambda z: jax_levir_train_loss(z, jnp.asarray(label, jnp.int32), b))(
        jnp.asarray(logits))
    for r in ranks:
        assert abs(float(r[which]["loss"]) - float(want)) <= 1e-6 * abs(
            float(want))
    assert _scaled(np.concatenate([r[which]["grad"].numpy() for r in ranks]),
                   grad) < 1e-6
    if b == 2:  # the CE branch gives another value
        ce = jax_levir_train_loss(jnp.asarray(logits),
                                  jnp.asarray(label, jnp.int32), 1)
        assert abs(float(ce) - float(want)) > 1e-3


# ---------------------------------------------------- launch 2: CDTrainer

def _cd_cfg(tmp, net, img, bs):
    return dict(n_class=2, checkpoint_dir=str(tmp), max_epochs=1, net_G=net,
                img_size=img, lr=1e-3, batch_size=bs, lr_policy="linear",
                device="cpu", seed=0)


CD_CASES = {  # name: (net_G, px, joined batch, pairs in the split)
    "base_resnet18": ("base_resnet18", 64, 4, 6),
    "newUNetTrans": ("newUNetTrans", 128, 4, 6),
    "ragged": ("base_resnet18", 64, 4, 3)}  # 3 real pairs + 1 filler


@pytest.fixture(scope="module")
def cd_launch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cd")
    cases, ones = [], {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, (net, img, bs, n_pairs) in CD_CASES.items():
            cfg = _cd_cfg(tmp / name, net, img, bs)
            arrays = _arrays(n_pairs, img, seed=len(cases))
            cases.append(("cd_steps", (cfg, arrays, 1)))
            ones[name] = (mesh_checks.cd_steps(None, cfg, arrays, 1, pad_to=2),
                          cfg, arrays)
        os.environ["OMP_NUM_THREADS"] = "1"
        ranks = launch(mesh_checks.run_cases, (cases,), devices=TWO,
                       timeout=LIMIT)
    finally:
        os.environ.pop("OMP_NUM_THREADS", None)
        torch.set_num_threads(n)
    return {name: (ones[name], [r[i] for r in ranks])
            for i, name in enumerate(CD_CASES)}


def _own_moves(cfg, arrays, one, monkeypatch) -> list:
    """The one-process step's gradient moves (scale-normalized) under four
    1e-6 moves of the augmented inputs."""
    aug = engine.augment_pairs
    moves = []
    for i in range(4):
        g = torch.Generator().manual_seed(100 + i)

        def moved(*a, **k):
            x, y, l = aug(*a, **k)
            return (x + 1e-6 * torch.randn(x.shape, generator=g),
                    y + 1e-6 * torch.randn(y.shape, generator=g), l)

        monkeypatch.setattr(engine, "augment_pairs", moved)
        mv = mesh_checks.cd_steps(None, cfg, arrays, 1, pad_to=2)
        moves.append(_grad_err(mv["grads"], one["grads"]))
    monkeypatch.setattr(engine, "augment_pairs", aug)
    return moves


def _check_cd(name, cd_launch, grad_tol):
    (one, _, _), ranks = cd_launch[name]
    for r in ranks:
        torch.testing.assert_close(r["loss"], one["loss"], rtol=1e-5, atol=0)
        assert torch.equal(r["cm"], one["cm"])
        assert _grad_err(r["grads"], one["grads"]) <= grad_tol
        assert max(_scaled(r["stats"][k], one["stats"][k])
                   for k in one["stats"]) < 1e-5
    assert _stats_equal(ranks[0]["stats"], ranks[1]["stats"])
    assert _stats_equal(ranks[0]["grads"], ranks[1]["grads"])


def test_cd_step_on_two_ranks_equals_one_process_dahitra(cd_launch):
    """``newUNetTrans`` at 128 px (tests/test_torch_dahitra.py's size), a
    joined batch of 4: loss 1e-5, gradients at the flat 1e-4 of the
    scale, the same confusion matrix, equal statistics on both ranks."""
    _check_cd("newUNetTrans", cd_launch, 1e-4)


@pytest.mark.parametrize("name", ["base_resnet18", "ragged"])
def test_cd_step_on_two_ranks_equals_one_process_resnet(cd_launch, name,
                                                        monkeypatch):
    """``base_resnet18`` at 64 px, a joined batch of 4, and a ragged batch
    (3 pairs padded to 4, held against one process on the same padded
    batch). Bound: rule 5, max(1e-4, the median of the one-process step's
    own moves under four 1e-6 input moves); its early convolutions'
    gradients are cancellations (BN right behind them) that move past 1e-4
    of the scale under such a move, and the split batch sums them in
    another order."""
    one, cfg, arrays = cd_launch[name][0]
    bound = max(1e-4, float(np.median(_own_moves(cfg, arrays, one,
                                                 monkeypatch))))
    _check_cd(name, cd_launch, bound)


# ------------------------- launch 3: xBD validate, GAN, steps and padded eval

def _xbd_arrays(n, s, seed):
    rng = np.random.default_rng(seed)
    return {"img_pre": rng.integers(0, 255, (n, s, s, 3), dtype=np.uint8),
            "img_post": rng.integers(0, 255, (n, s, s, 3), dtype=np.uint8),
            "msk": rng.integers(0, 2, (n, s, s, 5)).astype(np.uint8),
            "lbl_msk": rng.integers(0, 4, (n, s, s)).astype(np.uint8)}


def _xbd_cfg(tmp, net, s, bs, val_bs):
    return dict(net_G=net, img_size=s, batch_size=bs, val_batch_size=val_bs,
                lr=1e-4, max_epochs=1, checkpoint_dir=str(tmp), seed=0,
                device="cpu")


@pytest.fixture(scope="module")
def xbd_launch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("xbd")
    val = _xbd_arrays(5, 32, 1)
    # 64 px: at 32 px the trunk's last BatchNorms see 1 x 1 maps of two
    # samples, whose variance is a cancellation that the ranks' split sums
    # round another way, far past the bound
    gan = _xbd_arrays(4, 64, 2)
    vcfg = _xbd_cfg(tmp / "val", "xbd_res34_double", 32, 8, 8)
    gcfg = _xbd_cfg(tmp / "gan", "xbd_res34_double", 64, 2, 2)
    for c in (vcfg, gcfg):
        os.makedirs(c["checkpoint_dir"], exist_ok=True)
    # the padded evaluation: 5 pairs at batch 4 with eval_cd's per-patch
    # groups; one process at the ranks' per-forward batch of 2
    model = define_g("base_resnet18", img_size=32)
    init_random(model, torch.Generator().manual_seed(3))
    ecfg = dict(n_class=2, checkpoint_dir=str(tmp / "eval"),
                net_G="base_resnet18", img_size=32, batch_size=4,
                device="cpu")
    os.makedirs(ecfg["checkpoint_dir"], exist_ok=True)
    ev = (ecfg, _arrays(5, 32, seed=4), model.state_dict(),
          np.array([0, 0, 1, 1, 2]))
    steps = _xbd_arrays(2, 64, 19)
    scfgs = [{**_xbd_cfg(tmp / f"steps_{d}", "xbd_dahitra", 64, 2, 2),
              "lr": 1e-3, "bf16": d == "bfloat16"} for d in XBD_STEP_DTYPES]
    for c in scfgs:
        os.makedirs(c["checkpoint_dir"], exist_ok=True)
    cases = [("xbd_validate", (vcfg, val)), ("gan_epoch", (gcfg, gan)),
             ("cd_eval", ev)] + [("xbd_steps", (c, steps, 1)) for c in scfgs]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ones = [getattr(mesh_checks, f)(None, *a) for f, a in cases[:2]]
        ones.append(mesh_checks.cd_eval(None, {**ecfg, "batch_size": 2},
                                        *ev[1:]))
        ones += [mesh_checks.xbd_steps(None, *a) for _, a in cases[3:]]
        os.environ["OMP_NUM_THREADS"] = "1"
        ranks = launch(mesh_checks.run_cases, (cases,), devices=TWO,
                       timeout=LIMIT)
    finally:
        os.environ.pop("OMP_NUM_THREADS", None)
        torch.set_num_threads(n)
    return ones, ranks


def test_xbd_validate_on_two_ranks_equals_one_process(xbd_launch):
    """``XBDTrainer.validate`` with ``xbd_res34_double`` on 5 samples at val
    batch 8 (each rank 4 rows, 3 of them filler): tp / fp / fn exactly,
    dice 1e-6 (the port's tests/test_sharding.py:164-197)."""
    ones, ranks = xbd_launch
    one = ones[0]
    for r in ranks:
        got = r[0]
        assert torch.equal(got["counts"], one["counts"])
        assert got["scores"]["dice_loc"] == pytest.approx(
            one["scores"]["dice_loc"], rel=1e-6, abs=1e-12)
        assert got["scores"]["score"] == pytest.approx(
            one["scores"]["score"], rel=1e-6, abs=1e-12)
        assert got["scores"]["class_f1"] == one["scores"]["class_f1"]


def test_gan_epoch_on_two_ranks_equals_one_process(xbd_launch):
    """A ``GANTrainer`` epoch of 2 steps at 64 px, a joined batch of 2 (one
    row a rank), the discriminator updated at step 0 through its own DDP: the
    generator's and discriminator's losses of every step 1e-5 relative;
    both ranks end with the same running statistics in both networks."""
    ones, ranks = xbd_launch
    one = ones[1]
    for r in ranks:
        got = r[1]
        torch.testing.assert_close(got["g_loss"], one["g_loss"], rtol=1e-5,
                                   atol=0)
        torch.testing.assert_close(got["d_loss"], one["d_loss"], rtol=1e-5,
                                   atol=0)
    assert float(one["d_loss"][0]) > 0
    for k in ("stats", "disc_stats"):
        assert _stats_equal(ranks[0][1][k], ranks[1][1][k])


def test_padded_evaluation_on_two_ranks_equals_one_process(xbd_launch):
    """``CDEvaluator`` of ``base_resnet18`` over 5 pairs at batch 4 with
    eval_cd's per-patch groups (per-sample matrices): each rank scores 2
    rows, then 1 and a filler; the summed matrix and every group's scores
    exactly those of one process at the ranks' per-forward batch of 2, the
    filler in none of them, and 5 pairs counted."""
    ones, ranks = xbd_launch
    one = ones[2]
    for r in ranks:
        got = r[2]
        assert torch.equal(got["cm"], one["cm"])
        assert int(got["cm"].sum()) == 5 * 32 * 32
        assert got["scores"]["per_group"] == one["scores"]["per_group"]
        assert got["launches"] == one["launches"]


XBD_STEP_DTYPES = ("float32", "bfloat16")


@pytest.mark.parametrize("dname", XBD_STEP_DTYPES)
def test_xbd_step_on_two_ranks_equals_one_process(xbd_launch, dname):
    """One ``XBDTrainer.train_step`` (``--task damage``) of ``xbd_dahitra``
    at 64 px, a joined batch of 2 (one row a rank), against one process on
    the joined batch: loss 1e-5 relative, gradients 1e-4 of the whole
    gradient's scale, statistics 1e-5 of scale in fp32; 2e-2, 6e-2 and
    2e-2 in bf16 (chip_smoke.py phase 19c's bounds). Both ranks end with the
    same gradients and running statistics."""
    ones, ranks = xbd_launch
    i = 3 + XBD_STEP_DTYPES.index(dname)
    one = ones[i]
    l_tol, g_tol, s_tol = ((1e-5, 1e-4, 1e-5) if dname == "float32"
                           else (2e-2, 6e-2, 2e-2))
    for r in ranks:
        got = r[i]
        torch.testing.assert_close(got["loss"], one["loss"], rtol=l_tol,
                                   atol=0)
        assert _grad_err(got["grads"], one["grads"]) <= g_tol
        assert max(_scaled(got["stats"][k], one["stats"][k])
                   for k in one["stats"]) <= s_tol
        assert got["launches"] == one["launches"]
    assert _stats_equal(ranks[0][i]["stats"], ranks[1][i]["stats"])
    assert _stats_equal(ranks[0][i]["grads"], ranks[1][i]["grads"])


def test_xbd_trainer_refuses_a_batch_the_ranks_do_not_split(tmp_path):
    args = argparse.Namespace(**_xbd_cfg(tmp_path, "xbd_res34_double", 32, 3,
                                         3))
    arrays = _xbd_arrays(4, 32, 0)
    with pytest.raises(ValueError, match="must be a multiple of the mesh"):
        XBDTrainer(args, arrays, arrays, device="cpu",
                   mesh=Mesh(0, 2, torch.device("cpu"), "gloo"))


# ------------------------------------------------------ launch 4: the CLI

def test_main_cd_trains_on_two_cpu_ranks(tmp_path, monkeypatch):
    """``main_cd --gpu_ids 0,1 --device cpu``: one epoch and the test pass
    through the spawning CLI; only rank 0 writes log.txt (its lines once)."""
    root = tmp_path / "data"
    write_synthetic_levir(str(root), n_tiles=3, size=32, split="train",
                          seed=1, block=8)
    write_synthetic_levir(str(root), n_tiles=3, size=32, split="val",
                          seed=2, block=8)
    monkeypatch.setenv("DAHITRA_DATA_ROOT", str(root))
    history = main_cd.main([
        "--checkpoint_root", str(tmp_path / "ckpt"), "--project_name", "two",
        "--net_G", "base_resnet18", "--img_size", "32", "--batch_size", "2",
        "--max_epochs", "1", "--device", "cpu", "--gpu_ids", "0,1"])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    d = tmp_path / "ckpt" / "two"
    for f in ("best_ckpt.pt", "log.txt", "train_acc.npy", "val_acc.npy",
              "log_test.txt", "scores_dict.npy"):
        assert (d / f).exists(), f
    log = (d / "log.txt").read_text()
    assert log.count("gpu_ids: 0,1") == 1
    assert len(re.findall(r"Is_training: True. Epoch 0", log)) == 1
    assert (d / "log_test.txt").read_text().count("Begin evaluation") == 1
