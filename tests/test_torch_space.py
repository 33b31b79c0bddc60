"""The port's ``space`` axis (``nn/space.py``, ``core/mesh.py`` grids, the
rank-split K3) against the JAX package and against one process, with gloo
ranks on the CPU.

Every multi-rank check spawns its ranks through ``core.mesh.launch`` with
``n_space``; the ranks run ``dahitra_tpu_torch/tools/space_checks.py`` and
``tools/mesh_checks.py``, which import no JAX, on one thread each, and each
launch has a time limit of its own. The one-process references run in the
test's process, the JAX ones on the virtual CPU devices of
``tests/conftest.py``; the JAX Pallas K3 runs in interpret mode, as
tests/test_pallas.py runs it.

Tolerances, scale-normalized (the largest difference over the reference's
largest element; gradients over the whole gradient's): against one process,
fp32 forwards 1e-5 and gradients 1e-4 (or ROADMAP rule 5 where a test says
so), bf16 2e-2 and 6e-2; against JAX, the bounds of the one-process test of
the same function (tests/test_torch_tokenizer.py: tokens 1e-5 / 2e-2,
gradients 1e-4 / 6e-2; tests/test_torch_bit.py: ``base_resnet18`` logits
1e-4; tests/test_torch_xbd_tasks.py: the ResNet34 UNet's logits 1e-5 and a
step's loss 1e-5 relative; tests/test_torch_dahitra.py: ``newUNetTrans``'s
logits 1e-4, its train step's loss 1e-5 relative, statistics 1e-4 and
gradients 1e-3 of scale, in bf16 the loss 2e-2 relative and the gradients'
cosine 0.99; tests/test_torch_xbd.py: ``xbd_dahitra``'s train step, loss
1e-5 relative, statistics 1e-4, gradients 1e-3 of scale or the median of
JAX's own moves under four 1e-6 input moves where larger). The ranks'
tokens must agree bit for bit.
"""
import argparse
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import dahitra_tpu.pallas.fused_tokenizer as jft
from dahitra_tpu.core.mesh import (batch_sharding, make_mesh,
                                   mesh_from_gpu_ids)
from dahitra_tpu.losses.cd import levir_train_loss as jax_levir_train_loss
from dahitra_tpu.losses.combo import xbd_damage_loss as jax_xbd_damage_loss
from dahitra_tpu.models.registry import define_g as jax_define_g
from dahitra_tpu.nn.blocks import SemanticTokenizer as JaxTokenizer
from dahitra_tpu_torch.core.flax_import import (flax_to_state_dict,
                                                res34_unet_flax_to_state_dict,
                                                resnet_cd_flax_to_state_dict)
from dahitra_tpu_torch.core.mesh import (Mesh, devices_from_gpu_ids, launch,
                                         shard_batch)
from dahitra_tpu_torch.kernels import fused_tokenizer as ft
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.nn import space
from dahitra_tpu_torch.nn.init import init_random
from dahitra_tpu_torch.tools import mesh_checks, space_checks
from dahitra_tpu_torch.train.engine import CDTrainer

TWO = ["cpu", "cpu"]
LIMIT = 240  # seconds, per launch
IMG = 64


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """The ranks and the one-process references on one thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launch(cases, devices=TWO, n_space=2):
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        return launch(space_checks.run_cases, (cases,), devices=devices,
                      timeout=LIMIT, n_space=n_space)
    finally:
        os.environ.pop("OMP_NUM_THREADS", None)


def _scaled(got, ref):
    got, ref = (np.asarray(v, np.float32) for v in (got, ref))
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def _grad_err(got: dict, ref: dict) -> float:
    assert got.keys() == ref.keys()
    scale = max(float(v.abs().max()) for v in ref.values())
    return max(float((got[k] - ref[k]).abs().max()) for k in ref) / scale


def _stats_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------- the grid, no ranks

GRIDS = [("0,1,2,3", 2), ("0,1,2", 2), ("0", 4), ("0,1,2,3,4,5,6,7", 4),
         ("0,1,2,3,4", 2), ("0,5,9", 3)]


@pytest.mark.parametrize("ids,n_space", GRIDS)
def test_devices_from_gpu_ids_take_n_space_as_mesh_from_gpu_ids(ids, n_space,
                                                               capsys):
    """With 8 visible devices: the kept devices and the grid's (n_data,
    n_space) those of the JAX mesh, and the same warnings (the "not
    divisible by n_space" one naming the devices kept) on stdout."""
    want = mesh_from_gpu_ids(ids, n_space=n_space)
    want_out = capsys.readouterr().out
    got = devices_from_gpu_ids(ids, "cuda", visible=8, n_space=n_space)
    assert capsys.readouterr().out == want_out
    assert len(got) == want.devices.size
    n_sp = min(n_space, len(got))
    assert (len(got) // n_sp, n_sp) == tuple(want.devices.shape)
    assert [d.index for d in got] == [d.id for d in want.devices.ravel()]
    if ids == "0,1,2":
        assert "not divisible by n_space=2; using the first 2" in want_out


@pytest.mark.parametrize("spatial", [False, True])
def test_shard_batch_matches_batch_sharding_on_a_2x2_mesh(spatial):
    """Each rank's part of a (4, 8, 6, 3) batch: the shard that
    ``batch_sharding(mesh, spatial)`` places on the device at the rank's
    (data, space) position of a 2 x 2 JAX mesh (space fastest)."""
    x = np.arange(4 * 8 * 6 * 3, dtype=np.float32).reshape(4, 8, 6, 3)
    valid = np.array([True, True, False, True])
    mesh = make_mesh(n_data=2, n_space=2, devices=jax.devices()[:4])
    index = batch_sharding(mesh, spatial).devices_indices_map(x.shape)
    for rank in range(4):
        m = Mesh(rank, 4, torch.device("cpu"), "gloo", n_space=2)
        part = shard_batch({"x": x, "valid": valid, "n": 3}, m, spatial)
        want = x[index[mesh.devices[m.data_rank, m.space_rank]]]
        np.testing.assert_array_equal(part["x"], want)
        np.testing.assert_array_equal(
            part["valid"], valid[2 * m.data_rank:2 * m.data_rank + 2])
        assert part["n"] == 3 and m.shard == (rank // 2, 2)
    with pytest.raises(ValueError, match="rows do not split"):
        shard_batch({"x": x[:, :7]}, Mesh(0, 4, torch.device("cpu"), "gloo",
                                          n_space=2), spatial=True)


def test_epoch_perm_covers_every_data_shard_on_a_4x2_grid():
    """tests/test_sharding.py::test_scan_epoch_covers_all_shards_on_mixed_
    mesh: on a 4 x 2 grid the staged set shards over the 4 data ranks, and
    every data shard's columns cover all of its 8 local rows in the epoch
    (with the world size of 8 each would cover 4)."""
    tr = CDTrainer.__new__(CDTrainer)
    tr.args = argparse.Namespace(seed=0)
    tr.mesh = Mesh(3, 8, torch.device("cpu"), "gloo", n_space=2)
    tr._staged_n = 32
    assert tr.mesh.n_data == 4 and tr.mesh.shard == (1, 4)
    bs = 8
    perm = tr._epoch_perm(0, 32 // bs, bs)
    assert perm.shape == (4, bs)
    per = bs // 4
    for d in range(4):
        block = perm[:, d * per:(d + 1) * per]
        assert sorted(block.ravel().tolist()) == list(range(8))


@pytest.mark.parametrize("net_g,img,n_space,stride", [
    ("newUNetTrans", 48, 2, 16), ("xbd_res34_double", 64, 4, 32),
    ("base_resnet18", 40, 2, 8)])
def test_misaligned_rows_raise_naming_the_stride(net_g, img, n_space, stride):
    """Rows per rank that are not a multiple of the model's total stride
    pass the row split that every row-sharded step and forward goes through
    (``space.shard_rows``): each rank gets its rows, and the levels that
    the strides do not split run whole (tests/test_torch_space_uneven.py
    holds these sizes against JAX and one process). What raises, before any
    collective: rows that do not split over the ranks at the input (as the
    JAX package's ``device_put`` refuses them), and, by name, a model that
    does not run on row-sharded batches."""
    model = define_g(net_g, img_size=img)
    mesh = Mesh(0, n_space, torch.device("cpu"), "gloo", n_space=n_space)
    x = torch.zeros(1, img, img, 6 if net_g.startswith("xbd") else 3)
    assert (img // n_space) % stride
    with space.grid(mesh, spatial=True):
        got, = space.shard_rows(model, x)
        assert got.shape[1] == img // n_space
        with pytest.raises(ValueError, match=f"{img - 1} rows do not split "
                                             f"over {n_space} space ranks"):
            space.shard_rows(model, x[:, 1:])
        with torch.device("meta"):
            refused = define_g("xbd_seresnext50_loc", img_size=img)
        with pytest.raises(ValueError, match="does not run on row-sharded"):
            space.shard_rows(refused, x)


def test_ranks_plain_matches_one_rank_and_the_kernel_algorithm():
    """``semantic_tokenizer_ranks_plain`` over 1 rank is the split plain
    version bit for bit; over 3 ranks of uneven pixels it holds to the
    plain tokenizer (1e-5)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.normal(size=(2, 600, 32)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(32, 4)) * 32 ** -0.5).astype(
        np.float32))
    assert torch.equal(ft.semantic_tokenizer_ranks_plain([x], w, 128),
                       ft.semantic_tokenizer_split_plain(x, w, 128))
    got = ft.semantic_tokenizer_ranks_plain(
        [x[:, :256], x[:, 256:512], x[:, 512:]], w, 128)
    assert _scaled(got, ft.semantic_tokenizer_plain(x, w)) <= 1e-5


# ------------------------------------- launch 1: halo ops, rank-split K3

def _halo_case(op, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 32, 12, 4)).astype(np.float32)
    w = None
    if op in space_checks.CONVS:
        k = space_checks.CONVS[op][0]
        w = (rng.normal(size=(5, 4, k, k)) / k).astype(np.float32)
    y = space_checks.halo_op(op, torch.from_numpy(x),
                             None if w is None else torch.from_numpy(w))
    return (op, x, rng.normal(size=tuple(y.shape)).astype(np.float32), w)


K3_DTYPES = ("float32", "bfloat16")


def _k3_case(dname, seed):
    return (2, 16, 12, 4, seed, dname)


@pytest.fixture(scope="module")
def small_launch():
    halo = [_halo_case(op, i) for i, op in enumerate(space_checks.HALO_OPS)]
    k3 = [_k3_case(d, 10 + i) for i, d in enumerate(K3_DTYPES)]
    ranks = _launch([("halo_ops", (halo,)), ("k3_ranks", (k3,)),
                     ("grid_of", ())])
    return halo, k3, ranks


@pytest.mark.parametrize("op", space_checks.HALO_OPS)
def test_halo_op_matches_the_unsharded_op(small_launch, op):
    """3x3/s1, 3x3/s2, the 7x7/s2 stem, 1x1/s2, the 3x3/s2 max-pool and the
    x4 bilinear resize on two ranks of 16 rows each: the ranks' outputs
    joined 1e-5 of the unsharded op's, the gradient of sum(y * dy) with
    respect to x and the weight 1e-4; every rank holds only its rows."""
    halo, _, ranks = small_launch
    i = space_checks.HALO_OPS.index(op)
    _, x, dy, w = halo[i]
    one = space_checks.halo_ops(None, [halo[i]])[0]
    for r in ranks:
        assert r[0][i]["y"].shape[1] * 2 == one["y"].shape[1]
        assert r[0][i]["dx"].shape[1] == x.shape[1] // 2
    assert _scaled(torch.cat([r[0][i]["y"] for r in ranks], 1),
                   one["y"]) <= 1e-5
    assert _scaled(torch.cat([r[0][i]["dx"] for r in ranks], 1),
                   one["dx"]) <= 1e-4
    if w is not None:
        assert _scaled(ranks[0][0][i]["dw"], one["dw"]) <= 1e-4


def _jax_tokens(x, w, dt, dname):
    jdt = jnp.float32 if dname == "float32" else jnp.bfloat16
    mod = JaxTokenizer(4, dtype=jdt)
    ref, vjp = jax.vjp(
        lambda x_, k_: mod.apply({"params": {"conv_token": {"kernel": k_}}},
                                 x_),
        jnp.asarray(x, jdt), jnp.asarray(w.reshape(1, 1, 32, 4)))
    rdx, rdk = vjp(jnp.asarray(dt, ref.dtype))
    return (np.asarray(ref, np.float32), np.asarray(rdx, np.float32),
            np.asarray(rdk, np.float32).reshape(32, 4))


@pytest.mark.parametrize("dname", K3_DTYPES)
def test_rank_split_k3_matches_flax_and_pallas(small_launch, dname,
                                               monkeypatch):
    """The rank-split K3 (its plain version on the CPU) over two ranks of
    8 of 16 rows: the same tokens bit for bit on both ranks; tokens against
    the flax ``SemanticTokenizer`` and the Pallas K3 in interpret mode
    (1e-5 / 2e-2), the ranks' joined pixel gradients and summed dw against
    ``jax.vjp`` of the flax module (1e-4 / 6e-2); one process's
    ``semantic_tokenizer_ranks_plain`` of the two ranks' pixels equal to the
    ranks' tokens."""
    _, k3, ranks = small_launch
    i = K3_DTYPES.index(dname)
    x, w, dt = space_checks.k3_inputs(*k3[i][:5])
    tol, gtol = (1e-5, 1e-4) if dname == "float32" else (2e-2, 6e-2)
    got = [r[1][i] for r in ranks]
    assert torch.equal(got[0]["tokens"], got[1]["tokens"])
    ref, rdx, rdw = _jax_tokens(x, w, dt, dname)
    assert _scaled(got[0]["tokens"].float(), ref) <= tol
    orig = jft.pl.pallas_call
    monkeypatch.setattr(jft.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    jdt = jnp.float32 if dname == "float32" else jnp.bfloat16
    pallas = jft.fused_semantic_tokenizer(
        jnp.asarray(x.reshape(2, -1, 32), jdt), jnp.asarray(w),
        precise=dname == "float32")
    assert _scaled(got[0]["tokens"].float(), np.asarray(pallas, np.float32)
                   ) <= tol
    dx = torch.cat([g["dx"].float() for g in got], 1)
    assert _scaled(dx, rdx) <= gtol
    assert _scaled(got[0]["dw"].float() + got[1]["dw"].float(), rdw) <= gtol
    tdt = getattr(torch, dname)
    xt = torch.from_numpy(x).to(tdt)
    halves = [xt[:, :8].reshape(2, -1, 32), xt[:, 8:].reshape(2, -1, 32)]
    plain = ft.semantic_tokenizer_ranks_plain(
        halves, torch.from_numpy(w).to(tdt), 8 * 12)
    assert torch.equal(plain, got[0]["tokens"])
    assert ranks[0][1][-1] == {k: 0 for k in ranks[0][1][-1]}  # the CPU


def test_grid_places_two_ranks_on_one_data_row(small_launch):
    """n_data 1, n_space 2: both ranks in one space group, each its own
    data group, the shard (0, 1)."""
    _, _, ranks = small_launch
    for r, got in enumerate(g[2] for g in ranks):
        assert got["space_rank"] == r and got["data_rank"] == 0
        assert got["space_members"] == [0, 1]
        assert got["data_members"] == [r] and got["shard"] == (0, 1)


# ------------------------------------- launch 2: models, steps, replicated

CONVERT = {"base_resnet18": resnet_cd_flax_to_state_dict,
           "xbd_res34_double": res34_unet_flax_to_state_dict,
           "newUNetTrans": flax_to_state_dict,
           "xbd_dahitra": functools.partial(flax_to_state_dict, xbd=True)}


def _flax(key, seed):
    """(inputs, state_dict, variables) of a seeded flax model at 64 px,
    batch 2: every leaf drawn from numpy, or for the DAHiTra models, as
    their one-process tests take them (tests/test_torch_dahitra.py,
    tests/test_torch_xbd.py), the flax init with perturbed biases and
    statistics."""
    rng = np.random.RandomState(seed)
    six = key.startswith("xbd")
    x1 = rng.uniform(-1, 1, (2, IMG, IMG, 6 if six else 3)).astype(np.float32)
    x2 = None if six else rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(
        np.float32)
    model = jax_define_g(key, img_size=IMG)
    args = (x1,) if six else (x1, x2)
    init = jax.jit(lambda *a: model.init(jax.random.PRNGKey(0), *a))
    dahitra = key in ("newUNetTrans", "xbd_dahitra")
    leaves = init(*args) if dahitra else jax.eval_shape(init, *args)
    flat = {}
    for k, s in traverse_util.flatten_dict(leaves).items():
        if dahitra:
            v = np.asarray(s)
            if k[-1] in ("bias", "mean"):
                v = v + 0.1 * rng.normal(size=v.shape)
            elif k[-1] == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
        elif k[-1] == "kernel":
            v = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif k[-1] == "scale":
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
        elif k[-1] == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = 0.1 * rng.normal(size=s.shape)
        flat[k] = v.astype(np.float32)
    v = traverse_util.unflatten_dict(flat)
    inputs = {"x": x1} if six else {"a": x1, "b": x2}
    return inputs, CONVERT[key](v["params"], v["batch_stats"]), v


def _seeded(net_g, seed):
    model = define_g(net_g, img_size=IMG)
    init_random(model, torch.Generator().manual_seed(seed))
    return model.state_dict()


def _cd_arrays(n, s, seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.randint(0, 256, (n, s, s, 3)).astype(np.uint8),
            "b": rng.randint(0, 256, (n, s, s, 3)).astype(np.uint8),
            "label": rng.randint(0, 2, (n, s, s)).astype(np.uint8)}


def _xbd_arrays(n, s, seed):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, 255, (n, s, s, 3), dtype=np.uint8)
    post = pre.copy()
    post[:, : s // 2, : s // 2] = 255 - post[:, : s // 2, : s // 2]
    return {"img_pre": pre, "img_post": post,
            "msk": rng.integers(0, 2, (n, s, s, 5)).astype(np.uint8),
            "lbl_msk": rng.integers(0, 4, (n, s, s)).astype(np.uint8)}


def _cfg(tmp, tag, net, bs, **kw):
    os.makedirs(tmp / tag, exist_ok=True)
    return dict(n_class=2, checkpoint_dir=str(tmp / tag), max_epochs=1,
                net_G=net, img_size=IMG, lr=1e-3, batch_size=bs,
                lr_policy="linear", device="cpu", seed=0, **kw)


MODEL_CASES = ("dahitra_forward", "resnet_forward", "res34_loss",
               "dahitra_loss", "dahitra_loss_bf16", "xbd_dahitra_loss",
               "dahitra_step", "dahitra_step_bf16", "xbd_dahitra_step",
               "resnet_replicated", "eval_rows", "eval_replicated")


@pytest.fixture(scope="module")
def model_launch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("space")
    rng = np.random.default_rng(0)
    dah_in, dah_sd, dah_v = _flax("newUNetTrans", 0)
    dah_in["label"] = (rng.random((2, IMG, IMG)) < 0.3).astype(np.uint8)
    res_in, res_sd, res_v = _flax("base_resnet18", 1)
    r34_in, r34_sd, r34_v = _flax("xbd_res34_double", 2)
    r34_in["masks"] = rng.integers(0, 2, (2, IMG, IMG, 5)).astype(np.uint8)
    xd_in, xd_sd, xd_v = _flax("xbd_dahitra", 8)
    xd_in["x"][..., 3:] *= 0.5  # a changed scene (tests/test_torch_xbd.py)
    xd_in["masks"] = (rng.random((2, IMG, IMG, 5)) < 0.3).astype(np.uint8)
    cases = [
        ("forward_rows", ("newUNetTrans", IMG, dah_sd, dah_in)),
        ("forward_rows", ("base_resnet18", IMG, res_sd, res_in)),
        ("forward_rows", ("xbd_res34_double", IMG, r34_sd, r34_in,
                          "float32", True, "damage")),
        ("forward_rows", ("newUNetTrans", IMG, dah_sd, dah_in, "float32",
                          True, "levir")),
        ("forward_rows", ("newUNetTrans", IMG, dah_sd, dah_in, "bfloat16",
                          True, "levir")),
        ("forward_rows", ("xbd_dahitra", IMG, xd_sd, xd_in, "float32", True,
                          "damage")),
        ("cd_steps", (_cfg(tmp, "d32", "newUNetTrans", 2),
                      _cd_arrays(2, IMG, 3), 1, None, True)),
        ("cd_steps", (_cfg(tmp, "d16", "newUNetTrans", 2, bf16=True),
                      _cd_arrays(2, IMG, 3), 1, None, True)),
        ("xbd_steps", ({**_cfg(tmp, "x32", "xbd_dahitra", 2),
                        "val_batch_size": 2}, _xbd_arrays(2, IMG, 4), 1,
                       "damage", 1, True)),
        ("cd_steps", (_cfg(tmp, "rep", "base_resnet18", 2),
                      _cd_arrays(2, IMG, 5), 1, None, False))]
    ev_cfg = _cfg(tmp, "ev", "newUNetTrans", 2)
    ev_sd = _seeded("newUNetTrans", 6)
    ev_arrays = _cd_arrays(3, IMG, 6)
    cases += [("cd_eval", (ev_cfg, ev_arrays, ev_sd, np.array([0, 0, 1]),
                           spatial)) for spatial in (True, False)]
    ranks = _launch(cases)
    return cases, ranks, {"resnet": res_v, "res34": r34_v,
                          "newUNetTrans": dah_v, "xbd_dahitra": xd_v}


def _case_args(model_launch, name):
    return model_launch[0][MODEL_CASES.index(name)][1]


def _case(model_launch, name):
    cases, ranks, flax_vars = model_launch
    i = MODEL_CASES.index(name)
    fn = getattr(space_checks, cases[i][0], None) or getattr(
        mesh_checks, cases[i][0])
    return cases[i][1], fn(None, *cases[i][1]), [r[i] for r in ranks], \
        flax_vars


def test_row_sharded_dahitra_forward_equals_one_process(model_launch):
    """``newUNetTrans`` eval forward at 64 px, batch 2, with seeded flax
    weights, rows split over two ranks: the gathered logits against the
    flax model (1e-4) and 1e-5 of one process's; every 4-D activation and
    every decoder stack's output on a rank holds half the rows of one
    process's, everything else (tokens, the encoder's) the same shape."""
    (_, _, _, inputs), one, got, flax_vars = _case(model_launch,
                                                   "dahitra_forward")
    v = flax_vars["newUNetTrans"]
    ref = np.asarray(jax.jit(lambda p, s, a, b: jax_define_g(
        "newUNetTrans", img_size=IMG).apply(
            {"params": p, "batch_stats": s}, a, b, False))(
        v["params"], v["batch_stats"], inputs["a"], inputs["b"]))
    sharded = 0
    for g in got:
        assert _scaled(g["whole"], ref) <= 1e-4
        assert _scaled(g["whole"], one["logits"]) <= 1e-5
        assert g["logits"].shape[1] * 2 == one["logits"].shape[1]
        assert g["shapes"].keys() == one["shapes"].keys()
        for name, shape in one["shapes"].items():
            mine = g["shapes"][name]
            half = (mine[0], mine[1] * 2, *mine[2:]) == shape
            if len(shape) == 4 or (name.startswith("transformer_decoder")
                                   and "." not in name):
                assert half, name
            else:  # tokens and the encoder whole; pixel-wise parts halved
                assert half or mine == shape, name
            sharded += half
    assert sharded > 40


def test_row_sharded_resnet18_forward_matches_jax(model_launch):
    """tests/test_sharding.py::test_spatial_sharding_forward: ``base_
    resnet18`` at 64 px, batch 2, rows over two ranks: the gathered logits
    against the flax model (1e-4) and one process (1e-5)."""
    (_, _, _, inputs), one, got, flax_vars = _case(model_launch,
                                                   "resnet_forward")
    v = flax_vars["resnet"]
    ref = np.asarray(jax.jit(lambda p, s, a, b: jax_define_g(
        "base_resnet18").apply({"params": p, "batch_stats": s}, a, b, False))(
        v["params"], v["batch_stats"], inputs["a"], inputs["b"]))
    for g in got:
        assert _scaled(g["whole"], ref) <= 1e-4
        assert _scaled(g["whole"], one["logits"]) <= 1e-5


def test_row_sharded_res34_double_train_loss_matches_jax(model_launch):
    """tests/test_sharding.py::test_xbd_train_step_spatial_mesh, with 2
    space ranks (4 would leave 16 rows a rank, under the stride of 32):
    ``xbd_res34_double``'s train-mode forward at 64 px, batch 2, and the
    damage loss of the gathered logits, against flax (logits 1e-5, loss
    1e-5 relative) and one process (running statistics 1e-5, both ranks
    equal; gradients averaged over the ranks max(1e-4, rule 5: the median
    of one process's own moves under four 1e-6 input moves): the trunk's
    1/32 maps are 2 x 2, whose BatchNorm sums the split rows round another
    way)."""
    (_, _, _, inputs, *_), one, got, flax_vars = _case(model_launch,
                                                       "res34_loss")
    v = flax_vars["res34"]

    def jloss(p):
        logits, _ = jax_define_g("xbd_res34_double", img_size=IMG).apply(
            {"params": p, "batch_stats": v["batch_stats"]},
            jnp.asarray(inputs["x"]), None, True, mutable=["batch_stats"])
        return jax_xbd_damage_loss(logits.astype(jnp.float32),
                                   jnp.asarray(inputs["masks"], jnp.float32)
                                   ), logits

    (ref_loss, ref_logits) = jax.jit(jloss)(v["params"])
    args = _case_args(model_launch, "res34_loss")
    moves = []
    for i in range(4):
        noise = np.random.default_rng(100 + i).normal(size=inputs["x"].shape)
        moved = {**inputs, "x": inputs["x"] + (1e-6 * noise).astype(
            np.float32)}
        moves.append(_grad_err(space_checks.forward_rows(
            None, *args[:3], moved, *args[4:])["grads"], one["grads"]))
    bound = max(1e-4, float(np.median(moves)))
    for g in got:
        assert _scaled(g["whole"], np.asarray(ref_logits)) <= 1e-5
        assert abs(float(g["loss"]) - float(ref_loss)) <= 1e-5 * abs(
            float(ref_loss))
        assert _grad_err(g["grads"], one["grads"]) <= bound
        assert max(_scaled(g["stats"][k], one["stats"][k])
                   for k in one["stats"]) <= 1e-5
    assert _stats_equal(got[0]["stats"], got[1]["stats"])


@functools.lru_cache(maxsize=None)
def _jax_loss_step(key, dname):
    """``jax.value_and_grad`` of the flax model's train-mode forward and
    its loss (``levir_train_loss`` for ``newUNetTrans``, the damage loss
    for ``xbd_dahitra``), jitted: (params, stats, inputs) -> (loss, (logits,
    new batch_stats)), grads."""
    dtype = jnp.float32 if dname == "float32" else jnp.bfloat16
    model = jax_define_g(key, img_size=IMG, dtype=dtype)

    def loss_fn(p, stats, inputs):
        xs = ((inputs["x"].astype(dtype), None) if "x" in inputs else
              (inputs["a"].astype(dtype), inputs["b"].astype(dtype)))
        logits, mut = model.apply({"params": p, "batch_stats": stats}, *xs,
                                  True, mutable=["batch_stats"])
        logits = logits.astype(jnp.float32)
        if "x" in inputs:
            loss = jax_xbd_damage_loss(logits, inputs["masks"].astype(
                jnp.float32))
        else:
            loss = jax_levir_train_loss(logits, inputs["label"],
                                        inputs["label"].shape[0])
        return loss, (logits, mut["batch_stats"])

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("name", ["dahitra_loss", "dahitra_loss_bf16",
                                  "xbd_dahitra_loss"])
def test_row_sharded_dahitra_train_loss_matches_jax(model_launch, name):
    """The train-mode forward of ``newUNetTrans`` (fp32 and bf16, with
    ``levir_train_loss``) and of ``xbd_dahitra`` (fp32, the damage loss on
    a changed scene) at 64 px, batch 2, seeded flax weights, rows split
    over two ranks (K3 split over them, K1-save and K2 on each rank's
    rows): the loss of the gathered logits, the gradients averaged over the
    ranks and the running statistics against ``jax.value_and_grad`` of the
    flax model on the whole batch, at the bounds of the one-process tests
    (module docstring; ``xbd_dahitra``'s gradients under its rule, four
    1e-6 moves of JAX's input), and against the port's one process (fp32:
    loss 1e-5 relative, gradients 1e-4 of scale, statistics 1e-5; bf16
    2e-2, 6e-2, 2e-2; ``xbd_dahitra``'s gradients max(1e-4, rule 5: the
    median of one process's own moves under the same four input moves), as
    ReLU inputs within rounding of zero flip); both ranks with the same
    gradient and statistics bits."""
    (net_g, _, _, inputs, dname, *_), one, got, flax_vars = _case(
        model_launch, name)
    v = flax_vars[net_g]
    convert = CONVERT[net_g]
    step = _jax_loss_step(net_g, dname)
    (ref_loss, (_, ref_stats)), ref_grads = step(
        v["params"], v["batch_stats"], inputs)
    want = convert(jax.tree.map(np.asarray, ref_grads), v["batch_stats"])
    want = {k: want[k] for k in one["grads"]}
    new_stats = convert(v["params"], jax.tree.map(np.asarray, ref_stats))
    assert len(want) == (314 if net_g == "newUNetTrans" else 310)
    bf16 = dname == "bfloat16"
    l_tol, g_tol, s_tol = (2e-2, 6e-2, 2e-2) if bf16 else (1e-5, 1e-4, 1e-5)
    bound = 1e-3
    if net_g == "xbd_dahitra":  # the rule, on JAX and on the one process
        jax_moves, own_moves = [], []
        args = _case_args(model_launch, name)
        for i in range(4):
            moved = {**inputs, "x": inputs["x"] + (1e-6 * np.random.RandomState(
                100 + i).normal(size=inputs["x"].shape)).astype(np.float32)}
            m = convert(jax.tree.map(np.asarray, step(
                v["params"], v["batch_stats"], moved)[1]), v["batch_stats"])
            jax_moves.append(_grad_err({k: m[k] for k in want}, want))
            own_moves.append(_grad_err(space_checks.forward_rows(
                None, *args[:3], moved, *args[4:])["grads"], one["grads"]))
        bound = max(bound, float(np.median(jax_moves)))
        g_tol = max(g_tol, float(np.median(own_moves)))
    for g in got:
        grads = {k: t.float() for k, t in g["grads"].items()}
        assert grads.keys() == want.keys()
        if bf16:
            assert abs(float(g["loss"]) - float(ref_loss)) <= 2e-2 * abs(
                float(ref_loss))
            a = torch.cat([grads[k].ravel() for k in want])
            b = torch.cat([want[k].ravel() for k in want])
            assert float(a @ b / (a.norm() * b.norm())) >= 0.99
        else:
            assert abs(float(g["loss"]) - float(ref_loss)) <= 1e-5 * abs(
                float(ref_loss))
            assert _grad_err(grads, want) <= bound
            for k, t in g["stats"].items():
                r = new_stats[k]
                assert float((t - r).abs().max()) <= 1e-4 * max(
                    float(r.abs().max()), 1e-3), k
        torch.testing.assert_close(g["loss"], one["loss"], rtol=l_tol, atol=0)
        assert _grad_err(g["grads"], one["grads"]) <= g_tol
        assert max(_scaled(g["stats"][k], one["stats"][k])
                   for k in one["stats"]) <= s_tol
    assert _stats_equal(got[0]["stats"], got[1]["stats"])
    assert _stats_equal(got[0]["grads"], got[1]["grads"])


@pytest.mark.parametrize("name", ["dahitra_step", "dahitra_step_bf16",
                                  "xbd_dahitra_step"])
def test_row_sharded_train_step_equals_one_process(model_launch, name):
    """``CDTrainer.train_step(spatial=True)`` of ``newUNetTrans`` at 64 px,
    batch 2, fp32 and bf16, and ``XBDTrainer.train_step(spatial=True)``
    (damage) of ``xbd_dahitra`` at 64 px, batch 2 (a changed post quarter),
    on two ranks of 32 rows against one process's step on the whole batch:
    loss 1e-5 relative, gradients 1e-4 of scale, statistics 1e-5 (bf16
    2e-2, 6e-2, 2e-2); the same confusion matrix; both ranks with the same
    gradients and statistics bits."""
    _, one, got, _ = _case(model_launch, name)
    bf16 = name.endswith("bf16")
    l_tol, g_tol, s_tol = (2e-2, 6e-2, 2e-2) if bf16 else (1e-5, 1e-4, 1e-5)
    for g in got:
        torch.testing.assert_close(g["loss"], one["loss"], rtol=l_tol, atol=0)
        assert _grad_err(g["grads"], one["grads"]) <= g_tol
        assert max(_scaled(g["stats"][k], one["stats"][k])
                   for k in one["stats"]) <= s_tol
        if "cm" in one and not bf16:
            assert torch.equal(g["cm"], one["cm"])
    assert _stats_equal(got[0]["stats"], got[1]["stats"])
    assert _stats_equal(got[0]["grads"], got[1]["grads"])


def test_replicated_grid_step_equals_one_process(model_launch):
    """``spatial=False`` on the 1 x 2 grid (the epoch loops' placement):
    both space ranks run the whole batch; BatchNorm sums over the data
    group, so each sample counts once in the statistics and their
    gradient: ``base_resnet18``'s step equal to one process's (loss 1e-5,
    gradients 1e-4, statistics 1e-5)."""
    _, one, got, _ = _case(model_launch, "resnet_replicated")
    for g in got:
        torch.testing.assert_close(g["loss"], one["loss"], rtol=1e-5, atol=0)
        assert _grad_err(g["grads"], one["grads"]) <= 1e-4
        assert max(_scaled(g["stats"][k], one["stats"][k])
                   for k in one["stats"]) <= 1e-5
        assert torch.equal(g["cm"], one["cm"])


@pytest.mark.parametrize("name", ["eval_rows", "eval_replicated"])
def test_grid_evaluation_equals_one_process(model_launch, name):
    """``CDEvaluator.eval_models`` of ``newUNetTrans`` over 3 pairs at
    batch 2 (a ragged last batch) with per-patch groups on the 1 x 2 grid,
    row-sharded and replicated: the summed matrix, the per-group scores and
    the pairs counted those of one process, each sample counted once."""
    _, one, got, _ = _case(model_launch, name)
    for g in got:
        assert torch.equal(g["cm"], one["cm"])
        assert int(g["cm"].sum()) == 3 * IMG * IMG
        assert g["scores"]["per_group"] == one["scores"]["per_group"]


# -------------------------------------------------- launch 3: a 2 x 2 grid

@pytest.fixture(scope="module")
def grid_launch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    cfg = {**_cfg(tmp, "g", "base_resnet18", 4), "img_size": 32}
    arrays = _cd_arrays(4, 32, 7)
    ranks = _launch([("grid_of", ()),
                     ("cd_steps", (cfg, arrays, 1, None, True))],
                    devices=["cpu"] * 4)
    return cfg, arrays, ranks


def test_two_by_two_grid_groups_and_row_sharded_step(grid_launch):
    """Four ranks, n_data 2, n_space 2 (space fastest): each rank's groups
    hold the ranks of its data row and of its space column; a row-sharded
    ``base_resnet18`` step at 32 px, batch 4 (each rank 2 samples, 16 rows)
    against one process on the batch (loss 1e-5 relative, the confusion
    matrix exactly, statistics 1e-5; gradients max(1e-4, rule 5: the median
    of the one-process step's own moves under four 1e-6 input moves, as
    tests/test_torch_mesh.py bounds this model's split batch)); all four
    ranks equal."""
    cfg, arrays, ranks = grid_launch
    for rank, r in enumerate(ranks):
        g = r[0]
        d, s = divmod(rank, 2)
        assert (g["data_rank"], g["space_rank"], g["shard"]) == (d, s, (d, 2))
        assert g["space_members"] == [2 * d, 2 * d + 1]
        assert g["data_members"] == [s, 2 + s]
    one = mesh_checks.cd_steps(None, cfg, arrays, 1)
    moves = []
    from dahitra_tpu_torch.train import engine
    aug = engine.augment_pairs
    try:
        for i in range(4):
            gen = torch.Generator().manual_seed(100 + i)

            def moved(*a, **k):
                x, y, lab = aug(*a, **k)
                return (x + 1e-6 * torch.randn(x.shape, generator=gen),
                        y + 1e-6 * torch.randn(y.shape, generator=gen), lab)

            engine.augment_pairs = moved
            moves.append(_grad_err(mesh_checks.cd_steps(
                None, cfg, arrays, 1)["grads"], one["grads"]))
    finally:
        engine.augment_pairs = aug
    bound = max(1e-4, float(np.median(moves)))
    for r in ranks:
        got = r[1]
        torch.testing.assert_close(got["loss"], one["loss"], rtol=1e-5,
                                   atol=0)
        assert torch.equal(got["cm"], one["cm"])
        assert _grad_err(got["grads"], one["grads"]) <= bound
        assert max(_scaled(got["stats"][k], one["stats"][k])
                   for k in one["stats"]) <= 1e-5
        assert _stats_equal(got["stats"], ranks[0][1]["stats"])
