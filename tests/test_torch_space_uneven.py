"""Uneven rows on the port's ``space`` axis: rows per rank that a model's
strides do not split all the way down, against the JAX package and against
one process, on gloo ranks on the CPU.

The cases run in one launch of eight ranks on the 2 x 4 (data x space)
grid of tests/test_sharding.py::test_xbd_train_step_spatial_mesh
(``core.mesh.launch(..., n_space=4)``; ``tools/space_checks.py``, which
imports no JAX, one thread a rank), started in a thread of its own so that
the JAX references compile while the ranks run. On four space ranks the
first strided op that meets rows it cannot split gathers its level, and it
and every coarser level run whole on every rank (``nn/space.py``):

  * ``xbd_res34_double`` at 64 px: 16 rows a rank, 1 at 1/16, so 1/32 is
    whole (the JAX test's case);
  * ``newUNetTrans`` at 48 px: 3 rows a rank at 1/4, so 1/8 and 1/16 are
    whole (the 1/8 decoder takes the stack path on the whole 36 tokens);
  * ``base_resnet18`` at 40 px and BIT ``_dd8`` at 72 px: 5 and 9 rows a
    rank at 1/2, so the max-pool gathers and 1/4 down is whole (BIT's
    tokenizer and decoder run whole);
  * ``xbd_res34_double_modified`` at 64 px, whose fused pass goes back to
    the 1/2 level.

The JAX references run un-sharded on one virtual CPU device, compiled
without LLVM's optimizations (``FAST_COMPILE``, as
tests/test_torch_space_kernels.py compiles them). Inputs are seeded numpy;
weights the port's ``init_random`` with seeded biases, crossed into the JAX
models by the JAX package's converters; the trainers' steps start from the
weights the trainers draw, and are held against ``jax.value_and_grad`` on
those weights and the trainer's augmented batch.

Tolerances, scale-normalized (the largest difference over the reference's
largest element; gradients over the whole gradient's): against JAX, a
step's loss 1e-5 relative, gradients 1e-3 of scale or ROADMAP rule 5 on
JAX (the median of JAX's own moves under four 1e-6 moves of its augmented
images), statistics 1e-4; ``newUNetTrans``'s eval logits 1e-4 (the bound
of tests/test_torch_dahitra.py); against one process, fp32 forwards 1e-5.
"""
import multiprocessing
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahitra_tpu.core.torch_import import convert_res34_unet
from dahitra_tpu.losses.cd import levir_train_loss as jax_levir_train_loss
from dahitra_tpu.losses.combo import xbd_damage_loss as jax_xbd_damage_loss
from dahitra_tpu.models.registry import define_g as jax_define_g
from dahitra_tpu_torch.core.flax_import import (flax_to_state_dict,
                                                res34_unet_flax_to_state_dict)
from dahitra_tpu_torch.core.mesh import Mesh, launch
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.nn import space
from dahitra_tpu_torch.tools import mesh_checks, space_checks
from test_torch_space import LIMIT, _cd_arrays, _cfg, _scaled, _xbd_arrays
from test_torch_space_kernels import (FAST_COMPILE, _clipped, _held_to_jax,
                                      _moved, _np, _to_jax, _trainer_start)

RANKS, N_SPACE = 8, 4
DAH, DD8, R34 = "newUNetTrans", "base_transformer_pos_s4_dd8", \
    "xbd_res34_double"
R34_IMG, DAH_IMG, RES_IMG, BIT_IMG = 64, 48, 40, 72


@pytest.fixture(autouse=True)
def one_thread():
    """The one-process references on one thread, as the ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed, img, n=2):
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(-1, 1, (n, img, img, 3)).astype(np.float32)
            for k in ("a", "b")}


class _Cases:
    """The launch's cases, built once: name -> (function, args)."""

    def __init__(self, tmp):
        keys = {DAH: DAH_IMG, "base_resnet18": RES_IMG, DD8: BIT_IMG,
                "xbd_res34_double_modified": R34_IMG}
        # weights drawn on each rank from a seed (a ResNet34 UNet's are
        # 109 MB to send to each of eight ranks)
        self.seed = {k: 30 + i for i, k in enumerate(keys)}
        self.inputs = {k: _pair(40 + i, img)
                       for i, (k, img) in enumerate(keys.items())}
        six = np.random.RandomState(45).uniform(-1, 1, (2, R34_IMG, R34_IMG,
                                                        6))
        self.inputs["xbd_res34_double_modified"] = {
            "x": six.astype(np.float32)}
        self.xbd_arrays = _xbd_arrays(4, R34_IMG, 46)
        self.cd_arrays = _cd_arrays(2, DAH_IMG, 47)
        self.xbd_cfg = {**_cfg(tmp, "r34", R34, 4), "img_size": R34_IMG,
                        "val_batch_size": 4}
        self.cd_cfg = {**_cfg(tmp, "dah", DAH, 2), "img_size": DAH_IMG}
        ev_cfg = {**_cfg(tmp, "ev", DAH, 2), "img_size": DAH_IMG}
        ev_sd = space_checks.seeded_weights(define_g(DAH, img_size=DAH_IMG),
                                            self.seed[DAH])
        self.cases = {
            "r34_step": ("trainer_steps", ("xbd", self.xbd_cfg,
                                           self.xbd_arrays, True)),
            "dah_step": ("trainer_steps", ("cd", self.cd_cfg,
                                           self.cd_arrays, True)),
            "dah_eval_models": ("cd_eval", (
                ev_cfg, _cd_arrays(3, DAH_IMG, 48), ev_sd, np.array([0, 0, 1]),
                True))}
        for k, img in keys.items():
            self.cases[k] = ("forward_rows", (k, img, self.seed[k],
                                              self.inputs[k]))
        self._one = {}

    def one(self, name):
        """The case on one process, the whole batch, once."""
        if name not in self._one:
            fn, args = self.cases[name]
            run = getattr(space_checks, fn, None) or getattr(mesh_checks, fn)
            self._one[name] = run(None, *args)
        return self._one[name]


def _r34_ref(cases):
    """``jax.value_and_grad`` of the flax ``xbd_res34_double`` damage loss
    on the xBD trainer's weights and first augmented batch (batch 4): the
    step function and its result."""
    sd, (img6, masks) = _trainer_start("xbd", cases.xbd_cfg,
                                       cases.xbd_arrays)
    p, s = convert_res34_unet({k: _np(v) for k, v in sd.items()})
    model = jax_define_g(R34, img_size=R34_IMG)

    def loss_fn(p_, x, m):
        logits, mut = model.apply({"params": p_, "batch_stats": s}, x, None,
                                  True, mutable=["batch_stats"])
        return jax_xbd_damage_loss(logits.astype(jnp.float32), m), \
            mut["batch_stats"]

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                   compiler_options=FAST_COMPILE)
    out = jax.tree.map(np.asarray, step(p, _np(img6), _np(masks)))
    return {"step": step, "out": out, "params": p, "stats": s,
            "batch": (_np(img6), _np(masks))}


def _dah_ref(cases):
    """The flax ``newUNetTrans`` at 48 px: its eval logits on the seeded
    weights, and ``jax.value_and_grad`` of its train-mode
    ``levir_train_loss`` on the CD trainer's weights and first augmented
    batch (one compile for both)."""
    model = jax_define_g(DAH, img_size=DAH_IMG)

    def loss_fn(p, s, a, b, label):
        logits, mut = model.apply({"params": p, "batch_stats": s}, a, b,
                                  True, mutable=["batch_stats"])
        return jax_levir_train_loss(logits.astype(jnp.float32), label,
                                    label.shape[0]), mut["batch_stats"]

    def fn(pe, se, x1, x2, p, s, a, b, label):
        ev = model.apply({"params": pe, "batch_stats": se}, x1, x2, False)
        return ev, jax.value_and_grad(loss_fn, has_aux=True)(p, s, a, b,
                                                              label)

    sd, (a, b, label) = _trainer_start("cd", cases.cd_cfg, cases.cd_arrays)
    pe, se = _to_jax(DAH, space_checks.seeded_weights(
        define_g(DAH, img_size=DAH_IMG), cases.seed[DAH]))
    p, s = _to_jax(DAH, sd)
    fn = jax.jit(fn, compiler_options=FAST_COMPILE)
    ev_in = (cases.inputs[DAH]["a"], cases.inputs[DAH]["b"])
    batch = (_np(a), _np(b), label.numpy().astype(np.int32))
    ev, step = fn(pe, se, *ev_in, p, s, *batch)
    return {"fn": fn, "logits": np.asarray(ev),
            "step": jax.tree.map(np.asarray, step), "params": p, "stats": s,
            "eval": (pe, se, *ev_in), "batch": batch}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """(the cases, their results): the launch of eight ranks and the JAX
    references, in threads beside the tests."""
    cases = _Cases(tmp_path_factory.mktemp("space_uneven"))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(3) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")  # the ranks', before any thread
        # The ranks are spawned before any JAX program runs
        # (tests/test_torch_space_kernels.py ``launched``).
        before = set(multiprocessing.active_children())
        futures = {"ranks": pool.submit(
            launch, space_checks.run_cases, (list(cases.cases.values()),),
            devices=["cpu"] * RANKS, timeout=LIMIT, n_space=N_SPACE)}
        while (len(set(multiprocessing.active_children()) - before) < RANKS
               and not futures["ranks"].done()):
            time.sleep(0.05)
        futures["r34"] = pool.submit(_r34_ref, cases)
        futures["dah"] = pool.submit(_dah_ref, cases)
        try:
            yield cases, _Results(cases, futures)
        finally:
            wait(futures.values(), timeout=2 * LIMIT)


class _Results:
    def __init__(self, cases, futures):
        self.cases, self.futures = cases, futures

    def ranks(self, name):
        """Each rank's result of the case ``name``."""
        i = list(self.cases.cases).index(name)
        return [r[i] for r in self["ranks"]]

    def __getitem__(self, key):
        return self.futures[key].result(timeout=2 * LIMIT)


def _whole(got: dict, one: dict, name: str) -> bool:
    """Whether the submodule ``name``'s output on a rank had one process's
    shape for the rank's sample (a whole level) rather than its rows."""
    mine, ref = got["shapes"][name], one["shapes"][name]
    assert ref[0] == 2 * mine[0], name  # the data rank's half of the batch
    if mine[1:] == ref[1:]:
        return True
    assert mine[1] * N_SPACE == ref[1], name
    return False


def test_xbd_res34_double_step_on_a_2x4_grid_matches_jax(launched):
    """tests/test_sharding.py::test_xbd_train_step_spatial_mesh ported:
    ``XBDTrainer.train_step(spatial=True)`` (damage) of ``xbd_res34_double``
    at 64 px, batch 4, on the 2 x 4 grid (each rank 2 samples of 16 rows;
    layer 4 gathers the 1/16 level and 1/32 runs whole): the global batch's
    loss, the gradients the ranks reduce (after the trainer's clip to a
    global norm of 0.999) and the running statistics against
    ``jax.value_and_grad`` of the flax damage loss on the trainer's weights
    and augmented batch (loss 1e-5 relative, gradients 1e-3 of scale or
    rule 5 on JAX, statistics 1e-4); every rank with the same gradient and
    statistics bits."""
    cases, res = launched
    ref = res["r34"]
    step, p, s = ref["step"], ref["params"], ref["stats"]
    img6, masks = ref["batch"]
    (loss, new), grads = ref["out"]
    got = res.ranks("r34_step")
    assert len(got) == RANKS

    def torch_grads(g):
        sd = res34_unet_flax_to_state_dict(jax.tree.map(np.asarray, g), s)
        return _clipped({k: sd[k] for k in got[0]["grads"]})

    _held_to_jax(got, loss, torch_grads(grads),
                 res34_unet_flax_to_state_dict(p, new),
                 lambda: [torch_grads(step(p, _moved(img6, i), masks)[1])
                          for i in range(4)])
    for g in got[1:]:
        for k in ("grads", "stats"):
            assert all(torch.equal(g[k][n], got[0][k][n]) for n in g[k]), k


def test_dahitra_at_48_px_on_four_space_ranks_matches_flax(launched):
    """``newUNetTrans`` at 48 px, batch 2, on the 2 x 4 grid (12 rows a
    rank; the 1/4 level's 3 rows meet layer 2's stride, so 1/8 and 1/16
    run whole: the one-process tokenizer, the whole positional embedding
    and token count there): the gathered eval logits against the flax model
    (1e-4) and one process (1e-5); the 1/4 scale's decoder on the rank's
    rows, the 1/8 and 1/16 ones on the whole level."""
    cases, res = launched
    one = cases.one(DAH)
    for g in res.ranks(DAH):
        assert _scaled(g["whole"], res["dah"]["logits"]) <= 1e-4
        assert _scaled(g["whole"], one["logits"]) <= 1e-5
        assert not _whole(g, one, "transformer_decoder_3")
        assert _whole(g, one, "transformer_decoder_4")
        assert _whole(g, one, "transformer_decoder_5")
        assert _whole(g, one, "resnet.layer2")
        assert not _whole(g, one, "resnet.layer1")


def test_dahitra_train_step_with_whole_levels_matches_jax(launched):
    """``CDTrainer.train_step(spatial=True)`` of ``newUNetTrans`` at 48 px,
    batch 2, on the 2 x 4 grid (1/8 and 1/16 whole; their K1-save and K2,
    here their plain versions, and the one-process K3 on every rank): the
    loss, the gradients summed over the ranks (DDP's mean of each rank's
    rows' share) and the running statistics against ``jax.value_and_grad``
    of the flax model on the trainer's weights and augmented batch (loss
    1e-5 relative, gradients 1e-3 of scale or rule 5 on JAX, statistics
    1e-4); every rank with the same bits."""
    _, res = launched
    ref = res["dah"]
    (loss, new), grads = ref["step"]
    got = res.ranks("dah_step")
    assert len(got[0]["grads"]) == 314

    def moves():
        a, b, label = ref["batch"]
        return [flax_to_state_dict(jax.tree.map(np.asarray, ref["fn"](
            *ref["eval"], ref["params"], ref["stats"], _moved(a, i),
            _moved(b, i), label)[1][1]), ref["stats"]) for i in range(4)]

    _held_to_jax(got, loss, flax_to_state_dict(grads, ref["stats"]),
                 flax_to_state_dict(ref["params"], new), moves)
    for g in got[1:]:
        for k in ("grads", "stats"):
            assert all(torch.equal(g[k][n], got[0][k][n]) for n in g[k]), k


@pytest.mark.parametrize("key,img", [("base_resnet18", RES_IMG),
                                     (DD8, BIT_IMG),
                                     ("xbd_res34_double_modified", R34_IMG)])
def test_uneven_forward_equals_one_process(launched, key, img):
    """``base_resnet18`` at 40 px and BIT ``_dd8`` at 72 px (the max-pool
    meets 5 and 9 rows a rank at 1/2 and gathers; BIT's tokenizer and
    decoder then run whole) and ``xbd_res34_double_modified`` at 64 px (its
    fused pass takes up the 1/2 level again, ``space.at_level``), eval,
    batch 2, on the 2 x 4 grid: the gathered fp32 logits within 1e-5 of
    one process's; the logits on a rank its rows."""
    cases, res = launched
    one = cases.one(key)
    for g in res.ranks(key):
        assert _scaled(g["whole"], one["logits"]) <= 1e-5
        assert g["logits"].shape[1] * N_SPACE == img
    if key == DD8:
        g = res.ranks(key)[0]
        assert _whole(g, one, "transformer_decoder")
        assert _whole(g, one, "resnet.layer1")
        assert not _whole(g, one, "classifier")


@pytest.mark.parametrize("key", [DAH, DD8])
def test_decoder_gates_on_whole_levels_follow_one_process(launched, key):
    """Each decoder's gate path under the grid equals one process's on the
    whole image: at a whole level the gate reads the whole token count
    (``newUNetTrans``'s 1/8 decoder takes the stack on 36 tokens, its 1/16
    one the layer loop on 9; BIT's 1/4 decoder the stack on 324), not S
    times it."""
    cases, res = launched
    one = cases.one(key)
    want = {DAH: {"transformer_decoder_3": "stack",
                  "transformer_decoder_4": "stack",
                  "transformer_decoder_5": "layers"},
            DD8: {"transformer_decoder": "stack"}}[key]
    assert one["paths"] == want
    for g in res.ranks(key):
        assert g["paths"] == want


def test_uneven_evaluation_counts_each_pixel_once(launched):
    """``CDEvaluator.eval_models(spatial=True)`` of ``newUNetTrans`` at 48
    px over 3 pairs at batch 2 (a ragged last batch) with per-patch groups
    on the 2 x 4 grid, 1/8 and 1/16 whole: the summed matrix and the
    per-group scores those of one process, each pixel counted once."""
    cases, res = launched
    one = cases.one("dah_eval_models")
    for g in res.ranks("dah_eval_models"):
        assert torch.equal(g["cm"], one["cm"])
        assert int(g["cm"].sum()) == 3 * DAH_IMG * DAH_IMG
        assert g["scores"]["per_group"] == one["scores"]["per_group"]


def test_levels_record_where_rows_stop_splitting(monkeypatch):
    """``space.descend`` keeps a rank's rows while they are a multiple of
    the stride and at least the halo and gathers them below; ``ascend``
    takes the rank's rows again at the first level finer than the first
    whole one; ``rows()`` and ``stat_group()`` answer for the current level;
    ``at_level`` goes back to a level and ``shard_rows`` starts the levels
    over. (The row gather is stood in for: no collective runs.)"""
    monkeypatch.setattr(space, "gather_rows",
                        lambda x, r=None: torch.cat([x] * r.size, 1))
    mesh = Mesh(1, 2, torch.device("cpu"), "gloo", n_space=2,
                space_group="space", data_group="data")
    model = define_g(DAH, img_size=DAH_IMG)

    def col(n):
        return torch.arange(float(n)).view(1, n, 1, 1)

    with space.grid(mesh, spatial=True):
        x, = space.shard_rows(model, col(12))
        assert x.flatten().tolist() == list(range(6, 12))
        lv = space._level()
        assert space.descend(x, 2, 3) is x and lv.scale == 2
        assert space.rows() is not None and space.stat_group() is None
        x4 = space.descend(x[:, :3], 2, 1)  # 3 rows at stride 2: gathered
        assert x4.shape[1] == 6 and (lv.scale, lv.whole_at) == (4, 4)
        assert space.rows() is None and space.stat_group() == "data"
        assert space.descend(x4, 2, 1) is x4 and lv.scale == 8
        y = col(6)
        assert space.ascend(y, 2) is y and lv.scale == 4  # 1/4 is whole
        z = space.ascend(col(12), 2)  # 1/2 splits: the rank's rows
        assert z.flatten().tolist() == list(range(6, 12))
        assert lv.scale == 2 and space.rows().rank == 1
        space.at_level(8)
        assert space.rows() is None
        space.shard_rows(model, col(12))
        assert (lv.scale, lv.whole_at) == (1, None)
        with pytest.raises(ValueError, match="6 rows per space rank at "
                                             "stride 4"):
            from dahitra_tpu_torch.nn.blocks import conv2d_nhwc
            conv2d_nhwc(col(6), torch.zeros(1, 1, 1, 1), stride=4)


@pytest.mark.parametrize("whole,want", [(False, "stack"), (True, "layers"),
                                        (None, "layers")])
def test_decoder_gate_reads_the_whole_count_at_a_whole_level(whole, want,
                                                             monkeypatch):
    """``TransformerDecoder``'s gate given 16 rows of tokens (4 memory
    tokens) under a grid of two space ranks: on a level whose rows split it
    reads the global count, 32, and takes the stack (``n > 4 l``); on a
    whole level (``whole``) it reads the 16 it holds, which are the whole
    level's, and takes the layer loop, as one process (``whole`` None: no
    grid) does on 16 tokens."""
    from dahitra_tpu_torch.nn import blocks

    took = []
    monkeypatch.setattr(blocks, "decoder_stack", lambda x, *a: (
        took.append("stack") or x))
    dec = blocks.TransformerDecoder(32, 2, 4, 16, 32)
    mesh = Mesh(0, 2, torch.device("cpu"), "gloo", n_space=2)
    with space.grid(mesh if whole is not None else None, spatial=True), \
            torch.no_grad():
        if whole:
            space._level().whole_at = 1.0
        dec(torch.zeros(1, 16, 32), torch.zeros(1, 4, 32))
    assert (took[0] if took else "layers") == want
