"""ChangeFormer V1 (``changeFormer``) and V6 (``changeFormerV6``) on the
port's ``space`` axis, against the JAX package and against one process,
with two gloo ranks on the CPU.

Each rank holds half the image rows (n_data 1, n_space 2): the patch
embeddings' strided convs and the Mix-FFN's depthwise 3x3 take halos, the
spatial-reduction attention's queries stay on the rank's pixels while its
reduced keys and values are gathered over the space group, element dropout
draws its masks at the whole rows and slices the rank's, V6's decoder
takes each scale's level and V1's ladder its transposed convs' halos. All
cases run in one launch of two ranks (``tools/space_checks.py``, which
imports no JAX, one thread a rank), started in a thread of its own before
the JAX references compile in theirs (with XLA's default optimizations:
``FAST_COMPILE``, which tests/test_torch_space_kernels.py uses, saves no
compile time here and runs V6's step 7 times slower, 60 s against 8.6):

  * both keys at 128 px, batch 2, where every level splits (16 / 8 / 4 / 2
    rows a rank, each sr conv on a multiple of its ratio): the eval
    forward on seeded weights, every head of V6's list; a
    ``CDTrainer.train_step(spatial=True, --multi_scale_loss)`` with every
    dropout rate 0 and one with dropout active;
  * uneven rows: ``changeFormerV6`` at 64 px (the stage-4 patch embed's
    reach of 3 over 2 rows gathers 1/16, so 1/32 and its head run whole)
    and ``changeFormer`` at 96 px (12 / 6 / 3 rows a rank at 1/4 to 1/16:
    every sr-8 / 4 / 2 conv gathers its level's rows, and 1/32 runs
    whole), each an eval forward and a multi-scale step with dropout
    active; ``CDEvaluator.eval_models(spatial=True)`` of V6 at 64 px;
  * the blocks: the rows-mode ``Dropout`` (an NHWC map, an attention
    matrix's queries, per sample and per channel after them) and
    ``SRAttention`` at sr 1, 2, 4 (the rank's rows) and 8 (the level
    gathered), train mode, dropout 0.2.

The JAX references are the un-sharded flax submodules with every rate 0
(tests/test_torch_changeformer.py ``_jax_forward``) on the port's weights
crossed by the JAX package's ``convert_changeformer``; the steps start
from the weights the trainers draw and are held against
``jax.value_and_grad`` of the trainer's loss (V6: the weighted sum over
its five heads, each against the label resized nearest) on those weights
and the trainer's augmented batch.

Tolerances, scale-normalized (the largest difference over the reference's
largest element; gradients over the whole gradient's): against JAX, eval
logits 1e-4 of each head's scale, a step's loss 1e-5 relative, gradients
1e-3 of scale or ROADMAP rule 5 on JAX (the median of JAX's own moves
under four 1e-6 moves of its augmented images), statistics 1e-4; against
one process, fp32 forwards 1e-5 of each head's scale, a step's loss 1e-5
relative, gradients 1e-4 of scale or rule 5 on one process, statistics
1e-5, every rank with the same gradient and statistics bits; the dropout
masks bit for bit; ``SRAttention``'s output, input and weight gradients
1e-6.
"""
import multiprocessing
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahitra_tpu.core.torch_import import convert_changeformer
from dahitra_tpu.losses.cd import levir_train_loss as jax_levir_train_loss
from dahitra_tpu_torch.core.flax_import import changeformer_flax_to_state_dict
from dahitra_tpu_torch.core.mesh import launch
from dahitra_tpu_torch.losses.cd import MULTI_SCALE_WEIGHTS
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.tools import mesh_checks, space_checks
from test_torch_changeformer import _jax_forward
from test_torch_space import LIMIT, _cd_arrays, _cfg, _scaled
from test_torch_space_kernels import (_held_to_jax, _held_to_one_process,
                                      _moved, _np, _trainer_start)

IMG = 128
V1, V6 = "changeFormer", "changeFormerV6"
KEYS = (V1, V6)
# uneven rows: key -> px whose 1/32 level runs whole on both ranks
UNEVEN = {V6: 64, V1: 96}
# the sr ratios of ``SRAttention`` on (2, 8, 16, 16) maps, 4 rows a rank:
# 1, 2 and 4 reduce the rank's rows, 8 the level's rows gathered
SR = (1, 2, 4, 8)


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
        rng = np.random.RandomState(3)
        self.sr = [tuple(rng.normal(size=(2, 8, 16, 16)).astype(np.float32)
                         for _ in range(2)) + (sr, 30 + i)
                   for i, sr in enumerate(SR)]
        self.seed = {k: 60 + i for i, k in enumerate(KEYS)}
        self.inputs = _pair(4, IMG)
        self.arrays = _cd_arrays(2, IMG, 5)

        def cfg(tag, key, img):
            return {**_cfg(tmp, tag, key, 2), "img_size": img,
                    "multi_scale_loss": True}

        self.cfg = {k: cfg(k, k, IMG) for k in KEYS}
        self.cases = {
            "dropout": ("rows_dropout", ((2, 8, 6, 4), 0.3, 7)),
            "sr_attention": ("sr_attention", (self.sr,))}
        for k in KEYS:
            self.cases[f"{k}_eval"] = ("forward_rows", (
                k, IMG, self.seed[k], self.inputs))
            self.cases[f"{k}_step"] = ("trainer_steps", (
                "cd", self.cfg[k], self.arrays, True, 0, False, True))
            self.cases[f"{k}_dropout"] = ("trainer_steps", (
                "cd", cfg(f"{k}_d", k, IMG), self.arrays, True))
        for i, (k, img) in enumerate(UNEVEN.items()):
            self.cases[f"{k}_uneven_eval"] = ("forward_rows", (
                k, img, 70 + i, _pair(7 + i, img)))
            self.cases[f"{k}_uneven_step"] = ("trainer_steps", (
                "cd", cfg(f"{k}_u", k, img), _cd_arrays(2, img, 8 + i),
                True))
        img = UNEVEN[V6]
        self.cases["eval_models"] = ("cd_eval", (
            cfg("ev", V6, img), _cd_arrays(3, img, 6),
            space_checks.seeded_weights(define_g(V6), 72),
            np.array([0, 0, 1]), True))
        self._one = {}

    def run(self, name):
        """The case on one process, the whole batch."""
        fn, args = self.cases[name]
        run = getattr(space_checks, fn, None) or getattr(mesh_checks, fn)
        return run(None, *args)

    def one(self, name):
        """``run(name)``, once."""
        if name not in self._one:
            self._one[name] = self.run(name)
        return self._one[name]


def _to_jax(key, sd):
    """The port's state dict as (params, batch_stats) of the JAX model."""
    return convert_changeformer({k: v.float().numpy() for k, v in sd.items()},
                                v6=key == V6)


def _to_torch(key, params, stats):
    """A flax tree (parameters or their gradients) as the port's names."""
    return changeformer_flax_to_state_dict(jax.tree.map(np.asarray, params),
                                           stats, v6=key == V6)


def _jax_ref(cases, key):
    """The flax model ``key`` at 128 px (every rate 0): its eval heads on
    the seeded weights, and ``jax.value_and_grad`` of the trainer's loss
    (V6: the multi-scale sum, engine.py:127-151) on the CD trainer's
    weights and first augmented batch (one compile for both)."""
    ev_fwd = _jax_forward(key, jnp.float32, False)
    train_fwd = _jax_forward(key, jnp.float32, True)

    def loss_fn(p, s, a, b, label):
        out, new = train_fwd(p, s, a, b)
        if key == V1:
            return jax_levir_train_loss(out[0], label, label.shape[0]), new
        loss = 0.0
        for wt, lg in zip(MULTI_SCALE_WEIGHTS, out):
            tgt = jax.image.resize(label.astype(jnp.float32),
                                   (label.shape[0],) + lg.shape[1:3],
                                   "nearest").astype(jnp.int32)
            loss = loss + wt * jax_levir_train_loss(lg, tgt, label.shape[0])
        return loss, new

    def fn(pe, se, x1, x2, p, s, a, b, label):
        ev = ev_fwd(pe, se, x1, x2)[0]
        return ev, jax.value_and_grad(loss_fn, has_aux=True)(p, s, a, b,
                                                              label)

    sd, (a, b, label) = _trainer_start("cd", cases.cfg[key], cases.arrays)
    pe, se = _to_jax(key, space_checks.seeded_weights(define_g(key),
                                                      cases.seed[key]))
    p, s = _to_jax(key, sd)
    fn = jax.jit(fn)
    ev_in = (cases.inputs["a"], cases.inputs["b"])
    batch = (_np(a), _np(b), label.numpy().astype(np.int32))
    ev, step = fn(pe, se, *ev_in, p, s, *batch)
    return {"fn": fn, "heads": [np.asarray(h) for h in ev],
            "step": jax.tree.map(np.asarray, step), "params": p, "stats": s,
            "eval": (pe, se, *ev_in), "batch": batch}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """(the cases, their results): the launch of two ranks and the JAX
    references, in threads beside the tests."""
    cases = _Cases(tmp_path_factory.mktemp("space_changeformer"))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(3) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")  # the ranks', before any thread
        # The ranks are spawned before any JAX program runs
        # (tests/test_torch_space_kernels.py ``launched``).
        before = set(multiprocessing.active_children())
        futures = {"ranks": pool.submit(
            launch, space_checks.run_cases, (list(cases.cases.values()),),
            devices=["cpu", "cpu"], timeout=LIMIT, n_space=2)}
        while (len(set(multiprocessing.active_children()) - before) < 2
               and not futures["ranks"].done()):
            time.sleep(0.05)
        for k in KEYS:
            futures[k] = pool.submit(_jax_ref, cases, k)
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
    rows (a whole level) rather than half of them (the rank's)."""
    mine, ref = got["shapes"][name], one["shapes"][name]
    if mine == ref:
        return True
    assert mine[1] * 2 == ref[1], name
    return False


def _enc(key):
    return "Tenc_x2" if key == V6 else "Tenc"


def _heads(got: dict) -> list:
    return got.get("heads", [got["whole"]])


def test_changeformer_takes_row_sharded_batches_by_its_stride():
    """Both keys have a ``space_stride`` of 32 (the four patch
    embeddings' strides), so ``space.shard_rows`` gives a rank its rows."""
    with torch.device("meta"):
        assert {define_g(k).space_stride for k in KEYS} == {32}


def test_rows_dropout_draws_one_process_masks(launched):
    """``Dropout(0.3, ...)(x, rows=)`` on two ranks' blocks, one generator
    seed: an NHWC map's rows, an attention matrix's queries (axis 2), then
    a per-sample and a per-channel mask: every rank's mask the block of
    one process's bit for bit (the first two drawn at the whole size and
    sliced), the last two one process's whole masks, so the generators
    stay in step."""
    cases, res = launched
    one = cases.one("dropout")
    got = res.ranks("dropout")
    assert torch.equal(torch.cat([g[0] for g in got], 1), one[0])
    assert torch.equal(torch.cat([g[1] for g in got], 2), one[1])
    for k in (2, 3):
        for i, g in enumerate(got):
            assert torch.equal(g[k], one[k][:, 4 * i:4 * (i + 1)])
    assert 0 < float((one[0] == 0).float().mean()) < 0.6


@pytest.mark.parametrize("sr", SR)
def test_sr_attention_on_rows_equals_one_process(launched, sr):
    """``SRAttention`` (16 wide, 2 heads, attention and projection dropout
    0.2) on two ranks of 4 rows: queries on the rank's pixels, the reduced
    keys and values gathered (sr 8: the level's 8 rows gathered before the
    conv): the joined output, the gradient of sum(y * dy) with respect to
    x and every parameter's gradient summed over the ranks 1e-6 of one
    process's."""
    cases, res = launched
    i = SR.index(sr)
    one = cases.one("sr_attention")[i]
    got = [g[i] for g in res.ranks("sr_attention")]
    assert all(g["y"].shape[1] == 4 for g in got)
    assert _scaled(torch.cat([g["y"] for g in got], 1), one["y"]) <= 1e-6
    assert _scaled(torch.cat([g["dx"] for g in got], 1), one["dx"]) <= 1e-6
    scale = max(float(v.abs().max()) for v in one["grads"].values())
    assert max(float((got[0]["grads"][k] - v).abs().max())
               for k, v in one["grads"].items()) <= 1e-6 * scale


@pytest.mark.parametrize("key", KEYS)
def test_row_sharded_eval_matches_jax(launched, key):
    """The eval forward at 128 px, batch 2, on two ranks of 64 rows: every
    head's gathered logits against the flax model on whole images (1e-4)
    and one process (1e-5); each rank holds its rows of every level, 1/32
    included (its last block and V6's 1/32 head's convs)."""
    cases, res = launched
    one = cases.one(f"{key}_eval")
    ref = res[key]["heads"]
    for g in res.ranks(f"{key}_eval"):
        heads = _heads(g)
        assert [h.shape for h in heads] == [r.shape for r in ref]
        for h, r, o in zip(heads, ref, _heads(one)):
            assert _scaled(h, torch.tensor(r)) <= 1e-4
            assert _scaled(h, o) <= 1e-5
        assert g["logits"].shape[1] * 2 == IMG
        for name in (f"{_enc(key)}.block4.2", f"{_enc(key)}.block1.0.attn"):
            assert not _whole(g, one, name), name


@pytest.mark.parametrize("key", KEYS)
def test_row_sharded_step_matches_jax(launched, key):
    """``CDTrainer.train_step(spatial=True)`` at 128 px, batch 2,
    ``--multi_scale_loss``, every dropout rate 0, on two ranks of 64 rows:
    the loss (V6: the weighted sum over its five heads), the gradients the
    ranks reduce (DDP's mean) and the running statistics against
    ``jax.value_and_grad`` of the flax model on the trainer's weights and
    augmented batch (loss 1e-5 relative, gradients 1e-3 of scale or rule
    5 on JAX, statistics 1e-4); both ranks with the same bits."""
    _, res = launched
    ref = res[key]
    (loss, new), grads = ref["step"]
    got = res.ranks(f"{key}_step")

    def moves():
        a, b, label = ref["batch"]
        return [_to_torch(key, ref["fn"](
            *ref["eval"], ref["params"], ref["stats"], _moved(a, i),
            _moved(b, i), label)[1][1], ref["stats"]) for i in range(4)]

    _held_to_jax(got, loss, _to_torch(key, grads, ref["stats"]),
                 _to_torch(key, ref["params"], new), moves)
    for k in ("grads", "stats"):
        assert all(torch.equal(got[0][k][n], got[1][k][n])
                   for n in got[0][k]), k


@pytest.mark.parametrize("key", KEYS)
def test_dropout_step_equals_one_process(launched, key):
    """``CDTrainer.train_step(spatial=True)`` at 128 px, batch 2, V6 on
    its five heads, with dropout active (V6: element dropout 0.1 on the
    Mix-FFN, the attention matrix's queries and the projection, drop path
    to 0.1; V1: drop path to 0.1), both ranks drawing from the trainer's
    generator as one process: the step against one process's (loss 1e-5
    relative, gradients 1e-4 of scale or rule 5 on one process, statistics
    1e-5), every rank with the same bits."""
    cases, res = launched
    name = f"{key}_dropout"
    _held_to_one_process(cases, name, res.ranks(name), cases.one(name))


@pytest.mark.parametrize("key", list(UNEVEN))
def test_uneven_rows_equal_one_process(launched, key):
    """``changeFormerV6`` at 64 px (2 rows a rank at 1/16, under the
    stage-4 patch embed's reach of 3: 1/32 and its head run whole) and
    ``changeFormer`` at 96 px (12 / 6 / 3 rows a rank at 1/4 / 1/8 / 1/16:
    every sr conv gathers its level's rows; 3 rows do not take the stride
    2, so 1/32 runs whole and its transposed conv gives the rank its 1/16
    rows again): every head's gathered fp32 eval logits 1e-5 of one
    process's, and the multi-scale dropout step held as
    ``test_dropout_step_equals_one_process`` holds it. The loss equal to
    one process's shows that each head, V6's whole 1/32 one too, counted
    once."""
    cases, res = launched
    one = cases.one(f"{key}_uneven_eval")
    img, enc = UNEVEN[key], _enc(key)
    for g in res.ranks(f"{key}_uneven_eval"):
        for h, o in zip(_heads(g), _heads(one)):
            assert _scaled(h, o) <= 1e-5
        assert g["logits"].shape[1] * 2 == img
        assert _whole(g, one, f"{enc}.block4.0")
        assert not _whole(g, one, f"{enc}.block3.0.attn")
        if key == V6:
            assert _whole(g, one, "TDec_x2.make_pred_c4")
            assert not _whole(g, one, "TDec_x2.make_pred_c3")
        else:
            assert not _whole(g, one, "convproj.dense_4")
    name = f"{key}_uneven_step"
    _held_to_one_process(cases, name, res.ranks(name), cases.one(name))


def test_row_sharded_v6_evaluation_counts_each_pixel_once(launched):
    """``CDEvaluator.eval_models(spatial=True)`` of V6 at 64 px (1/32
    whole) over 3 pairs at batch 2 (a ragged last batch) with per-patch
    groups on two ranks: the summed matrix and the per-group scores those
    of one process."""
    cases, res = launched
    one = cases.one("eval_models")
    img = UNEVEN[V6]
    for g in res.ranks("eval_models"):
        assert torch.equal(g["cm"], one["cm"])
        assert int(g["cm"].sum()) == 3 * img * img
        assert g["scores"]["per_group"] == one["scores"]["per_group"]
