"""The decoder kernels' models on the port's ``space`` axis, against the
JAX package and against one process, with two gloo ranks on the CPU.

BIT (``base_transformer_pos_s4*``), ``xbd_bit`` and ``TransformerDecoder(
pallas=True)`` (K4's plain version on the CPU) on row-sharded batches:
each rank holds half the image rows, K3 splits its softmax over the ranks
and the decoders run on the rank's rows, their gates reading the global
token count. All cases run in one launch of two ranks (n_data 1, n_space
2; ``tools/space_checks.py``, which imports no JAX, one thread a rank),
started in a thread of its own so that the JAX references compile while
the ranks run. The JAX references run on the virtual CPU devices of
``tests/conftest.py``; the row-sharded ones on rows placed with
``batch_sharding(make_mesh(n_data=1, n_space=2), spatial=True)``, the JAX
package's own space axis (tests/test_sharding.py:107), and the pallas
DAHiTra with its Pallas K4 in interpret mode (as
tests/test_torch_fused_decoder.py runs it). Inputs are seeded numpy, 64
px, batch 2. Weights: the port's ``init_random`` (the flax initializer's
draws: lecun-normal kernels, unit-normal positional embeddings) with
seeded biases and BN statistics, crossed into the JAX models by the JAX
package's ``convert_bit`` / ``convert_dahitra``, the inverses of
``bit_flax_to_state_dict`` / ``flax_to_state_dict`` (a flax init compiles
for 14-28 s here); the trainers' steps start from the weights the trainers
draw.

Tolerances, scale-normalized (the largest difference over the reference's
largest element; gradients over the whole gradient's): against JAX those
of the one-process tests (tests/test_torch_bit.py: BIT logits 1e-4 fp32,
5e-2 bf16, a train step's loss 1e-5 relative, BN statistics 1e-4,
gradients 1e-3 of scale, the bf16 loss 2e-2 relative;
tests/test_torch_xbd.py: ``xbd_bit``'s damage step, loss 1e-5 relative,
statistics 1e-4, gradients 1e-3 of scale or the median of JAX's own moves
under four 1e-6 input moves where larger (ROADMAP rule 5);
tests/test_torch_fused_decoder.py: the pallas DAHiTra's logits 1e-4, and
its train step held as BIT's, loss 1e-5 relative, gradients 1e-3 of scale
or rule 5, statistics 1e-4); against one process, fp32 forwards 1e-5, a
step's loss 1e-5 relative, gradients 1e-4 of scale or rule 5 on one
process and statistics 1e-5; bf16 forwards 2e-2, a bf16 step's loss and
statistics 2e-2 and its gradients by their cosine, at least 0.99 (the bf16
bound of tests/test_torch_dahitra.py), not the flat 6e-2 of scale: one
process's bf16 ``resnet.conv1`` gradient of ``_dd8`` lies 0.26 of scale
from its fp32 one at 64 px, the ranks' 8.6e-2 from one process's.
"""
import argparse
import functools
import multiprocessing
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import dahitra_tpu.models.dahitra as jax_dahitra
import dahitra_tpu.pallas.fused_decoder as jfd
from dahitra_tpu.core.mesh import batch_sharding, make_mesh
from dahitra_tpu.core.torch_import import convert_bit, convert_dahitra
from dahitra_tpu.losses.cd import levir_train_loss as jax_levir_train_loss
from dahitra_tpu.losses.combo import xbd_damage_loss as jax_xbd_damage_loss
from dahitra_tpu.models.registry import define_g as jax_define_g
from dahitra_tpu.nn.blocks import TransformerDecoder as JaxDecoder
from dahitra_tpu_torch.core.flax_import import (bit_flax_to_state_dict,
                                                flax_to_state_dict)
from dahitra_tpu_torch.core.mesh import Mesh, launch
from dahitra_tpu_torch.data.augment import augment_pairs
from dahitra_tpu_torch.kernels.fused_decoder import pick_tile
from dahitra_tpu_torch.models.bit import BIT
from dahitra_tpu_torch.models.registry import PORTED, define_g
from dahitra_tpu_torch.nn import blocks, space
from dahitra_tpu_torch.tools import mesh_checks, space_checks
from dahitra_tpu_torch.train.engine import CDTrainer
from dahitra_tpu_torch.train.xbd_engine import XBDTrainer
from test_torch_space import (LIMIT, _cd_arrays, _cfg, _grad_err, _scaled,
                              _xbd_arrays)

IMG = 64
DD8 = "base_transformer_pos_s4_dd8"
T8 = "base_transformer_pos_s4_dd8_t8_e2d4"
BIT_KEYS = ("base_transformer_pos_s4", DD8, "base_transformer_pos_s4_dd8_o5",
            "base_transformer_pos_s4_dd8_dedim8", T8, "xbd_bit")
# The models that take row-sharded batches: DAHiTra, the ResNet34 UNets,
# ResNetCD (tests/test_torch_space.py), BIT (this file), siamUnet_conc and
# the UNet change transformers (tests/test_torch_space_zoo.py), ChangeFormer
# V1 and V6 (tests/test_torch_space_changeformer.py).
ROWS_KEYS = {"newUNetTrans", "xbd_dahitra", "xbd_adapt_dahitra",
             "base_resnet18", "xbd_res34_loc", "xbd_res34_double",
             "xbd_res34_single", "xbd_res34_double_modified",
             "xbd_adapt_res34", "siamUnet", "siamUnet_conc",
             "unet_coupled_trans_256", "unet_coupled_two_trans_256",
             "changeFormer", "changeFormerV6", *BIT_KEYS}
# BIT variants outside the registry: (name, constructor arguments)
VARIANTS = {"simple_decoder": dict(token_len=4, dec_depth=8,
                                   with_decoder=False),
            "decoder_pos": dict(token_len=4, dec_depth=8,
                                with_decoder_pos="learned",
                                decoder_pos_size=IMG // 4),
            "no_upsample_2x": dict(token_len=4, dec_depth=8,
                                   if_upsample_2x=False)}
DAH = "newUNetTrans"
# The JAX references' programs compiled without LLVM's optimizations: the
# file is bound by their compiles (the pallas DAHiTra's forward and
# gradient with the interpreted K4 alone takes 80 s otherwise), and the
# HLO they run is the same.
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def one_thread():
    """The one-process references on one thread, as the ranks run. (The
    ranks' OMP_NUM_THREADS is set once by ``launched``: setenv beside the
    threads of a running XLA program corrupted its results, NaN and 1e12
    logits.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed, h=IMG, w=IMG, n=2):
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
            for k in ("a", "b")}


def _six(seed):
    x = np.random.RandomState(seed).uniform(-1, 1, (2, IMG, IMG, 6))
    x[..., 3:] *= 0.5  # a changed scene (tests/test_torch_xbd.py)
    return {"x": x.astype(np.float32)}


class _Cases:
    """The launch's cases, built once: name -> (function, args)."""

    def __init__(self, tmp):
        self.sd = {k: space_checks.seeded_weights(define_g(k, img_size=IMG),
                                                10 + i)
                   for i, k in enumerate(BIT_KEYS + (DAH,))}
        self.var_sd = {k: space_checks.seeded_weights(BIT(**kw), 20 + i)
                       for i, (k, kw) in enumerate(VARIANTS.items())}
        self.inputs = _pair(1)
        self.cd_arrays = _cd_arrays(2, IMG, 3)
        self.xbd_arrays = _xbd_arrays(2, IMG, 4)
        self.cfg = {d: _cfg(tmp, f"bit_{d}", DD8, 2, bf16=d == "bfloat16")
                    for d in ("float32", "bfloat16")}
        self.xbd_cfg = {**_cfg(tmp, "xbd_bit", "xbd_bit", 2),
                        "val_batch_size": 2}
        self.dah_cfg = _cfg(tmp, "dah_pallas", DAH, 2)
        self.cases, self._one = {}, {}
        for d in ("float32", "bfloat16"):
            self.cases[f"dd8_{d}"] = ("forward_rows", (
                DD8, IMG, self.sd[DD8], self.inputs, d))
        for k in BIT_KEYS:
            if k != DD8:
                self.cases[k] = ("forward_rows", (
                    k, IMG, self.sd[k], _six(2) if k == "xbd_bit"
                    else self.inputs))
        for k, kw in VARIANTS.items():
            self.cases[k] = ("forward_rows", (
                functools.partial(BIT, **kw), IMG, self.var_sd[k],
                self.inputs))
        for d in ("float32", "bfloat16"):
            self.cases[f"step_{d}"] = ("trainer_steps", (
                "cd", self.cfg[d], self.cd_arrays, True))
        self.cases["xbd_bit_step"] = ("trainer_steps", (
            "xbd", self.xbd_cfg, self.xbd_arrays, True))
        self.cases["pallas_forward"] = ("forward_rows", (
            DAH, IMG, self.sd[DAH], self.inputs, "float32", False, None,
            True, "cpu", True))
        self.cases["pallas_step"] = ("trainer_steps", (
            "cd", self.dah_cfg, self.cd_arrays, True, 0, True))
        self.cases["bit_eval_models"] = ("cd_eval", (
            _cfg(tmp, "bit_ev", DD8, 2), _cd_arrays(3, IMG, 6), self.sd[DD8],
            np.array([0, 0, 1]), True))
        # BIT at 64 x 32: the 1/4-scale decoder's global n 128 takes a
        # tile, a rank's 64 would not
        self.cases["pallas_bit"] = ("forward_rows", (
            DD8, IMG, self.sd[DD8], _pair(5, IMG, IMG // 2), "float32",
            False, None, True, "cpu", True))

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


def _jdt(dname):
    return jnp.float32 if dname == "float32" else jnp.bfloat16


def _sharded(*xs):
    """Rows over the 'space' axis of a (1, 2) JAX mesh."""
    sh = batch_sharding(make_mesh(n_data=1, n_space=2,
                                  devices=jax.devices()[:2]), spatial=True)
    return [jax.device_put(np.asarray(x), sh) for x in xs]


def _to_jax(key, sd):
    """The port's state dict as (params, batch_stats) of the JAX model."""
    np_sd = {k: v.float().numpy() for k, v in sd.items()}
    if key == DAH:
        return convert_dahitra(np_sd)
    depth = {T8: (2, 4)}.get(key, (1, 8))
    return convert_bit(np_sd, *depth)


@functools.lru_cache(maxsize=None)
def _jax_fn(key, dname):
    """One jitted function of the flax model ``key`` (``_dd8``, or
    ``newUNetTrans`` built ``pallas=True`` by ``launched``): its eval
    logits, and its train-mode loss and new statistics with (fp32)
    ``jax.value_and_grad`` (one compile for both)."""
    dt = _jdt(dname)
    model = jax_define_g(key, img_size=IMG, dtype=dt)

    def loss_fn(p, s, a, b, label):
        logits, mut = model.apply({"params": p, "batch_stats": s},
                                  a.astype(dt), b.astype(dt), True,
                                  mutable=["batch_stats"])
        return jax_levir_train_loss(logits.astype(jnp.float32), label,
                                    label.shape[0]), mut["batch_stats"]

    def fn(pe, se, x1, x2, p, s, a, b, label):
        ev = model.apply({"params": pe, "batch_stats": se}, x1.astype(dt),
                         x2.astype(dt), False).astype(jnp.float32)
        step = jax.value_and_grad(loss_fn, has_aux=True) \
            if dname == "float32" else loss_fn
        return ev, step(p, s, a, b, label)

    return jax.jit(fn, compiler_options=FAST_COMPILE)


def _trainer_start(kind, cfg, arrays):
    """A trainer's starting weights and its first augmented batch, as its
    first ``train_step`` draws them (one process)."""
    cls = CDTrainer if kind == "cd" else XBDTrainer
    trainer = cls(argparse.Namespace(**cfg), arrays, arrays, device="cpu")
    sd = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    batch = trainer._to_device(next(iter(trainer.train_loader)))
    if kind == "cd":
        return sd, augment_pairs(*batch, train=True, dtype=trainer.dtype,
                                 generator=trainer.aug_generator)
    img6, masks, _ = trainer._augment(*batch)
    return sd, (img6, masks)


def _np(t):
    return t.float().numpy()


def _cd_refs(cases, key, cfg, dname):
    """The flax model ``key``'s eval logits on rows placed on the JAX space
    axis, and the trainer's (``cfg``) first step there (loss, statistics
    and in fp32 the gradients) on the trainer's weights and augmented
    batch, with those weights, that batch and the eval operands."""
    sd, (a, b, label) = _trainer_start("cd", cfg, cases.cd_arrays)
    pe, se = _to_jax(key, cases.sd[key])
    p, s = _to_jax(key, sd)
    x = _sharded(cases.inputs["a"], cases.inputs["b"])
    ev, step = _jax_fn(key, dname)(pe, se, *x, p, s, *_sharded(
        _np(a), _np(b), label.numpy().astype(np.int32)))
    return {"key": key, "logits": np.asarray(ev),
            "step": jax.tree.map(np.asarray, step), "params": p, "stats": s,
            "batch": (a, b, label), "eval": (pe, se, x)}


def _xbd_refs(cases):
    """``jax.value_and_grad`` of the flax ``xbd_bit`` damage loss on the
    xBD trainer's weights and first augmented batch: the step function and
    its result."""
    sd, (img6, masks) = _trainer_start("xbd", cases.xbd_cfg,
                                       cases.xbd_arrays)
    p, s = _to_jax("xbd_bit", sd)
    model = jax_define_g("xbd_bit", img_size=IMG)

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


_RUNNING = []  # the futures of ``launched``, while it runs


def _drain():
    """Wait for every thread of ``launched``: a test that patches a module
    the threads read waits first."""
    for futures in _RUNNING:
        wait(futures.values(), timeout=2 * LIMIT)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """(the cases, their results): the launch of two ranks and the JAX
    references, in threads beside the tests, which run the cases on one
    process and wait for what they read. For the module's run the JAX
    DAHiTra's decoders are built ``pallas=True``, every Pallas call of the
    fused decoder in interpret mode (as tests/test_torch_fused_decoder.py
    runs it)."""
    cases = _Cases(tmp_path_factory.mktemp("space_kernels"))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(6) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")  # the ranks', before any thread
        orig = pl.pallas_call
        mp.setattr(jfd.pl, "pallas_call",
                   lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        mp.setattr(jax_dahitra, "TransformerDecoder",
                   functools.partial(JaxDecoder, pallas=True))
        # The ranks are spawned before any JAX program runs (XLA programs
        # running while they were spawned gave NaN or 1e12); then each JAX
        # reference in a thread of its own (XLA compiles without the
        # interpreter lock).
        before = set(multiprocessing.active_children())
        futures = {"ranks": pool.submit(
            launch, space_checks.run_cases, (list(cases.cases.values()),),
            devices=["cpu", "cpu"], timeout=LIMIT, n_space=2)}
        while (len(set(multiprocessing.active_children()) - before) < 2
               and not futures["ranks"].done()):
            time.sleep(0.05)
        futures["pallas"] = pool.submit(_cd_refs, cases, DAH, cases.dah_cfg,
                                        "float32")
        for d in ("float32", "bfloat16"):
            futures[d] = pool.submit(_cd_refs, cases, DD8, cases.cfg[d], d)
        futures["xbd_bit"] = pool.submit(_xbd_refs, cases)
        _RUNNING.append(futures)
        try:
            yield cases, _Results(cases, futures)
        finally:
            wait(futures.values(), timeout=2 * LIMIT)
            _RUNNING.clear()


class _Results:
    def __init__(self, cases, futures):
        self.cases, self.futures = cases, futures

    def ranks(self, name):
        """Each rank's result of the case ``name``."""
        i = list(self.cases.cases).index(name)
        return [r[i] for r in self["ranks"]]

    def __getitem__(self, key):
        return self.futures[key].result(timeout=2 * LIMIT)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_row_sharded_bit_eval_matches_jax_space_axis(launched, dname):
    """``_dd8``'s eval forward at 64 px, batch 2, rows over two ranks (the
    rank-split K3 and the decoder stack, K1's plain version, on each rank's
    rows): the gathered logits against the flax BIT on rows placed on the
    JAX space axis (1e-4 fp32, 5e-2 bf16) and against one process (1e-5,
    2e-2); each rank holds half the rows and every decoder takes the stack
    path, as on one process."""
    cases, res = launched
    ref = res[dname]["logits"]
    one = cases.one(f"dd8_{dname}")
    tol, own = (1e-4, 1e-5) if dname == "float32" else (5e-2, 2e-2)
    for g in res.ranks(f"dd8_{dname}"):
        assert _scaled(g["whole"], ref) <= tol
        assert _scaled(g["whole"], one["logits"]) <= own
        assert g["logits"].shape[1] * 2 == IMG
        assert g["paths"] == one["paths"] == {"transformer_decoder": "stack"}


@pytest.mark.parametrize("name", [T8, *VARIANTS])
def test_row_sharded_bit_variants_equal_one_process(launched, name):
    """``_t8_e2d4`` (8 tokens, hl 64), BIT with the simple decoder
    (``with_decoder=False``: the summed tokens on every pixel), BIT with a
    learned decoder positional embedding (16 rows at 64 px, each rank
    adding its 8) and BIT without the x2 upsampling (its decoder on the
    1/8 map, still a stride of 8): the gathered fp32 logits equal one
    process's within 1e-5."""
    cases, res = launched
    one = cases.one(name)
    for g in res.ranks(name):
        assert _scaled(g["whole"], one["logits"]) <= 1e-5
        assert g["paths"] == one["paths"]


def test_decoder_embedding_of_other_rows_raises_by_name():
    """Under a row-sharded grid a decoder positional embedding whose rows
    are not the ranks' rows together raises, naming it, before any
    collective."""
    model = BIT(**VARIANTS["decoder_pos"])
    mesh = Mesh(0, 2, torch.device("cpu"), "gloo", n_space=2)
    x = torch.zeros(1, 4, 16, 32)  # 4 rows a rank, 8 in all, not 16
    with space.grid(mesh, spatial=True), pytest.raises(
            ValueError, match="decoder positional embedding: 16 rows, the "
                              "ranks hold 8"):
        model._decode(x, torch.zeros(1, 4, 32))


def _one_moved(cases, name, i):
    """One process's step ``name`` with its augmented images moved by 1e-6
    (draw ``i``)."""
    from dahitra_tpu_torch.train import engine, xbd_engine

    _drain()
    mod, fn, n_img = ((engine, "augment_pairs", 2)
                      if cases.cases[name][1][0] == "cd"
                      else (xbd_engine, "augment_xbd", 1))
    aug = getattr(mod, fn)
    gen = torch.Generator().manual_seed(100 + i)

    def moved(*a, **k):
        return tuple(t + 1e-6 * torch.randn(t.shape, generator=gen).to(
            t.dtype) if j < n_img else t for j, t in enumerate(aug(*a, **k)))

    setattr(mod, fn, moved)
    try:
        return cases.run(name)
    finally:
        setattr(mod, fn, aug)


def _rule5(errs, flat, moves):
    """max(``flat``, the median of ``moves()``) where an error in ``errs``
    passes ``flat``, else ``flat`` (ROADMAP rule 5)."""
    if max(errs) <= flat:
        return flat
    return max(flat, float(np.median(moves())))


def _cosine(a: dict, b: dict) -> float:
    x = torch.cat([a[k].float().ravel() for k in b])
    y = torch.cat([b[k].float().ravel() for k in b])
    return float(x @ y / (x.norm() * y.norm()))


def _held_to_one_process(cases, name, got, one, bf16=False):
    """Two ranks' step against one process's: loss 1e-5 relative,
    gradients max(1e-4, rule 5 on one process), statistics 1e-5 (bf16: the
    loss and statistics 2e-2, the gradients' cosine 0.99, the bf16 bound
    of tests/test_torch_dahitra.py); both ranks with the same gradient and
    statistics bits."""
    l_tol, s_tol = (2e-2, 2e-2) if bf16 else (1e-5, 1e-5)
    errs = [_grad_err(g["grads"], one["grads"]) for g in got]
    g_tol = None if bf16 else _rule5(errs, 1e-4, lambda: [
        _grad_err(_one_moved(cases, name, i)["grads"], one["grads"])
        for i in range(4)])
    for g, err in zip(got, errs):
        torch.testing.assert_close(g["loss"], one["loss"], rtol=l_tol, atol=0)
        if bf16:
            assert _cosine(g["grads"], one["grads"]) >= 0.99
        else:
            assert err <= g_tol, (err, g_tol)
        assert max((_scaled(g["stats"][k], one["stats"][k])
                    for k in one["stats"]), default=0.0) <= s_tol
    for k in ("grads", "stats"):
        assert got[0][k].keys() == got[1][k].keys()
        assert all(torch.equal(got[0][k][n], got[1][k][n]) for n in got[0][k])


def _held_to_jax(got, loss, grads, new_stats, jax_moves):
    """Two ranks' fp32 step against JAX's: loss 1e-5 relative, gradients
    max(1e-3, rule 5 on JAX: ``jax_moves()``), statistics 1e-4."""
    want = {k: grads[k] for k in got[0]["grads"]}
    errs = [_grad_err(g["grads"], want) for g in got]
    bound = _rule5(errs, 1e-3, lambda: [_grad_err(
        {k: m[k] for k in want}, want) for m in jax_moves()])
    for g, err in zip(got, errs):
        assert abs(float(g["loss"][0]) - float(loss)) <= 1e-5 * abs(
            float(loss))
        assert err <= bound, (err, bound)
        for k, t in g["stats"].items():
            assert float((t - new_stats[k]).abs().max()) <= 1e-4 * max(
                float(new_stats[k].abs().max()), 1e-3), k


def _clipped(grads: dict, norm: float = 0.999) -> dict:
    """The gradients scaled to a global norm of at most ``norm``: the xBD
    trainer's clip before its optimizer step (``train/optim.py``), which
    leaves them so in the parameters' ``grad``."""
    total = float(torch.sqrt(sum(g.double().square().sum()
                                 for g in grads.values())))
    return {k: g * (norm / max(total, norm)) for k, g in grads.items()}


def _moved(x, i):
    return x + (1e-6 * np.random.RandomState(100 + i).normal(
        size=x.shape)).astype(np.float32)


def _jax_moves(ref, convert):
    """The fp32 JAX step's gradients (``_cd_refs``'s ``ref``) under four
    1e-6 moves of its augmented images, as state dicts (``convert``)."""
    a, b, label = ref["batch"]
    fn, p, s = _jax_fn(ref["key"], "float32"), ref["params"], ref["stats"]
    return [convert(jax.tree.map(np.asarray, fn(*ref["eval"], p, s, *_sharded(
        _moved(_np(a), i), _moved(_np(b), i), label.numpy().astype(
            np.int32)))[1][1]), s) for i in range(4)]


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_row_sharded_bit_train_step_matches_jax(launched, dname):
    """``CDTrainer.train_step(spatial=True)`` of ``_dd8`` at 64 px, batch
    2, on two ranks of 32 rows (K1-save and K2 on each rank's rows, the
    rank-split K3): the loss, the gradients averaged over the ranks and
    the running statistics after it against ``jax.value_and_grad`` of the
    flax model's train-mode loss on the trainer's weights and augmented
    batch, on rows placed on the JAX space axis (loss 1e-5 relative,
    gradients 1e-3 of scale or rule 5 on JAX, statistics 1e-4; bf16 the
    loss 2e-2 relative), and against one process's step (gradients under
    rule 5 on one process: with the trainer's N(0, 0.02) weights its own
    moves read 2.0e-3 to 3.6e-3 of scale, the ranks 1.4e-3; in bf16 the
    gradients' cosine: one process's bf16 gradient of ``resnet.conv1``
    lies 0.26 of scale from its fp32 one, the ranks' 8.6e-2 from it)."""
    cases, res = launched
    ref = res[dname]
    step, params, stats = ref["step"], ref["params"], ref["stats"]
    name = f"step_{dname}"
    got = res.ranks(name)
    if dname == "bfloat16":
        for g in got:
            assert abs(float(g["loss"][0]) - float(step[0])) <= 2e-2 * abs(
                float(step[0]))
    else:
        (loss, new), grads = step
        _held_to_jax(got, loss, bit_flax_to_state_dict(grads, stats),
                     bit_flax_to_state_dict(params, new),
                     lambda: _jax_moves(ref, bit_flax_to_state_dict))
    _held_to_one_process(cases, name, got, cases.one(name),
                         dname == "bfloat16")


def test_row_sharded_xbd_bit_damage_step_matches_jax(launched):
    """``XBDTrainer.train_step(spatial=True)`` (damage) of ``xbd_bit`` at
    64 px, batch 2 (a changed post quarter), on two ranks: the loss, the
    gradients averaged over the ranks and the running statistics against
    ``jax.value_and_grad`` of the flax damage loss on the trainer's weights
    and augmented batch (loss 1e-5 relative,
    gradients 1e-3 of scale or rule 5 on JAX, after the trainer's clip to
    a global norm of 0.999, statistics 1e-4), and
    against one process's step (module docstring; gradients under rule 5
    on one process)."""
    cases, res = launched
    ref = res["xbd_bit"]
    step, p, s = ref["step"], ref["params"], ref["stats"]
    img6, masks = ref["batch"]
    (loss, new), grads = ref["out"]
    got = res.ranks("xbd_bit_step")

    def torch_grads(g):
        sd = bit_flax_to_state_dict(jax.tree.map(np.asarray, g), s)
        return _clipped({k: sd[k] for k in got[0]["grads"]})

    _held_to_jax(got, loss, torch_grads(grads), bit_flax_to_state_dict(
        p, new), lambda: [torch_grads(step(
            p, _moved(img6, i), masks)[1]) for i in range(4)])
    _held_to_one_process(cases, "xbd_bit_step", got,
                         cases.one("xbd_bit_step"))


def test_row_sharded_pallas_dahitra_matches_flax(launched):
    """``newUNetTrans`` at 64 px, batch 2, with ``pallas = True`` on its
    three decoders, rows over two ranks: at 1/4 scale the global n 256
    takes K4 (its plain version on the CPU) on each rank's 128 rows, the
    1/8 decoder (n 64) falls through to the stack and the 1/16 one (n 16,
    not above 4 tokens' 16) to the layer loop, as in the flax model traced
    on the whole image; the gathered eval logits against the flax
    ``DAHiTraUNet`` built ``pallas=True`` with the Pallas K4 in interpret
    mode, on rows placed on the JAX space axis (1e-4), and one process
    (1e-5)."""
    cases, res = launched
    ref = res["pallas"]["logits"]
    one = cases.one("pallas_forward")
    paths = {"transformer_decoder_3": "fused",
             "transformer_decoder_4": "stack",
             "transformer_decoder_5": "layers"}
    assert one["paths"] == paths
    for g in res.ranks("pallas_forward"):
        assert _scaled(g["whole"], ref) <= 1e-4
        assert _scaled(g["whole"], one["logits"]) <= 1e-5
        assert g["paths"] == paths


def test_row_sharded_pallas_dahitra_step_matches_jax(launched):
    """``CDTrainer.train_step(spatial=True)`` of ``newUNetTrans`` with
    ``pallas = True`` at 64 px, batch 2, on two ranks of 32 rows: each
    rank's K4 backward gives its rows' part of the memory tokens' gradient,
    which the rank-split K3's backward sums over the ranks. The loss, the
    gradients averaged over the ranks and the running statistics after it
    against ``jax.value_and_grad`` of the flax ``DAHiTraUNet`` built
    ``pallas=True`` (the Pallas K4 in interpret mode) on the trainer's
    weights and augmented batch, on rows placed on the JAX space axis (loss
    1e-5 relative, gradients 1e-3 of scale or rule 5 on JAX, statistics
    1e-4), and against one process's step (module docstring; gradients
    under rule 5 on one process); both ranks with the same gradient and
    statistics bits."""
    cases, res = launched
    ref = res["pallas"]
    (loss, new), grads = ref["step"]
    got = res.ranks("pallas_step")
    assert len(got[0]["grads"]) == 314
    _held_to_jax(got, loss, flax_to_state_dict(grads, ref["stats"]),
                 flax_to_state_dict(ref["params"], new),
                 lambda: _jax_moves(ref, flax_to_state_dict))
    _held_to_one_process(cases, "pallas_step", got, cases.one("pallas_step"))


def test_row_sharded_pallas_bit_follows_the_global_gate(launched):
    """``_dd8`` with ``pallas = True`` (K4 at mlp_dim 64) on a 64 x 32
    input over two ranks: the 1/4-scale decoder's global n of 128 takes a
    tile and a rank's 64 would not; each rank takes K4 as one process does
    on the whole image, the gathered logits within 1e-5 of one
    process's."""
    cases, res = launched
    assert pick_tile(16 * 8) == 128 and pick_tile(8 * 8) is None
    one = cases.one("pallas_bit")
    assert one["paths"] == {"transformer_decoder": "fused"}
    for g in res.ranks("pallas_bit"):
        assert g["paths"] == one["paths"]
        assert _scaled(g["whole"], one["logits"]) <= 1e-5


# n global, rank's n, memory tokens, heads, pallas: the rank's n alone
# would decide otherwise in the cases marked so
GATES = {"fused_global_tile": (128, 64, 4, 8, True),
         "fused_both": (512, 256, 4, 8, True),
         "untileable": (200, 100, 4, 8, True),
         "stack_global_only": (32, 16, 4, 8, None),
         "stack_both": (256, 128, 4, 8, None),
         "hl_136": (256, 128, 17, 8, True)}


@pytest.mark.parametrize("case", list(GATES))
def test_gate_under_a_grid_decides_as_flax_on_global_shapes(case,
                                                            monkeypatch):
    """``TransformerDecoder``'s gate under a row-sharded grid of two ranks,
    given a rank's rows: K4 (``uses_fused``) or the stack (``uses_stack``)
    exactly where the flax module, traced on the whole rows as GSPMD
    traces it, calls ``make_fused_decoder`` or ``decoder_stack_auto``
    (each recorded by a stand-in), including where the rank's n alone
    would decide otherwise."""
    _drain()
    n, n_rank, l, heads, pallas = GATES[case]
    chose = []
    monkeypatch.setattr(jfd, "make_fused_decoder", lambda d, h, t, dt: (
        chose.append("fused") or (lambda x, m, p: x)))
    import dahitra_tpu.nn.decoder_vjp as jvjp

    monkeypatch.setattr(jvjp, "decoder_stack_auto", lambda x, *a: (
        chose.append("stack") or x))
    jdec = JaxDecoder(32, 2, heads, 16, 32, pallas=pallas)
    x = jax.ShapeDtypeStruct((1, n, 32), jnp.float32)
    m = jax.ShapeDtypeStruct((1, l, 32), jnp.float32)
    params = jax.eval_shape(jdec.init, jax.random.PRNGKey(0), x, m)
    jax.eval_shape(jdec.apply, params, x, m)  # traced, as under jit
    want = chose[0] if chose else "layers"
    port = blocks.TransformerDecoder(32, 2, heads, 16, 32, pallas=pallas)
    took = []
    monkeypatch.setattr(blocks.FusedDecoderFn, "apply", lambda *a: (
        took.append("fused") or a[3]))
    monkeypatch.setattr(blocks, "decoder_stack", lambda x, *a: (
        took.append("stack") or x))
    mesh = Mesh(0, 2, torch.device("cpu"), "gloo", n_space=2)
    with space.grid(mesh, spatial=True), torch.no_grad():
        port(torch.zeros(1, n_rank, 32), torch.zeros(1, l, 32))
    assert (took[0] if took else "layers") == want
    alone = ("fused" if port.uses_fused(n_rank, l, 32) else "stack"
             if port.uses_stack(n_rank, l, 32) else "layers")
    assert (alone != want) == case.endswith(("global_tile", "global_only"))


@pytest.mark.parametrize("key", BIT_KEYS)
def test_every_bit_key_runs_row_sharded(launched, key):
    """Every BIT key of the registry and ``xbd_bit`` have a
    ``space_stride`` of 8 and run an eval forward on two ranks' rows, the
    gathered fp32 logits within 1e-5 of one process's."""
    cases, res = launched
    assert define_g(key).space_stride == 8
    name = "dd8_float32" if key == DD8 else key
    one = cases.one(name)
    for g in res.ranks(name):
        assert g["whole"].shape == one["logits"].shape
        assert _scaled(g["whole"], one["logits"]) <= 1e-5


def test_row_sharded_bit_evaluation_equals_one_process(launched):
    """``CDEvaluator.eval_models(spatial=True)`` of ``_dd8`` over 3 pairs
    at batch 2 (a ragged last batch) with per-patch groups, rows over two
    ranks: the summed matrix and the per-group scores those of one
    process, each pixel counted once."""
    cases, res = launched
    one = cases.one("bit_eval_models")
    for g in res.ranks("bit_eval_models"):
        assert torch.equal(g["cm"], one["cm"])
        assert int(g["cm"].sum()) == 3 * IMG * IMG
        assert g["scores"]["per_group"] == one["scores"]["per_group"]


@pytest.mark.parametrize("key", sorted(set(PORTED) - ROWS_KEYS))
def test_keys_outside_the_space_axis_refuse_row_sharding(key):
    """Every other key of the registry has no ``space_stride`` and refuses
    row-sharded batches by name (``space.shard_rows``), before any
    collective."""
    with torch.device("meta"):
        model = define_g(key, img_size=IMG)
    assert getattr(model, "space_stride", None) is None
    mesh = Mesh(0, 2, torch.device("cpu"), "gloo", n_space=2)
    with space.grid(mesh, spatial=True), pytest.raises(
            ValueError, match=f"{type(model).__name__} does not run on "
                              "row-sharded batches"):
        space.shard_rows(model, torch.zeros(1, IMG, IMG, 3))
