"""The port's xBD damage path against the JAX package's, on the CPU.

Data (``data/xbd.py``: masks, the split with its numpy draw against
sklearn's, the loader), the augmentation ops on given draws
(``data/xbd_augment.py`` against the JAX internals), the ComboLoss members
and the damage loss with their gradients (``losses/combo.py``), the
``xbd_dahitra`` and ``xbd_bit`` forwards and one damage train step
(``models/registry.py``, weights crossed with ``flax_to_state_dict(xbd=
True)`` and ``bit_flax_to_state_dict``), the validation counters against
the JAX ``_eval_step_impl``, the TTA views, and ``xbd_train`` /
``xbd_predict`` end to end with ``--device cpu``. Inputs are seeded numpy
handed to both packages. Tolerances: masks, split, loader and counters
exact; augmentation 1e-6; losses and their gradients 1e-5 (fp32),
scale-normalized; the fp32 forwards 1e-5. The model tests read a changed
scene: the post half of the input at half the contrast of the pre half.
On two halves drawn alike both dates give nearly the same tokens, so the
decoder's memory, their difference (about 0.04 against tokens of 6.6), is
a cancellation: JAX's own fp32 logits then move by 3.0e-5 of their scale
under a 1e-6 input move, and its bf16 logits lie 0.26 from its fp32 ones. On the changed scene the fp32 move is 2e-6. Two
bounds are set by the JAX package against itself, as tests/test_torch_bit.py
does, and each test says how:

* bf16 forwards: two bf16 implementations that round at different points
  lie about as far apart as each lies from fp32, and JAX's bf16 logits lie
  2.5e-2 (xbd_dahitra) and 2.7e-2 (xbd_bit) of the scale from its fp32 ones
  here, above 2e-2. The port's bf16 logits must lie within 1.25 times that
  distance of JAX's bf16 and of its fp32 logits, and at least half that
  distance from the port's own fp32 logits, which a port that computes in
  fp32 fails;
* the train step's gradients, 1e-3 of the whole gradient's scale (ROADMAP
  fault 5), or the median of JAX's own deviations under four input moves
  of 1e-6 where that is larger. Such a move shifts JAX's train-mode logits
  1.5 to 2.5 times as far as the port's lie from them (the test checks
  that the two are of a size), so it is the rounding the port brings. The
  gradient jumps where a ReLU input within that rounding of zero flips:
  xbd_dahitra's port reads 8.6e-5, xbd_bit's 1.6e-3 (one ReLU of
  layer1.1, whose input is -3.0e-6 in JAX and 2.6e-7 in the port), and
  JAX's own deviations read 1.6e-4 to 2.4e-2 and 9.5e-5 to 1.1e-2.
"""
import functools
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax import traverse_util
from sklearn.model_selection import train_test_split

from dahitra_tpu.cli import xbd_predict as jpredict
from dahitra_tpu.data import xbd as jxbd
from dahitra_tpu.data import xbd_augment as jaug
from dahitra_tpu.losses import combo as jcombo
from dahitra_tpu.models.registry import define_g as jax_define_g
from dahitra_tpu.nn.init import zoo_ctor_init_variables
from dahitra_tpu.train.xbd_engine import XBDTrainer as JaxXBDTrainer
from dahitra_tpu_torch.cli import xbd_predict, xbd_train
from dahitra_tpu_torch.core.checkpoint import load_checkpoint, load_weights
from dahitra_tpu_torch.core.flax_import import (bit_flax_to_state_dict,
                                                flax_to_state_dict)
from dahitra_tpu_torch.data import xbd
from dahitra_tpu_torch.data import xbd_augment as aug
from dahitra_tpu_torch.data.synthetic import write_synthetic_xbd
from dahitra_tpu_torch.losses import combo
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.train.xbd_engine import damage_counts

IMG = 64
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FWD_TOL = 1e-5


def _close(got, ref, tol):
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    sc = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(got / sc, ref / sc, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A seeded synthetic xBD tree of 12 tiles of 64 px."""
    root = str(tmp_path_factory.mktemp("xbd") / "train")
    write_synthetic_xbd(root, n_tiles=12, size=IMG, seed=3, block=8)
    return root


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("merge_34", [False, True])
def test_damage_masks_match_jax(train, merge_34):
    rng = np.random.RandomState(1)
    loc = np.where(rng.rand(32, 32) < 0.4, 255, 0).astype(np.uint8)
    dmg = rng.randint(0, 5, (32, 32)).astype(np.uint8)
    got = xbd.build_damage_masks(loc, dmg, train, merge_34)
    ref = jxbd.build_damage_masks(loc, dmg, train, merge_34)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_split_draw_matches_sklearn(seed):
    for n in (2, 8, 9, 10, 11, 37, 100, 1001):
        train, test = xbd._train_test_split(n, seed)
        ref_train, ref_test = train_test_split(np.arange(n), test_size=0.1,
                                               random_state=seed)
        np.testing.assert_array_equal(train, ref_train)
        np.testing.assert_array_equal(test, ref_test)
    for split in (xbd._train_test_split,
                  lambda n, s: train_test_split(np.arange(n), test_size=0.1,
                                                random_state=s)):
        with pytest.raises(ValueError):
            split(1, seed)


@pytest.mark.parametrize("policy", ["random", "multi"])
def test_scan_split_and_loader_match_jax(tree, policy):
    """File scan, class presence, the split with upsampling and the decoded
    arrays of both parts (the train part cropped to 48 px)."""
    files = xbd.scan_xbd_files([tree])
    assert files == jxbd.scan_xbd_files([tree]) and len(files) == 12
    np.testing.assert_array_equal(xbd.file_class_presence(files),
                                  jxbd.file_class_presence(files))
    for seed in (0, 5):
        got = xbd.split_and_upsample(files, seed=seed, policy=policy)
        ref = jxbd.split_and_upsample(files, seed=seed, policy=policy)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    train_idx, val_idx = got
    for idx, train, crop in ((train_idx, True, 48), (val_idx, False, None)):
        sel = [files[i] for i in idx]
        g = xbd.load_xbd_pairs(sel, train, crop_size=crop, seed=2)
        r = jxbd.load_xbd_pairs(sel, train, crop_size=crop, seed=2)
        assert g.files == r.files
        for k, v in r.arrays().items():
            assert g.arrays()[k].dtype == v.dtype
            np.testing.assert_array_equal(g.arrays()[k], v, err_msg=k)


def test_adaptation_loader_matches_jax(tree):
    """merge_34 and the xBD -> IdaBD colour renormalization."""
    files = xbd.scan_xbd_files([tree])[:3]
    g = xbd.load_xbd_pairs(files, True, merge_34=True, color_normalize=True)
    r = jxbd.load_xbd_pairs(files, True, merge_34=True, color_normalize=True)
    for k, v in r.arrays().items():
        np.testing.assert_array_equal(g.arrays()[k], v, err_msg=k)
    assert g.msk.shape[-1] == 4


# ---------------------------------------------------------------- augmentation

def _jax_draws(key, h):
    """The draws ``_augment_one`` makes from ``key``, as ``draw_xbd``'s
    dict."""
    (k_apply, k_h, k_v, k_rc, k_xy, k_cj, k_cjk, *_) = jax.random.split(key, 9)
    block = bool(jax.random.bernoulli(k_apply, 0.3))
    xy = np.asarray(jax.random.randint(k_xy, (2,), 0, min(200, h // 4) + 1))
    kb, kc, ks = jax.random.split(k_cjk, 3)
    fac = [float(jax.random.uniform(k, (), minval=0.8, maxval=1.2))
           for k in (kb, kc, ks)]
    return {"hflip": block and bool(jax.random.bernoulli(k_h, 0.7)),
            "vflip": block and bool(jax.random.bernoulli(k_v, 0.7)),
            "crop": block and bool(jax.random.bernoulli(k_rc, 0.7)),
            "xy": xy, "jitter": block and bool(jax.random.bernoulli(k_cj, 0.3)),
            "factors": np.asarray(fac, np.float32)}


def _sample(seed, h=40, w=40):
    rng = np.random.RandomState(seed)
    pre = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    post = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    msk = (rng.rand(h, w, 5) < 0.3).astype(np.float32)
    lbl = rng.randint(0, 4, (h, w)).astype(np.int32)
    return pre, post, msk, lbl


@pytest.mark.parametrize("xy", [(0, 0), (3, 7), (10, 1)])
def test_samplers_and_crop_grid_match_jax(xy):
    pre, _, msk, _ = _sample(0)
    h, w = pre.shape[:2]
    x, y = (np.float32(v) for v in xy)
    rows, cols = jaug._resized_crop_grid(h, w, jnp.asarray(x), jnp.asarray(y))
    trows, tcols = aug.resized_crop_grid(h, w, torch.tensor([x]),
                                         torch.tensor([y]))
    _close(trows[0], rows, 1e-6)
    _close(tcols[0], cols, 1e-6)
    _close(aug.bilinear_sample(torch.from_numpy(pre)[None], trows, tcols)[0],
           jaug._bilinear_sample(jnp.asarray(pre), rows, cols), 1e-6)
    np.testing.assert_array_equal(
        aug.nearest_sample(torch.from_numpy(msk)[None], trows, tcols)[0],
        jaug._nearest_sample(jnp.asarray(msk), rows, cols))


def test_color_jitter_matches_jax():
    pre = _sample(1)[0]
    key = jax.random.PRNGKey(3)
    ref = jaug._color_jitter(jnp.asarray(pre), key)
    kb, kc, ks = jax.random.split(key, 3)
    fac = [torch.tensor([float(jax.random.uniform(k, (), minval=0.8,
                                                  maxval=1.2))])
           for k in (kb, kc, ks)]
    _close(aug.color_jitter(torch.from_numpy(pre)[None], *fac)[0], ref, 1e-6)


def test_augment_on_jax_draws_matches_augment_one():
    """``apply_xbd`` on the draws ``_augment_one`` makes from a key equals
    ``_augment_one``, for keys whose block applies (flips, crop and jitter
    among them) and one where it does not."""
    cases, ops = [], set()
    for k in range(200):
        key = jax.random.PRNGKey(k)
        d = _jax_draws(key, 40)
        on = {n for n in ("hflip", "vflip", "crop", "jitter") if d[n]}
        if (on - ops) or (not on and not cases):
            cases.append((key, d))
            ops |= on
        if ops == {"hflip", "vflip", "crop", "jitter"} and len(cases) >= 3:
            break
    assert ops == {"hflip", "vflip", "crop", "jitter"}
    for i, (key, d) in enumerate(cases):
        pre, post, msk, lbl = _sample(10 + i)
        ref = jaug._augment_one(*(jnp.asarray(t) for t in (pre, post, msk,
                                                           lbl)), key)
        draws = {k: torch.tensor(np.asarray(v)).reshape(1, *np.shape(v))
                 for k, v in d.items()}
        got = aug.apply_xbd(*(torch.from_numpy(t)[None]
                              for t in (pre, post, msk, lbl)), draws)
        for g, r in zip(got[:2], ref[:2]):
            _close(g[0], r, 1e-6)
        np.testing.assert_array_equal(got[2][0].numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(got[3][0].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_eval_inputs_match_jax(dname):
    """The eval branch: the 6-channel x / 127 - 1 input, masks and labels;
    the train branch's shapes, ranges and mask values on a generator; and
    with ``elastic`` the same masks and labels, and the same images where
    the gate does not fire (the jitter draws after the block's draws)."""
    rng = np.random.RandomState(4)
    pre, post = (rng.randint(0, 256, (2, 24, 24, 3)).astype(np.uint8)
                 for _ in "ab")
    msk = (rng.rand(2, 24, 24, 5) < 0.3).astype(np.uint8)
    lbl = rng.randint(0, 4, (2, 24, 24)).astype(np.uint8)
    ref = jaug.augment_xbd(pre, post, msk, lbl, jax.random.PRNGKey(0),
                           train=False, dtype=JDT[dname])
    got = aug.augment_xbd(*(torch.from_numpy(t) for t in (pre, post, msk,
                                                          lbl)),
                          train=False, dtype=TDT[dname])
    assert got[0].dtype == TDT[dname]
    _close(got[0], np.asarray(ref[0], np.float32), 1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _close(aug.normalize_xbd(torch.from_numpy(pre)),
           jaug.normalize_xbd(jnp.asarray(pre)), 1e-6)
    gen = torch.Generator().manual_seed(0)
    img6, m, lb = aug.augment_xbd(*(torch.from_numpy(t) for t in
                                    (pre, post, msk, lbl)), gen, train=True)
    assert img6.shape == (2, 24, 24, 6) and img6.abs().max() <= 255 / 127 - 1
    assert set(np.unique(m.numpy())) <= {0.0, 1.0} and lb.dtype == torch.long
    img6_el, m_el, lb_el = aug.augment_xbd(
        *(torch.from_numpy(t) for t in (pre, post, msk, lbl)),
        torch.Generator().manual_seed(0), train=True, elastic=True)
    assert torch.equal(m_el, m) and torch.equal(lb_el, lb)
    same = (img6_el == img6).flatten(1).all(1)
    assert same.sum() >= 1 and img6_el.shape == img6.shape


# ---------------------------------------------------------------- losses

MEMBERS = ["bce", "dice", "jaccard", "focal", "lovasz", "lovasz_sigmoid",
           "mask_bceavg"]


def _loss_inputs(seed, ignore=False):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.normal(size=(2, 12, 12))).astype(np.float32)
    target = (rng.rand(2, 12, 12) < 0.4).astype(np.float32)
    if ignore:
        target[rng.rand(2, 12, 12) < 0.1] = 255.0
    return logits, target


def _grad_close(fn_t, fn_j, logits, target, tol=1e-5):
    x = torch.from_numpy(logits).requires_grad_()
    val = fn_t(x, torch.from_numpy(target))
    (g,) = torch.autograd.grad(val, x)
    ref, rg = jax.value_and_grad(fn_j)(jnp.asarray(logits),
                                       jnp.asarray(target))
    _close(val, ref, tol)
    _close(g, rg, tol)


@pytest.mark.parametrize("member", MEMBERS)
def test_combo_members_and_grads_match_jax(member):
    """Each member alone through ComboLoss (weight 1), its value and its
    gradient; ``per_image`` for the Lovasz members too."""
    logits, target = _loss_inputs(5)
    for per_image in ((False, True) if member.startswith("lovasz")
                      else (False,)):
        _grad_close(combo.ComboLoss({member: 1.0}, per_image),
                    jcombo.ComboLoss({member: 1.0}, per_image), logits, target)


@pytest.mark.parametrize("fn", ["focal_loss_2d", "lovasz_hinge",
                                "lovasz_sigmoid"])
def test_ignore_index_matches_jax(fn):
    """Pixels at 255 drop out of the focal and Lovasz members."""
    logits, target = _loss_inputs(6, ignore=True)
    probs = fn != "lovasz_hinge"

    def wrap(f, sig):
        return lambda x, t: f(sig(x) if probs else x, t)

    _grad_close(wrap(getattr(combo, fn), torch.sigmoid),
                wrap(getattr(jcombo, fn), jax.nn.sigmoid), logits, target)


def test_damage_and_localization_losses_match_jax():
    rng = np.random.RandomState(8)
    logits = rng.normal(size=(2, 16, 16, 5)).astype(np.float32)
    masks = (rng.rand(2, 16, 16, 5) < 0.3).astype(np.float32)
    _grad_close(combo.xbd_damage_loss, jcombo.xbd_damage_loss, logits, masks)
    _grad_close(combo.xbd_localization_loss, jcombo.xbd_localization_loss,
                logits, masks[..., 0])
    assert combo.XBD_CLASS_WEIGHTS == jcombo.XBD_CLASS_WEIGHTS


# ---------------------------------------------------------------- models

def _perturb(tree, rng):
    """Seeded numpy biases, BN means and variances over a flax tree."""
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, tree))
    out = {}
    for k, v in flat.items():
        if k[-1] in ("bias", "mean"):
            v = v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
        elif k[-1] == "var":
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        out[k] = v
    return traverse_util.unflatten_dict(out)


@functools.lru_cache(maxsize=None)
def _flax_case(key):
    """(x6 (2, 64, 64, 6), params, batch_stats) of the flax model ``key``,
    seeded; the post half at half the contrast of the pre half."""
    rng = np.random.RandomState(0)
    x6 = rng.uniform(-1, 1, (2, IMG, IMG, 6)).astype(np.float32)
    x6[..., 3:] *= 0.5
    variables = jax.jit(lambda k, x: jax_define_g(key, img_size=IMG).init(
        k, x, None))(jax.random.PRNGKey(0), jnp.asarray(x6))
    return (x6, _perturb(variables["params"], rng),
            _perturb(variables["batch_stats"], rng))


def _state_dict(key, params, stats):
    if key == "xbd_bit":
        return bit_flax_to_state_dict(params, stats)
    return flax_to_state_dict(params, stats, xbd=True)


def _port(key, params, stats, dtype=torch.float32):
    model = define_g(key, dtype=dtype, img_size=IMG)
    load_weights(model, _state_dict(key, params, stats))
    return model


def _jax_logits(key, dname, params, stats, x6):
    return np.asarray(jax.jit(lambda p, s, x: jax_define_g(
        key, img_size=IMG, dtype=JDT[dname]).apply(
            {"params": p, "batch_stats": s}, x.astype(JDT[dname]), None,
            False))(params, stats, x6), np.float32)


def _scaled(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _port_logits(key, dname, params, stats, x6):
    with torch.no_grad():
        got = _port(key, params, stats, TDT[dname]).eval()(
            torch.from_numpy(x6).to(TDT[dname]))
    assert got.shape == (2, IMG, IMG, 5) and got.dtype == TDT[dname]
    return got.float().numpy()


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", ["xbd_dahitra", "xbd_bit"])
def test_forward_matches_flax(key, dname):
    """The eval forward on the 6-channel input, 5 logits per pixel: fp32
    to 1e-5; bf16 within 1.25 times JAX's own bf16-to-fp32 distance of
    JAX's bf16 and fp32 logits, and at least half that distance from the
    port's fp32 logits (module docstring)."""
    x6, params, stats = _flax_case(key)
    ref = _jax_logits(key, dname, params, stats, x6)
    got = _port_logits(key, dname, params, stats, x6)
    if dname == "float32":
        _close(got, ref, FWD_TOL)
        return
    ref32 = _jax_logits(key, "float32", params, stats, x6)
    own = _scaled(ref, ref32)
    for err in (_scaled(got, ref), _scaled(got, ref32)):
        assert err <= 1.25 * own, (err, own)
    rounding = _scaled(got, _port_logits(key, "float32", params, stats, x6))
    assert rounding >= 0.5 * own, (rounding, own)


def test_xbd_dahitra_has_no_date_decode():
    """pos_coarsest_only gives decode_dates False: the decoder runs once per
    scale (the difference), three calls per forward."""
    model = define_g("xbd_dahitra", img_size=IMG)
    assert not model.decode_dates
    assert not any(k.endswith(("_4", "_5")) for k in model.state_dict()
                   if k.startswith("pos_embedding"))


@pytest.mark.parametrize("key", ["xbd_dahitra", "xbd_bit"])
def test_zoo_ctor_init_is_a_no_op(key):
    """The JAX trainer's ``zoo_ctor_init_variables`` re-draws only
    conv6..conv10 and res modules; neither model has one, so it returns the
    variables unchanged and the port has nothing to port."""
    _, params, stats = _flax_case(key)
    variables = {"params": params, "batch_stats": stats}
    out = zoo_ctor_init_variables(variables, jax.random.PRNGKey(7))
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("key", ["xbd_dahitra", "xbd_bit"])
def test_damage_train_step_grads_match_flax(key):
    """The train-mode forward, ``xbd_damage_loss`` and its gradients (fp32,
    no augmentation): the loss to 1e-5, the updated BN statistics to 1e-4,
    the gradients to 1e-3 of the whole gradient's scale or, where larger,
    the median of JAX's own deviations under four input moves of 1e-6,
    each of which moves JAX's logits about as far as the port's lie from
    them (module docstring)."""
    x6, params, stats = _flax_case(key)
    masks = (np.random.RandomState(9).rand(2, IMG, IMG, 5) < 0.3).astype(
        np.float32)
    model_j = jax_define_g(key, img_size=IMG)

    def loss_fn(p, x):
        logits, mut = model_j.apply({"params": p, "batch_stats": stats},
                                    x, None, True, mutable=["batch_stats"])
        return jcombo.xbd_damage_loss(logits.astype(jnp.float32),
                                      jnp.asarray(masks)), (
                                          mut["batch_stats"], logits)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (ref_loss, (ref_stats, ref_logits)), ref_grads = step(params,
                                                          jnp.asarray(x6))
    model = _port(key, params, stats)
    logits = model(torch.from_numpy(x6), train=True)
    loss = combo.xbd_damage_loss(logits.float(), torch.from_numpy(masks))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-5)
    named = dict(model.named_parameters())
    want = _state_dict(key, jax.tree.map(np.asarray, ref_grads), stats)
    scale = max(np.abs(want[k].numpy()).max() for k in named)

    def dist(grads):
        return max(np.abs(grads[k] - want[k].numpy()).max()
                   for k in named) / scale

    ref_logits = np.asarray(ref_logits)
    port_move = _scaled(logits.detach().numpy(), ref_logits)
    own = []
    for i in range(4):
        moved = x6 + 1e-6 * np.random.RandomState(100 + i).normal(
            size=x6.shape).astype(np.float32)
        (_, (_, m_logits)), m_grads = step(params, jnp.asarray(moved))
        ratio = _scaled(np.asarray(m_logits), ref_logits) / port_move
        assert 0.5 <= ratio <= 4.0, ratio
        own.append(dist({k: v.numpy() for k, v in _state_dict(
            key, jax.tree.map(np.asarray, m_grads), stats).items()}))
    port = dist({k: p.grad.numpy() for k, p in named.items()})
    assert port <= max(1e-3, float(np.median(own))), (port, own)
    new = _state_dict(key, params, jax.tree.map(np.asarray, ref_stats))
    for k, v in model.named_buffers():
        _close(v, new[k].numpy(), 1e-4)


# ---------------------------------------------------------------- validation

def test_eval_counters_match_jax_eval_step():
    """Dice per image and the per-class tp / fp / fn of one batch against
    the JAX trainer's ``_eval_step_impl``, on the same logits."""
    rng = np.random.RandomState(11)
    pre, post = (rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
                 for _ in "ab")
    loc = np.where(rng.rand(3, 32, 32) < 0.4, 255, 0).astype(np.uint8)
    dmg = rng.randint(0, 5, (3, 32, 32)).astype(np.uint8)
    pairs = [jxbd.build_damage_masks(loc[i], dmg[i], train=False)
             for i in range(3)]
    msk = np.stack([p[0] for p in pairs]).astype(np.uint8)
    lbl = np.stack([p[1] for p in pairs]).astype(np.uint8)
    msk[2] = 0  # an image without buildings
    logits = (2.0 * rng.normal(size=(3, 32, 32, 5))).astype(np.float32)
    stub = types.SimpleNamespace(
        task="damage", thr=0.3, dtype=jnp.float32,
        _apply_model=lambda *a, **k: jnp.asarray(logits))
    ref = JaxXBDTrainer._eval_step_impl(stub, None, None, pre, post, msk, lbl)
    probs = torch.sigmoid(torch.from_numpy(logits))
    _, masks, lbl_i = aug.augment_xbd(*(torch.from_numpy(t) for t in
                                        (pre, post, msk, lbl)), train=False)
    got = damage_counts(probs, masks, lbl_i, 0.3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_tta_views_match_jax():
    img = np.random.RandomState(12).rand(8, 10, 6).astype(np.float32)
    views = xbd_predict.tta_views(torch.from_numpy(img))
    np.testing.assert_array_equal(views.numpy(),
                                  np.asarray(jpredict.tta_views(img)))
    probs = np.random.RandomState(13).rand(4, 8, 10, 5).astype(np.float32)
    _close(xbd_predict.untta_mean(torch.from_numpy(probs)),
           jpredict.untta_mean(jnp.asarray(probs)), 1e-6)
    np.testing.assert_array_equal(
        xbd_predict.untta_mean(views).numpy(), img)


# ---------------------------------------------------------------- CLIs

@pytest.mark.parametrize("net", ["xbd_dahitra", "xbd_bit"])
def test_xbd_train_and_predict_on_cpu(tree, tmp_path, net):
    """``xbd_train --task damage`` for 2 epochs at 64 px, batch 2, then a
    resume of the same run to 3 epochs; ``xbd_predict`` with its
    checkpoint: the two PNGs per tile, loc in 0..255 and damage in 0..3;
    the task not ported (``hrnet``) raises by name."""
    args = ["--data_root", tree, "--net_G", net, "--img_size", str(IMG),
            "--batch_size", "2", "--eval_every", "1", "--checkpoint_root",
            str(tmp_path), "--project_name", net, "--device", "cpu"]
    history = xbd_train.main(args + ["--max_epochs", "2"])
    assert len(history) == 2
    for h in history:
        assert np.isfinite(h["loss"]) and np.isfinite(h["val"]["score"])
        assert 0.0 <= h["val"]["score"] <= 1.0
    ckpt = load_checkpoint(str(tmp_path / net))
    assert ckpt is not None
    resumed = xbd_train.main(args + ["--max_epochs", "3"])
    assert len(resumed) == 3 - (ckpt[1]["epoch_id"] + 1)
    out = tmp_path / "pred"
    written = xbd_predict.main(["--test_root", tree, "--net_G", net,
                                "--img_size", str(IMG), "--checkpoints",
                                str(tmp_path / net), "--out_dir", str(out),
                                "--device", "cpu"])
    assert len(written) == 2 * 12
    for name in written:
        png = np.array(Image.open(os.path.join(out, name)))
        assert png.shape == (IMG, IMG) and png.dtype == np.uint8
        if name.endswith("_part2.png"):
            assert png.max() <= 3
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        xbd_train.main(args + ["--task", "hrnet"])
