"""The rest of the port's xBD stack against the JAX package, on the CPU.

The ResNet34 UNets and the mask discriminator (``models/res34_unet.py``,
``models/discriminator.py``, weights crossed with
``res34_unet_flax_to_state_dict`` / ``discriminator_flax_to_state_dict``
and back through the JAX package's ``convert_res34_unet`` /
``convert_res34_double_modified``), the adaptation and GAN losses and the
deferred xBD members of ``losses/cd.py``, ``data/xbd_cd_augment.py`` (the
elastic jitter among its ops), ``nn/init.py`` ``zoo_ctor_init``, one
``loc``, ``adapt`` and GAN train step (with and without a discriminator
update) against the JAX trainer's own step code, the GAN step's three
BatchNorm rules, and ``xbd_train --task loc|adapt|gan`` and
``visualize_results`` end to end with ``--device cpu``. Inputs and weights
are seeded numpy handed to both packages, at 64 px and batch 2.

Tolerances, scale-normalized: the fp32 forwards 1e-5; the bf16 forwards
2e-2 of JAX's bf16 logits, or 1.25 times JAX's own bf16-to-fp32 distance
where that is larger (ROADMAP fault 5); the losses and their gradients
1e-6; the train steps' losses 1e-5, their BatchNorm statistics 1e-4 and
their gradients 1e-3 of the whole gradient's scale (fault 5), or the
median of JAX's own distance under four input moves of 1e-6 where larger,
in every output channel of every tensor but one, which may be off by up to
1e-2: the port's rounding moves the train-mode logits about as far as one
such move does, and where a ReLU input lies within that of zero the ReLU
flips and one output channel's weight gradient alone jumps (in the ``loc``
step one channel of ``conv3.2.conv1``, past 1e-3 while the rest of the
model stays below JAX's own moves). The
augmentation ops that only add, scale and floor integer-valued images are
exact; those that interpolate, take a histogram's CDF or smooth a field
within 1e-5 of the 0..255 scale (fp32 sums taken in another order).
The JAX steps run ``optax.sgd(1.0)`` (behind the generator's 0.999
global-norm clip) in place of AdamW, so that the gradient is the
parameters' change; the port's is read from ``.grad``, which its AdamW
clips in place.
Both sides skip the random augmentation (its eval branch), which
tests/test_torch_xbd.py holds on its own.
"""
import functools
import os
import types

import numpy as np
import optax
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax import traverse_util

from dahitra_tpu.core.state import TrainState
from dahitra_tpu.core.torch_import import (convert_res34_double_modified,
                                           convert_res34_unet)
from dahitra_tpu.data import xbd_augment as jaug
from dahitra_tpu.data import xbd_cd_augment as jcda
from dahitra_tpu.losses import cd as jcd
from dahitra_tpu.losses import combo as jcombo
from dahitra_tpu.models.discriminator import Discriminator as JaxDisc
from dahitra_tpu.models.registry import define_g as jax_define_g
from dahitra_tpu.nn.init import zoo_ctor_init_variables
from dahitra_tpu.train import xbd_engine as jengine
from dahitra_tpu_torch.cli import visualize_results, xbd_train
from dahitra_tpu_torch.core.checkpoint import load_checkpoint, load_weights
from dahitra_tpu_torch.core.flax_import import (
    discriminator_flax_to_state_dict, res34_unet_flax_to_state_dict)
from dahitra_tpu_torch.data import xbd
from dahitra_tpu_torch.data import xbd_cd_augment as cda
from dahitra_tpu_torch.data.synthetic import write_synthetic_xbd
from dahitra_tpu_torch.data.xbd_augment import augment_xbd
from dahitra_tpu_torch.losses import cd, combo
from dahitra_tpu_torch.models.discriminator import Discriminator
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.nn.init import init_random, zoo_ctor_init
from dahitra_tpu_torch.train import xbd_engine

IMG = 64
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# registry key -> input channels of its forward (3: one image)
RES34 = {"xbd_res34_loc": 3, "xbd_res34_single": 3, "xbd_res34_double": 6,
         "xbd_res34_double_modified": 6}


def _scaled(got, ref):
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fill(shapes, rng):
    """Seeded numpy values for a flax variables tree of shapes: lecun-normal
    kernels, biases and BN means ~ 0.1 N(0, 1), BN scales 1 + 0.1 N(0, 1),
    BN variances U(0.5, 1.5)."""
    out = {}
    for k, s in traverse_util.flatten_dict(shapes).items():
        if k[-1] == "kernel":
            v = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif k[-1] == "scale":
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
        elif k[-1] == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = 0.1 * rng.normal(size=s.shape)
        out[k] = v.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def _jax_model(key, dtype=jnp.float32):
    return JaxDisc(5, dtype=dtype) if key == "disc" else jax_define_g(
        key, dtype=dtype, img_size=IMG)


def _call_args(key):
    """The flax model's positional arguments after its input, train off."""
    return () if key == "disc" or RES34.get(key) == 3 else (None,)


@functools.lru_cache(maxsize=None)
def _case(key):
    """(input (2, 64, 64, C), params, batch_stats) of a model, seeded."""
    rng = np.random.RandomState(len(key))
    c = 5 if key == "disc" else RES34.get(key, 6)
    x = rng.uniform(-1, 1, (2, IMG, IMG, c)).astype(np.float32)
    shapes = jax.eval_shape(lambda a: _jax_model(key).init(
        jax.random.PRNGKey(0), a, *_call_args(key)), x)
    v = _fill(shapes, rng)
    return x, v["params"], v["batch_stats"]


def _state_dict(key, params, stats):
    if key == "disc":
        return discriminator_flax_to_state_dict(params, stats)
    return res34_unet_flax_to_state_dict(params, stats)


def _port(key, params, stats, dtype=torch.float32):
    model = Discriminator(5, dtype=dtype) if key == "disc" else define_g(
        key, dtype=dtype, img_size=IMG)
    load_weights(model, _state_dict(key, params, stats))
    return model


@functools.lru_cache(maxsize=None)
def _jax_logits(key, dname):
    x, params, stats = _case(key)
    model = _jax_model(key, JDT[dname])
    return np.asarray(jax.jit(lambda p, s, a: model.apply(
        {"params": p, "batch_stats": s}, a.astype(JDT[dname]),
        *_call_args(key)))(params, stats, x), np.float32)


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", [*RES34, "xbd_res34_double two images",
                                 "disc"])
def test_forward_matches_flax(key, dname):
    """Every ResNet34 UNet (the double one also on two 3-channel images)
    and the discriminator, eval mode: fp32 to 1e-5; bf16 to 2e-2 or 1.25
    times JAX's own bf16-to-fp32 distance, where larger."""
    two = key.endswith("two images")
    key = key.split()[0]
    x, params, stats = _case(key)
    ref = _jax_logits(key, dname)
    model = _port(key, params, stats, TDT[dname]).eval()
    xt = torch.from_numpy(x).to(TDT[dname])
    with torch.no_grad():
        got = model(xt[..., :3], xt[..., 3:]) if two else model(xt)
    assert got.dtype == TDT[dname]
    if dname == "float32":
        assert _scaled(got, ref) <= 1e-5
        return
    own = _scaled(ref, _jax_logits(key, "float32"))
    assert _scaled(got, ref) <= max(2e-2, 1.25 * own), (_scaled(got, ref), own)


@pytest.mark.parametrize("key", ["xbd_res34_loc", "xbd_res34_double",
                                 "xbd_res34_double_modified"])
def test_weights_cross_back_through_the_jax_converters(key):
    """The port's state_dict has exactly the keys the flax variables give,
    and ``convert_res34_unet`` / ``convert_res34_double_modified`` read them
    back to the same flax variables."""
    _, params, stats = _case(key)
    sd = _state_dict(key, params, stats)
    assert set(sd) == set(define_g(key, img_size=IMG).state_dict())
    convert = (convert_res34_double_modified if key.endswith("modified")
               else convert_res34_unet)
    back = convert({k: v.numpy() for k, v in sd.items()})
    for tree, want in zip(back, (params, stats)):
        got = traverse_util.flatten_dict(tree)
        ref = traverse_util.flatten_dict(want)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))


def test_zoo_ctor_init_touches_what_jax_touches():
    """``zoo_ctor_init`` re-draws the same tensors as
    ``zoo_ctor_init_variables`` (the decoder convs' and the head's kernels,
    N(0, 2 / fan_in), and zeroes their biases) and leaves the rest."""
    key = "xbd_res34_double_modified"
    _, params, stats = _case(key)
    out = zoo_ctor_init_variables({"params": params, "batch_stats": stats},
                                  jax.random.PRNGKey(3))
    moved = jax.tree.map(lambda a, b: np.asarray(
        np.any(np.asarray(a) != np.asarray(b)), np.float32) * np.ones_like(b),
        out["params"], params)
    want = {k for k, v in _state_dict(key, moved, stats).items()
            if v.numel() and v.flatten()[0] == 1}
    model = init_random(define_g(key, img_size=IMG),
                        torch.Generator().manual_seed(0))
    for p in model.parameters():
        p.data.add_(0.1)  # every bias nonzero before
    before = {k: v.clone() for k, v in model.state_dict().items()}
    zoo_ctor_init(model, torch.Generator().manual_seed(1))
    got = {k for k, v in model.state_dict().items()
           if not torch.equal(v, before[k])}
    assert got == want and any(k.startswith("conv6.") for k in got)
    for k in got:
        v = model.state_dict()[k]
        if k.endswith("bias"):
            assert (v == 0).all(), k
        else:
            std = (2.0 / v[0].numel()) ** 0.5
            assert abs(v.std().item() / std - 1.0) < 0.15, k


# ---------------------------------------------------------------- losses

def _grad_close(fn_t, fn_j, logits, *rest, tol=1e-6, value_tol=1e-5):
    """Value (to ``value_tol``) and gradient (with respect to the first
    argument, to ``tol``) of the port's and JAX's loss; a port loss that
    does not depend on it has a zero gradient. The values' bound is that of
    tests/test_torch_xbd.py: JAX's fp32 sum of the CE's 288 class weights
    lies about 2e-6 from their float64 sum, the port's far less; the gradients
    of the losses with a weighted CE are held to 1e-6 plus that distance
    (``_weight_sum_err``), by which JAX's CE gradient moves."""
    x = torch.from_numpy(logits).requires_grad_()
    val = fn_t(x, *(torch.from_numpy(r) for r in rest))
    g = (torch.autograd.grad(val, x)[0] if val.requires_grad
         else torch.zeros_like(x))
    ref, rg = jax.value_and_grad(fn_j)(jnp.asarray(logits),
                                       *(jnp.asarray(r) for r in rest))
    assert abs(val.item() - float(ref)) <= value_tol * max(abs(float(ref)),
                                                           1e-3)
    assert _scaled(g, rg) <= tol, _scaled(g, rg)
    return g


def _weight_sum_err(target, weight):
    """JAX's fp32 sum of the class weights of ``target``'s pixels, its
    distance from the float64 sum, relative."""
    w = np.asarray(weight, np.float32)[np.asarray(target)]
    exact = w.astype(np.float64).sum()
    return abs(float(jnp.sum(jnp.asarray(w))) - exact) / exact


def _loss_case(c, seed):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.normal(size=(2, 12, 12, c))).astype(np.float32)
    masks = (rng.rand(2, 12, 12, c) < 0.3).astype(np.float32)
    return logits, masks, rng.randint(0, 5, (2, 12, 12)).astype(np.int32)


@pytest.mark.parametrize("name", ["xbd_adapt_loss", "gen", "gen_effective",
                                  "disc", "bce_with_logits",
                                  "focal_loss_xbd", "multi_cross_entropy",
                                  "ce_dice"])
def test_losses_and_grads_match_jax(name):
    """The new losses' values and their gradients to 1e-6 (the generator
    loss with respect to the logits and to the discriminator's logits:
    the latter's gradient is 0 unless ``effective_gan``)."""
    logits, masks, target = _loss_case(4 if name == "xbd_adapt_loss" else 5,
                                       len(name))
    fake = np.random.RandomState(1).normal(size=(2, 1000)).astype(np.float32)
    class_target = np.asarray(jcombo._masks_to_class_target(
        jnp.asarray(masks)))
    if name == "xbd_adapt_loss":
        _grad_close(combo.xbd_adapt_loss, jcombo.xbd_adapt_loss, logits, masks,
                    tol=1e-6 + _weight_sum_err(class_target,
                                               (0.1, 0.5, 1.5, 1.5)))
    elif name.startswith("gen"):
        eff = name.endswith("effective")
        tol = 1e-6 + _weight_sum_err(class_target, (0.1, 0.5, 1.5, 1.5, 1.5))
        _grad_close(lambda a, m, f: combo.xbd_gan_generator_loss(a, m, f, eff),
                    lambda a, m, f: jcombo.xbd_gan_generator_loss(a, m, f, eff),
                    logits, masks, fake, tol=tol)
        g = _grad_close(
            lambda f, a, m: combo.xbd_gan_generator_loss(a, m, f, eff),
            lambda f, a, m: jcombo.xbd_gan_generator_loss(a, m, f, eff),
            fake, logits, masks)
        assert (g.abs().max() > 0) == eff
    elif name == "disc":
        _grad_close(combo.xbd_gan_discriminator_loss,
                    jcombo.xbd_gan_discriminator_loss, fake,
                    -fake[::-1].copy())
    elif name == "bce_with_logits":
        _grad_close(combo.bce_with_logits, jcombo.bce_with_logits, logits,
                    masks)
    else:
        weight = (1.0, 5.0, 100.0, 90.0, 100.0) if name.startswith("multi") \
            else (1.0,) * 5
        _grad_close(getattr(cd, name), getattr(jcd, name), logits, target,
                    tol=1e-6 + _weight_sum_err(target, weight))


# ---------------------------------------------------------------- augmentation

def _imgs(seed, b=2, h=20, w=24):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (b, h, w, 3)).astype(np.float32)


def _per_image(fn, imgs, *args):
    return np.stack([np.asarray(fn(jnp.asarray(im), *(a[i] for a in args)))
                     for i, im in enumerate(imgs)])


@pytest.mark.parametrize("op", ["saturation", "brightness", "contrast",
                                "box_blur3", "gauss_noise", "clahe"])
def test_photometric_ops_match_jax(op):
    """The blends, the box blur and the noise (on JAX's own normal field)
    exactly; CLAHE within 1e-5 of the 0..255 scale."""
    imgs = _imgs(len(op))
    t = torch.from_numpy(imgs)
    if op in ("saturation", "brightness", "contrast"):
        alpha = np.asarray([0.93, 1.07], np.float32)
        got = getattr(cda, op)(t, torch.from_numpy(alpha))
        ref = _per_image(getattr(jcda, op), imgs, alpha)
    elif op == "gauss_noise":
        keys = jax.random.split(jax.random.PRNGKey(5), 2)
        normal = np.stack([np.asarray(jax.random.normal(k, imgs.shape[1:3]
                                                        + (3,)))
                           for k in keys])
        got = cda.gauss_noise(t, torch.from_numpy(normal))
        ref = _per_image(jcda.gauss_noise, imgs, keys)
    else:
        got = getattr(cda, op)(t)
        ref = _per_image(getattr(jcda, op), imgs)
    if op == "clahe":
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * 255
    else:
        np.testing.assert_array_equal(got.numpy(), ref)


def test_scale_random_crop_and_elastic_match_jax():
    """The pair-consistent rescale-and-crop on JAX's draws (images within
    1e-5, labels exactly), the constant-0 smoothing and border, and
    ``elastic_transform`` on the field JAX draws from its key."""
    imgs, other = _imgs(1), _imgs(2)
    label = np.random.RandomState(3).randint(0, 5, imgs.shape[:3]).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    draws, ref = [], []
    for i, k in enumerate(keys):
        ks, kt, kl = jax.random.split(k, 3)
        draws.append([float(jax.random.uniform(ks, (), minval=1.0,
                                               maxval=1.2)),
                      float(jax.random.uniform(kt, ())),
                      float(jax.random.uniform(kl, ()))])
        ref.append(jcda.scale_random_crop((jnp.asarray(imgs[i]),
                                           jnp.asarray(other[i])),
                                          jnp.asarray(label[i]), k))
    d = {n: torch.tensor([v[j] for v in draws])
         for j, n in enumerate(("scale", "top", "left"))}
    (a, b), lab = cda.scale_random_crop(
        (torch.from_numpy(imgs), torch.from_numpy(other)),
        torch.from_numpy(label), d)
    for i, ((ra, rb), rl) in enumerate(ref):
        assert np.abs(a[i].numpy() - np.asarray(ra)).max() <= 1e-5 * 255
        assert np.abs(b[i].numpy() - np.asarray(rb)).max() <= 1e-5 * 255
        np.testing.assert_array_equal(lab[i].numpy(), np.asarray(rl))

    field = np.random.RandomState(4).uniform(-1, 1, (2, 9, 11)).astype(
        np.float32)
    ref = np.stack([np.asarray(jcda._gaussian_smooth_const0(jnp.asarray(f),
                                                            0.8))
                    for f in field])
    assert np.abs(cda._gaussian_smooth_const0(torch.from_numpy(field), 0.8)
                  .numpy() - ref).max() <= 1e-6
    img = imgs / 255.0
    rows = np.random.RandomState(5).uniform(-2, 22, img.shape[:3])
    cols = np.random.RandomState(6).uniform(-2, 26, img.shape[:3])
    ref = _per_image(jcda._bilinear_sample_cval0, img, rows, cols)
    got = cda._bilinear_sample_cval0(torch.from_numpy(img),
                                     *(torch.from_numpy(v).float()
                                       for v in (rows, cols)))
    assert np.abs(got.numpy() - ref).max() <= 1e-6
    h, w = img.shape[1:3]
    d = {"alpha": [], "ux": [], "uy": []}
    for k in keys:
        ka, kx, ky = jax.random.split(k, 3)
        d["alpha"].append(float(jax.random.uniform(ka, (), minval=0.25,
                                                   maxval=1.2)))
        d["ux"].append(np.asarray(jax.random.uniform(kx, (h, w))))
        d["uy"].append(np.asarray(jax.random.uniform(ky, (h, w))))
    d = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in d.items()}
    got = cda.elastic_transform(torch.from_numpy(img).float(), d)
    ref = _per_image(jcda.elastic_transform, img.astype(np.float32), keys)
    assert np.abs(got.numpy() - ref).max() <= 1e-5
    assert not np.allclose(got.numpy(), img)


def test_photometric_tree_and_elastic_gate():
    """Each of the tree's six picks on forced draws gives the JAX op's
    output; with no pick the image is left as it is; the elastic gate
    fires at the reference's rate (p = 0.017) over 4000 images."""
    imgs = _imgs(9, b=1)
    t = torch.from_numpy(imgs)
    normal = torch.randn((1, *imgs.shape[1:3], 3),
                         generator=torch.Generator().manual_seed(0))
    ops = [lambda a: jcda.clahe(a), None, lambda a: jcda.box_blur3(a),
           lambda a: jcda.saturation(a, 0.95),
           lambda a: jcda.brightness(a, 0.95),
           lambda a: jcda.contrast(a, 0.95)]
    # r for each pick: branch 1 (r0) then its gates r1..r3; branch 2 (r4)
    # then r5..r7
    for pick in range(6):
        r = np.zeros(8, np.float32)
        r[0 if pick < 3 else 4] = 0.99
        r[1 + pick if pick < 3 else 2 + pick] = 0.99
        d = {"r": torch.from_numpy(r)[None], "alpha": torch.tensor([0.95]),
             "normal": normal}
        got = cda.photometric_tree(t, d).numpy()[0]
        if pick == 1:
            want = cda.gauss_noise(t, normal).numpy()[0]
        else:
            want = np.asarray(ops[pick](jnp.asarray(imgs[0])))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 255)
    d["r"] = torch.zeros(1, 8)
    assert torch.equal(cda.photometric_tree(t, d), t)
    gen = torch.Generator().manual_seed(0)
    small = torch.rand(4000, 6, 6, 3, generator=gen)
    moved = cda.elastic_gated(small, cda.draw_elastic_gated(4000, 6, 6, gen,
                                                            "cpu"))
    rate = (moved != small).flatten(1).any(1).float().mean().item()
    assert 0.005 < rate < 0.035
    a, b, lab = cda.augment_pairs_xbd_cd(
        *(torch.from_numpy(v.astype(np.uint8)) for v in
          (_imgs(1), _imgs(2), _imgs(3)[..., 0] % 5)), gen)
    assert a.shape == b.shape == (2, 20, 24, 3) and lab.dtype == torch.long


# ---------------------------------------------------------------- train steps

def _batch(channels, seed=21):
    rng = np.random.RandomState(seed)
    pre, post = (rng.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
                 for _ in "ab")
    loc = np.where(rng.rand(2, IMG, IMG) < 0.4, 255, 0).astype(np.uint8)
    dmg = rng.randint(0, 5, (2, IMG, IMG)).astype(np.uint8)
    pairs = [xbd.build_damage_masks(loc[i], dmg[i], True, channels == 4)
             for i in range(2)]
    msk = np.stack([p[0] for p in pairs]).astype(np.uint8)
    lbl = np.stack([p[1] for p in pairs]).astype(np.uint8)
    return pre, post, msk, lbl


# Both sides of a step read the eval branch of the augmentation with the
# input moved by MOVE * N(0, 1), drawn from the key the JAX step hands its
# augmentation; JAX's own gradient moves under other keys set the bound.
MOVE = 1e-6
MOVES = 4


def _eval_branch(pre, post, msk, lbl, key, *_, dtype=jnp.float32, **__):
    img6, masks, lbl_i = jaug.augment_xbd(pre, post, msk, lbl, key,
                                          train=False, dtype=dtype)
    return img6 + MOVE * jax.random.normal(key, img6.shape), masks, lbl_i


def _port_augment(step_key):
    """The port trainer's ``_augment`` for the JAX step run on
    ``step_key``: the eval branch and the same move."""
    key = jax.random.split(step_key)[0]

    def augment(*batch):
        img6, masks, lbl_i = augment_xbd(*batch, train=False)
        move = np.array(jax.random.normal(key, tuple(img6.shape)))
        return img6 + MOVE * torch.from_numpy(move), masks, lbl_i

    return augment


# The generator's gradient as the trainers step with it: clipped to a
# global norm of 0.999 (the port clips .grad in place).
_G_TX = optax.chain(optax.clip_by_global_norm(0.999), optax.sgd(1.0))


def _jax_stub(key, task):
    stub = types.SimpleNamespace(model=jax_define_g(key, img_size=IMG),
                                 task=task, dtype=jnp.float32, elastic=False,
                                 tx=_G_TX, d_tx=optax.sgd(1.0),
                                 disc=JaxDisc(5), effective_gan=False)
    stub._apply_model = functools.partial(jengine.XBDTrainer._apply_model,
                                          stub)
    stub._disc_apply = functools.partial(jengine.GANTrainer._disc_apply, stub)
    return stub


def _trainer(tmp_path, key, task, arrays, gan=False):
    args = types.SimpleNamespace(
        checkpoint_dir=str(tmp_path / task), max_epochs=1, bf16=False, seed=0,
        net_G=key, img_size=IMG, lr=0.0, batch_size=2, val_batch_size=2)
    if gan:
        trainer = xbd_engine.GANTrainer(args, arrays, arrays, device="cpu")
    else:
        trainer = xbd_engine.XBDTrainer(args, arrays, arrays, device="cpu",
                                        task=task)
    trainer._augment = _port_augment(jax.random.PRNGKey(0))
    return trainer


def _arrays(batch):
    return dict(zip(("img_pre", "img_post", "msk", "lbl_msk"), batch))


def _change(before, after):
    """The gradient an sgd(1.0) step took: the parameters' change."""
    return jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), before,
                        _np(after))


def _grads_close(named, want, moved):
    """The port's gradients within 1e-3 of the whole gradient's scale of
    JAX's, or within the median of JAX's own distance under the other
    moves (``moved``) where larger (ROADMAP fault 5), in every output
    channel of every tensor but one: there one ReLU whose input lies within
    fp32 rounding of zero may flip, which moves that channel's gradient
    alone, by at most 1e-2 (module docstring)."""
    scale = max(np.abs(want[k].numpy()).max() for k in named)

    def blocks(grads):
        """Each (tensor, output channel)'s distance from JAX's."""
        return {(k, c): float(v) / scale for k in named
                for c, v in enumerate(np.abs(
                    grads[k] - want[k].numpy()).reshape(len(want[k]), -1)
                    .max(1))}

    own = [max(blocks({k: v.numpy() for k, v in m.items()}).values())
           for m in moved]
    port = blocks({k: p.grad.numpy() for k, p in named.items()})
    bound = max(1e-3, float(np.median(own)))
    worst = max(port, key=port.get)
    rest = max(v for b, v in port.items() if b != worst)
    assert rest <= bound and port[worst] <= 1e-2, (worst, port[worst], rest,
                                                   own)


def _stats_close(model, want):
    for k, v in model.named_buffers():
        assert _scaled(v, want[k].numpy()) <= 1e-4, k


@pytest.mark.parametrize("task,key", [("loc", "xbd_res34_loc"),
                                      ("adapt", "xbd_adapt_res34")])
def test_train_step_matches_jax(tmp_path, monkeypatch, task, key):
    """One ``loc`` / ``adapt`` step of the JAX trainer's own step code and
    of ``XBDTrainer.train_step`` from the same weights and batch: the loss,
    every gradient and the updated BN statistics."""
    monkeypatch.setattr(jengine, "augment_xbd", _eval_branch)
    batch = _batch(4 if task == "adapt" else 5)
    _, params, stats = _case(key if task == "loc" else "xbd_res34_double")
    if task == "adapt":  # the 4-class head
        rng = np.random.RandomState(2)
        params = {**params, "res": {
            "kernel": rng.normal(0, 96 ** -0.5, (1, 1, 96, 4)).astype(
                np.float32),
            "bias": 0.1 * rng.normal(size=4).astype(np.float32)}}
    state = TrainState.create({"params": params, "batch_stats": stats},
                              _G_TX)
    step = jax.jit(functools.partial(jengine.XBDTrainer._train_step_impl,
                                     _jax_stub(key, task)))
    runs = [step(state, *batch, jax.random.PRNGKey(i))
            for i in range(MOVES + 1)]
    (new, ref_loss), moved = runs[0], [
        _state_dict(key, _change(params, r[0].params), stats)
        for r in runs[1:]]
    trainer = _trainer(tmp_path, key, task, _arrays(batch))
    load_weights(trainer.model, _state_dict(key, params, stats))
    loss = trainer.train_step(*(torch.from_numpy(b) for b in batch))
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    _grads_close(dict(trainer.model.named_parameters()),
                 _state_dict(key, _change(params, new.params), stats), moved)
    _stats_close(trainer.model, _state_dict(key, params,
                                            _np(new.batch_stats)))


@functools.lru_cache(maxsize=None)
def _gan_case():
    key = "xbd_res34_double"
    _, params, stats = _case(key)
    _, d_params, d_stats = _case("disc")
    return key, params, stats, d_params, d_stats


@pytest.fixture
def few_threads():
    """torch on 2 CPU threads: under the suite's six workers on eight cores
    full thread pools in the parameter-sized passes of the CLI runs (init,
    AdamW, checkpoints) slow them several times."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gan_trainer(tmp_path_factory):
    """One ``GANTrainer`` (generator ``xbd_res34_double``) for the GAN
    tests, each of which loads its weights first."""
    key = _gan_case()[0]
    return _trainer(tmp_path_factory.mktemp("gan"), key, "gan",
                    _arrays(_batch(5)), gan=True)


def _load_gan(trainer):
    key, params, stats, d_params, d_stats = _gan_case()
    load_weights(trainer.model, _state_dict(key, params, stats))
    load_weights(trainer.disc, _state_dict("disc", d_params, d_stats))
    trainer.effective_gan = False
    return trainer


@pytest.mark.parametrize("update_disc", [True, False])
def test_gan_step_matches_jax(gan_trainer, monkeypatch, update_disc):
    """One GAN step of the JAX trainer's ``_gan_step_impl`` and of
    ``GANTrainer.gan_step`` (generator ``xbd_res34_double``): both losses,
    the generator's gradients and BN statistics, and with an update the
    discriminator's gradients and BN statistics (the real pass's statistics
    chained into the fake pass); without one its statistics unmoved."""
    monkeypatch.setattr(jengine, "augment_xbd", _eval_branch)
    key, params, stats, d_params, d_stats = _gan_case()
    batch = _batch(5)
    state = TrainState.create({"params": params, "batch_stats": stats},
                              _G_TX)
    d_state = TrainState.create({"params": d_params, "batch_stats": d_stats},
                                optax.sgd(1.0))
    step = jax.jit(functools.partial(jengine.GANTrainer._gan_step_impl,
                                     _jax_stub(key, "damage")),
                   static_argnames=("update_disc",))
    runs = [step(state, d_state, *batch, jax.random.PRNGKey(i),
                 update_disc=update_disc) for i in range(MOVES + 1)]
    new, new_d, ref_g, ref_d = runs[0]
    trainer = _load_gan(gan_trainer)
    g, d = trainer.gan_step(*(torch.from_numpy(b) for b in batch),
                            update_disc=update_disc)
    for got, ref in ((g, ref_g), (d, ref_d)):
        assert abs(got.item() - float(ref)) <= 1e-5 * max(abs(float(ref)),
                                                          1e-3)
    _grads_close(dict(trainer.model.named_parameters()),
                 _state_dict(key, _change(params, new.params), stats),
                 [_state_dict(key, _change(params, r[0].params), stats)
                  for r in runs[1:]])
    _stats_close(trainer.model, _state_dict(key, params, _np(new.batch_stats)))
    _stats_close(trainer.disc, _state_dict("disc", d_params,
                                           _np(new_d.batch_stats)))
    if update_disc:
        _grads_close(dict(trainer.disc.named_parameters()),
                     _state_dict("disc", _change(d_params, new_d.params),
                                 d_stats),
                     [_state_dict("disc", _change(d_params, r[1].params),
                                  d_stats) for r in runs[1:]])


def test_gan_step_batchnorm_rules(gan_trainer, few_threads):
    """The three BN rules of the JAX GAN step, on the port alone: (1) the
    discriminator step's generator forward moves no running statistic of
    the generator (which moves once, in its own step); (2) the generator
    step's discriminator pass moves none of the discriminator's; (3) the
    discriminator step's fake pass takes the statistics its real pass
    left. And ``--effective_gan`` gives the generator the adversarial
    gradient."""
    key, params, stats, d_params, d_stats = _gan_case()
    batch = [torch.from_numpy(b) for b in _batch(5, seed=3)]
    trainer = _load_gan(gan_trainer)
    img6, masks, _ = trainer._augment(*batch)
    g_ref, d_ref = (_port(k, p, s) for k, p, s in
                    ((key, params, stats), ("disc", d_params, d_stats)))
    with torch.no_grad():
        fake = g_ref(img6, train=True)  # G's statistics after one update
        d_ref(masks, train=True)
        d_ref(fake, train=True)  # D's after the real, then the fake pass
    trainer.gan_step(*batch, update_disc=True)
    for model, ref in ((trainer.model, g_ref), (trainer.disc, d_ref)):
        want = dict(ref.named_buffers())
        for k, v in model.named_buffers():
            assert torch.equal(v, want[k]), k
    before = {k: v.clone() for k, v in trainer.disc.named_buffers()}
    trainer.gan_step(*batch, update_disc=False)
    for k, v in trainer.disc.named_buffers():
        assert torch.equal(v, before[k]), k
    grads = {}
    for eff in (False, True):
        trainer.effective_gan = eff
        load_weights(trainer.model, _state_dict(key, params, stats))
        trainer.gan_step(*batch, update_disc=False)
        grads[eff] = torch.cat([p.grad.flatten()
                                for p in trainer.model.parameters()])
    assert (grads[True] - grads[False]).abs().max() > 0


# ---------------------------------------------------------------- CLIs

# The CLIs' tiles: 32 px (the ResNet34 UNets' coarsest level is 1 px).
CLI_IMG = 32


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A seeded synthetic xBD tree of 8 tiles of 32 px."""
    root = str(tmp_path_factory.mktemp("xbd_tasks") / "train")
    write_synthetic_xbd(root, n_tiles=8, size=CLI_IMG, seed=4, block=4)
    return root


def test_xbd_train_tasks_and_visualize_on_cpu(tree, tmp_path, few_threads):
    """``xbd_train --task loc``, ``adapt`` (its default net) and ``gan``
    (``--elastic``, ``best_ckpt_D.pt``) for one epoch at 32 px, batch 2;
    ``visualize_results`` with the loc and the GAN generator's checkpoints:
    one (32, 128, 3) grid per tile; a task the CLI does not know is
    refused (``hrnet`` trains in tests/test_torch_xbd_zoo.py)."""
    common = ["--data_root", tree, "--img_size", str(CLI_IMG), "--batch_size",
              "2", "--max_epochs", "1", "--eval_every", "1",
              "--checkpoint_root", str(tmp_path), "--device", "cpu"]
    for task, extra in (("loc", []), ("adapt", []),
                        ("gan", ["--elastic", "--net_G", "xbd_res34_double"])):
        history = xbd_train.main(common + ["--task", task, "--project_name",
                                           task, *extra])
        assert len(history) == 1 and np.isfinite(history[0]["loss"])
        assert 0.0 <= history[0]["val"]["score"] <= 1.0
        assert load_checkpoint(str(tmp_path / task)) is not None
    assert history[0]["disc_updates"] == 1
    assert load_checkpoint(str(tmp_path / "gan"), "best_ckpt_D") is not None
    with pytest.raises(SystemExit):
        xbd_train.main(common + ["--task", "nope"])
    out = tmp_path / "vis"
    written = visualize_results.main(
        ["--test_root", tree, "--loc_ckpt", str(tmp_path / "loc"),
         "--dmg_ckpt", str(tmp_path / "gan"), "--dmg_net_G",
         "xbd_res34_double", "--img_size", str(CLI_IMG), "--out_dir",
         str(out), "--device", "cpu"])
    assert len(written) == 8
    for name in written:
        assert np.array(Image.open(os.path.join(out, name))).shape == (
            CLI_IMG, 4 * CLI_IMG, 3)


def test_fusion_and_palette_match_jax():
    from dahitra_tpu.cli import visualize_results as jvis

    rng = np.random.RandomState(7)
    p_loc = rng.rand(16, 16).astype(np.float32)
    dmg = rng.rand(16, 16, 5).astype(np.float32)
    for g, r in zip(visualize_results.fuse_loc_damage(p_loc, dmg),
                    jvis.fuse_loc_damage(p_loc, dmg)):
        np.testing.assert_array_equal(g, r)
    cls = rng.randint(-1, 6, (8, 8))
    np.testing.assert_array_equal(visualize_results.assign_color(cls),
                                  jvis.assign_color(cls))
