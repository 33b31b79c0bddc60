"""The xBD half of the zoo against the JAX package, on the CPU: the
SE-ResNeXt50 and SENet154 UNets (dahitra_tpu_torch/models/senet_unet.py),
the DPN92 UNets (dpn_unet.py), the xBD UNet change transformers
(xbd_unet_change_transformer.py) and Dual-HRNet (dual_hrnet.py), their
blocks, ``max_pool_3x3_s2_ceil``, ``dual_hrnet_loss``, the converters, the
``hrnet`` task's validation and ``xbd_train --task hrnet``.

The flax parameters are built from the port: its seeded ``state_dict``
(``init_random``, biases moved by N(0, 0.1)) goes through the JAX
converters (``convert_se_unet``, ``convert_xbd_unet_change_transformer``,
``convert_dual_hrnet``); the DPN92 UNets, which have no JAX converter, and
the blocks fill a ``jax.eval_shape`` tree from seeded numpy and go to the
port through its converters. The flax models are applied un-jitted and
never jit-initialized: their CPU compiles would dominate the suite. Inputs
are seeded numpy at 64 px, batch 1 (the second date at half the first's
contrast plus noise). The whole models are held in eval mode to 1e-5 of the
flax logits' scale or, where larger, twice JAX's largest own move under
four 1e-6 input moves (ROADMAP.md section 3, fault 5); the blocks to 1e-5
(fp32 forward), 1e-4 of the whole gradient's scale (fp32 gradients, train
mode) and 2e-2 (bf16 forward).
"""
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from dahitra_tpu.data import xbd as jxbd
from dahitra_tpu.core.torch_import import (convert_dual_hrnet,
                                           convert_se_unet,
                                           convert_xbd_unet_change_transformer)
from dahitra_tpu.losses import combo as jcombo
from dahitra_tpu.models import dpn_unet as jdpn
from dahitra_tpu.models import dual_hrnet as jhr
from dahitra_tpu.models import senet_unet as jse
from dahitra_tpu.models.registry import define_g as jax_define_g
from dahitra_tpu.nn import blocks as jb
from dahitra_tpu.train.xbd_engine import XBDTrainer as JaxXBDTrainer
from dahitra_tpu_torch.cli import import_checkpoint, xbd_predict, xbd_train
from dahitra_tpu_torch.core import flax_import as fi
from dahitra_tpu_torch.core.checkpoint import load_checkpoint, load_weights
from dahitra_tpu_torch.data.synthetic import write_synthetic_xbd
from dahitra_tpu_torch.losses import combo
from dahitra_tpu_torch.models import dpn_unet, dual_hrnet, senet_unet
from dahitra_tpu_torch.models.registry import XBD_ZOO, define_g
from dahitra_tpu_torch.nn import blocks as tb
from dahitra_tpu_torch.nn.init import init_random
from dahitra_tpu_torch.train.xbd_engine import XBDTrainer

IMG = 64
# Each _loc key before its _double: the un-jitted JAX ops compiled for the
# one are reused by the other.
KEYS = tuple(XBD_ZOO)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# key -> the JAX converter of its reference state_dict (None: DPN92)
JAX_CONVERT = {
    "xbd_seresnext50": lambda sd: convert_se_unet(sd, "se_resnext50"),
    "xbd_senet154": lambda sd: convert_se_unet(sd, "senet154"),
    "xbd_dpn92": None,
    "xbd_unet_change_transformer_bit":
        lambda sd: convert_xbd_unet_change_transformer(sd, bit=True),
    "xbd_unet_change_transformer":
        lambda sd: convert_xbd_unet_change_transformer(sd, bit=False),
    "dual_hrnet": convert_dual_hrnet,
}
PORT_CONVERT = {
    "xbd_seresnext50": fi.se_unet_flax_to_state_dict,
    "xbd_senet154": fi.se_unet_flax_to_state_dict,
    "xbd_dpn92": fi.dpn_unet_flax_to_state_dict,
    "xbd_unet_change_transformer_bit":
        fi.xbd_unet_change_transformer_flax_to_state_dict,
    "xbd_unet_change_transformer":
        fi.xbd_unet_change_transformer_flax_to_state_dict,
    "dual_hrnet": fi.dual_hrnet_flax_to_state_dict,
}


@pytest.fixture(autouse=True)
def few_threads():
    """torch on at most 4 CPU threads: under the suite's six workers on
    eight cores full thread pools in these 30-125 M-parameter models'
    passes slow every file beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _family(key):
    return next(f for f in JAX_CONVERT if key.startswith(f))


def _one_image(key):
    return key.endswith("_loc")


def _scaled(got, ref):
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(
        ref, np.float32)).max() / max(np.abs(np.asarray(ref)).max(), 1e-3))


def _fill(shapes, rng):
    """A seeded numpy tree for an eval_shape tree: lecun-normal kernels,
    scales near 1, biases and means near 0, variances in [0.5, 1.5]."""
    out = {}
    for path, s in traverse_util.flatten_dict(shapes).items():
        if path[-1] == "kernel":
            v = rng.normal(0.0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif path[-1] == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif path[-1] == "scale":
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            v = 0.1 * rng.normal(size=s.shape)
        out[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def _seeded(model, seed):
    """``init_random`` with seeded running statistics, every bias and
    norm scale moved by N(0, 0.1)."""
    gen = torch.Generator().manual_seed(seed)
    init_random(model, gen)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def _image(key, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (1, IMG, IMG, 3)).astype(np.float32)
    if _one_image(key):
        return x
    x2 = 0.5 * x + 0.3 * rng.uniform(-1, 1, x.shape).astype(np.float32)
    return np.concatenate([x, x2], -1)


def _jax_args(key, x, train=False):
    return (x, train) if _one_image(key) else (x, None, train)


@functools.lru_cache(maxsize=None)
def _dpn_core_shapes():
    """The eval_shape tree of the DPN92 UNets' shared core (both keys: the
    head ``res`` is drawn beside it)."""
    return jax.eval_shape(lambda: jdpn._DPNUnetCore().init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))))


@functools.lru_cache(maxsize=None)
def _case(key):
    """(x, params, batch_stats, port state_dict) of ``key``, seeded."""
    x = _image(key)
    family = _family(key)
    if JAX_CONVERT[family] is None:
        core = _dpn_core_shapes()
        rng = np.random.RandomState(1)
        params, stats = ({"core": _fill(core[c], rng)}
                         for c in ("params", "batch_stats"))
        c_in, c_out = (32, 1) if _one_image(key) else (64, 5)
        params["res"] = {
            "kernel": rng.normal(0, c_in ** -0.5, (1, 1, c_in, c_out)
                                 ).astype(np.float32),
            "bias": (0.1 * rng.normal(size=c_out)).astype(np.float32)}
        sd = fi.dpn_unet_flax_to_state_dict(params, stats)
    else:
        sd = _seeded(define_g(key, img_size=IMG), 0).state_dict()
        params, stats = JAX_CONVERT[family](
            {k: v.numpy() for k, v in sd.items()})
    return x, params, stats, sd


def _jax_forward(key, params, stats, x):
    out = jax_define_g(key, img_size=IMG).apply(
        {"params": params, "batch_stats": stats},
        *_jax_args(key, jnp.asarray(x)))
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    return {"logits": np.asarray(out)}


def test_max_pool_3x3_s2_ceil_matches_jax():
    """The ceil-mode pool with no padding, at even and odd sizes (31, 32,
    33; the last, clipped window kept), equals the JAX pool exactly."""
    rng = np.random.RandomState(2)
    for size in (31, 32, 33):
        x = rng.normal(size=(2, size, size + 1, 3)).astype(np.float32)
        ref = np.asarray(jb.max_pool_3x3_s2_ceil(jnp.asarray(x)))
        got = tb.max_pool_3x3_s2_ceil(torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape == (2, -(-(size - 3) // 2) + 1,
                                          -(-(size - 2) // 2) + 1, 3)
        np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------------ blocks

def _se_block_key(path):
    return ".".join(fi._DOWN.get(n, n) for n in path)


def _hr_key(prefix, torch_prefix):
    """A key function for an HRNet block: ``_hrnet_key`` under a stream
    module, the stream prefix cut."""
    return lambda path: fi._hrnet_key(("h", prefix) + path)[
        len(torch_prefix):]


def _map(fn, t):
    """``fn`` over the arrays of a tuple / list / None structure."""
    if t is None:
        return None
    if isinstance(t, (tuple, list)):
        return type(t)(_map(fn, v) for v in t)
    return fn(t)


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


R = np.random.RandomState(3)
# name -> (flax module of a dtype, port module of a dtype, input, key
# function, whether the modules take ``train``)
BLOCKS = {
    "se_module": (lambda dt: jse.SEModule(dtype=dt),
                  lambda dt: senet_unet.SEModule(32, dtype=dt),
                  R.normal(size=(2, 8, 8, 32)), ".".join, False),
    "scse_module": (lambda dt: jse.SCSEModule(dtype=dt),
                    lambda dt: senet_unet.SCSEModule(32, dtype=dt),
                    R.normal(size=(2, 8, 8, 32)), ".".join, False),
    "se_resnext_bottleneck": (
        lambda dt: jse.SEResNeXtBottleneck(16, stride=2, dtype=dt),
        lambda dt: senet_unet.SEResNeXtBottleneck(32, 16, stride=2,
                                                  dtype=dt),
        R.normal(size=(2, 8, 8, 32)), _se_block_key, True),
    "se_bottleneck": (
        lambda dt: jse.SEBottleneck(32, stride=2, dtype=dt),
        lambda dt: senet_unet.SEBottleneck(64, 32, stride=2, dtype=dt),
        R.normal(size=(2, 8, 8, 64)), _se_block_key, True),
    "dual_path_proj": (
        lambda dt: jdpn.DualPathBlock(32, 16, 8, "proj", dtype=dt),
        lambda dt: dpn_unet.DualPathBlock(24, 32, 16, 8, "proj", dt),
        (R.normal(size=(2, 8, 8, 24)), None), ".".join, True),
    "dual_path_down": (
        lambda dt: jdpn.DualPathBlock(32, 16, 8, "down", dtype=dt),
        lambda dt: dpn_unet.DualPathBlock(40, 32, 16, 8, "down", dt),
        (R.normal(size=(2, 8, 8, 16)), R.normal(size=(2, 8, 8, 24))),
        ".".join, True),
    "dual_path_normal": (
        lambda dt: jdpn.DualPathBlock(32, 16, 8, "normal", dtype=dt),
        lambda dt: dpn_unet.DualPathBlock(40, 32, 16, 8, "normal", dt),
        (R.normal(size=(2, 8, 8, 16)), R.normal(size=(2, 8, 8, 24))),
        ".".join, True),
    "hr_module": (
        lambda dt: jhr.HRModule((4, 8, 16), dt),
        lambda dt: dual_hrnet.HRModule((4, 8, 16), dt),
        [R.normal(size=(2, 16, 16, 4)), R.normal(size=(2, 8, 8, 8)),
         R.normal(size=(2, 4, 4, 16))],
        _hr_key("stage2_m0", "h.stage2.0."), True),
    "transition": (
        lambda dt: jhr.Transition((8, 16), (4, 16, 32), dt),
        lambda dt: dual_hrnet.Transition((8, 16), (4, 16, 32), dt),
        [R.normal(size=(2, 16, 16, 8)), R.normal(size=(2, 8, 8, 16))],
        _hr_key("transition1", "h.transitions.0."), True),
}


def _block_case(name, dname="float32"):
    make_flax, make_port, x, key_fn, takes_train = BLOCKS[name]
    x = _map(lambda v: v.astype(np.float32), x)
    flax_mod = make_flax(JDT[dname])
    jx = _map(lambda v: jnp.asarray(v, JDT[dname]), x)
    extra = (False,) if takes_train else ()
    shapes = jax.eval_shape(lambda: flax_mod.init(jax.random.PRNGKey(0), jx,
                                                  *extra))
    variables = {c: _fill(v, np.random.RandomState(4))
                 for c, v in shapes.items()}
    port = make_port(TDT[dname])
    load_weights(port, fi._write_renamed(variables["params"],
                                         variables.get("batch_stats", {}),
                                         key_fn))
    assert set(port.state_dict()) == set(fi._write_renamed(
        variables["params"], variables.get("batch_stats", {}), key_fn))
    return flax_mod, port, variables, x, jx, takes_train


def _jax_eval(flax_mod, takes_train):
    """The block's eval-mode apply, jitted (a block compiles in about a
    second; un-jitted, its ops compile one by one)."""
    return jax.jit(lambda v, x: flax_mod.apply(
        v, x, *((False,) if takes_train else ())))


@pytest.mark.parametrize("name", BLOCKS)
def test_block_matches_flax(name):
    """fp32 eval forward to 1e-5 of the flax output's scale; train-mode
    gradients of sum(out * a seeded cotangent), every parameter's to 1e-4
    of the whole gradient's scale, and the output there to 1e-5."""
    flax_mod, port, variables, x, jx, takes_train = _block_case(name)
    tx = _map(torch.from_numpy, x)
    with torch.no_grad():
        got = _flat(port(tx, False) if takes_train else port(tx))
    ref = _flat(_jax_eval(flax_mod, takes_train)(variables, jx))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _scaled(g.numpy(), r) <= 1e-5, name

    cot = [np.random.RandomState(5 + i).normal(size=r.shape).astype(
        np.float32) for i, r in enumerate(ref)]

    def loss(params):
        out, _ = flax_mod.apply(
            {**variables, "params": params}, jx,
            *((True,) if takes_train else ()), mutable=["batch_stats"])
        return sum(jnp.sum(o * c) for o, c in zip(_flat(out), cot)), out

    (_, ref_out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    out = _flat(port(tx, True) if takes_train else port(tx))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cot)).backward()
    for o, r in zip(out, _flat(ref_out)):
        assert _scaled(o.detach().numpy(), r) <= 1e-5, name
    want = fi._write_renamed(grads, {}, BLOCKS[name][3])
    scale = max(float(v.abs().max()) for v in want.values())
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    for k, v in want.items():
        err = float((named[k].grad - v).abs().max()) / scale
        assert err <= 1e-4, (name, k, err)


@pytest.mark.parametrize("name", BLOCKS)
def test_block_bf16_matches_flax(name):
    """bf16 eval forward within 2e-2 of the bf16 flax output's scale."""
    flax_mod, port, variables, x, jx, takes_train = _block_case(name,
                                                                "bfloat16")
    tx = _map(lambda v: torch.from_numpy(v).bfloat16(), x)
    with torch.no_grad():
        got = _flat(port(tx, False) if takes_train else port(tx))
    ref = _flat(_jax_eval(flax_mod, takes_train)(variables, jx))
    for g, r in zip(got, ref):
        assert _scaled(g.float().numpy(), np.asarray(r, np.float32)) <= 2e-2


# ------------------------------------------------------------ whole models

@pytest.mark.parametrize("key", KEYS)
def test_forward_matches_flax(key):
    """Each key's fp32 eval forward at 64 px: every head within 1e-5 of the
    flax logits' scale or twice JAX's largest own move under four 1e-6
    input moves, and the same decisions (the argmax over the classes, the
    sign of a single logit) at 99.9 % of the pixels or more."""
    x, params, stats, sd = _case(key)
    ref = _jax_forward(key, params, stats, x)
    port = define_g(key, img_size=IMG)
    load_weights(port, sd)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    got = got if isinstance(got, dict) else {"logits": got}
    assert set(got) == set(ref)
    for head, r in ref.items():
        g = got[head].numpy()
        assert g.dtype == np.float32 and g.shape == r.shape
        err = _scaled(g, r)
        if err > 1e-5:
            own = [_scaled(_jax_forward(key, params, stats, x + 1e-6 * (
                np.random.RandomState(100 + i).normal(size=x.shape).astype(
                    np.float32)))[head], r) for i in range(4)]
            assert err <= 2 * max(own), (key, head, err, own)
        decide = (lambda a: a.argmax(-1)) if r.shape[-1] > 1 \
            else (lambda a: a[..., 0] > 0)
        assert (decide(g) == decide(r)).mean() >= 0.999, (key, head)


def test_double_models_run_dates_batch_stacked_in_train_mode():
    """A Double model in train mode runs both dates batch-stacked: the
    logits against the flax model's two core calls (1e-5), and every
    running statistic as the port's own two core calls in a row leave it
    (each date normalized by its own batch, the statistics moved twice),
    to 1e-4 of its tensor's scale (the batched convolutions sum in another
    order)."""
    key = "xbd_seresnext50_double"
    x, params, stats, sd = _case(key)
    ref = jax_define_g(key, img_size=IMG).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), None, True,
        mutable=["batch_stats"])[0]
    port, twice = (define_g(key, img_size=IMG) for _ in range(2))
    load_weights(port, sd)
    load_weights(twice, sd)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        got = port(tx, train=True)
        for date in (tx[..., :3], tx[..., 3:]):
            twice.core(date, True)
    assert _scaled(got.numpy(), ref) <= 1e-5
    seq = dict(twice.named_buffers())
    for k, v in port.named_buffers():
        assert _scaled(v.numpy(), seq[k].numpy()) <= 1e-4, k


# ------------------------------------------------------ loss, eval, CLIs

def _hrnet_masks(rng, n=2, size=IMG):
    loc = (rng.rand(n, size, size) < 0.4).astype(np.float32)
    dmg = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (n, size, size))]
    return np.concatenate([loc[..., None], dmg * loc[..., None]], -1)


def _hrnet_loss64(loc, cls, masks, seg):
    """``dual_hrnet_loss`` with its CE term summed in float64 (the heads
    upsampled x4 nearest), beside the given ComboLoss term."""
    up = np.repeat(np.repeat(cls.astype(np.float64), 4, 1), 4, 2)
    logp = up - up.max(-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    target = masks[..., 1:].argmax(-1)
    w = np.array([0.1, 2.0, 1.0, 2.0])[target]
    nll = -np.take_along_axis(logp, target[..., None], -1)[..., 0]
    return seg + 5.0 * (nll * w).sum() / w.sum()


def test_dual_hrnet_loss_and_gradient_match_jax():
    """``dual_hrnet_loss`` on fixed 1/4-resolution logits: the value to
    1e-5 of JAX's or, where larger, twice the distance of JAX's fp32 sum
    from a float64 evaluation (XLA's CPU sum over the 8192 pixels drifts
    about 1e-5); the cls gradient to 1e-4 of its scale, and no gradient
    through the loc head's argmax, as in JAX."""
    rng = np.random.RandomState(6)
    loc = rng.normal(size=(2, IMG // 4, IMG // 4, 2)).astype(np.float32)
    cls = rng.normal(size=(2, IMG // 4, IMG // 4, 4)).astype(np.float32)
    masks = _hrnet_masks(rng)
    ref, (g_loc, g_cls) = jax.value_and_grad(
        lambda a, b: jcombo.dual_hrnet_loss({"loc": a, "cls": b},
                                            jnp.asarray(masks)),
        argnums=(0, 1))(jnp.asarray(loc), jnp.asarray(cls))
    tl, tc = (torch.from_numpy(v).requires_grad_() for v in (loc, cls))
    got = combo.dual_hrnet_loss({"loc": tl, "cls": tc},
                                torch.from_numpy(masks))
    got.backward()
    seg = float(jcombo.ComboLoss({"dice": 1.0, "focal": 8.0})(
        jnp.argmax(jnp.repeat(jnp.repeat(jnp.asarray(loc), 4, 1), 4, 2),
                   -1).astype(jnp.float32), jnp.asarray(masks[..., 0])))
    ref64 = _hrnet_loss64(loc, cls, masks, seg)
    assert abs(got.item() - float(ref)) <= max(
        1e-5 * abs(float(ref)), 2 * abs(float(ref) - ref64))
    assert abs(got.item() - ref64) <= 1e-5 * abs(ref64)
    assert tl.grad is None and not np.asarray(g_loc).any()
    assert _scaled(tc.grad.numpy(), g_cls) <= 1e-4


def test_hrnet_eval_counters_match_jax_eval_step():
    """The ``hrnet`` validation on fixed Dual-HRNet heads: both resized
    bilinearly to the masks, the loc head's softmax channel 1 beside the
    cls head's sigmoids; dice per image and tp / fp / fn against the JAX
    trainer's ``_eval_step_impl``."""
    rng = np.random.RandomState(7)
    pre, post = (rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
                 for _ in "ab")
    loc = np.where(rng.rand(3, 32, 32) < 0.4, 255, 0).astype(np.uint8)
    dmg = rng.randint(0, 5, (3, 32, 32)).astype(np.uint8)
    pairs = [jxbd.build_damage_masks(loc[i], dmg[i], train=False)
             for i in range(3)]
    msk = np.stack([p[0] for p in pairs]).astype(np.uint8)
    lbl = np.stack([p[1] for p in pairs]).astype(np.uint8)
    out = {"loc": (2.0 * rng.normal(size=(3, 8, 8, 2))).astype(np.float32),
           "cls": (2.0 * rng.normal(size=(3, 8, 8, 4))).astype(np.float32)}
    stub = types.SimpleNamespace(
        task="hrnet", thr=0.3, dtype=jnp.float32,
        _apply_model=lambda *a, **k: {h: jnp.asarray(v)
                                      for h, v in out.items()})
    ref = JaxXBDTrainer._eval_step_impl(stub, None, None, pre, post, msk, lbl)
    port = types.SimpleNamespace(
        task="hrnet", thr=0.3, dtype=torch.float32, mesh=None, model=None,
        _forward=lambda img6: {h: torch.from_numpy(v)
                               for h, v in out.items()})
    got = XBDTrainer.eval_step(port, *(torch.from_numpy(t) for t in
                                       (pre, post, msk, lbl)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("key", ["xbd_seresnext50_double", "xbd_senet154_loc",
                                 "xbd_dpn92_double",
                                 "xbd_unet_change_transformer",
                                 "xbd_unet_change_transformer_bit",
                                 "dual_hrnet", "dual_hrnet_fpn"])
def test_converters_round_trip(key):
    """port -> JAX converter -> port gives back the same tensors, and JAX ->
    port -> JAX the same arrays, with exactly the model's keys; for DPN92
    (no JAX converter) the flax tree -> port -> flax tree through the flax
    names, exact."""
    x, params, stats, sd = _case(key)
    family = _family(key)
    back = PORT_CONVERT[family](params, stats)
    assert set(back) == set(define_g(key, img_size=IMG).state_dict())
    if JAX_CONVERT[family] is None:
        for path, p, s in fi._leaf_modules(params, stats):
            k = fi._dpn_key(path)
            if "kernel" in p:
                np.testing.assert_array_equal(np.transpose(
                    back[f"{k}.weight"].numpy(), (2, 3, 1, 0)), p["kernel"])
            for leaf, name in (("scale", "weight"), ("bias", "bias")):
                if leaf in p:
                    np.testing.assert_array_equal(back[f"{k}.{name}"], p[leaf])
            for leaf, name in (("mean", "running_mean"),
                               ("var", "running_var")):
                if s is not None:
                    np.testing.assert_array_equal(back[f"{k}.{name}"], s[leaf])
        return
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    p2, s2 = JAX_CONVERT[family]({k: v.numpy() for k, v in back.items()})
    for a, b in ((params, p2), (stats, s2)):
        fa, fb = (traverse_util.flatten_dict(t) for t in (a, b))
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]), fb[k])


def test_import_checkpoint_and_predict_refusals(tmp_path):
    """A reference-named ``dual_hrnet`` checkpoint imports by name with its
    values; an ``xbd_unet_change_transformer`` one drops the dead
    transformer's keys; ``dual_hrnet_fpn`` refuses a checkpoint without FPN
    weights, the DPN92 UNets refuse any; ``xbd_predict`` refuses Dual-HRNet
    by name."""
    sd = _seeded(define_g("dual_hrnet", img_size=IMG), 8).state_dict()
    pt = str(tmp_path / "ref.pt")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, pt)
    path = import_checkpoint.main([pt, "--net_G", "dual_hrnet", "--out",
                                   str(tmp_path / "imported")])
    got = load_checkpoint(str(tmp_path / "imported"))[0]
    assert path.endswith("best_ckpt.pt") and set(got) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    uct = define_g("xbd_unet_change_transformer", img_size=IMG).state_dict()
    dead = {"transformer.layers.0.0.fn.norm.weight": torch.ones(4)}
    torch.save({"state_dict": {**uct, **dead}}, pt)
    import_checkpoint.main([pt, "--net_G", "xbd_unet_change_transformer",
                            "--img_size", str(IMG), "--out",
                            str(tmp_path / "uct")])
    assert set(load_checkpoint(str(tmp_path / "uct"))[0]) == set(uct)
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, pt)
    with pytest.raises(ValueError, match="fpn_loc"):
        import_checkpoint.main([pt, "--net_G", "dual_hrnet_fpn", "--out",
                                str(tmp_path / "fpn")])
    with pytest.raises(NotImplementedError, match="dpn92"):
        import_checkpoint.main([pt, "--net_G", "xbd_dpn92_loc", "--out",
                                str(tmp_path / "dpn")])
    with pytest.raises(NotImplementedError, match="dual_hrnet"):
        xbd_predict.main(["--net_G", "dual_hrnet", "--checkpoints",
                          str(tmp_path / "imported"), "--out_dir",
                          str(tmp_path / "pred"), "--device", "cpu"])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A seeded synthetic xBD tree of 4 tiles of 64 px."""
    root = str(tmp_path_factory.mktemp("xbd_zoo") / "train")
    write_synthetic_xbd(root, n_tiles=4, size=IMG, seed=9, block=8)
    return root


@pytest.mark.parametrize("net", [None, "dual_hrnet_fpn"])
def test_xbd_train_hrnet_on_cpu(tree, tmp_path, net):
    """``xbd_train --task hrnet`` (``--net_G`` left at its default, which
    becomes ``dual_hrnet``, or ``dual_hrnet_fpn``) for one epoch at 64 px,
    batch 2: a finite loss, a score in [0, 1] and
    ``best_ckpt.pt`` with the Dual-HRNet's weights."""
    history = xbd_train.main(
        ["--data_root", tree, "--task", "hrnet", "--img_size", str(IMG),
         "--batch_size", "2", "--max_epochs", "1", "--eval_every", "1",
         "--checkpoint_root", str(tmp_path), "--project_name", "hr",
         "--device", "cpu"] + (["--net_G", net] if net else []))
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert 0.0 <= history[0]["val"]["score"] <= 1.0
    sd = load_checkpoint(str(tmp_path / "hr"))[0]
    want = define_g(net or "dual_hrnet", img_size=IMG).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


def test_loc_task_feeds_one_image_to_the_loc_models():
    """The ``loc`` task's forward gives the _loc models the pre image alone
    (3 channels), the other tasks the 6-channel pair."""
    seen = []
    stub = types.SimpleNamespace(
        task="loc", model=lambda x, train=False: seen.append(x.shape[-1]))
    img6 = torch.zeros(1, 8, 8, 6)
    XBDTrainer._forward(stub, img6)
    stub.task = "hrnet"
    XBDTrainer._forward(stub, img6)
    assert seen == [3, 6]
