"""Whole xBD zoo models against the JAX package in training and in bf16, on
the CPU: one key per family, ``xbd_seresnext50_loc`` and
``xbd_unet_change_transformer`` here, ``xbd_dpn92_loc`` in
``tests/test_torch_xbd_zoo_grads_dpn.py`` and ``dual_hrnet`` in
``tests/test_torch_xbd_zoo_grads_hrnet.py``, which import this file's
checks (the jitted JAX steps' compiles set each file's time; Dual-HRNet's
is the longest).

Weights as ``tests/test_torch_xbd_zoo.py`` makes them: the port's seeded
``state_dict`` through the JAX converters, or for DPN92 (no JAX converter) a
seeded flax tree through the port's. Inputs are seeded numpy at 64 px,
batch 2 (a second date at half the first's contrast plus noise), masks
seeded at p = 0.3.

  * The train step: the train-mode forward, the task's loss
    (``xbd_localization_loss`` for the ``_loc`` keys, ``xbd_damage_loss``,
    ``dual_hrnet_loss``) and every parameter's gradient against
    ``jax.value_and_grad`` of the JAX loss (one jitted step, run again for
    four 1e-6 input moves): the loss to 1e-5 relative (of JAX's loss, or
    where a pixel of an argmax the loss reads flips, of one of its moved
    runs': ``dual_hrnet_loss`` reads the loc head's argmax, and one move of
    JAX's flips the same pixel the port's rounding flips); the gradients to
    1e-3 of the whole gradient's scale or, where larger, the median of
    JAX's own moves under the four input moves (ROADMAP.md section 3, rule
    5); the updated BatchNorm statistics to 1e-4 of their scale or, where
    larger, the median of JAX's own moves.
  * The bf16 eval forward: within 1.25 times JAX's own bf16-to-fp32
    distance of JAX's bf16 and fp32 logits, and at least half that
    distance from the port's fp32 logits (``tests/test_torch_xbd.py``'s
    bf16 rule).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from dahitra_tpu.core.torch_import import (convert_dual_hrnet,
                                           convert_se_unet,
                                           convert_xbd_unet_change_transformer)
from dahitra_tpu.losses import combo as jcombo
from dahitra_tpu.models import dpn_unet as jdpn
from dahitra_tpu.models.registry import define_g as jax_define_g
from dahitra_tpu_torch.core import flax_import as fi
from dahitra_tpu_torch.core.checkpoint import load_weights
from dahitra_tpu_torch.losses import combo
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.nn.init import init_random

IMG = 64
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# family -> (JAX converter of the port's state_dict or None, the port's
# converter of a flax tree)
CONVERT = {
    "xbd_seresnext50": (lambda sd: convert_se_unet(sd, "se_resnext50"),
                        fi.se_unet_flax_to_state_dict),
    "xbd_dpn92": (None, fi.dpn_unet_flax_to_state_dict),
    "xbd_unet_change_transformer": (
        lambda sd: convert_xbd_unet_change_transformer(sd, bit=False),
        fi.xbd_unet_change_transformer_flax_to_state_dict),
    "dual_hrnet": (convert_dual_hrnet, fi.dual_hrnet_flax_to_state_dict),
}
KEYS = ("xbd_seresnext50_loc", "xbd_unet_change_transformer")


@pytest.fixture(autouse=True)
def few_threads():
    """torch on at most 4 CPU threads (the suite runs six workers on eight
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _family(key):
    return next(f for f in CONVERT if key.startswith(f))


def _one_image(key):
    return key.endswith("_loc")


def _scaled(got, ref):
    got, ref = (np.asarray(v, np.float32) for v in (got, ref))
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def _fill(shapes, rng):
    """A seeded numpy tree for an eval_shape tree (lecun-normal kernels,
    scales near 1, biases and means near 0, variances in [0.5, 1.5])."""
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


@functools.lru_cache(maxsize=None)
def case(key):
    """(x, masks, params, batch_stats) of ``key``, seeded."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    if not _one_image(key):
        x2 = 0.5 * x + 0.3 * rng.uniform(-1, 1, x.shape).astype(np.float32)
        x = np.concatenate([x, x2], -1)
    masks = (rng.rand(2, IMG, IMG, 5) < 0.3).astype(np.float32)
    to_jax, _ = CONVERT[_family(key)]
    if to_jax is None:  # DPN92: a seeded flax tree
        core = jax.eval_shape(lambda: jdpn._DPNUnetCore().init(
            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))))
        frng = np.random.RandomState(1)
        params, stats = ({"core": _fill(core[c], frng)}
                         for c in ("params", "batch_stats"))
        c_in, c_out = (32, 1) if _one_image(key) else (64, 5)
        params["res"] = {
            "kernel": frng.normal(0, c_in ** -0.5, (1, 1, c_in, c_out)
                                  ).astype(np.float32),
            "bias": (0.1 * frng.normal(size=c_out)).astype(np.float32)}
        return x, masks, params, stats
    model = define_g(key, img_size=IMG)
    gen = torch.Generator().manual_seed(0)
    init_random(model, gen)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    params, stats = to_jax({k: v.numpy() for k, v in
                            model.state_dict().items()})
    return x, masks, params, stats


def port_model(key, params, stats, dtype=torch.float32):
    model = define_g(key, dtype=dtype, img_size=IMG)
    load_weights(model, CONVERT[_family(key)][1](params, stats))
    return model


def _jax_args(key, x, train):
    return (x, train) if _one_image(key) else (x, None, train)


def _loss(key, out, masks, lib):
    """The task's loss of the train-mode output (fp32 logits)."""
    if isinstance(out, dict):
        return lib.dual_hrnet_loss(out, masks)
    if _one_image(key):
        return lib.xbd_localization_loss(out.astype(jnp.float32) if lib is
                                         jcombo else out.float(),
                                         masks[..., 0])
    return lib.xbd_damage_loss(out.astype(jnp.float32) if lib is jcombo
                               else out.float(), masks)


def check_train_step(key):
    """The port's train step against the jitted JAX step and its four
    input moves (module docstring); returns the JAX step's outputs."""
    x, masks, params, stats = case(key)
    model_j = jax_define_g(key, img_size=IMG)
    jmasks = jnp.asarray(masks)

    def loss_fn(p, xx):
        out, mut = model_j.apply({"params": p, "batch_stats": stats},
                                 *_jax_args(key, xx, True),
                                 mutable=["batch_stats"])
        return _loss(key, out, jmasks, jcombo), mut["batch_stats"]

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    runs = [step(params, jnp.asarray(x))]
    for i in range(4):
        moved = x + 1e-6 * np.random.RandomState(100 + i).normal(
            size=x.shape).astype(np.float32)
        runs.append(step(params, jnp.asarray(moved)))
    to_port = CONVERT[_family(key)][1]
    named = [(to_port(jax.tree.map(np.asarray, g), stats),
              to_port(params, jax.tree.map(np.asarray, s)))
             for (_, s), g in runs]

    model = port_model(key, params, stats)
    loss = _loss(key, model(torch.from_numpy(x), train=True),
                 torch.from_numpy(masks), combo)
    loss.backward()
    # within 1e-5 of JAX's loss, or of one of its moved runs' where an
    # argmax the loss reads flips (Dual-HRNet's loc head)
    ref_losses = [float(r[0][0]) for r in runs]
    assert min(abs(loss.item() - r) / abs(ref_losses[0])
               for r in ref_losses) <= 1e-5, (loss.item(), ref_losses)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()
             if p.grad is not None}
    want_g, want_s = named[0]
    for k, p in model.named_parameters():  # no gradient: JAX's is zero
        if p.grad is None:
            assert not np.abs(want_g[k].numpy()).any(), k
    g_scale = max(np.abs(want_g[k].numpy()).max() for k in grads)
    bufs = {k: v.numpy() for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}
    s_scale = max(np.abs(want_s[k].numpy()).max() for k in bufs)

    def g_dist(g):
        return max(np.abs(g[k] - want_g[k].numpy()).max()
                   for k in grads) / g_scale

    def s_dist(s):
        return max(np.abs(s[k] - want_s[k].numpy()).max()
                   for k in bufs) / s_scale

    own_g = [g_dist({k: v.numpy() for k, v in g.items()})
             for g, _ in named[1:]]
    own_s = [s_dist({k: v.numpy() for k, v in s.items()})
             for _, s in named[1:]]
    g_err, s_err = g_dist(grads), s_dist(bufs)
    assert g_err <= max(1e-3, float(np.median(own_g))), (g_err, own_g)
    assert s_err <= max(1e-4, float(np.median(own_s))), (s_err, own_s)
    return runs[0]


def _logits(out):
    parts = [out[k] for k in sorted(out)] if isinstance(out, dict) \
        else [out]
    return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for v in parts])


def check_bf16_forward(key, jit: bool = True):
    """The bf16 eval forward under ``tests/test_torch_xbd.py``'s rule, the
    JAX forwards jitted or not (un-jitted, DPN92's takes half a minute;
    jitted, Dual-HRNet's compiles for 20 s a dtype)."""
    x, _, params, stats = case(key)
    ref = {}
    for dname in ("float32", "bfloat16"):
        model_j = jax_define_g(key, img_size=IMG, dtype=JDT[dname])

        def fwd(p, s, xx):
            return model_j.apply({"params": p, "batch_stats": s},
                                 *_jax_args(key, xx, False))

        out = (jax.jit(fwd) if jit else fwd)(params, stats,
                                             jnp.asarray(x, JDT[dname]))
        ref[dname] = _logits(jax.tree.map(np.asarray, out) if isinstance(
            out, dict) else np.asarray(out, np.float32))
    got = {}
    for dname in ("float32", "bfloat16"):
        with torch.no_grad():
            out = port_model(key, params, stats, TDT[dname])(
                torch.from_numpy(x).to(TDT[dname]))
        got[dname] = _logits({k: v.float().numpy() for k, v in out.items()}
                             if isinstance(out, dict) else out.float().numpy())
    own = _scaled(ref["bfloat16"], ref["float32"])
    for r in (ref["bfloat16"], ref["float32"]):
        err = _scaled(got["bfloat16"], r)
        assert err <= 1.25 * own, (err, own)
    rounding = _scaled(got["bfloat16"], got["float32"])
    assert rounding >= 0.5 * own, (rounding, own)


@pytest.mark.parametrize("key", KEYS)
def test_train_step_grads_match_jax(key):
    """Loss 1e-5; gradients max(1e-3, the median of JAX's own moves under
    four 1e-6 input moves) of the whole gradient's scale (rule 5); BN
    statistics max(1e-4, the median of JAX's own moves)."""
    check_train_step(key)


@pytest.mark.parametrize("key", KEYS)
def test_bf16_forward_matches_jax(key):
    """Within 1.25 times JAX's own bf16-to-fp32 distance of both JAX
    logits, at least half of it from the port's fp32 logits."""
    check_bf16_forward(key)
