"""The port's ChangeFormer (``changeFormer``) and ChangeFormerV6
(``changeFormerV6``) against the flax models, the multi-scale loss and its
nearest-resized targets, and drop path.

Weights come from the flax init (seeded numpy biases and BN statistics on
top, so those paths carry values) through
``changeformer_flax_to_state_dict``, which is also held as the inverse of
the JAX ``convert_changeformer``, both ways. Inputs are seeded numpy, 64 px. The JAX side
of a train-mode forward with every dropout and drop-path rate 0 applies the
flax encoder and decoder (or V1's projection and head) with those rates 0 on
``params['Tenc']`` and ``params['TDec']`` (the eval forward too, which
runs them as ``ChangeFormerV1`` / ``ChangeFormerV6`` do, the encoder over
both dates batch-stacked to halve its compile); the port's rates are set to
0. V1 has no BatchNorm, so at rate 0 its JAX train forward is its eval
forward, and the port's train forward is held to that.

fp32 forwards are held to 1e-5 of the flax logits' scale, every head of
V6's list, or, where larger, to twice the largest of JAX's own moves under
four 1e-6 input moves (the rule of tests/test_torch_zoo_unet.py): in train
mode at batch 1 V6's ``make_pred_c2`` BatchNorm normalizes a channel with one
nonzero ReLU output among 64 pixels, at 6e-4 of the other channel's largest,
which amplifies fp32 noise about 1700 times (JAX's own moves of that head:
6e-5 to 2.2e-4; the port 3.9e-4). bf16 (V6): the forward's output, its five
heads flattened together and scaled by their largest value, within 2e-2 of
JAX's bf16 output and of its fp32 output, or 1.25 times JAX's own
bf16-to-fp32 distance where that is larger (the rule of
tests/test_torch_xbd.py). The multi-scale train-step gradient (batch 2) to
max(1e-3, the median of JAX's own deviations under four 1e-6 input moves)
of the whole gradient's scale (ROADMAP.md section 3, fault 5).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn
from flax import traverse_util

from dahitra_tpu.core.torch_import import convert_changeformer
from dahitra_tpu.losses.cd import levir_train_loss as jax_levir_train_loss
from dahitra_tpu.models import changeformer as jcf
from dahitra_tpu.models.registry import define_g as jax_define_g
from dahitra_tpu_torch.core.checkpoint import load_weights
from dahitra_tpu_torch.core.flax_import import changeformer_flax_to_state_dict
from dahitra_tpu_torch.losses.cd import (MULTI_SCALE_WEIGHTS,
                                         levir_train_loss, multi_scale_loss,
                                         resize_labels_nearest)
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.nn.blocks import Dropout

IMG = 64
V1, V6 = "changeFormer", "changeFormerV6"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Encoder depths and patch size of each key (registry.py:83-91).
ENC = {V1: dict(depths=(3, 4, 6, 3), patch_size=3),
       V6: dict(depths=(3, 3, 4, 3), patch_size=7)}


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
    """(x1, x2 (2, 64, 64, 3), params, batch_stats) of the flax model
    ``key``, seeded; the second date at half the first's contrast plus
    noise."""
    rng = np.random.RandomState(0)
    x1 = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    x2 = (0.5 * x1 + 0.3 * rng.uniform(-1, 1, x1.shape)).astype(np.float32)
    variables = jax.jit(jax_define_g(key).init)(
        jax.random.PRNGKey(0), jnp.asarray(x1[:1]), jnp.asarray(x2[:1]))
    return (x1, x2, _perturb(variables["params"], rng),
            _perturb(variables.get("batch_stats", {}), rng))


def _port(key, dtype=torch.float32, rates_zero=False):
    _, _, params, stats = _flax_case(key)
    model = define_g(key, dtype=dtype)
    load_weights(model, changeformer_flax_to_state_dict(params, stats,
                                                        v6=key == V6))
    if rates_zero:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    return model


def _scaled(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3))


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _jax_forward(key, dtype, train):
    """(params, stats, x1, x2) -> (list of logits, new batch_stats) of the
    flax model's submodules, with every dropout and drop-path rate 0 (in
    eval mode they are inactive anyway): the encoder once over both dates
    batch-stacked (it has no BatchNorm, so this is its two calls), then
    V6's decoder, or V1's projection and head."""
    enc = jcf.EncoderTransformerV3(drop=0.0, attn_drop=0.0,
                                   drop_path_rate=0.0, dtype=dtype, **ENC[key])

    def fn(p, s, a, b):
        feats = enc.apply({"params": p["Tenc"]}, jnp.concatenate([a, b]),
                          train)
        f1, f2 = ([f[:a.shape[0]] for f in feats],
                  [f[a.shape[0]:] for f in feats])
        if key == V6:
            out, mut = jcf.DecoderTransformerV3(dtype=dtype).apply(
                {"params": p["TDec"], "batch_stats": s["TDec"]}, f1, f2, train,
                mutable=["batch_stats"])
            return out, {"TDec": mut["batch_stats"]}
        di = [jnp.abs(x - y) for x, y in zip(f1, f2)]
        y = jcf.ConvProjectionBase(dtype=dtype).apply(
            {"params": p["convproj"]}, di)
        head = fnn.Conv(2, (3, 3), padding=1, dtype=dtype)
        return [head.apply({"params": p["change_probability"]}, y)], s
    return fn


@functools.lru_cache(maxsize=None)
def _jax_fn(key, dname, train):
    return jax.jit(_jax_forward(key, JDT[dname], train))


def _jax_out(key, dname="float32", train=False, move=None):
    """JAX's logits (batch 1) and new BN statistics; ``move`` (a seed)
    moves the first date by 1e-6 N(0, 1)."""
    x1, x2, params, stats = _flax_case(key)
    a = x1[:1]
    if move is not None:
        a = a + 1e-6 * np.random.RandomState(move).normal(
            size=a.shape).astype(np.float32)
    out, new_stats = _jax_fn(key, dname, train and key == V6)(
        params, stats, a.astype(JDT[dname]), x2[:1].astype(JDT[dname]))
    return [np.asarray(o, np.float32) for o in out], new_stats


def _port_out(key, dname="float32", train=False):
    x1, x2, _, _ = _flax_case(key)
    model = _port(key, TDT[dname], rates_zero=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x1[:1]).to(TDT[dname]),
                    torch.from_numpy(x2[:1]).to(TDT[dname]), train=train)
    return [o.float().numpy() for o in _as_list(out)], model


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("key", [V1, V6])
def test_forward_matches_flax(key, train):
    """fp32 logits, every head, to 1e-5 of each head's flax scale or twice
    JAX's largest own move (module docstring); in train mode (every rate 0)
    V6's updated BN running statistics to 1e-4."""
    ref, ref_stats = _jax_out(key, train=train)
    got, model = _port_out(key, train=train)
    sizes = [(IMG // 32) * 2 ** i for i in range(4)] + [IMG] if key == V6 \
        else [IMG]
    assert [g.shape for g in got] == [r.shape for r in ref] == [
        (1, s, s, 2) for s in sizes]
    for i, (g, r) in enumerate(zip(got, ref)):
        err = _scaled(g, r)
        if err > 1e-5:
            own = [_scaled(_jax_out(key, train=train, move=100 + m)[0][i], r)
                   for m in range(4)]
            assert err <= 2 * max(own), (i, err, own)
    if train and key == V6:
        _, _, params, _ = _flax_case(key)
        want = changeformer_flax_to_state_dict(
            params, jax.tree.map(np.asarray, ref_stats))
        for k, v in model.named_buffers():
            assert _scaled(v.numpy(), want[k].numpy()) <= 1e-4, k


def test_v6_bf16_forward_matches_flax():
    """bf16 V6, the five heads flattened together: within 2e-2 of JAX's
    bf16 and of its fp32 output's scale, or 1.25 times JAX's own
    bf16-to-fp32 distance where that is larger."""
    def flat(heads):
        return np.concatenate([h.ravel() for h in heads])

    ref, ref32 = flat(_jax_out(V6, "bfloat16")[0]), flat(_jax_out(V6)[0])
    got = flat(_port_out(V6, "bfloat16")[0])
    bound = max(2e-2, 1.25 * _scaled(ref, ref32))
    for r in (ref, ref32):
        assert _scaled(got, r) <= bound, (_scaled(got, r), bound)


@pytest.mark.parametrize("key", [V1, V6])
def test_state_dict_round_trip(key):
    """JAX -> port -> ``convert_changeformer`` gives back the same arrays,
    the port model has exactly those keys, and port -> JAX -> port the same
    tensors."""
    _, _, params, stats = _flax_case(key)
    sd = changeformer_flax_to_state_dict(params, stats, v6=key == V6)
    assert set(sd) == set(define_g(key).state_dict())
    p2, s2 = convert_changeformer({k: v.numpy() for k, v in sd.items()},
                                  v6=key == V6)
    for a, b in ((params, p2), (stats, s2)):
        fa, fb = (traverse_util.flatten_dict(t) for t in (a, b))
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]), fb[k],
                                          err_msg=str(k))
    back = changeformer_flax_to_state_dict(p2, s2, v6=key == V6)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(2, 2), (4, 4), (8, 8), (16, 16), (5, 7),
                                (64, 64)])
def test_resize_labels_nearest_matches_jax(hw):
    """The multi-scale targets: ``resize_labels_nearest`` takes the source
    index floor((i + 0.5) * H / h), as ``jax.image.resize(..., 'nearest')``
    does (at 4x, 4i + 2), which torch's ``mode='nearest'`` does not (4i)."""
    label = np.arange(2 * 64 * 64).reshape(2, 64, 64) % 251
    ref = np.asarray(jax.image.resize(jnp.asarray(label, jnp.float32),
                                      (2,) + hw, "nearest")).astype(np.int64)
    got = resize_labels_nearest(torch.from_numpy(label), *hw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    if hw == (16, 16):
        assert got[0, 0, 1] == label[0, 2, 6]
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(label)[:, None].float(), size=hw,
            mode="nearest")[:, 0].long()
        assert not torch.equal(plain, got)


def test_v6_multi_scale_train_step_grads_match_flax():
    """One multi-scale train step of V6 at 64 px, batch 2, every rate 0:
    the loss (the JAX engine's weighted sum over the five heads,
    engine.py:127-151) to 1e-5 relative, and it differs from the
    full-resolution head's alone; the gradients to max(1e-3, the median of
    JAX's own deviations under four 1e-6 input moves) of the whole
    gradient's scale (JAX's moves are taken only where the port lies
    beyond 1e-3)."""
    x1, x2, params, stats = _flax_case(V6)
    label = (np.random.RandomState(7).rand(2, IMG, IMG) < 0.3).astype(
        np.uint8)
    fwd = _jax_forward(V6, jnp.float32, True)

    def loss_fn(p, a):
        out, _ = fwd(p, stats, a, x2)
        loss = 0.0
        for w, lg in zip(MULTI_SCALE_WEIGHTS, out):
            tgt = jax.image.resize(jnp.asarray(label, jnp.float32),
                                   (2, lg.shape[1], lg.shape[2]),
                                   "nearest").astype(jnp.int32)
            loss = loss + w * jax_levir_train_loss(lg.astype(jnp.float32),
                                                   tgt, 2)
        return loss

    step = jax.jit(jax.value_and_grad(loss_fn))
    model = _port(V6, rates_zero=True)
    named = dict(model.named_parameters())

    def jax_grads(a):
        loss, grads = step(params, jnp.asarray(a))
        sd = changeformer_flax_to_state_dict(jax.tree.map(np.asarray, grads),
                                             stats)
        return float(loss), {k: sd[k].numpy() for k in named}

    ref_loss, want = jax_grads(x1)
    out = model(torch.from_numpy(x1), torch.from_numpy(x2), train=True)
    loss = multi_scale_loss(out, torch.from_numpy(label), 2)
    loss.backward()
    assert loss.item() == pytest.approx(ref_loss, rel=1e-5)
    single = levir_train_loss(out[-1].float(), torch.from_numpy(label), 2)
    assert abs(single.item() - loss.item()) > 1e-3
    scale = max(np.abs(v).max() for v in want.values())

    def dist(a):
        return max(np.abs(a[k] - want[k]).max() for k in named) / scale

    port = dist({k: p.grad.numpy() for k, p in named.items()})
    if port > 1e-3:
        own = [dist(jax_grads(x1 + 1e-6 * np.random.RandomState(
            100 + i).normal(size=x1.shape).astype(np.float32))[1])
            for i in range(4)]
        assert port <= float(np.median(own)), (port, own)


def test_drop_path_is_per_sample():
    """Drop path (``Dropout(per='sample')``): one draw per sample (each
    sample all kept, scaled by 1 / (1 - p), or all zero), the kept share
    over 20k samples within 3 sigma of 1 - p, the same bits from the same
    generator seed; V6 ramps its 13 blocks' rates linearly from 0 to 0.1
    and drops nothing in eval mode."""
    p, n = 0.1, 20_000
    drop = Dropout(p, per="sample")
    drop.generator = torch.Generator().manual_seed(3)
    y = drop(torch.ones(n, 4, 4, 8), deterministic=False)
    per = y.reshape(n, -1)
    assert ((per == 0).all(1) | (per == 1 / (1 - p)).all(1)).all()
    kept = (per[:, 0] != 0).float().mean().item()
    assert abs(kept - (1 - p)) <= 3 * (p * (1 - p) / n) ** 0.5
    drop.generator = torch.Generator().manual_seed(3)
    torch.testing.assert_close(drop(torch.ones(n, 4, 4, 8),
                                    deterministic=False), y, rtol=0, atol=0)
    model = define_g(V6)
    rates = [m.drop_path.rate for m in model.modules()
             if hasattr(m, "drop_path")]
    np.testing.assert_allclose(rates, np.linspace(0, 0.1, 13), atol=1e-12)
    x = torch.ones(2, 32, 32, 3)
    with torch.no_grad():
        a, b = model(x, x), model(x, x)
    torch.testing.assert_close(a[-1], b[-1], rtol=0, atol=0)
