"""The port's UNet change transformers (``unet_coupled_trans_256``,
``unet_coupled_two_trans_256``) and ``siamUnet_conc`` against the flax
models, and the blocks this slice adds: ``Dropout`` (element and channel),
``ConvReluBN``, ``max_pool_2x2``, the Bottleneck trunk (resnet50),
``init_weights`` on a transposed conv, and the decoder's ``fast_vjp`` switch
and dropout gate.

Weights come from the flax init (seeded numpy biases and BN statistics, so
those paths carry values) through the port's converters
(``unet_change_transformer_flax_to_state_dict``,
``siam_unet_conc_flax_to_state_dict``), which are also held as the inverses
of the JAX converters, both ways. Inputs are seeded numpy, 64 px, batch 1.
The forwards are held to 1e-5 of the flax logits' scale in eval mode and in
train mode with every dropout rate 0 (the flax ``Dropout`` patched to the
identity in the test; the port's rates set to 0), or, where larger, to
twice the largest of JAX's own logit moves under four 1e-6 input moves (the
rule chip_smoke.py phase 16 holds the card to; ROADMAP.md section 3, fault
5): at 64 px the UNet change transformers' bottleneck tokens are 4 wide, and
their LayerNorm over 4 saturated tanh values amplifies fp32 summation noise
(the port's fp32 logits lie closer to a float64 evaluation than JAX's do).
BN running statistics are held to 1e-4, as in that file; bf16 within 2e-2,
or 1.25 times JAX's own bf16-to-fp32 distance where that is larger.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp
from flax import traverse_util

from dahitra_tpu.core.torch_import import (convert_resnet_trunk,
                                           convert_siam_unet_conc,
                                           convert_unet_change_transformer)
from dahitra_tpu.models.registry import define_g as jax_define_g
from dahitra_tpu.nn import blocks as jb
from dahitra_tpu.nn.resnet import ResNetTrunk as JaxTrunk
from dahitra_tpu_torch.core.checkpoint import load_weights
from dahitra_tpu_torch.core.flax_import import (
    siam_unet_conc_flax_to_state_dict, unet_change_transformer_flax_to_state_dict)
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.nn import blocks as tb
from dahitra_tpu_torch.nn.init import init_random, init_weights
from dahitra_tpu_torch.nn.resnet import ResNetTrunk

IMG = 64
KEYS = ("unet_coupled_trans_256", "unet_coupled_two_trans_256",
        "siamUnet_conc")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    """(x1, x2, params, batch_stats) of the flax model ``key``, seeded; the
    second date at half the first's contrast plus noise."""
    rng = np.random.RandomState(0)
    x1 = rng.uniform(-1, 1, (1, IMG, IMG, 3)).astype(np.float32)
    x2 = (0.5 * x1 + 0.3 * rng.uniform(-1, 1, x1.shape)).astype(np.float32)
    variables = jax.jit(jax_define_g(key, img_size=IMG).init)(
        jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x2))
    return (x1, x2, _perturb(variables["params"], rng),
            _perturb(variables["batch_stats"], rng))


def _to_state_dict(key, params, stats):
    if key == "siamUnet_conc":
        return siam_unet_conc_flax_to_state_dict(params, stats)
    return unet_change_transformer_flax_to_state_dict(
        params, stats, two=key == "unet_coupled_two_trans_256")


def _port(key, dtype=torch.float32):
    _, _, params, stats = _flax_case(key)
    model = define_g(key, dtype=dtype, img_size=IMG)
    load_weights(model, _to_state_dict(key, params, stats))
    return model


def _scaled(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3))


@functools.lru_cache(maxsize=None)
def _jax_apply(key, dname, train):
    model = jax_define_g(key, img_size=IMG, dtype=JDT[dname])

    def fn(p, s, a, b):
        if train:
            return model.apply({"params": p, "batch_stats": s}, a, b, True,
                               mutable=["batch_stats"])
        return model.apply({"params": p, "batch_stats": s}, a, b, False), {}

    return jax.jit(fn)


def _jax_out(key, dname="float32", train=False):
    x1, x2, params, stats = _flax_case(key)
    logits, mut = _jax_apply(key, dname, train)(
        params, stats, x1.astype(JDT[dname]), x2.astype(JDT[dname]))
    return np.asarray(logits, np.float32), mut


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """flax ``Dropout`` as the identity: the JAX side of a train-mode
    forward with every dropout rate 0."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, *a, **k: x)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("key", KEYS)
def test_forward_matches_flax(key, train, no_flax_dropout):
    """fp32 logits to 1e-5 of the flax logits' scale or twice JAX's largest
    own move (module docstring); in train mode (every dropout rate 0) also
    every updated BN running statistic, to 1e-4."""
    x1, x2, params, stats = _flax_case(key)
    ref, mut = _jax_out(key, train=train)
    model = _port(key)
    for m in model.modules():
        if isinstance(m, tb.Dropout):
            m.rate = 0.0
    with torch.no_grad():
        got = model(torch.from_numpy(x1), torch.from_numpy(x2), train=train)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (
        1, IMG, IMG, 2)
    err = _scaled(got.numpy(), ref)
    if err > 1e-5:
        own = [_scaled(np.asarray(_jax_apply(key, "float32", train)(
            params, stats, x1 + 1e-6 * np.random.RandomState(100 + i).normal(
                size=x1.shape).astype(np.float32), x2)[0]), ref)
            for i in range(4)]
        assert err <= 2 * max(own), (err, own)
    if train:
        want = _to_state_dict(key, params, jax.tree.map(
            np.asarray, mut["batch_stats"]))
        for k, v in model.named_buffers():
            assert _scaled(v.numpy(), want[k].numpy()) <= 1e-4, k


def test_bf16_forward_matches_flax():
    """``unet_coupled_trans_256`` in bf16: within 2e-2 of the bf16 flax
    logits' scale, or 1.25 times JAX's own bf16-to-fp32 distance where
    that is larger."""
    key = "unet_coupled_trans_256"
    x1, x2, _, _ = _flax_case(key)
    ref = _jax_out(key, "bfloat16")[0]
    own = _scaled(ref, _jax_out(key)[0])
    with torch.no_grad():
        got = _port(key, torch.bfloat16).eval()(
            torch.from_numpy(x1).bfloat16(), torch.from_numpy(x2).bfloat16())
    assert got.dtype == torch.bfloat16
    err = _scaled(got.float().numpy(), ref)
    assert err <= max(2e-2, 1.25 * own), (err, own)


@pytest.mark.parametrize("key", KEYS)
def test_state_dict_round_trip(key):
    """JAX -> port -> the JAX converter gives back the same arrays, the port
    model has exactly those keys, and port -> JAX -> port the same
    tensors."""
    _, _, params, stats = _flax_case(key)
    sd = _to_state_dict(key, params, stats)
    assert set(sd) == set(define_g(key, img_size=IMG).state_dict())
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    p2, s2 = (convert_siam_unet_conc(numpy_sd) if key == "siamUnet_conc"
              else convert_unet_change_transformer(
                  numpy_sd, two=key == "unet_coupled_two_trans_256"))
    for a, b in ((params, p2), (stats, s2)):
        fa, fb = (traverse_util.flatten_dict(t) for t in (a, b))
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]), fb[k],
                                          err_msg=str(k))
    back = _to_state_dict(key, p2, s2)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_dropout_statistics_and_seed():
    """Element dropout at p = 0.3 over 200k elements: the kept share within
    3 sigma of 1 - p, kept values scaled by 1 / (1 - p); Dropout2d on NHWC
    drops whole channels, one draw per (sample, channel); the same
    generator seed gives the same bits; deterministic and rate 0 are the
    identity."""
    p, n = 0.3, 200_000
    x = torch.ones(n)
    drop = tb.Dropout(p)
    drop.generator = torch.Generator().manual_seed(5)
    y = drop(x, deterministic=False)
    kept = (y != 0).float().mean().item()
    assert abs(kept - (1 - p)) <= 3 * (p * (1 - p) / n) ** 0.5
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0],
                                                          1 / (1 - p)))
    drop.generator = torch.Generator().manual_seed(5)
    torch.testing.assert_close(drop(x, deterministic=False), y, rtol=0,
                               atol=0)
    assert drop(x) is x and tb.Dropout(0.0)(x, deterministic=False) is x

    ch = tb.Dropout(0.2, per="channel")
    tb.set_dropout_generator(torch.nn.Sequential(ch),
                             torch.Generator().manual_seed(6))
    z = ch(torch.ones(8, 5, 6, 64), deterministic=False)
    per_channel = (z != 0).float().mean(dim=(1, 2))
    assert ((per_channel == 0) | (per_channel == 1)).all()
    assert 0 < per_channel.mean().item() < 1
    torch.testing.assert_close(z[z != 0], torch.full_like(z[z != 0], 1.25))


def test_siam_unet_conc_dropout_is_channelwise_in_training():
    """siamUnet_conc builds one Dropout2d(0.2) after every encoder conv and
    every deconv (19), drops only in train mode and, from the same
    generator seed, gives the same bits."""
    model = define_g("siamUnet_conc")
    drops = [m for m in model.modules() if isinstance(m, tb.Dropout)]
    assert len(drops) == 19 and all(
        d.rate == 0.2 and d.per == "channel" for d in drops)
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32))
    outs = []
    for _ in range(2):
        tb.set_dropout_generator(model, torch.Generator().manual_seed(9))
        outs.append(model(x, x.flip(1), train=True))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with torch.no_grad():
        e1, e2 = model(x, x.flip(1)), model(x, x.flip(1))
    torch.testing.assert_close(e1, e2, rtol=0, atol=0)
    assert (outs[0] - e1).abs().max() > 0


def test_resnet50_trunk_matches_flax():
    """The Bottleneck trunk, eval mode, four layers at the standard
    strides, against the flax ``ResNetTrunk('resnet50')`` through
    ``convert_resnet_trunk`` (which reads torchvision's names)."""
    port = ResNetTrunk("resnet50", (False, False, False))
    rng = np.random.RandomState(20)
    with torch.no_grad():
        for name, t in list(port.named_parameters()) + list(
                port.named_buffers()):
            if name.endswith("running_var"):
                v = rng.uniform(0.5, 1.5, t.shape)
            elif t.dim() > 1:
                v = rng.normal(0.0, t[0].numel() ** -0.5, t.shape)
            else:
                v = rng.normal(0.0, 0.2, t.shape) + name.endswith("weight")
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    params, stats = convert_resnet_trunk(
        {k: v.numpy() for k, v in port.state_dict().items()})
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(JaxTrunk("resnet50", (False, False, False)).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 2, 2, 2048)
    assert _scaled(got, ref) <= 1e-5


def test_conv_relu_bn_and_max_pool_2x2_match_jax():
    """``ConvReluBN`` in eval and train mode (the updated statistics too)
    and ``max_pool_2x2`` on an odd-sized map (the last row and column
    dropped) against the JAX blocks."""
    rng = np.random.RandomState(3)
    x = rng.normal(size=(2, 9, 7, 5)).astype(np.float32)
    port = tb.ConvReluBN(5, 6)
    with torch.no_grad():
        port.conv.weight.copy_(torch.from_numpy(rng.normal(
            0, 0.3, (6, 5, 3, 3)).astype(np.float32)))
        port.conv.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 6).astype(
            np.float32)))
        port.bn.running_var.uniform_(0.5, 1.5)
    params = {"conv": {"kernel": np.transpose(port.conv.weight.detach().numpy(),
                                              (2, 3, 1, 0)),
                       "bias": port.conv.bias.detach().numpy()},
              "bn": {"scale": port.bn.weight.detach().numpy(),
                     "bias": port.bn.bias.detach().numpy()}}
    stats = {"bn": {"mean": port.bn.running_mean.numpy().copy(),
                    "var": port.bn.running_var.numpy().copy()}}
    for train in (False, True):
        ref, mut = jb.ConvReluBN(6).apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x), train,
            mutable=["batch_stats"])
        with torch.no_grad():
            got = port(torch.from_numpy(x), train)
        assert _scaled(got.numpy(), np.asarray(ref)) <= 1e-5
        if train:
            assert _scaled(port.bn.running_var.numpy(),
                           np.asarray(mut["batch_stats"]["bn"]["var"])) <= 1e-5
    ref = np.asarray(jb.max_pool_2x2(jnp.asarray(x)))
    got = tb.max_pool_2x2(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 4, 3, 5)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("init_type", ["normal", "kaiming", "xavier"])
def test_init_weights_on_conv_transpose(init_type):
    """``init_weights`` re-draws a ``ConvTranspose2d`` (its bias to 0) with
    torch's fans for a transposed weight (in, out, kh, kw): fan-in out*9,
    fan-out in*9, as the JAX ``_torch_fans`` has them; the draws' std
    within 5 % of the rule's over 64 x 256 x 3 x 3 values."""
    from dahitra_tpu.nn.init import _torch_fans

    conv = torch.nn.ConvTranspose2d(64, 256, 3)
    init_weights(conv, init_type, 0.02, torch.Generator().manual_seed(1))
    fan_in, fan_out = _torch_fans((3, 3, 256, 64))  # flax (kh, kw, out, in)
    assert (fan_in, fan_out) == (256 * 9, 64 * 9)
    want = {"normal": 0.02, "kaiming": (2.0 / fan_in) ** 0.5,
            "xavier": 0.02 * (2.0 / (fan_in + fan_out)) ** 0.5}[init_type]
    assert abs(conv.weight.std().item() / want - 1) < 0.05
    assert (conv.bias == 0).all()


def test_fast_vjp_switch_sends_the_stack_to_the_layer_loop(monkeypatch):
    """TransformerDecoder(fast_vjp=False) and a decoder with dropout in
    training take the layer loop at shapes the stack would take (the stack
    is not called; its logits agree with the stack's to 1e-5); in eval, or
    at rate 0, the dropout decoder takes the stack."""
    dec = tb.TransformerDecoder(32, 2, 4, 16, 32)
    init_random(dec, torch.Generator().manual_seed(2))
    x = torch.randn(2, 256, 32, generator=torch.Generator().manual_seed(3))
    m = torch.randn(2, 4, 32, generator=torch.Generator().manual_seed(4))
    assert dec.uses_stack(256, 4, 32)
    with torch.no_grad():
        stacked = dec(x, m)
    calls = []
    monkeypatch.setattr(tb, "decoder_stack",
                        lambda *a, **k: calls.append(1) or stacked)
    dec.fast_vjp = False
    assert not dec.uses_stack(256, 4, 32)
    with torch.no_grad():
        looped = dec(x, m)
    assert not calls
    sc = stacked.abs().max()
    assert ((looped - stacked).abs().max() / sc).item() <= 1e-5
    drop = tb.TransformerDecoder(32, 2, 4, 16, 32, dropout=0.1)
    assert not drop.uses_stack(256, 4, 32, deterministic=False)
    assert drop.uses_stack(256, 4, 32)
    drop.dropout = 0.0
    assert drop.uses_stack(256, 4, 32, deterministic=False)


def test_dahitra_fast_vjp_env_is_read_at_import():
    """DAHITRA_FAST_VJP=0 in the environment at import closes the stack
    path of every decoder, as in the JAX package (blocks.py:33)."""
    code = ("from dahitra_tpu_torch.nn import blocks as b\n"
            "d = b.TransformerDecoder(32, 2, 4, 16, 32)\n"
            "print(b._FAST_VJP_DEFAULT, d.uses_stack(256, 4, 32))\n")
    env = {**os.environ, "DAHITRA_FAST_VJP": "0"}
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.split() == ["False", "False"]
