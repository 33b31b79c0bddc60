"""The port's fused decoder (K4, ``TransformerDecoder(pallas=True)``) against
the JAX package's.

``fused_decoder_plain`` (the plain PyTorch version of the K4 kernel) is held
against the Pallas ``fused_transformer_decoder`` run in interpret mode on
the CPU (``pallas_call`` patched as tests/test_pallas.py patches it);
``plain_decoder_stack`` (K4's backward rule) against its JAX original; the
module's pallas path, forward and gradients, against ``jax.grad`` of the
flax module's; the gate against the flax module's choice; and one
whole-model forward and gradient against the flax ``DAHiTraUNet`` with its
decoders built ``pallas=True``. Same seeded numpy inputs and weights through
both packages. Tolerances, scale-normalized: fp32-precise forward 1e-5 (the
same arithmetic in another summation order), bf16 operands 2e-2; module
gradients fp32 1e-4 and bf16 6e-2 (tests/test_decoder_vjp.py:27-30); the
whole model 1e-4 on the logits and 1e-3 of the gradient's scale
(tests/test_torch_dahitra.py).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import dahitra_tpu.models.dahitra as jax_dahitra
import dahitra_tpu.pallas.fused_decoder as jfd
from dahitra_tpu.core.torch_import import _convert_decoder, convert_dahitra
from dahitra_tpu.models.dahitra import DAHiTraUNet as JaxDAHiTra
from dahitra_tpu.nn.blocks import TransformerDecoder as JaxDecoder
from dahitra_tpu_torch.core.flax_import import flax_to_state_dict
from dahitra_tpu_torch.kernels import folded_decoder as fd
from dahitra_tpu_torch.kernels import fused_decoder as kd
from dahitra_tpu_torch.models.dahitra import DAHiTraUNet
from dahitra_tpu_torch.nn import blocks
from dahitra_tpu_torch.nn.blocks import TransformerDecoder

DIM = 32
TOL = {"precise": 1e-5, "bf16": 2e-2}
GTOL = {"float32": 1e-4, "bfloat16": 6e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    """Every Pallas call of the JAX fused decoder runs in interpret mode."""
    orig = pl.pallas_call
    monkeypatch.setattr(jfd.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _packed(depth, heads, dim_head=64, seed=0):
    """Seeded numpy weights in the stacked layout of pack_decoder_params."""
    rng = np.random.RandomState(seed)
    inner = heads * dim_head
    shapes = {"wq": (DIM, inner), "wk": (DIM, inner), "wv": (DIM, inner),
              "wo": (inner, DIM), "w1": (DIM, DIM), "w2": (DIM, DIM)}
    p = {k: rng.normal(0, s[0] ** -0.5, (depth, *s)) for k, s in shapes.items()}
    for k in ("ln1_scale", "ln2_scale"):
        p[k] = 1.0 + 0.2 * rng.normal(size=(depth, DIM))
    for k in ("ln1_bias", "ln2_bias", "bo", "b1", "b2"):
        p[k] = 0.2 * rng.normal(size=(depth, DIM))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _inputs(b, n, l=4, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(b, n, DIM)).astype(np.float32),
            rng.normal(size=(b, l, DIM)).astype(np.float32))


def _close(got, ref, tol):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    sc = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(got / sc, ref / sc, rtol=tol, atol=tol)


# (x dtype, precise): the fp32 model, the bf16 model (its decoder input is
# fp32 after the positional add) and bf16 I/O (tests/test_pallas.py:48-72).
K4_MODES = {"f32_precise": ("float32", True), "f32_bf16ops": ("float32", False),
            "bf16_io": ("bfloat16", False)}


@pytest.mark.parametrize("mode", list(K4_MODES))
def test_plain_matches_pallas_k4_interpret(mode):
    dname, precise = K4_MODES[mode]
    tdt, jdt = DTYPES[dname]
    depth, heads = 2, 8
    packed = _packed(depth, heads)
    x, m = _inputs(2, 128)
    ref = jfd.fused_transformer_decoder(
        jnp.asarray(x, jdt), jnp.asarray(m, jdt),
        {k: jnp.asarray(v) for k, v in packed.items()}, depth=depth,
        heads=heads, tile=128, precise=precise)
    got = kd.fused_transformer_decoder(
        torch.from_numpy(x).to(tdt), torch.from_numpy(m).to(tdt),
        {k: torch.from_numpy(v) for k, v in packed.items()}, depth, heads,
        precise)
    assert got.dtype == tdt and ref.dtype == jdt
    _close(got, ref, TOL["precise" if precise else "bf16"])
    assert kd.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("xname,dname", [("float32", "float32"),
                                         ("bfloat16", "bfloat16"),
                                         ("float32", "bfloat16")])
def test_plain_decoder_stack_matches_jax(xname, dname):
    """K4's backward rule, forward values: fp32, bf16, and the bf16 model's
    fp32 input (the residual stays fp32 by type promotion)."""
    (txdt, jxdt), (tdt, jdt) = DTYPES[xname], DTYPES[dname]
    depth, heads = 3, 4
    packed = _packed(depth, heads, seed=2)
    x, m = _inputs(2, 64, seed=3)
    ref = jfd.plain_decoder_stack(jnp.asarray(x, jxdt), jnp.asarray(m, jxdt),
                                  {k: jnp.asarray(v) for k, v in packed.items()},
                                  depth, heads, jdt)
    got = kd.plain_decoder_stack(torch.from_numpy(x).to(txdt),
                                 torch.from_numpy(m).to(txdt),
                                 {k: torch.from_numpy(v)
                                  for k, v in packed.items()},
                                 depth, heads, tdt)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    _close(got, ref, TOL["precise" if dname == "float32" else "bf16"])


def _port_and_flax(depth, heads, dim_head, seed, **kw):
    """A port TransformerDecoder with seeded weights and the same weights as
    a flax param tree."""
    port = TransformerDecoder(DIM, depth, heads, dim_head, DIM, **kw)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in port.parameters():
            p.add_(torch.from_numpy(
                rng.normal(0, 0.1, p.shape).astype(np.float32)))
    sd = {f"d.{k}": v.numpy() for k, v in port.state_dict().items()}
    params = {}
    _convert_decoder(sd, "d", depth, params, ())
    return port, params


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_module_pallas_grads_match_flax(dname):
    """TransformerDecoder(pallas=True): forward and the gradients of x, m and
    every parameter against jax.grad of the flax module's pallas path (the
    Pallas K4 forward in interpret mode, the plain-stack backward). Inputs
    are fp32 in both dtypes, as in DAHiTra."""
    tdt, jdt = DTYPES[dname]
    depth, heads = 2, 8
    port, params = _port_and_flax(depth, heads, 64, 4, dtype=tdt, pallas=True)
    x, m = _inputs(2, 128, seed=5)
    dy = np.random.RandomState(6).normal(size=x.shape).astype(np.float32)
    flax_dec = JaxDecoder(DIM, depth, heads, 64, DIM, pallas=True, dtype=jdt)

    def loss(p, x_, m_):
        y = flax_dec.apply({"params": p}, x_, m_)
        return jnp.sum(y.astype(jnp.float32) * dy), y

    (_, ref_y), (rp, rx, rm) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(x),
                                               jnp.asarray(m))
    xt = torch.from_numpy(x).requires_grad_()
    mt = torch.from_numpy(m).requires_grad_()
    y = port(xt, mt)
    assert y.dtype == torch.float32
    (y * torch.from_numpy(dy)).sum().backward()
    _close(y, ref_y, 1e-4 if dname == "float32" else TOL["bf16"])
    _close(xt.grad, rx, GTOL[dname])
    _close(mt.grad, rm, GTOL[dname])
    grads = {f"d.{k}": p.grad.numpy() for k, p in port.named_parameters()}
    got = {}
    _convert_decoder(grads, "d", depth, got, ())
    flat_ref = jax.tree_util.tree_flatten_with_path(rp)[0]
    assert len(flat_ref) == len(grads) == 13 * depth
    for path, r in flat_ref:
        g = got
        for key in path:
            g = g[key.key]
        _close(torch.from_numpy(np.asarray(g)), r, GTOL[dname])


# name -> (n, tokens, heads, softmax, pallas)
GATE_CASES = {"fused": (128, 4, 8, True, True),
              "n_untileable": (100, 4, 8, True, True),
              "no_softmax": (128, 4, 8, False, True),
              "hl_136": (128, 17, 8, True, True),
              "pallas_none": (128, 4, 8, True, None),
              "pallas_false": (128, 4, 8, True, False)}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_matches_flax(case, monkeypatch):
    """The port takes K4 exactly where the flax module calls
    make_fused_decoder (recorded by a stand-in that computes the plain
    stack), and then never the K1 path; the outputs agree on both sides of
    the gate."""
    n, l, heads, softmax, pallas = GATE_CASES[case]
    chose = []

    def record(depth_, heads_, tile, dtype):
        chose.append(tile)
        return lambda x_, m_, p_: jfd.plain_decoder_stack(x_, m_, p_, depth_,
                                                          heads_, dtype)

    monkeypatch.setattr(jfd, "make_fused_decoder", record)
    depth = 2
    port, params = _port_and_flax(depth, heads, 16, 7, softmax=softmax,
                                  pallas=pallas)
    x, m = _inputs(2, n, l, seed=8)
    ref = JaxDecoder(DIM, depth, heads, 16, DIM, softmax=softmax,
                     pallas=pallas).apply({"params": params}, jnp.asarray(x),
                                          jnp.asarray(m))
    fused = port.uses_fused(n, l, DIM)
    assert fused == bool(chose) == (case == "fused")
    if fused:
        def refuse(*a, **k):
            raise AssertionError("K1 path taken behind the K4 gate")
        monkeypatch.setattr(blocks, "decoder_stack", refuse)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(m))
    _close(got, ref, 1e-4)


def test_cpu_wrapper_counts_nothing_and_raises_off_cpu():
    """On CPU tensors the wrapper runs the plain version and counts nothing;
    a tensor on a device with no kernel never takes the plain version."""
    packed = {k: torch.from_numpy(v) for k, v in _packed(2, 4, seed=9).items()}
    x, m = (torch.from_numpy(t) for t in _inputs(2, 64, seed=10))
    got = kd.fused_transformer_decoder(x, m, packed, 2, 4, True)
    torch.testing.assert_close(
        got, kd.fused_decoder_plain(x, m, packed, 2, 4, True), rtol=0, atol=0)
    assert kd.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        kd.fused_transformer_decoder(x.to("meta"), m.to("meta"),
                                     {k: v.to("meta")
                                      for k, v in packed.items()}, 2, 4, True)


def test_divergent_head_stays_finite():
    """The per-group max shift keeps a head whose logits sit far below
    another's finite (no clamp, unlike K1)."""
    packed = _packed(2, 2, seed=11)
    packed["wq"][:, :, :64] *= 2000.0
    x, m = _inputs(2, 64, seed=12)
    got = kd.fused_decoder_plain(torch.from_numpy(x), torch.from_numpy(m),
                                 {k: torch.from_numpy(v)
                                  for k, v in packed.items()}, 2, 2, True)
    assert torch.isfinite(got).all()


IMG = 64


def test_whole_model_pallas_matches_flax(monkeypatch):
    """newUNetTrans at 64 px, batch 2, fp32, with every decoder set
    pallas=True, against the flax DAHiTraUNet whose decoders are built
    pallas=True (a test-side patch of the class the model module reads).
    At 64 px the 1/4-scale decoders (n = 256) take K4 on both sides; the
    1/8 (n = 64) and 1/16 (n = 16) ones fail pick_tile and fall through.
    Eval-mode logits to 1e-4; the gradient of sum(logits * dy) over every
    parameter to 1e-3 of the whole gradient's scale."""
    monkeypatch.setattr(jax_dahitra, "TransformerDecoder",
                        functools.partial(JaxDecoder, pallas=True))
    rng = np.random.RandomState(13)
    port = DAHiTraUNet(img_size=IMG).eval()
    port.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith("bias"):
                p.add_(torch.from_numpy(
                    0.1 * rng.normal(size=p.shape).astype(np.float32)))
    params, stats = convert_dahitra(
        {k: v.numpy() for k, v in port.state_dict().items()})
    x1, x2 = (rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
              for _ in range(2))
    dy = rng.normal(size=(2, IMG, IMG, 2)).astype(np.float32)
    model = JaxDAHiTra(img_size=IMG)

    def loss(p):
        y = model.apply({"params": p, "batch_stats": stats}, x1, x2, False)
        return jnp.sum(y * dy), y

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    decoders = [mod for mod in port.modules()
                if isinstance(mod, TransformerDecoder)]
    assert len(decoders) == 3
    for dec in decoders:
        dec.pallas = True
    calls = []
    monkeypatch.setattr(kd, "fused_transformer_decoder",
                        lambda *a: calls.append(1) or kd.fused_decoder_plain(*a))
    got = port(torch.from_numpy(x1), torch.from_numpy(x2))
    assert len(calls) == 2  # the dates and the difference decode at 1/4
    _close(got, ref, 1e-4)
    (got * torch.from_numpy(dy)).sum().backward()
    named = dict(port.named_parameters())
    want = flax_to_state_dict(jax.tree.map(np.asarray, ref_grads), stats)
    scale = max(np.abs(want[k].numpy()).max() for k in named)
    worst = max(np.abs(named[k].grad.numpy() - want[k].numpy()).max()
                for k in named)
    assert worst <= 1e-3 * scale, worst / scale
    assert fd.launches == fd.launches_save == fd.launches_bwd == 0
