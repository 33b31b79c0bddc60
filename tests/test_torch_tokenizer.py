"""The port's semantic tokenizer (plain version of the K3 kernel) against the
flax ``SemanticTokenizer`` and the Pallas K3 kernel ``fused_semantic_tokenizer``
(interpret mode, as tests/test_pallas.py:129-132 runs it).

Its gradient (``SemanticTokenizerFn``: the K3 forward, a PyTorch-ops
backward) is held against ``jax.vjp`` of the flax module.

The CUDA kernel splits the N pixels into chunks and combines per-chunk
softmax statistics; ``semantic_tokenizer_split_plain`` is that algorithm in
PyTorch, held here against the plain version and the flax module. The
port's ``SemanticTokenizer`` module is held against the flax module at the
1/4-scale sizes of 512 and 1024 px images (N = 16384, 65536).

Tolerances, scale-normalized: fp32 1e-5; bf16 2e-2 (logits, attention and
tokens each rounded to bf16, in a different summation order); gradients
fp32 1e-4 and bf16 6e-2 (tests/test_decoder_vjp.py:27-30).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dahitra_tpu.pallas.fused_tokenizer as jft
from dahitra_tpu.nn.blocks import SemanticTokenizer as JaxTokenizer
from dahitra_tpu_torch.kernels import fused_tokenizer as ft
from dahitra_tpu_torch.nn.blocks import SemanticTokenizer

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GTOL = {"float32": 1e-4, "bfloat16": 6e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(b=2, n=256, c=32, l=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(b, n, c)).astype(np.float32),
            (rng.normal(size=(c, l)) * c ** -0.5).astype(np.float32))


def _close(got, ref, tol):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    sc = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(got / sc, ref / sc, rtol=tol, atol=tol)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_plain_matches_flax_module(dname):
    tdt, jdt = DTYPES[dname]
    x, w = _inputs(n=16 * 16)
    ref = JaxTokenizer(4, dtype=jdt).apply(
        {"params": {"conv_token": {"kernel": w.reshape(1, 1, 32, 4)}}},
        jnp.asarray(x, jdt).reshape(2, 16, 16, 32))
    got = ft.semantic_tokenizer_plain(torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt
    _close(got, ref, TOL[dname])


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_plain_matches_pallas_k3_interpret(dname, monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jft.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    tdt, jdt = DTYPES[dname]
    x, w = _inputs(n=512, seed=1)
    ref = jft.fused_semantic_tokenizer(jnp.asarray(x, jdt), jnp.asarray(w),
                                       precise=dname == "float32")
    got = ft.semantic_tokenizer_plain(torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(w).to(tdt))
    _close(got, ref, TOL[dname])


def test_cpu_wrapper_is_plain_and_counts_nothing():
    x, w = (torch.from_numpy(t) for t in _inputs(seed=2))
    before = ft.launches
    got = ft.semantic_tokenizer(x, w)
    assert ft.launches == before == 0
    torch.testing.assert_close(got, ft.semantic_tokenizer_plain(x, w),
                               rtol=0, atol=0)


def test_wrapper_raises_off_cpu_without_kernel():
    x, w = (torch.from_numpy(t).to("meta") for t in _inputs(seed=3))
    with pytest.raises(ValueError):
        ft.semantic_tokenizer(x, w)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_gradient_matches_flax_vjp(dname):
    """dx and dw of SemanticTokenizerFn against jax.vjp of the flax
    SemanticTokenizer (XLA's autodiff, which the JAX package relies on)."""
    tdt, jdt = DTYPES[dname]
    x, w = _inputs(n=16 * 16, seed=4)
    dt = np.random.RandomState(5).normal(size=(2, 4, 32)).astype(np.float32)
    mod = JaxTokenizer(4, dtype=jdt)
    ref, vjp = jax.vjp(
        lambda x_, k_: mod.apply({"params": {"conv_token": {"kernel": k_}}},
                                 x_),
        jnp.asarray(x, jdt).reshape(2, 16, 16, 32),
        jnp.asarray(w.reshape(1, 1, 32, 4)))
    rdx, rdk = vjp(jnp.asarray(dt, ref.dtype))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    got = ft.SemanticTokenizerFn.apply(xt, wt)
    _close(got.detach(), ref, TOL[dname])
    dx, dw = torch.autograd.grad(got, (xt, wt), torch.from_numpy(dt).to(tdt))
    _close(dx, np.asarray(rdx, np.float32).reshape(2, 256, 32), GTOL[dname])
    _close(dw, np.asarray(rdk, np.float32).reshape(32, 4), GTOL[dname])


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("l", [1, 4, 16])
@pytest.mark.parametrize("n,chunk", [(1024, 256), (1024, 128), (1000, 256),
                                     (64, 128)])
def test_split_plain_matches_plain(n, chunk, l, dname):
    """Chunks that divide N, chunks that do not (a short last chunk) and one
    chunk larger than N."""
    tdt, _ = DTYPES[dname]
    x, w = (torch.from_numpy(t).to(tdt) for t in _inputs(3, n, l=l, seed=6))
    got = ft.semantic_tokenizer_split_plain(x, w, chunk)
    assert got.dtype == tdt and got.shape == (3, l, 32)
    _close(got, ft.semantic_tokenizer_plain(x, w).float().numpy(), TOL[dname])


def test_split_plain_combines_chunks_of_very_different_maxima():
    """One chunk's logits dwarf the others': the combine rescales the small
    chunks' sums to nothing without a NaN."""
    x, w = (torch.from_numpy(t) for t in _inputs(2, 512, seed=7))
    x[:, 300:310] *= 40.0
    got = ft.semantic_tokenizer_split_plain(x, w, 128)
    assert torch.isfinite(got).all()
    _close(got, ft.semantic_tokenizer_plain(x, w).numpy(), TOL["float32"])


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_split_plain_matches_flax_module(dname):
    tdt, jdt = DTYPES[dname]
    x, w = _inputs(n=1000, seed=8)
    ref = JaxTokenizer(4, dtype=jdt).apply(
        {"params": {"conv_token": {"kernel": w.reshape(1, 1, 32, 4)}}},
        jnp.asarray(x, jdt).reshape(2, 25, 40, 32))
    got = ft.semantic_tokenizer_split_plain(torch.from_numpy(x).to(tdt),
                                            torch.from_numpy(w).to(tdt), 256)
    _close(got, ref, TOL[dname])


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", [128, 256])
def test_module_matches_flax_at_large_n(side, dname):
    """The port's module at N = 16384 and 65536 (the 1/4-scale maps of 512
    and 1024 px images), which the card's first kernel refused."""
    tdt, jdt = DTYPES[dname]
    x, w = _inputs(n=side * side, seed=9)
    ref = JaxTokenizer(4, dtype=jdt).apply(
        {"params": {"conv_token": {"kernel": w.reshape(1, 1, 32, 4)}}},
        jnp.asarray(x, jdt).reshape(2, side, side, 32))
    mod = SemanticTokenizer(32, 4, dtype=tdt)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w.T.copy()).view(4, 32, 1, 1))
        got = mod(torch.from_numpy(x).view(2, side, side, 32))
    assert got.dtype == tdt
    _close(got, ref, TOL[dname])


@pytest.mark.parametrize("n", [12544, 16384, 65536, 100000])
def test_wrapper_refuses_no_n(n):
    """No size limit: the first kernel kept a sample's N * L logits in one
    CTA's shared memory and the wrapper raised above 220 KB (N = 14080 at
    L = 4). The wrapper takes every N, and the launch geometry keeps its
    chunk a whole number of tiles with a grid that covers a 132-SM card about
    twice."""
    x, w = (torch.from_numpy(t) for t in _inputs(1, n, seed=10))
    got = ft.semantic_tokenizer(x, w)
    assert got.shape == (1, 4, 32) and torch.isfinite(got).all()
    assert not hasattr(ft, "_SMEM_LIMIT")
    for b in (1, 4, 16):
        chunk = ft._chunk(b, n, 132)
        ctas = b * -(-n // chunk)
        assert chunk % ft._TILE == 0 and chunk >= ft._TILE
        assert ctas <= 2 * 132 + b and (ctas >= 132 or chunk == ft._TILE)
