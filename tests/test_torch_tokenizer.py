"""The port's semantic tokenizer (plain version of the K3 kernel) against the
flax ``SemanticTokenizer`` and the Pallas K3 kernel ``fused_semantic_tokenizer``
(interpret mode, as tests/test_pallas.py:129-132 runs it).

Its gradient (``SemanticTokenizerFn``: the K3 forward, a PyTorch-ops
backward) is held against ``jax.vjp`` of the flax module.

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
