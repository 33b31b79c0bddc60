"""What K4's kernels (csrc/fused_decoder.cu) rely on, held on the CPU against
the JAX package's Pallas K4 (``fused_transformer_decoder``, run in interpret
mode as tests/test_torch_fused_decoder.py runs it).

* The row kernel pads hl up to a multiple of 16 with zero columns of A and
  zero rows of Z. Since hl is a multiple of the l tokens per head and l
  divides 16, the padding is whole heads: each padded head's logits are 0,
  so its max-shifted softmax is 1 / l inside its own group and meets only
  zero rows of Z. So ``fused_decoder_plain`` with zero heads appended (zero
  columns of wq, wk, wv and zero rows of wo) gives the unpadded JAX kernel's
  output, odd hl included.
* The kernels take 1, 2, 4, 8 and 16 tokens per head: the plain version
  against JAX at each.
* The row kernel's mlp_dim-64 instance (BIT's decoder): the plain version
  at mlp_dim 64 against JAX.
* ``fused_decoder_az_plain`` (the prologue's function) against A and Z
  written out with jnp as the TPU kernel's body builds them.

Same seeded numpy inputs through both packages. Tolerances, scale-normalized:
``precise`` 1e-5 (the same arithmetic in another summation order), bf16
operands 2e-2.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import dahitra_tpu.pallas.fused_decoder as jfd
from dahitra_tpu_torch.kernels import fused_decoder as kd

DIM = 32
TOL = {True: 1e-5, False: 2e-2}
MODES = {"precise": True, "bf16ops": False}


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    """Every Pallas call of the JAX fused decoder runs in interpret mode."""
    orig = pl.pallas_call
    monkeypatch.setattr(jfd.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _packed(depth, heads, dim_head, seed, mlp=DIM):
    """Seeded numpy weights in the stacked layout of pack_decoder_params,
    with a hidden width of ``mlp``."""
    rng = np.random.RandomState(seed)
    inner = heads * dim_head
    shapes = {"wq": (DIM, inner), "wk": (DIM, inner), "wv": (DIM, inner),
              "wo": (inner, DIM), "w1": (DIM, mlp), "w2": (mlp, DIM)}
    p = {k: rng.normal(0, s[0] ** -0.5, (depth, *s)) for k, s in shapes.items()}
    for k in ("ln1_scale", "ln2_scale"):
        p[k] = 1.0 + 0.2 * rng.normal(size=(depth, DIM))
    for k in ("ln1_bias", "ln2_bias", "bo", "b1", "b2"):
        p[k] = 0.2 * rng.normal(size=(depth, mlp if k == "b1" else DIM))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _inputs(b, n, l, seed):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(b, n, DIM)).astype(np.float32),
            rng.normal(size=(b, l, DIM)).astype(np.float32))


def _close(got, ref, tol):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    sc = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(got / sc, ref / sc, rtol=0, atol=tol)


def _jax_k4(x, m, packed, depth, heads, precise):
    return jfd.fused_transformer_decoder(
        jnp.asarray(x), jnp.asarray(m),
        {k: jnp.asarray(v) for k, v in packed.items()}, depth=depth,
        heads=heads, tile=x.shape[1], precise=precise)


def _torch(packed):
    return {k: torch.from_numpy(v) for k, v in packed.items()}


def _zero_heads(packed, extra, dim_head):
    """``extra`` zero heads appended: zero columns of wq, wk, wv and zero
    rows of wo."""
    out = dict(packed)
    for k in ("wq", "wk", "wv"):
        v = packed[k]
        out[k] = np.concatenate(
            [v, np.zeros((*v.shape[:-1], extra * dim_head), v.dtype)], -1)
    wo = packed["wo"]
    out["wo"] = np.concatenate(
        [wo, np.zeros((wo.shape[0], extra * dim_head, DIM), wo.dtype)], 1)
    return out


# name -> (heads, tokens per head): hl 8, 24 and 40, and an odd hl of 3.
PAD_CASES = {"hl8": (2, 4), "hl24": (6, 4), "hl40": (10, 4), "hl3_l1": (3, 1)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(PAD_CASES))
def test_zero_heads_padding_keeps_the_output(case, mode):
    """Depth 2, N 128, dim_head 16: the plain version over the operands
    padded to hl a multiple of 16 equals the unpadded JAX kernel; the padded
    heads' columns of A and rows of Z are zero."""
    heads, l = PAD_CASES[case]
    precise = MODES[mode]
    depth, dim_head = 2, 16
    hl = heads * l
    extra = (-hl % 16) // l
    packed = _packed(depth, heads, dim_head, seed=hl)
    x, m = _inputs(2, 128, l, seed=hl + 1)
    ref = _jax_k4(x, m, packed, depth, heads, precise)

    padded = _torch(_zero_heads(packed, extra, dim_head))
    hp = heads + extra
    assert (hp * l) % 16 == 0 and hp * l - hl < 16
    got = kd.fused_decoder_plain(torch.from_numpy(x), torch.from_numpy(m),
                                 padded, depth, hp, precise)
    _close(got, ref, TOL[precise])
    a, z = kd.fused_decoder_az_plain(torch.from_numpy(m), padded, depth, hp,
                                     precise)
    assert not a[..., hl:].any() and not z[:, :, hl:].any()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("l", [1, 2, 8, 16])
def test_token_counts_match_jax(l, mode):
    """Tokens per head beside DAHiTra's 4: depth 2, 4 heads, N 128."""
    precise = MODES[mode]
    depth, heads = 2, 4
    packed = _packed(depth, heads, 32, seed=20 + l)
    x, m = _inputs(2, 128, l, seed=30 + l)
    ref = _jax_k4(x, m, packed, depth, heads, precise)
    got = kd.fused_decoder_plain(torch.from_numpy(x), torch.from_numpy(m),
                                 _torch(packed), depth, heads, precise)
    _close(got, ref, TOL[precise])


@pytest.mark.parametrize("mode", list(MODES))
def test_wide_mlp_matches_jax(mode):
    """mlp_dim 64 (BIT's decoder: W1 (32, 64), b1 (64,), W2 (64, 32)) at
    depth 2, 8 heads of 4 tokens (hl 32), dim_head 64, N 128."""
    precise = MODES[mode]
    depth, heads = 2, 8
    packed = _packed(depth, heads, 64, seed=60, mlp=64)
    x, m = _inputs(2, 128, 4, seed=61)
    ref = _jax_k4(x, m, packed, depth, heads, precise)
    got = kd.fused_decoder_plain(torch.from_numpy(x), torch.from_numpy(m),
                                 _torch(packed), depth, heads, precise)
    _close(got, ref, TOL[precise])
    assert kd.launches == 0  # CPU tensors never reach the kernel


def _jnp_az(m, packed, depth, heads, precise):
    """A (D, B, 32, hl) and Z (D, B, hl, 32) as the TPU kernel's body builds
    them (fused_decoder.py:136-148), one sample at a time."""
    mm = jfd._make_mm(precise)
    p = {k: jnp.asarray(v) for k, v in packed.items()}
    hd = p["wq"].shape[-1] // heads
    a_d, z_d = [], []
    for d in range(depth):
        a_b, z_b = [], []
        for mb in jnp.asarray(m):
            mn = jfd._layer_norm(mb, p["ln1_scale"][d], p["ln1_bias"][d])
            k, v = mm(mn, p["wk"][d]), mm(mn, p["wv"][d])
            sl = [slice(h * hd, (h + 1) * hd) for h in range(heads)]
            a_b.append(jnp.concatenate(
                [mm(p["wq"][d][:, s], k[:, s].T) for s in sl], axis=1))
            z_b.append(jnp.concatenate(
                [mm(v[:, s], p["wo"][d][s, :]) for s in sl], axis=0))
        a_d.append(jnp.stack(a_b))
        z_d.append(jnp.stack(z_b))
    return jnp.stack(a_d), jnp.stack(z_d)


# name -> (heads, tokens per head, dim_head)
AZ_CASES = {"dahitra": (8, 4, 64), "odd_hl": (3, 1, 16), "l16": (2, 16, 32)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(AZ_CASES))
def test_az_plain_matches_jnp(case, mode):
    heads, l, dim_head = AZ_CASES[case]
    precise = MODES[mode]
    depth = 2
    packed = _packed(depth, heads, dim_head, seed=40 + l)
    _, m = _inputs(3, 1, l, seed=50 + l)
    ref_a, ref_z = _jnp_az(m, packed, depth, heads, precise)
    a, z = kd.fused_decoder_az_plain(torch.from_numpy(m), _torch(packed),
                                     depth, heads, precise)
    assert a.dtype == z.dtype == torch.float32
    _close(a, ref_a, TOL[precise])
    _close(z, ref_z, TOL[precise])
    assert kd.fused_decoder_az(torch.from_numpy(m), _torch(packed), depth,
                               heads, precise)[0].equal(a)
    assert kd.launches_az == 0  # CPU tensors never reach the kernel
