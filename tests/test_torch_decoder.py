"""The port's decoder stack against the JAX package's.

``decoder_stack_plain`` (the plain PyTorch version of the K1 kernel) is held
against ``decoder_vjp.decoder_stack`` and, in bf16, against the Pallas K1
kernel ``folded_decoder_fwd`` run in interpret mode. The gradients of
``decoder_stack`` (the autograd Function whose forward is K1 with saves and
whose backward is K2, here their plain versions) are held against
``jax.vjp`` of ``decoder_vjp.decoder_stack`` and, in bf16, of
``folded_decoder_stack`` with the Pallas K1 and K2 in interpret mode. Same
seeded numpy inputs and packed weights through both packages. Tolerances
are those of tests/test_decoder_vjp.py:27-30, scale-normalized: forward
fp32 1e-5 and bf16 2e-2, gradients fp32 1e-4 and bf16 6e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahitra_tpu.core.torch_import import _convert_decoder
from dahitra_tpu.nn.blocks import TransformerDecoder as JaxDecoder
from dahitra_tpu.nn.decoder_vjp import decoder_stack as jax_decoder_stack
from dahitra_tpu.pallas.folded_decoder import build_az as jax_build_az
from dahitra_tpu.pallas import folded_decoder as jfd
from dahitra_tpu.pallas.folded_decoder import folded_decoder_fwd
from dahitra_tpu_torch.kernels import folded_decoder as fd
from dahitra_tpu_torch.nn.blocks import TransformerDecoder
from dahitra_tpu_torch.nn.decoder_vjp import (_operands, build_az,
                                              decoder_stack,
                                              decoder_stack_plain)

DIM = 32
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GTOL = {"float32": 1e-4, "bfloat16": 6e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


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


def _to_torch(packed):
    return {k: torch.from_numpy(v) for k, v in packed.items()}


def _close(got, ref, tol):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    sc = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(got / sc, ref / sc, rtol=tol, atol=tol)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth,heads", [(2, 4), (8, 8)])
def test_plain_matches_decoder_vjp(depth, heads, dname):
    tdt, jdt = DTYPES[dname]
    packed = _packed(depth, heads)
    x, m = _inputs(2, 256)
    ref = jax_decoder_stack(jnp.asarray(x, jdt), jnp.asarray(m, jdt),
                            {k: jnp.asarray(v) for k, v in packed.items()},
                            depth, heads, jdt)
    got = decoder_stack_plain(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(m).to(tdt), _to_torch(packed),
                              depth, heads, tdt)
    assert got.dtype == tdt
    _close(got, ref, TOL[dname])


@pytest.mark.parametrize("depth,heads", [(2, 4), (8, 8)])
def test_plain_matches_pallas_k1_interpret(depth, heads):
    """The Pallas K1 forward (bf16 only) in interpret mode on the CPU."""
    packed = _packed(depth, heads, seed=2)
    x, m = _inputs(2, 256, seed=3)
    ref, _ = folded_decoder_fwd(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(m, jnp.bfloat16),
                                {k: jnp.asarray(v) for k, v in packed.items()},
                                depth, heads, interpret=True)
    got = decoder_stack_plain(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(m).bfloat16(),
                              _to_torch(packed), depth, heads, torch.bfloat16)
    _close(got, ref, TOL["bfloat16"])


def test_build_az_matches_jax():
    packed = _packed(3, 4, seed=4)
    _, m = _inputs(2, 8, seed=5)
    ra, rz = jax_build_az(jnp.asarray(m), {k: jnp.asarray(v) for k, v in
                                          packed.items()}, 3, 4, jnp.float32)
    a, z = build_az(torch.from_numpy(m), _to_torch(packed), 3, 4,
                    torch.float32)
    _close(a, ra, 1e-6)
    _close(z, rz, 1e-6)


def test_cpu_wrapper_is_plain_and_counts_nothing():
    """On CPU tensors the K1 wrapper runs the plain version and its launch
    counter stays 0."""
    packed = _to_torch(_packed(2, 4, seed=6))
    x, m = (torch.from_numpy(t) for t in _inputs(2, 64, seed=7))
    before = fd.launches
    got = decoder_stack(x, m, packed, 2, 4, torch.float32)
    assert fd.launches == before == 0
    torch.testing.assert_close(
        got, decoder_stack_plain(x, m, packed, 2, 4, torch.float32),
        rtol=0, atol=0)


def test_wrapper_raises_off_cpu_without_kernel():
    """A tensor that is not on the CPU never takes the plain version: on a
    device with no kernel the wrapper raises."""
    packed = _to_torch(_packed(2, 4, seed=8))
    x, m = _inputs(2, 64, seed=9)
    ops = [t.to("meta") for t in _operands(torch.from_numpy(x),
                                            torch.from_numpy(m), packed, 2, 4,
                                            torch.float32)]
    with pytest.raises(ValueError, match="CUDA"):
        fd.decoder_stack_fwd(*ops, 2, 4, torch.float32)


def test_divergent_logits_stay_finite():
    """The +-80 clamp keeps a head whose logits dwarf the others finite."""
    packed = _packed(2, 2, seed=10)
    packed["wq"] = packed["wq"] * 2000.0
    x, m = _inputs(2, 64, seed=11)
    got = decoder_stack_plain(torch.from_numpy(x), torch.from_numpy(m),
                              _to_torch(packed), 2, 2, torch.float32)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("n", [16, 64])
def test_module_gate_matches_flax(n):
    """The TransformerDecoder dispatch: n <= 4 * n_kv runs layer by layer
    with the max-shifted softmax, n > 4 * n_kv the decoder stack; each
    matches the flax module, which gates the same way (blocks.py:596-602)."""
    depth, heads = 3, 4
    port = TransformerDecoder(DIM, depth, heads, 16, DIM)
    rng = np.random.RandomState(12)
    with torch.no_grad():
        for p in port.parameters():
            p.add_(torch.from_numpy(
                rng.normal(0, 0.1, p.shape).astype(np.float32)))
    assert port.uses_stack(n, 4, DIM) == (n > 16)
    sd = {f"d.{k}": v.numpy() for k, v in port.state_dict().items()}
    params = {}
    _convert_decoder(sd, "d", depth, params, ())
    x, m = _inputs(2, n, seed=13)
    ref = JaxDecoder(DIM, depth, heads, 16, DIM).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(m))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(m))
    _close(got, ref, TOL["float32"])


def _port_vjp(x, m, packed, dy, depth, heads, tdt):
    """(y, dx, dm, {key: dparam}) of the port's decoder_stack."""
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    mt = torch.from_numpy(m).to(tdt).requires_grad_()
    pt = {k: v.requires_grad_() for k, v in _to_torch(packed).items()}
    y = decoder_stack(xt, mt, pt, depth, heads, tdt)
    grads = torch.autograd.grad(y, [xt, mt, *pt.values()],
                                torch.from_numpy(dy).to(tdt))
    return y.detach(), grads[0], grads[1], dict(zip(pt, grads[2:]))


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth,heads", [(2, 4), (8, 8)])
def test_stack_grads_match_decoder_vjp(depth, heads, dname):
    """dx, dm and all 13 packed gradients against jax.vjp of the JAX
    package's hand-written VJP."""
    tdt, jdt = DTYPES[dname]
    packed = _packed(depth, heads, seed=14)
    x, m = _inputs(2, 64, seed=15)
    dy = np.random.RandomState(16).normal(size=x.shape).astype(np.float32)
    ref_y, vjp = jax.vjp(
        lambda x_, m_, p_: jax_decoder_stack(x_, m_, p_, depth, heads, jdt),
        jnp.asarray(x, jdt), jnp.asarray(m, jdt),
        {k: jnp.asarray(v) for k, v in packed.items()})
    rdx, rdm, rdp = vjp(jnp.asarray(dy, jdt))
    y, dx, dm, dp = _port_vjp(x, m, packed, dy, depth, heads, tdt)
    _close(y, ref_y, TOL[dname])
    _close(dx, rdx, GTOL[dname])
    _close(dm, rdm, GTOL[dname])
    assert set(dp) == set(rdp) and len(dp) == 13
    for k in dp:
        _close(dp[k], rdp[k], GTOL[dname])


@pytest.mark.parametrize("depth,heads", [(2, 4), (8, 8)])
def test_stack_grads_match_pallas_k2_interpret(depth, heads, monkeypatch):
    """bf16 against jax.vjp of folded_decoder_stack: K1 with saves and the
    Pallas K2 run in interpret mode on the CPU."""
    monkeypatch.setattr(jfd, "_INTERPRET", True)
    packed = _packed(depth, heads, seed=17)
    x, m = _inputs(2, 64, seed=18)
    dy = np.random.RandomState(19).normal(size=x.shape).astype(np.float32)
    ref_y, vjp = jax.vjp(
        lambda x_, m_, p_: jfd.folded_decoder_stack(x_, m_, p_, depth, heads),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(m, jnp.bfloat16),
        {k: jnp.asarray(v) for k, v in packed.items()})
    rdx, rdm, rdp = vjp(jnp.asarray(dy, jnp.bfloat16))
    y, dx, dm, dp = _port_vjp(x, m, packed, dy, depth, heads, torch.bfloat16)
    _close(y, ref_y, TOL["bfloat16"])
    for got, ref in ((dx, rdx), (dm, rdm), *((dp[k], rdp[k]) for k in dp)):
        _close(got, ref, GTOL["bfloat16"])


def test_plain_backward_is_the_forward_gradient_in_float64():
    """In float64 (no rounding) the plain K2 is the exact gradient of the
    plain K1 with saves: torch autograd through decoder_stack_fwd_plain."""
    depth, heads = 3, 4
    rng = np.random.RandomState(20)
    hl = 4 * heads

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(shift + scale * rng.normal(size=shape)
                                ).requires_grad_()

    x, a, z = t(2, 48, DIM), t(depth, 2, DIM, hl, scale=0.3), \
        t(depth, 2, hl, DIM, scale=0.3)
    w1, w2 = t(depth, DIM, DIM, scale=0.2), t(depth, DIM, DIM, scale=0.2)
    vecs = t(depth, 7, DIM, scale=0.3)
    ops = (x, a, z, w1, w2, vecs)
    y, xs, ats = fd.decoder_stack_fwd_plain(*ops, depth, heads, torch.float64,
                                            save=True)
    dy = torch.from_numpy(rng.normal(size=y.shape))
    ref = torch.autograd.grad(y, ops, dy)
    got = fd.decoder_stack_bwd_plain(xs.detach(), ats.detach(), dy,
                                     *(o.detach() for o in ops[1:]), depth,
                                     heads, torch.float64)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-10)


def test_save_forward_returns_the_kernel_saves():
    """The plain K1 with saves: the same y, each layer's input and its
    attention rows (summing to 1 over each head's tokens)."""
    packed = _to_torch(_packed(3, 4, seed=21))
    x, m = (torch.from_numpy(t) for t in _inputs(2, 64, seed=22))
    ops = _operands(x, m, packed, 3, 4, torch.float32)
    y, xs, ats = fd.decoder_stack_fwd(*ops, 3, 4, torch.float32, save=True)
    torch.testing.assert_close(y, fd.decoder_stack_fwd(*ops, 3, 4,
                                                       torch.float32),
                               rtol=0, atol=0)
    assert xs.shape == (3, 2, 64, DIM) and ats.shape == (3, 2, 64, 16)
    torch.testing.assert_close(xs[0], ops[0], rtol=0, atol=0)
    torch.testing.assert_close(ats.view(3, 2, 64, 4, 4).sum(-1),
                               torch.ones(3, 2, 64, 4))
    assert fd.launches_save == fd.launches_bwd == 0


@pytest.mark.parametrize("n", [16, 64])
def test_module_grads_match_flax(n):
    """TransformerDecoder's parameter gradients on both sides of the gate
    (layer by layer at n = 16, the stack at n = 64) against jax.grad of the
    flax module."""
    depth, heads = 3, 4
    port = TransformerDecoder(DIM, depth, heads, 16, DIM)
    rng = np.random.RandomState(23)
    with torch.no_grad():
        for p in port.parameters():
            p.add_(torch.from_numpy(
                rng.normal(0, 0.1, p.shape).astype(np.float32)))
    sd = {f"d.{k}": v.numpy() for k, v in port.state_dict().items()}
    params = {}
    _convert_decoder(sd, "d", depth, params, ())
    x, m = _inputs(2, n, seed=24)
    dy = rng.normal(size=x.shape).astype(np.float32)
    flax_dec = JaxDecoder(DIM, depth, heads, 16, DIM)
    ref = jax.grad(lambda p: jnp.sum(flax_dec.apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(m)) * dy))(params)
    out = port(torch.from_numpy(x), torch.from_numpy(m))
    (out * torch.from_numpy(dy)).sum().backward()
    grads = {f"d.{k}": p.grad.numpy() for k, p in port.named_parameters()}
    got = {}
    _convert_decoder(grads, "d", depth, got, ())
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat_ref) == len(grads) == 13 * depth
    for path, r in flat_ref:
        g = got
        for key in path:
            g = g[key.key]
        _close(torch.from_numpy(np.asarray(g)), r, GTOL["float32"])


def _wide_decoder(seed, dtype=torch.float32, mlp=64):
    """A port TransformerDecoder with mlp_dim = ``mlp`` != dim (64 is BIT's
    decoder width), seeded numpy weights, and the same weights as flax
    params."""
    depth, heads = 2, 8
    port = TransformerDecoder(DIM, depth, heads, 64, mlp, dtype=dtype)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in port.parameters():
            p.add_(torch.from_numpy(
                rng.normal(0, 0.1, p.shape).astype(np.float32)))
    sd = {f"d.{k}": v.numpy() for k, v in port.state_dict().items()}
    params = {}
    _convert_decoder(sd, "d", depth, params, ())
    return port, params, depth, heads


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_module_with_wide_mlp_matches_flax(dname):
    """mlp_dim = 64 with dim = 32: forward and every parameter's gradient,
    and dx and dm, against the flax module with the same weights."""
    tdt, jdt = DTYPES[dname]
    port, params, depth, heads = _wide_decoder(25, tdt)
    assert port.uses_stack(256, 4, DIM)
    x, m = _inputs(2, 256, seed=26)
    dy = np.random.RandomState(27).normal(size=x.shape).astype(np.float32)
    flax_dec = JaxDecoder(DIM, depth, heads, 64, 64, dtype=jdt)

    def loss(p, x_, m_):
        y = flax_dec.apply({"params": p}, x_, m_)
        return jnp.sum(y.astype(jnp.float32) * dy), y

    (_, ref_y), (rdp, rdx, rdm) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(x),
                                               jnp.asarray(m))
    xt = torch.from_numpy(x).requires_grad_()
    mt = torch.from_numpy(m).requires_grad_()
    out = port(xt, mt)
    assert out.dtype == tdt and out.shape == (2, 256, DIM)
    _close(out.detach(), ref_y, TOL[dname])
    (out.float() * torch.from_numpy(dy)).sum().backward()
    _close(xt.grad, rdx, GTOL[dname])
    _close(mt.grad, rdm, GTOL[dname])
    grads = {f"d.{k}": p.grad.numpy() for k, p in port.named_parameters()}
    got = {}
    _convert_decoder(grads, "d", depth, got, ())
    flat_ref = jax.tree_util.tree_flatten_with_path(rdp)[0]
    assert len(flat_ref) == len(grads) == 13 * depth
    for path, r in flat_ref:
        g = got
        for key in path:
            g = g[key.key]
        assert np.asarray(g).shape == r.shape
        _close(torch.from_numpy(np.asarray(g)), r, GTOL[dname])


def test_wide_mlp_plain_backward_is_the_forward_gradient_in_float64():
    """With b1 (D, 64) beside vecs the plain K2 is still the exact gradient
    of the plain K1 with saves, db1 included."""
    depth, heads, mlp = 2, 4, 64
    rng = np.random.RandomState(28)
    hl = 4 * heads

    def t(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.normal(size=shape)).requires_grad_()

    ops = (t(2, 48, DIM), t(depth, 2, DIM, hl, scale=0.3),
           t(depth, 2, hl, DIM, scale=0.3), t(depth, DIM, mlp, scale=0.2),
           t(depth, mlp, DIM, scale=0.2), t(depth, 7, DIM, scale=0.3))
    b1 = t(depth, mlp, scale=0.3)
    y, xs, ats = fd.decoder_stack_fwd_plain(*ops, depth, heads, torch.float64,
                                            save=True, b1=b1)
    dy = torch.from_numpy(rng.normal(size=y.shape))
    ref = torch.autograd.grad(y, (*ops, b1), dy)
    got = fd.decoder_stack_bwd_plain(xs.detach(), ats.detach(), dy,
                                     *(o.detach() for o in ops[1:]), depth,
                                     heads, torch.float64, b1=b1.detach())
    assert len(got) == 7 and got[6].shape == (depth, mlp)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("which", ["fwd", "fwd_save", "bwd", "fused"])
def test_wrappers_raise_by_name_for_wide_mlp_off_cpu(which):
    """Off the CPU the kernels exist for mlp_dim 32 and 64: at a width with
    no instance (96) every wrapper raises a ValueError that names mlp_dim
    and never runs its plain version."""
    from dahitra_tpu_torch.kernels import fused_decoder as kd
    from dahitra_tpu_torch.nn.decoder_vjp import (_split_b1,
                                                  pack_decoder_params)

    port, _, depth, heads = _wide_decoder(29, mlp=96)
    x, m = (torch.from_numpy(t) for t in _inputs(2, 64, seed=30))
    with torch.no_grad():
        packed = pack_decoder_params(port)
        ops = [t.to("meta") for t in _operands(x, m, packed, depth, heads,
                                               torch.float32)]
        b1 = _split_b1(packed).to("meta")
    with pytest.raises(ValueError, match="mlp_dim"):
        if which == "fused":
            kd.fused_transformer_decoder(
                x.to("meta"), m.to("meta"),
                {k: v.to("meta") for k, v in packed.items()}, depth, heads,
                True)
        elif which == "bwd":
            xs = torch.empty(depth, 2, 64, DIM, device="meta")
            ats = torch.empty(depth, 2, 64, 4 * heads, device="meta")
            fd.decoder_stack_bwd(xs, ats, ops[0], *ops[1:], depth, heads,
                                 torch.float32, b1=b1)
        else:
            fd.decoder_stack_fwd(*ops, depth, heads, torch.float32,
                                 save=which == "fwd_save", b1=b1)
