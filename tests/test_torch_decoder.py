"""The port's decoder stack against the JAX package's.

``decoder_stack_plain`` (the plain PyTorch version of the K1 kernel) is held
against ``decoder_vjp.decoder_stack`` and, in bf16, against the Pallas K1
kernel ``folded_decoder_fwd`` run in interpret mode. Same seeded numpy
inputs and packed weights through both packages. Tolerances are those of
tests/test_decoder_vjp.py:27-30, scale-normalized: fp32 1e-5, bf16 2e-2.
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
from dahitra_tpu.pallas.folded_decoder import folded_decoder_fwd
from dahitra_tpu_torch.kernels import folded_decoder as fd
from dahitra_tpu_torch.nn.blocks import TransformerDecoder
from dahitra_tpu_torch.nn.decoder_vjp import (_operands, build_az,
                                              decoder_stack,
                                              decoder_stack_plain)

DIM = 32
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
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
