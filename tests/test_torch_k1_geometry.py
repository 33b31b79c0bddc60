"""What K1 and K1-save (csrc/decoder_fwd.cu, ``decoder_stack_fwd_rows_mma``)
rely on, held on the CPU against the JAX package.

The kernel pads hl up to a multiple of 16 with zero columns of A and zero
rows of Z. Since hl is a multiple of the l tokens per head and l divides 16,
the padding is whole heads: each padded head's logits are 0, its softmax
stays inside its own group (1 / l each) and meets only zero rows of Z. So
the forward with those heads appended, through ``decoder_stack_fwd_plain``,
gives the y of the JAX ``decoder_vjp.decoder_stack`` over the unpadded
operands (tolerances of tests/test_decoder_vjp.py:27-30, scale-normalized:
fp32 1e-5, bf16 2e-2), and leaves the real heads' attention as it was.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dahitra_tpu.nn.decoder_vjp import decoder_stack as jax_decoder_stack
from dahitra_tpu_torch.kernels import folded_decoder as fd
from dahitra_tpu_torch.nn.decoder_vjp import _operands

DIM = 32
TOKENS = 4
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _packed(depth, heads, seed, dim_head=64):
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


def _pad_to_16(a, z):
    """A's extra columns and Z's extra rows, zero, up to hl a multiple of
    16, as the kernel stages them."""
    hl = a.shape[-1]
    cols = -hl % 16
    return (torch.cat([a, a.new_zeros(*a.shape[:-1], cols)], -1),
            torch.cat([z, z.new_zeros(*z.shape[:2], cols, DIM)], 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [2, 6, 10])
def test_zero_heads_padding_keeps_the_forward(dtype, heads):
    """hl 8, 24 and 40 (two zero heads each), depth 2, N 37."""
    depth, b, n = 2, 2, 37
    hl = heads * TOKENS
    packed = _packed(depth, heads, seed=hl)
    rng = np.random.RandomState(hl + 1)
    x = rng.normal(size=(b, n, DIM)).astype(np.float32)
    m = rng.normal(size=(b, TOKENS, DIM)).astype(np.float32)
    jdt = JAX_DTYPES[dtype]
    ref = np.asarray(jax_decoder_stack(
        jnp.asarray(x, jdt), jnp.asarray(m, jdt),
        {k: jnp.asarray(v) for k, v in packed.items()}, depth, heads, jdt),
        np.float32)

    ops = _operands(torch.from_numpy(x), torch.from_numpy(m),
                    {k: torch.from_numpy(v) for k, v in packed.items()}, depth,
                    heads, dtype)
    a, z = _pad_to_16(ops[1], ops[2])
    hlp = a.shape[-1]
    assert hlp % 16 == 0 and hlp - hl == 2 * TOKENS
    y, _, attn = fd.decoder_stack_fwd_plain(ops[0], a, z, *ops[3:], depth,
                                            hlp // TOKENS, dtype, save=True)
    got = y.float().numpy()
    scale = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0,
                               atol=TOL[dtype])
    # The zero heads' attention is 1 / l, inside their own groups; the real
    # heads' attention is the unpadded forward's.
    _, _, attn_ref = fd.decoder_stack_fwd_plain(*ops, depth, heads, dtype,
                                                save=True)
    torch.testing.assert_close(attn[..., :hl].float(), attn_ref.float(),
                               rtol=0, atol=0)
    assert (attn[..., hl:].float() == 1.0 / TOKENS).all()
