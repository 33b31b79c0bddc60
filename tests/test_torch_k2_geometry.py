"""What K2's bf16 instance (csrc/decoder_bwd.cu, ``decoder_stack_bwd_rows_mma``)
relies on, held on the CPU.

* The launch geometry: ``_bwd_rows_per_cta`` gives each CTA whole tiles of
  its instance (32 rows fp32, 64 bf16), every row to exactly one CTA, no CTA
  empty.
* The padding rule: the kernel pads hl up to a multiple of 16 with zero
  columns of A, zero rows of Z and zero attention. With whole heads of zeros
  appended, ``decoder_stack_bwd_plain`` returns the same dx, dW1, dW2 and
  dvecs, and dA, dZ that are the unpadded ones beside zeros.
"""
import numpy as np
import pytest
import torch

from dahitra_tpu_torch.kernels import folded_decoder as fd

DIM = 32
TOKENS = 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 8, 16, 64])
def test_rows_per_cta_gives_whole_tiles_and_covers_every_row_once(dtype, b):
    tile = fd._BWD_TILE[dtype]
    for slots in (2 * 132, 3 * 132, 2 * 114):
        for n in (1, 5, 16, 17, 63, 64, 65, 100, 113, 256, 1024, 4096, 4097,
                  16384, 65536):
            rows = fd._bwd_rows_per_cta(b, n, slots, tile)
            assert rows > 0 and rows % tile == 0, (n, rows)
            cps = -(-n // rows)
            owner = np.zeros(n, np.int64)
            for c in range(cps):
                lo, hi = c * rows, min(n, (c + 1) * rows)
                assert lo < hi, (n, c)  # no empty CTA
                owner[lo:hi] += 1
            assert (owner == 1).all(), n
            # About one wave of the card's CTA slots, given rows enough.
            assert b * cps <= slots + b, (n, cps)


def _operands(dtype, depth, b, n, heads, seed):
    rng = np.random.RandomState(seed)
    hl = heads * TOKENS

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.normal(size=shape)).astype(np.float32)).to(dtype)

    logits = torch.from_numpy(rng.normal(size=(depth, b, n, heads, TOKENS))
                              .astype(np.float32))
    attn = torch.softmax(logits, -1).reshape(depth, b, n, hl).to(dtype)
    vecs = torch.from_numpy((0.2 * rng.normal(size=(depth, 7, DIM)) + np.array(
        [1, 0, 0, 1, 0, 0, 0], np.float32)[:, None]).astype(np.float32))
    return dict(xsave=t(depth, b, n, DIM), attnsave=attn, dy=t(b, n, DIM),
                a=t(depth, b, DIM, hl, scale=0.2),
                z=t(depth, b, hl, DIM, scale=0.2),
                w1=t(depth, DIM, DIM, scale=DIM ** -0.5),
                w2=t(depth, DIM, DIM, scale=DIM ** -0.5), vecs=vecs)


def _pad_heads(ops, extra):
    """``extra`` zero heads appended to A (columns), Z (rows) and the
    attention save."""
    cols = extra * TOKENS
    out = dict(ops)
    out["a"] = torch.cat([ops["a"], torch.zeros(*ops["a"].shape[:-1], cols,
                                                dtype=ops["a"].dtype)], -1)
    z = ops["z"]
    out["z"] = torch.cat([z, torch.zeros(*z.shape[:2], cols, DIM,
                                         dtype=z.dtype)], 2)
    at = ops["attnsave"]
    out["attnsave"] = torch.cat([at, torch.zeros(*at.shape[:-1], cols,
                                                 dtype=at.dtype)], -1)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,b,n", [(1, 1, 5), (2, 2, 33)])
def test_zero_heads_change_no_gradient(dtype, depth, b, n):
    """Heads 4 (hl 16) against heads 8 with four zero heads appended (hl
    32): the kernel's padding of hl to a multiple of 16 adds nothing."""
    ops = _operands(dtype, depth, b, n, 4, seed=depth * 10 + n)
    order = ("xsave", "attnsave", "dy", "a", "z", "w1", "w2", "vecs")
    ref = fd.decoder_stack_bwd_plain(*(ops[k] for k in order), depth, 4, dtype)
    padded = _pad_heads(ops, 4)
    got = fd.decoder_stack_bwd_plain(*(padded[k] for k in order), depth, 8,
                                     dtype)
    for name, i in (("dx", 0), ("dw1", 3), ("dw2", 4), ("dvecs", 5)):
        torch.testing.assert_close(got[i], ref[i], rtol=0, atol=0, msg=name)
    hl = 4 * TOKENS
    torch.testing.assert_close(got[1][..., :hl], ref[1], rtol=0, atol=0)
    torch.testing.assert_close(got[2][:, :, :hl], ref[2], rtol=0, atol=0)
    assert not got[1][..., hl:].any() and not got[2][:, :, hl:].any()
