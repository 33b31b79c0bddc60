"""What K2 (csrc/decoder_bwd.cu, ``decoder_stack_bwd_rows_mma``) relies on,
held on the CPU.

* The launch geometry: ``_bwd_rows_per_cta`` gives each CTA whole 64-row
  tiles, every row to exactly one CTA, no CTA empty, at the CTA slots each
  instance has.
* The padding rule: the kernel pads hl up to a multiple of 16 with zero
  columns of A, zero rows of Z and zero attention. With whole heads of zeros
  appended, ``decoder_stack_bwd_plain`` returns the same dx, dW1, dW2 and
  dvecs, and dA, dZ that are the unpadded ones beside zeros.
* The fp32 instance's arithmetic: each fp32 operand split into three bf16
  pieces (hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)) sums
  back to v exactly, and a product taken as the six piece products lo.hi,
  hi.lo, mid.mid, mid.hi, hi.mid, hi.hi, each 16-long k-step of
  ``mma.sync`` emulated as an exact sum rounded once to fp32 and added to
  an fp32 accumulator, stays within 1e-6 of the float64 product.
"""
import numpy as np
import pytest
import torch

from dahitra_tpu_torch.kernels import folded_decoder as fd

DIM = 32
TOKENS = 4


# CTAs per SM of K2's row kernel (CUDA's occupancy calculator on the H100,
# PERF.md): fp32 2 at every hl, bf16 3 at hl <= 64 and 2 at 128.
CTAS_PER_SM = {torch.float32: (2,), torch.bfloat16: (2, 3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 8, 16, 64])
def test_rows_per_cta_gives_whole_tiles_and_covers_every_row_once(dtype, b):
    tile = fd._BWD_TILE
    for slots in [k * sms for k in CTAS_PER_SM[dtype] for sms in (132, 114)]:
        for n in (1, 5, 16, 17, 63, 64, 65, 100, 113, 256, 1024, 4096, 4097,
                  16384, 65536):
            rows = fd._bwd_rows_per_cta(b, n, slots)
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


def _split3(v):
    """The kernel's three bf16 pieces of fp32 ``v`` (``split_pair``), as
    fp32 tensors; torch's float-to-bf16 cast rounds to nearest even, as
    ``__floats2bfloat162_rn`` does."""
    hi = v.to(torch.bfloat16).float()
    mid = (v - hi).to(torch.bfloat16).float()
    lo = (v - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _values(kind, rng, n=4096):
    if kind == "logits":  # the clamped softmax's range
        return rng.uniform(-80.0, 80.0, n)
    if kind == "near_zero":
        return rng.normal(size=n) * 10.0 ** rng.uniform(-12, -6, n)
    if kind == "exponents":  # normal fp32 from 2^-100 to 2^100, both signs
        return rng.choice([-1.0, 1.0], n) * 2.0 ** rng.uniform(-100, 100, n)
    return rng.normal(size=n)  # activations and weights


@pytest.mark.parametrize("kind", ["logits", "near_zero", "exponents",
                                  "normal"])
def test_three_piece_split_sums_back_exactly(kind):
    rng = np.random.RandomState(7)
    v = torch.from_numpy(_values(kind, rng).astype(np.float32))
    hi, mid, lo = _split3(v)
    for piece in (hi, mid, lo):  # each piece is a bf16 value
        assert torch.equal(piece.to(torch.bfloat16).float(), piece)
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, v.double())
    # Each piece holds what the one before left, 8 bits further down.
    small = v != 0
    assert (mid[small].abs() <= hi[small].abs() * 2.0 ** -8).all()
    assert (lo[small].abs() <= hi[small].abs() * 2.0 ** -16).all()


def _six_term_product(a, b):
    """A (m, k) . B (k, n) as K2's fp32 instance takes it: per 16-long
    k-step, the six piece products in the kernel's order (``mma_split``),
    each an exact sum rounded once to fp32 and added to the fp32
    accumulator."""
    pa, pb = _split3(a), _split3(b)
    order = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
    c = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 16):
        for i, j in order:
            step = pa[i][:, k0:k0 + 16].double() @ pb[j][k0:k0 + 16].double()
            c = (c.double() + step).float()
    return c


@pytest.mark.parametrize("k", [32, 128])
@pytest.mark.parametrize("scale", [1.0, 80.0])
def test_six_piece_products_match_float64(k, scale):
    """The products of K2's chain at their depths: 32 (the model width) and
    128 (the widest hl), on unit-scale and on logit-scale operands."""
    rng = np.random.RandomState(k)
    a = torch.from_numpy((scale * rng.normal(size=(16, k))).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(k, 32)).astype(np.float32))
    ref = a.double() @ b.double()
    got = _six_term_product(a, b)
    err = ((got.double() - ref).abs().max() / ref.abs().max()).item()
    assert err <= 1e-6, err
    # One bf16 piece per operand (TF32-like) misses the fp32 tolerance.
    one = (a.to(torch.bfloat16).double() @ b.to(torch.bfloat16).double())
    assert ((one - ref).abs().max() / ref.abs().max()).item() > 1e-4
