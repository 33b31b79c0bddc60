"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips when no CUDA card is present. This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances, scale-normalized: forward fp32 1e-4 (summation order) and bf16
2e-2; gradients fp32 1e-4 and bf16 6e-2 (tests/test_decoder_vjp.py:27-30).
"""
import pytest
import torch

from dahitra_tpu_torch.kernels import folded_decoder as fd
from dahitra_tpu_torch.kernels import fused_decoder as kd
from dahitra_tpu_torch.kernels import fused_tokenizer as ft
from dahitra_tpu_torch.nn.blocks import TransformerDecoder
from dahitra_tpu_torch.nn.decoder_vjp import (_operands, _split_b1,
                                              decoder_stack,
                                              pack_decoder_params)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GTOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scaled_err(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-3)
            ).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,depth,heads", [(2, 256, 2, 4), (3, 100, 8, 8),
                                             (2, 64, 1, 32)])
def test_decoder_stack_kernel_matches_plain(card, dtype, b, n, depth, heads):
    """Ragged n (100: a partly filled CTA) and the widest hl = 128."""
    g = torch.Generator().manual_seed(0)
    dec = TransformerDecoder(32, depth, heads, 64, 32).to(card)
    x = torch.randn(b, n, 32, generator=g).to(card, dtype)
    m = torch.randn(b, 4, 32, generator=g).to(card, dtype)
    with torch.no_grad():
        ops = _operands(x, m, pack_decoder_params(dec), depth, heads, dtype)
    before = fd.launches
    got = fd.decoder_stack_fwd(*ops, depth, heads, dtype)
    torch.cuda.synchronize()
    assert fd.launches == before + 1
    ref = fd.decoder_stack_fwd_plain(*ops, depth, heads, dtype)
    assert _scaled_err(got, ref) <= TOL[dtype]


def _stack_case(card, dtype, b, n, depth, heads, seed=0, mlp=32, l=4):
    """A seeded decoder (mlp_dim ``mlp``), its inputs x and m (``l`` memory
    tokens), the kernel operands and a cotangent; with ``mlp`` != 32 the
    operands end with b1 (D, mlp)."""
    g = torch.Generator().manual_seed(seed)
    dec = TransformerDecoder(32, depth, heads, 64, mlp).to(card)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g).to(card))
    x = torch.randn(b, n, 32, generator=g).to(card, dtype)
    m = torch.randn(b, l, 32, generator=g).to(card, dtype)
    with torch.no_grad():
        packed = pack_decoder_params(dec)
        ops = _operands(x, m, packed, depth, heads, dtype)
        if mlp != 32:
            ops = (*ops, _split_b1(packed).contiguous())
    return dec, x, m, ops, torch.randn(b, n, 32, generator=g).to(card, dtype)


# The edges of K1, K1-save and K2 (tensor cores, 16-row warp tiles; CTAs of
# 128 rows in K1, tiles of 64 in K2), in both dtypes: n below one warp tile
# (5), n = 16 k + 1, one sample, hl = 8 (zero-padded to 16: two whole zero
# heads), hl = 64 at a ragged n, and the 256 px dates depth at N = 4096.
K1_K2_EDGES = [(dtype, *shape) for shape in [(2, 5, 2, 4), (2, 113, 2, 8),
                                             (1, 300, 4, 8), (2, 100, 2, 2),
                                             (2, 200, 2, 16), (2, 4096, 8, 8)]
               for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("dtype,b,n,depth,heads", [
    (dtype, *shape) for shape in [(2, 100, 1, 32), (3, 100, 8, 8),
                                  (2, 256, 8, 32)]
    for dtype in (torch.float32, torch.bfloat16)] + K1_K2_EDGES)
def test_save_forward_and_backward_kernels_match_plain(card, dtype, b, n,
                                                       depth, heads):
    """K1, K1-save and K2 at ragged n (100), depth 1 and 8 and the widest
    hl = 128, and at their edges (``K1_K2_EDGES``). K1-save's y is K1's bit
    for bit; reruns of K1, K1-save and K2 give the same bits."""
    _, _, _, ops, dy = _stack_case(card, dtype, b, n, depth, heads)
    before = (fd.launches, fd.launches_save, fd.launches_bwd)
    y, xs, ats = fd.decoder_stack_fwd(*ops, depth, heads, dtype, save=True)
    got = fd.decoder_stack_bwd(xs, ats, dy, *ops[1:], depth, heads, dtype)
    y_k1 = fd.decoder_stack_fwd(*ops, depth, heads, dtype)
    torch.cuda.synchronize()
    assert (fd.launches, fd.launches_save, fd.launches_bwd) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert torch.equal(y, y_k1)
    assert torch.equal(y_k1, fd.decoder_stack_fwd(*ops, depth, heads, dtype))
    again = fd.decoder_stack_fwd(*ops, depth, heads, dtype, save=True)
    assert all(torch.equal(g, h) for g, h in zip((y, xs, ats), again))
    ref_y, ref_xs, ref_ats = fd.decoder_stack_fwd_plain(*ops, depth, heads,
                                                        dtype, save=True)
    for g, r in ((y, ref_y), (xs, ref_xs), (ats, ref_ats)):
        assert _scaled_err(g, r) <= TOL[dtype]
    # K2 from the kernel's own saves against the plain backward from them.
    ref = fd.decoder_stack_bwd_plain(xs, ats, dy, *ops[1:], depth, heads, dtype)
    for name, g, r in zip(("dx", "da", "dz", "dw1", "dw2", "dvecs"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert _scaled_err(g, r) <= GTOL[dtype], name
    again = fd.decoder_stack_bwd(xs, ats, dy, *ops[1:], depth, heads, dtype)
    assert all(torch.equal(g, h) for g, h in zip(got, again))  # fixed order


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["16 tokens per head", "odd hl",
                                  "3 tokens per head"])
@pytest.mark.parametrize("which", ["forward", "forward with saves",
                                   "backward"])
def test_kernels_refuse_what_they_do_not_take(card, dtype, case, which):
    """K1, K1-save and K2 take 1, 2, 4 or 8 tokens per head (a softmax
    group inside one 8-column mma tile) and an even hl; 16 tokens per head
    (hl 16, one head), hl 15 (15 heads of one token) and 3 tokens per head
    (hl 12, 4 heads: even, but not a count the tiles hold) raise by name,
    before any launch."""
    _, _, _, ops, dy = _stack_case(card, dtype, 1, 64, 1, 4)
    _, xs, ats = fd.decoder_stack_fwd(*ops, 1, 4, dtype, save=True)
    a, z = ops[1], ops[2]
    heads = 1
    cut = {"odd hl": (15, 15), "3 tokens per head": (12, 4)}.get(case)
    if cut is not None:
        hl, heads = cut
        ats, a, z = (ats[..., :hl].contiguous(), a[..., :hl].contiguous(),
                     z[:, :, :hl].contiguous())
    before = (fd.launches, fd.launches_save, fd.launches_bwd)
    with pytest.raises(ValueError, match="tokens per head and an even hl"):
        if which == "backward":
            fd.decoder_stack_bwd(xs, ats, dy, a, z, *ops[3:], 1, heads, dtype)
        else:
            fd.decoder_stack_fwd(ops[0], a, z, *ops[3:], 1, heads, dtype,
                                 save=which == "forward with saves")
    assert (fd.launches, fd.launches_save, fd.launches_bwd) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_step_uses_only_save_and_backward_kernels(card, dtype,
                                                           monkeypatch):
    """One autograd step through decoder_stack launches K1-save and K2 once
    each, never K1 without saves and never the plain versions; under
    no_grad it is K1 without saves."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on the card")

    dec, x, m, _, dy = _stack_case(card, dtype, 2, 256, 4, 4, seed=1)
    monkeypatch.setattr(fd, "decoder_stack_fwd_plain", refuse)
    monkeypatch.setattr(fd, "decoder_stack_bwd_plain", refuse)
    x.requires_grad_(True)
    before = (fd.launches, fd.launches_save, fd.launches_bwd)
    y = decoder_stack(x, m, pack_decoder_params(dec), 4, 4, dtype)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (fd.launches, fd.launches_save, fd.launches_bwd) == (
        before[0], before[1] + 1, before[2] + 1)
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()
    assert all(p.grad is not None for p in dec.parameters())
    with torch.no_grad():
        decoder_stack(x, m, pack_decoder_params(dec), 4, 4, dtype)
    assert fd.launches == before[0] + 1


def _tokenizer_case(card, dtype, b, n, l, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, 32, generator=g).to(card, dtype)
    w = (torch.randn(32, l, generator=g) * 32 ** -0.5).to(card, dtype)
    return x, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,l", [(2, 4096, 4), (3, 1000, 16), (1, 64, 1),
                                   (2, 16384, 4), (1, 65536, 4),
                                   (16, 256, 4), (5, 129, 3)])
def test_tokenizer_kernel_matches_plain(card, dtype, b, n, l):
    """The 256, 512 and 1024 px 1/4-scale maps (N = 4096, 16384, 65536), a
    ragged last chunk (N = 1000, 129), one short tile (N = 64) and the
    widest L."""
    x, w = _tokenizer_case(card, dtype, b, n, l)
    before = ft.launches
    got = ft.semantic_tokenizer(x, w)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    assert torch.isfinite(got.float()).all()
    assert _scaled_err(got, ft.semantic_tokenizer_plain(x, w)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,l", [(2, 16384, 4), (3, 1000, 16), (16, 4096, 4)])
def test_tokenizer_rerun_gives_the_same_bits(card, dtype, b, n, l):
    """Every sum has a fixed order: reruns agree bit for bit, whichever CTA
    of a sample finishes last and sums the partial tokens."""
    x, w = _tokenizer_case(card, dtype, b, n, l, seed=2)
    first = ft.semantic_tokenizer(x, w)
    for _ in range(20):
        assert torch.equal(first, ft.semantic_tokenizer(x, w))


def test_tokenizer_combines_chunks_of_very_different_maxima(card):
    """One chunk's logits dwarf the others': no NaN from the combine."""
    x, w = _tokenizer_case(card, torch.float32, 2, 4096, 4, seed=3)
    x[:, 300:310] *= 40.0
    got = ft.semantic_tokenizer(x, w)
    assert torch.isfinite(got).all()
    assert _scaled_err(got, ft.semantic_tokenizer_plain(x, w)) <= 1e-4


def test_tokenizer_matches_its_split_plain_version(card):
    """The kernel against the same algorithm in PyTorch at its own chunk."""
    x, w = _tokenizer_case(card, torch.float32, 4, 65536, 4, seed=4)
    chunk = ft._chunk(4, 65536, ft._n_sm(x.device.index))
    ref = ft.semantic_tokenizer_split_plain(x, w, chunk)
    assert _scaled_err(ft.semantic_tokenizer(x, w), ref) <= 1e-4


# K4 instances: (x dtype, precise). The fp32 model, the bf16 model (fp32
# decoder input, bf16 operands), bf16 I/O, and bf16 I/O with fp32 operands.
K4_MODES = [(torch.float32, True), (torch.float32, False),
            (torch.bfloat16, False), (torch.bfloat16, True)]


def _k4_case(card, io, b, n, depth, heads, seed=2, l=4, mlp=32):
    g = torch.Generator().manual_seed(seed)
    dec = TransformerDecoder(32, depth, heads, 64, mlp)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
        packed = {k: v.to(card) for k, v in pack_decoder_params(dec).items()}
    x = torch.randn(b, n, 32, generator=g).to(card, io)
    m = torch.randn(b, l, 32, generator=g).to(card)
    return x, m, packed


# (b, n, depth, heads, tokens per head): a 1/4-scale and a 1/16-scale shape;
# a ragged n (100) at the widest hl = 128; l = 1, 2, 8 and 16, with an odd
# hl (3), ragged n and hl = 128 at l = 16.
K4_SHAPES = [(2, 4096, 8, 8, 4), (16, 256, 4, 4, 4), (3, 100, 2, 32, 4),
             (2, 300, 2, 8, 1), (5, 257, 3, 3, 1), (2, 256, 2, 4, 2),
             (2, 129, 2, 4, 8), (3, 200, 2, 8, 16), (1, 64, 1, 1, 16)]


@pytest.mark.parametrize("io,precise", K4_MODES)
@pytest.mark.parametrize("b,n,depth,heads,l", K4_SHAPES)
def test_fused_decoder_kernel_matches_plain(card, io, precise, b, n, depth,
                                            heads, l):
    """K4 (prologue and row kernel) against fused_decoder_plain; a rerun
    gives the same bits."""
    x, m, packed = _k4_case(card, io, b, n, depth, heads, l=l)
    before = kd.launches
    got = kd.fused_transformer_decoder(x, m, packed, depth, heads, precise)
    torch.cuda.synchronize()
    assert kd.launches == before + 1 and got.dtype == io
    ref = kd.fused_decoder_plain(x, m, packed, depth, heads, precise)
    # bf16 operands or a bf16 output: one rounding flip in bf16 moves a value
    # by up to an ulp of bf16.
    tol = TOL[torch.float32 if precise and io == torch.float32
              else torch.bfloat16]
    assert _scaled_err(got, ref) <= tol
    assert torch.equal(got, kd.fused_transformer_decoder(x, m, packed, depth,
                                                         heads, precise))


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("b,depth,heads,l", [(16, 8, 8, 4), (5, 3, 3, 1),
                                             (3, 2, 8, 16), (9, 2, 32, 4)])
def test_fused_decoder_prologue_matches_plain(card, precise, b, depth, heads,
                                              l):
    """The prologue alone (A and Z, fp32) against fused_decoder_az_plain:
    B not a multiple of the 4 samples per CTA, odd hl, l = 16, hl = 128."""
    _, m, packed = _k4_case(card, torch.float32, b, 1, depth, heads, l=l)
    before = kd.launches_az
    a, z = kd.fused_decoder_az(m, packed, depth, heads, precise)
    torch.cuda.synchronize()
    assert kd.launches_az == before + 1
    ref_a, ref_z = kd.fused_decoder_az_plain(m, packed, depth, heads, precise)
    # fp32 FMA sums in another order; with bf16 operands k and v are rounded
    # to bf16, where one flipped rounding moves A by an ulp of bf16.
    tol = 1e-5 if precise else TOL[torch.bfloat16]
    assert _scaled_err(a, ref_a) <= tol and _scaled_err(z, ref_z) <= tol


@pytest.mark.parametrize("l,heads", [(3, 4), (32, 4)])
def test_fused_decoder_refuses_other_token_counts(card, l, heads):
    """3 tokens per head, and 32 (hl = 128 but a group wider than a
    16-column slice): a ValueError naming the tokens per head, from both
    wrappers; no plain fallback."""
    x, m, packed = _k4_case(card, torch.float32, 2, 128, 1, heads, l=l)
    before = kd.launches, kd.launches_az
    with pytest.raises(ValueError, match="tokens per head"):
        kd.fused_transformer_decoder(x, m, packed, 1, heads, True)
    with pytest.raises(ValueError, match="tokens per head"):
        kd.fused_decoder_az(m, packed, 1, heads, True)
    assert (kd.launches, kd.launches_az) == before


def test_fused_decoder_grads_match_cpu(card, monkeypatch):
    """FusedDecoderFn on the card (K4 forward, the plain-stack backward)
    against autograd of plain_decoder_stack on the CPU, fp32: x, m and all
    13 packed gradients. The card's forward never takes the plain
    version."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on the card")

    depth, heads = 4, 8
    x, m, packed = _k4_case(card, torch.float32, 2, 512, depth, heads, seed=3)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    leaves = {dev: [t.detach().to(dev).requires_grad_()
                    for t in (x, m, *(packed[k] for k in kd.ORDER))]
              for dev in ("cpu", "cuda")}
    ref = torch.autograd.grad(
        kd.plain_decoder_stack(leaves["cpu"][0], leaves["cpu"][1],
                               dict(zip(kd.ORDER, leaves["cpu"][2:])), depth,
                               heads, torch.float32), leaves["cpu"], dy)
    monkeypatch.setattr(kd, "fused_decoder_plain", refuse)
    before = kd.launches
    y = kd.FusedDecoderFn.apply(depth, heads, torch.float32, *leaves["cuda"])
    got = torch.autograd.grad(y, leaves["cuda"], dy.to(card))
    torch.cuda.synchronize()
    assert kd.launches == before + 1
    for name, g, r in zip(("x", "m", *kd.ORDER), got, ref):
        assert _scaled_err(g.cpu(), r) <= GTOL[torch.float32], name


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.randn(2, 64, 16, device=card)
    with pytest.raises(ValueError):
        ft.semantic_tokenizer(x, torch.randn(16, 4, device=card))
    with pytest.raises(TypeError):
        ft.semantic_tokenizer(torch.randn(2, 64, 32, device=card).half(),
                              torch.randn(32, 4, device=card).half())
    x, m, packed = _k4_case(card, torch.float32, 1, 128, 1, 4)
    with pytest.raises(TypeError):
        kd.fused_transformer_decoder(x.half(), m, packed, 1, 4, True)
    with pytest.raises(ValueError):
        kd.fused_transformer_decoder(x, torch.randn(1, 40, 32, device=card),
                                     packed, 1, 4, True)


# BIT's decoder width, mlp_dim 64, at hl 32 (8 heads of 4 tokens) and 64 (8
# heads of 8 tokens), at N below one warp tile (5) and N = 16 k + 1 (4097).
WIDE_SHAPES = [(dtype, b, n, depth, l) for b, n, depth, l in
               [(2, 5, 2, 4), (2, 4097, 2, 4), (2, 5, 2, 8), (2, 4097, 2, 8)]
               for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("dtype,b,n,depth,l", WIDE_SHAPES)
def test_wide_mlp_kernels_match_plain(card, dtype, b, n, depth, l):
    """The mlp_dim-64 instances of K1, K1-save and K2 (b1 and db1 beside
    vecs) against their plain versions; K1-save's y is K1's bit for bit and
    reruns give the same bits."""
    heads = 8
    _, _, _, ops, dy = _stack_case(card, dtype, b, n, depth, heads, mlp=64,
                                   l=l)
    *ops, b1 = ops
    before = (fd.launches, fd.launches_save, fd.launches_bwd)
    y = fd.decoder_stack_fwd(*ops, depth, heads, dtype, b1=b1)
    ys, xs, ats = fd.decoder_stack_fwd(*ops, depth, heads, dtype, save=True,
                                       b1=b1)
    got = fd.decoder_stack_bwd(xs, ats, dy, *ops[1:], depth, heads, dtype,
                               b1=b1)
    torch.cuda.synchronize()
    assert (fd.launches, fd.launches_save, fd.launches_bwd) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert torch.equal(y, ys)
    assert torch.equal(y, fd.decoder_stack_fwd(*ops, depth, heads, dtype,
                                               b1=b1))
    ref_y, ref_xs, ref_ats = fd.decoder_stack_fwd_plain(
        *ops, depth, heads, dtype, save=True, b1=b1)
    for g, r in ((y, ref_y), (xs, ref_xs), (ats, ref_ats)):
        assert _scaled_err(g, r) <= TOL[dtype]
    ref = fd.decoder_stack_bwd_plain(xs, ats, dy, *ops[1:], depth, heads,
                                     dtype, b1=b1)
    assert len(got) == len(ref) == 7
    for name, g, r in zip(("dx", "da", "dz", "dw1", "dw2", "dvecs", "db1"),
                          got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert _scaled_err(g, r) <= GTOL[dtype], name
    assert not got[5][:, 5].any()  # b1's row of dvecs
    again = fd.decoder_stack_bwd(xs, ats, dy, *ops[1:], depth, heads, dtype,
                                 b1=b1)
    assert all(torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.parametrize("io,precise", K4_MODES)
@pytest.mark.parametrize("n,l", [(5, 4), (4097, 4), (5, 8), (4097, 8)])
def test_wide_mlp_fused_decoder_matches_plain(card, io, precise, n, l):
    """K4's mlp_dim-64 row kernel against fused_decoder_plain in its four
    instances, at hl 32 and 64; a rerun gives the same bits."""
    depth, heads = 2, 8
    x, m, packed = _k4_case(card, io, 2, n, depth, heads, l=l, mlp=64)
    before = kd.launches
    got = kd.fused_transformer_decoder(x, m, packed, depth, heads, precise)
    torch.cuda.synchronize()
    assert kd.launches == before + 1 and got.dtype == io
    ref = kd.fused_decoder_plain(x, m, packed, depth, heads, precise)
    tol = TOL[torch.float32 if precise and io == torch.float32
              else torch.bfloat16]
    assert _scaled_err(got, ref) <= tol
    assert torch.equal(got, kd.fused_transformer_decoder(x, m, packed, depth,
                                                         heads, precise))


@pytest.mark.parametrize("which", ["forward", "forward with saves",
                                   "backward", "fused"])
def test_kernels_refuse_mlp_dim_96(card, which):
    """A hidden width with no kernel instance (96) raises a ValueError that
    names mlp_dim, before any launch; the plain version never runs."""
    depth, heads = 1, 4
    _, x, m, ops, dy = _stack_case(card, torch.float32, 1, 64, depth, heads,
                                   mlp=96)
    *ops, b1 = ops
    before = (fd.launches, fd.launches_save, fd.launches_bwd, kd.launches)
    with pytest.raises(ValueError, match="mlp_dim"):
        if which == "fused":
            _, m4, packed = _k4_case(card, torch.float32, 1, 64, depth, heads,
                                     mlp=96)
            kd.fused_transformer_decoder(x, m4, packed, depth, heads, True)
        elif which == "backward":
            xs = torch.zeros(depth, 1, 64, 32, device=card)
            ats = torch.zeros(depth, 1, 64, 4 * heads, device=card)
            fd.decoder_stack_bwd(xs, ats, dy, *ops[1:], depth, heads,
                                 torch.float32, b1=b1)
        else:
            fd.decoder_stack_fwd(*ops, depth, heads, torch.float32,
                                 save=which == "forward with saves", b1=b1)
    assert (fd.launches, fd.launches_save, fd.launches_bwd,
            kd.launches) == before
