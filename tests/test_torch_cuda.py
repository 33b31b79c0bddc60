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


# Token counts per head outside 1, 2, 4 and 8 (fault 3.2): (heads, tokens)
# -> 16 tokens (the PAD instances' two 8-column halves), an odd hl (15 heads
# of one token, run as 2), 3 tokens (padded to 4, masked) at 4 and 8 heads,
# 5 tokens at 3 heads (hl 15, padded to 24) and 13 at 8 (padded hl 128).
PADDED_CASES = {"16 tokens per head": (1, 16), "odd hl": (15, 1),
                "3 tokens per head": (4, 3), "3 tokens at 8 heads": (8, 3),
                "5 tokens at 3 heads": (3, 5), "13 tokens at 8 heads": (8, 13)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(PADDED_CASES))
def test_kernels_take_every_token_count_the_gate_sends(card, dtype, case):
    """K1, K1-save and K2 at token counts the tiles do not hold, padded by
    the wrappers: against their plain versions on the unpadded operands
    (forward, saves and every gradient), one launch each, reruns bit for
    bit; the attention save, dA and dZ come back unpadded."""
    heads, l = PADDED_CASES[case]
    _, _, _, ops, dy = _stack_case(card, dtype, 2, 113, 2, heads, l=l)
    assert ops[1].shape[-1] == heads * l
    before = (fd.launches, fd.launches_save, fd.launches_bwd)
    y = fd.decoder_stack_fwd(*ops, 2, heads, dtype)
    ys, xs, ats = fd.decoder_stack_fwd(*ops, 2, heads, dtype, save=True)
    got = fd.decoder_stack_bwd(xs, ats, dy, *ops[1:], 2, heads, dtype)
    torch.cuda.synchronize()
    assert (fd.launches, fd.launches_save, fd.launches_bwd) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert torch.equal(y, ys)
    ref = fd.decoder_stack_fwd_plain(*ops, 2, heads, dtype, save=True)
    for g, r in zip((ys, xs, ats), ref):
        assert g.shape == r.shape and _scaled_err(g, r) <= TOL[dtype]
    gref = fd.decoder_stack_bwd_plain(*ref[1:], dy, *ops[1:], 2, heads, dtype)
    for name, g, r in zip(("dx", "da", "dz", "dw1", "dw2", "dvecs"), got, gref):
        assert g.shape == r.shape, name
        assert _scaled_err(g, r) <= GTOL[dtype], name
    assert torch.equal(y, fd.decoder_stack_fwd(*ops, 2, heads, dtype))
    again = fd.decoder_stack_bwd(xs, ats, dy, *ops[1:], 2, heads, dtype)
    assert all(torch.equal(g, h) for g, h in zip(got, again))


# Padded hl above 128 (ROADMAP fault 3.2, closed): 9 heads of 9 tokens
# (padded to 16: hl 144) and 17 of 5 (to 8: hl 136), which the card refused
# before, 14 of 9 (hl 224, the most the JAX gate sends; K2's fp32 WIDE
# instance, PAD), 25 of 5 (hl 200; the WIDE instance without PAD) and 127 of
# 1 (odd hl: one zero head more, hl 128).
PADDED_HL_CASES = [(9, 9), (17, 5), (14, 9), (25, 5), (127, 1)]


@pytest.mark.parametrize("heads,l", PADDED_HL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_padded_hl_above_128(card, dtype, heads, l):
    """K1, K1-save and K2 at padded hl above 128, through the wrappers:
    against their plain versions on the unpadded operands (forward, saves
    and every gradient), one launch each, counted as padded; reruns bit for
    bit; nothing refused."""
    _, _, _, ops, dy = _stack_case(card, dtype, 2, 200, 2, heads, l=l)
    before = (fd.launches, fd.launches_save, fd.launches_bwd,
              fd.launches_pad, fd.launches_save_pad, fd.launches_bwd_pad)
    y = fd.decoder_stack_fwd(*ops, 2, heads, dtype)
    ys, xs, ats = fd.decoder_stack_fwd(*ops, 2, heads, dtype, save=True)
    got = fd.decoder_stack_bwd(xs, ats, dy, *ops[1:], 2, heads, dtype)
    torch.cuda.synchronize()
    assert (fd.launches, fd.launches_save, fd.launches_bwd, fd.launches_pad,
            fd.launches_save_pad, fd.launches_bwd_pad) == tuple(
                c + 1 for c in before)
    assert torch.equal(y, ys) and ats.shape[-1] == heads * l
    ref = fd.decoder_stack_fwd_plain(*ops, 2, heads, dtype, save=True)
    for g, r in zip((ys, xs, ats), ref):
        assert g.shape == r.shape and _scaled_err(g, r) <= TOL[dtype]
    gref = fd.decoder_stack_bwd_plain(*ref[1:], dy, *ops[1:], 2, heads, dtype)
    for name, g, r in zip(("dx", "da", "dz", "dw1", "dw2", "dvecs"), got, gref):
        assert g.shape == r.shape, name
        assert _scaled_err(g, r) <= GTOL[dtype], name
    assert torch.equal(y, fd.decoder_stack_fwd(*ops, 2, heads, dtype))
    again = fd.decoder_stack_bwd(xs, ats, dy, *ops[1:], 2, heads, dtype)
    assert all(torch.equal(g, h) for g, h in zip(got, again))


def test_k2_wide_instances_build_and_hold_a_cta(card, tmp_path):
    """The row kernels' WIDE instances of K2 (fp32, mlp_dim 32 and 64, with
    and without PAD) are in the build with a ptxas report and no spills;
    at hl 224, where the wrapper takes them, one SM holds a CTA of each,
    and of K1's and K1-save's PAD instances in both dtypes."""
    import re
    import subprocess

    from dahitra_tpu_torch.kernels import _build

    log = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(tmp_path / "bwd.so"), str(_build._CSRC / "decoder_bwd.cu")],
        capture_output=True, text=True, check=True)
    report = log.stdout + log.stderr
    found, inst = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            inst = entry.group(1) if "Lb1EEEv" in entry.group(1) \
                and "rows_mmaIf" in entry.group(1) else None
        elif inst is not None:
            spill = re.search(r"(\d+) bytes spill stores", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                found.setdefault(inst, {})["spill"] = int(spill.group(1))
            if regs:
                found.setdefault(inst, {})["regs"] = int(regs.group(1))
    assert len(found) == 4, report
    assert all(v.get("spill") == 0 and 0 < v.get("regs", 0) <= 255
               for v in found.values()), found
    for mlp in (32, 64):
        for pad in (0, 1):
            assert fd._ctas_per_sm("decoder_bwd", torch.float32, 224, mlp,
                                   pad) >= 1
        for dtype in (torch.float32, torch.bfloat16):
            for save in (0, 1):
                assert fd._ctas_per_sm("decoder_fwd", dtype, 224, save, mlp,
                                       1) >= 1


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
# hl (3), ragged n and hl = 128 at l = 16; and counts the wrapper pads
# (fault 3.2): 3 and 5 tokens (to 4 and 8), 32 at 4 heads (two 16-column
# slices per group), 20 at 4 heads (to 32), 40 at 3 heads (to 48: hl 144)
# and 18 at 7 heads (to 32: hl 224).
K4_SHAPES = [(2, 4096, 8, 8, 4), (16, 256, 4, 4, 4), (3, 100, 2, 32, 4),
             (2, 300, 2, 8, 1), (5, 257, 3, 3, 1), (2, 256, 2, 4, 2),
             (2, 129, 2, 4, 8), (3, 200, 2, 8, 16), (1, 64, 1, 1, 16),
             (2, 128, 2, 4, 3), (2, 150, 2, 8, 5), (2, 128, 2, 4, 32),
             (2, 100, 2, 4, 20), (2, 64, 2, 3, 40), (2, 64, 2, 7, 18)]


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


@pytest.mark.parametrize("l,heads", [(15, 9), (33, 4)])
def test_fused_decoder_refuses_other_token_counts(card, l, heads):
    """heads * tokens above 128, which the JAX gate never sends (9 heads of
    15 tokens, 4 of 33): a ValueError naming the tokens per head, from both
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


# The xBD damage models: decoder and K3 launches per forward (xbd_dahitra one
# difference decode and one tokenizer call per scale, xbd_bit one of each
# per date, its mlp_dim-64 instances).
XBD_CALLS = {"xbd_dahitra": 3, "xbd_bit": 2}
XBD_IMG = 128


def _xbd_pair(seed=0):
    """One seeded uint8 xBD pair at XBD_IMG px: pre, post, a 5-channel mask
    and its label map (val variant)."""
    g = torch.Generator().manual_seed(seed)
    pre, post = (torch.randint(0, 256, (1, XBD_IMG, XBD_IMG, 3), generator=g,
                               dtype=torch.uint8) for _ in "ab")
    lbl = torch.randint(0, 4, (1, XBD_IMG, XBD_IMG), generator=g,
                        dtype=torch.uint8)
    loc = torch.rand(1, XBD_IMG, XBD_IMG, generator=g) < 0.4
    msk = torch.cat([loc[..., None], torch.nn.functional.one_hot(
        lbl.long(), 4).bool() & loc[..., None]], -1).to(torch.uint8)
    return {"img_pre": pre.numpy(), "img_post": post.numpy(),
            "msk": msk.numpy(), "lbl_msk": lbl.numpy()}


def _xbd_counts():
    return (fd.launches, fd.launches_save, fd.launches_bwd, ft.launches,
            kd.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("net", list(XBD_CALLS))
def test_xbd_damage_step_and_eval_on_the_card(card, tmp_path, net, dtype):
    """One ``XBDTrainer.train_step`` (K1-save, K2 and K3, ``XBD_CALLS``
    each) and one ``eval_step`` (K1 and K3) on the card; finite loss,
    counters within their range."""
    import types

    from dahitra_tpu_torch.train.xbd_engine import XBDTrainer

    arrays = _xbd_pair()
    args = types.SimpleNamespace(
        checkpoint_dir=str(tmp_path), max_epochs=1, net_G=net, seed=0,
        bf16=dtype == torch.bfloat16, img_size=XBD_IMG, lr=0.0, batch_size=1)
    trainer = XBDTrainer(args, arrays, arrays, device="cuda")
    batch = [torch.from_numpy(arrays[k]).to(card)
             for k in ("img_pre", "img_post", "msk", "lbl_msk")]
    before = _xbd_counts()
    loss = trainer.train_step(*batch)
    dices, tp, fp, fn = trainer.eval_step(*batch)
    torch.cuda.synchronize()
    c = XBD_CALLS[net]
    assert tuple(a - b for a, b in zip(_xbd_counts(), before)) == (
        c, c, c, 2 * c, 0)
    assert torch.isfinite(loss) and 0 <= dices.item() <= 1
    assert int((tp + fn).sum()) == int(batch[2][..., 0].bool().sum())


@pytest.mark.parametrize("net", list(XBD_CALLS))
def test_xbd_forward_matches_cpu(card, net):
    """The fp32 eval forward on the 6-channel input, card (kernels) against
    the CPU plain path: 1e-3 of the logits' scale, argmax agreement at least
    99.9 %."""
    from dahitra_tpu_torch.data.xbd_augment import augment_xbd
    from dahitra_tpu_torch.models.registry import define_g
    from dahitra_tpu_torch.nn.init import init_random

    gen = torch.Generator().manual_seed(1)
    model = init_random(define_g(net, img_size=XBD_IMG, generator=gen), gen)
    img6 = augment_xbd(*(torch.from_numpy(v) for v in _xbd_pair(2).values()),
                       train=False)[0]
    with torch.inference_mode():
        ref = model(img6)
        got = model.to(card)(img6.to(card)).cpu()
    assert _scaled_err(got, ref) <= 1e-3
    assert (got.argmax(-1) == ref.argmax(-1)).float().mean() >= 0.999


def test_xbd_predict_on_the_card(card, tmp_path):
    """``xbd_predict`` over one tile with a seeded ``xbd_dahitra``
    checkpoint: one forward of the 4 TTA views (3 K1 and 3 K3), both PNGs
    at the tile's size, damage classes in 0..3."""
    import numpy as np
    from PIL import Image

    from dahitra_tpu_torch.cli import xbd_predict
    from dahitra_tpu_torch.core.checkpoint import save_checkpoint
    from dahitra_tpu_torch.data.synthetic import write_synthetic_xbd
    from dahitra_tpu_torch.models.registry import define_g
    from dahitra_tpu_torch.nn.init import init_random

    root = write_synthetic_xbd(str(tmp_path / "test"), 1, XBD_IMG, block=16)
    gen = torch.Generator().manual_seed(3)
    model = init_random(define_g("xbd_dahitra", img_size=XBD_IMG,
                                 generator=gen), gen)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), model.state_dict())
    before = _xbd_counts()
    written = xbd_predict.main(["--test_root", root, "--img_size",
                                str(XBD_IMG), "--checkpoints", ckpt,
                                "--out_dir", str(tmp_path / "out")])
    assert tuple(a - b for a, b in zip(_xbd_counts(), before)) == (
        3, 0, 0, 3, 0)
    pngs = {w: np.array(Image.open(tmp_path / "out" / w)) for w in written}
    assert len(pngs) == 2
    for w, p in pngs.items():
        assert p.shape == (XBD_IMG, XBD_IMG) and p.dtype == np.uint8
        assert w.endswith("_part1.png") or p.max() <= 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xbd_gan_step_launch_counts(card, tmp_path, dtype):
    """``GANTrainer.gan_step`` of ``xbd_dahitra`` on the card: a generator
    step launches 3 K1-save, 3 K2 and 3 K3; with a discriminator update it
    adds the generator's forward without saves, 3 K1 and 3 K3; finite
    losses; the discriminator's BN statistics move only in its update."""
    import types

    from dahitra_tpu_torch.train.xbd_engine import GANTrainer

    arrays = _xbd_pair()
    args = types.SimpleNamespace(
        checkpoint_dir=str(tmp_path), max_epochs=1, net_G="xbd_dahitra",
        seed=0, bf16=dtype == torch.bfloat16, img_size=XBD_IMG, lr=0.0,
        batch_size=1)
    trainer = GANTrainer(args, arrays, arrays, device="cuda")
    batch = [torch.from_numpy(arrays[k]).to(card)
             for k in ("img_pre", "img_post", "msk", "lbl_msk")]
    for update, want in ((False, (0, 3, 3, 3, 0)), (True, (3, 3, 3, 6, 0))):
        stats = [b.clone() for b in trainer.disc.buffers()]
        before = _xbd_counts()
        g, d = trainer.gan_step(*batch, update_disc=update)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_xbd_counts(), before)) == want
        assert torch.isfinite(g) and torch.isfinite(d)
        moved = any(not torch.equal(a, b)
                    for a, b in zip(stats, trainer.disc.buffers()))
        assert moved == update


ZOO_KEYS = ("unet_coupled_trans_256", "unet_coupled_two_trans_256",
            "siamUnet_conc", "changeFormer", "changeFormerV6")


@pytest.mark.parametrize("key", ZOO_KEYS)
def test_zoo_forward_matches_cpu(card, key):
    """The LEVIR zoo keys' fp32 eval forward at 256 px, batch 2 (the
    full-resolution logits of changeFormerV6's list), card against the CPU
    plain path: 1e-3 of the logits' scale, argmax agreement at least
    99.9 %, and no decoder or tokenizer kernel launched."""
    from dahitra_tpu_torch.models.registry import define_g, final_logits
    from dahitra_tpu_torch.nn.init import init_random
    from dahitra_tpu_torch.utils import disable_tf32

    disable_tf32()
    g = torch.Generator().manual_seed(5)
    model = init_random(define_g(key), g)
    a, b = (torch.rand(2, 256, 256, 3, generator=g) * 2 - 1 for _ in "ab")
    before = (fd.launches, fd.launches_save, fd.launches_bwd, ft.launches,
              kd.launches)
    with torch.inference_mode():
        ref = final_logits(model.eval()(a, b))
        got = final_logits(model.to(card)(a.to(card), b.to(card))).cpu()
    torch.cuda.synchronize()
    assert (fd.launches, fd.launches_save, fd.launches_bwd, ft.launches,
            kd.launches) == before
    assert _scaled_err(got, ref) <= 1e-3
    assert (got.argmax(-1) == ref.argmax(-1)).float().mean() >= 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_changeformer_v6_multi_scale_step_on_the_card(card, tmp_path, dtype):
    """One CDTrainer step of changeFormerV6 at 256 px, batch 2, with the
    multi-scale loss and dropout on: a finite loss, and the same bits from
    a second trainer of the same seed (each on a freed card, cuDNN held to
    deterministic algorithms, which otherwise may differ between the two)."""
    import types

    import numpy as np

    from dahitra_tpu_torch.train.engine import CDTrainer

    losses = []
    torch.backends.cudnn.deterministic = True
    for run in range(2):
        torch.cuda.empty_cache()
        args = types.SimpleNamespace(
            n_class=2, checkpoint_dir=str(tmp_path / f"run{run}"), max_epochs=1,
            bf16=dtype == torch.bfloat16, seed=0, net_G="changeFormerV6",
            img_size=256, lr=5e-4, batch_size=2, multi_scale_loss=True)
        empty = {k: np.zeros((0, 1), np.uint8) for k in ("a", "b", "label")}
        trainer = CDTrainer(args, empty, empty, device="cuda")
        g = torch.Generator().manual_seed(1)
        batch = [torch.randint(0, 256, (2, 256, 256, 3), generator=g,
                               dtype=torch.uint8).to(card) for _ in "ab"]
        batch.append(torch.randint(0, 2, (2, 256, 256), generator=g,
                                   dtype=torch.uint8).to(card))
        losses.append(trainer.train_step(*batch)[0].item())
        del trainer
    torch.backends.cudnn.deterministic = False
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
