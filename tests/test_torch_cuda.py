"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips when no CUDA card is present. This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances, scale-normalized: fp32 1e-4 (summation order), bf16 2e-2.
"""
import pytest
import torch

from dahitra_tpu_torch.kernels import folded_decoder as fd
from dahitra_tpu_torch.kernels import fused_tokenizer as ft
from dahitra_tpu_torch.nn.blocks import TransformerDecoder
from dahitra_tpu_torch.nn.decoder_vjp import _operands, pack_decoder_params

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,l", [(2, 4096, 4), (3, 1000, 16), (1, 64, 1)])
def test_tokenizer_kernel_matches_plain(card, dtype, b, n, l):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, n, 32, generator=g).to(card, dtype)
    w = (torch.randn(32, l, generator=g) * 32 ** -0.5).to(card, dtype)
    before = ft.launches
    got = ft.semantic_tokenizer(x, w)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    assert _scaled_err(got, ft.semantic_tokenizer_plain(x, w)) <= TOL[dtype]


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.randn(2, 64, 16, device=card)
    with pytest.raises(ValueError):
        ft.semantic_tokenizer(x, torch.randn(16, 4, device=card))
    with pytest.raises(TypeError):
        ft.semantic_tokenizer(torch.randn(2, 64, 32, device=card).half(),
                              torch.randn(32, 4, device=card).half())
