"""K3: the semantic tokenizer as a hand-written CUDA kernel for Hopper.

Replaces dahitra_tpu/pallas/fused_tokenizer.py ``_tokenizer_kernel``
(via ``fused_semantic_tokenizer``), the function the flax
``SemanticTokenizer`` computes (dahitra_tpu/nn/blocks.py:626-646):

    logits = x @ w                   (B, N, L), rounded to T
    attn   = softmax over N, fp32    rounded to T
    tokens = attn^T @ x              (B, L, C)

Source: ``csrc/tokenizer.cu``. Bound on this card: bytes (about 4 FLOP per
byte of x in fp32), and at the model's sizes the latency of a launch. Design:
the N pixels are split into chunks, one 128-thread CTA per (sample, chunk),
so that the grid covers the card about twice and no shared-memory size grows
with N. Two launches per call: the first writes each chunk's per-token
maximum and exp-sum; the second combines them in index order into the
sample's M and S, pools rnd(exp(l - M) / S) * x over its chunk, and the last
CTA of a sample to finish sums the partial tokens in index order.
``semantic_tokenizer_split_plain`` is that algorithm step by step in PyTorch.

``SemanticTokenizerFn`` makes it differentiable: its forward is the kernel
(the plain version on the CPU) and its backward is PyTorch operations. The
JAX package has no backward kernel for the tokenizer (XLA differentiates
``SemanticTokenizer``, dahitra_tpu/nn/blocks.py:638-646), so the backward is
not a kernel port: it recomputes the logits and the fp32 softmax from the
saved x and w and rounds where XLA's autodiff rounds.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dahitra_tpu_torch.kernels import _build

# Launches of the CUDA kernel in this process; the plain version never counts.
launches = 0

_MAX_L = 16
_C = 32
_TILE = 128  # pixels per tile = threads per CTA (csrc/tokenizer.cu TILE)
_FNS = {torch.float32: "semantic_tokenizer_f32",
        torch.bfloat16: "semantic_tokenizer_bf16"}


def semantic_tokenizer_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, N, C), w: (C, L), both in the compute dtype -> (B, L, C)."""
    logits = torch.matmul(x, w)
    attn = torch.softmax(logits.float(), dim=1).to(x.dtype)
    return torch.einsum("bnl,bnc->blc", attn, x)


def semantic_tokenizer_split_plain(x: torch.Tensor, w: torch.Tensor,
                                   chunk: int) -> torch.Tensor:
    """``semantic_tokenizer_plain`` by the kernel's algorithm, with the N
    pixels split into chunks of ``chunk`` (the last may be shorter): per
    chunk and token the maximum m_c and s_c = sum exp(l - m_c); combined in
    index order into M = max m_c and S = sum s_c * exp(m_c - M); per chunk
    the fp32 partial tokens of rnd(exp(l - M) / S); summed in index order and
    stored as x's dtype."""
    logits = torch.matmul(x, w).float().split(chunk, dim=1)
    m_c = [lg.amax(1) for lg in logits]                       # each (B, L)
    s_c = [torch.exp(lg - m[:, None]).sum(1) for lg, m in zip(logits, m_c)]
    big_m = m_c[0]
    for m in m_c[1:]:
        big_m = torch.maximum(big_m, m)
    big_s = torch.zeros_like(big_m)
    for m, s in zip(m_c, s_c):
        big_s = big_s + s * torch.exp(m - big_m)
    tokens = 0.0
    for lg, xc in zip(logits, x.split(chunk, dim=1)):
        attn = (torch.exp(lg - big_m[:, None]) / big_s[:, None]).to(x.dtype)
        tokens = tokens + torch.einsum("bnl,bnc->blc", attn.float(), xc.float())
    return tokens.to(x.dtype)


def _chunk(b: int, n: int, n_sm: int) -> int:
    """Pixels per CTA: a multiple of the kernel's 128-pixel tile, chosen so
    that about two CTAs run per SM where N allows."""
    tiles = -(-n // _TILE)
    per_sample = max(1, min(tiles, -(-2 * n_sm // b)))
    return -(-tiles // per_sample) * _TILE


@functools.lru_cache(maxsize=None)
def _n_sm(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _fn(dtype):
    fn = getattr(_build.load("tokenizer"), _FNS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def semantic_tokenizer(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Semantic tokens of x (B, N, C) under w (C, L); returns (B, L, C) in
    x's dtype, for any N. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise. One call counts one launch, though it starts
    two kernels."""
    global launches
    if x.device.type == "cpu":
        return semantic_tokenizer_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"semantic_tokenizer: x on {x.device}, w on {w.device}")
    if x.dtype not in _FNS or w.dtype != x.dtype:
        raise TypeError(f"semantic_tokenizer: dtypes {x.dtype}, {w.dtype}; "
                        "need both float32 or both bfloat16")
    if x.dim() != 3 or w.dim() != 2 or x.shape[-1] != _C or w.shape[0] != _C \
            or not 1 <= w.shape[1] <= _MAX_L or 0 in x.shape:
        raise ValueError(f"semantic_tokenizer: shapes {tuple(x.shape)}, "
                         f"{tuple(w.shape)}; need (B, N, 32) and (32, L), "
                         f"1 <= L <= {_MAX_L}")
    if not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError("semantic_tokenizer: inputs must be contiguous and "
                         "x aligned to 16 bytes")
    b, n, c = x.shape
    l = w.shape[1]
    chunk = _chunk(b, n, _n_sm(x.device.index))
    ctas = b * -(-n // chunk)
    out = torch.empty((b, l, c), dtype=x.dtype, device=x.device)
    # chunk statistics, partial tokens and a ticket per sample
    scratch = torch.empty(ctas * l * (2 + c) + b, dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _fn(x.dtype)(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                          scratch.data_ptr(), b, n, l, chunk, stream)
    _build.check(status, "semantic_tokenizer")
    launches += 1
    return out


class SemanticTokenizerFn(torch.autograd.Function):
    """``semantic_tokenizer`` with its gradient. Backward, from the saved
    x (B, N, C) and w (C, L) in the compute dtype T:

        attn32 = softmax_N(rnd(x . w)),  attn = rnd(attn32)
        dattn  = rnd(dtokens . x^T)
        dlogits = rnd(attn32 * (dattn - sum_N(attn32 * dattn)))
        dx = rnd(rnd(attn . dtokens) + rnd(dlogits . w^T))
        dw = rnd(sum_{B,N} x^T . dlogits)
    """

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return semantic_tokenizer(x, w)

    @staticmethod
    def backward(ctx, dtokens):
        x, w = ctx.saved_tensors
        dtokens = dtokens.to(x.dtype)
        attn32 = torch.softmax(torch.matmul(x, w).float(), dim=1)
        attn = attn32.to(x.dtype)
        dattn = torch.einsum("blc,bnc->bnl", dtokens, x).float()
        dlogits = (attn32 * (dattn - (attn32 * dattn).sum(1, keepdim=True))
                   ).to(x.dtype)
        dx = (torch.einsum("bnl,blc->bnc", attn, dtokens)
              + torch.matmul(dlogits, w.t()))
        dw = torch.einsum("bnc,bnl->cl", x, dlogits)
        return dx, dw
