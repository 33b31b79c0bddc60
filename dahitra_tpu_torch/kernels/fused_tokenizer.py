"""K3: the semantic tokenizer as a hand-written CUDA kernel for Hopper.

Replaces dahitra_tpu/pallas/fused_tokenizer.py ``_tokenizer_kernel``
(via ``fused_semantic_tokenizer``), the function the flax
``SemanticTokenizer`` computes (dahitra_tpu/nn/blocks.py:626-646):

    logits = x @ w                   (B, N, L), rounded to T
    attn   = softmax over N, fp32    rounded to T
    tokens = attn^T @ x              (B, L, C)

Source: ``csrc/tokenizer.cu``. Bound on this card: bytes (about 4 FLOP per
byte of x in fp32). Design: one 1024-thread CTA per sample, x read twice,
logits kept in shared memory, warp partials summed in a fixed order. Known
limit: B CTAs only (16 at eval batch 8); splitting N across CTAs is later
work, and needed for xBD's N = 65536.

``SemanticTokenizerFn`` makes it differentiable: its forward is the kernel
(the plain version on the CPU) and its backward is PyTorch operations. The
JAX package has no backward kernel for the tokenizer (XLA differentiates
``SemanticTokenizer``, dahitra_tpu/nn/blocks.py:638-646), so the backward is
not a kernel port: it recomputes the logits and the fp32 softmax from the
saved x and w and rounds where XLA's autodiff rounds.
"""
from __future__ import annotations

import ctypes

import torch

from dahitra_tpu_torch.kernels import _build

# Launches of the CUDA kernel in this process; the plain version never counts.
launches = 0

_MAX_L = 16
_C = 32
_SMEM_LIMIT = 220 * 1024  # dynamic shared memory the kernel may ask for
_FNS = {torch.float32: "semantic_tokenizer_f32",
        torch.bfloat16: "semantic_tokenizer_bf16"}


def semantic_tokenizer_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, N, C), w: (C, L), both in the compute dtype -> (B, L, C)."""
    logits = torch.matmul(x, w)
    attn = torch.softmax(logits.float(), dim=1).to(x.dtype)
    return torch.einsum("bnl,bnc->blc", attn, x)


def _smem_bytes(n: int, l: int) -> int:
    return 4 * max(n * l, 32 * l * _C)


def _fn(dtype):
    fn = getattr(_build.load("tokenizer"), _FNS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def semantic_tokenizer(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Semantic tokens of x (B, N, C) under w (C, L); returns (B, L, C) in
    x's dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    global launches
    if x.device.type == "cpu":
        return semantic_tokenizer_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"semantic_tokenizer: x on {x.device}, w on {w.device}")
    if x.dtype not in _FNS or w.dtype != x.dtype:
        raise TypeError(f"semantic_tokenizer: dtypes {x.dtype}, {w.dtype}; "
                        "need both float32 or both bfloat16")
    if x.dim() != 3 or w.dim() != 2 or x.shape[-1] != _C or w.shape[0] != _C:
        raise ValueError(f"semantic_tokenizer: shapes {tuple(x.shape)}, "
                         f"{tuple(w.shape)}; need (B, N, 32) and (32, L)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("semantic_tokenizer: inputs must be contiguous")
    b, n, c = x.shape
    l = w.shape[1]
    smem = _smem_bytes(n, l)
    if l > _MAX_L or smem > _SMEM_LIMIT:
        raise ValueError(f"semantic_tokenizer: L={l}, N={n} need {smem} bytes "
                         f"of shared memory (limit {_SMEM_LIMIT}, L <= {_MAX_L})")
    out = torch.empty((b, l, c), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _fn(x.dtype)(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                          b, n, l, smem, stream)
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
