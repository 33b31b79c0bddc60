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

Split over the space ranks of a row-sharded grid (``nn/space.py``), each
rank holding some of a sample's pixels, ``semantic_tokenizer_ranks`` keeps
that design: the statistics launch on the rank's pixels; one gather of the
(B, chunks, L, 2) statistics over the space group; the pool launch, whose
prologue combines every rank's statistics in (rank, chunk) order, the same
on every rank, so that every rank has the same M and S bits, on the rank's
pixels, writing fp32 partial tokens; one gather of the partial tokens and
their sum in rank order, then the cast to T. Every rank gets the same
tokens, bit for bit (the replicated encoder behind them would otherwise
drift apart). ``semantic_tokenizer_ranks_plain`` is that algorithm step by
step in PyTorch, with the ranks as the outer chunks; the CPU runs it, one
chunk a rank. ``SemanticTokenizerRanksFn`` is its gradient: the global M
and S saved from the forward, the incoming token gradients (each rank's
holds its rows' share) summed over the space group, and sum_N(attn32 *
dattn) all-reduced there; dw stays partial for DDP to sum.

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
from typing import List, Sequence, Tuple

import torch

from dahitra_tpu_torch.core.mesh import gather_parts, reduce_sum_
from dahitra_tpu_torch.kernels import _build

# Launches of the CUDA kernel in this process, by the one-process entry
# point (``semantic_tokenizer``) and by the rank-split one
# (``semantic_tokenizer_ranks``); the plain versions never count.
launches = 0
launches_ranks = 0

_MAX_L = 16
_C = 32
_TILE = 128  # pixels per tile = threads per CTA (csrc/tokenizer.cu TILE)
_FNS = {torch.float32: "semantic_tokenizer_f32",
        torch.bfloat16: "semantic_tokenizer_bf16"}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def semantic_tokenizer_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, N, C), w: (C, L), both in the compute dtype -> (B, L, C)."""
    logits = torch.matmul(x, w)
    attn = torch.softmax(logits.float(), dim=1).to(x.dtype)
    return torch.einsum("bnl,bnc->blc", attn, x)


def chunk_stats_plain(x: torch.Tensor, w: torch.Tensor,
                      chunk: int) -> torch.Tensor:
    """The kernel's first pass: per chunk of ``chunk`` pixels (the last may
    be shorter) and token, the maximum m_c of the logits and s_c = sum
    exp(l - m_c); (B, chunks, L, 2) fp32."""
    stats = []
    for lg in torch.matmul(x, w).float().split(chunk, dim=1):
        m = lg.amax(1)                                         # (B, L)
        stats.append(torch.stack([m, torch.exp(lg - m[:, None]).sum(1)], -1))
    return torch.stack(stats, 1)


def combine_stats_plain(stats: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n, L, 2) statistics combined in index order: M = max m_c and
    S = sum s_c * exp(m_c - M), each (B, L)."""
    big_m = stats[:, 0, :, 0]
    for i in range(1, stats.shape[1]):
        big_m = torch.maximum(big_m, stats[:, i, :, 0])
    big_s = torch.zeros_like(big_m)
    for i in range(stats.shape[1]):
        big_s = big_s + stats[:, i, :, 1] * torch.exp(stats[:, i, :, 0] - big_m)
    return big_m, big_s


def pool_plain(x: torch.Tensor, w: torch.Tensor, big_m: torch.Tensor,
               big_s: torch.Tensor, chunk: int) -> torch.Tensor:
    """The kernel's second pass: per chunk the fp32 partial tokens of
    rnd(exp(l - M) / S) . x, summed in index order; (B, L, C) fp32."""
    logits = torch.matmul(x, w).float().split(chunk, dim=1)
    tokens = torch.zeros(x.shape[0], w.shape[1], x.shape[2],
                         dtype=torch.float32, device=x.device)
    for lg, xc in zip(logits, x.split(chunk, dim=1)):
        attn = (torch.exp(lg - big_m[:, None]) / big_s[:, None]).to(x.dtype)
        tokens = tokens + torch.einsum("bnl,bnc->blc", attn.float(), xc.float())
    return tokens


def semantic_tokenizer_ranks_plain(xs: Sequence[torch.Tensor],
                                   w: torch.Tensor, chunk: int
                                   ) -> torch.Tensor:
    """``semantic_tokenizer_plain`` of the pixels of every rank ``xs`` (each
    (B, N_r, C), in rank order) by the rank-split kernel's algorithm: each
    rank's chunk statistics (``chunk_stats_plain``), combined in (rank,
    chunk) order; each rank's fp32 partial tokens (``pool_plain``), summed
    in rank order and stored as the pixels' dtype."""
    stats = torch.cat([chunk_stats_plain(x, w, chunk) for x in xs], 1)
    big_m, big_s = combine_stats_plain(stats)
    tokens = pool_plain(xs[0], w, big_m, big_s, chunk)
    for x in xs[1:]:
        tokens = tokens + pool_plain(x, w, big_m, big_s, chunk)
    return tokens.to(xs[0].dtype)


def semantic_tokenizer_split_plain(x: torch.Tensor, w: torch.Tensor,
                                   chunk: int) -> torch.Tensor:
    """``semantic_tokenizer_plain`` by the kernel's algorithm, with the N
    pixels split into chunks of ``chunk`` (the last may be shorter): per
    chunk and token the maximum m_c and s_c = sum exp(l - m_c); combined in
    index order into M = max m_c and S = sum s_c * exp(m_c - M); per chunk
    the fp32 partial tokens of rnd(exp(l - M) / S); summed in index order and
    stored as x's dtype (``semantic_tokenizer_ranks_plain`` of one rank)."""
    return semantic_tokenizer_ranks_plain([x], w, chunk)


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


@functools.lru_cache(maxsize=None)
def _split_fns(dtype):
    """The rank-split entry points: (statistics pass, pool pass)."""
    lib = _build.load("tokenizer")
    stats = getattr(lib, f"semantic_tokenizer_stats_{_SUFFIX[dtype]}")
    stats.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    pool = getattr(lib, f"semantic_tokenizer_pool_{_SUFFIX[dtype]}")
    pool.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    stats.restype = pool.restype = ctypes.c_int
    return stats, pool


def _check_operands(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{what}: x on {x.device}, w on {w.device}")
    if x.dtype not in _FNS or w.dtype != x.dtype:
        raise TypeError(f"{what}: dtypes {x.dtype}, {w.dtype}; "
                        "need both float32 or both bfloat16")
    if x.dim() != 3 or w.dim() != 2 or x.shape[-1] != _C or w.shape[0] != _C \
            or not 1 <= w.shape[1] <= _MAX_L or 0 in x.shape:
        raise ValueError(f"{what}: shapes {tuple(x.shape)}, "
                         f"{tuple(w.shape)}; need (B, N, 32) and (32, L), "
                         f"1 <= L <= {_MAX_L}")
    if not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError(f"{what}: inputs must be contiguous and "
                         "x aligned to 16 bytes")


def _scratch(b: int, n: int, l: int, chunk: int, device) -> torch.Tensor:
    """Chunk statistics, partial tokens and a ticket per sample."""
    ctas = b * -(-n // chunk)
    return torch.empty(ctas * l * (2 + _C) + b, dtype=torch.float32,
                       device=device)


def semantic_tokenizer(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Semantic tokens of x (B, N, C) under w (C, L); returns (B, L, C) in
    x's dtype, for any N. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise. One call counts one launch, though it starts
    two kernels."""
    global launches
    if x.device.type == "cpu":
        return semantic_tokenizer_plain(x, w)
    _check_operands(x, w, "semantic_tokenizer")
    b, n, c = x.shape
    l = w.shape[1]
    chunk = _chunk(b, n, _n_sm(x.device.index))
    out = torch.empty((b, l, c), dtype=x.dtype, device=x.device)
    scratch = _scratch(b, n, l, chunk, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):  # the launch's device
        status = _fn(x.dtype)(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), b, n, l, chunk, stream)
    _build.check(status, "semantic_tokenizer")
    launches += 1
    return out


def ranks_stats(x: torch.Tensor, w: torch.Tensor, chunk: int,
                scratch: torch.Tensor) -> torch.Tensor:
    """The rank-split K3's first launch on this rank's pixels x (B, N_r,
    C): its chunks' statistics, a (B, chunks, L, 2) view of ``scratch``."""
    b, n, _ = x.shape
    l = w.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = _split_fns(x.dtype)[0](x.data_ptr(), w.data_ptr(),
                                        scratch.data_ptr(), b, n, l, chunk,
                                        stream)
    _build.check(status, "semantic_tokenizer_ranks (statistics)")
    return scratch[:b * -(-n // chunk) * l * 2].view(b, -1, l, 2)


def ranks_pool(x: torch.Tensor, w: torch.Tensor, stats: torch.Tensor,
               chunk: int, scratch: torch.Tensor):
    """The rank-split K3's second launch, after ``ranks_stats`` on the same
    ``scratch``: every rank's statistics ``stats`` (B, ranks * chunks, L, 2)
    combined in that order, this rank's fp32 partial tokens (B, L, C) and
    the combined M and S (B, L, 2)."""
    b, n, c = x.shape
    l = w.shape[1]
    stats = stats.contiguous()
    part = torch.empty((b, l, c), dtype=torch.float32, device=x.device)
    ms = torch.empty((b, l, 2), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = _split_fns(x.dtype)[1](
            x.data_ptr(), w.data_ptr(), stats.data_ptr(), stats.shape[1],
            part.data_ptr(), ms.data_ptr(), scratch.data_ptr(), b, n, l,
            chunk, stream)
    _build.check(status, "semantic_tokenizer_ranks (pool)")
    return part, ms


def sum_in_order(parts: List[torch.Tensor]) -> torch.Tensor:
    """The ranks' partial tokens summed in rank order."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def semantic_tokenizer_ranks(x: torch.Tensor, w: torch.Tensor, group):
    """Semantic tokens of the pixels of every rank of ``group`` (the space
    group of a row-sharded grid; x (B, N_r, C) this rank's, equal N_r on
    every rank), under w (C, L): (tokens (B, L, C) in x's dtype, the same
    bits on every rank; M, S (B, L) fp32). CPU tensors take the plain
    version, one chunk a rank; CUDA tensors launch the kernel or raise. One
    call counts one launch (``launches_ranks``), though it starts two
    kernels."""
    global launches_ranks
    if x.device.type == "cpu":
        chunk = x.shape[1]
        stats = torch.cat(gather_parts(chunk_stats_plain(x, w, chunk),
                                       group), 1)
        big_m, big_s = combine_stats_plain(stats)
        part = pool_plain(x, w, big_m, big_s, chunk)
    else:
        _check_operands(x, w, "semantic_tokenizer_ranks")
        b, n, _ = x.shape
        chunk = _chunk(b, n, _n_sm(x.device.index))
        scratch = _scratch(b, n, w.shape[1], chunk, x.device)
        stats = ranks_stats(x, w, chunk, scratch)
        part, ms = ranks_pool(x, w, torch.cat(gather_parts(stats, group), 1),
                              chunk, scratch)
        big_m, big_s = ms.unbind(-1)
        launches_ranks += 1
    return sum_in_order(gather_parts(part, group)).to(x.dtype), big_m, big_s


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


class SemanticTokenizerRanksFn(torch.autograd.Function):
    """``semantic_tokenizer_ranks`` with its gradient, on this rank's pixels
    x (B, N_r, C) and w (C, L) over the space ``group``. Backward, with the
    forward's global M and S and T the compute dtype:

        dtokens = rnd(sum over the group of the incoming dtokens)
        attn32 = exp(rnd(x . w) - M) / S,  attn = rnd(attn32)
        dattn  = rnd(dtokens . x^T)
        dlogits = rnd(attn32 * (dattn - sum over the group of
                                 sum_N(attn32 * dattn)))
        dx = rnd(rnd(attn . dtokens) + rnd(dlogits . w^T))
        dw = rnd(sum_{B,N} x^T . dlogits), this rank's pixels only
    """

    @staticmethod
    def forward(ctx, x, w, group):
        tokens, big_m, big_s = semantic_tokenizer_ranks(x, w, group)
        ctx.save_for_backward(x, w, big_m, big_s)
        ctx.group = group
        return tokens

    @staticmethod
    def backward(ctx, dtokens):
        x, w, big_m, big_s = ctx.saved_tensors
        dtokens = reduce_sum_(dtokens.float().contiguous(), ctx.group
                              ).to(x.dtype)
        attn32 = (torch.exp(torch.matmul(x, w).float() - big_m[:, None])
                  / big_s[:, None])
        attn = attn32.to(x.dtype)
        dattn = torch.einsum("blc,bnc->bnl", dtokens, x).float()
        red = reduce_sum_((attn32 * dattn).sum(1, keepdim=True), ctx.group)
        dlogits = (attn32 * (dattn - red)).to(x.dtype)
        dx = (torch.einsum("bnl,blc->bnc", attn, dtokens)
              + torch.matmul(dlogits, w.t()))
        dw = torch.einsum("bnc,bnl->cl", x, dlogits)
        return dx, dw, None
