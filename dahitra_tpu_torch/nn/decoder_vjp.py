"""The cross-attention decoder stack in production "noshift" numerics.

Counterpart of dahitra_tpu/nn/decoder_vjp.py: ``decoder_stack_plain`` is the
plain PyTorch forward of ``_layer_fwd`` / ``_stack_fwd``, and
``decoder_stack`` is the same function through the kernels of
kernels/folded_decoder.py, differentiable as the JAX ``custom_vjp`` is
(``_vjp_fwd`` / ``_vjp_bwd``, in the split of folded_decoder.py ``_fds_bwd``):
``DecoderStack`` is a ``torch.autograd.Function`` over the kernel operands
whose forward is K1 with saves and whose backward is K2. Without a gradient
(``torch.no_grad``, ``inference_mode``) the forward is K1 without saves.
Both take the stacked parameter dict of ``pack_decoder_params``
(dahitra_tpu/pallas/fused_decoder.py:40) in the flax layout, Linear kernels
(in, out).

Per layer: fp32 LayerNorm shared by query and memory (PreNorm2), dots
rounded to ``dtype`` then scaled by dim**-0.5 (the model-dim quirk),
``exp(clip(dots, +-80))`` over each head's token group, and the residual
kept in ``dtype``. The memory side, ``build_az`` (folded_decoder.py:78), and
the ``vecs`` stack are tiny and stay ordinary differentiable PyTorch, so
autograd carries the memory-token chains (dWq, dWk, dWv, dWo, dm) and the
memory side of the LayerNorm-1 gradient into the parameters; K2 returns the
x side of that gradient through ``vecs``, and the two meet in the one
parameter. The n-chunking of ``decoder_stack_auto`` works around an XLA limit
and has no counterpart.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from dahitra_tpu_torch.kernels.folded_decoder import (VEC_KEYS,
                                                      decoder_stack_bwd,
                                                      decoder_stack_fwd,
                                                      decoder_stack_fwd_plain)

Packed = Dict[str, torch.Tensor]


def pack_decoder_params(decoder) -> Packed:
    """Stack a port ``TransformerDecoder``'s per-layer parameters along a
    leading depth axis, in the flax layout of the JAX ``pack_decoder_params``
    (Linear weights transposed to (in, out))."""
    layers = [(layer[0].fn, layer[1].fn) for layer in decoder.layers]

    def stack(fn):
        return torch.stack([fn(att, ff) for att, ff in layers])

    return {
        "ln1_scale": stack(lambda att, ff: att.norm.weight),
        "ln1_bias": stack(lambda att, ff: att.norm.bias),
        "wq": stack(lambda att, ff: att.fn.to_q.weight.t()),
        "wk": stack(lambda att, ff: att.fn.to_k.weight.t()),
        "wv": stack(lambda att, ff: att.fn.to_v.weight.t()),
        "wo": stack(lambda att, ff: att.fn.to_out[0].weight.t()),
        "bo": stack(lambda att, ff: att.fn.to_out[0].bias),
        "ln2_scale": stack(lambda att, ff: ff.norm.weight),
        "ln2_bias": stack(lambda att, ff: ff.norm.bias),
        "w1": stack(lambda att, ff: ff.fn.net[0].weight.t()),
        "b1": stack(lambda att, ff: ff.fn.net[0].bias),
        "w2": stack(lambda att, ff: ff.fn.net[3].weight.t()),
        "b2": stack(lambda att, ff: ff.fn.net[3].bias),
    }


def build_az(m: torch.Tensor, packed: Packed, depth: int, heads: int,
             dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer, per-sample reassociated attention operands
    a = [Wq_h K_h^T]_h: (D, B, dim, hl) and z = [V_h Wo_h]_h: (D, B, hl, dim),
    in ``dtype`` (dahitra_tpu/pallas/folded_decoder.py:78)."""
    b, l, dim = m.shape
    inner = packed["wq"].shape[-1]
    hd = inner // heads
    m32 = m.float()
    mu = m32.mean(-1, keepdim=True)
    rs = torch.rsqrt((m32 - mu).square().mean(-1, keepdim=True) + 1e-5)
    a_list, z_list = [], []
    for d in range(depth):
        mn = ((m32 - mu) * rs * packed["ln1_scale"][d]
              + packed["ln1_bias"][d]).to(dtype)
        kh = (mn @ packed["wk"][d].to(dtype)).view(b, l, heads, hd)
        vh = (mn @ packed["wv"][d].to(dtype)).view(b, l, heads, hd)
        wq = packed["wq"][d].to(dtype).view(dim, heads, hd)
        wo = packed["wo"][d].to(dtype).view(heads, hd, dim)
        a_list.append(torch.einsum("chd,bjhd->bchj", wq, kh)
                      .reshape(b, dim, heads * l))
        z_list.append(torch.einsum("bjhd,hdc->bhjc", vh, wo)
                      .reshape(b, heads * l, dim))
    return torch.stack(a_list), torch.stack(z_list)


def _split_b1(packed: Packed):
    """The feed-forward bias (D, mlp_dim) in fp32 where mlp_dim != dim: it
    does not fit ``vecs`` and travels beside the operands. None otherwise."""
    b1 = packed["b1"]
    return None if b1.shape[-1] == packed["b2"].shape[-1] else b1.float()


def _operands(x, m, packed, depth, heads, dtype, weights_dtype=None):
    """(x, a, z, w1, w2, vecs): the kernel operands, w1 and w2 in
    ``weights_dtype`` (default ``dtype``). Where mlp_dim != dim, row 5 of
    vecs is zero and ``_split_b1`` carries b1."""
    a, z = build_az(m, packed, depth, heads, dtype)
    wide = _split_b1(packed) is not None
    rows = [torch.zeros_like(packed["b2"], dtype=torch.float32)
            if wide and k == "b1" else packed[k].float() for k in VEC_KEYS]
    vecs = torch.stack(rows, dim=1)
    wdt = weights_dtype or dtype
    return (x.to(dtype).contiguous(), a.contiguous(), z.contiguous(),
            packed["w1"].to(wdt).contiguous(),
            packed["w2"].to(wdt).contiguous(), vecs.contiguous())


class DecoderStack(torch.autograd.Function):
    """The stack over its kernel operands (x, a, z, w1, w2, vecs) and b1
    (None unless mlp_dim != dim): forward K1 with saves, backward K2. w1 and
    w2 come in fp32 and are cast to ``dtype`` here, so their fp32 gradients
    reach the parameters unrounded, as in the JAX package."""

    @staticmethod
    def forward(ctx, x, a, z, w1, w2, vecs, b1, depth, heads, dtype):
        w1c, w2c = w1.to(dtype).contiguous(), w2.to(dtype).contiguous()
        y, xsave, attnsave = decoder_stack_fwd(x, a, z, w1c, w2c, vecs, depth,
                                               heads, dtype, save=True, b1=b1)
        ctx.save_for_backward(xsave, attnsave, a, z, w1c, w2c, vecs, b1)
        ctx.meta = (depth, heads, dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        depth, heads, dtype = ctx.meta
        xsave, attnsave, a, z, w1c, w2c, vecs, b1 = ctx.saved_tensors
        dx, da, dz, dw1, dw2, dvecs, *db1 = decoder_stack_bwd(
            xsave, attnsave, dy.to(dtype).contiguous(), a, z, w1c, w2c, vecs,
            depth, heads, dtype, b1=b1)
        return (dx, da, dz, dw1, dw2, dvecs, db1[0] if db1 else None, None,
                None, None)


def decoder_stack_plain(x: torch.Tensor, m: torch.Tensor, packed: Packed,
                        depth: int, heads: int, dtype) -> torch.Tensor:
    """x: (B, N, dim) queries, m: (B, L, dim) memory tokens -> (B, N, dim)
    in ``dtype``; plain PyTorch on any device."""
    return decoder_stack_fwd_plain(*_operands(x, m, packed, depth, heads, dtype),
                                   depth, heads, dtype, b1=_split_b1(packed))


def decoder_stack(x: torch.Tensor, m: torch.Tensor, packed: Packed,
                  depth: int, heads: int, dtype) -> torch.Tensor:
    """``decoder_stack_plain`` through the kernels on a CUDA tensor (their
    plain versions on the CPU). When a gradient is needed this is
    ``DecoderStack`` (K1 with saves, then K2); otherwise K1 without saves."""
    ops = _operands(x, m, packed, depth, heads, dtype,
                    weights_dtype=torch.float32)
    b1 = _split_b1(packed)
    if torch.is_grad_enabled() and (any(t.requires_grad for t in ops)
                                    or (b1 is not None and b1.requires_grad)):
        return DecoderStack.apply(*ops, b1, depth, heads, dtype)
    x, a, z, w1, w2, vecs = ops
    return decoder_stack_fwd(x, a, z, w1.to(dtype), w2.to(dtype), vecs, depth,
                             heads, dtype, b1=b1)
