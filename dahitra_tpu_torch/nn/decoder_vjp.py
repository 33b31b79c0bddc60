"""The cross-attention decoder stack in production "noshift" numerics.

Counterpart of dahitra_tpu/nn/decoder_vjp.py (forward only):
``decoder_stack_plain`` is the plain PyTorch forward of ``_layer_fwd`` /
``_stack_fwd``, and ``decoder_stack`` is the same function through the K1
kernel (kernels/folded_decoder.py). Both take the stacked parameter dict of
``pack_decoder_params`` (dahitra_tpu/pallas/fused_decoder.py:40) in the flax
layout, Linear kernels (in, out).

Per layer: fp32 LayerNorm shared by query and memory (PreNorm2), dots
rounded to ``dtype`` then scaled by dim**-0.5 (the model-dim quirk),
``exp(clip(dots, +-80))`` over each head's token group, and the residual
kept in ``dtype``. The memory side, ``build_az`` (folded_decoder.py:78), is
tiny and stays in PyTorch. The n-chunking of ``decoder_stack_auto`` works
around an XLA limit and has no counterpart; the backward (K2) comes with the
training slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from dahitra_tpu_torch.kernels.folded_decoder import (VEC_KEYS,
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


def _operands(x, m, packed, depth, heads, dtype):
    a, z = build_az(m, packed, depth, heads, dtype)
    vecs = torch.stack([packed[k].float() for k in VEC_KEYS], dim=1)
    return (x.to(dtype).contiguous(), a.contiguous(), z.contiguous(),
            packed["w1"].to(dtype).contiguous(),
            packed["w2"].to(dtype).contiguous(), vecs.contiguous())


def decoder_stack_plain(x: torch.Tensor, m: torch.Tensor, packed: Packed,
                        depth: int, heads: int, dtype) -> torch.Tensor:
    """x: (B, N, dim) queries, m: (B, L, dim) memory tokens -> (B, N, dim)
    in ``dtype``; plain PyTorch on any device."""
    return decoder_stack_fwd_plain(*_operands(x, m, packed, depth, heads, dtype),
                                   depth, heads, dtype)


def decoder_stack(x: torch.Tensor, m: torch.Tensor, packed: Packed,
                  depth: int, heads: int, dtype) -> torch.Tensor:
    """``decoder_stack_plain`` through the K1 kernel on a CUDA tensor."""
    return decoder_stack_fwd(*_operands(x, m, packed, depth, heads, dtype),
                             depth, heads, dtype)
