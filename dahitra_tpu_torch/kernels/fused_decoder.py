"""K4: the fused cross-attention decoder stack (``TransformerDecoder(pallas=
True)``) as a hand-written CUDA kernel for Hopper.

Replaces dahitra_tpu/pallas/fused_decoder.py ``_decoder_kernel`` (via
``fused_transformer_decoder``), the forward of ``make_fused_decoder``. Its
numerics differ from K1's (kernels/folded_decoder.py) at almost every step:

* every product rounds only its operands, to bf16 unless ``precise``, and
  accumulates in fp32 (``_make_mm``); ``precise`` is the module's dtype
  being fp32;
* the residual stream is fp32 through every layer; the output is cast to
  x's dtype, and x comes in as it is (fp32 in DAHiTra's bf16 model, where
  the decoder positional embedding promotes it);
* the softmax is shifted by each head group's max, so it is exact (no
  clamp);
* LayerNorm is two-pass; GELU uses the Abramowitz-Stegun 7.1.26 erf;
* the memory side (LN1(m), k, v, A = [Wq_h K_h^T], Z = [V_h Wo_h]) is
  computed per layer and sample inside the kernel, from the packed weights.

``fused_decoder_plain`` is that function in plain PyTorch, at the kernel's
rounding points; the tests and ``chip_smoke.py`` hold the kernel against it.

The backward is the JAX package's rule as it is: autodiff of
``plain_decoder_stack`` (fused_decoder.py:181-218, one-pass clamped variance
LayerNorm, heads-split attention, casts to ``dtype``), recomputed from the
saved inputs. It is plain JAX in the reference, so it is plain PyTorch here
(``FusedDecoderFn``), not a kernel port.

Source: ``csrc/fused_decoder.cu``. Bound on this card: operations, as K1
(~8 kFLOP per 32-wide row per layer at hl = 32 against 256 bytes per row for
the whole stack in fp32), plus a memory side of ~0.4 MFLOP per sample and
layer at DAHiTra's 1/4 scale. Design: a prologue kernel, grid (depth, B),
computes A and Z once per layer and sample into a scratch buffer, reading the
weights from global memory (L2); the row kernel has K1's layout (one warp
per row, lane = channel, A, Z, W1, W2 staged per layer in shared memory)
and keeps each row's fp32 residual in registers through all layers. The
products run on the fp32 FMA pipe.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from dahitra_tpu_torch.kernels import _build
from dahitra_tpu_torch.kernels.folded_decoder import VEC_KEYS

# Launches of the CUDA kernel in this process (one per call: the prologue
# and the row kernel); the plain version never counts.
launches = 0

# The 13 packed tensors in the order of fused_decoder.py:270-271.
ORDER = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo", "bo", "ln2_scale",
         "ln2_bias", "w1", "b1", "w2", "b2")
_DIM = 32
_MAX_HL = 128
_SMEM_LIMIT = 227 * 1024
_IO = {torch.float32: "f32", torch.bfloat16: "bf16"}
# fused_decoder.py:69-71, Abramowitz & Stegun 7.1.26.
_ERF_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_ERF_P = 0.3275911
_SQRT2_F32 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))

Packed = Dict[str, torch.Tensor]


def pick_tile(n: int) -> Optional[int]:
    """Largest row tile of the TPU kernel dividing n (None = the JAX module
    does not take the fused path); fused_decoder.py:247-252. Only the gate
    reads it: the CUDA kernel takes any n."""
    for t in (512, 256, 128):
        if n % t == 0:
            return t
    return None


def _erf_as(x: torch.Tensor) -> torch.Tensor:
    a1, a2, a3, a4, a5 = _ERF_A
    ax = x.abs()
    t = 1.0 / (1.0 + _ERF_P * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _gelu_as(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + _erf_as(x / _SQRT2_F32))


def _layer_norm(x, scale, bias):
    """Two-pass fp32 LayerNorm (fused_decoder.py:84-87)."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale + bias


def fused_decoder_plain(x: torch.Tensor, m: torch.Tensor, packed: Packed,
                        depth: int, heads: int, precise: bool) -> torch.Tensor:
    """K4's function in plain PyTorch (fused_decoder.py:126-178): x (B, N,
    dim), m (B, L, dim), ``packed`` as ``pack_decoder_params`` gives it ->
    (B, N, dim) in x's dtype. Each product is round(a) . round(b) with fp32
    accumulation, round being bf16 unless ``precise``."""
    op = torch.float32 if precise else torch.bfloat16

    def rnd(t):
        return t.to(op).float()

    def mm(a, b):
        return torch.matmul(rnd(a), rnd(b))

    out_dtype = x.dtype
    x, m = x.float(), m.float()
    b, l, dim = m.shape
    scale = dim ** -0.5
    p = {k: v.float() for k, v in packed.items()}
    inner = p["wq"].shape[-1]
    hd = inner // heads
    for d in range(depth):
        xn = _layer_norm(x, p["ln1_scale"][d], p["ln1_bias"][d])
        mn = _layer_norm(m, p["ln1_scale"][d], p["ln1_bias"][d])
        k = mm(mn, p["wk"][d]).view(b, l, heads, hd)
        v = mm(mn, p["wv"][d]).view(b, l, heads, hd)
        # A = [Wq_h K_h^T]_h (B, dim, hl), Z = [V_h Wo_h]_h (B, hl, dim)
        af = torch.einsum("che,bjhe->bchj",
                          rnd(p["wq"][d]).view(dim, heads, hd),
                          rnd(k)).reshape(b, dim, heads * l)
        zm = torch.einsum("bjhe,hec->bhjc", rnd(v),
                          rnd(p["wo"][d]).view(heads, hd, dim)
                          ).reshape(b, heads * l, dim)
        dots = (mm(xn, af) * scale).unflatten(-1, (heads, l))
        e = torch.exp(dots - dots.amax(-1, keepdim=True))
        attn = (e / e.sum(-1, keepdim=True)).flatten(-2)
        x = x + mm(attn, zm) + p["bo"][d]
        xn2 = _layer_norm(x, p["ln2_scale"][d], p["ln2_bias"][d])
        h = _gelu_as(mm(xn2, p["w1"][d]) + p["b1"][d])
        x = x + mm(h, p["w2"][d]) + p["b2"][d]
    return x.to(out_dtype)


def plain_decoder_stack(x: torch.Tensor, m: torch.Tensor, packed: Packed,
                        depth: int, heads: int, dtype) -> torch.Tensor:
    """Op-for-op port of fused_decoder.py:181-218, the function whose
    autodiff is K4's backward: one-pass clamped-variance fp32 LayerNorm,
    heads-split attention with an fp32 softmax, products in ``dtype``. The
    residual adds follow type promotion (an fp32 x stays fp32)."""
    scale = x.shape[-1] ** -0.5

    def ln(t, s, b):
        tf = t.float()
        mu = tf.mean(-1, keepdim=True)
        var = ((tf * tf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        return (tf - mu) * torch.rsqrt(var + 1e-5) * s + b

    def heads_split(t):
        b, n, hd = t.shape
        return t.view(b, n, heads, hd // heads).transpose(1, 2)

    for d in range(depth):
        w = {k: v[d].to(dtype) for k, v in packed.items()
             if k not in ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")}
        xn = ln(x, packed["ln1_scale"][d], packed["ln1_bias"][d]).to(dtype)
        mn = ln(m, packed["ln1_scale"][d], packed["ln1_bias"][d]).to(dtype)
        q = heads_split(xn @ w["wq"])
        k = heads_split(mn @ w["wk"])
        v = heads_split(mn @ w["wv"])
        dots = torch.einsum("bhid,bhjd->bhij", q, k).float() * scale
        attn = torch.softmax(dots, dim=-1).to(dtype)
        ctx = torch.einsum("bhij,bhjd->bhid", attn, v)
        bb, hh, nn_, dd = ctx.shape
        ctx = ctx.transpose(1, 2).reshape(bb, nn_, hh * dd)
        x = x + ctx @ w["wo"] + w["bo"]
        xn2 = ln(x, packed["ln2_scale"][d], packed["ln2_bias"][d]).to(dtype)
        h = F.gelu(xn2 @ w["w1"] + w["b1"])
        x = x + h @ w["w2"] + w["b2"]
    return x


def _fn(io_dtype, precise: bool):
    name = f"fused_decoder_{_IO[io_dtype]}_{'precise' if precise else 'bf16ops'}"
    fn = getattr(_build.load("fused_decoder"), name)
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_transformer_decoder(x: torch.Tensor, m: torch.Tensor, packed: Packed,
                              depth: int, heads: int,
                              precise: bool) -> torch.Tensor:
    """The decoder stack over ``depth`` layers with K4's numerics.

    x: (B, N, 32) in float32 or bfloat16; m: (B, L, 32) in any float type;
    ``packed``: the 13 stacked parameters of ``pack_decoder_params`` (any
    float type, read as fp32), inner width heads * dim_head, mlp_dim 32,
    heads * L <= 128. Returns (B, N, 32) in x's dtype. CPU tensors take
    ``fused_decoder_plain`` (any mlp_dim); CUDA tensors launch the kernel or
    raise.
    """
    global launches
    if x.device.type == "cpu":
        return fused_decoder_plain(x, m, packed, depth, heads, precise)
    if packed["w1"].shape[-1] != _DIM:
        raise ValueError("fused_transformer_decoder: mlp_dim = "
                         f"{packed['w1'].shape[-1]}; the kernel instance for "
                         f"mlp_dim != {_DIM} is not built yet (the plain "
                         "version runs on CPU tensors only)")
    ts = (x, m, *(packed[k] for k in ORDER))
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError("fused_transformer_decoder: all operands must be on "
                         f"one CUDA device, got {[str(t.device) for t in ts]}")
    if x.dtype not in _IO:
        raise TypeError(f"fused_transformer_decoder: x is {x.dtype}; need "
                        "float32 or bfloat16")
    b, n, dim = x.shape
    l = m.shape[1]
    hl = heads * l
    inner = packed["wq"].shape[-1]
    shapes_ok = (dim == _DIM and m.shape == (b, l, _DIM) and hl <= _MAX_HL
                 and inner % heads == 0
                 and all(packed[k].shape == (depth, _DIM, inner)
                         for k in ("wq", "wk", "wv"))
                 and packed["wo"].shape == (depth, inner, _DIM)
                 and packed["w1"].shape == packed["w2"].shape
                 == (depth, _DIM, _DIM)
                 and all(packed[k].shape == (depth, _DIM) for k in VEC_KEYS))
    smem = 4 * (l * _DIM + 2 * l * inner)
    if not shapes_ok or smem > _SMEM_LIMIT:
        raise ValueError("fused_transformer_decoder: need dim = mlp_dim = "
                         f"{_DIM}, heads * tokens <= {_MAX_HL} and "
                         f"{smem} <= {_SMEM_LIMIT} bytes of memory-side "
                         f"shared memory, got x {tuple(x.shape)}, m "
                         f"{tuple(m.shape)}, heads {heads}, "
                         f"{ {k: tuple(v.shape) for k, v in packed.items()} }")
    w = [packed[k].float().contiguous() for k in ("wq", "wk", "wv", "wo",
                                                  "w1", "w2")]
    vecs = torch.stack([packed[k].float() for k in VEC_KEYS], 1).contiguous()
    xc, mc = x.contiguous(), m.float().contiguous()
    a = torch.empty((depth, b, _DIM, hl), dtype=torch.float32, device=x.device)
    z = torch.empty((depth, b, hl, _DIM), dtype=torch.float32, device=x.device)
    y = torch.empty_like(xc)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _fn(x.dtype, precise)(
        *[t.data_ptr() for t in (xc, mc, *w, vecs, a, z, y)],
        b, n, depth, l, heads, inner, smem, stream)
    _build.check(status, "fused_transformer_decoder")
    launches += 1
    return y


class FusedDecoderFn(torch.autograd.Function):
    """``make_fused_decoder`` (fused_decoder.py:221-244): forward
    ``fused_transformer_decoder`` with ``precise = dtype is fp32``, backward
    the autodiff of ``plain_decoder_stack`` in ``dtype``, recomputed from
    the saved x, m and packed tensors. Called as
    ``apply(depth, heads, dtype, x, m, *packed)`` with the packed tensors in
    ``ORDER``; gradients reach x, m and all 13 packed tensors."""

    @staticmethod
    def forward(ctx, depth, heads, dtype, x, m, *packed):
        ctx.save_for_backward(x, m, *packed)
        ctx.meta = (depth, heads, dtype)
        return fused_transformer_decoder(x, m, dict(zip(ORDER, packed)), depth,
                                         heads, dtype == torch.float32)

    @staticmethod
    def backward(ctx, g):
        depth, heads, dtype = ctx.meta
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = plain_decoder_stack(leaves[0], leaves[1],
                                    dict(zip(ORDER, leaves[2:])), depth,
                                    heads, dtype)
            grads = torch.autograd.grad(y, leaves, g.to(y.dtype))
        return (None, None, None, *grads)
