"""K4: the fused cross-attention decoder stack (``TransformerDecoder(pallas=
True)``) as hand-written CUDA kernels for Hopper.

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
rounding points, and ``fused_decoder_az_plain`` its memory side alone (A and
Z, which ``fused_decoder_plain`` takes from it); the tests and
``chip_smoke.py`` hold the kernels against them, the prologue alone through
``fused_decoder_az``.

The backward is the JAX package's rule as it is: autodiff of
``plain_decoder_stack`` (fused_decoder.py:181-218, one-pass clamped variance
LayerNorm, heads-split attention, casts to ``dtype``), recomputed from the
saved inputs. It is plain JAX in the reference, so it is plain PyTorch here
(``FusedDecoderFn``), not a kernel port.

Source: ``csrc/fused_decoder.cu``, with the fragment code of
``csrc/decoder_mma.cuh``. Bound on this card: operations (~9.8 kFLOP per
32-wide row per layer at hl = 32, the four products and the elementwise
work, against 256 bytes per row for the whole stack in fp32 I/O); the memory
side adds ~0.4 MFLOP per sample and layer, under 1 % of it. Design: two
kernels on one stream. The prologue, grid (depth, heads, ceil(B / 4)),
stages one head's slices of Wq, Wk, Wv and Wo in shared memory and writes
that head's columns of A and rows of Z for 4 samples, in fp32, to a scratch
buffer. The row kernel is K1's template (``csrc/decoder_fwd.cu``): a warp
per 16 rows held in registers through all layers, the four per-row products
on ``mma.sync`` tensor cores with fp32 accumulation, bf16 operands or, when
``precise``, each fp32 operand split exactly into three bf16 pieces; the
group softmax shifted by its max inside the quad of lanes that holds a row.
The kernels take every count of memory tokens the JAX gate sends (heads *
tokens <= 128) and mlp_dim 32 or 64 (BIT's decoder: the row kernel's 64
instance runs the hidden layer in two 32-column halves, with b1 (D, 64)
beside ``vecs``); on a CUDA tensor anything else raises. A group of 1, 2,
4, 8 or 16 tokens lies in one 16-column slice of hl; other counts are
padded here with zero memory tokens to the next of those, or above 16 to a
multiple of 16 (``_group``), and the row kernel gets the real count and sets
the padded columns' logits to -inf. The plain version runs the same padding
on the CPU.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from dahitra_tpu_torch.kernels import _build
from dahitra_tpu_torch.kernels.folded_decoder import _MLP, VEC_KEYS

# Launches in this process; the plain versions never count. ``launches``:
# ``fused_transformer_decoder``, one per call (the prologue and the row
# kernel); ``launches_az``: ``fused_decoder_az``, the prologue alone;
# ``launches_pad``: those of ``launches`` at a token count the row kernel
# does not take as it is (padded here, or above 16: its PAD instances).
launches = 0
launches_az = 0
launches_pad = 0

# The 13 packed tensors in the order of fused_decoder.py:270-271.
ORDER = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo", "bo", "ln2_scale",
         "ln2_bias", "w1", "b1", "w2", "b2")
_DIM = 32
_MAX_HL = 128
_SMEM_LIMIT = 227 * 1024
# csrc/fused_decoder.cu: memory tokens per prologue pass (PRO_ROWS).
_PRO_ROWS = 16
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


def _rounding(precise: bool):
    """``_make_mm``: (rnd, mm), rnd rounding to the operand type (bf16, or
    fp32 when ``precise``) and mm a product of rounded operands with fp32
    accumulation."""
    op = torch.float32 if precise else torch.bfloat16

    def rnd(t):
        return t.to(op).float()

    def mm(a, b):
        return torch.matmul(rnd(a), rnd(b))

    return rnd, mm


def fused_decoder_az_plain(m: torch.Tensor, packed: Packed, depth: int,
                           heads: int, precise: bool):
    """K4's memory side in plain PyTorch (fused_decoder.py:136-148): per
    layer d and sample, A = [Wq_h k_h^T]_h (32, heads * L) and Z = [v_h
    Wo_h]_h (heads * L, 32) from k, v = LN1(m) Wk, LN1(m) Wv, each product
    rounding its operands. m: (B, L, dim). Returns A (D, B, dim, hl) and Z
    (D, B, hl, dim) in fp32, unrounded."""
    rnd, mm = _rounding(precise)
    m = m.float()
    b, l, dim = m.shape
    p = {k: packed[k].float() for k in ("ln1_scale", "ln1_bias", "wq", "wk",
                                        "wv", "wo")}
    hd = p["wq"].shape[-1] // heads
    a_s, z_s = [], []
    for d in range(depth):
        mn = _layer_norm(m, p["ln1_scale"][d], p["ln1_bias"][d])
        k = mm(mn, p["wk"][d]).view(b, l, heads, hd)
        v = mm(mn, p["wv"][d]).view(b, l, heads, hd)
        a_s.append(torch.einsum("che,bjhe->bchj",
                                rnd(p["wq"][d]).view(dim, heads, hd),
                                rnd(k)).reshape(b, dim, heads * l))
        z_s.append(torch.einsum("bjhe,hec->bhjc", rnd(v),
                                rnd(p["wo"][d]).view(heads, hd, dim)
                                ).reshape(b, heads * l, dim))
    return torch.stack(a_s), torch.stack(z_s)


def fused_decoder_plain(x: torch.Tensor, m: torch.Tensor, packed: Packed,
                        depth: int, heads: int, precise: bool,
                        tokens: Optional[int] = None) -> torch.Tensor:
    """K4's function in plain PyTorch (fused_decoder.py:126-178): x (B, N,
    dim), m (B, L, dim), ``packed`` as ``pack_decoder_params`` gives it ->
    (B, N, dim) in x's dtype. Each product is round(a) . round(b) with fp32
    accumulation, round being bf16 unless ``precise``. ``tokens``: m is
    padded and its first ``tokens`` rows are tokens; the others' logits are
    -inf, as in the row kernel's PAD instance."""
    _, mm = _rounding(precise)
    out_dtype = x.dtype
    x = x.float()
    scale = x.shape[-1] ** -0.5
    l = m.shape[1]
    a, z = fused_decoder_az_plain(m, packed, depth, heads, precise)
    p = {k: v.float() for k, v in packed.items()}
    for d in range(depth):
        xn = _layer_norm(x, p["ln1_scale"][d], p["ln1_bias"][d])
        dots = (mm(xn, a[d]) * scale).unflatten(-1, (heads, l))
        if tokens is not None:
            dots = dots.masked_fill(torch.arange(l, device=dots.device) >= tokens,
                                      -math.inf)
        e = torch.exp(dots - dots.amax(-1, keepdim=True))
        attn = (e / e.sum(-1, keepdim=True)).flatten(-2)
        x = x + mm(attn, z[d]) + p["bo"][d]
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


def _ops(precise: bool) -> str:
    return "precise" if precise else "bf16ops"


def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(_build.load("fused_decoder"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _prologue_smem(hd: int) -> int:
    """Shared-memory bytes of the prologue (csrc/fused_decoder.cu
    ``pro_smem_floats``): one head's Wq^T (rows padded by one), Wk, Wv and
    Wo slices, and LN1(m), k_h and v_h of ``_PRO_ROWS`` tokens."""
    return 4 * (hd * (_DIM + 1) + 3 * _DIM * hd + _PRO_ROWS * (_DIM + 2 * hd))


def _rows_smem(hl: int, precise: bool, mlp: int) -> int:
    """Shared-memory bytes of the row kernel (``rows_smem_bytes``): A, Z, W1
    and W2 as one bf16 plane, or three when ``precise``, hl padded to 16 and
    rows padded by 8; the seven fp32 vectors, and b1 where mlp_dim != 32."""
    hlp = -(-hl // 16) * 16
    plane = _DIM * (hlp + 8) + hlp * (_DIM + 8) + _DIM * (mlp + 8) \
        + mlp * (_DIM + 8)
    return 2 * (3 if precise else 1) * plane \
        + 4 * (7 * _DIM + (mlp if mlp != _DIM else 0))


def _group(l: int) -> int:
    """Memory tokens that the row kernel runs for ``l``: the next of 1, 2,
    4, 8 and 16, or above 16 the next multiple of 16."""
    return 1 << (l - 1).bit_length() if l <= 16 else -(-l // 16) * 16


def _check(what: str, ts, m: torch.Tensor, packed: Packed, depth: int,
           heads: int, precise: bool, tokens: Optional[int] = None) -> None:
    """Raise unless the tensors ``ts`` lie on one CUDA device and the shapes
    are ones the kernels take; ``tokens``: the real count of m's (padded)
    tokens."""
    mlp = packed["w1"].shape[-1]
    if mlp not in _MLP:
        raise ValueError(f"{what}: mlp_dim = {mlp}; the kernels are built for "
                         f"mlp_dim in {_MLP} (the plain version runs on CPU "
                         "tensors only)")
    if ts[0].device.type != "cuda" or any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{what}: all operands must be on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    b, l = m.shape[:2]
    real = l if tokens is None else tokens
    if heads * real > _MAX_HL:
        raise ValueError(f"{what}: the kernels take heads * tokens <= "
                         f"{_MAX_HL}, got {real} tokens per head at {heads} "
                         "heads")
    inner = packed["wq"].shape[-1]
    shapes_ok = (m.shape == (b, l, _DIM) and inner % heads == 0
                 and all(packed[k].shape == (depth, _DIM, inner)
                         for k in ("wq", "wk", "wv"))
                 and packed["wo"].shape == (depth, inner, _DIM)
                 and packed["w1"].shape == (depth, _DIM, mlp)
                 and packed["w2"].shape == (depth, mlp, _DIM)
                 and packed["b1"].shape == (depth, mlp)
                 and all(packed[k].shape == (depth, _DIM)
                         for k in VEC_KEYS if k != "b1"))
    smem = max(_prologue_smem(inner // heads),
               _rows_smem(heads * l, precise, mlp))
    if not shapes_ok or smem > _SMEM_LIMIT:
        raise ValueError(f"{what}: need dim = {_DIM}, mlp_dim in {_MLP} and "
                         f"{smem} <= {_SMEM_LIMIT} bytes of shared memory per "
                         "CTA, got "
                         f"m {tuple(m.shape)}, heads {heads}, "
                         f"{ {k: tuple(v.shape) for k, v in packed.items()} }")


def _vecs(packed: Packed) -> torch.Tensor:
    """The (D, 7, 32) fp32 vectors in ``VEC_KEYS`` order; b1's row is zero
    where mlp_dim != 32 (``_b1`` carries it)."""
    wide = packed["b1"].shape[-1] != _DIM
    return torch.stack([torch.zeros_like(packed["b2"], dtype=torch.float32)
                        if wide and k == "b1" else packed[k].float()
                        for k in VEC_KEYS], 1).contiguous()


def _b1(packed: Packed) -> Optional[torch.Tensor]:
    """b1 (D, mlp_dim) fp32 where mlp_dim != 32, else None (it is in
    ``_vecs``)."""
    b1 = packed["b1"]
    return None if b1.shape[-1] == _DIM else b1.float().contiguous()


def _prologue(m, packed, vecs, depth: int, heads: int, precise: bool):
    """Launches the prologue: A (D, B, 32, hl) and Z (D, B, hl, 32), fp32."""
    b, l, _ = m.shape
    hl = heads * l
    mc = m.float().contiguous()
    w = [packed[k].float().contiguous() for k in ("wq", "wk", "wv", "wo")]
    a = torch.empty((depth, b, _DIM, hl), dtype=torch.float32, device=m.device)
    z = torch.empty((depth, b, hl, _DIM), dtype=torch.float32, device=m.device)
    status = _fn(f"fused_decoder_az_{_ops(precise)}", 8, 5)(
        *[t.data_ptr() for t in (mc, *w, vecs, a, z)], b, depth, l, heads,
        w[0].shape[-1], torch.cuda.current_stream(m.device).cuda_stream)
    _build.check(status, "fused_decoder prologue")
    return a, z


def _rows(x, a, z, packed, vecs, depth: int, heads: int, precise: bool,
          tokens: int):
    """Launches the row kernel on the prologue's A and Z, whose groups hold
    ``tokens`` tokens each, padded or not: y like x."""
    b, n, _ = x.shape
    hl = a.shape[-1]
    xc = x.contiguous()
    w1, w2 = (packed[k].float().contiguous() for k in ("w1", "w2"))
    b1 = _b1(packed)
    y = torch.empty_like(xc)
    status = _fn(f"fused_decoder_{_IO[x.dtype]}_{_ops(precise)}", 8, 7)(
        *[None if t is None else t.data_ptr()
          for t in (xc, a, z, w1, w2, vecs, b1, y)], b, n, depth, hl,
        hl // heads, tokens, w1.shape[-1],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "fused_decoder rows")
    return y


def fused_decoder_az(m: torch.Tensor, packed: Packed, depth: int, heads: int,
                     precise: bool):
    """The prologue alone: (A, Z) as ``fused_decoder_az_plain`` returns
    them. CPU tensors take that plain version; CUDA tensors launch the
    prologue kernel or raise."""
    global launches_az
    if m.device.type == "cpu":
        return fused_decoder_az_plain(m, packed, depth, heads, precise)
    _check("fused_decoder_az", (m, *(packed[k] for k in ORDER)), m, packed,
           depth, heads, precise)
    out = _prologue(m, packed, _vecs(packed), depth, heads, precise)
    launches_az += 1
    return out


def fused_transformer_decoder(x: torch.Tensor, m: torch.Tensor, packed: Packed,
                              depth: int, heads: int,
                              precise: bool) -> torch.Tensor:
    """The decoder stack over ``depth`` layers with K4's numerics.

    x: (B, N, 32) in float32 or bfloat16; m: (B, L, 32) in any float type;
    ``packed``: the 13 stacked parameters of ``pack_decoder_params`` (any
    float type, read as fp32), inner width heads * dim_head, mlp_dim 32 or
    64 and heads * L <= 128; L other than 1, 2, 4, 8 and 16 runs padded
    (module docstring). Returns (B, N, 32) in x's dtype. CPU tensors take
    ``fused_decoder_plain`` (any shape); CUDA tensors launch the prologue
    and the row kernel or raise.
    """
    global launches, launches_pad
    tokens = m.shape[1]
    lp = _group(tokens)
    if lp != tokens and heads * tokens <= _MAX_HL:
        m = torch.cat([m, m.new_zeros(m.shape[0], lp - tokens, m.shape[2])], 1)
    if x.device.type == "cpu":
        return fused_decoder_plain(x, m, packed, depth, heads, precise,
                                   tokens if m.shape[1] != tokens else None)
    _check("fused_transformer_decoder", (x, m, *(packed[k] for k in ORDER)), m,
           packed, depth, heads, precise, tokens)
    if x.dtype not in _IO:
        raise TypeError(f"fused_transformer_decoder: x is {x.dtype}; need "
                        "float32 or bfloat16")
    if x.dim() != 3 or x.shape[0] != m.shape[0] or x.shape[-1] != _DIM:
        raise ValueError("fused_transformer_decoder: need x (B, N, "
                         f"{_DIM}) beside m {tuple(m.shape)}, got "
                         f"{tuple(x.shape)}")
    vecs = _vecs(packed)
    a, z = _prologue(m, packed, vecs, depth, heads, precise)
    y = _rows(x, a, z, packed, vecs, depth, heads, precise, tokens)
    launches += 1
    launches_pad += m.shape[1] != tokens or tokens > 16
    return y


def ctas_per_sm(io_dtype, precise: bool, mlp: int, hl: int,
                pad: bool = False) -> int:
    """CTAs of the row kernel instance (x's dtype, ``precise``, mlp_dim,
    ``pad`` for the PAD one) that one SM holds at once at this hl, as the
    CUDA occupancy calculator counts them (registers and shared memory
    decide)."""
    per_sm = ctypes.c_int(0)
    fn = getattr(_build.load("fused_decoder"),
                 f"fused_decoder_ctas_per_sm_{_IO[io_dtype]}_{_ops(precise)}")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(hl, mlp, int(pad), ctypes.byref(per_sm)),
                 "fused_decoder occupancy")
    return per_sm.value


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
