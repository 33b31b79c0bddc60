"""K1 and K2: the cross-attention decoder stack, forward and backward, as
hand-written CUDA kernels for Hopper.

* K1, ``decoder_stack_fwd``, replaces dahitra_tpu/pallas/folded_decoder.py
  ``_fwd_kernel`` (via ``folded_decoder_fwd``): the production "noshift"
  forward of dahitra_tpu/nn/decoder_vjp.py ``_layer_fwd`` over the whole
  depth. With ``save=True`` (training) it also writes each layer's input
  ``x_in`` (D, B, N, 32) and attention (D, B, N, hl) in ``dtype``, as
  ``_fwd_kernel(save=True)`` does, and counts in ``launches_save`` instead
  of ``launches``; its ``y`` is the same bit for bit.
* K2, ``decoder_stack_bwd``, replaces ``_bwd_kernel`` (via
  ``_folded_bwd_call`` and ``_fds_bwd``): the reverse pass over every layer,
  from the saves, with the numerics of decoder_vjp ``_layer_bwd``.

The memory-token side (``build_az`` in nn/decoder_vjp.py) is computed
outside, as in the JAX package; the kernels consume the per-sample
A (D, B, 32, hl) and Z (D, B, hl, 32).

Sources: ``csrc/decoder_fwd.cu``, ``csrc/decoder_bwd.cu`` and the fragment
code they share, ``csrc/decoder_mma.cuh``. Bound on this card: operations
(K1 ~8 kFLOP, K2 ~20 kFLOP per 32-wide row per layer at hl = 32, against
2 * (32 + hl) bytes of saves per row and layer in bf16). Design: both run
their per-row products on tensor cores (``mma.sync`` bf16, a warp per 16
rows, each product's accumulators packed into the next one's A fragment);
in fp32 each operand is split exactly into three bf16 pieces and a product
is six piece products. K1 keeps the rows in registers across all layers
and stages each layer's weights once per 128-row CTA; K2 runs its four
weight-side sums on tensor cores too, writes per-CTA weight-gradient
partials and sums them in a second, fixed-order pass. A softmax group lies
in one 16-column slice of hl: the kernels take 1, 2, 4, 8 or 16 tokens per
head (DAHiTra has 4, BIT 4 or 8) and an even hl. Every other count the JAX
gate sends (up to 16 tokens per head, heads * tokens <= 128) is padded here
(``_padding``): each head's group of l tokens widened to the next count they
take, A's columns and Z's rows with zeros, the attention save with zeros for
K2; an odd hl (one token at an odd number of heads) gains one zero head
instead, whose softmax is its own and whose Z rows are zero (hl + 1, where
doubling every group would run 2 * hl). K1 gets the real
count and zeroes the padded columns' exp terms (its softmax clamps, so a
zero logit would add exp(0) = 1); K2 needs no mask, since its dl is attn
times a factor and the padded attention is 0. The padded columns of dA
and dZ are sliced off again, and of the attention save where the caller
reads it (``DecoderStack`` hands it to K2 padded). The plain versions run the
same padding on the CPU. Padded, the gate's counts reach hl 224 (14 heads
of 9 tokens); K1's instances take any hl up to 256 as they are, K2 runs its
WIDE instances where fp32 64-row tiles would not fit (csrc/decoder_bwd.cu).
On a CUDA tensor a padded hl above 256 raises.

The kernels are built for ``dim`` = 32 and ``mlp_dim`` 32 (DAHiTra), with
the feed-forward bias ``b1`` as row 5 of ``vecs``, or 64 (BIT's decoder,
``mlp_dim = 2 * dim``), with w1 (D, 32, 64), w2 (D, 64, 32) and ``b1``
(D, 64) fp32 as an argument of its own (row 5 of ``vecs`` is then unused;
K2 returns db1 (D, 64) as a seventh value). The 64 instances run the hidden
layer in two 32-column halves on the 32 instances' tiles. The plain versions
take any ``mlp_dim``; on a CUDA tensor any width but 32 and 64 raises.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from dahitra_tpu_torch.kernels import _build

# Launches of the CUDA kernels in this process; the plain versions never
# count. ``launches``: K1 without saves; ``launches_save``: K1 with saves;
# ``launches_bwd``: K2. The ``_pad`` counts are those of the three among
# them at a token count the tiles do not hold as it is (padded here, or 16
# tokens per head: the PAD instances).
launches = 0
launches_save = 0
launches_bwd = 0
launches_pad = 0
launches_save_pad = 0
launches_bwd_pad = 0

_DIM = 32
# Hidden widths (mlp_dim) with a kernel instance.
_MLP = (32, 64)
_MAX_HL = 256
_CLAMP = 80.0  # dahitra_tpu/nn/decoder_vjp.py _NOSHIFT_CLAMP
# Rows per K2 CTA tile, both dtypes (csrc/decoder_bwd.cu: 4 warps of 16
# rows; the WIDE instances' 2-warp tiles of 32 rows divide it).
_BWD_TILE = 64
# Tokens per head that K1 and K2 take: a softmax group lies inside one
# 16-column slice of hl (16 in the kernels' PAD instances).
_MMA_L = (1, 2, 4, 8, 16)
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# Rows of vecs: per-layer vectors in this order.
VEC_KEYS = ("ln1_scale", "ln1_bias", "bo", "ln2_scale", "ln2_bias", "b1", "b2")


def _acc(dtype):
    """Accumulation type: fp32, or float64 for float64 inputs (the
    exact-arithmetic check of the backward)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _ln_stats(x):
    """decoder_vjp._ln_stats: mean and rsqrt(var + eps), two-pass."""
    mu = x.mean(-1, keepdim=True)
    return mu, torch.rsqrt((x - mu).square().mean(-1, keepdim=True) + 1e-5)


def _ln_bwd(dg, xhat, rs, scale):
    """decoder_vjp._ln_bwd: (dx, dscale, dbias), sums over the rows."""
    dxh = dg * scale
    dx = rs * (dxh - dxh.mean(-1, keepdim=True)
               - xhat * (dxh * xhat).mean(-1, keepdim=True))
    return dx, (dg * xhat).sum((0, 1)), dg.sum((0, 1))


def _gelu_grad(t):
    cdf = 0.5 * (1.0 + torch.erf(t * 0.5 ** 0.5))
    return cdf + t * torch.exp(-0.5 * t * t) / math.sqrt(2.0 * math.pi)


def _group_sum(v, heads):
    b, n, hl = v.shape
    return v.view(b, n, heads, hl // heads).sum(-1, keepdim=True) \
        .expand(b, n, heads, hl // heads).reshape(b, n, hl)


def decoder_stack_fwd_plain(x, a, z, w1, w2, vecs, depth: int, heads: int,
                            dtype, save: bool = False, b1=None, tokens=None):
    """The kernel's function in plain PyTorch, rounding to ``dtype`` where
    decoder_vjp._layer_fwd rounds. Shapes as in ``decoder_stack_fwd``; with
    ``save``, returns (y, xsave, attnsave) as the kernel does. ``b1``
    (D, mlp_dim) replaces row 5 of ``vecs`` where mlp_dim != 32. ``tokens``:
    the groups are padded and their first ``tokens`` columns are tokens; the
    others' exp terms are zeroed, as K1's PAD instance zeroes them."""
    acc = _acc(dtype)
    b, n, dim = x.shape
    scale = dim ** -0.5
    xs, ats = [], []
    for d in range(depth):
        ln1s, ln1b, bo, ln2s, ln2b, b1d, b2 = vecs[d]
        if b1 is not None:
            b1d = b1[d]
        mu, rs = _ln_stats(x.to(acc))
        hn = ((x.to(acc) - mu) * rs * ln1s + ln1b).to(dtype)
        dots = torch.matmul(hn, a[d]).to(acc) * scale
        e = torch.exp(dots.clamp(-_CLAMP, _CLAMP))
        if tokens is not None:
            e = e * _token_mask(e.shape[-1], heads, tokens, e.device)
        attn = (e / _group_sum(e, heads)).to(dtype)
        if save:
            xs.append(x)
            ats.append(attn)
        x1 = x + torch.matmul(attn, z[d]) + bo.to(dtype)
        mu1, rs1 = _ln_stats(x1.to(acc))
        g = ((x1.to(acc) - mu1) * rs1 * ln2s + ln2b).to(dtype)
        t = torch.matmul(g, w1[d]) + b1d.to(dtype)
        h = F.gelu(t.to(acc)).to(dtype)
        x = x1 + torch.matmul(h, w2[d]) + b2.to(dtype)
    if save:
        return x, torch.stack(xs), torch.stack(ats)
    return x


def decoder_stack_bwd_plain(xsave, attnsave, dy, a, z, w1, w2, vecs,
                            depth: int, heads: int, dtype, b1=None):
    """K2's function in plain PyTorch: decoder_vjp._layer_bwd / _vjp_bwd on
    the kernel operands, rounding where they round. Returns
    (dx, da, dz, dw1, dw2, dvecs) as ``decoder_stack_bwd`` does; the ln1 rows
    of dvecs are the x side only. With ``b1`` (D, mlp_dim) given, row 5 of
    dvecs is zero and db1 (D, mlp_dim) is returned as a seventh value."""
    acc = _acc(dtype)
    dim = dy.shape[-1]
    scale = dim ** -0.5
    dy = dy.to(dtype)
    da, dz, dw1, dw2, dvecs, db1 = [], [], [], [], [], []
    for d in range(depth - 1, -1, -1):
        ln1s, ln1b, bo, ln2s, ln2b, b1d, b2 = vecs[d]
        if b1 is not None:
            b1d = b1[d]
        x, attn = xsave[d], attnsave[d]
        # recompute (the forward's operations)
        mu, rs = _ln_stats(x.to(acc))
        xhat = (x.to(acc) - mu) * rs
        hn = (xhat * ln1s + ln1b).to(dtype)
        x1 = x + torch.matmul(attn, z[d]) + bo.to(dtype)
        mu1, rs1 = _ln_stats(x1.to(acc))
        xhat1 = (x1.to(acc) - mu1) * rs1
        g = (xhat1 * ln2s + ln2b).to(dtype)
        t = (torch.matmul(g, w1[d]) + b1d.to(dtype)).to(acc)
        hg = F.gelu(t).to(dtype)
        # feed-forward backward
        dw2.append(torch.einsum("bnm,bnc->mc", hg.to(acc), dy.to(acc)))
        db2 = dy.to(acc).sum((0, 1))
        dt32 = torch.matmul(dy, w2[d].t()).to(acc) * _gelu_grad(t)
        dt = dt32.to(dtype)
        dw1.append(torch.einsum("bnc,bnm->cm", g.to(acc), dt.to(acc)))
        dg = torch.matmul(dt, w1[d].t()).to(acc)
        dx1_ln, dls2, dlb2 = _ln_bwd(dg, xhat1, rs1, ln2s)
        dx1 = dy + dx1_ln.to(dtype)
        dbo = dx1.to(acc).sum((0, 1))
        # attention backward: the group softmax in fp32
        a32 = attn.to(acc)
        dattn = torch.matmul(dx1, z[d].transpose(-1, -2)).to(acc)
        dl = (a32 * (dattn - _group_sum(a32 * dattn, heads)) * scale).to(dtype)
        dhn = torch.matmul(dl, a[d].transpose(-1, -2)).to(acc)
        da.append(torch.einsum("bnc,bnj->bcj", hn.to(acc), dl.to(acc)).to(dtype))
        dz.append(torch.einsum("bnj,bnc->bjc", a32, dx1.to(acc)).to(dtype))
        dx_ln, dls1, dlb1 = _ln_bwd(dhn, xhat, rs, ln1s)
        dy = dx1 + dx_ln.to(dtype)
        db1.append(dt32.sum((0, 1)))
        dvecs.append(torch.stack([dls1, dlb1, dbo, dls2, dlb2,
                                  db1[-1] if b1 is None
                                  else torch.zeros_like(db2), db2]))
    rev = lambda ts: torch.stack(ts[::-1])  # noqa: E731
    out = (dy, rev(da), rev(dz), rev(dw1), rev(dw2), rev(dvecs))
    return out if b1 is None else (*out, rev(db1))


def _token_mask(hl, heads, tokens, device):
    """1 at the first ``tokens`` columns of each head's group of hl // heads,
    0 at the padded ones."""
    return (torch.arange(hl, device=device) % (hl // heads) < tokens).float()


def _widen(t, heads: int, l: int, lp: int, axis: int, hk: int):
    """Each head's group of ``l`` entries along ``axis`` (-1: columns, -2:
    rows) widened to ``lp`` with zeros, then ``hk - heads`` zero heads of
    ``lp`` appended."""
    shape = list(t.shape)
    grouped = t.reshape(*shape[:len(shape) + axis], heads, l,
                        *shape[len(shape) + axis + 1:])
    after = [0, 0] * (-axis - 1)
    grouped = F.pad(grouped, after + [0, lp - l, 0, hk - heads])
    shape[axis] = hk * lp
    return grouped.reshape(shape).contiguous()


def _narrow(t, heads: int, l: int, lp: int, axis: int):
    """``_widen`` undone: the first ``l`` of each of the first ``heads``
    groups of ``lp`` entries."""
    shape = list(t.shape)
    t = t.narrow(axis, 0, heads * lp)
    grouped = t.reshape(*shape[:len(shape) + axis], heads, lp,
                        *shape[len(shape) + axis + 1:])
    shape[axis] = heads * l
    return grouped.narrow(axis, 0, l).reshape(shape).contiguous()


def _padding(what, hl: int, heads: int, cuda: bool):
    """(hk, l, lp): the heads the kernels run, the tokens per head and the
    group width they run them as: ``l`` itself where the tiles hold it, else
    the next power of two; an odd hl (one token at odd heads) runs one zero
    head more. On a CUDA tensor a count the kernels cannot take even padded
    (more than 16 tokens per head, or a padded hl above ``_MAX_HL``) raises;
    the plain version takes it unpadded (hk, l, l)."""
    l = hl // heads
    lp = 1 << (l - 1).bit_length()
    hk = heads + (heads * lp) % 2
    ok = hl % heads == 0 and lp in _MMA_L and hk * lp <= _MAX_HL
    if cuda and not ok:
        raise ValueError(f"{what}: the kernels take {_MMA_L} tokens per head "
                         f"(other counts padded to the next of them, an odd "
                         f"hl with one zero head more) and a padded hl = "
                         f"heads * tokens <= {_MAX_HL}, got hl {hl}, heads "
                         f"{heads}: padded hl {hk * lp}")
    return (hk, l, lp) if ok else (heads, l, l)


def _fn(lib, name, dtype, n_ptr, n_int):
    fn = getattr(_build.load(lib), f"{name}_{_DTYPES[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(what, tensors, dtype, heads, hl, shapes_ok):
    """Raise unless every operand is a contiguous tensor on one CUDA device
    with the kernel's dtypes and shapes. The last tensor is vecs (fp32)."""
    if tensors[0].device.type != "cuda" \
            or any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{what}: all operands must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if dtype not in _DTYPES or any(t.dtype != dtype for t in tensors[:-1]) \
            or tensors[-1].dtype != torch.float32:
        raise TypeError(f"{what}: need the activations and weights in {dtype} "
                        "(float32 or bfloat16) and vecs in float32, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    if not shapes_ok or hl > _MAX_HL or hl % heads:
        raise ValueError(f"{what}: need dim = {_DIM}, mlp_dim in {_MLP}, "
                         f"hl = heads * tokens <= {_MAX_HL} and the shapes "
                         "of the docstring, got "
                         f"{[tuple(t.shape) for t in tensors]}, heads {heads}")


def _mlp_dim(what, w1, b1, depth) -> int:
    """The hidden width of the call, one the kernels are built for: 32 with
    b1 in vecs, or 64 with b1 (D, 64) fp32 beside it. Off the CPU any other
    width raises (the plain version never runs there)."""
    mlp = w1.shape[-1]
    if mlp not in _MLP:
        raise ValueError(f"{what}: mlp_dim = {mlp}; the kernels are built "
                         f"for mlp_dim in {_MLP} (the plain version runs on "
                         "CPU tensors only)")
    wide = mlp != _DIM
    if (b1 is not None) != wide or wide and (
            b1.shape != (depth, mlp) or b1.dtype != torch.float32
            or not b1.is_contiguous() or b1.device != w1.device):
        got = None if b1 is None else (tuple(b1.shape), b1.dtype)
        raise ValueError(f"{what}: at mlp_dim {mlp} b1 must be "
                         + (f"a contiguous float32 ({depth}, {mlp}) tensor "
                            "beside the operands" if wide else
                            "row 5 of vecs (no b1 argument)") + f", got {got}")
    return mlp


def decoder_stack_fwd(x, a, z, w1, w2, vecs, depth: int, heads: int, dtype,
                      save: bool = False, b1=None, narrow_save: bool = True):
    """Decoder-stack forward over ``depth`` layers.

    x: (B, N, 32); a: (D, B, 32, hl); z: (D, B, hl, 32); w1: (D, 32, mlp)
    and w2: (D, mlp, 32) laid out (in, out), all in ``dtype``; vecs: (D, 7,
    32) fp32 rows in ``VEC_KEYS`` order; b1: None at mlp_dim 32 (it is row 5
    of vecs), else (D, mlp) fp32. Returns y (B, N, 32) in ``dtype``, or with
    ``save`` (y, xsave (D, B, N, 32), attnsave (D, B, N, hl)). CPU tensors
    take the plain version (any mlp_dim); CUDA tensors launch the kernel
    (mlp_dim 32 or 64) or raise. Token counts the kernel does not take run
    padded (module docstring), on both; ``narrow_save`` False leaves a
    padded attnsave at the padded hl, as ``decoder_stack_bwd`` takes it.
    """
    hl = a.shape[-1]
    hk, l, lp = _padding("decoder_stack_fwd", hl, heads,
                         x.device.type != "cpu")
    if (hk, lp) == (heads, l):
        return _fwd(x, a, z, w1, w2, vecs, depth, heads, dtype, save, b1, l,
                    False)
    out = _fwd(x, _widen(a, heads, l, lp, -1, hk),
               _widen(z, heads, l, lp, -2, hk), w1, w2, vecs, depth, hk,
               dtype, save, b1, l, True)
    if save and narrow_save:
        return out[0], out[1], _narrow(out[2], heads, l, lp, -1)
    return out


def _fwd(x, a, z, w1, w2, vecs, depth, heads, dtype, save, b1, tokens,
         padded):
    """``decoder_stack_fwd`` on operands whose groups hold ``tokens`` tokens
    each, padded (``padded``: by the wrapper) or not."""
    global launches, launches_save, launches_pad, launches_save_pad
    if x.device.type == "cpu":
        return decoder_stack_fwd_plain(
            x, a, z, w1, w2, vecs, depth, heads, dtype, save, b1,
            tokens if tokens != a.shape[-1] // heads else None)
    mlp = _mlp_dim("decoder_stack_fwd", w1, b1, depth)
    b, n, dim = x.shape
    hl = a.shape[-1]
    shapes_ok = (dim == _DIM and w1.shape == (depth, _DIM, mlp)
                 and w2.shape == (depth, mlp, _DIM)
                 and a.shape == (depth, b, _DIM, hl)
                 and z.shape == (depth, b, hl, _DIM)
                 and vecs.shape == (depth, 7, _DIM))
    _check("decoder_stack_fwd", (x, a, z, w1, w2, vecs), dtype, heads, hl,
           shapes_ok)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data_ptr() for t in (x, a, z, w1, w2, vecs)] \
        + [None if b1 is None else b1.data_ptr(), y.data_ptr()]
    if save:
        xsave = torch.empty((depth, b, n, _DIM), dtype=dtype, device=x.device)
        attnsave = torch.empty((depth, b, n, hl), dtype=dtype, device=x.device)
        status = _fn("decoder_fwd", "decoder_stack_fwd_save", dtype, 10, 7)(
            *ptrs, xsave.data_ptr(), attnsave.data_ptr(), b, n, depth, hl,
            hl // heads, tokens, mlp, stream)
        _build.check(status, "decoder_stack_fwd(save)")
        launches_save += 1
        launches_save_pad += padded or tokens > 8
        return y, xsave, attnsave
    status = _fn("decoder_fwd", "decoder_stack_fwd", dtype, 8, 7)(
        *ptrs, b, n, depth, hl, hl // heads, tokens, mlp, stream)
    _build.check(status, "decoder_stack_fwd")
    launches += 1
    launches_pad += padded or tokens > 8
    return y


def _bwd_rows_per_cta(b: int, n: int, slots: int) -> int:
    """K2's rows per CTA: a multiple of its tile (``_BWD_TILE`` rows),
    chosen so that the grid is about ``slots`` CTAs, the number the card
    runs at once (``_bwd_slots``). Fewer, longer CTAs keep the partial-sum
    scratch small (tens of MB at the batch-8 training shapes)."""
    tiles = -(-n // _BWD_TILE)
    cps = max(1, min(tiles, -(-slots // b)))
    return -(-tiles // cps) * _BWD_TILE


_slots = {}


def _ctas_per_sm(lib: str, dtype, hl: int, *flags) -> int:
    """CTAs of the row kernel of ``csrc/<lib>.cu`` in ``dtype`` that one SM
    holds at once at this hl, as the CUDA occupancy calculator counts them
    (registers and shared memory decide): ``decoder_bwd``, K2, flags
    (mlp_dim, pad); ``decoder_fwd``, flags (0 for K1 or 1 for K1-save,
    mlp_dim, pad); pad 1 for the PAD instance."""
    per_sm = ctypes.c_int(0)
    fn = getattr(_build.load(lib), f"decoder_stack_{lib[-3:]}_ctas_per_sm_"
                 f"{_DTYPES[dtype]}")
    fn.argtypes = [ctypes.c_int] * (1 + len(flags)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(hl, *flags, ctypes.byref(per_sm)), f"{lib} occupancy")
    return max(1, per_sm.value)


def _bwd_slots(dev, dtype, hl: int, mlp: int, pad: int) -> int:
    """CTAs of K2's row kernel instance that the card runs at once: what one
    SM holds at this hl times the SMs, asked once per device, dtype, hl,
    mlp_dim and instance (``pad`` 1 for the PAD one, 16 tokens per head)."""
    key = (dev.index, dtype, hl, mlp, pad)
    if key not in _slots:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        _slots[key] = _ctas_per_sm("decoder_bwd", dtype, hl, mlp, pad) * n_sm
    return _slots[key]


def decoder_stack_bwd(xsave, attnsave, dy, a, z, w1, w2, vecs, depth: int,
                      heads: int, dtype, b1=None):
    """Decoder-stack backward (K2) from the forward's saves.

    xsave (D, B, N, 32), attnsave (D, B, N, hl), dy (B, N, 32), a, z, w1,
    w2 as in ``decoder_stack_fwd``, all in ``dtype``; vecs (D, 7, 32) fp32;
    b1 as in ``decoder_stack_fwd``. Returns dx (B, N, 32) and da, dz (per
    sample) in ``dtype``, and dw1 (D, 32, mlp), dw2 (D, mlp, 32) and dvecs
    (D, 7, 32) in fp32; the ln1 rows of dvecs are the x side only. With
    ``b1`` given (mlp_dim != 32) row 5 of dvecs is zero and db1 (D, mlp)
    fp32 is a seventh value. CPU tensors take the plain version (any
    mlp_dim); CUDA tensors launch the kernel (mlp_dim 32 or 64) or raise.
    Token counts the kernel does not take run padded (module docstring), on
    both; ``attnsave`` may come padded already.
    """
    hl = a.shape[-1]
    hk, l, lp = _padding("decoder_stack_bwd", hl, heads,
                         dy.device.type != "cpu")
    if (hk, lp) == (heads, l):
        return _bwd(xsave, attnsave, dy, a, z, w1, w2, vecs, depth, heads,
                    dtype, b1, l > 8)
    if attnsave.shape[-1] == hl:
        attnsave = _widen(attnsave, heads, l, lp, -1, hk)
    dx, da, dz, *rest = _bwd(xsave, attnsave, dy,
                             _widen(a, heads, l, lp, -1, hk),
                             _widen(z, heads, l, lp, -2, hk), w1, w2, vecs,
                             depth, hk, dtype, b1, True)
    return (dx, _narrow(da, heads, l, lp, -1), _narrow(dz, heads, l, lp, -2),
            *rest)


def _bwd(xsave, attnsave, dy, a, z, w1, w2, vecs, depth, heads, dtype, b1,
         padded):
    """``decoder_stack_bwd`` on operands the kernel takes as they are;
    ``padded``: a count the tiles do not hold as it is."""
    global launches_bwd, launches_bwd_pad
    if dy.device.type == "cpu":
        return decoder_stack_bwd_plain(xsave, attnsave, dy, a, z, w1, w2, vecs,
                                       depth, heads, dtype, b1)
    mlp = _mlp_dim("decoder_stack_bwd", w1, b1, depth)
    b, n, dim = dy.shape
    hl = a.shape[-1]
    shapes_ok = (dim == _DIM and xsave.shape == (depth, b, n, _DIM)
                 and attnsave.shape == (depth, b, n, hl)
                 and w1.shape == (depth, _DIM, mlp)
                 and w2.shape == (depth, mlp, _DIM)
                 and a.shape == (depth, b, _DIM, hl)
                 and z.shape == (depth, b, hl, _DIM)
                 and vecs.shape == (depth, 7, _DIM))
    _check("decoder_stack_bwd", (xsave, attnsave, dy, a, z, w1, w2, vecs),
           dtype, heads, hl, shapes_ok)
    dev = dy.device
    rows = _bwd_rows_per_cta(b, n, _bwd_slots(dev, dtype, hl, mlp,
                                              int(hl // heads > 8)))
    cps = -(-n // rows)
    # Per (CTA, layer): [dW1 | dW2 | dA | dZ | dvecs | db1 where mlp != 32]
    # (csrc/decoder_bwd.cu part_size).
    wide = mlp != _DIM
    part = torch.empty(b * cps * depth * (2 * _DIM * mlp + 2 * _DIM * hl
                                          + 7 * _DIM + wide * mlp),
                       dtype=torch.float32, device=dev)
    dx = torch.empty_like(dy)
    da, dz = torch.empty_like(a), torch.empty_like(z)
    dw1 = torch.empty((depth, _DIM, mlp), dtype=torch.float32, device=dev)
    dw2 = torch.empty((depth, mlp, _DIM), dtype=torch.float32, device=dev)
    dvecs = torch.empty((depth, 7, _DIM), dtype=torch.float32, device=dev)
    db1 = torch.empty((depth, mlp), dtype=torch.float32, device=dev) \
        if wide else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = _fn("decoder_bwd", "decoder_stack_bwd", dtype, 17, 7)(
        *[None if t is None else t.data_ptr()
          for t in (xsave, attnsave, dy, a, z, w1, w2, vecs, b1, dx, da, dz,
                    dw1, dw2, dvecs, db1, part)],
        b, n, depth, hl, hl // heads, rows, mlp, stream)
    _build.check(status, "decoder_stack_bwd")
    launches_bwd += 1
    launches_bwd_pad += padded
    out = (dx, da, dz, dw1, dw2, dvecs)
    return out if db1 is None else (*out, db1)
