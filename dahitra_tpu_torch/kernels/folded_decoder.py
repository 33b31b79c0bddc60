"""K1 forward: the cross-attention decoder stack as a hand-written CUDA
kernel for Hopper.

Replaces dahitra_tpu/pallas/folded_decoder.py ``_fwd_kernel`` (via
``folded_decoder_fwd``, forward without saves): the production "noshift"
forward of dahitra_tpu/nn/decoder_vjp.py ``_layer_fwd`` over the whole
depth. The memory-token side (``build_az`` in nn/decoder_vjp.py) is computed
outside, as in the JAX package; the kernel consumes the per-sample
A (D, B, 32, hl) and Z (D, B, hl, 32).

Source: ``csrc/decoder_fwd.cu``. Bound on this card: operations (~8 kFLOP
per 32-wide row per layer at hl = 32 against 128-256 bytes of the row for the
whole stack). Design: one warp per row, lane = channel; the residual stays
in registers across all layers (x read once, written once) and each layer's
weights are staged in shared memory. The products run on the fp32 FMA pipe;
tensor-core tiles are later work.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dahitra_tpu_torch.kernels import _build

# Launches of the CUDA kernel in this process; the plain version never counts.
launches = 0

_DIM = 32
_MAX_HL = 128
_CLAMP = 80.0  # dahitra_tpu/nn/decoder_vjp.py _NOSHIFT_CLAMP
_FNS = {torch.float32: "decoder_stack_fwd_f32",
        torch.bfloat16: "decoder_stack_fwd_bf16"}
# Rows of vecs: per-layer vectors in this order.
VEC_KEYS = ("ln1_scale", "ln1_bias", "bo", "ln2_scale", "ln2_bias", "b1", "b2")


def _layer_norm(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """decoder_vjp._ln_stats / _ln_apply: fp32, two-pass variance."""
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + 1e-5) * scale + bias


def decoder_stack_fwd_plain(x, a, z, w1, w2, vecs, depth: int, heads: int,
                            dtype) -> torch.Tensor:
    """The kernel's function in plain PyTorch, rounding to ``dtype`` where
    decoder_vjp._layer_fwd rounds. Shapes as in ``decoder_stack_fwd``."""
    b, n, dim = x.shape
    hl = a.shape[-1]
    l = hl // heads
    scale = dim ** -0.5
    for d in range(depth):
        ln1s, ln1b, bo, ln2s, ln2b, b1, b2 = vecs[d]
        hn = _layer_norm(x.float(), ln1s, ln1b).to(dtype)
        dots = torch.matmul(hn, a[d]).float() * scale
        e = torch.exp(dots.clamp(-_CLAMP, _CLAMP))
        den = e.view(b, n, heads, l).sum(-1, keepdim=True)
        attn = (e.view(b, n, heads, l) / den).view(b, n, hl).to(dtype)
        x1 = x + torch.matmul(attn, z[d]) + bo.to(dtype)
        g = _layer_norm(x1.float(), ln2s, ln2b).to(dtype)
        t = torch.matmul(g, w1[d]) + b1.to(dtype)
        h = F.gelu(t.float()).to(dtype)
        x = x1 + torch.matmul(h, w2[d]) + b2.to(dtype)
    return x


def _fn(dtype):
    fn = getattr(_build.load("decoder_fwd"), _FNS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decoder_stack_fwd(x, a, z, w1, w2, vecs, depth: int, heads: int,
                      dtype) -> torch.Tensor:
    """Decoder-stack forward over ``depth`` layers.

    x: (B, N, 32); a: (D, B, 32, hl); z: (D, B, hl, 32); w1, w2: (D, 32, 32)
    laid out (in, out), all in ``dtype``; vecs: (D, 7, 32) fp32 rows in
    ``VEC_KEYS`` order. Returns (B, N, 32) in ``dtype``. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise.
    """
    global launches
    if x.device.type == "cpu":
        return decoder_stack_fwd_plain(x, a, z, w1, w2, vecs, depth, heads,
                                       dtype)
    tensors = (x, a, z, w1, w2, vecs)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("decoder_stack_fwd: all operands must be on one "
                         f"CUDA device, got {[str(t.device) for t in tensors]}")
    if dtype not in _FNS or any(t.dtype != dtype for t in tensors[:5]) \
            or vecs.dtype != torch.float32:
        raise TypeError(f"decoder_stack_fwd: need x, a, z, w1, w2 in {dtype} "
                        "(float32 or bfloat16) and vecs in float32, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decoder_stack_fwd: operands must be contiguous")
    b, n, dim = x.shape
    hl = a.shape[-1]
    if dim != _DIM or w1.shape != (depth, _DIM, _DIM) \
            or w2.shape != (depth, _DIM, _DIM):
        raise ValueError(f"decoder_stack_fwd: dim and mlp_dim must be {_DIM}, "
                         f"got x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    if hl > _MAX_HL or hl % heads or a.shape != (depth, b, _DIM, hl) \
            or z.shape != (depth, b, hl, _DIM) or vecs.shape != (depth, 7, _DIM):
        raise ValueError(f"decoder_stack_fwd: need hl <= {_MAX_HL}, a "
                         f"(D, B, 32, hl), z (D, B, hl, 32), vecs (D, 7, 32); "
                         f"got a {tuple(a.shape)}, z {tuple(z.shape)}, "
                         f"vecs {tuple(vecs.shape)}, heads {heads}")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _fn(dtype)(x.data_ptr(), a.data_ptr(), z.data_ptr(),
                        w1.data_ptr(), w2.data_ptr(), vecs.data_ptr(),
                        y.data_ptr(), b, n, depth, hl, hl // heads, stream)
    _build.check(status, "decoder_stack_fwd")
    launches += 1
    return y
