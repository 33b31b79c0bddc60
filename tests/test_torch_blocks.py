"""The port's blocks and eval-mode ResNet trunk against their flax modules.

Same seeded numpy inputs and the same weights through dahitra_tpu (flax,
CPU) and dahitra_tpu_torch (PyTorch, CPU), fp32, compared to 1e-5 after
dividing both by the reference's largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahitra_tpu.core.torch_import import (_convert_decoder,
                                           _convert_transformer,
                                           convert_resnet_trunk)
from dahitra_tpu.nn import blocks as jb
from dahitra_tpu.nn.resnet import ResNetTrunk as JaxTrunk
from dahitra_tpu_torch.nn import blocks as tb
from dahitra_tpu_torch.nn.resnet import ResNetTrunk

TOL = 1e-5


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    sc = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(got / sc, ref / sc, rtol=tol, atol=tol)


def _randomize(module: torch.nn.Module, seed: int) -> None:
    """Seeded numpy values for every parameter and BN statistic."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in list(module.named_parameters()) + list(
                module.named_buffers()):
            if name.endswith("running_var"):
                v = rng.uniform(0.5, 1.5, p.shape)
            elif p.dim() > 1:
                v = rng.normal(0.0, p[0].numel() ** -0.5, p.shape)
            else:
                v = rng.normal(0.0, 0.2, p.shape) + (
                    1.0 if name.endswith("weight") else 0.0)
            p.copy_(torch.from_numpy(v.astype(np.float32)))


def _sd(module: torch.nn.Module, prefix: str = "") -> dict:
    return {prefix + k: v.numpy() for k, v in module.state_dict().items()}


def _conv(w):  # OIHW -> HWIO
    return np.transpose(w, (2, 3, 1, 0))


def _lin(w):  # (out, in) -> (in, out)
    return np.transpose(w, (1, 0))


def _x(seed, shape):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def test_upsample_nearest_and_max_pool():
    x = _x(0, (2, 7, 9, 5))
    _close(tb.upsample_nearest(torch.from_numpy(x)),
           jb.upsample_nearest(jnp.asarray(x)))
    _close(tb.max_pool_3x3_s2(torch.from_numpy(x)),
           jb.max_pool_3x3_s2(jnp.asarray(x)))


def test_two_layer_conv_eval_bn():
    c_in, c_out = 8, 6
    port = tb.TwoLayerConv(c_in, c_out)
    _randomize(port, 1)
    sd = _sd(port)
    variables = {
        "params": {"conv1": {"kernel": _conv(sd["0.weight"])},
                   "bn": {"scale": sd["1.weight"], "bias": sd["1.bias"]},
                   "conv2": {"kernel": _conv(sd["3.weight"]),
                             "bias": sd["3.bias"]}},
        "batch_stats": {"bn": {"mean": sd["1.running_mean"],
                               "var": sd["1.running_var"]}}}
    x = _x(2, (2, 9, 9, c_in))
    ref = jb.TwoLayerConv(c_out).apply(variables, jnp.asarray(x), False)
    _close(port(torch.from_numpy(x)), ref)


def test_up_conv_and_classifier_match_phase_convs():
    """UpConv == PhaseUpConv, and conv3x3 on the upsampled map ==
    PhasePackedConv on the phase-packed one (the fused head)."""
    up = tb.UpConv(16, 16)
    cls = torch.nn.Conv2d(16, 2, 3, padding=1)
    _randomize(up, 3)
    _randomize(cls, 4)
    up_p = {"kernel": _conv(up[0].weight.detach().numpy()),
            "bias": up[0].bias.detach().numpy()}
    cls_p = {"kernel": _conv(cls.weight.detach().numpy()),
             "bias": cls.bias.detach().numpy()}
    x = _x(5, (2, 6, 7, 16))
    xt = torch.from_numpy(x)
    _close(up(xt), jb.PhaseUpConv(16).apply({"params": up_p}, jnp.asarray(x)))
    packed = jb.PhaseUpConv(16, packed_out=True).apply({"params": up_p},
                                                        jnp.asarray(x))
    ref = jb.PhasePackedConv(2).apply({"params": cls_p}, packed)
    _close(tb.conv2d_nhwc(up(xt), cls.weight, cls.bias, padding=1), ref)


def test_feed_forward():
    port = tb.FeedForward(32, 48)
    _randomize(port, 6)
    sd = _sd(port)
    params = {"fc1": {"kernel": _lin(sd["net.0.weight"]),
                      "bias": sd["net.0.bias"]},
              "fc2": {"kernel": _lin(sd["net.3.weight"]),
                      "bias": sd["net.3.bias"]}}
    x = _x(7, (2, 10, 32))
    ref = jb.FeedForward(32, 48).apply({"params": params}, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), ref)


def test_multi_head_self_attention():
    port = tb.MultiHeadSelfAttention(32, heads=4, dim_head=16)
    _randomize(port, 8)
    sd = _sd(port)
    params = {"to_qkv": {"kernel": _lin(sd["to_qkv.weight"])},
              "to_out": {"kernel": _lin(sd["to_out.0.weight"]),
                         "bias": sd["to_out.0.bias"]}}
    x = _x(9, (2, 8, 32))
    ref = jb.MultiHeadSelfAttention(32, 4, 16).apply({"params": params},
                                                    jnp.asarray(x))
    _close(port(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("n,softmax", [(8, True), (64, True), (8, False)])
def test_cross_attention(n, softmax):
    """n=8 takes flax's standard path, n=64 its small-memory reassociation
    (n > 4 * n_kv); the port computes both as the standard path."""
    port = tb.CrossAttention(32, heads=4, dim_head=16, softmax=softmax)
    _randomize(port, 10)
    sd = _sd(port)
    params = {t: {"kernel": _lin(sd[f"{t}.weight"])}
              for t in ("to_q", "to_k", "to_v")}
    params["to_out"] = {"kernel": _lin(sd["to_out.0.weight"]),
                        "bias": sd["to_out.0.bias"]}
    x, m = _x(11, (2, n, 32)), _x(12, (2, 4, 32))
    ref = jb.CrossAttention(32, 4, 16, softmax=softmax).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(m))
    _close(port(torch.from_numpy(x), torch.from_numpy(m)), ref)


def test_transformer_encoder():
    depth = 2
    port = tb.TransformerEncoder(32, depth, heads=8, dim_head=16, mlp_dim=32)
    _randomize(port, 13)
    params = {}
    _convert_transformer(_sd(port, "t."), "t", depth, params, ())
    x = _x(14, (2, 8, 32))
    ref = jb.TransformerEncoder(32, depth, 8, 16, 32).apply(
        {"params": params}, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), ref)


def test_transformer_decoder_module_path():
    """n <= 4 * n_kv: both packages take the layer-by-layer path with the
    max-shifted softmax (the decoder-stack gate is in test_torch_decoder)."""
    depth = 2
    port = tb.TransformerDecoder(32, depth, heads=4, dim_head=16, mlp_dim=32)
    _randomize(port, 15)
    assert not port.uses_stack(16, 4, 32)
    params = {}
    _convert_decoder(_sd(port, "d."), "d", depth, params, ())
    x, m = _x(16, (2, 16, 32)), _x(17, (2, 4, 32))
    ref = jb.TransformerDecoder(32, depth, 4, 16, 32).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(m))
    _close(port(torch.from_numpy(x), torch.from_numpy(m)), ref)


def test_semantic_tokenizer_module():
    port = tb.SemanticTokenizer(32, 4)
    _randomize(port, 18)
    w = port.weight.detach().numpy()
    x = _x(19, (2, 8, 8, 32))
    ref = jb.SemanticTokenizer(4).apply(
        {"params": {"conv_token": {"kernel": _conv(w)}}}, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), ref)


def test_resnet_trunk_eval():
    """Eval-mode resnet18 trunk, three layers with DAHiTra's strides
    (layer3 stride removed, not dilated)."""
    port = ResNetTrunk("resnet18", (False, True, True), num_layers=3)
    _randomize(port, 20)
    params, stats = convert_resnet_trunk(_sd(port))
    x = _x(21, (2, 32, 32, 3))
    ref = JaxTrunk("resnet18", (False, True, True)).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), False,
        num_stages=3)
    got = port(torch.from_numpy(x))
    assert got.shape == (2, 4, 4, 256)
    _close(got, ref)
    pre = JaxTrunk("resnet18", (False, True, True)).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        method=JaxTrunk.stem_preact)
    _close(port.stem_preact(torch.from_numpy(x)), pre)


def test_resnet_trunk_rejects_unported_backbone():
    """resnet50 is ported (tests/test_torch_zoo_unet.py); a backbone the
    JAX package does not have either raises by name."""
    with pytest.raises(NotImplementedError, match="resnet101"):
        ResNetTrunk("resnet101")
