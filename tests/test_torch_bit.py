"""The port's BIT (``base_transformer_pos_s4*``) and ResNetCD
(``base_resnet18``) against the flax models, ``upsample_bilinear`` against
``jax.image.resize``, the weight converters, the registry keys and the CLIs
on a BIT key.

Weights come from the flax init (with seeded numpy biases and BN
statistics, so those paths carry values) through ``bit_flax_to_state_dict``
and ``resnet_cd_flax_to_state_dict``; inputs are seeded numpy, 64 px, batch
2. At 64 px BIT's decoder sees N = 256 pixels and 4 or 8 tokens, so it
takes the decoder stack (K1's plain version on the CPU), with mlp_dim 64.
Tolerances are those of tests/test_torch_dahitra.py where they hold for
the JAX package against itself: logits 1e-4 scale-normalized in fp32 and
5e-2 in bf16, BN statistics 1e-4, BIT's fp32 gradients 1e-3 of the whole
gradient's scale, the bf16 loss 2e-2 relative. Three bounds of that file are
below what the JAX package reaches against itself on these models, so the
port is held to the JAX package's own deviation instead (each test says
how): the bf16 argmax agreement (JAX's bf16 BIT agrees with its fp32 BIT on
98.1 % of the pixels at _dd8, not 99.5 %), the bf16 gradients' cosine
similarity (0.974 between JAX's bf16 and fp32 BIT, not 0.99), and ResNetCD's
fp32 gradients (JAX against itself with the input moved by 1e-6: 3.8e-3 of
the scale, not 1e-3: ReLU flips in a batch-2 train-mode trunk).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from dahitra_tpu.core.torch_import import convert_bit, convert_resnet_cd
from dahitra_tpu.losses.cd import levir_train_loss as jax_levir_train_loss
from dahitra_tpu.models.registry import define_g as jax_define_g
from dahitra_tpu.nn.blocks import upsample_bilinear as jax_upsample_bilinear
from dahitra_tpu_torch.cli import eval_cd, main_cd
from dahitra_tpu_torch.core.checkpoint import load_checkpoint, load_weights
from dahitra_tpu_torch.core.flax_import import (bit_flax_to_state_dict,
                                                resnet_cd_flax_to_state_dict)
from dahitra_tpu_torch.data.synthetic import write_synthetic_levir
from dahitra_tpu_torch.kernels import folded_decoder as fd
from dahitra_tpu_torch.losses.cd import levir_train_loss
from dahitra_tpu_torch.models.bit import BIT
from dahitra_tpu_torch.models.registry import PORTED, define_g, final_logits
from dahitra_tpu_torch.nn.blocks import upsample_bilinear

IMG = 64
DD8 = "base_transformer_pos_s4_dd8"
T8 = "base_transformer_pos_s4_dd8_t8_e2d4"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _perturb(tree, rng):
    """Seeded numpy biases, BN means and variances over a flax tree."""
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, tree))
    out = {}
    for k, v in flat.items():
        if k[-1] in ("bias", "mean"):
            v = v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
        elif k[-1] == "var":
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        out[k] = v
    return traverse_util.unflatten_dict(out)


@functools.lru_cache(maxsize=None)
def _flax_case(key):
    """(x1, x2, params, batch_stats) of the flax model ``key``, seeded."""
    rng = np.random.RandomState(0)
    x1 = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    variables = jax.jit(jax_define_g(key).init)(
        jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x2))
    return (x1, x2, _perturb(variables["params"], rng),
            _perturb(variables["batch_stats"], rng))


def _to_state_dict(key, params, stats):
    convert = resnet_cd_flax_to_state_dict if key == "base_resnet18" \
        else bit_flax_to_state_dict
    return convert(params, stats)


def _port(key, params, stats, dtype=torch.float32):
    model = define_g(key, dtype=dtype)
    load_weights(model, _to_state_dict(key, params, stats))
    return model


def _close(got, ref, tol):
    sc = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(got / sc, ref / sc, rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _jax_logits(key, dname):
    x1, x2, params, stats = _flax_case(key)
    return np.asarray(jax.jit(lambda p, s, a, b: jax_define_g(
        key, dtype=JDT[dname]).apply({"params": p, "batch_stats": s}, a, b,
                                     False))(params, stats, x1, x2),
                      np.float32)


@pytest.mark.parametrize("key,dname", [(DD8, "float32"), (DD8, "bfloat16"),
                                       (T8, "float32"), (T8, "bfloat16"),
                                       ("base_resnet18", "float32")])
def test_eval_logits_match_flax(key, dname):
    """The eval forward against the flax model in the same dtype. In bf16
    also the argmax against the fp32 flax model: the port's agreement with
    it at most 0.5 % below the bf16 flax model's own."""
    x1, x2, params, stats = _flax_case(key)
    ref = _jax_logits(key, dname)
    model = _port(key, params, stats, TDT[dname]).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x1).to(TDT[dname]),
                    torch.from_numpy(x2).to(TDT[dname]))
    assert got.dtype == TDT[dname] and got.shape == ref.shape == (
        2, IMG, IMG, 2)
    got = got.float().numpy()
    if dname == "float32":
        _close(got, ref, 1e-4)
    else:
        _close(got, ref, 5e-2)
        truth = _jax_logits(key, "float32").argmax(-1)
        jax_agree = (ref.argmax(-1) == truth).mean()
        assert (got.argmax(-1) == truth).mean() >= jax_agree - 5e-3
    assert fd.launches == 0  # CPU tensors never reach a kernel


@functools.lru_cache(maxsize=None)
def _jax_train_step(key, dtype):
    """The flax model's train step: (params, stats, x1, x2, label) ->
    (loss, (logits, new batch_stats)), grads; jitted once per key and
    dtype."""
    model = jax_define_g(key, dtype=dtype)

    def loss_fn(p, stats, x1, x2, label):
        logits, mut = model.apply({"params": p, "batch_stats": stats},
                                  x1.astype(dtype), x2.astype(dtype), True,
                                  mutable=["batch_stats"])
        loss = jax_levir_train_loss(logits.astype(jnp.float32), label, 2)
        return loss, (logits, mut["batch_stats"])

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _train_pair(key, dname):
    """The flax and the port's train step on the same weights and batch:
    ((loss, logits, new stats, grads), (model, loss, logits))."""
    x1, x2, params, stats = _flax_case(key)
    label = (np.random.RandomState(7).rand(2, IMG, IMG) < 0.3).astype(np.uint8)
    (loss, (logits, new_stats)), grads = _jax_train_step(key, JDT[dname])(
        params, stats, x1, x2, label)
    model = _port(key, params, stats, TDT[dname])
    out = model(torch.from_numpy(x1).to(TDT[dname]),
                torch.from_numpy(x2).to(TDT[dname]), train=True)
    port_loss = levir_train_loss(out.float(), torch.from_numpy(label), 2)
    port_loss.backward()
    return ((float(loss), np.asarray(logits, np.float32), new_stats, grads),
            (model, port_loss.item(), out.detach().float().numpy()))


def _grad_err(key, named, grads):
    """The largest gradient error over all tensors, on the whole gradient's
    scale (its largest element over all tensors)."""
    ref = _to_state_dict(key, jax.tree.map(np.asarray, grads),
                         _flax_case(key)[3])
    scale = max(np.abs(ref[k].numpy()).max() for k in named)
    return max(np.abs(g - ref[k].numpy()).max()
               for k, g in named.items()) / scale


@pytest.mark.parametrize("key", [DD8, "base_resnet18"])
def test_train_step_matches_flax(key):
    """fp32 train step: the logits and loss, every updated BN running
    statistic (the trunk's two per-date updates and the classifier's), and
    every parameter's gradient on the gradient's scale (its largest element
    over all tensors; tests/test_torch_dahitra.py says why not each
    tensor's own): BIT's to 1e-3; ResNetCD's to 1.5 times the flax model's
    own error with the first date's input moved by 1e-6."""
    (ref_loss, ref, ref_stats, ref_grads), (model, loss, got) = _train_pair(
        key, "float32")
    _close(got, ref, 1e-4)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    params = _flax_case(key)[2]
    want = _to_state_dict(key, params, jax.tree.map(np.asarray, ref_stats))
    bufs = dict(model.named_buffers())
    assert bufs and set(bufs) <= set(want)
    for k, v in bufs.items():
        _close(v.numpy(), want[k].numpy(), 1e-4)
    named = {k: p.grad.numpy() for k, p in model.named_parameters()}
    err = _grad_err(key, named, ref_grads)
    if key == DD8:
        assert err <= 1e-3, err
        return
    x1, x2, params, stats = _flax_case(key)
    moved = x1 + 1e-6 * np.random.RandomState(9).normal(
        size=x1.shape).astype(np.float32)
    label = (np.random.RandomState(7).rand(2, IMG, IMG) < 0.3).astype(np.uint8)
    self_grads = _jax_train_step(key, jnp.float32)(params, stats, moved, x2,
                                                   label)[1]
    ref_sd = _to_state_dict(key, jax.tree.map(np.asarray, ref_grads), stats)
    jax_self = _grad_err(key, {k: ref_sd[k].numpy() for k in named},
                         self_grads)
    assert err <= max(1e-3, 1.5 * jax_self), (err, jax_self)


def test_bf16_train_loss_and_grads_match_flax():
    """bf16 compute: the loss to 2e-2 relative to the bf16 flax model's; the
    cosine similarity of all gradients flattened together against the fp32
    flax model's, 1 - cos at most 1.5 times the bf16 flax model's own."""
    (ref_loss, _, _, ref_grads), (model, loss, _) = _train_pair(DD8,
                                                                "bfloat16")
    assert loss == pytest.approx(ref_loss, rel=2e-2)
    x1, x2, params, stats = _flax_case(DD8)
    label = (np.random.RandomState(7).rand(2, IMG, IMG) < 0.3).astype(np.uint8)
    fp32_grads = _jax_train_step(DD8, jnp.float32)(params, stats, x1, x2,
                                                   label)[1]
    named = dict(model.named_parameters())

    def flat(grads):
        sd = bit_flax_to_state_dict(jax.tree.map(np.asarray, grads), stats)
        return np.concatenate([sd[k].numpy().ravel() for k in named])

    def cos(a, b):
        return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))

    truth = flat(fp32_grads)
    got = np.concatenate([named[k].grad.float().numpy().ravel()
                          for k in named])
    jax_cos = cos(flat(ref_grads), truth)
    assert 1 - cos(got, truth) <= 1.5 * (1 - jax_cos), (cos(got, truth),
                                                       jax_cos)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_upsample_bilinear_matches_jax_resize(dname):
    """x4 with half-pixel centres, border rows and columns included: equal
    to 1e-6 in fp32; in bf16 both round the fp32 interpolation once or
    twice, so within one bf16 ulp of the largest value."""
    x = np.random.RandomState(3).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jax_upsample_bilinear(jnp.asarray(x, JDT[dname]), 4),
                     np.float32)
    got = upsample_bilinear(torch.from_numpy(x).to(TDT[dname]), 4)
    assert got.dtype == TDT[dname] and got.shape == ref.shape == (2, 20, 28, 3)
    got = got.float().numpy()
    tol = 1e-6 if dname == "float32" else 2.0 ** -8
    sc = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=tol * sc, rtol=0)
    # The border: source coordinate (o + 0.5) / 4 - 0.5 lies before the
    # first centre for output rows and columns 0 and 1 (after the last for
    # the last two), where both packages give the edge pixel: jax by
    # renormalising its triangle weights, torch by clamping the index.
    xs = torch.from_numpy(x).to(TDT[dname]).float().numpy()
    for arr in (got, ref):
        for edge in (np.s_[:2], np.s_[-2:]):
            for side in ((edge, np.s_[:]), (np.s_[:], edge)):
                part = arr[(np.s_[:], *side)]
                first = part[:, :1] if side[1] == np.s_[:] else part[:, :, :1]
                np.testing.assert_allclose(part, np.broadcast_to(
                    first, part.shape), atol=tol * sc, rtol=0)
        for i, j in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
            np.testing.assert_allclose(arr[:, i, j], xs[:, i, j],
                                       atol=tol * sc, rtol=0)


@pytest.mark.parametrize("key", [DD8, "base_resnet18"])
def test_state_dict_round_trip(key):
    """JAX -> port (bit_flax_to_state_dict, resnet_cd_flax_to_state_dict) ->
    convert_bit / convert_resnet_cd gives back the same arrays, and the port
    has exactly those keys."""
    _, _, params, stats = _flax_case(key)
    sd = _to_state_dict(key, params, stats)
    assert set(sd) == set(define_g(key).state_dict())
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    p2, s2 = (convert_resnet_cd(numpy_sd) if key == "base_resnet18"
              else convert_bit(numpy_sd, 1, 8))
    for a, b in ((params, p2), (stats, s2)):
        fa, fb = (traverse_util.flatten_dict(t) for t in (a, b))
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]), fb[k],
                                          err_msg=str(k))


def test_every_ported_key_builds_with_the_jax_output_shape():
    """Each ported key's forward at 32 px, batch 1, has the JAX model's
    output shape (jax.eval_shape, nothing compiled; the full-resolution
    logits of changeFormerV6's list), the xBD keys on the
    6-channel pre|post input (the single-image ResNet34 UNets on one
    3-channel image); a key not ported yet raises by name."""
    x = np.zeros((1, 32, 32, 3), np.float32)
    x6 = np.zeros((1, 32, 32, 6), np.float32)
    for key in PORTED:
        ins = ((x, None) if key in ("xbd_res34_loc", "xbd_res34_single")
               else (x6, None) if key.startswith("xbd_") else (x, x))
        want = final_logits(jax.eval_shape(
            lambda a: jax_define_g(key, img_size=32).init_with_output(
                jax.random.PRNGKey(0), a, ins[1])[0], ins[0])).shape
        with torch.no_grad():
            got = final_logits(define_g(key, img_size=32).eval()(
                *(None if t is None else torch.from_numpy(t) for t in ins)))
        assert tuple(got.shape) == tuple(want), key
    with pytest.raises(NotImplementedError,
                       match="dual_hrnet.*Rest of the zoo"):
        define_g("dual_hrnet")


def test_bit_fields_and_six_channel_input():
    """The fields the registry keys leave at their defaults: the learned
    decoder positional embedding (NCHW, N(0, 1)), no token transformer, the
    simple decoder, the sigmoid and no x2 upsampling; and the xBD 6-channel
    input equals the pair."""
    x = torch.from_numpy(np.random.RandomState(4).uniform(
        -1, 1, (1, 32, 32, 6)).astype(np.float32))
    for kw in (dict(with_decoder_pos="learned", decoder_pos_size=8),
               dict(token_trans=False, with_pos=None),
               dict(with_decoder=False, output_sigmoid=True),
               dict(if_upsample_2x=False, resnet_stages_num=5)):
        model = BIT(**kw).eval()
        with torch.no_grad():
            out = model(x)
            pair = model(x[..., :3], x[..., 3:])
        assert out.shape == (1, 32, 32, 2) and torch.isfinite(out).all()
        torch.testing.assert_close(out, pair, rtol=0, atol=0)
        if kw.get("output_sigmoid"):
            assert ((out >= 0) & (out <= 1)).all()
    pos = BIT(with_decoder_pos="learned").pos_embedding_decoder
    assert pos.shape == (1, 32, 64, 64) and abs(pos.std().item() - 1) < 0.05


def test_main_cd_and_eval_cd_run_a_bit_key_on_cpu(tmp_path, monkeypatch):
    """One epoch of main_cd --net_G base_transformer_pos_s4_dd8 at 64 px,
    batch 2, on a synthetic tree; then eval_cd reloads best_ckpt.pt into the
    same key and scores the test split."""
    data = tmp_path / "data"
    for split, n, seed in (("train", 4, 1), ("val", 2, 2), ("test", 2, 3)):
        write_synthetic_levir(str(data), n_tiles=n, size=IMG, split=split,
                              seed=seed, block=8)
    monkeypatch.setenv("DAHITRA_DATA_ROOT", str(data))
    common = ["--checkpoint_root", str(tmp_path / "ckpt"), "--project_name",
              "bit", "--img_size", str(IMG), "--batch_size", "2",
              "--net_G", DD8, "--device", "cpu"]
    history = main_cd.main(common + ["--max_epochs", "1", "--skip_test"])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    sd, _ = load_checkpoint(str(tmp_path / "ckpt" / "bit"))
    assert "conv_a.weight" in sd and \
        sd["transformer_decoder.layers.7.1.fn.fn.net.0.weight"].shape == (64, 32)
    scores = eval_cd.main(common)
    assert all(0.0 <= scores[k] <= 1.0 for k in ("acc", "miou", "mf1"))
