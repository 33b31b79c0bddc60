"""The port's DAHiTra (``newUNetTrans``) against the flax model: the eval
forward, and the train-mode forward, BN statistics and gradients.

Weights come from the flax init (with seeded numpy BN statistics and
biases, so those paths carry values) through ``flax_to_state_dict``; inputs
are seeded numpy. At 128 px every decoder call has n > 4 * n_kv, so all six
take the decoder stack, as at 256 px (at 64 px the 1/16 decoder has
n = 16 = 4 * n_kv and leaves it). The logits must agree to 1e-4,
scale-normalized; in train mode so must the updated BN statistics, and the
gradients of ``levir_train_loss`` to 1e-3 of the gradient's scale.
"""
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from dahitra_tpu.core.torch_import import convert_dahitra
from dahitra_tpu.losses.cd import levir_train_loss as jax_levir_train_loss
from dahitra_tpu.models.dahitra import DAHiTraUNet as JaxDAHiTra
from dahitra_tpu_torch.core.checkpoint import (load_checkpoint, load_weights,
                                               save_checkpoint)
from dahitra_tpu_torch.core.flax_import import (flax_to_state_dict,
                                                load_reference_checkpoint)
from dahitra_tpu_torch.kernels import folded_decoder as fd
from dahitra_tpu_torch.kernels import fused_tokenizer as ft
from dahitra_tpu_torch.losses.cd import levir_train_loss
from dahitra_tpu_torch.models.dahitra import DAHiTraUNet
from dahitra_tpu_torch.models.registry import define_g

IMG = 128


def _perturb(tree, rng, names, fn):
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, tree))
    out = {k: (fn(v) if k[-1] in names else v) for k, v in flat.items()}
    return traverse_util.unflatten_dict(out)


@pytest.fixture(scope="module")
def flax_case():
    rng = np.random.RandomState(0)
    x1 = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    model = JaxDAHiTra(img_size=IMG)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x1),
                                    jnp.asarray(x2))
    params = _perturb(variables["params"], rng, {"bias"},
                      lambda v: v + 0.1 * rng.normal(size=v.shape)
                      .astype(np.float32))
    stats = _perturb(variables["batch_stats"], rng, {"mean"},
                     lambda v: 0.1 * rng.normal(size=v.shape)
                     .astype(np.float32))
    stats = _perturb(stats, rng, {"var"},
                     lambda v: rng.uniform(0.5, 1.5, v.shape)
                     .astype(np.float32))
    logits = jax.jit(lambda p, s, a, b: model.apply(
        {"params": p, "batch_stats": s}, a, b, False))(params, stats, x1, x2)
    return x1, x2, params, stats, np.asarray(logits)


@pytest.fixture(scope="module")
def port_model(flax_case):
    _, _, params, stats, _ = flax_case
    model = DAHiTraUNet(img_size=IMG).eval()
    load_weights(model, flax_to_state_dict(params, stats))
    return model


def test_eval_logits_match_flax(flax_case, port_model):
    x1, x2, _, _, ref = flax_case
    with torch.no_grad():
        got = port_model(torch.from_numpy(x1), torch.from_numpy(x2))
    assert got.shape == ref.shape == (2, IMG, IMG, 2)
    sc = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy() / sc, ref / sc, rtol=1e-4,
                               atol=1e-4)
    # CPU tensors never reach a kernel.
    assert fd.launches == 0 and ft.launches == 0


def test_bf16_eval_logits_match_flax(flax_case):
    """bf16 compute: both packages round at their own points through some
    forty layers, so the bound is 5e-2 scale-normalized on the logits and
    99.5 % argmax agreement."""
    x1, x2, params, stats, _ = flax_case
    ref = np.asarray(jax.jit(lambda p, s, a, b: JaxDAHiTra(
        img_size=IMG, dtype=jnp.bfloat16).apply(
            {"params": p, "batch_stats": s}, a, b, False))(
                params, stats, x1, x2), np.float32)
    model = DAHiTraUNet(img_size=IMG, dtype=torch.bfloat16).eval()
    load_weights(model, flax_to_state_dict(params, stats))
    with torch.no_grad():
        got = model(torch.from_numpy(x1).bfloat16(),
                    torch.from_numpy(x2).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    sc = np.abs(ref).max()
    np.testing.assert_allclose(got / sc, ref / sc, rtol=5e-2, atol=5e-2)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.995


def test_six_channel_input_matches_pair(flax_case, port_model):
    x1, x2, _, _, _ = flax_case
    a, b = torch.from_numpy(x1[:1]), torch.from_numpy(x2[:1])
    with torch.no_grad():
        pair = port_model(a, b)
        six = port_model(torch.cat([a, b], -1))
    torch.testing.assert_close(six, pair, rtol=0, atol=0)


def test_state_dict_round_trip(port_model):
    """port state_dict -> convert_dahitra -> flax_to_state_dict returns the
    same tensors under the same keys."""
    sd = {k: v.numpy() for k, v in port_model.state_dict().items()}
    back = flax_to_state_dict(*convert_dahitra(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_xbd_variant_keys_match_flax_tree():
    """pos_coarsest_only: only the suffix-3 embeddings, sized for 1/16."""
    port = DAHiTraUNet(img_size=IMG, pos_coarsest_only=True)
    assert not port.decode_dates
    shapes = jax.eval_shape(lambda: JaxDAHiTra(
        img_size=IMG, pos_coarsest_only=True).init(
            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
            jnp.zeros((1, IMG, IMG, 3))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_state_dict(zeros["params"], zeros["batch_stats"], xbd=True)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert want["pos_embedding_decoder_3"] == (1, 32, IMG // 16, IMG // 16)
    assert not any(k.endswith(("_4", "_5")) for k in want
                   if k.startswith("pos_embedding"))


def test_train_mode_and_unported_keys_raise():
    """Every key of the JAX registry builds (the last ones, Dual-HRNet's,
    since the xBD half of the zoo); a key of neither registry raises by
    name."""
    assert isinstance(define_g("dual_hrnet"), torch.nn.Module)
    with pytest.raises(NotImplementedError, match="not recognized"):
        define_g("no_such_model")


def test_checkpoint_round_trip_and_reference_keys(tmp_path, port_model):
    """best_ckpt.pt in the reference trainer's format; a reference file's
    ``module.`` prefix and unused keys (layer4, num_batches_tracked) load,
    a missing model key raises."""
    sd = port_model.state_dict()
    save_checkpoint(str(tmp_path), sd, best_val_acc=0.5, best_epoch_id=3)
    loaded, meta = load_checkpoint(str(tmp_path))
    assert meta == {"best_val_acc": 0.5, "best_epoch_id": 3}
    assert set(loaded) == set(sd)

    ref = {f"module.{k}": v for k, v in sd.items()}
    ref["module.resnet.layer4.0.conv1.weight"] = torch.zeros(512, 256, 3, 3)
    ref["module.resnet.bn1.num_batches_tracked"] = torch.tensor(7)
    path = tmp_path / "reference.pt"
    torch.save({"model_G_state_dict": ref, "epoch_id": 9}, path)
    model = DAHiTraUNet(img_size=IMG)
    load_weights(model, load_reference_checkpoint(str(path)))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    del ref["module.classifier.bias"]
    torch.save({"model_G_state_dict": ref}, path)
    with pytest.raises(KeyError, match="classifier.bias"):
        load_weights(model, load_reference_checkpoint(str(path)))


@functools.lru_cache(maxsize=None)
def _jax_train_step(dtype):
    """The flax model's train step (dahitra_tpu/train/engine.py:129-158),
    jitted once per dtype: (params, stats, x1, x2, label) -> (loss, (logits,
    new batch_stats)), grads."""
    model = JaxDAHiTra(img_size=IMG, dtype=dtype)

    def loss_fn(p, stats, x1, x2, label):
        logits, mut = model.apply({"params": p, "batch_stats": stats},
                                  x1.astype(dtype), x2.astype(dtype), True,
                                  mutable=["batch_stats"])
        loss = jax_levir_train_loss(logits.astype(jnp.float32), label, 2)
        return loss, (logits, mut["batch_stats"])

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _jax_train(params, stats, x1, x2, label, dtype=jnp.float32):
    """(loss, logits, new batch_stats, grads) of the flax train step."""
    (loss, (logits, new_stats)), grads = _jax_train_step(dtype)(
        params, stats, x1, x2, label)
    return float(loss), np.asarray(logits, np.float32), new_stats, grads


def _port_train(params, stats, x1, x2, label, dtype=torch.float32):
    model = DAHiTraUNet(img_size=IMG, dtype=dtype)
    load_weights(model, flax_to_state_dict(params, stats))
    logits = model(torch.from_numpy(x1).to(dtype),
                   torch.from_numpy(x2).to(dtype), train=True)
    loss = levir_train_loss(logits.float(), torch.from_numpy(label), 2)
    loss.backward()
    return model, loss.item(), logits.detach().float().numpy()


@pytest.fixture(scope="module")
def train_case(flax_case):
    x1, x2, params, stats, _ = flax_case
    label = (np.random.RandomState(7).rand(2, IMG, IMG) < 0.3).astype(
        np.uint8)
    return (x1, x2, params, stats, label,
            _jax_train(params, stats, x1, x2, label))


def test_train_logits_and_batch_stats_match_flax(train_case):
    """Train-mode forward (per-date BN statistics in the trunk, ordinary BN
    in conv_layer2_0) and the updated running statistics, fp32, to 1e-4."""
    x1, x2, params, stats, label, (ref_loss, ref, ref_stats, _) = train_case
    model, loss, got = _port_train(params, stats, x1, x2, label)
    sc = np.abs(ref).max()
    np.testing.assert_allclose(got / sc, ref / sc, rtol=1e-4, atol=1e-4)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    want = flax_to_state_dict(params, jax.tree.map(np.asarray, ref_stats))
    bufs = dict(model.named_buffers())
    assert len(bufs) == 2 * sum(1 for k in want if k.endswith("running_var"))
    for k, v in bufs.items():
        r = want[k].numpy()
        sc = max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(v.numpy() / sc, r / sc, rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert fd.launches_save == fd.launches_bwd == 0  # CPU: plain versions


def test_train_grads_match_flax(train_case):
    """Every parameter's gradient of levir_train_loss against jax.grad,
    mapped through flax_to_state_dict, to 1e-3 of the gradient's scale (its
    largest element over all 314 tensors).

    Not each tensor's own scale: fp32 summation order moves a few ReLU
    inputs within ~1e-6 of zero across the kink, and each flip moves the
    gradients of the convolutions below it by about 1 % of their own
    largest element. The test measures it on JAX alone, with the first
    date's input moved by 1e-6, and prints both comparisons as one JSON
    line (pytest -s): per tensor on its own scale (worst, and how many
    tensors exceed 1e-3) and on the gradient's scale."""
    x1, x2, params, stats, label, (_, _, _, ref_grads) = train_case
    model, _, _ = _port_train(params, stats, x1, x2, label)
    named = dict(model.named_parameters())
    assert len(named) == 314

    def as_sd(grads):
        sd = flax_to_state_dict(jax.tree.map(np.asarray, grads), stats)
        return {k: sd[k].numpy() for k in named}

    want = as_sd(ref_grads)
    scale = max(np.abs(v).max() for v in want.values())

    def compare(got):
        errs = {k: np.abs(got[k] - want[k]).max() for k in named}
        own = [errs[k] / np.abs(want[k]).max() for k in named]
        return {"worst_over_scale": float(max(errs.values()) / scale),
                "worst_own_scale": float(max(own)),
                "tensors_own_over_1e-3": int(sum(o > 1e-3 for o in own))}

    moved = x1 + 1e-6 * np.random.RandomState(9).normal(
        size=x1.shape).astype(np.float32)
    port = compare({k: p.grad.numpy() for k, p in named.items()})
    jax_self = compare(as_sd(_jax_train(params, stats, moved, x2, label)[3]))
    print(json.dumps({"port_vs_jax": port, "jax_vs_jax_input_moved_1e-6":
                      jax_self}))
    assert port["worst_over_scale"] <= 1e-3, port


def test_bf16_train_loss_and_grads_match_flax(flax_case, train_case):
    """bf16 compute: the loss to 2e-2 relative, and the cosine similarity
    of all gradients flattened together at least 0.99."""
    x1, x2, params, stats, label, _ = train_case
    ref_loss, _, _, ref_grads = _jax_train(params, stats, x1, x2, label,
                                           jnp.bfloat16)
    model, loss, _ = _port_train(params, stats, x1, x2, label, torch.bfloat16)
    assert loss == pytest.approx(ref_loss, rel=2e-2)
    want = flax_to_state_dict(jax.tree.map(np.asarray, ref_grads), stats)
    named = dict(model.named_parameters())
    got = np.concatenate([named[k].grad.numpy().ravel() for k in named])
    ref = np.concatenate([want[k].numpy().ravel() for k in named])
    cos = got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert cos >= 0.99, cos


def test_eval_logits_match_flax_at_another_img_size():
    """The size-dependent parts (decoder positional embeddings sized by
    ``img_size``, the tokenizer's N, the decoder gate) at a second size:
    64 px, batch 1, where the 1/16 decoder has n = 16 = 4 * n_kv and runs
    layer by layer in both packages while the other two take the stack."""
    img = 64
    rng = np.random.RandomState(7)
    x1 = rng.uniform(-1, 1, (1, img, img, 3)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (1, img, img, 3)).astype(np.float32)
    model = JaxDAHiTra(img_size=img)
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(x1),
                                    jnp.asarray(x2))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _perturb(variables["batch_stats"], rng, {"var"},
                     lambda v: rng.uniform(0.5, 1.5, v.shape)
                     .astype(np.float32))
    ref = np.asarray(jax.jit(lambda p, s, a, b: model.apply(
        {"params": p, "batch_stats": s}, a, b, False))(params, stats, x1, x2))
    port = DAHiTraUNet(img_size=img).eval()
    sd = flax_to_state_dict(params, stats)
    assert sd["pos_embedding_decoder_3"].shape == (1, 32, img // 4, img // 4)
    load_weights(port, sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x1), torch.from_numpy(x2))
    assert got.shape == ref.shape == (1, img, img, 2)
    sc = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy() / sc, ref / sc, rtol=1e-4,
                               atol=1e-4)
