"""The port's training pieces against the JAX package's, on the CPU.

Train-mode BatchNorm (``PairBatchNorm``, pair False and True), the LEVIR
losses with their gradients, AdamW and the learning-rate schedules, the
train branch of the augmentation, ``init_net``, the shuffling loader, and
``main_cd`` end to end with resume. Inputs are seeded numpy handed to both
packages; tolerances are scale-normalized where not stated.
"""
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dahitra_tpu.data import augment as jaug
from dahitra_tpu.data.loader import BatchLoader as JaxLoader
from dahitra_tpu.losses import cd as jloss
from dahitra_tpu.models.dahitra import DAHiTraUNet as JaxDAHiTra
from dahitra_tpu.nn.init import init_weights_variables
from dahitra_tpu.nn.resnet import PairBatchNorm
from dahitra_tpu.train import optim as joptim
from dahitra_tpu_torch.cli import main_cd
from dahitra_tpu_torch.core.flax_import import flax_to_state_dict
from dahitra_tpu_torch.data import augment as taug
from dahitra_tpu_torch.data.loader import BatchLoader
from dahitra_tpu_torch.data.synthetic import write_synthetic_levir
from dahitra_tpu_torch.losses import cd as tloss
from dahitra_tpu_torch.models.dahitra import DAHiTraUNet
from dahitra_tpu_torch.nn.blocks import BatchNorm
from dahitra_tpu_torch.nn.init import init_weights
from dahitra_tpu_torch.train import optim as toptim


def _close(got, ref, tol):
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    sc = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(got / sc, ref / sc, rtol=tol, atol=tol)


# ---------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("pair", [False, True])
def test_train_batchnorm_matches_pair_batchnorm(pair):
    """Output and updated batch_stats of train-mode BatchNorm against flax
    PairBatchNorm (biased variance, momentum 0.9, per-date statistics and
    the composed update with ``pair``), to 1e-5."""
    rng = np.random.RandomState(0)
    x = (rng.normal(size=(4, 6, 5, 16)) * 2 + 0.5).astype(np.float32)
    x[2:] = x[2:] * 3 - 1  # the two dates differ in their statistics
    scale, bias = (rng.normal(size=16).astype(np.float32) for _ in "sb")
    mean = (0.1 * rng.normal(size=16)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    ref, mut = PairBatchNorm().apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}},
        jnp.asarray(x), False, pair, mutable=["batch_stats"])
    bn = BatchNorm(16)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    got = bn(torch.from_numpy(x), train=True, pair=pair)
    _close(got, ref, 1e-5)
    _close(bn.running_mean, mut["batch_stats"]["mean"], 1e-5)
    _close(bn.running_var, mut["batch_stats"]["var"], 1e-5)
    # eval mode reads the updated running statistics
    ref_eval = PairBatchNorm().apply(
        {"params": {"scale": scale, "bias": bias}, **mut}, jnp.asarray(x),
        True)
    _close(bn(torch.from_numpy(x)), ref_eval, 1e-5)


# ------------------------------------------------------------------- losses

def _loss_case(b=2, seed=1, ignore=True):
    rng = np.random.RandomState(seed)
    logits = (2 * rng.normal(size=(b, 8, 8, 2))).astype(np.float32)
    target = rng.randint(0, 2, (b, 8, 8)).astype(np.uint8)
    if ignore:
        target[:, :2, :3] = 255
    return logits, target


_LOSSES = {
    "ce": (lambda l, t: jloss.cross_entropy(l, t),
           lambda l, t: tloss.cross_entropy(l, t)),
    "ce_weighted": (lambda l, t: jloss.cross_entropy(l, t, weight=[0.3, 2.0]),
                    lambda l, t: tloss.cross_entropy(l, t, weight=[0.3, 2.0])),
    "focal": (lambda l, t: jloss.focal_loss(l, t),
              lambda l, t: tloss.focal_loss(l, t)),
    "focal_ignore": (lambda l, t: jloss.focal_loss(l, t, ignore_index=255),
                     lambda l, t: tloss.focal_loss(l, t, ignore_index=255)),
    "dice_ignore": (lambda l, t: jloss.dice_argmax(l, t, ignore_index=255),
                    lambda l, t: tloss.dice_argmax(l, t, ignore_index=255)),
    "levir_b2": (lambda l, t: jloss.levir_train_loss(l, t, 2),
                 lambda l, t: tloss.levir_train_loss(l, t, 2)),
    "levir_b1": (lambda l, t: jloss.levir_train_loss(l, t, 1),
                 lambda l, t: tloss.levir_train_loss(l, t, 1)),
}


@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_loss_values_and_logit_grads_match_jax(name):
    jfn, tfn = _LOSSES[name]
    logits, target = _loss_case(b=1 if name == "levir_b1" else 2,
                                ignore=name != "focal")
    ref, rgrad = jax.value_and_grad(jfn)(jnp.asarray(logits),
                                         jnp.asarray(target))
    lt = torch.from_numpy(logits).requires_grad_()
    got = tfn(lt, torch.from_numpy(target))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6, atol=1e-7)
    if got.requires_grad:
        got.backward()
        _close(lt.grad, rgrad, 1e-5)
    else:  # dice on the argmax carries no gradient, as under stop_gradient
        assert not np.asarray(rgrad).any()


def test_dice_is_zero_on_an_empty_target():
    logits, _ = _loss_case()
    empty = np.zeros((2, 8, 8), np.uint8)
    assert float(jloss.dice_argmax(jnp.asarray(logits), empty)) == 0.0
    assert tloss.dice_argmax(torch.from_numpy(logits),
                             torch.from_numpy(empty)).item() == 0.0


# ------------------------------------------------ optimizer and schedules

@pytest.mark.parametrize("clip", [None, 0.5])
def test_two_adamw_steps_match_optax(clip):
    """Two steps from the same gradients, the LR set between them, against
    optax's injectable AdamW (and its global-norm clip), to 1e-6."""
    rng = np.random.RandomState(2)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in (("w", (4, 3)), ("b", (3,)))}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    tx = joptim.make_optimizer(1e-2, weight_decay=0.01, clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = toptim.make_optimizer(tp.values(), 1e-2, weight_decay=0.01,
                                clip_norm=clip)
    for step, (g, lr) in enumerate(zip(grads, (1e-2, 3e-3))):
        state = joptim.set_learning_rate(state, lr)
        toptim.set_learning_rate(opt, lr)
        assert toptim.current_learning_rate(opt) == pytest.approx(
            joptim.current_learning_rate(state))
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


def test_schedules_equal_jax():
    for policy in ("linear", "step", "multistep", "constant"):
        for after in (False, True):
            for epoch in range(0, 60, 3):
                assert toptim.epoch_lr(1e-3, epoch, policy, 50,
                                       after_epoch_step=after) == \
                    joptim.epoch_lr(1e-3, epoch, policy, 50,
                                    after_epoch_step=after)
    for step in (0, 7, 50, 99, 100, 140):
        assert toptim.poly_lr(1e-3, step, 100) == joptim.poly_lr(1e-3, step,
                                                                 100)
        assert toptim.sgdr_lr(1e-3, step, 30, 0.1) == joptim.sgdr_lr(
            1e-3, step, 30, 0.1)
    with pytest.raises(NotImplementedError):
        toptim.epoch_lr(1e-3, 0, "cosine", 10)


# ------------------------------------------------------------ augmentation

@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_blur_matches_separable_blur(dname):
    """The per-sample blur against _separable_blur at fixed sigmas, each
    pass stored in the image dtype: fp32 to 1e-6, bf16 bit for bit up to
    one rounding step."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dname]
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (3, 12, 10, 3)).astype(np.float32) / 255.0
    sigmas = np.array([0.0, 0.37, 0.93], np.float32)
    ref = np.stack([np.asarray(jaug._separable_blur(
        jnp.asarray(im, jdt), jnp.float32(s)), np.float32)
        for im, s in zip(imgs, sigmas)])
    got = taug.separable_blur(torch.from_numpy(imgs).to(getattr(torch, dname)),
                              torch.from_numpy(sigmas))
    assert got.dtype == getattr(torch, dname)
    tol = 1e-6 if dname == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)
    np.testing.assert_allclose(ref[0], imgs[0], rtol=0, atol=tol)  # sigma 0


def test_train_flips_move_the_label_with_the_images():
    """With flips only, every sample stays pair-consistent: the label still
    marks the pixels where A and B differ, and the images are a flip of the
    inputs."""
    rng = np.random.RandomState(4)
    a = rng.randint(0, 256, (16, 8, 8, 3)).astype(np.uint8)
    label = (rng.rand(16, 8, 8) < 0.3).astype(np.uint8)
    b = np.where(label[..., None] == 1, 255 - a, a).astype(np.uint8)
    gen = torch.Generator().manual_seed(0)
    ta, tb, tl = taug.augment_pairs(*(torch.from_numpy(t) for t in
                                      (a, b, label)), train=True,
                                    generator=gen, blur=False, rot=True)
    differs = (ta != tb).any(-1)
    assert torch.equal(differs, tl.bool())
    seen = set()
    ua = ((ta + 1) * 127.5).round().to(torch.uint8).numpy()
    for i in range(16):
        for hf in (0, 1):
            for vf in (0, 1):
                for k in range(4):
                    t = np.rot90(a[i][::-1 if vf else 1, ::-1 if hf else 1],
                                 k, (0, 1))
                    if np.array_equal(ua[i], t):
                        seen.add((hf, vf, k))
    assert len(seen) > 3  # the draws vary across samples
    eval_a, _, eval_l = taug.augment_pairs(
        *(torch.from_numpy(t) for t in (a, b, label)))
    assert eval_l.dtype == torch.int64 and torch.equal(eval_l,
                                                       torch.from_numpy(label)
                                                       .long())
    with pytest.raises(ValueError, match="generator"):
        taug.augment_pairs(*(torch.from_numpy(t) for t in (a, b, label)),
                           train=True)


def test_loader_shuffles_as_the_jax_loader():
    arrays = {"a": np.arange(11), "label": np.arange(11) * 2}
    for drop_last in (False, True):
        port = BatchLoader(arrays, 4, shuffle=True, seed=7,
                           drop_last=drop_last)
        ref = JaxLoader(arrays, 4, shuffle=True, seed=7, drop_last=drop_last)
        assert len(port) == len(ref)
        for _ in range(3):  # epochs draw new permutations
            assert [b["a"].tolist() for b in port] == \
                [b["a"].tolist() for b in ref]


# ------------------------------------------------------------------- init

def test_init_touches_what_init_net_touches():
    """Starting from one sentinel tree, init_weights changes exactly the
    parameters init_weights_variables changes (LayerNorm biases aside: the
    JAX sweep zeroes them, a no-op on their zero default, and the port
    leaves LayerNorms alone), and the draws have the same statistics."""
    img = 64
    shapes = jax.eval_shape(lambda: JaxDAHiTra(img_size=img).init(
        jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)),
        jnp.zeros((1, img, img, 3))))
    sentinel = jax.tree.map(lambda s: np.full(s.shape, 3.0, np.float32),
                            shapes)
    out = init_weights_variables(
        {"params": jax.tree.map(jnp.asarray, sentinel["params"]),
         "batch_stats": sentinel["batch_stats"]}, jax.random.PRNGKey(1))
    before = flax_to_state_dict(sentinel["params"], sentinel["batch_stats"])
    after_jax = flax_to_state_dict(jax.tree.map(np.asarray, out["params"]),
                                   sentinel["batch_stats"])
    port = DAHiTraUNet(img_size=img)
    port.load_state_dict(before)
    init_weights(port, "normal", 0.02, torch.Generator().manual_seed(1))
    after_port = port.state_dict()
    changed_jax = {k for k in before
                   if not torch.equal(after_jax[k], before[k])}
    changed_port = {k for k in before
                    if not torch.equal(after_port[k], before[k])}
    ln_bias = {k for k in changed_jax - changed_port
               if re.search(r"\.fn\.norm\.bias$", k)}
    assert changed_jax - ln_bias == changed_port
    assert len(changed_port) > 200

    def stats(sd, keys):
        v = torch.cat([sd[k].flatten() for k in sorted(keys)])
        return v.mean().item(), v.std().item()

    weights = {k for k in changed_port if k.endswith("weight")
               and after_port[k].dim() > 1}
    bn = {k for k in changed_port if k.endswith("weight")
          and after_port[k].dim() == 1}
    for keys, mean in ((weights, 0.0), (bn, 1.0)):
        (pm, ps), (jm, js) = stats(after_port, keys), stats(after_jax, keys)
        assert abs(pm - mean) < 2e-3 and abs(jm - mean) < 2e-3
        assert ps == pytest.approx(0.02, rel=0.05)
        assert js == pytest.approx(0.02, rel=0.05)
    for init_type in ("xavier", "kaiming", "orthogonal"):
        init_weights(port, init_type, 0.02, torch.Generator().manual_seed(2))
    w = port.conv_decode_3.weight.detach().reshape(32, -1)  # orthogonal rows
    torch.testing.assert_close(w @ w.t(), 0.02 ** 2 * torch.eye(32),
                               rtol=1e-4, atol=1e-7)


# ----------------------------------------------------------- end to end

@pytest.fixture
def few_threads():
    """torch on 2 CPU threads: under the suite's six workers on eight cores
    full thread pools in the parameter-sized passes of the CLI runs (init,
    AdamW, checkpoints) slow them several times."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synthetic_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    write_synthetic_levir(str(root / "data"), n_tiles=4, size=64,
                          split="train", seed=1, block=8)
    write_synthetic_levir(str(root / "data"), n_tiles=2, size=64,
                          split="val", seed=2, block=8)
    return root


def _argv(root, *extra):
    return ["--checkpoint_root", str(root / "ckpt"), "--project_name", "cpu",
            "--img_size", "64", "--batch_size", "2", "--max_epochs", "2",
            "--log_every", "1", *extra]


def test_main_cd_trains_and_resumes_on_cpu(synthetic_tree, monkeypatch,
                                          few_threads):
    """Two epochs at 64 px, batch 2: the reference artifacts, a finite loss
    in log.txt, a test pass, the epoch-0 profiler trace and the training
    vis grids; a rerun resumes from best_ckpt.pt after the saved epoch,
    optimizer state included."""
    monkeypatch.setenv("DAHITRA_DATA_ROOT", str(synthetic_tree / "data"))
    trace = synthetic_tree / "trace"
    history = main_cd.main(_argv(synthetic_tree, "--device", "cpu",
                                 "--profile_dir", str(trace),
                                 "--vis_train_every", "2"))
    d = synthetic_tree / "ckpt" / "cpu"
    for f in ("best_ckpt.pt", "log.txt", "train_acc.npy", "val_acc.npy",
              "log_test.txt", "scores_dict.npy"):
        assert (d / f).exists(), f
    assert (trace / "trace.json").stat().st_size > 0
    assert sorted(p.name for p in (d / "vis").iterdir()) == [
        "train_e0_b2.jpg", "train_e1_b2.jpg"]
    assert len(history) == 2
    log = (d / "log.txt").read_text()
    losses = [float(v) for v in re.findall(r"G_loss: ([-\d.naninf]+)", log)]
    assert losses and np.isfinite(losses).all()
    assert np.load(d / "val_acc.npy").shape == (2,)
    ckpt = torch.load(d / "best_ckpt.pt", weights_only=False)
    assert {"model_G_state_dict", "optimizer_G_state_dict", "epoch_id",
            "best_val_acc", "best_epoch_id"} <= set(ckpt)
    saved = ckpt["epoch_id"]
    rerun = main_cd.main(_argv(synthetic_tree, "--device", "cpu",
                               "--skip_test"))
    assert len(rerun) == 2 - (saved + 1)
    assert f"Epoch_to_start = {saved + 1}" in (d / "log.txt").read_text()


def test_main_cd_default_device_without_cuda_raises(synthetic_tree,
                                                    monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    monkeypatch.setenv("DAHITRA_DATA_ROOT", str(synthetic_tree / "data"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_cd.main(_argv(synthetic_tree))
    help_text = main_cd.build_parser().format_help()
    assert "CUDA-graph replay" in help_text and "--device" in help_text


def test_train_step_batch_of_one_takes_cross_entropy(tmp_path, few_threads):
    """A ragged last batch of one takes the CE branch, as the reference's
    trainer does with its batch size."""
    import copy

    from dahitra_tpu_torch.train.engine import CDTrainer

    rng = np.random.RandomState(5)
    arrays = {"a": rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8),
              "b": rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8),
              "label": rng.randint(0, 2, (3, 32, 32)).astype(np.uint8)}
    args = types.SimpleNamespace(
        n_class=2, checkpoint_dir=str(tmp_path), max_epochs=1,
        net_G="newUNetTrans", img_size=32, lr=1e-3, batch_size=2,
        lr_policy="linear")
    trainer = CDTrainer(args, arrays, arrays, device="cpu")
    a, b, l = (torch.from_numpy(arrays[k][:1]) for k in ("a", "b", "label"))
    gen = torch.Generator().set_state(trainer.aug_generator.get_state())
    with torch.no_grad():  # the same draws as the step's augmentation
        an, bn_, ln = taug.augment_pairs(a, b, l, train=True, generator=gen)
        want = tloss.cross_entropy(copy.deepcopy(trainer.model)(
            an, bn_, train=True).float(), ln)
    loss, cm = trainer.train_step(a, b, l)
    torch.testing.assert_close(loss, want)
    assert cm.sum().item() == 32 * 32
    assert np.isfinite(trainer.train_one_epoch(0)["loss"])  # 2 + 1 pairs
