"""The port's evaluation path end to end on the CPU, against the JAX package.

A seeded synthetic LEVIR tree of 128 px tiles goes through the port's
``eval_cd`` (``--device cpu``) and through ``dahitra_tpu``'s ``CDEvaluator``
with the same weights (the flax init, carried over by
``flax_to_state_dict``). The confusion matrices may differ by at most 0.1 %
of the pixels: an argmax tie can break either way.
"""
import os
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dahitra_tpu.core.mesh import mesh_from_gpu_ids
from dahitra_tpu.data.augment import augment_pairs as jax_augment_pairs
from dahitra_tpu.evalx.evaluator import CDEvaluator as JaxEvaluator
from dahitra_tpu.metrics import confusion as jconf
from dahitra_tpu.models.dahitra import DAHiTraUNet as JaxDAHiTra
from dahitra_tpu_torch.cli import eval_cd
from dahitra_tpu_torch.core.checkpoint import save_checkpoint
from dahitra_tpu_torch.core.flax_import import flax_to_state_dict
from dahitra_tpu_torch.data.augment import augment_pairs
from dahitra_tpu_torch.data.levir import load_levir_split
from dahitra_tpu_torch.data.synthetic import write_synthetic_levir
from dahitra_tpu_torch.evalx.evaluator import CDEvaluator
from dahitra_tpu_torch.metrics import confusion as tconf
from dahitra_tpu_torch.models.registry import define_g

IMG = 128
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Synthetic tree, seeded flax weights, a port checkpoint and the JAX
    evaluator's confusion matrix."""
    tmp = tmp_path_factory.mktemp("eval")
    root = write_synthetic_levir(str(tmp / "data"), n_tiles=4, size=IMG,
                                 block=8, seed=0)
    model = JaxDAHiTra(img_size=IMG)
    zeros = jnp.zeros((1, IMG, IMG, 3))
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), zeros, zeros)
    rng = np.random.RandomState(2)
    stats = jax.tree.map(
        lambda v: (rng.uniform(0.5, 1.5, v.shape) if np.all(np.asarray(v) == 1)
                   else 0.1 * rng.normal(size=v.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree.map(np.asarray, variables["params"])
    ckpt_dir = tmp / "ckpt" / "synthetic"
    save_checkpoint(str(ckpt_dir), flax_to_state_dict(params, stats))

    pairs = load_levir_split(root, "test", IMG)
    arrays = {"a": pairs.a, "b": pairs.b, "label": pairs.label}
    args = types.SimpleNamespace(n_class=2, checkpoint_dir=str(tmp / "jax"),
                                 bf16=False, net_G="newUNetTrans",
                                 img_size=IMG, batch_size=2)
    ev = JaxEvaluator(args, arrays, mesh=mesh_from_gpu_ids("0"),
                      state=types.SimpleNamespace(params=params,
                                                  batch_stats=stats))
    jax_cm = sum(np.asarray(ev._eval_step(ev.params, ev.batch_stats, a, b, l)[0])
                 for a, b, l in ev.stage_on_device())
    return types.SimpleNamespace(tmp=tmp, ckpt_root=str(tmp / "ckpt"),
                                 data_root=str(tmp / "data"), arrays=arrays,
                                 jax_cm=jax_cm)


def _argv(case, *extra):
    return ["--checkpoint_root", case.ckpt_root, "--project_name", "synthetic",
            "--img_size", str(IMG), "--batch_size", "2", *extra]


def test_eval_cli_writes_artifacts(case, monkeypatch):
    monkeypatch.setenv("DAHITRA_DATA_ROOT", case.data_root)
    scores = eval_cd.main(_argv(case, "--device", "cpu"))
    d = os.path.join(case.ckpt_root, "synthetic")
    log = open(os.path.join(d, "log_test.txt")).read()
    assert "Eval Historical_best_acc" in log and "mf1:" in log
    saved = np.load(os.path.join(d, "scores_dict.npy"), allow_pickle=True).item()
    assert saved["mf1"] == scores["mf1"]
    assert os.path.exists(os.path.join(d, f"{scores['mf1']}.txt"))
    assert 0.0 <= scores["mf1"] <= 1.0


def test_confusion_matrix_matches_jax_evaluator(case):
    args = types.SimpleNamespace(
        n_class=2, checkpoint_dir=os.path.join(case.ckpt_root, "synthetic"),
        bf16=False, net_G="newUNetTrans", img_size=IMG, batch_size=2)
    ev = CDEvaluator(args, case.arrays, device="cpu")
    ev.eval_models(device_cache=True)
    got, ref = ev.confusion_matrix, case.jax_cm
    assert got.sum() == ref.sum() == 4 * IMG * IMG
    assert np.abs(got - ref).sum() / 2 <= 1e-3 * ref.sum(), (got, ref)


def test_patch_sweep_crops_and_scores_each_patch(tmp_path, monkeypatch):
    """Tiles wider than twice img_size are swept patch by patch at the
    reference's fixed origins, with a score block per patch; --save_vis
    writes one comparison grid per batch under vis/<project>."""
    root = write_synthetic_levir(str(tmp_path / "data"), n_tiles=2, size=512,
                                 seed=3)
    tile = load_levir_split(root, "test", 512)
    p1 = load_levir_split(root, "test", IMG, patch=1)
    np.testing.assert_array_equal(p1.a, tile.a[:, 0:IMG, 256:256 + IMG])
    port = define_g("newUNetTrans", img_size=IMG)
    port.init_weights(torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path / "ckpt" / "sweep"), port.state_dict())
    monkeypatch.setenv("DAHITRA_DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.chdir(tmp_path)
    scores = eval_cd.main(["--checkpoint_root", str(tmp_path / "ckpt"),
                           "--project_name", "sweep", "--img_size", str(IMG),
                           "--batch_size", "2", "--num_patches", "2",
                           "--device", "cpu", "--save_vis"])
    assert [g["patch"] for g in scores["per_group"]] == [0, 1]
    assert sorted(os.listdir(tmp_path / "vis" / "sweep")) == [
        "eval_2.jpg", "eval_4.jpg"]


def test_default_device_without_cuda_raises(case, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    monkeypatch.setenv("DAHITRA_DATA_ROOT", case.data_root)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_cd.main(_argv(case))


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_eval_normalisation_matches_jax(dname):
    rng = np.random.RandomState(4)
    a, b = (rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8) for _ in "ab")
    lbl = rng.randint(0, 2, (2, 8, 8)).astype(np.uint8)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dname]
    ja, jb_, jl = jax_augment_pairs(a, b, lbl, jax.random.PRNGKey(0),
                                    train=False, dtype=jdt)
    ta, tb_, tl = augment_pairs(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(lbl),
                                dtype=getattr(torch, dname))
    # bf16 agrees bit for bit; in fp32 XLA divides by 255 as a product with
    # its reciprocal, which may differ by one ulp from the true quotient.
    atol = 2 ** -23 if dname == "float32" else 0.0
    for got, ref in ((ta, ja), (tb_, jb_), (tl, jl)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=0,
                                   atol=atol)


def test_confusion_metrics_match_jax():
    rng = np.random.RandomState(5)
    pred = rng.randint(0, 3, (4, 16, 16))
    gt = rng.randint(0, 3, (4, 16, 16)).astype(np.uint8)
    gt[:, :2] = 255  # the ignore label
    ref_b = np.asarray(jconf.batch_confusion_matrix(pred, gt, 3))
    ref_s = np.asarray(jconf.per_sample_confusion_matrix(pred, gt, 3))
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    np.testing.assert_array_equal(
        tconf.batch_confusion_matrix(tp, tg, 3).numpy(), ref_b)
    np.testing.assert_array_equal(
        tconf.per_sample_confusion_matrix(tp, tg, 3).numpy(), ref_s)
    assert tconf.cm2score(ref_b) == jconf.cm2score(ref_b)
    acc = tconf.ConfusionAccumulator(3)
    acc.update(tp, tg)
    assert acc.scores() == jconf.cm2score(ref_b)
    assert acc.f1() == jconf.cm2f1(ref_b)


def test_port_imports_neither_jax_nor_the_jax_package():
    """No file of the port, nor chip_smoke.py, imports jax, flax or
    dahitra_tpu (dahitra_tpu_torch itself is fine)."""
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax|dahitra_tpu)"
        r"(?![\w])", re.M)
    files = list((REPO / "dahitra_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
