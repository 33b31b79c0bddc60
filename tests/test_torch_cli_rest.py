"""The last LEVIR CLIs of the port (``demo``, ``import_checkpoint``;
``count_params`` in tests/test_torch_count_params.py), ``main_cd`` /
``eval_cd`` on the five zoo keys of this slice, and dropout in the trainer,
on the CPU.

``import_checkpoint`` reads reference-style
``.pt`` files this test writes from port models: the reference's dict keys
(``model_G_state_dict``, the xBD ``state_dict``), DataParallel's ``module.``
prefix, dead modules' keys and ``num_batches_tracked``. The CLIs run with
``--device cpu`` on seeded synthetic trees at 32 px, each test on two of
torch's CPU threads (``few_threads``): their models hold 1.5-41 M
parameters, and under the suite's six workers on eight cores torch's full
thread pools in these parameter-sized passes (init, AdamW, checkpoints)
slowed them 30-50 times and every other file beside them.
"""
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

from dahitra_tpu_torch.cli import demo, eval_cd, import_checkpoint, main_cd
from dahitra_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from dahitra_tpu_torch.data.synthetic import write_synthetic_levir
from dahitra_tpu_torch.models.registry import define_g
from dahitra_tpu_torch.nn.init import init_random
from dahitra_tpu_torch.losses.cd import multi_scale_loss
from dahitra_tpu_torch.train import engine
from dahitra_tpu_torch.train.engine import CDTrainer

IMG = 64
TRAIN_IMG = 32  # the CLI and trainer runs
ZOO = ("unet_coupled_trans_256", "unet_coupled_two_trans_256",
       "siamUnet_conc", "changeFormer", "changeFormerV6")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Seeded synthetic LEVIR splits at 32 px: train 2, val 2, test 2."""
    root = tmp_path_factory.mktemp("levir")
    for split, seed in (("train", 1), ("val", 2), ("test", 3)):
        write_synthetic_levir(str(root / "data"), n_tiles=2, size=TRAIN_IMG,
                              split=split, seed=seed, block=8)
    return root


def _reference_pt(path, sd, wrap="model_G_state_dict", extra=None):
    """A reference-style checkpoint: ``module.``-prefixed keys under
    ``wrap``, plus ``extra`` keys."""
    sd = {**sd, **(extra or {})}
    torch.save({wrap: {f"module.{k}": v for k, v in sd.items()},
                "best_val_acc": 0.5}, str(path))


def _seeded(key, seed=0):
    return init_random(define_g(key, img_size=IMG),
                       torch.Generator().manual_seed(seed))


def test_import_checkpoint_drops_dead_keys_and_round_trips(tmp_path):
    """newUNetTrans: the reference's dead modules (its 4th transformer,
    layer4 and fc of the torchvision trunk, ``num_batches_tracked``) are
    dropped by name; the written best_ckpt.pt loads into the model and
    gives the source model's logits; the xBD ``state_dict`` wrapping of the
    UNet change transformer imports too, its dead ``ca_skip_4`` dropped."""
    src = _seeded("newUNetTrans")
    dead = {"transformer_2.layers.0.0.fn.norm.weight": torch.ones(32),
            "resnet.layer4.0.conv1.weight": torch.zeros(512, 256, 3, 3),
            "resnet.fc.weight": torch.zeros(1000, 512),
            "resnet.bn1.num_batches_tracked": torch.tensor(7)}
    pt = tmp_path / "ref.pt"
    _reference_pt(pt, src.state_dict(), extra=dead)
    path = import_checkpoint.main([str(pt), "--net_G", "newUNetTrans",
                                   "--img_size", str(IMG), "--out",
                                   str(tmp_path / "imp")])
    assert path == str(tmp_path / "imp" / "best_ckpt.pt")
    sd, _ = load_checkpoint(str(tmp_path / "imp"))
    assert set(sd) == set(src.state_dict())
    model = define_g("newUNetTrans", img_size=IMG)
    model.load_state_dict(sd)
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (1, IMG, IMG, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model.eval()(x, x.flip(2)),
                                   src.eval()(x, x.flip(2)), rtol=0, atol=0)

    unet = _seeded("unet_coupled_trans_256")
    pt = tmp_path / "unet.pt"
    _reference_pt(pt, unet.state_dict(), wrap="state_dict",
                  extra={"ca_skip_4.conv1.weight": torch.zeros(256, 512, 3,
                                                               3)})
    import_checkpoint.main([str(pt), "--net_G", "unet_coupled_trans_256",
                            "--img_size", str(IMG), "--out",
                            str(tmp_path / "unet")])
    sd, _ = load_checkpoint(str(tmp_path / "unet"))
    for k, v in unet.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_import_checkpoint_refuses_unknown_missing_and_misshaped(tmp_path):
    """A key no module of the key's reference has, a model key the file
    lacks, and a misshaped key each raise by name; the Dpn92 UNets raise as
    in the JAX package."""
    sd = _seeded("siamUnet_conc").state_dict()
    cases = {"unknown": ({**sd, "conv99.weight": torch.zeros(1)},
                         KeyError, "conv99.weight"),
             "missing": ({k: v for k, v in sd.items() if k != "bn43d.bias"},
                         KeyError, "bn43d.bias"),
             "shape": ({**sd, "conv11.bias": torch.zeros(3)}, ValueError,
                       "conv11.bias")}
    for name, (bad, exc, match) in cases.items():
        pt = tmp_path / f"{name}.pt"
        _reference_pt(pt, bad)
        with pytest.raises(exc, match=match):
            import_checkpoint.main([str(pt), "--net_G", "siamUnet_conc",
                                    "--out", str(tmp_path / name)])
    with pytest.raises(NotImplementedError, match="dpn92"):
        import_checkpoint.convert_reference({}, "xbd_dpn92_loc")


def test_import_checkpoint_trunk_only_warm_starts_res34(tmp_path):
    """--trunk_only: a torchvision resnet34 state_dict (fc and
    ``num_batches_tracked`` included) becomes the zoo's wrapped-trunk names,
    each of which xbd_res34_loc has with the same shape, covering its whole
    encoder; a whole-model file is refused."""
    trunk = _seeded("xbd_res34_loc")
    tv = {}
    for k, v in trunk.state_dict().items():
        for src, dst in import_checkpoint._ZOO_TRUNK:
            if k.startswith(dst):
                tv[src + k[len(dst):]] = v
    tv["fc.weight"] = torch.zeros(1000, 512)
    tv["bn1.num_batches_tracked"] = torch.tensor(3)
    pth = tmp_path / "resnet34.pth"
    torch.save(tv, str(pth))
    import_checkpoint.main([str(pth), "--trunk_only", "--out",
                            str(tmp_path / "trunk")])
    sd, _ = load_checkpoint(str(tmp_path / "trunk"))
    own = define_g("xbd_res34_loc").state_dict()
    enc = {k for k in own if k.split(".")[0] in
           ("conv1", "conv2", "conv3", "conv4", "conv5")}
    assert set(sd) == enc
    for k, v in sd.items():
        torch.testing.assert_close(v, trunk.state_dict()[k], rtol=0, atol=0)
    pt = tmp_path / "whole.pt"
    _reference_pt(pt, _seeded("siamUnet_conc").state_dict())
    with pytest.raises(ValueError, match="torchvision"):
        import_checkpoint.main([str(pt), "--trunk_only", "--out",
                                str(tmp_path / "no")])


def test_demo_writes_predictions(tree, tmp_path, monkeypatch):
    """demo --device cpu over the test split (labels unused): one PNG per
    pair under its name, (32, 32) with values in {0, 255}, the argmax * 255
    of the model's logits."""
    monkeypatch.setenv("DAHITRA_DATA_ROOT", str(tree / "data"))
    model = init_random(define_g("newUNetTrans", img_size=TRAIN_IMG),
                        torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path / "ckpt" / "demo"), model.state_dict())
    out = tmp_path / "pred"
    names = demo.main(["--project_name", "demo", "--checkpoint_root",
                       str(tmp_path / "ckpt"), "--data_name", "LEVIR",
                       "--split", "test", "--img_size", str(TRAIN_IMG),
                       "--output_folder", str(out), "--device", "cpu"])
    assert sorted(names) == sorted(os.listdir(tree / "data" / "LEVIR_CD" /
                                              "test" / "A"))
    for n in names:
        png = np.array(Image.open(out / n))
        assert png.shape == (TRAIN_IMG, TRAIN_IMG) and set(
            np.unique(png)) <= {0, 255}


@pytest.mark.parametrize("key", ZOO)
def test_main_cd_and_eval_cd_on_cpu(key, tree, tmp_path, monkeypatch):
    """One epoch of main_cd at 32 px, batch 2 (``--multi_scale_loss`` for
    changeFormerV6, whose every step then takes ``multi_scale_loss``), then
    eval_cd on its best_ckpt.pt: finite loss, scores in range, the
    augmentation and dropout generators' states saved."""
    monkeypatch.setenv("DAHITRA_DATA_ROOT", str(tree / "data"))
    calls = []
    monkeypatch.setattr(engine, "multi_scale_loss",
                        lambda *a: calls.append(1) or multi_scale_loss(*a))
    common = ["--checkpoint_root", str(tmp_path), "--project_name", key,
              "--img_size", str(TRAIN_IMG), "--batch_size", "2", "--net_G", key,
              "--device", "cpu"]
    extra = ["--multi_scale_loss"] if key == "changeFormerV6" else []
    history = main_cd.main(common + ["--max_epochs", "1", "--skip_test"]
                           + extra)
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert len(calls) == (1 if extra else 0)
    _, meta = load_checkpoint(str(tmp_path / key))
    assert set(meta["generator_states"]) == {"aug", "dropout"}
    scores = eval_cd.main(common)
    assert all(0.0 <= scores[k] <= 1.0 for k in ("acc", "miou", "mf1"))


def _trainer(tmp_path, key):
    args = types.SimpleNamespace(
        n_class=2, checkpoint_dir=str(tmp_path / key), max_epochs=1,
        net_G=key, img_size=TRAIN_IMG, lr=1e-3, batch_size=2, seed=0,
        lr_policy="linear")
    rng = np.random.RandomState(4)
    shape = (2, TRAIN_IMG, TRAIN_IMG)
    arrays = {"a": rng.randint(0, 256, shape + (3,), np.uint8),
              "b": rng.randint(0, 256, shape + (3,), np.uint8),
              "label": (rng.rand(*shape) < 0.3).astype(np.uint8)}
    return CDTrainer(args, arrays, arrays, device="cpu"), [
        torch.from_numpy(arrays[k]) for k in ("a", "b", "label")]


def test_train_step_dropout_reproduces_from_the_seed(tmp_path):
    """CDTrainer steps of siamUnet_conc (Dropout2d 0.2) draw their masks
    from the trainer's dropout generator (seeded from --seed + 1), and two
    trainers from the same --seed give the same loss bits and weights."""
    runs = []
    for _ in range(2):
        trainer, batch = _trainer(tmp_path, "siamUnet_conc")
        fresh = torch.Generator().manual_seed(1).get_state()
        assert torch.equal(trainer.dropout_generator.get_state(), fresh)
        runs.append((trainer.train_step(*batch)[0].item(),
                     next(trainer.model.parameters()).detach().clone()))
        assert not torch.equal(trainer.dropout_generator.get_state(), fresh)
    assert np.isfinite(runs[0][0]) and runs[0][0] == runs[1][0]
    torch.testing.assert_close(runs[0][1], runs[1][1], rtol=0, atol=0)
