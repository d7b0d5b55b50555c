"""The port's Generator ``Trainer`` and the CLI's Generator modes, on the CPU
(``--device cpu``): train -> resume -> eval -> predict on a ci_smoke-like
config, the history keys against the JAX trainer's, the kernel cell path
against the plain one, a Fenhe run split by year, and which settings the
Generator's training still refuses."""
import json
import os

import numpy as np
import pytest
import torch

from pl_convlstm_gan_tpu.config import load_config as jax_load_config
from pl_convlstm_gan_tpu.train.trainer import Trainer as JaxTrainer
from pl_convlstm_gan_tpu_torch import cli
from pl_convlstm_gan_tpu_torch.config import load_config
from pl_convlstm_gan_tpu_torch.predict import load_predictor
from pl_convlstm_gan_tpu_torch.train import SequenceTrainer, Trainer
from pl_convlstm_gan_tpu_torch.train.checkpoint import restore_checkpoint
from test_torch_generator_train import _fenhe_files


def _config(out_dir, epochs=2, **model):
    """configs/ci_smoke.yaml (hidden (8, 8), T 3, 8 px x2, 64 days, B 8)
    with a latest checkpoint every epoch."""
    cfg = load_config("ci_smoke")
    cfg.output.output_dir = str(out_dir)
    cfg.output.save_model_interval = 1
    cfg.training.epochs = epochs
    for k, v in model.items():
        setattr(cfg.model, k, v)
    return cfg


def _yaml(tmp_path, cfg, name):
    path = tmp_path / f"{name}.yaml"
    cfg.to_yaml(str(path))
    return str(path)


def test_cli_train_resume_eval_predict_on_ci_smoke(tmp_path):
    """train 2 epochs, then --resume to 3: it starts at epoch 2, and its
    history equals a straight 3-epoch run's (params, Adam state, step,
    scheduler and history restored; the data order seeded per epoch). The
    history keys are the JAX trainer's. Then --mode eval (loss, RMSE and the
    four parts) and --mode predict on an .npz of rain_lr/dem/lu, whose
    output equals load_predictor's on the best checkpoint and the trained
    module's own forward."""
    out = tmp_path / "out"
    two = _yaml(tmp_path, _config(out, 2), "two")
    three = _yaml(tmp_path, _config(out, 3), "three")
    h2 = cli.main(["--config", two, "--mode", "train", "--device", "cpu"])
    assert h2["epoch"] == [0, 1]
    jax_cfg = jax_load_config("ci_smoke")
    jax_cfg.output.output_dir = str(tmp_path / "jax")
    assert set(h2) == set(JaxTrainer(config=jax_cfg).history)
    h3 = cli.main(["--config", three, "--mode", "train", "--device", "cpu",
                   "--resume"])
    assert h3["epoch"] == [0, 1, 2]
    assert {k: v[:2] for k, v in h3.items()} == h2
    with open(out / "metrics.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1, 2]
    straight = Trainer(config=_config(tmp_path / "straight", 3), device="cpu")
    assert straight.train() == h3
    _, host = restore_checkpoint(str(out / "latest"))
    _, host_ref = restore_checkpoint(str(tmp_path / "straight" / "latest"))
    assert host["scheduler"] == host_ref["scheduler"] and host["epoch"] == 2
    with open(out / "history.json") as f:
        assert json.load(f) == h3

    metrics = cli.main(["--config", three, "--mode", "eval", "--device",
                        "cpu"])
    assert set(metrics) == {"loss", "rmse", "point", "conserve", "smooth",
                            "temporal"}
    assert all(np.isfinite(v) for v in metrics.values())

    rng = np.random.default_rng(0)
    inp, pred_path = tmp_path / "lr.npz", tmp_path / "pred.npy"
    arrays = dict(rain_lr=rng.random((2, 3, 1, 8, 8), dtype=np.float32) * 4,
                  dem=rng.random((2, 1, 16, 16), dtype=np.float32),
                  lu=rng.random((2, 5, 16, 16), dtype=np.float32))
    np.savez(inp, **arrays)
    cli.main(["--config", three, "--mode", "predict", "--input", str(inp),
              "--output", str(pred_path), "--device", "cpu"])
    written = np.load(pred_path)
    assert written.shape == (2, 3, 1, 16, 16)
    best = str(out / "best_model")
    cfg3 = load_config(three)
    np.testing.assert_array_equal(
        written, load_predictor(cfg3, best, device="cpu")(
            *arrays.values()).numpy())
    straight.restore(best)
    with torch.no_grad():
        ref = straight.model(*map(torch.from_numpy, arrays.values()))
    np.testing.assert_array_equal(written, ref.numpy())


def test_cli_generator_refusals(tmp_path):
    """--mode stream is the sequence families' mode: refused by name for
    the Generator; predict needs an .npz of rain_lr/dem/lu."""
    cfg = _yaml(tmp_path, _config(tmp_path / "out"), "cfg")
    frames = tmp_path / "frames.npy"
    np.save(frames, np.zeros((1, 3, 1, 8, 8), np.float32))
    with pytest.raises(SystemExit, match="sequence family"):
        cli.main(["--config", cfg, "--mode", "stream", "--input", str(frames),
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="rain_lr/dem/lu"):
        cli.main(["--config", cfg, "--mode", "predict", "--input",
                  str(frames), "--checkpoint", str(frames), "--device", "cpu"])


def test_pallas_impl_trains_like_the_plain_step(tmp_path):
    """convlstm_impl pallas (K1's plain version with z and the custom
    backward on CPU tensors) against xla (autograd through the plain step):
    the same history for two epochs, rtol 1e-5 (float32, sums in other
    orders)."""
    hist = {}
    for impl in ("pallas", "xla"):
        trainer = Trainer(config=_config(tmp_path / impl, 2,
                                         convlstm_impl=impl), device="cpu")
        hist[impl] = trainer.train()
        assert trainer.model.convlstm_impl == (
            "kernel" if impl == "pallas" else "torch")
    for key in ("total_loss", "point_loss", "rmse"):
        np.testing.assert_allclose(hist["pallas"][key], hist["xla"][key],
                                   rtol=1e-5)


def test_trainer_on_fenhe_files_splits_by_year(tmp_path):
    """source fenhe with split_method year: train on 2012's windows,
    validate and test on 2013's (each year's last T dropped); the LUCC
    class count comes from the data."""
    kw = _fenhe_files(tmp_path, multiyear=True)
    cfg = _config(tmp_path / "out", 1, T=5, hidden_dims=[4, 4])
    cfg.data.source = "fenhe"
    cfg.data.rain_lr_path, cfg.data.dem_path = kw["rain_lr_path"], \
        kw["dem_path"]
    cfg.data.lucc_path, cfg.data.meta_path = kw["lucc_path"], \
        kw["rain_meta_path"]
    cfg.data.rain_excel_path, cfg.data.shp_path = kw["rain_station_path"], \
        kw["shp_path"]
    cfg.data.start_year, cfg.data.end_year = 2012, 2013
    cfg.training.split_method = "year"
    cfg.training.batch_size = 64
    cfg.training.train_years = [2012, 2012]
    cfg.training.val_years = cfg.training.test_years = [2013, 2013]
    trainer = Trainer(config=cfg, device="cpu")
    history = trainer.train()
    assert len(trainer.train_dataset) == 366 - 5
    assert len(trainer.val_dataset) == len(trainer.test_dataset) == 365 - 5
    assert trainer.model.lu_attn.conv_reduce.weight.shape[1] == 3
    assert np.isfinite(history["rmse"][0]) and \
        os.path.isdir(tmp_path / "out" / "best_model")


def test_generator_training_settings():
    """The Generator family trains (configs/default.yaml passes
    validate(training=True)); data parallelism (A9) is ported, so
    data_axis 4 passes validate(training=True) and is refused by a
    single-process Trainer, which has no 4 ranks (ValueError naming
    torchrun); model.remat is a forecaster setting, which validate(
    training=True) takes; TP stays refused, target_grid_size without
    input_grid_size stays an error, and each trainer refuses the other's
    families."""
    cfg = load_config("default")
    cfg.validate(training=True)
    for section, key, value, item in (("model", "remat", True, "A3"),
                                      ("mesh", "data_axis", 4, "A9")):
        bad = load_config("default")
        setattr(getattr(bad, section), key, value)
        bad.validate(training=True)
        if item == "A9":
            with pytest.raises(ValueError, match="needs 4 ranks"):
                Trainer(config=bad, device="cpu")
    bad = load_config("default")
    bad.mesh.model_axis = 2
    with pytest.raises(ValueError, match="DP-only"):
        bad.validate(training=True)
    bad = load_config("default")
    bad.model.target_grid_size = [500, 500]
    with pytest.raises(ValueError, match="input_grid_size"):
        bad.validate()
    with pytest.raises(ValueError, match="Trainer"):
        SequenceTrainer(config=load_config("ci_smoke"), device="cpu")
    with pytest.raises(ValueError, match="SequenceTrainer"):
        Trainer(config=load_config("ci_smoke_seq"), device="cpu")
