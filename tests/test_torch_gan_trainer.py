"""The port's trainer on the GAN family, on the CPU (``--device cpu``):
train -> resume -> eval through the CLI, the checkpoint bundle, and serving
a GAN checkpoint's generator (``gen_params``) through ``load_predictor`` and
``StreamingForecaster.from_checkpoint``.

The config is the JAX trainer test's GAN config (tests/test_sequence_trainer.py
``_cfg(..., "gan")``: one 8-channel cell, 16 px, 2 frames in / 3 out, B 8,
scheduled sampling) with discriminator features (8, 16) and 24 sequences."""
import json
import os

import numpy as np
import pytest
import torch

from pl_convlstm_gan_tpu_torch import cli
from pl_convlstm_gan_tpu_torch.config import Config
from pl_convlstm_gan_tpu_torch.predict import load_predictor
from pl_convlstm_gan_tpu_torch.streaming import StreamingForecaster
from pl_convlstm_gan_tpu_torch.train import SequenceTrainer
from pl_convlstm_gan_tpu_torch.train.checkpoint import restore_checkpoint

GAN_KEYS = {"gen_params", "disc_params", "gen_opt_state", "disc_opt_state",
            "step"}


def _config(out_dir, epochs=2, **training):
    return Config.from_dict({
        "data": {"source": "synthetic", "synthetic_num_sequences": 24,
                 "synthetic_image_size": 16},
        "model": {"family": "gan", "hidden_dims": [8], "input_frames": 2,
                  "output_frames": 3, "disc_features": [8, 16],
                  "convlstm_impl": "pallas"},
        "training": {"batch_size": 8, "epochs": epochs, "learning_rate": 1e-3,
                     "disc_learning_rate": 2e-3, "use_split": True,
                     "use_early_stopping": False, "scheduled_sampling": True,
                     "sampling_decay_epochs": 4, **training},
        "output": {"output_dir": str(out_dir), "log_interval": 100,
                   "save_model_interval": 1},
    })


def _yaml(tmp_path, cfg, name):
    path = tmp_path / f"{name}.yaml"
    cfg.to_yaml(str(path))
    return str(path)


@pytest.mark.parametrize("impl", ["default", "vjp"])
def test_gan_cli_train_resume_eval(tmp_path, impl):
    """train 2 epochs, --resume to 3 (it starts at epoch 2 and its history
    equals a straight 3-epoch run's: params, both Adam states, step,
    scheduler and history are restored), then --mode eval. g_loss and
    d_loss are finite, the D LR stays constant while G's is the
    scheduler's, and the checkpoints hold the five GAN entries."""
    out = tmp_path / "out"
    two = _yaml(tmp_path, _config(out, 2, gan_step_impl=impl), "two")
    three = _yaml(tmp_path, _config(out, 3, gan_step_impl=impl), "three")
    h2 = cli.main(["--config", two, "--mode", "train", "--device", "cpu"])
    assert h2["epoch"] == [0, 1]
    h3 = cli.main(["--config", three, "--mode", "train", "--device", "cpu",
                   "--resume"])
    assert h3["epoch"] == [0, 1, 2]
    assert {k: v[:2] for k, v in h3.items()} == h2
    assert all(np.isfinite(h3["g_loss"])) and all(np.isfinite(h3["d_loss"]))
    assert h3["total_loss"] == h3["g_loss"]
    straight = SequenceTrainer(config=_config(tmp_path / "straight", 3,
                                              gan_step_impl=impl),
                               device="cpu")
    assert straight.train() == h3
    assert straight.disc_lr == 2e-3
    assert straight.state.disc_optimizer.param_groups[0]["lr"] == 2e-3
    with open(out / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["epoch"] for r in lines] == [0, 1, 2]
    assert {"train_d_total", "train_g_total", "train_g_adv", "train_g_l1",
            "train_d_real", "train_d_fake", "train_skipped",
            "val_l1"} <= set(lines[0])
    for name in ("latest", "best_model"):
        assert set(restore_checkpoint(str(out / name))[0]) == GAN_KEYS
    state, host = restore_checkpoint(str(out / "latest"))
    assert state["step"] == 3 * 2 and host["epoch"] == 2   # 2 batches/epoch
    metrics = cli.main(["--config", three, "--mode", "eval", "--device",
                        "cpu"])
    assert {"l1", "ssim"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())


def test_gan_checkpoint_serves_its_generator(tmp_path):
    """load_predictor and StreamingForecaster.from_checkpoint read a GAN
    checkpoint's gen_params (the JAX restore_params rule): the predictor
    equals the trained generator's own forward on the kernel and the plain
    path, and streaming's window + forecast equals it."""
    cfg = _config(tmp_path / "out", 1)
    trainer = SequenceTrainer(config=cfg, device="cpu")
    trainer.train()
    best = os.path.join(cfg.output.output_dir, "best_model")
    assert "params" not in restore_checkpoint(best)[0]
    frames = np.random.default_rng(0).random((2, 2, 1, 16, 16),
                                             dtype=np.float32)
    with torch.no_grad():
        ref = trainer.model(torch.from_numpy(frames))
    for impl in ("kernel", "torch"):
        cfg.model.rollout_impl = impl
        pred = load_predictor(cfg, best, device="cpu")(frames)
        torch.testing.assert_close(pred, ref, atol=1e-6, rtol=1e-6)
    sf = StreamingForecaster.from_checkpoint(cfg, best, device="cpu")
    state, now = sf.observe_window(sf.init_state(2, 16, 16), frames)
    rest = sf.forecast(state, cfg.model.output_frames - 1)
    torch.testing.assert_close(torch.cat([now[:, None], rest], 1), ref,
                               atol=1e-6, rtol=1e-6)
