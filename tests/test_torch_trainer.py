"""The port's trainer, CLI train/eval modes, checkpoints and the training
refusals, on the CPU (``--device cpu``).

The trainer runs ``configs/ci_smoke_seq.yaml`` (one 8-channel cell, 16 px,
2 frames in / 3 out, B 8, scheduled sampling) in a temporary directory.
The checkpoint tests are the JAX writer's cases (tests/test_train.py:
``test_async_checkpoint_*``, ``test_restore_skips_pending_owned_by_live_
writer``, ``test_checkpoint_promotion_survives_missing_pending``,
``test_recover_checkpoint_from_interrupted_promotion``) on the port's
format."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from pl_convlstm_gan_tpu_torch import cli
from pl_convlstm_gan_tpu_torch.config import convlstm_cell_impl, load_config
from pl_convlstm_gan_tpu_torch.predict import build_model, load_predictor
from pl_convlstm_gan_tpu_torch.streaming import StreamingForecaster
from pl_convlstm_gan_tpu_torch.train import SequenceTrainer
from pl_convlstm_gan_tpu_torch.train import checkpoint as ckpt_mod
from pl_convlstm_gan_tpu_torch.train.checkpoint import (CheckpointWriter,
                                                        restore_checkpoint)


def _config(out_dir, epochs=2, **model):
    cfg = load_config("ci_smoke_seq")
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


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_train_resume_eval_on_ci_smoke_seq(tmp_path):
    """train 2 epochs, then --resume to 3: it starts at epoch 2, and its
    history and scheduler equal a straight 3-epoch run's (the resumed run
    restores params, Adam state, step, scheduler and history, and the data
    order and teacher draws are seeded per epoch). Then --mode eval."""
    out = tmp_path / "out"
    two = _yaml(tmp_path, _config(out, 2), "two")
    three = _yaml(tmp_path, _config(out, 3), "three")
    h2 = cli.main(["--config", two, "--mode", "train", "--device", "cpu"])
    assert h2["epoch"] == [0, 1]
    assert [r["epoch"] for r in _jsonl(out / "metrics.jsonl")] == [0, 1]
    h3 = cli.main(["--config", three, "--mode", "train", "--device", "cpu",
                   "--resume"])
    assert h3["epoch"] == [0, 1, 2]
    assert {k: v[:2] for k, v in h3.items()} == h2
    lines = _jsonl(out / "metrics.jsonl")
    assert [r["epoch"] for r in lines] == [0, 1, 2]
    assert lines[2]["tf_prob"] == pytest.approx(0.5)   # decay over 4 epochs

    straight = _config(tmp_path / "straight", 3)
    h_ref = SequenceTrainer(config=straight, device="cpu").train()
    assert h_ref == h3
    _, host = restore_checkpoint(str(out / "latest"))
    _, host_ref = restore_checkpoint(str(tmp_path / "straight" / "latest"))
    assert host["scheduler"] == host_ref["scheduler"]
    assert host["epoch"] == 2
    with open(out / "history.json") as f:
        assert json.load(f) == h3

    metrics = cli.main(["--config", three, "--mode", "eval", "--device",
                        "cpu"])
    assert set(metrics) == {"l1", "ssim", "pod@0.3", "far@0.3", "csi@0.3",
                            "hss@0.3"}
    assert all(np.isfinite(v) for v in metrics.values())


def test_pallas_impl_trains_like_the_plain_step(tmp_path):
    """convlstm_impl pallas (K1's plain version with z and the custom
    backward, on CPU tensors) against xla (autograd through the plain
    step): the same losses for one epoch to rtol 1e-5 (float32, sums in
    other orders)."""
    hist = {}
    for impl in ("pallas", "xla"):
        cfg = _config(tmp_path / impl, 1, convlstm_impl=impl)
        trainer = SequenceTrainer(config=cfg, device="cpu")
        hist[impl] = trainer.train()
        assert trainer.model.convlstm_impl == convlstm_cell_impl(impl)
    for key in ("total_loss", "val_l1", "val_ssim"):
        np.testing.assert_allclose(hist["pallas"][key], hist["xla"][key],
                                   rtol=1e-5)


def test_trained_checkpoint_serves_through_predict_and_stream(tmp_path):
    """load_predictor and StreamingForecaster.from_checkpoint take the
    trainer's checkpoint directory as is: the predictor equals the trained
    module's own forward, and streaming's window + forecast equals it."""
    cfg = _config(tmp_path / "out", 1)
    trainer = SequenceTrainer(config=cfg, device="cpu")
    trainer.train()
    best = os.path.join(cfg.output.output_dir, "best_model")
    frames = np.random.default_rng(0).random((2, 2, 1, 16, 16),
                                             dtype=np.float32)
    for impl in ("kernel", "torch"):
        cfg.model.rollout_impl = impl
        pred = load_predictor(cfg, best, device="cpu")(frames)
        with torch.no_grad():
            ref = trainer.model(torch.from_numpy(frames))
        torch.testing.assert_close(pred, ref, atol=1e-6, rtol=1e-6)
    sf = StreamingForecaster.from_checkpoint(cfg, best, device="cpu")
    state, now = sf.observe_window(sf.init_state(2, 16, 16), frames)
    rest = sf.forecast(state, cfg.model.output_frames - 1)
    torch.testing.assert_close(torch.cat([now[:, None], rest], 1), ref,
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("metrics", [
    [1.0, 0.9, 0.9, 0.95, 0.9, 0.89999, 1.0, 0.5, 0.5, 0.5, 0.5],
    [0.3] * 8 + [float("nan"), 0.2, 0.2, 0.2],
])
def test_plateau_and_early_stopping_match_jax(metrics):
    """ReduceLROnPlateau and EarlyStopping against the JAX package's copies
    as its trainers configure them (mode 'min'), metric by metric: the LR,
    the bad-epoch counters, is-best and the early_stop flag agree exactly,
    also after a state_dict round trip through JSON mid-sequence."""
    from pl_convlstm_gan_tpu.train.early_stopping import EarlyStopping as JaxES
    from pl_convlstm_gan_tpu.train.plateau import ReduceLROnPlateau as JaxLR
    from pl_convlstm_gan_tpu_torch.train.early_stopping import EarlyStopping
    from pl_convlstm_gan_tpu_torch.train.plateau import ReduceLROnPlateau

    lr_j = JaxLR(lr=1e-3, mode="min", factor=0.5, patience=1, verbose=True)
    es_j = JaxES(patience=3, min_delta=1e-3, mode="min", verbose=True)
    lr_p = ReduceLROnPlateau(lr=1e-3, factor=0.5, patience=1)
    es_p = EarlyStopping(patience=3, min_delta=1e-3)
    for i, m in enumerate(metrics):
        if i == len(metrics) // 2:      # resume: JSON, as host_state.json
            saved = json.loads(json.dumps([lr_p.state_dict(),
                                           es_p.state_dict()]))
            lr_p = ReduceLROnPlateau(lr=1e-3, factor=0.5, patience=1)
            es_p = EarlyStopping(patience=3, min_delta=1e-3)
            lr_p.load_state_dict(saved[0])
            es_p.load_state_dict(saved[1])
        assert lr_p.step(m) == lr_j.step(m), i
        assert lr_p.num_bad_epochs == lr_j.num_bad_epochs, i
        assert es_p(m, i) == es_j(m, i), i
        assert es_p.state_dict() == es_j.state_dict(), i
    assert lr_p.lr < 1e-3 and es_p.early_stop


@pytest.mark.parametrize("setting,value,item", [
    ("mesh.model_axis", 2, "A10"),
    ("mesh.data_axis", 4, "A9"),
    ("model.remat", True, "A3"),
    ("data.source", "frames", "A6"),
    ("data.loader", "grain", "A6"),
])
def test_unported_training_settings_are_refused(tmp_path, setting, value,
                                                item, monkeypatch):
    """Every training setting of the JAX trainer is ported now, each under
    its ROADMAP item: validate(training=True) takes them all. A9 (data
    parallelism) and A10 (tensor parallelism): data_axis 4 and model_axis 2
    are then refused by the trainer and the CLI of a single process, which
    has no 4 (or 2) ranks to run them (ValueError naming torchrun); A3:
    remat trains (tests/test_torch_remat.py, tests/test_torch_dp.py,
    tests/test_torch_tp.py). A6: the frames source reads a .npy stack of
    sequences, and data.loader grain, where grain is not installed, raises
    an ImportError naming data.loader: plain from validate, the trainer and
    the CLI, never switching loaders (the epochs on both:
    tests/test_torch_frames_grain_plots.py)."""
    cfg = _config(tmp_path / "out")
    section, key = setting.split(".")
    setattr(getattr(cfg, section), key, value)
    cfg.validate()
    cfg.validate(training=True)
    if item == "A3":
        assert SequenceTrainer(config=cfg, device="cpu").config.model.remat
        return
    if item == "A6" and key == "source":
        mc = cfg.model
        frames = np.random.default_rng(5).random(
            (12, mc.input_frames + mc.output_frames, 16, 16), np.float32)
        np.save(tmp_path / "frames.npy", frames)
        cfg.data.frames_path = str(tmp_path / "frames.npy")
        full = SequenceTrainer(config=cfg, device="cpu").setup_data()
        assert len(full) == 12
        inputs, targets = full[3]
        np.testing.assert_array_equal(inputs[:, 0], frames[3, :mc.input_frames])
        np.testing.assert_array_equal(targets[:, 0], frames[3, mc.input_frames:])
        return
    if item == "A6":
        import importlib.util
        find_spec = importlib.util.find_spec
        monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
            None if name == "grain" else find_spec(name, *a)))
        with pytest.raises(ImportError, match="data.loader: plain"):
            cfg.validate(training=True)
        with pytest.raises(ImportError, match="data.loader: plain"):
            SequenceTrainer(config=cfg, device="cpu")
        with pytest.raises(ImportError, match="data.loader: plain"):
            cli.main(["--config", _yaml(tmp_path, cfg, "grain"), "--mode",
                      "train", "--device", "cpu"])
        return
    ranks = {"A9": 4, "A10": 2}[item]
    match = f"{ranks} ranks: launch with torchrun"
    with pytest.raises(ValueError, match=match):
        SequenceTrainer(config=cfg, device="cpu")
    with pytest.raises(ValueError, match=match):
        cli.main(["--config", _yaml(tmp_path, cfg, "bad"), "--mode",
                  "train", "--device", "cpu"])


def test_convlstm_impl_meaning_and_cuda_requirement(tmp_path, monkeypatch):
    assert convlstm_cell_impl("pallas") == "kernel"
    assert convlstm_cell_impl("xla") == convlstm_cell_impl("auto") == "torch"
    cfg = load_config("nowcast_128_pallas")
    assert build_model(cfg).convlstm_impl == "kernel"
    cfg.model.convlstm_impl = "triton"
    with pytest.raises(ValueError, match="convlstm_impl"):
        cfg.validate()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SequenceTrainer(config=_config(tmp_path / "out"))


# ------------------------------------------------------------- checkpoints

def _bundle(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g)},
            "opt_state": {"state": {0: {"step": torch.tensor(1.0)}}},
            "step": seed}


def test_async_checkpoint_writer(tmp_path):
    """save() returns after the CPU snapshot; wait() promotes the pending
    dir; back-to-back saves finalize the previous one; restore round-trips
    and the snapshot is immune to later in-place updates."""
    path = str(tmp_path / "ck")
    w = CheckpointWriter()
    w.save(path, _bundle(0), {"epoch": 0, "metric": 1.0})
    w.wait()
    assert os.path.isdir(path) and not os.path.exists(path + ".pending")
    live = _bundle(1)
    w.save(path, live, {"epoch": 1, "metric": 0.5})
    want = live["params"]["w"].clone()
    live["params"]["w"].add_(1.0)           # the next step, in place
    w.save(path, _bundle(2), {"epoch": 2, "metric": 0.4})
    first = restore_checkpoint(path)        # the writer still owns epoch 2
    assert first[1]["epoch"] == 1
    assert torch.equal(first[0]["params"]["w"], want)
    w.wait()
    state, host = restore_checkpoint(path)
    assert host == {"epoch": 2, "metric": 0.4} and state["step"] == 2
    assert torch.equal(state["params"]["w"], _bundle(2)["params"]["w"])


def test_async_checkpoint_crash_recovers_completed_pending(tmp_path):
    """Killed after the write finished but before the promotion: restore
    recovers the newer pending save."""
    path = str(tmp_path / "ck")
    w1 = CheckpointWriter()
    w1.save(path, _bundle(0), {"epoch": 0})
    w1.wait()
    w2 = CheckpointWriter()
    w2.save(path, _bundle(1), {"epoch": 1})
    w2._thread.join()                   # written, not promoted
    w2._pending = None                  # the process dies before wait()
    ckpt_mod._LIVE_PENDING.clear()      # a dead process has no live writers
    _, host = restore_checkpoint(path)
    assert host["epoch"] == 1
    assert not os.path.exists(path + ".pending")


def test_restore_skips_pending_owned_by_live_writer(tmp_path):
    path = str(tmp_path / "ck")
    w = CheckpointWriter()
    w.save(path, _bundle(0), {"epoch": 0})
    w.wait()
    w2 = CheckpointWriter()
    w2.save(path, _bundle(1), {"epoch": 1})
    w2._thread.join()
    _, host = restore_checkpoint(path)
    assert host["epoch"] == 0
    assert os.path.exists(path + ".pending")
    w2.wait()
    _, host = restore_checkpoint(path)
    assert host["epoch"] == 1
    assert not os.path.exists(path + ".pending")


def test_async_checkpoint_incomplete_pending_ignored(tmp_path):
    """A crash mid-write leaves ``state.pt.tmp`` without the committed
    ``state.pt``: recovery ignores that pending dir."""
    path = str(tmp_path / "ck")
    w = CheckpointWriter()
    w.save(path, _bundle(0), {"epoch": 0})
    w.wait()
    pending = path + ".pending"
    os.makedirs(pending)
    open(os.path.join(pending, "state.pt.tmp"), "wb").close()
    with open(os.path.join(pending, "host_state.json"), "w") as f:
        json.dump({"epoch": 1}, f)
    _, host = restore_checkpoint(path)
    assert host["epoch"] == 0


def test_checkpoint_promotion_survives_missing_pending(tmp_path):
    path = str(tmp_path / "ck")
    w = CheckpointWriter()
    w.save(path, _bundle(0), {"epoch": 0})
    w.wait()
    w.save(path, _bundle(1), {"epoch": 1})
    w._thread.join()
    shutil.rmtree(path + ".pending")        # a racing writer
    w.wait()                                 # must not raise
    _, host = restore_checkpoint(path)
    assert host["epoch"] == 0


def test_recover_checkpoint_from_interrupted_promotion(tmp_path):
    path = str(tmp_path / "ck")
    w = CheckpointWriter()
    w.save(path, _bundle(5), {"epoch": 5})
    w.wait()
    os.replace(path, path + ".old")          # the crash window
    assert ckpt_mod.recover_checkpoint_dir(path)
    _, host = restore_checkpoint(path)
    assert host["epoch"] == 5
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))
