"""The port's frames source, grain loader and plots against the JAX
package's, on the CPU: ``data.NpyFramesDataset`` item for item against
``data/frames.py`` for every layout and error; ``data.make_grain_loader``'s
batches against ``data/pipeline.py``'s, in order, for one seed and process
index / count; ``SequenceTrainer`` epochs on ``data.source: frames`` and
``data.loader: grain``; ``utils/visualization.py``'s figures pixel for pixel
against JAX's (``matplotlib.image.imread`` arrays equal); the plot files
both trainers write, and what they do without matplotlib or when a plot
fails. Everything here is exact: the same numpy, grain and matplotlib code
on the same inputs."""
from itertools import islice

import matplotlib.image as mpimg
import numpy as np
import pytest

from pl_convlstm_gan_tpu.data.frames import NpyFramesDataset as JaxFrames
from pl_convlstm_gan_tpu.data.pipeline import \
    make_grain_loader as jax_grain_loader
from pl_convlstm_gan_tpu.utils import visualization as jax_vis
from pl_convlstm_gan_tpu_torch.config import load_config
from pl_convlstm_gan_tpu_torch.data import (NpyFramesDataset,
                                            SyntheticSequenceDataset,
                                            make_grain_loader)
from pl_convlstm_gan_tpu_torch.train import SequenceTrainer, Trainer
from pl_convlstm_gan_tpu_torch.train import sequence_trainer as seq_mod
from pl_convlstm_gan_tpu_torch.train import trainer as gen_mod
from pl_convlstm_gan_tpu_torch.utils import visualization as vis


def _items_equal(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        for x, y in zip(a[i], b[i]):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def frame_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    arrays = {"seqs.npy": rng.random((6, 7, 8, 8)).astype(np.float32),
              "seqs5.npy": rng.random((4, 6, 2, 8, 8)).astype(np.float32),
              "movie.npy": rng.random((20, 8, 8)).astype(np.float32),
              "rank2.npy": rng.random((20, 8)).astype(np.float32)}
    for name, arr in arrays.items():
        np.save(root / name, arr)
    np.savez(root / "f.npz", frames=arrays["seqs.npy"],
             other=arrays["seqs5.npy"])
    return root


@pytest.mark.parametrize("name,t_in,t_out,kw", [
    ("seqs.npy", 3, 4, {}),                          # [N, T, H, W]
    ("seqs.npy", 2, 2, {"mmap": False}),
    ("seqs5.npy", 2, 3, {}),                         # [N, T, C, H, W]
    ("movie.npy", 2, 3, {"stride": 5}),              # [T, H, W], stride
    ("movie.npy", 2, 3, {}),                         # non-overlapping
    ("movie.npy", 1, 1, {"stride": 1, "scale": 2.0}),
    ("f.npz", 3, 4, {"scale": 0.5}),                 # .npz, key "frames"
    ("f.npz", 2, 3, {"key": "other"}),
])
def test_npy_frames_dataset_equals_jax(frame_files, name, t_in, t_out, kw):
    path = str(frame_files / name)
    ours = NpyFramesDataset(path, t_in, t_out, **kw)
    ref = JaxFrames(path, t_in, t_out, **kw)
    _items_equal(ours, ref)
    x, y = ours[0]
    assert x.shape[0] == t_in and y.shape[0] == t_out and x.ndim == 4


@pytest.mark.parametrize("name,t_in,t_out,match", [
    ("seqs.npy", 5, 5, "sequences have 7 frames"),
    ("movie.npy", 15, 10, "too short"),
    ("rank2.npy", 1, 1, "unsupported frame array rank 2"),
])
def test_npy_frames_dataset_errors_equal_jax(frame_files, name, t_in, t_out,
                                             match):
    path = str(frame_files / name)
    with pytest.raises(ValueError, match=match) as ours:
        NpyFramesDataset(path, t_in, t_out)
    with pytest.raises(ValueError) as ref:
        JaxFrames(path, t_in, t_out)
    assert str(ours.value) == str(ref.value)


def _batches_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=3),
    dict(shuffle=False, drop_remainder=False),
    dict(shuffle=True, seed=1, process_index=0, process_count=2),
    dict(shuffle=True, seed=1, process_index=1, process_count=2),
    dict(shuffle=True, seed=2, process_index=1, process_count=2,
         drop_remainder=False),
    dict(shuffle=True, seed=4, num_epochs=2),
])
def test_grain_loader_batches_equal_jax(kw):
    """The same batches in the same order as JAX's loader, for one seed and
    process index / count (15 items: the shards differ in length, and
    every shard is cut to one length)."""
    ds = SyntheticSequenceDataset(num_sequences=15, input_frames=2,
                                  output_frames=2, image_size=8, seed=0)
    kw = {"process_index": 0, "process_count": 1, **kw}
    _batches_equal(list(make_grain_loader(ds, 4, **kw)),
                   list(jax_grain_loader(ds, 4, **kw)))


def test_grain_loader_endless_and_workers():
    """num_epochs=None is endless, as grain's repeat(None); worker
    processes yield the in-process batches; a global batch the processes
    do not divide raises; the process index and count default to this
    process's rank and world (one process here)."""
    ds = SyntheticSequenceDataset(num_sequences=12, input_frames=2,
                                  output_frames=2, image_size=8)
    endless = list(islice(iter(make_grain_loader(ds, 4, num_epochs=None)), 5))
    assert len(endless) == 5
    inproc = list(make_grain_loader(ds, 4, shuffle=True, seed=3))
    _batches_equal(inproc, list(make_grain_loader(ds, 4, shuffle=True, seed=3,
                                                  worker_count=2)))
    _batches_equal(inproc, list(jax_grain_loader(ds, 4, shuffle=True, seed=3,
                                                 process_index=0,
                                                 process_count=1)))
    with pytest.raises(ValueError, match="not divisible"):
        make_grain_loader(ds, 5, process_index=0, process_count=2)


# ------------------------------------------------------------- the trainers

def _seq_config(out_dir, **data):
    cfg = load_config("ci_smoke_seq")
    cfg.output.output_dir = str(out_dir)
    cfg.training.epochs = 1
    for k, v in data.items():
        setattr(cfg.data, k, v)
    return cfg


def test_sequence_trainer_on_frames_and_grain(tmp_path):
    """One epoch on data.source frames, from a .npy holding the synthetic
    dataset's items, equals the epoch on the synthetic data; one epoch under
    data.loader grain trains (finite loss, the metrics line written)."""
    cfg = _seq_config(tmp_path / "synthetic")
    ds = SyntheticSequenceDataset(
        num_sequences=cfg.data.synthetic_num_sequences,
        input_frames=cfg.model.input_frames,
        output_frames=cfg.model.output_frames,
        image_size=cfg.data.synthetic_image_size, seed=cfg.data.seed)
    stack = np.stack([np.concatenate(ds[i]) for i in range(len(ds))])
    np.save(tmp_path / "frames.npy", stack)                   # [N,T,1,H,W]
    h_synth = SequenceTrainer(config=cfg, device="cpu").train()
    h_frames = SequenceTrainer(config=_seq_config(
        tmp_path / "frames", source="frames",
        frames_path=str(tmp_path / "frames.npy")), device="cpu").train()
    assert h_frames == h_synth
    h_grain = SequenceTrainer(config=_seq_config(
        tmp_path / "grain", loader="grain"), device="cpu").train()
    assert h_grain["epoch"] == [0] and np.isfinite(h_grain["total_loss"][0])
    assert (tmp_path / "grain" / "metrics.jsonl").exists()


def _gen_config(out_dir, epochs):
    cfg = load_config("ci_smoke")
    cfg.output.output_dir = str(out_dir)
    cfg.training.epochs = epochs
    # 32 days: the val split (4) holds one batch of 4 for the station plot
    cfg.data.synthetic_num_sequences = 32
    cfg.training.batch_size = 4
    cfg.data.loader = "grain"
    return cfg


def test_trainers_write_jax_plot_files(tmp_path):
    """SequenceTrainer: final_training_curves.png and
    final_sequence_comparison.png; Trainer (the Generator, 10 epochs under
    grain): training_curves.png at epoch 10, final_training_curves.png and
    final_station_comparison.png, as the JAX trainers name them."""
    SequenceTrainer(config=_seq_config(tmp_path / "seq"), device="cpu").train()
    assert {p.name for p in (tmp_path / "seq").glob("*.png")} == {
        "final_training_curves.png", "final_sequence_comparison.png"}
    Trainer(config=_gen_config(tmp_path / "gen", 10), device="cpu").train()
    assert {p.name for p in (tmp_path / "gen").glob("*.png")} == {
        "training_curves.png", "final_training_curves.png",
        "final_station_comparison.png"}
    for png in (tmp_path / "gen").glob("*.png"):
        assert mpimg.imread(str(png)).ndim == 3


def test_trainers_without_matplotlib_or_with_a_failing_plot(
        tmp_path, capsys, monkeypatch):
    """Without matplotlib each trainer prints one line and writes no plot;
    a failing sequence or station plot prints "... plot skipped" and the
    finished run returns its history."""
    for mod in (seq_mod, gen_mod):
        monkeypatch.setattr(mod, "have_matplotlib", lambda: False)
    SequenceTrainer(config=_seq_config(tmp_path / "a"), device="cpu").train()
    Trainer(config=_gen_config(tmp_path / "b", 1), device="cpu").train()
    out = capsys.readouterr().out
    assert out.count("matplotlib is not installed: no plots written") == 2
    assert not list(tmp_path.glob("*/*.png"))
    monkeypatch.undo()

    def broken(*a, **k):
        raise RuntimeError("no canvas")
    monkeypatch.setattr(seq_mod, "plot_sequence_comparison", broken)
    monkeypatch.setattr(gen_mod, "plot_stations_vs_pred", broken)
    h = SequenceTrainer(config=_seq_config(tmp_path / "c"), device="cpu"
                        ).train()
    h2 = Trainer(config=_gen_config(tmp_path / "d", 1), device="cpu").train()
    out = capsys.readouterr().out
    assert "Sequence plot skipped: no canvas" in out
    assert "Station plot skipped: no canvas" in out
    assert h["epoch"] == h2["epoch"] == [0]


# ---------------------------------------------------------------- the plots

def _same_pixels(tmp_path, name, ours, ref, *args, **kwargs):
    a = str(tmp_path / f"ours_{name}.png")
    b = str(tmp_path / f"jax_{name}.png")
    ours(*args, save_path=a, **kwargs)
    ref(*args, save_path=b, **kwargs)
    pa, pb = mpimg.imread(a), mpimg.imread(b)
    assert pa.shape == pb.shape and pa.ndim == 3
    np.testing.assert_array_equal(pa, pb)


def test_plots_draw_jax_pixels(tmp_path):
    rng = np.random.default_rng(9)
    true_vals = rng.random(12) * 20
    _same_pixels(tmp_path, "stations", vis.plot_stations_vs_pred,
                 jax_vis.plot_stations_vs_pred, rng.random((12, 2)),
                 true_vals, true_vals + rng.normal(size=12), dpi=40)
    # layouts [T,H,W] / [T,C,H,W] / [B,T,C,H,W], one column
    _same_pixels(tmp_path, "sequence", vis.plot_sequence_comparison,
                 jax_vis.plot_sequence_comparison, rng.random((3, 8, 8)),
                 rng.random((4, 1, 8, 8)), rng.random((1, 4, 1, 8, 8)),
                 dpi=40)
    _same_pixels(tmp_path, "sequence1", vis.plot_sequence_comparison,
                 jax_vis.plot_sequence_comparison, rng.random((1, 8, 8)),
                 rng.random((1, 8, 8)), rng.random((1, 8, 8)), dpi=40)
    epochs = list(range(5))
    history = {"epoch": epochs, "total_loss": list(rng.random(5)),
               "rmse": list(rng.random(5)), "point_loss": list(rng.random(5)),
               "g_loss": list(rng.random(5)), "d_loss": [1.0],
               "learning_rate": [1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4]}
    _same_pixels(tmp_path, "curves", vis.plot_training_curves,
                 jax_vis.plot_training_curves, history, dpi=40)
