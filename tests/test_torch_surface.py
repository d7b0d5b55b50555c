"""The port's public surface against the JAX package's, on the CPU: the
package's exports, the positional order of ``build_model`` /
``build_predict_fn`` / ``load_predictor`` (JAX's: ``lu_channels`` before
``output_frames``), the losses and metrics code written against the JAX
package calls, and ``Trainer.compute_station_rmse``.

Inputs are made with numpy from seeds and given to both packages. float32
at atol=rtol=1e-5 (the same formulas, sums in other orders)."""
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import pl_convlstm_gan_tpu as jax_pkg
import pl_convlstm_gan_tpu_torch as port_pkg
from pl_convlstm_gan_tpu import losses as jax_losses
from pl_convlstm_gan_tpu.losses.sharpness import \
    hf_energy_fraction as jax_hf_energy_fraction
from pl_convlstm_gan_tpu.predict import build_model as jax_build_model
from pl_convlstm_gan_tpu.predict import load_predictor as jax_load_predictor
from pl_convlstm_gan_tpu.train.checkpoint import save_checkpoint
from pl_convlstm_gan_tpu.train.trainer import Trainer as JaxTrainer
from pl_convlstm_gan_tpu_torch import losses
from pl_convlstm_gan_tpu_torch.predict import (build_model, build_predict_fn,
                                               load_predictor)
from pl_convlstm_gan_tpu_torch.train.trainer import Trainer
from test_torch_generator_train import _loss_inputs
from test_torch_isolation import REPO
from test_torch_models import flax_params, frames_np
from test_torch_serve import jax_config, port_config

F32 = dict(atol=1e-5, rtol=1e-5)
LAZY = ("Trainer", "SequenceTrainer", "load_predictor", "build_model",
        "StreamingForecaster")


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **(tol or F32))


def test_package_exports_resolve_lazily():
    """The JAX package's top-level names exist in the port; importing the
    package loads its config alone (no torch), and each lazy name loads
    the module it lives in at first access."""
    assert {"Config", "load_config"} <= set(dir(port_pkg))
    for name in ("Config", "load_config") + LAZY:
        assert hasattr(jax_pkg, name)
        assert getattr(port_pkg, name).__name__ == \
            getattr(jax_pkg, name).__name__
    with pytest.raises(AttributeError):
        port_pkg.not_a_name
    code = ("import json, sys, pl_convlstm_gan_tpu_torch as p\n"
            "before = sorted(m for m in sys.modules if m.startswith("
            "('torch', 'pl_convlstm_gan_tpu_torch')))\n"
            "p.load_predictor\n"
            "print(json.dumps([before, 'pl_convlstm_gan_tpu_torch.predict' "
            "in sys.modules]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    before, loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert before == ["pl_convlstm_gan_tpu_torch",
                      "pl_convlstm_gan_tpu_torch.config"]
    assert loaded


def test_positional_arguments_mean_what_they_mean_in_jax(tmp_path):
    """load_predictor(cfg, ckpt, 0, 3), build_predict_fn(cfg, ckpt, 0, 3)
    and build_model(cfg, 0, 3) serve 3 frames in both packages (the fourth
    positional argument is output_frames, the third lu_channels); the
    outputs agree at 1e-5."""
    params = flax_params(51, (8, 8))
    npz = tmp_path / "params.npz"
    np.savez(npz, **flatten_dict(params, sep="/"))
    ckpt = str(tmp_path / "jax_ckpt")
    save_checkpoint(ckpt, {"params": params}, {"epoch": 0, "rmse": 1.0})
    cfg, jcfg = port_config(tmp_path), jax_config()
    frames = frames_np(52)
    want = np.asarray(jax_load_predictor(jcfg, ckpt, 0, 3)(frames))
    got = load_predictor(cfg, str(npz), 0, 3, "auto", "cpu")(frames)
    assert want.shape == tuple(got.shape) == (2, 3, 1, 16, 16)
    close(got, want)
    with torch.inference_mode():
        again = build_predict_fn(cfg, str(npz), 0, 3, "torch", "cpu")(
            torch.from_numpy(frames))
    assert torch.equal(again, got)
    assert build_model(cfg, 0, 3).output_frames == \
        jax_build_model(jcfg, 0, 3).output_frames == 3


@pytest.mark.parametrize("weighted,strategy", [(True, "log"),
                                               (False, "sqrt")])
def test_combined_loss_class_matches_jax(weighted, strategy):
    pred, lr, coords, values = _loss_inputs(53)
    kw = dict(lambda_point=0.9, lambda_conserve=0.8, lambda_smooth=0.2,
              lambda_temporal=0.1, use_weighted_loss=weighted,
              weight_strategy=strategy)
    want, want_parts = jax_losses.CombinedLoss(**kw)(
        *map(jnp.asarray, (pred, lr, coords, values)), 2.0)
    got, parts = losses.CombinedLoss(**kw)(
        *map(torch.from_numpy, (pred, lr, coords, values)), 2.0)
    close(got, want)
    assert set(parts) == set(want_parts)
    for k in parts:
        close(parts[k], want_parts[k])


@pytest.mark.parametrize("kw", [
    {}, dict(data_range=2.0, window_size=7, sigma=1.0, k1=0.02, k2=0.05)])
@pytest.mark.parametrize("channel_last", [False, True])
def test_ssim_and_ssim_per_sample_match_jax(kw, channel_last):
    """Both functions, default and given constants, on [B,T,H,W] and on
    [B,T,H,W,1] (a trailing channel of 1)."""
    rng = np.random.default_rng(54)
    shape = (3, 2, 20, 18) + ((1,) if channel_last else ())
    pred = rng.random(shape, dtype=np.float32)
    tgt = np.clip(pred + 0.1 * rng.standard_normal(shape).astype(np.float32),
                  0, 1)
    j, t = (jnp.asarray(pred), jnp.asarray(tgt)), (torch.from_numpy(pred),
                                                   torch.from_numpy(tgt))
    close(losses.ssim(*t, **kw), jax_losses.ssim(*j, **kw))
    close(losses.ssim_per_sample(*t, **kw),
          jax_losses.ssim_per_sample(*j, **kw))


def test_categorical_and_nowcast_scores_match_jax():
    """POD/FAR/CSI/HSS at one threshold and over the default set, and the
    unmasked contingency counts (exact integers)."""
    rng = np.random.default_rng(55)
    pred = rng.random((2, 3, 1, 16, 16), dtype=np.float32) * 40.0
    tgt = rng.random((2, 3, 1, 16, 16), dtype=np.float32) * 40.0
    j, t = (jnp.asarray(pred), jnp.asarray(tgt)), (torch.from_numpy(pred),
                                                   torch.from_numpy(tgt))
    for got, want in zip(losses.contingency_counts(*t, 5.0),
                         jax_losses.contingency_counts(*j, 5.0)):
        assert int(got) == int(want)
    got, want = losses.categorical_scores(*t, 12.0), \
        jax_losses.categorical_scores(*j, 12.0)
    assert set(got) == set(want) == {"pod", "far", "csi", "hss"}
    for k in want:
        close(got[k], want[k])
    got, want = losses.nowcast_scores(*t), jax_losses.nowcast_scores(*j)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("counts", [(7, 3, 2, 88), (0, 0, 5, 95),
                                    (0, 4, 0, 0), (0, 0, 0, 0)])
def test_scores_from_counts_match_jax(kind, counts):
    """One formula serves host counts (eval's aggregation, numpy float64)
    and float tensors (categorical_scores); a zero denominator gives 0."""
    host = [np.float64(x) for x in counts]
    args = host if kind == "numpy" else [torch.tensor(x, dtype=torch.float32)
                                         for x in counts]
    got = losses.scores_from_counts(*args)
    want = jax_losses.scores_from_counts(*(jnp.float32(x) for x in counts))
    assert set(got) == set(want) == {"pod", "far", "csi", "hss"}
    for k in want:
        assert np.isfinite(float(got[k]))
        close(got[k], want[k])


@pytest.mark.parametrize("cutoff", [0.5, 0.25, 0.8])
def test_hf_energy_fraction_cutoff_matches_jax(cutoff):
    x = np.random.default_rng(56).random((3, 2, 1, 12, 10), dtype=np.float32)
    close(losses.hf_energy_fraction(torch.from_numpy(x), cutoff),
          jax_hf_energy_fraction(jnp.asarray(x), cutoff))


def test_trainer_compute_station_rmse_matches_jax():
    """The method reads nothing of the trainer: called on bare instances of
    both classes, with numpy inputs, NaN observations and stations outside
    the grid."""
    pred, _, coords, values = _loss_inputs(57)
    want = JaxTrainer.__new__(JaxTrainer).compute_station_rmse(
        pred, coords, values, 2.0)
    got = Trainer.__new__(Trainer).compute_station_rmse(
        pred, coords, values, 2.0)
    assert isinstance(got, torch.Tensor)
    close(got, want)
