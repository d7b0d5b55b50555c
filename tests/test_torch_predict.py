"""The port's predict entry points and CLI against the JAX model.

A flax params tree made with numpy from a seed is written as the README's
``.npz`` (flattened flax params, '/'-joined keys), loaded by the port on the
CPU, and compared with ``model.apply`` of the JAX package in float32 at
atol=rtol=1e-5 (the tolerance tests/test_pallas.py uses between kernel and
scan)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pl_convlstm_gan_tpu_torch import cli, predict as port_predict
from pl_convlstm_gan_tpu_torch.config import Config
from pl_convlstm_gan_tpu_torch.predict import build_predict_fn, load_predictor
from pl_convlstm_gan_tpu_torch.weights import flax_to_state_dict
from test_torch_models import B, T_IN, T_OUT, flax_params, frames_np, jax_apply

TOL = dict(atol=1e-5, rtol=1e-5)
HIDDEN = (8, 8, 8)


def _config(tmp_path, **model):
    return Config.from_dict({
        "model": {"family": "forecaster", "hidden_dims": list(HIDDEN),
                  "input_frames": T_IN, "output_frames": T_OUT, **model},
        "output": {"output_dir": str(tmp_path / "out")},
    })


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    params = flax_params(21, HIDDEN)
    path = tmp_path_factory.mktemp("ckpt") / "params.npz"
    np.savez(path, **flatten_dict(params, sep="/"))
    frames = frames_np(22)
    return str(path), params, frames, jax_apply(params, HIDDEN, frames)


@pytest.mark.parametrize("impl", ["auto", "torch", "kernel"])
def test_load_predictor_npz_matches_jax(tmp_path, checkpoint, impl):
    path, _, frames, ref = checkpoint
    predict = load_predictor(_config(tmp_path, rollout_impl=impl), path,
                             device="cpu")
    out = predict(frames)
    assert out.shape == ref.shape == (B, T_OUT, 1, 16, 16)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_pt_checkpoint_and_horizon_override(tmp_path, checkpoint):
    path, params, frames, _ = checkpoint
    pt = tmp_path / "params.pt"
    torch.save(flax_to_state_dict(params), pt)
    ref = jax_apply(params, HIDDEN, frames, t_out=T_OUT + 2)
    out = load_predictor(_config(tmp_path), str(pt), output_frames=T_OUT + 2,
                         device="cpu")(torch.from_numpy(frames))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_predict_rejects_wrong_window_and_unknown_impl(tmp_path, checkpoint):
    path, _, frames, _ = checkpoint
    for impl in ("torch", "kernel"):
        predict = load_predictor(_config(tmp_path, rollout_impl=impl), path,
                                 device="cpu")
        with pytest.raises(ValueError, match="input window"):
            predict(frames[:, :T_IN - 1])
    # JAX's 'pallas' serves through the kernel path (its plain versions on
    # CPU tensors), 'int8' is refused by name, an unknown value raises
    pallas = build_predict_fn(_config(tmp_path), path, rollout_impl="pallas",
                              device="cpu")
    kernel = build_predict_fn(_config(tmp_path), path, rollout_impl="kernel",
                              device="cpu")
    assert not isinstance(pallas, torch.nn.Module)
    x = torch.from_numpy(frames)
    assert torch.equal(pallas(x), kernel(x))
    with pytest.raises(ValueError, match="A13"):
        build_predict_fn(_config(tmp_path), path, rollout_impl="int8",
                         device="cpu")
    with pytest.raises(ValueError, match="rollout_impl"):
        build_predict_fn(_config(tmp_path), path, rollout_impl="mosaic",
                         device="cpu")
    with pytest.raises(ValueError, match=".npz"):
        build_predict_fn(_config(tmp_path), str(tmp_path / "best_model"),
                         device="cpu")


def test_entry_points_raise_without_cuda(tmp_path, checkpoint, monkeypatch):
    """With no CUDA device and no device='cpu', the entry points refuse to
    run rather than carry on on the CPU."""
    path, _, frames, _ = checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_predictor(_config(tmp_path), path)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_predict_fn(_config(tmp_path), path)
    inp = tmp_path / "frames.npy"
    np.save(inp, frames)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config", "nowcast_128", "--mode", "predict",
                  "--checkpoint", path, "--input", str(inp)])


def test_cli_predict_writes_the_predictor_output(tmp_path, checkpoint,
                                                 monkeypatch):
    path, _, frames, ref = checkpoint
    cfg = _config(tmp_path)
    yaml_path = tmp_path / "cfg.yaml"
    cfg.to_yaml(str(yaml_path))
    inp, out = tmp_path / "frames.npz", tmp_path / "pred.npy"
    np.savez(inp, frames=frames)
    cli.main(["--config", str(yaml_path), "--mode", "predict", "--checkpoint",
              path, "--input", str(inp), "--output", str(out),
              "--device", "cpu"])
    written = np.load(out)
    expected = load_predictor(cfg, path, device="cpu")(frames).numpy()
    np.testing.assert_array_equal(written, expected)
    np.testing.assert_allclose(written, ref, **TOL)


def test_build_model_refuses_unported_family(tmp_path):
    cfg = _config(tmp_path)
    cfg.model.family = "generator"
    with pytest.raises(NotImplementedError, match="not ported"):
        port_predict.build_model(cfg)


def test_bf16_predict_kernel_path_equals_plain_forward(tmp_path, checkpoint):
    """compute_dtype bfloat16: the kernel path on CPU tensors (plain versions)
    and the plain forward share their rounding points and give the same
    bits, and stay near the float32 JAX reference (bf16 inputs and state:
    absolute 2e-3 at outputs below 0.1)."""
    path, _, frames, ref = checkpoint
    outs = []
    for impl in ("kernel", "torch"):
        cfg = _config(tmp_path, rollout_impl=impl)
        cfg.precision.compute_dtype = "bfloat16"
        outs.append(load_predictor(cfg, path, device="cpu")(frames))
    assert torch.equal(outs[0], outs[1])
    assert np.abs(ref).max() < 0.1
    np.testing.assert_allclose(outs[0].numpy(), ref, atol=2e-3, rtol=0)
