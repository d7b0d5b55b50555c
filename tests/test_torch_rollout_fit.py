"""How the port picks its inference path (faults C1-C3 of the port's
ROADMAP), on the CPU.

- ``rollout_kernel_misfit`` is a pure function of
  a model's widths, kernel size and compute dtype: each rule of K1
  (``cell_kernel_misfit``) and K2 (``head_kernel_misfit``) is tested here.
- ``rollout_impl: auto`` on a (faked) CUDA device picks the plain path for
  a model the kernels refuse before any weight is packed or wrapper called;
  ``kernel`` raises naming the rule.
- The JAX package's ``rollout_impl`` values validate in the port (``xla`` ->
  torch, ``pallas`` -> kernel); ``int8`` is refused by name.
- The CLI's ``--mode`` defaults to ``train``, as the JAX CLI's does.

Outputs are compared with the JAX model at atol=rtol=1e-5 in float32 (the
tolerance tests/test_torch_predict.py uses), and between two port paths that
run the same plain code bit for bit."""
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pl_convlstm_gan_tpu.config import Config as JaxConfig
from pl_convlstm_gan_tpu_torch import cli, predict as port_predict
from pl_convlstm_gan_tpu_torch.config import Config, load_config
from pl_convlstm_gan_tpu_torch.models import ConvLSTMForecaster
from pl_convlstm_gan_tpu_torch.ops.kernels import rollout_kernel as rk
from pl_convlstm_gan_tpu_torch.ops.kernels.rollout_kernel import (
    head_kernel_misfit, rollout_kernel_misfit)
from pl_convlstm_gan_tpu_torch.predict import (build_predict_fn,
                                               load_predictor, rollout_choice)
from pl_convlstm_gan_tpu_torch.streaming import StreamingForecaster
from test_torch_models import T_IN, T_OUT, flax_params, frames_np, jax_apply

TOL = dict(atol=1e-5, rtol=1e-5)
F32, BF16 = torch.float32, torch.bfloat16
CUDA = torch.device("cuda")


@pytest.mark.parametrize("hidden,cin,k,dtype,rule", [
    ((64, 64, 64), 1, 3, F32, None),               # nowcast_128
    ((64, 64, 64), 1, 3, BF16, None),
    ((256, 256, 256), 1, 3, BF16, None),           # tp_nowcast_128's widths
    ((8, 8), 1, 4, F32, "odd"),                    # even kernels
    ((8, 8), 1, 4, BF16, "odd"),
    ((12, 16), 1, 3, BF16, "multiple of 8"),       # bf16 K1: Ch % 8
    ((12, 16), 1, 3, F32, None),                   # f32 K1 takes any Ch...
    ((16, 6), 1, 3, F32, "multiple of 4"),         # ...but f32 K2 Cin % 4
    ((16, 12), 1, 3, BF16, "multiple of 8"),       # bf16 K2 Cin % 8 (and K1)
    ((8,), 10, 7, BF16, None),                     # folded x: 490 values
    ((8,), 11, 7, BF16, "holds 8"),                # 539 values: 9 k-blocks
    ((8,), 1, 5, F32, None),                       # f32 K1: K in 1, 3, 5
    ((8,), 1, 7, F32, "kernel sizes"),
    ((8,), 1, 1, F32, None),
])
def test_rollout_kernel_misfit_rules(hidden, cin, k, dtype, rule):
    misfit = rollout_kernel_misfit(hidden, cin, k, dtype)
    if rule is None:
        assert misfit is None
    else:
        assert rule in misfit
    # off the card only the loop's SAME padding binds
    off_card = rollout_kernel_misfit(hidden, cin, k, dtype, on_card=False)
    assert (off_card is None) == (k % 2 == 1)


def test_head_kernel_misfit_rules():
    assert head_kernel_misfit(64, 1, 3, BF16) is None
    assert head_kernel_misfit(40, 5, 3, F32) is None            # generic kernel
    assert head_kernel_misfit(4, 1, 3, F32) is None
    assert "multiple of 8" in head_kernel_misfit(4, 1, 3, BF16)
    assert "odd" in head_kernel_misfit(64, 1, 2, F32)
    assert "shared memory" in head_kernel_misfit(1024, 64, 3, F32)
    assert "float32 or bfloat16" in head_kernel_misfit(64, 1, 3, torch.float16)


def _config(tmp_path, hidden=(8, 8), dtype="float32", **model):
    return Config.from_dict({
        "model": {"family": "forecaster", "hidden_dims": list(hidden),
                  "input_frames": T_IN, "output_frames": T_OUT, **model},
        "precision": {"compute_dtype": dtype},
        "output": {"output_dir": str(tmp_path / "out")},
    })


def _checkpoint(tmp_path, hidden, seed=60):
    params = flax_params(seed, hidden)
    path = tmp_path / "params.npz"
    np.savez(path, **flatten_dict(params, sep="/"))
    return str(path), params


def test_rollout_choice_on_a_cuda_device(tmp_path):
    """A pure decision on the config: auto takes the kernels on a GPU only
    when they fit, kernel/pallas raise naming the rule, torch/xla never
    look; on the CPU auto is the plain path."""
    fits, refused = _config(tmp_path, (8, 8)), _config(tmp_path, (8, 6))
    assert rollout_choice(fits, CUDA) == "kernel"
    assert rollout_choice(fits, torch.device("cpu")) == "torch"
    assert rollout_choice(refused, CUDA) == "torch"
    for impl in ("kernel", "pallas"):
        with pytest.raises(ValueError, match=f"'{impl}'.*head.*multiple of 4"):
            rollout_choice(refused, CUDA, impl)
        assert rollout_choice(refused, torch.device("cpu"), impl) == "kernel"
    for impl in ("torch", "xla"):
        assert rollout_choice(refused, CUDA, impl) == "torch"
    bf16 = _config(tmp_path, (12, 16), "bfloat16")
    assert rollout_choice(bf16, CUDA) == "torch"
    with pytest.raises(ValueError, match="cell 0.*multiple of 8"):
        rollout_choice(bf16, CUDA, "kernel")


@pytest.fixture
def fake_cuda(monkeypatch):
    """A GPU as far as the entry points can see: torch.cuda.is_available is
    True and moving the model is a no-op (this box has no CUDA). Packing
    weights for the kernels or calling a kernel wrapper raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ConvLSTMForecaster, "to", lambda self, *a, **k: self)

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel path was taken")
    for name in ("pack_weights", "rollout_kernel"):
        monkeypatch.setattr(port_predict, name, refuse)
    for name in ("convlstm_cell_fwd", "conv_head_fwd", "pack_weights"):
        monkeypatch.setattr(rk, name, refuse)
    import pl_convlstm_gan_tpu_torch.streaming as port_streaming
    for name in ("pack_weights", "observe_kernel", "rollout_kernel_from_state"):
        monkeypatch.setattr(port_streaming, name, refuse)


def test_auto_serves_refused_model_on_the_plain_path(tmp_path, fake_cuda):
    """On a GPU, auto routes a model K2 refuses (f32 head of 6 channels) to
    the plain forward without touching a kernel; it still matches JAX."""
    hidden = (8, 6)
    path, params = _checkpoint(tmp_path, hidden)
    frames = frames_np(61)
    cfg = _config(tmp_path, hidden)
    fn = build_predict_fn(cfg, path)
    assert isinstance(fn, ConvLSTMForecaster)
    with torch.inference_mode():
        out = fn(torch.from_numpy(frames))
    np.testing.assert_allclose(out.numpy(), jax_apply(params, hidden, frames),
                               **TOL)
    with pytest.raises(ValueError, match="multiple of 4"):
        build_predict_fn(cfg, path, rollout_impl="kernel")
    sf = StreamingForecaster.from_checkpoint(cfg, path)
    assert not sf._kernels               # decided at construction
    sf.device = torch.device("cpu")      # the rest runs here on the CPU
    state, _ = sf.observe_window(sf.init_state(*frames.shape[:1], 16, 16),
                                 frames)
    assert sf.forecast(state, 2).shape == (frames.shape[0], 2, 1, 16, 16)
    cfg.model.rollout_impl = "pallas"
    with pytest.raises(ValueError, match="multiple of 4"):
        StreamingForecaster.from_checkpoint(cfg, path)


@pytest.mark.parametrize("impl,path", [("xla", "torch"), ("pallas", "kernel")])
def test_jax_yaml_rollout_impl_validates_and_maps(tmp_path, impl, path):
    """A yaml written by the JAX package's config with its own rollout_impl
    loads and validates in the port and serves the mapped path (on the CPU:
    the plain forward, or the kernel loop through the plain versions), at
    the JAX model's outputs."""
    hidden = (8, 8)
    jcfg = JaxConfig.from_dict({
        "data": {"source": "synthetic"},
        "model": {"family": "forecaster", "hidden_dims": list(hidden),
                  "input_frames": T_IN, "output_frames": T_OUT,
                  "rollout_impl": impl},
        "output": {"output_dir": str(tmp_path / "out")}})
    jcfg.validate()
    yaml_path = str(tmp_path / "jax.yaml")
    jcfg.to_yaml(yaml_path)
    cfg = load_config(yaml_path)
    cfg.validate()
    assert cfg.model.rollout_impl == impl
    assert rollout_choice(cfg, torch.device("cpu")) == path
    ckpt, params = _checkpoint(tmp_path, hidden, seed=62)
    fn = build_predict_fn(cfg, ckpt, device="cpu")
    assert isinstance(fn, ConvLSTMForecaster) == (path == "torch")
    frames = frames_np(63)
    out = load_predictor(cfg, ckpt, device="cpu")(frames)
    np.testing.assert_allclose(out.numpy(), jax_apply(params, hidden, frames),
                               **TOL)


def test_int8_is_refused_by_name(tmp_path):
    cfg = _config(tmp_path, rollout_impl="int8")
    with pytest.raises(ValueError, match="int8.*ROADMAP A13"):
        cfg.validate()
    path, _ = _checkpoint(tmp_path, (8, 8))
    with pytest.raises(ValueError, match="A13"):
        StreamingForecaster.from_checkpoint(cfg, path, device="cpu")


def test_cli_mode_defaults_to_train(tmp_path, monkeypatch):
    """Without --mode the CLI trains, as the JAX CLI does."""
    seen = []
    monkeypatch.setattr(cli, "_train", lambda config, args: seen.append(
        (args.mode, config.model.family)) or "trained")
    yaml_path = str(tmp_path / "cfg.yaml")
    _config(tmp_path).to_yaml(yaml_path)
    assert cli.main(["--config", yaml_path, "--device", "cpu"]) == "trained"
    assert seen == [("train", "forecaster")]
