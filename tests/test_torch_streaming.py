"""The port's streaming forecaster and warm-start rollout against the JAX
package.

Weights are a flax params tree made with numpy from a seed (as in
test_torch_models.py); frames are numpy too. The JAX ``StreamingForecaster``
runs its XLA scan on the CPU, and the JAX warm-start rollout kernel
``rollout_pallas_from_state`` runs in interpret mode, as tests/test_pallas.py
runs it. A JAX state crosses to the port through ``weights.py``. float32
tolerance: atol=rtol=1e-5, the one tests/test_pallas.py uses between the
warm-start kernel and the scan."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pl_convlstm_gan_tpu.config import Config as JaxConfig
from pl_convlstm_gan_tpu.ops.pallas.rollout_kernel import (
    rollout_pallas_from_state)
from pl_convlstm_gan_tpu.streaming import StreamingForecaster as JaxStreaming
from pl_convlstm_gan_tpu_torch import cli
from pl_convlstm_gan_tpu_torch.config import Config
from pl_convlstm_gan_tpu_torch.ops.kernels.rollout_kernel import (
    pack_weights, rollout_kernel_from_state, rollout_plain_from_state)
from pl_convlstm_gan_tpu_torch.predict import load_predictor
from pl_convlstm_gan_tpu_torch.streaming import StreamingForecaster
from pl_convlstm_gan_tpu_torch.weights import (flax_to_state_dict,
                                               stream_state_from_numpy,
                                               stream_state_to_numpy)
from test_torch_models import B, T_IN, T_OUT, flax_params, frames_np

TOL = dict(atol=1e-5, rtol=1e-5)
SIZE = 12
HORIZONS = (1, 3, 4)


def _model(hidden, **model):
    return {"family": "forecaster", "hidden_dims": list(hidden),
            "input_frames": T_IN, "output_frames": T_OUT, **model}


def jax_streaming(params, hidden, dtype="float32"):
    cfg = JaxConfig.from_dict({
        "data": {"source": "synthetic"},
        "model": _model(hidden, rollout_impl="xla"),
        "precision": {"compute_dtype": dtype},
        "output": {"output_dir": "/tmp/unused_torch_streaming"},
    })
    return JaxStreaming(cfg, params)


def port_config(hidden, impl="kernel", dtype="float32", **model):
    return Config.from_dict({
        "model": _model(hidden, rollout_impl=impl, **model),
        "precision": {"compute_dtype": dtype},
        "output": {"output_dir": "/tmp/unused_torch_streaming"},
    })


def port_streaming(params, hidden, impl="kernel", dtype="float32"):
    return StreamingForecaster(port_config(hidden, impl, dtype),
                               flax_to_state_dict(params), device="cpu")


def clone_state(state):
    return (tuple((h.clone(), c.clone()) for h, c in state.cells),
            state.prev_out.clone())


def assert_state_equal(a, b):
    assert len(a.cells) == len(b.cells)
    for (ha, ca), (hb, cb) in zip(a.cells, b.cells):
        assert torch.equal(ha, hb) and torch.equal(ca, cb)
    assert torch.equal(a.prev_out, b.prev_out)


def jax_state_numpy(jax_state):
    """A JAX StreamState as numpy arrays (bf16 stays bf16, via ml_dtypes)."""
    cells = tuple((np.asarray(h), np.asarray(c)) for h, c in jax_state.cells)
    return cells, np.asarray(jax_state.prev_out)


def assert_state_close_to_jax(state, jax_state, **tol):
    cells, prev = stream_state_to_numpy(state)
    for (h, c), (jh, jc) in zip(cells, jax_state.cells):
        np.testing.assert_allclose(h, np.asarray(jh, np.float32), **tol)
        np.testing.assert_allclose(c, np.asarray(jc, np.float32), **tol)
    np.testing.assert_allclose(prev, np.asarray(jax_state.prev_out,
                                                np.float32), **tol)


@pytest.mark.parametrize("hidden", [(8, 8), (8, 8, 8)])
@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_streaming_matches_jax(hidden, impl):
    """observe_window, then observe of one more frame, then forecast(h) for
    h in 1, 3, 4: nowcasts, states and forecasts against JAX in float32."""
    params = flax_params(31, hidden)
    frames = frames_np(32, size=SIZE)
    extra = frames_np(33, t=1, size=SIZE)[:, 0]
    jsf, sf = jax_streaming(params, hidden), port_streaming(params, hidden, impl)

    js, jnow = jsf.observe_window(jsf.init_state(B, SIZE, SIZE),
                                  jnp.asarray(frames))
    state, now = sf.observe_window(sf.init_state(B, SIZE, SIZE), frames)
    assert now.shape == (B, 1, SIZE, SIZE) and now.dtype == torch.float32
    np.testing.assert_allclose(now.numpy(), np.asarray(jnow), **TOL)
    assert_state_close_to_jax(state, js, **TOL)

    js, jnow = jsf.observe(js, jnp.asarray(extra))
    state, now = sf.observe(state, torch.from_numpy(extra))
    np.testing.assert_allclose(now.numpy(), np.asarray(jnow), **TOL)
    assert_state_close_to_jax(state, js, **TOL)

    for h in HORIZONS:
        ref = np.asarray(jsf.forecast(js, h))
        out = sf.forecast(state, h)
        assert out.shape == ref.shape == (B, h, 1, SIZE, SIZE)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("hidden,dtype", [((8, 8), "float32"),
                                          ((8, 8, 8), "float32"),
                                          ((8, 8, 8), "bfloat16")])
def test_rollout_plain_from_state_matches_jax_warm_kernel(hidden, dtype):
    """The warm rollout from one carried state: the port's plain loop against
    the JAX warm-start kernel in interpret mode. bf16 at 1e-3 absolute: the
    outputs here are below 0.0625, where one bf16 ulp is 2^-12 = 2.4e-4; the
    two sides share their rounding points (bf16 weights and state, f32
    accumulation and gates) but sum in different orders, so a stored value
    can land an ulp apart and be carried through the steps."""
    params = flax_params(34, hidden)
    frames = frames_np(35, size=SIZE)
    jsf = jax_streaming(params, hidden, dtype)
    js, _ = jsf.observe_window(jsf.init_state(B, SIZE, SIZE),
                               jnp.asarray(frames))
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(rollout_pallas_from_state(
        params["params"]["core"], js.cells, js.prev_out, 4,
        compute_dtype=jdtype))

    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    state = stream_state_from_numpy(*jax_state_numpy(js), "cpu", tdtype)
    before = clone_state(state)
    weights = pack_weights(flax_to_state_dict(params), tdtype)
    out = rollout_plain_from_state(weights, state.cells, state.prev_out, 4,
                                   tdtype)
    assert out.shape == ref.shape == (B, 4, 1, SIZE, SIZE)
    assert out.dtype == torch.float32
    if dtype == "bfloat16":
        assert np.abs(ref).max() < 0.0625
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=0)
    else:
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # on CPU tensors the kernel rollout runs the wrappers' plain versions,
    # and neither writes the state it was seeded from
    assert torch.equal(rollout_kernel_from_state(
        weights, state.cells, state.prev_out, 4, tdtype), out)
    assert_state_equal(state, type(state)(*before))


@pytest.mark.parametrize("hidden", [(8, 8), (8, 8, 8)])
def test_bf16_observe_near_jax_xla_step(hidden):
    """bfloat16 observe against JAX's bf16 XLA step. The two round at other
    points: XLA rounds the conv output z, the bias add and each gate op to
    bf16, where the port (like the TPU kernel) keeps them in f32 and rounds
    only h' and c'. Each extra rounding is half an ulp (2^-9 relative), so a
    stored value lands about one ulp of its own magnitude apart. Here |h|,
    |c| < 0.5, where one ulp is at most 2^-9 = 2.0e-3, and |nowcast| <
    0.125, where it is at most 2^-11 = 4.9e-4. Bound: two ulps, 4e-3 on the
    states and 1e-3 on the nowcast, over 3 frames (measured: one ulp)."""
    params = flax_params(36, hidden)
    frames = frames_np(37, size=SIZE)
    jsf = jax_streaming(params, hidden, "bfloat16")
    js, jnow = jsf.observe_window(jsf.init_state(B, SIZE, SIZE),
                                  jnp.asarray(frames))
    cells, prev = jax_state_numpy(js)
    assert max(np.abs(np.asarray(a, np.float32)).max()
               for pair in cells for a in pair) < 0.5
    assert np.abs(np.asarray(jnow)).max() < 0.125
    for impl in ("kernel", "torch"):
        sf = port_streaming(params, hidden, impl, "bfloat16")
        state, now = sf.observe_window(sf.init_state(B, SIZE, SIZE), frames)
        assert state.prev_out.dtype == torch.bfloat16
        assert all(h.dtype == c.dtype == torch.bfloat16 for h, c in state.cells)
        np.testing.assert_allclose(now.numpy(), np.asarray(jnow, np.float32),
                                   atol=1e-3, rtol=0)
        assert_state_close_to_jax(state, js, atol=4e-3, rtol=0)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_equals_batch_in_port(tmp_path, impl, dtype):
    """observe_window + forecast(T_out - 1) gives the port's own batch
    rollout (rollout_plain through the kernel wrappers, or the plain
    forecaster) bit for bit: the same steps on the same operands."""
    hidden = (8, 8, 8)
    params = flax_params(38, hidden)
    frames = frames_np(39, size=SIZE)
    sf = port_streaming(params, hidden, impl, dtype)
    state, now = sf.observe_window(sf.init_state(B, SIZE, SIZE), frames)
    rollout = torch.cat([now[:, None], sf.forecast(state, T_OUT - 1)], 1)

    batch = load_predictor(port_config(hidden, impl, dtype),
                           save_npz(tmp_path, params), device="cpu")(frames)
    assert rollout.shape == batch.shape == (B, T_OUT, 1, SIZE, SIZE)
    assert torch.equal(rollout, batch)


def save_npz(tmp_path, params):
    path = tmp_path / "params.npz"
    np.savez(path, **flatten_dict(params, sep="/"))
    return str(path)


def _observed(impl, hidden=(8, 8), dtype="float32", seed=40):
    params = flax_params(seed, hidden)
    frames = frames_np(seed + 1, size=SIZE)
    sf = port_streaming(params, hidden, impl, dtype)
    state, now = sf.observe_window(sf.init_state(B, SIZE, SIZE), frames)
    return sf, frames, state, now


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_frame_by_frame_equals_window(impl):
    """Assimilating one frame at a time reaches the same state and nowcast,
    bit for bit, as the windowed observe (the online access pattern)."""
    sf, frames, sw, now_w = _observed(impl)
    ss = sf.init_state(B, SIZE, SIZE)
    for t in range(frames.shape[1]):
        ss, now_s = sf.observe(ss, frames[:, t])
    assert torch.equal(now_s, now_w)
    assert_state_equal(ss, sw)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_forecast_is_pure_branching(impl):
    """forecast() never writes the stream: repeated calls agree, the state is
    unchanged, and assimilation after a forecast matches a stream that
    never forecast."""
    sf, frames, state, _ = _observed(impl)
    before = type(state)(*clone_state(state))
    f1 = sf.forecast(state, 3)
    f2 = sf.forecast(state, 3)
    assert torch.equal(f1, f2)
    assert_state_equal(state, before)

    base = sf.init_state(B, SIZE, SIZE)
    base, _ = sf.observe_window(base, frames)        # no forecast issued
    base, now_base = sf.observe(base, f1[:, 0])
    s_a, now_a = sf.observe(state, f1[:, 0])         # after two forecasts
    assert torch.equal(now_a, now_base)
    assert_state_equal(s_a, base)
    assert_state_equal(state, before)                 # observe wrote nothing


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_longer_horizon_extends_shorter(impl):
    """The same autoregressive prefix: forecast(5)[:, :3] == forecast(3)."""
    sf, _, state, _ = _observed(impl, hidden=(8, 8, 8))
    assert torch.equal(sf.forecast(state, 5)[:, :3], sf.forecast(state, 3))


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_from_checkpoint_matches_jax(tmp_path, suffix):
    hidden = (8, 8)
    params = flax_params(42, hidden)
    frames = frames_np(43, size=SIZE)
    if suffix == ".npz":
        path = save_npz(tmp_path, params)
    else:
        path = str(tmp_path / "params.pt")
        torch.save(flax_to_state_dict(params), path)
    sf = StreamingForecaster.from_checkpoint(port_config(hidden), path,
                                             device="cpu")
    state, now = sf.observe_window(sf.init_state(B, SIZE, SIZE), frames)
    jsf = jax_streaming(params, hidden)
    js, jnow = jsf.observe_window(jsf.init_state(B, SIZE, SIZE),
                                  jnp.asarray(frames))
    np.testing.assert_allclose(now.numpy(), np.asarray(jnow), **TOL)
    np.testing.assert_allclose(sf.forecast(state, 3).numpy(),
                               np.asarray(jsf.forecast(js, 3)), **TOL)


def test_rejects_generator_family_even_kernel_and_bad_horizon():
    sd = flax_to_state_dict(flax_params(44, (8, 8)))
    cfg = port_config((8, 8), family="generator", T=3, scale_factor=2)
    with pytest.raises(ValueError, match="sequence family"):
        StreamingForecaster(cfg, sd, device="cpu")
    even = flax_to_state_dict(flax_params(45, (8, 8), k=4))
    with pytest.raises(ValueError, match="odd"):
        StreamingForecaster(port_config((8, 8), kernel_size=4), even,
                            device="cpu")
    sf = StreamingForecaster(port_config((8, 8)), sd, device="cpu")
    state = sf.init_state(B, SIZE, SIZE)
    with pytest.raises(ValueError, match="horizon"):
        sf.forecast(state, 0)
    with pytest.raises(ValueError, match="state pairs"):
        sf.forecast(state._replace(cells=state.cells[:1]), 2)


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """With no CUDA device and no device='cpu', the streaming entry points
    refuse to run rather than carry on on the CPU."""
    params = flax_params(46, (8, 8))
    path = save_npz(tmp_path, params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingForecaster(port_config((8, 8)), flax_to_state_dict(params))
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingForecaster.from_checkpoint(port_config((8, 8)), path)
    inp = tmp_path / "frames.npy"
    np.save(inp, frames_np(47, size=SIZE)[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config", "nowcast_128", "--mode", "stream",
                  "--checkpoint", path, "--input", str(inp),
                  "--output", str(tmp_path / "out.npz")])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_state_round_trip(dtype):
    """A JAX state crosses to the port and back exactly; the port's state
    has the JAX layout (NHWC) and the compute dtype."""
    hidden = (8, 4)
    params = flax_params(48, hidden)
    jsf = jax_streaming(params, hidden, dtype)
    js, _ = jsf.observe_window(jsf.init_state(B, SIZE, SIZE),
                               jnp.asarray(frames_np(49, size=SIZE)))
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    state = stream_state_from_numpy(*jax_state_numpy(js), "cpu", tdtype)
    assert [tuple(h.shape) for h, _ in state.cells] == [(B, SIZE, SIZE, 8),
                                                       (B, SIZE, SIZE, 4)]
    assert tuple(state.prev_out.shape) == (B, SIZE, SIZE, 1)
    assert all(t.dtype == tdtype for pair in state.cells for t in pair)
    cells, prev = stream_state_to_numpy(state)
    for (h, c), (jh, jc) in zip(cells, js.cells):
        np.testing.assert_array_equal(h, np.asarray(jh, np.float32))
        np.testing.assert_array_equal(c, np.asarray(jc, np.float32))
    np.testing.assert_array_equal(prev, np.asarray(js.prev_out, np.float32))
    # and the port forecasts from it as JAX does (bf16: see the warm test)
    sf = port_streaming(params, hidden, "kernel", dtype)
    tol = dict(atol=1e-3, rtol=0) if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(sf.forecast(state, 2).numpy(),
                               np.asarray(jsf.forecast(js, 2), np.float32),
                               **tol)


@pytest.mark.parametrize("batched", [False, True])
def test_cli_stream_matches_streaming_forecaster(tmp_path, batched):
    """--mode stream on the CPU: [T,C,H,W] (one stream) or [B,T,C,H,W];
    nowcasts per frame and one forecast per horizon, equal to the API's."""
    hidden = (8, 8)
    params = flax_params(50, hidden)
    path = save_npz(tmp_path, params)
    cfg = port_config(hidden)
    yaml_path = tmp_path / "cfg.yaml"
    cfg.to_yaml(str(yaml_path))
    frames = frames_np(51, size=SIZE)
    inp, out = tmp_path / "frames.npz", tmp_path / "stream.npz"
    np.savez(inp, frames=frames if batched else frames[0])
    cli.main(["--config", str(yaml_path), "--mode", "stream", "--checkpoint",
              path, "--input", str(inp), "--output", str(out),
              "--horizons", "1,3", "--device", "cpu"])
    written = np.load(out)
    b = B if batched else 1
    assert sorted(written.files) == ["forecast_1", "forecast_3", "nowcasts"]
    assert written["nowcasts"].shape == (b, T_IN, 1, SIZE, SIZE)
    assert written["forecast_3"].shape == (b, 3, 1, SIZE, SIZE)

    sf = StreamingForecaster.from_checkpoint(cfg, path, device="cpu")
    state, nows = sf.init_state(b, SIZE, SIZE), []
    for t in range(T_IN):
        state, now = sf.observe(state, frames[:b, t])
        nows.append(now)
    np.testing.assert_array_equal(written["nowcasts"],
                                  torch.stack(nows, 1).numpy())
    for h in (1, 3):
        np.testing.assert_array_equal(written[f"forecast_{h}"],
                                      sf.forecast(state, h).numpy())
    # no --horizons: the config's output_frames
    cli.main(["--config", str(yaml_path), "--mode", "stream", "--checkpoint",
              path, "--input", str(inp), "--output", str(out),
              "--device", "cpu"])
    assert np.load(out)["forecast_4"].shape == (b, T_OUT, 1, SIZE, SIZE)
    with pytest.raises(SystemExit, match="export"):
        cli.main(["--config", str(yaml_path), "--mode", "stream",
                  "--checkpoint", str(tmp_path / "stream.jaxexport"),
                  "--input", str(inp), "--device", "cpu"])
