"""The port's int8 post-training-quantized serving (``ops/quant.py``,
``models/quantized.py``, the int8 branches of predict, streaming and serve)
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; weights are a flax params tree
carried into the port by ``weights.py``.

Tolerances:
- the primitives are exact: int8 levels, int32 conv sums and per-channel
  weight scales are equal (the scales' division is the same float32 op);
- one quantized step from the same state is within 1e-5 (float32 gates,
  whose sigmoid/tanh differ between XLA and ATen by ulps);
- a rollout is within ``ROLLOUT_ATOL`` = 1e-4 absolute (outputs ~0.1). The
  ulp differences of the gates can move an int8 level of a later conv
  input by one; the test counts those levels over every conv input of
  every step and holds them to at most ``LEVEL_SHARE`` = 1e-4 of all levels,
  each by one level. One level of the head's input moves an output by one
  activation step times the head's weights summed over a 3x3 window, under
  1e-4 here (measured: at most 3 of ~1e5 levels differ, outputs within
  5e-5).
"""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pl_convlstm_gan_tpu.config import Config as JaxConfig
from pl_convlstm_gan_tpu.models import quantized as jq
from pl_convlstm_gan_tpu.ops import quant as jquant
from pl_convlstm_gan_tpu.serve import export_model as jax_export_model
from pl_convlstm_gan_tpu.serve import export_streaming as jax_export_streaming
from pl_convlstm_gan_tpu.serve import load_exported as jax_load_exported
from pl_convlstm_gan_tpu.serve import \
    load_streaming_exported as jax_load_streaming
from pl_convlstm_gan_tpu.streaming import \
    StreamingForecaster as JaxStreamingForecaster
from pl_convlstm_gan_tpu.train.checkpoint import save_checkpoint
from pl_convlstm_gan_tpu_torch.config import Config
from pl_convlstm_gan_tpu_torch.models import quantized as pq
from pl_convlstm_gan_tpu_torch.ops import quant as pquant
from pl_convlstm_gan_tpu_torch.predict import build_predict_fn, load_predictor
from pl_convlstm_gan_tpu_torch.serve import (export_model, export_streaming,
                                             load_exported,
                                             load_streaming_exported,
                                             parse_stream_header)
from pl_convlstm_gan_tpu_torch.streaming import StreamingForecaster
from pl_convlstm_gan_tpu_torch.weights import flax_to_state_dict
from test_torch_models import flax_params

ROLLOUT_ATOL = 1e-4
LEVEL_SHARE = 1e-4
T_IN, T_OUT, SIZE = 4, 8, 12


def _hwio(t):
    return t.permute(2, 3, 1, 0).numpy()


# ------------------------------------------------------------- primitives

@pytest.mark.parametrize("shape,stride,padding", [
    ((2, 9, 9, 5, 8, 3), 1, "SAME"),
    ((2, 12, 12, 1, 48, 3), 1, "SAME"),       # K = 9: padded to 16
    ((2, 12, 12, 12, 1, 3), 1, "SAME"),       # N = 1 (the head): padded to 8
    ((1, 3, 4, 16, 8, 3), 1, "SAME"),         # 12 rows: M padded past 16
    ((2, 11, 10, 6, 5, 4), 2, 1),             # even kernel, stride 2, int pad
    ((3, 7, 7, 24, 16, 1), 1, ((0, 0), (0, 0))),
])
def test_conv2d_int8_equals_jax_int32(shape, stride, padding):
    """conv2d_int8 (im2col + torch._int_mm) is torch.equal to JAX's int32
    conv, the shapes _int_mm's rules pad included; a float conv is not
    exact at these sums (1152 products of 127^2 pass 2^24)."""
    b, h, w, cin, cout, k = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    wt = rng.integers(-127, 128, (cout, cin, k, k)).astype(np.int8)
    ours = pquant.conv2d_int8(torch.from_numpy(x), torch.from_numpy(wt),
                              stride, padding)
    ref = np.asarray(jquant.conv2d_int8(
        jnp.asarray(x), jnp.asarray(_hwio(torch.from_numpy(wt))), stride,
        padding))
    assert ours.dtype == torch.int32
    assert torch.equal(ours, torch.from_numpy(ref))
    with pytest.raises(ValueError, match="int8"):
        pquant.conv2d_int8(torch.from_numpy(x).float(), torch.from_numpy(wt))


def test_quantize_primitives_equal_jax():
    """quantize_weight (per output channel, a tiny and an all-zero channel),
    quantize_act (half to even, saturation), dynamic_scale (per sample)
    and apply_quant_conv give JAX's values."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(6, 4, 3, 3)).astype(np.float32)    # OIHW
    w[2] *= 1e-3
    w[4] = 0.0
    wq, scale = pquant.quantize_weight(torch.from_numpy(w))
    jwq, jscale = jquant.quantize_weight(jnp.asarray(w.transpose(2, 3, 1, 0)))
    assert wq.dtype == torch.int8 and scale.shape == (6,)
    np.testing.assert_array_equal(_hwio(wq), np.asarray(jwq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=0,
                               atol=1e-7)
    assert torch.isfinite(scale).all() and (wq[4] == 0).all()

    x = np.asarray([0.0, 0.5, -0.5, 1.0, -1.0, 3.0, -3.0, 1.5 / 127,
                    2.5 / 127], np.float32)
    for s in (pquant.UNIT_SCALE, 0.25):
        np.testing.assert_array_equal(
            pquant.quantize_act(torch.from_numpy(x), s).numpy(),
            np.asarray(jquant.quantize_act(jnp.asarray(x), s)))
    xb = np.stack([x * 100.0, x, np.zeros_like(x)])
    s = pquant.dynamic_scale(torch.from_numpy(xb))
    assert s.shape == (3, 1)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jquant.dynamic_scale(jnp.asarray(xb))))

    act = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    qc = pquant.quantize_conv(torch.from_numpy(w), torch.from_numpy(bias))
    jqc = jquant.quantize_conv(jnp.asarray(w.transpose(2, 3, 1, 0)),
                               jnp.asarray(bias))
    ours = pquant.apply_quant_conv(qc, torch.from_numpy(act),
                                   pquant.dynamic_scale(torch.from_numpy(act)))
    ref = jquant.apply_quant_conv(jqc, jnp.asarray(act),
                                  jquant.dynamic_scale(jnp.asarray(act)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------ the rollout

def _quantized(hidden, seed=7):
    params = flax_params(seed, hidden)
    return (params, jq.prepare_int8_forecaster(params),
            pq.prepare_int8_forecaster(flax_to_state_dict(params)))


def _frames(seed, b=2, t=T_IN):
    return np.random.default_rng(seed).random((b, t, 1, SIZE, SIZE),
                                              dtype=np.float32)


@pytest.mark.parametrize("hidden", [(12, 12), (8, 16, 8)])
def test_prepare_int8_forecaster_equals_jax(hidden):
    """Weights through weights.py quantize to JAX's: int8 kernels equal,
    scales within 1e-7, biases equal, the first cell split at the frame's
    channels."""
    _, qj, qp = _quantized(hidden)
    pairs = [(qp.cell0.conv_x, qj.cell0.conv_x),
             (qp.cell0.conv_h, qj.cell0.conv_h), (qp.head, qj.head)]
    pairs += list(zip(qp.cells, qj.cells))
    assert len(qp.cells) == len(hidden) - 1
    for ours, ref in pairs:
        np.testing.assert_array_equal(_hwio(ours.wq), np.asarray(ref.wq))
        np.testing.assert_allclose(ours.wscale.numpy(), np.asarray(ref.wscale),
                                   rtol=0, atol=1e-7)
        assert (ours.bias is None) == (ref.bias is None)
        if ours.bias is not None:
            np.testing.assert_array_equal(ours.bias.numpy(),
                                          np.asarray(ref.bias))
    assert qp.cell0.conv_x.bias is None and qp.cell0.conv_x.wq.shape[1] == 1


def test_int8_step_equals_jax():
    """One quantized step from the same (nonzero) state and frame: within
    1e-5, the states stay float32."""
    hidden = (8, 16, 8)
    _, qj, qp = _quantized(hidden, seed=11)
    rng = np.random.default_rng(12)
    states = [tuple(rng.uniform(-0.5, 0.5, (2, SIZE, SIZE, f)).astype(
        np.float32) for _ in range(2)) for f in hidden]
    x = rng.random((2, SIZE, SIZE, 1), dtype=np.float32)
    js, jout = jq._int8_step(qj, tuple(tuple(jnp.asarray(a) for a in p)
                                       for p in states), jnp.asarray(x))
    ps, pout = pq._int8_step(qp, tuple(tuple(torch.from_numpy(a) for a in p)
                                       for p in states), torch.from_numpy(x))
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    for (ph, pc), (jh, jc) in zip(ps, js):
        assert ph.dtype == pc.dtype == torch.float32
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=1e-5)
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-5)


def _levels(quant, x):
    return np.asarray(quant.quantize_act(x, quant.dynamic_scale(x))
                      ).astype(int)


@pytest.mark.parametrize("hidden", [(12, 12), (8, 16, 8)])
def test_rollout_int8_matches_jax(hidden):
    """rollout_int8 and rollout_int8_from_state (from float32 and bfloat16
    states) against JAX's within ROLLOUT_ATOL, after counting, step by
    step, the int8 levels of every conv input that differ between the two
    packages (the module docstring's bound)."""
    _, qj, qp = _quantized(hidden)
    frames = _frames(3)
    ours = pq.rollout_int8(qp, torch.from_numpy(frames), T_OUT)
    ref = np.asarray(jq.rollout_int8(qj, jnp.asarray(frames), T_OUT))
    assert ours.shape == ref.shape == (2, T_OUT, 1, SIZE, SIZE)
    assert ours.dtype == torch.float32

    # the same loop, step by step, with its conv inputs' levels compared
    js = jq._zero_states(qj, 2, SIZE, SIZE)
    ps = pq._zero_states(qp, 2, SIZE, SIZE, "cpu")
    seq = frames.transpose(1, 0, 3, 4, 2)
    differ = total = 0
    for t in range(T_IN + T_OUT - 1):
        jx = jnp.asarray(seq[t]) if t < T_IN else jout
        px = torch.from_numpy(seq[t]) if t < T_IN else pout
        js, jout = jq._int8_step(qj, js, jx)
        ps, pout = pq._int8_step(qp, ps, px)
        ins = [(px, jx)] + [(p[0], j[0]) for p, j in zip(ps, js)]
        for p, j in ins:
            diff = np.abs(_levels(pquant, p) - _levels(jquant, j))
            assert diff.max() <= 1, t
            differ += int((diff > 0).sum())
            total += diff.size
    assert differ <= LEVEL_SHARE * total, (differ, total)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ROLLOUT_ATOL, rtol=0)

    # warm start from one carried state, float32 and bfloat16 (a bf16
    # stream's state): cast to float32 on entry
    rng = np.random.default_rng(4)
    states = [tuple(rng.uniform(-0.3, 0.3, (2, SIZE, SIZE, f)).astype(
        np.float32) for _ in range(2)) for f in hidden]
    prev = rng.random((2, SIZE, SIZE, 1), dtype=np.float32)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        p_preds, p_prev, p_states = pq.rollout_int8_from_state(
            qp, torch.from_numpy(prev).to(tdt),
            tuple(tuple(torch.from_numpy(a).to(tdt) for a in s)
                  for s in states), 5)
        j_preds, _, _ = jq.rollout_int8_from_state(
            qj, jnp.asarray(prev).astype(jdt),
            tuple(tuple(jnp.asarray(a).astype(jdt) for a in s)
                  for s in states), 5)
        assert p_preds.shape == (2, 5, 1, SIZE, SIZE)
        assert p_states[0][0].dtype == p_prev.dtype == torch.float32
        np.testing.assert_allclose(p_preds.numpy(), np.asarray(j_preds),
                                   atol=ROLLOUT_ATOL, rtol=0)


# ------------------------------------------------- serving: predict, stream

# the artifacts' rollouts are cut to 2 + 3 frames: torch.export traces
# every step of the loop (~150 graph nodes a step here)
T_IN_EXPORT, T_OUT_EXPORT = 2, 3


def _model(impl, t_in=T_IN, t_out=T_OUT):
    return {"family": "forecaster", "hidden_dims": [12, 12],
            "input_frames": t_in, "output_frames": t_out,
            "rollout_impl": impl}


def _config(tmp_path, impl="int8", dtype="float32", **frames):
    return Config.from_dict({
        "data": {"source": "synthetic", "synthetic_image_size": SIZE},
        "model": _model(impl, **frames),
        "precision": {"compute_dtype": dtype},
        "output": {"output_dir": str(tmp_path / "out")}})


def _jax_config(impl="int8", **frames):
    return JaxConfig.from_dict({
        "data": {"source": "synthetic"}, "model": _model(impl, **frames),
        "output": {"output_dir": "/tmp/unused_torch_quant"}})


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(.npz for the port, orbax checkpoint for JAX, params)."""
    root = tmp_path_factory.mktemp("quant_ckpt")
    params = flax_params(21, (12, 12))
    np.savez(root / "params.npz", **flatten_dict(params, sep="/"))
    save_checkpoint(str(root / "jax_ckpt"), {"params": params},
                    {"epoch": 0, "rmse": 1.0})
    return str(root / "params.npz"), str(root / "jax_ckpt"), params


def test_load_predictor_int8_data_parallel(tmp_path, checkpoints):
    """rollout_impl int8 serves through load_predictor; over two CPU
    replicas the split batch equals one process bit for bit (per-sample
    scales: no sample's grid depends on its batchmates, magnitudes
    0.1-10 across the batch); within ROLLOUT_ATOL of JAX's int8 predictor,
    and the window is checked."""
    npz, _, params = checkpoints
    frames = _frames(5, b=8) * np.linspace(0.1, 10.0, 8, dtype=np.float32)[
        :, None, None, None, None]
    cfg = _config(tmp_path)
    one = load_predictor(cfg, npz, device="cpu", data_parallel="off")
    two = load_predictor(cfg, npz, device="cpu", data_parallel="require",
                         devices=["cpu", "cpu"])
    out = one(frames)
    assert torch.equal(two(frames), out)
    ref = np.asarray(jq.rollout_int8(jq.prepare_int8_forecaster(params),
                                     jnp.asarray(frames), T_OUT))
    np.testing.assert_allclose(out.numpy(), ref, atol=ROLLOUT_ATOL * 10,
                               rtol=ROLLOUT_ATOL)
    with pytest.raises(ValueError, match="input window"):
        build_predict_fn(cfg, npz, device="cpu")(
            torch.from_numpy(frames[:, :T_IN - 1]))


def test_export_model_int8_equals_eager_and_jax(tmp_path, checkpoints):
    """export_model under int8: the traced int8 rollout with the int8
    weights inside; served from the bytes, bit-equal to the eager int8
    predictor at another batch, and within ROLLOUT_ATOL of JAX's
    jax.export int8 artifact."""
    npz, jax_ckpt, _ = checkpoints
    cut = dict(t_in=T_IN_EXPORT, t_out=T_OUT_EXPORT)
    cfg = _config(tmp_path, **cut)
    frames = _frames(6, b=3, t=T_IN_EXPORT)
    blob = export_model(cfg, npz, (frames[:1],), device="cpu")
    ep = torch.export.load(io.BytesIO(blob))
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert "aten._int_mm.default" in targets
    assert any(t.dtype == torch.int8 for t in ep.state_dict.values())
    serve = load_exported(blob, device="cpu")
    out = serve(frames)
    assert torch.equal(out, load_predictor(cfg, npz, device="cpu")(frames))
    jserve = jax_load_exported(jax_export_model(_jax_config(**cut), jax_ckpt,
                                                (frames[:1],)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jserve(frames)),
                               atol=ROLLOUT_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_int8_and_its_artifact(tmp_path, checkpoints, dtype):
    """StreamingForecaster under int8: observe is the float path's (the
    states of 'auto' on the CPU, bit for bit), forecast the int8 decode
    from the carried (float32 or bfloat16) state. In float32:
    export_streaming writes int8 forecast entries beside the float observe
    entry, 'rollout' int8 and no kernel horizons; served, bit-equal to the
    eager stream; within ROLLOUT_ATOL of JAX's int8 streaming artifact and
    of JAX's in-process int8 stream; tpu_kernel='require' is refused with
    JAX's reason."""
    npz, jax_ckpt, _ = checkpoints
    cfg = _config(tmp_path, dtype=dtype)
    frames = _frames(8, b=2)
    sf = StreamingForecaster.from_checkpoint(cfg, npz, device="cpu")
    sf_f = StreamingForecaster.from_checkpoint(
        _config(tmp_path, "auto", dtype), npz, device="cpu")
    st, now = sf.observe_window(sf.init_state(2, SIZE, SIZE), frames)
    st_f, now_f = sf_f.observe_window(sf_f.init_state(2, SIZE, SIZE), frames)
    assert torch.equal(now, now_f) and torch.equal(st.prev_out, st_f.prev_out)
    fq = sf.forecast(st, 5)
    q = pq.prepare_int8_forecaster(sf._model)
    assert torch.equal(fq, pq.rollout_int8_from_state(q, st.prev_out,
                                                      st.cells, 5)[0])
    if dtype == "bfloat16":
        assert st.prev_out.dtype == torch.bfloat16
        assert fq.dtype == torch.float32
        return

    with pytest.raises(ValueError, match="contradicts rollout_impl 'int8'"):
        export_streaming(cfg, npz, SIZE, SIZE, horizons=(5,),
                         tpu_kernel="require", device="cpu")
    blob = export_streaming(cfg, npz, SIZE, SIZE, horizons=(2, 3),
                            device="cpu")
    meta, _ = parse_stream_header(blob)
    assert meta["rollout"] == "int8" and meta["kernel_horizons"] == []
    server = load_streaming_exported(blob, device="cpu")
    state = server.init_state(2)
    for t in range(T_IN):
        state, s_now = server.observe(state, frames[:, t])
    assert torch.equal(s_now, now)
    assert torch.equal(server.forecast(state, 3), fq[:, :3])
    jserver = jax_load_streaming(jax_export_streaming(
        _jax_config(), jax_ckpt, SIZE, SIZE, horizons=(3,)))
    jstate = jserver.init_state(2)
    for t in range(T_IN):
        jstate, _ = jserver.observe(jstate, frames[:, t])
    np.testing.assert_allclose(fq[:, :3].numpy(), np.asarray(
        jserver.forecast(jstate, 3)), atol=ROLLOUT_ATOL, rtol=0)
    # and JAX's in-process int8 stream, from the same frames
    jsf = JaxStreamingForecaster(_jax_config(), {"params": checkpoints[2][
        "params"]})
    jst, _ = jsf.observe_window(jsf.init_state(2, SIZE, SIZE), frames)
    np.testing.assert_allclose(fq.numpy(), np.asarray(jsf.forecast(jst, 5)),
                               atol=ROLLOUT_ATOL, rtol=0)


def test_cli_modes_take_an_int8_config(tmp_path, checkpoints):
    """--mode predict, stream, export and export-stream on a config with
    rollout_impl int8: the predictions are the int8 predictor's, the stream
    forecasts the int8 stream's, the artifacts hold the int8 programs (the
    streaming header says int8), and export-stream --tpu-kernel require is
    refused."""
    from pl_convlstm_gan_tpu_torch import cli
    npz = checkpoints[0]
    cfg = _config(tmp_path, t_in=T_IN_EXPORT, t_out=T_OUT_EXPORT)
    yaml_path = str(tmp_path / "int8.yaml")
    cfg.to_yaml(yaml_path)
    frames = _frames(9, b=2, t=T_IN_EXPORT)
    np.save(tmp_path / "frames.npy", frames)
    run = lambda mode, out, *extra: cli.main(
        ["--config", yaml_path, "--mode", mode, "--checkpoint", npz,
         "--input", str(tmp_path / "frames.npy"), "--output",
         str(tmp_path / out), "--device", "cpu", *extra])
    run("predict", "pred.npy")
    want = load_predictor(cfg, npz, device="cpu")(frames)
    np.testing.assert_array_equal(np.load(tmp_path / "pred.npy"),
                                  want.numpy())
    run("stream", "stream.npz", "--horizons", "2")
    sf = StreamingForecaster.from_checkpoint(cfg, npz, device="cpu")
    st, _ = sf.observe_window(sf.init_state(2, SIZE, SIZE), frames)
    np.testing.assert_array_equal(np.load(tmp_path / "stream.npz")[
        "forecast_2"], sf.forecast(st, 2).numpy())
    run("export", "model.pt2")
    with open(tmp_path / "model.pt2", "rb") as f:
        assert torch.equal(load_exported(f.read(), device="cpu")(frames), want)
    run("export-stream", "s.ptexport", "--horizons", "2")
    with open(tmp_path / "s.ptexport", "rb") as f:
        assert parse_stream_header(f.read())[0]["rollout"] == "int8"
    with pytest.raises(ValueError, match="contradicts rollout_impl 'int8'"):
        run("export-stream", "r.ptexport", "--horizons", "2",
            "--tpu-kernel", "require")
