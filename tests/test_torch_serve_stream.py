"""The port's streaming serving artifacts (``serve.export_streaming`` /
``load_streaming_exported`` / ``StreamingServer``) against its eager
``StreamingForecaster`` and against the JAX package's streaming artifacts,
on the CPU; the artifact's header and the CLI.

Tolerances: an artifact against the eager path it was exported from, bit
for bit (``torch.equal``); against JAX's artifact of the same weights,
float32 atol=rtol=1e-5, bfloat16 1e-3 absolute on the nowcasts and
forecasts (outputs below 0.0625, where a bf16 ulp is 2^-12: the bounds of
tests/test_torch_streaming.py for observe and the warm rollout)."""
import io
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_convlstm_gan_tpu.serve import export_streaming as jax_export_streaming
from pl_convlstm_gan_tpu.serve import \
    load_streaming_exported as jax_load_streaming
from pl_convlstm_gan_tpu_torch import cli
from pl_convlstm_gan_tpu_torch.ops.kernels.convlstm_kernel import kernel_pack
from pl_convlstm_gan_tpu_torch.ops.kernels.rollout_kernel import (
    pack_weights, rollout_plain_from_state)
from pl_convlstm_gan_tpu_torch.serve import (JAX_STREAM_MAGIC, STREAM_MAGIC,
                                             StreamingServer,
                                             export_streaming,
                                             load_streaming_exported,
                                             parse_stream_header)
from pl_convlstm_gan_tpu_torch.streaming import StreamingForecaster
from pl_convlstm_gan_tpu_torch.weights import flax_to_state_dict
from test_torch_models import T_IN, frames_np
from test_torch_serve import (SIZE, checkpoints, graph_ops,  # noqa: F401
                              jax_config, port_config)

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-3, rtol=0.0)
HORIZONS = (2, 3)


def _export(tmp_path, npz, impl="torch", dtype="float32", **kw):
    cfg = port_config(tmp_path, impl, dtype)
    kw.setdefault("horizons", HORIZONS)
    return cfg, export_streaming(cfg, npz, SIZE, SIZE, device="cpu", **kw)


def _state_equal(a, b):
    (ca, pa), (cb, pb) = a, b
    return torch.equal(pa, pb) and all(
        torch.equal(x, y) for qa, qb in zip(ca, cb) for x, y in zip(qa, qb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_stream_artifact_equals_eager_and_matches_jax(tmp_path, checkpoints,
                                                      impl, dtype):
    """An observe chain of T_IN frames and forecasts at two horizons through
    the loaded artifact: bit for bit the eager StreamingForecaster on the
    same path, state included, and within the tolerance of JAX's artifact
    of the same weights."""
    npz, jax_ckpt, _ = checkpoints
    cfg, blob = _export(tmp_path, npz, impl, dtype)
    meta, _ = parse_stream_header(blob)
    assert meta["rollout"] == impl
    assert meta["kernel_horizons"] == (list(HORIZONS) if impl == "kernel"
                                       else [])
    server = load_streaming_exported(blob, device="cpu")
    assert server.horizons == HORIZONS
    sf = StreamingForecaster.from_checkpoint(cfg, npz, device="cpu")
    jserver = jax_load_streaming(jax_export_streaming(
        jax_config(dtype), jax_ckpt, SIZE, SIZE, horizons=HORIZONS,
        platforms=("cpu",), tpu_kernel="off"))
    tol = F32 if dtype == "float32" else BF16
    frames = frames_np(41)
    b = frames.shape[0]
    state, eager, jstate = (server.init_state(b), sf.init_state(b, SIZE, SIZE),
                            jserver.init_state(b))
    for t in range(T_IN):
        state, now = server.observe(state, frames[:, t])
        eager, eager_now = sf.observe(eager, frames[:, t])
        jstate, jnow = jserver.observe(jstate, jnp.asarray(frames[:, t]))
        assert torch.equal(now, eager_now)
        assert _state_equal(state, (eager.cells, eager.prev_out))
        np.testing.assert_allclose(now.numpy(), np.asarray(jnow), **tol)
    for h in HORIZONS:
        out = server.forecast(state, h)
        assert out.shape == (b, h, 1, SIZE, SIZE)
        assert torch.equal(out, sf.forecast(eager, h))
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jserver.forecast(jstate, h)), **tol)
    with pytest.raises(ValueError, match="not in exported set"):
        server.forecast(state, 7)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_one_stream_artifact_serves_any_batch(tmp_path, checkpoints, impl):
    """Every entry has a symbolic batch, on both paths: 5 streams through
    an artifact exported at batch 1 give the 2-stream results on their
    first rows; batch_polymorphic=False pins the batch."""
    npz, _, _ = checkpoints
    _, blob = _export(tmp_path, npz, impl, horizons=(2,))
    server = load_streaming_exported(blob, device="cpu")
    frames = frames_np(42, b=5)
    s2, now2 = server.observe(server.init_state(2), frames[:2, 0])
    s5, now5 = server.observe(server.init_state(5), frames[:, 0])
    assert now5.shape == (5, 1, SIZE, SIZE)
    assert torch.equal(now5[:2], now2)
    assert torch.equal(server.forecast(s5, 2)[:2], server.forecast(s2, 2))
    _, pinned = _export(tmp_path, npz, impl, horizons=(2,),
                        batch_polymorphic=False, batch_size=2)
    pinned = load_streaming_exported(pinned, device="cpu")
    pinned.observe(pinned.init_state(2), frames[:2, 0])
    with pytest.raises(Exception):
        pinned.observe(pinned.init_state(5), frames[:, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_stream_artifact_holds_the_ops(tmp_path, checkpoints, dtype):
    """rollout_impl kernel on the CPU: observe is the plcg_torch.observe
    node and forecast_<h> the plcg_torch.rollout_from_state node, with no
    conv of the model in either; a forecast equals
    rollout_plain_from_state's bit for bit."""
    npz, _, params = checkpoints
    _, blob = _export(tmp_path, npz, "kernel", dtype)
    meta, off = parse_stream_header(blob)
    sizes = dict(meta["entries"])
    observe = blob[off:off + sizes["observe"]]
    forecast = blob[off + sizes["observe"]:
                    off + sizes["observe"] + sizes["forecast_2"]]
    for data, op in ((observe, "plcg_torch.observe.default"),
                     (forecast, "plcg_torch.rollout_from_state.default")):
        ops = graph_ops(data)
        assert op in ops and not any("convolution" in o for o in ops)
    server = load_streaming_exported(blob, device="cpu")
    state, _ = server.observe(server.init_state(2), frames_np(43)[:, 0])
    cdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    want = rollout_plain_from_state(
        pack_weights(flax_to_state_dict(params), cdtype), state[0], state[1],
        3, cdtype)
    assert torch.equal(server.forecast(state, 3), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_kernel_stream_entries_carry_k1_packed_weights(tmp_path,
                                                           checkpoints, dtype):
    """Every kernel entry of a stream artifact exported on the CPU holds
    K1's packed weight of every cell, as one exported on the card does."""
    npz, _, params = checkpoints
    _, blob = _export(tmp_path, npz, "kernel", dtype)
    meta, off = parse_stream_header(blob)
    cdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    cells = pack_weights(flax_to_state_dict(params), cdtype).cells
    for name, length in meta["entries"]:
        buffers = torch.export.load(io.BytesIO(blob[off:off + length])
                                    ).state_dict
        off += length
        for i, (w, _) in enumerate(cells):
            assert torch.equal(buffers[f"kernels.cell_{i}_packed"],
                               kernel_pack(w, cdtype)), name


def test_tpu_kernel_values_pick_the_entries(tmp_path, checkpoints):
    """auto follows rollout_choice on the export device (the CPU: the plain
    path unless the config asks for the kernels), require raises unless it
    takes the kernels, off exports plain programs."""
    npz, _, _ = checkpoints
    rollout = lambda blob: parse_stream_header(blob)[0]["rollout"]
    assert rollout(_export(tmp_path, npz, "auto", horizons=(2,))[1]) == \
        "torch"
    assert rollout(_export(tmp_path, npz, "kernel")[1]) == "kernel"
    assert rollout(_export(tmp_path, npz, "kernel", tpu_kernel="require",
                           horizons=(2,))[1]) == "kernel"
    assert rollout(_export(tmp_path, npz, "kernel", tpu_kernel="off",
                           horizons=(2,))[1]) == "torch"
    with pytest.raises(ValueError, match="require"):
        _export(tmp_path, npz, "auto", tpu_kernel="require")
    with pytest.raises(ValueError, match="auto/require/off"):
        _export(tmp_path, npz, tpu_kernel="on")
    for bad in ((), (0,), (2, 2)):
        with pytest.raises(ValueError, match="horizons"):
            _export(tmp_path, npz, horizons=bad)


def _forge(meta, payload, magic=STREAM_MAGIC):
    hdr = json.dumps(meta).encode()
    return magic + struct.pack("<I", len(hdr)) + hdr + payload


def test_parse_stream_header_corrupt_blobs():
    """Malformed blobs raise ValueError, a JAX artifact by name."""
    with pytest.raises(ValueError, match="not a streaming"):
        parse_stream_header(b"\x00" * 16)
    with pytest.raises(ValueError, match="JAX .jaxexport.*re-export"):
        parse_stream_header(_forge({"format": 1, "entries": []}, b"",
                                   JAX_STREAM_MAGIC))
    with pytest.raises(ValueError, match="truncated"):
        parse_stream_header(STREAM_MAGIC + b"\x01")
    with pytest.raises(ValueError, match="truncated"):
        parse_stream_header(STREAM_MAGIC + struct.pack("<I", 100) + b"{}")
    bad = b"not json at all!"
    with pytest.raises(ValueError, match="corrupt"):
        parse_stream_header(STREAM_MAGIC + struct.pack("<I", len(bad)) + bad)
    with pytest.raises(ValueError, match="newer"):
        parse_stream_header(_forge({"format": 99, "entries": []}, b""))
    blob = _forge({"format": 1, "entries": []}, b"")
    meta, off = parse_stream_header(blob)
    assert meta["format"] == 1 and off == len(blob)


def test_loader_skips_unknown_entries_and_checks_bounds(tmp_path,
                                                        checkpoints):
    """An entry kind this release does not know is skipped without reading
    its (here garbled) bytes; a payload cut mid-entry and a blob with no
    observe entry raise ValueError."""
    npz, _, _ = checkpoints
    _, blob = _export(tmp_path, npz, "kernel", horizons=(2,))
    meta, off = parse_stream_header(blob)
    sizes = dict(meta["entries"])
    chunks, pos = {}, off
    for name, size in meta["entries"]:
        chunks[name] = blob[pos:pos + size]
        pos += size
    renamed = [[n if n != "forecast_2" else "forecast_2_futurekind", s]
               for n, s in meta["entries"]]
    garbled = chunks["observe"] + b"\xde" * sizes["forecast_2"]
    server = load_streaming_exported(_forge(dict(meta, entries=renamed),
                                            garbled), device="cpu")
    assert server.horizons == ()
    _, now = server.observe(server.init_state(1),
                            np.zeros((1, 1, SIZE, SIZE), np.float32))
    assert now.shape == (1, 1, SIZE, SIZE)
    with pytest.raises(ValueError, match="cut short"):
        load_streaming_exported(blob[:-10], device="cpu")
    no_observe = dict(meta, entries=[["forecast_2", sizes["forecast_2"]]])
    with pytest.raises(ValueError, match="no observe"):
        load_streaming_exported(_forge(no_observe, chunks["forecast_2"]),
                                device="cpu")


def test_streaming_server_has_no_fallback():
    """A forecast program that raises takes the call down with it, every
    time: no other program answers in its place (the opposite of the JAX
    server's runtime fallback off its TPU kernel program)."""
    calls = []

    def failing(state):
        calls.append(1)
        raise RuntimeError("kernel launch failed")

    meta = {"height": 8, "width": 8, "channels": 1, "hidden": [8, 8],
            "dtype": "float32"}
    server = StreamingServer(meta, lambda s, f: (s, f), {2: failing},
                             device="cpu")
    state = server.init_state(1)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            server.forecast(state, 2)
    assert len(calls) == 2


def _write_config(tmp_path, impl):
    path = tmp_path / "stream.yaml"
    port_config(tmp_path, impl).to_yaml(str(path))
    return str(path)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_cli_export_stream_and_stream_the_artifact(tmp_path, checkpoints,
                                                   impl):
    """--mode export-stream writes <output_dir>/stream.ptexport (frame size
    from the dataset); --mode stream with it as --checkpoint writes what
    stream mode writes from the weights; a .jaxexport is refused, and so
    are horizons and frame sizes the artifact does not have."""
    npz, _, _ = checkpoints
    yaml = _write_config(tmp_path, impl)
    cli.main(["--config", yaml, "--mode", "export-stream", "--checkpoint",
              npz, "--horizons", "2,3", "--device", "cpu"])
    art = tmp_path / "out" / "stream.ptexport"
    assert parse_stream_header(art.read_bytes())[0]["rollout"] == impl
    np.save(tmp_path / "frames.npy", frames_np(44))
    outs = {}
    for name, ckpt in (("weights", npz), ("artifact", str(art))):
        out = tmp_path / f"{name}.npz"
        cli.main(["--config", yaml, "--mode", "stream", "--input",
                  str(tmp_path / "frames.npy"), "--checkpoint", ckpt,
                  "--horizons", "2,3", "--output", str(out), "--device",
                  "cpu"])
        outs[name] = dict(np.load(out))
    assert sorted(outs["artifact"]) == ["forecast_2", "forecast_3",
                                        "nowcasts"]
    for key, value in outs["weights"].items():
        np.testing.assert_array_equal(outs["artifact"][key], value)
    base = ["--config", yaml, "--mode", "stream", "--device", "cpu",
            "--input", str(tmp_path / "frames.npy")]
    with pytest.raises(SystemExit, match="missing \\[5\\]"):
        cli.main(base + ["--checkpoint", str(art), "--horizons", "5"])
    np.save(tmp_path / "small.npy", frames_np(45, size=8))
    with pytest.raises(SystemExit, match="exported at"):
        cli.main(["--config", yaml, "--mode", "stream", "--device", "cpu",
                  "--input", str(tmp_path / "small.npy"), "--checkpoint",
                  str(art), "--horizons", "2"])
    with pytest.raises(SystemExit, match="re-export"):
        cli.main(base + ["--checkpoint", str(tmp_path / "s.jaxexport")])
