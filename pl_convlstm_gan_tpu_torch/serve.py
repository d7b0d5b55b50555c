"""Serving artifacts: ``torch.export`` programs of the predictor and of the
streaming surface. Counterpart of the JAX package's ``serve.py``.

A checkpoint becomes bytes that a serving process loads and calls with no
model code, config or checkpoint:

    from pl_convlstm_gan_tpu_torch.serve import export_model, load_exported
    blob = export_model(config, "output/best_model", (sample,))   # bytes
    open("model.pt2", "wb").write(blob)
    serve = load_exported(open("model.pt2", "rb").read())         # the GPU
    pred = serve(frames)          # forecaster / GAN: any batch size
    pred = serve(rain, dem, lu)   # Generator family

The bytes of ``export_model`` are exactly what ``torch.export.save`` writes,
so ``torch.export.load`` alone reads them back (after importing
``ops.kernels.export_ops``, whose ops a kernel-path program holds).

- **The path is decided before export** by ``predict.rollout_choice`` on the
  export device: the kernel path becomes one registered op per call
  (``plcg_torch::rollout``, ``rollout_from_state``, ``observe``:
  ``ops/kernels/export_ops.py``), which launches the kernels exactly as the
  eager kernel path does (one K5 a call in bfloat16, K1 and K2 step by
  step in float32), the counterpart of JAX's Pallas-embedded
  programs; the plain path is the traced ``ConvLSTMForecaster``.
- **The Generator family exports on its plain cells.** Its K1 is a
  ``torch.autograd.Function`` around a ctypes launch, not a registered op,
  and ``torch.export`` cannot trace it; JAX's artifact is likewise portable
  XLA. K1 as a registered op for the Generator is left to a later change.
- **A symbolic batch** (``torch.export.Dim``) makes one artifact serve any
  batch. ``torch.export`` refuses a dynamic dimension whose example is 1, so
  an example of batch 1 is repeated to batch 2 before export.
- **The device.** ``torch.export`` bakes the device of constants and of
  tensors made in ``forward`` (the forecaster's zero state) into the graph,
  so the loaders move a program to the serving device
  (``torch.export.passes.move_to_device_pass``): the GPU unless the caller
  passes ``device="cpu"``. JAX's multi-platform ``platforms`` has no
  counterpart.
- ``rollout_impl: int8`` exports the quantized rollout
  (``models/quantized.py``), as JAX's does: ``export_model`` traces
  ``rollout_int8`` with the int8 kernels and their scales as buffers of the
  program; ``export_streaming`` writes int8 forecast entries beside the
  float observe entry (observe stays float, as in ``StreamingForecaster``:
  the kernel op on a GPU that takes the model, unless ``tpu_kernel`` is
  "off"), with ``rollout`` "int8" in the header and no kernel forecast
  entries; ``tpu_kernel="require"`` contradicts int8 and raises.

The streaming artifact (``export_streaming``) keeps JAX's wire layout with a
magic of its own: magic, a little-endian u32 header length, a JSON header
(state geometry, ``rollout``, ``horizons``, ``kernel_horizons``, the entry
names and sizes), then an ``observe`` entry and one ``forecast_<h>`` entry
per horizon, each the bytes of ``torch.export.save``. A JAX artifact is
refused by name; entry kinds this release does not know are skipped before
their bytes are read.
"""
from __future__ import annotations

import copy
import io
import json
import struct
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from .config import Config, rollout_path
from .models.quantized import (Int8Weights, prepare_int8_forecaster,
                               rollout_int8)
from .ops.kernels.export_ops import KernelWeights
from .ops.kernels.rollout_kernel import pack_weights
from .predict import (_as_tensor, build_predict_fn, compute_dtype,
                      resolve_device, rollout_choice)
from .streaming import StreamingForecaster

STREAM_MAGIC = b"PLCGPTS1"
JAX_STREAM_MAGIC = b"PLCGSTR1"     # the JAX package's streaming artifacts
STREAM_FORMAT = 1
TPU_KERNEL = ("auto", "require", "off")


class _Int8Rollout(nn.Module):
    """The batch predictor's int8 path: frames [B,T_in,C,H,W] ->
    [B,T_out,C,H,W] float32, the int8 weights as buffers."""

    def __init__(self, q, t_in: int, t_out: int):
        super().__init__()
        self.weights = Int8Weights(q)
        self.t_in, self.t_out = t_in, t_out

    def forward(self, frames):
        if frames.shape[1] != self.t_in:
            raise ValueError(f"expected a {self.t_in}-frame input window "
                             f"(model.input_frames), got {frames.shape[1]}")
        return rollout_int8(self.weights.forecaster(), frames, self.t_out)


class _KernelRollout(nn.Module):
    """The batch predictor's kernel path as one op: frames [B,T_in,C,H,W]
    -> [B,T_out,C,H,W] float32, the weights as buffers."""

    def __init__(self, weights, t_in: int, t_out: int):
        super().__init__()
        self.weights = KernelWeights(weights)
        self.t_in, self.t_out = t_in, t_out

    def forward(self, frames):
        if frames.shape[1] != self.t_in:
            raise ValueError(f"expected a {self.t_in}-frame input window "
                             f"(model.input_frames), got {frames.shape[1]}")
        return self.weights.rollout(frames, self.t_out)


def _plain_cells(config: Config) -> Config:
    """A copy of ``config`` whose cells take their plain step
    (``convlstm_impl: xla``): a cell on K1 launches through ctypes, which
    ``torch.export`` cannot trace. The kernel path is the ops, not the
    cells."""
    config = copy.deepcopy(config)
    config.model.convlstm_impl = "xla"
    return config


def _save(program: nn.Module, args, dynamic_shapes) -> bytes:
    with torch.no_grad():
        exported = torch.export.export(program, args,
                                       dynamic_shapes=dynamic_shapes)
    # the example inputs would be saved with the program: a stream's state
    # at 128^2 is ~50 MB an entry
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def _load(data: bytes, device: torch.device) -> Callable:
    """The program in ``data`` on ``device``, as a callable module."""
    exported = torch.export.load(io.BytesIO(data))
    return move_to_device_pass(exported, device).module()


def export_model(config: Config, checkpoint_path: str, example_args: Sequence,
                 lu_channels: int = 0, output_frames: int = 0,
                 batch_polymorphic: bool = True, device=None) -> bytes:
    """Load ``checkpoint_path`` and export the predictor as the bytes of
    ``torch.export.save``. ``example_args`` fix the non-batch shapes
    (forecaster / GAN: ``(frames,)``; Generator: ``(rain_lr, dem, lu)``);
    the batch is symbolic unless ``batch_polymorphic`` is False, which pins
    it to the example's. ``device`` (default: the GPU) is where the
    weights are loaded and the path decided (``rollout_choice``); the
    forecaster's kernel path becomes the ``plcg_torch::rollout`` op, its
    int8 path the traced ``rollout_int8`` on weights quantized here."""
    if config.model.family == "predrnn":
        raise ValueError("export_model serves the forecaster, GAN and "
                         "Generator families; family predrnn has no "
                         "serving artifact (serve it with load_predictor)")
    dev = resolve_device(device)
    plain = _plain_cells(config)
    if config.model.family == "generator":
        program = build_predict_fn(plain, checkpoint_path, lu_channels,
                                   output_frames, device=dev)
    else:
        impl = rollout_choice(config, dev)
        model = build_predict_fn(plain, checkpoint_path, lu_channels,
                                 output_frames, rollout_impl="torch",
                                 device=dev)
        if impl == "torch":
            program = model
        elif impl == "int8":
            program = _Int8Rollout(prepare_int8_forecaster(model),
                                   model.input_frames, model.output_frames)
        else:
            program = _KernelRollout(
                pack_weights(model.state_dict(), compute_dtype(config)),
                model.input_frames, model.output_frames)
    args = [_as_tensor(a).to(dev, torch.float32) for a in example_args]
    dynamic = None
    if batch_polymorphic:
        args = [torch.cat([a, a]) if a.shape[0] == 1 else a for a in args]
        batch = torch.export.Dim("batch")
        dynamic = tuple({0: batch} for _ in args)
    return _save(program, tuple(args), dynamic)


def load_exported(blob: bytes, device=None) -> Callable:
    """An ``export_model`` artifact as ``fn(*inputs) -> output``: inputs
    (numpy or tensors) go to ``device`` (default: the GPU) as float32, and
    the program runs there without autograd. Nothing of the model code,
    config or checkpoint is read."""
    dev = resolve_device(device)
    program = _load(blob, dev)

    def serve(*inputs):
        with torch.inference_mode():
            return program(*(_as_tensor(a).to(dev, torch.float32)
                             for a in inputs))
    return serve


# ---------------------------------------------------------------------------
# Streaming artifacts: an ``observe`` program and one ``forecast`` program per
# horizon in one blob, with the state geometry in a JSON header.
# ---------------------------------------------------------------------------

def export_streaming(config: Config, checkpoint_path: str, height: int,
                     width: int, horizons: Sequence[int] = (10,),
                     batch_polymorphic: bool = True, batch_size: int = 1,
                     tpu_kernel: str = "auto", device=None) -> bytes:
    """Export ``StreamingForecaster``'s surface for a checkpoint: ``observe``
    (``(state, frame [B,C,H,W]) -> (state, nowcast)``) and ``forecast_<h>``
    (``state -> [B,h,C,H,W]``) per horizon, at static H and W; the batch
    (the number of concurrent streams) is symbolic in every entry unless
    ``batch_polymorphic`` is False, which pins it to ``batch_size``.

    ``tpu_kernel`` keeps the JAX name and values and selects the CUDA
    kernel entries: "auto" exports the kernel path's ops when
    ``rollout_choice`` takes the kernels on the export device ``device``
    (default: the GPU), else the plain programs; "require" raises unless it
    does; "off" exports the plain programs. K1, K2 and K5 take any batch,
    so kernel entries are batch-polymorphic too. Under ``rollout_impl: int8``
    the forecast entries are the quantized decode and the observe entry the
    float one of "auto" (or "off"); "require" raises, as JAX's does."""
    horizons = [int(h) for h in horizons]
    if not horizons or any(h < 1 for h in horizons):
        raise ValueError(f"horizons must be >= 1, got {horizons}")
    if len(set(horizons)) != len(horizons):
        raise ValueError(f"duplicate horizons: {horizons}")
    if tpu_kernel not in TPU_KERNEL:
        raise ValueError(f"tpu_kernel must be auto/require/off, got "
                         f"{tpu_kernel!r}")
    dev = resolve_device(device)
    config = _plain_cells(config)
    int8 = rollout_path(config.model.rollout_impl) == "int8"
    if int8 and tpu_kernel == "require":
        raise ValueError(
            "tpu_kernel='require' contradicts rollout_impl 'int8': kernel "
            "forecast entries are float programs and would serve "
            "non-quantized forecasts from an artifact exported as int8 - "
            "export with tpu_kernel='auto' or 'off' (or a non-int8 config)")
    # the float programs' path: observe's, and the forecasts' unless int8
    if tpu_kernel == "off":
        config.model.rollout_impl = "torch"
    elif int8:
        config.model.rollout_impl = "auto"
    sf = StreamingForecaster.from_checkpoint(config, checkpoint_path, dev)
    meta = sf.export_meta()
    forecast_fn = sf.export_forecast_int8_fn if int8 else \
        sf.export_forecast_fn
    if tpu_kernel == "require" and meta["rollout"] != "kernel":
        raise ValueError(
            f"tpu_kernel='require' but the kernel path does not serve this "
            f"model on {dev} (rollout_impl {config.model.rollout_impl!r}: "
            f"'auto' takes the kernels only on a GPU whose K1 and K2 take "
            f"the model's widths)")
    b = batch_size
    if batch_polymorphic and b == 1:
        b = 2
    state = sf.init_state(b, height, width)
    state = (tuple(tuple(pair) for pair in state.cells), state.prev_out)
    frame = torch.zeros((b, meta["channels"], height, width), device=dev)
    if batch_polymorphic:
        dim = {0: torch.export.Dim("batch")}
        state_dims = (tuple((dim, dim) for _ in state[0]), dim)
        observe_dims, forecast_dims = (state_dims, dim), (state_dims,)
    else:
        observe_dims = forecast_dims = None
    entries = [("observe", _save(sf.export_observe_fn(), (state, frame),
                                 observe_dims))]
    for h in horizons:
        entries.append((f"forecast_{h}", _save(forecast_fn(h), (state,),
                                               forecast_dims)))
    if int8:
        meta["rollout"] = "int8"
    header = json.dumps({
        "format": STREAM_FORMAT, "height": height, "width": width,
        "horizons": horizons,
        "kernel_horizons": horizons if meta["rollout"] == "kernel" else [],
        "batch_polymorphic": bool(batch_polymorphic),
        "batch_size": batch_size,
        "entries": [[name, len(data)] for name, data in entries], **meta,
    }).encode()
    return b"".join([STREAM_MAGIC, struct.pack("<I", len(header)), header]
                    + [data for _, data in entries])


class StreamingServer:
    """A deserialized streaming artifact on one device: zero-init streams,
    assimilate frames, branch forecasts, with no model code, config or
    checkpoint. ``meta`` is the artifact's header.

    JAX's server serves an embedded TPU kernel program and, when it fails,
    warns and serves the portable program instead. This one has no such
    fallback: a forecast program raises its error to the caller, kernel
    program or not, so that no failure hides behind a slower path."""

    def __init__(self, meta: dict, observe_fn: Callable,
                 forecast_fns: Dict[int, Callable], device=None):
        self.meta = meta
        self.device = resolve_device(device)
        self._observe = observe_fn
        self._forecasts = dict(forecast_fns)

    @property
    def horizons(self) -> Tuple[int, ...]:
        return tuple(sorted(self._forecasts))

    def init_state(self, batch_size: int):
        """Fresh zero state of ``batch_size`` streams: ``(((h, c), ...),
        prev_out)``, NHWC in the artifact's compute dtype."""
        m = self.meta
        dtype = torch.bfloat16 if m["dtype"] == "bfloat16" else torch.float32
        zeros = lambda f: torch.zeros((batch_size, m["height"], m["width"], f),
                                      dtype=dtype, device=self.device)
        return (tuple((zeros(f), zeros(f)) for f in m["hidden"]),
                zeros(m["channels"]))

    def observe(self, state, frame):
        """Assimilate ``frame [B, C, H, W]`` -> ``(new_state, nowcast
        [B, C, H, W] float32)``."""
        frame = _as_tensor(frame).to(self.device, torch.float32)
        with torch.inference_mode():
            return self._observe(state, frame)

    def forecast(self, state, horizon: int):
        """Branch a ``horizon``-frame forecast ``[B, horizon, C, H, W]``
        float32 (an exported horizon) from ``state`` without changing it."""
        if horizon not in self._forecasts:
            raise ValueError(f"horizon {horizon} not in exported set "
                             f"{self.horizons}")
        with torch.inference_mode():
            return self._forecasts[horizon](state)


def parse_stream_header(blob: bytes) -> Tuple[dict, int]:
    """Check the magic and format; return ``(header, payload offset)``.
    Every malformed blob raises ValueError."""
    if blob[:len(JAX_STREAM_MAGIC)] == JAX_STREAM_MAGIC:
        raise ValueError("a JAX .jaxexport streaming artifact: re-export it "
                         "with the port (serve.export_streaming, or --mode "
                         "export-stream)")
    if blob[:len(STREAM_MAGIC)] != STREAM_MAGIC:
        raise ValueError("not a streaming serving artifact of the port")
    off = len(STREAM_MAGIC)
    if len(blob) < off + 4:
        raise ValueError("truncated streaming artifact (no header length)")
    (hlen,) = struct.unpack("<I", blob[off:off + 4])
    off += 4
    raw = blob[off:off + hlen]
    if len(raw) < hlen:
        raise ValueError("truncated streaming artifact (header cut short)")
    try:
        meta = json.loads(raw.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"corrupt streaming artifact header: {e}") from e
    fmt = meta.get("format", 1)
    if fmt > STREAM_FORMAT:
        raise ValueError(f"streaming artifact format {fmt} is newer than "
                         f"this release supports ({STREAM_FORMAT})")
    return meta, off + hlen


def load_streaming_exported(blob: bytes, device=None) -> StreamingServer:
    """An ``export_streaming`` artifact as a ``StreamingServer`` on
    ``device`` (default: the GPU). Entry names are read before any payload:
    an entry of a kind this release does not know is skipped without
    deserializing its bytes."""
    dev = resolve_device(device)
    meta, off = parse_stream_header(blob)
    raw = []
    for name, length in meta["entries"]:
        if off + length > len(blob):
            raise ValueError(f"truncated streaming artifact (entry {name!r} "
                             f"cut short)")
        raw.append((name, blob[off:off + length]))
        off += length
    observe, forecasts = None, {}
    for name, data in raw:
        kind, _, h = name.partition("_")
        if name == "observe":
            observe = _load(data, dev)
        elif kind == "forecast" and h.isdigit():
            forecasts[int(h)] = _load(data, dev)
        # any other name: an entry kind of a newer writer, skipped
    if observe is None:
        raise ValueError("streaming artifact has no observe entry")
    return StreamingServer(meta, observe, forecasts, dev)
