"""Streaming (stateful) inference for the sequence families.

Counterpart of the JAX package's ``streaming.py``. An operational nowcasting
service sees one new observation per time step, folds it into the carried
``(h, c)`` state at the cost of one recurrence step, and branches forecasts
of any horizon from that state without changing it.

    sf = StreamingForecaster.from_checkpoint(config, "params.npz")   # GPU
    state = sf.init_state(B, H, W)
    state, nowcast = sf.observe_window(state, frames)   # [B,T,C,H,W]
    state, nowcast = sf.observe(state, frame)           # [B,C,H,W]
    future = sf.forecast(state, 30)                     # [B,30,C,H,W] f32

Observing the batch model's input window and forecasting ``T_out - 1`` more
frames gives its rollout: ``cat([nowcast[:, None], forecast(state, T_out -
1)], 1)`` equals ``load_predictor(config, ...)(frames)``.

``model.rollout_impl`` picks the path of both ``observe`` and ``forecast``
once, at construction (``predict.rollout_choice``): 'kernel' (JAX's
'pallas'), or 'auto' on a GPU when K1 and K2 take the model's widths, runs
the kernels (``ops/kernels``): in bfloat16 one K5 launch a call (an
observe of any number of frames, a forecast of any horizon) where
``persistent_misfit`` admits the model, else K1 and K2 one step per frame
or per forecast frame;
'torch' (JAX's 'xla'), or 'auto' otherwise, runs the plain modules of
``ConvLSTMForecaster``. On CPU tensors the kernel wrappers run their plain
versions. Every method returns new tensors and writes none of its inputs, so
a caller may hold several branches of one stream.

The export hooks (``export_observe_fn``, ``export_forecast_fn``,
``export_meta``; ``serve.export_streaming`` calls them) give the same
computations as ``nn.Module``s that ``torch.export`` traces: on the kernel
path each is one registered op (``ops/kernels/export_ops.py``), on the plain
path the plain step loop. Their state is plain nested tuples, ``(((h, c),
...), prev_out)``, as JAX's hooks take it.

``rollout_impl: int8`` makes ``forecast`` the quantized decode
(``models/quantized.py``: ``rollout_int8_from_state``, weights quantized
once, at the first forecast), as JAX's does. ``observe`` stays float, as
JAX's: it is one step a frame and sets the state every branch starts from;
it takes the path that ``rollout_impl: auto`` takes on the device, so the
kernels on a GPU whose kernels take the model. The export hook of that forecast
is ``export_forecast_int8_fn``. JAX's ``pallas_forecast_fits`` becomes
``rollout_kernel_misfit``: K1 and K2 take any frame size, batch and horizon,
so the choice depends only on the widths, the kernel size and the compute
dtype, and is made before any export.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from .config import Config
from .models.quantized import (Int8Weights, prepare_int8_forecaster,
                               rollout_int8_from_state)
from .ops.kernels.export_ops import KernelWeights
from .ops.kernels.rollout_kernel import (observe_kernel, pack_weights,
                                         rollout_kernel_from_state)
from .predict import (build_model, compute_dtype, load_state_dict,
                      resolve_device, rollout_choice)
from .utils.profiling import span


class StreamState(NamedTuple):
    """The carried recurrent state, on the forecaster's device.

    ``cells``: per-cell ``(h, c)`` pairs, each ``[B, H, W, features]`` NHWC in
    the compute dtype. ``prev_out``: the model's latest emitted frame
    ``[B, H, W, C]``, the input of the next forecast step."""
    cells: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    prev_out: torch.Tensor


class StreamingForecaster:
    """Stateful online inference over a forecaster/GAN-generator checkpoint.

    ``state_dict`` is the port's (``weights.flax_to_state_dict`` of a flax
    params tree, or a ``.pt``); ``device`` defaults to the GPU and raises
    without one unless the caller passes ``device="cpu"``."""

    def __init__(self, config: Config, state_dict, device=None):
        mc = config.model
        if mc.family not in ("forecaster", "gan"):
            raise ValueError(
                f"streaming inference needs a sequence family "
                f"(forecaster/gan), got {mc.family!r}")
        self.device = resolve_device(device)
        self._int8 = rollout_choice(config, self.device) == "int8"
        # the float path: observe's, and forecast's unless under int8
        self._kernels = rollout_choice(
            config, self.device, "auto" if self._int8 else "") == "kernel"
        self._q = None         # the int8 weights, made at the first forecast
        self._hidden = tuple(mc.hidden_dims)
        self._channels = mc.in_channels
        self._cdtype = compute_dtype(config)
        model = build_model(config)
        model.load_state_dict(state_dict)
        model.to(self.device).eval()
        self._model = model
        self._core = model.core
        self._weights = (pack_weights(model.state_dict(), self._cdtype)
                         if self._kernels else None)

    @classmethod
    def from_checkpoint(cls, config: Config, checkpoint_path: str,
                        device=None) -> "StreamingForecaster":
        """A ``.npz`` of flattened flax params, a torch ``.pt``, or a
        checkpoint directory of the port's trainer (``best_model``; of a
        GAN run, its ``gen_params``)."""
        return cls(config, load_state_dict(checkpoint_path), device)

    def init_state(self, batch_size: int, height: int, width: int
                   ) -> StreamState:
        """Fresh zero state (the batch model's zero-init carry)."""
        zeros = lambda f: torch.zeros((batch_size, height, width, f),
                                      dtype=self._cdtype, device=self.device)
        return StreamState(tuple((zeros(f), zeros(f)) for f in self._hidden),
                           zeros(self._channels))

    def observe_window(self, state: StreamState, frames
                       ) -> Tuple[StreamState, torch.Tensor]:
        """Assimilate ``frames [B, T, C, H, W]`` (numpy or tensor); returns
        ``(new_state, nowcast [B, C, H, W] float32)``: the 1-step-ahead
        prediction from the last frame (the batch rollout's first frame).
        While the program's trace is on, the call is the span
        ``plcg.stream.observe`` (``utils.profiling``)."""
        with span("stream.observe"):
            frames = torch.as_tensor(np.asarray(frames) if not isinstance(
                frames, torch.Tensor) else frames).to(self.device,
                                                      torch.float32)
            if frames.ndim != 5 or frames.shape[1] < 1:
                raise ValueError(f"frames must be [B, T >= 1, C, H, W], got "
                                 f"{tuple(frames.shape)}")
            with torch.inference_mode():
                if self._kernels:
                    cells, prev = observe_kernel(self._weights, state.cells,
                                                 frames, self._cdtype)
                else:
                    cells, prev = _plain_observe(self._core, state.cells,
                                                 state.prev_out, frames,
                                                 self._cdtype)
                nowcast = prev.permute(0, 3, 1, 2).to(torch.float32,
                                                      copy=True)
            return StreamState(cells, prev), nowcast

    def observe(self, state: StreamState, frame
                ) -> Tuple[StreamState, torch.Tensor]:
        """Assimilate one frame ``[B, C, H, W]``; returns ``(new_state,
        nowcast [B, C, H, W] float32)``."""
        frame = torch.as_tensor(np.asarray(frame) if not isinstance(
            frame, torch.Tensor) else frame)
        return self.observe_window(state, frame[:, None])

    def forecast(self, state: StreamState, horizon: int) -> torch.Tensor:
        """Free-running rollout of ``horizon`` frames ``[B, horizon, C, H, W]``
        float32 beyond the state's nowcast, without touching ``state`` (a pure
        branch). On the kernel path: one K5 launch in bfloat16, else
        horizon x n_cells K1 launches and horizon K2 launches; under int8
        none (int8 convs on ``torch._int_mm``). While the program's trace is
        on, the call is the span ``plcg.stream.forecast``."""
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        with span("stream.forecast"), torch.inference_mode():
            if self._int8:
                return rollout_int8_from_state(
                    self._int8_weights(), state.prev_out, state.cells,
                    horizon)[0]
            if self._kernels:
                return rollout_kernel_from_state(
                    self._weights, state.cells, state.prev_out, horizon,
                    self._cdtype)
            return _plain_forecast(self._core, state.cells, state.prev_out,
                                   horizon)

    def _int8_weights(self):
        """The int8 weights, quantized once, at the first call (as ordinary
        tensors, also when that call runs under inference mode, so that an
        export may hold them)."""
        if self._q is None:
            with torch.inference_mode(False), torch.no_grad():
                self._q = prepare_int8_forecaster(self._model)
        return self._q

    # -- export hooks (serve.export_streaming) ------------------------------
    def export_observe_fn(self) -> nn.Module:
        """A module ``(state, frame [B,C,H,W] float32) -> (state, nowcast
        [B,C,H,W] float32)``, state = ``(((h, c), ...), prev_out)``, with
        the weights as its buffers and parameters."""
        return _ObserveProgram(self)

    def export_forecast_fn(self, horizon: int) -> nn.Module:
        """A module ``state -> forecast [B, horizon, C, H, W] float32`` (a
        pure branch)."""
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        return _ForecastProgram(self, horizon)

    def export_forecast_int8_fn(self, horizon: int) -> nn.Module:
        """The quantized variant of ``export_forecast_fn`` (``rollout_impl:
        int8``): a module ``state -> forecast [B, horizon, C, H, W]
        float32`` with the int8 weights and their scales as buffers."""
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        return _Int8ForecastProgram(self._int8_weights(), horizon)

    def export_meta(self) -> dict:
        """What a serving process needs to zero-init a stream without model
        code, and which path the forecast programs run (``rollout``:
        "kernel", "torch" or "int8")."""
        return {"hidden": list(self._hidden), "channels": self._channels,
                "dtype": ("bfloat16" if self._cdtype == torch.bfloat16
                          else "float32"),
                "rollout": ("int8" if self._int8 else
                            "kernel" if self._kernels else "torch")}


def _plain_step(core, cells, x):
    """One step of the plain modules: x [B,H,W,C] -> (cells, head out)."""
    n = len(core.cells())
    if len(cells) != n:
        raise ValueError(f"{len(cells)} state pairs for {n} cells")
    new = []
    for cell, (h, c) in zip(core.cells(), cells):
        h, c = cell(x, h, c)
        new.append((h, c))
        x = h
    return tuple(new), core.head(x)


def _plain_observe(core, cells, prev, frames, cdtype):
    """Fold frames [B,T,C,H,W] into (cells, prev) one plain step a frame."""
    for t in range(frames.shape[1]):
        cells, prev = _plain_step(core, cells,
                                  frames[:, t].permute(0, 2, 3, 1).to(cdtype))
    return cells, prev


def _plain_forecast(core, cells, prev, horizon):
    """``horizon`` plain steps from (cells, prev) -> [B,horizon,C,H,W]
    float32."""
    outs = []
    for _ in range(horizon):
        cells, prev = _plain_step(core, cells, prev)
        outs.append(prev)
    return torch.stack(outs).permute(1, 0, 4, 2, 3).float()


class _StreamProgram(nn.Module):
    """A stream's weights on its path: ``KernelWeights`` (the kernel path's
    ops) or the plain modules of ``ConvLSTMForecaster.core``."""

    def __init__(self, sf: StreamingForecaster):
        super().__init__()
        self.cdtype = sf._cdtype
        if sf._kernels:
            self.kernels = KernelWeights(sf._weights)
        else:
            self.kernels, self.core = None, sf._core


class _ObserveProgram(_StreamProgram):
    def forward(self, state, frame):
        cells, prev = state
        frames = frame[:, None]
        if self.kernels is not None:
            cells, prev = self.kernels.observe(cells, frames)
        else:
            cells, prev = _plain_observe(self.core, cells, prev, frames,
                                         self.cdtype)
        return (cells, prev), prev.permute(0, 3, 1, 2).to(torch.float32,
                                                            copy=True)


class _ForecastProgram(_StreamProgram):
    def __init__(self, sf: StreamingForecaster, horizon: int):
        super().__init__(sf)
        self.horizon = horizon

    def forward(self, state):
        cells, prev = state
        if self.kernels is not None:
            return self.kernels.rollout_from_state(cells, prev, self.horizon)
        return _plain_forecast(self.core, cells, prev, self.horizon)


class _Int8ForecastProgram(nn.Module):
    def __init__(self, q, horizon: int):
        super().__init__()
        self.weights = Int8Weights(q)
        self.horizon = horizon

    def forward(self, state):
        cells, prev = state
        return rollout_int8_from_state(self.weights.forecaster(), prev,
                                       cells, self.horizon)[0]
