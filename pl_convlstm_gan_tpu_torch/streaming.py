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

``model.rollout_impl`` picks the path of both ``observe`` and ``forecast``:
'kernel' (or 'auto' on a GPU) runs K1 and K2 (``ops/kernels``), one step per
frame or per forecast frame; 'torch' runs the plain modules of
``ConvLSTMForecaster``. On CPU tensors the kernel wrappers run their plain
versions. Every method returns new tensors and writes none of its inputs, so
a caller may hold several branches of one stream.

Not ported here: the JAX package's int8 forecast (the port's config rejects
``rollout_impl: int8``), its ``export_*`` hooks (the export slice), and
``pallas_forecast_fits``: K1 and K2 take any odd kernel size and any widths,
so the kernel path refuses only what ``pack_weights`` refuses.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .config import Config
from .ops.kernels.rollout_kernel import (observe_kernel, pack_weights,
                                         rollout_kernel_from_state)
from .predict import (ROLLOUT_IMPLS, build_model, compute_dtype,
                      load_state_dict, resolve_device)


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
        if mc.rollout_impl not in ROLLOUT_IMPLS:
            raise ValueError(f"Unknown rollout_impl: {mc.rollout_impl!r} "
                             f"(valid: {', '.join(ROLLOUT_IMPLS)})")
        self.device = resolve_device(device)
        self._hidden = tuple(mc.hidden_dims)
        self._channels = mc.in_channels
        self._cdtype = compute_dtype(config)
        model = build_model(config)
        model.load_state_dict(state_dict)
        model.to(self.device).eval()
        self._core = model.core
        self._kernels = (mc.rollout_impl == "kernel" or
                         (mc.rollout_impl == "auto"
                          and self.device.type == "cuda"))
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

    def _plain_step(self, cells, x):
        """One step of the plain modules: x [B,H,W,C] -> (cells, head out)."""
        if len(cells) != len(self._hidden):
            raise ValueError(f"{len(cells)} state pairs for "
                             f"{len(self._hidden)} cells")
        new = []
        for cell, (h, c) in zip(self._core.cells(), cells):
            h, c = cell(x, h, c)
            new.append((h, c))
            x = h
        return tuple(new), self._core.head(x)

    def observe_window(self, state: StreamState, frames
                       ) -> Tuple[StreamState, torch.Tensor]:
        """Assimilate ``frames [B, T, C, H, W]`` (numpy or tensor); returns
        ``(new_state, nowcast [B, C, H, W] float32)``: the 1-step-ahead
        prediction from the last frame (the batch rollout's first frame)."""
        frames = torch.as_tensor(np.asarray(frames) if not isinstance(
            frames, torch.Tensor) else frames).to(self.device, torch.float32)
        if frames.ndim != 5 or frames.shape[1] < 1:
            raise ValueError(f"frames must be [B, T >= 1, C, H, W], got "
                             f"{tuple(frames.shape)}")
        with torch.inference_mode():
            if self._kernels:
                cells, prev = observe_kernel(self._weights, state.cells,
                                             frames, self._cdtype)
            else:
                cells, prev = state.cells, state.prev_out
                for t in range(frames.shape[1]):
                    cells, prev = self._plain_step(
                        cells, frames[:, t].permute(0, 2, 3, 1).to(self._cdtype))
            nowcast = prev.permute(0, 3, 1, 2).to(torch.float32, copy=True)
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
        branch). On the kernel path: horizon x n_cells K1 launches and
        horizon K2 launches."""
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        with torch.inference_mode():
            if self._kernels:
                return rollout_kernel_from_state(
                    self._weights, state.cells, state.prev_out, horizon,
                    self._cdtype)
            cells, prev, outs = state.cells, state.prev_out, []
            for _ in range(horizon):
                cells, prev = self._plain_step(cells, prev)
                outs.append(prev)
            return torch.stack(outs).permute(1, 0, 4, 2, 3).float()
