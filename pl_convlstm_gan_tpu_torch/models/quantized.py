"""int8 post-training-quantized serving rollout for the forecaster families.

Counterpart of the JAX package's ``models/quantized.py``
(``rollout_impl: int8``). No calibration data: every conv input is quantized
with a per-step, per-sample dynamic scale (``ops.quant.dynamic_scale``), so
a sample's result does not depend on its batchmates and a data-parallel
split equals one process bit for bit.

- The first cell is split by linearity, ``conv(x ++ h) == conv_x(x) +
  conv_h(h)``: the frame (unbounded: observations, then the model's own
  outputs) and the hidden state carry scales of their own. The x-side conv
  has no bias; the h-side conv carries the cell's.
- The cells above it run one fused conv over ``concat(h_below, h_own)``.
- The head is one int8 conv.
- Weights are int8 per output channel; each conv accumulates exactly in
  int32 (``ops.quant.conv2d_int8``) and is dequantized in float32.
- The gates run in float32 (``ops.convlstm.convlstm_gates``), and the
  carried h and c stay float32: quantization error does not accumulate in
  the recurrent state. States from a bfloat16 stream are cast to float32
  on entry.

The phase scheduling is ``ConvLSTMForecaster``'s: encode ``T_in`` frames,
then decode autoregressively, one loop of ``T_in + T_out - 1`` steps.
``Int8Weights`` holds the quantized tensors as buffers, for programs that
``torch.export`` traces (``serve.py``).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import torch
from torch import nn

from ..ops.convlstm import convlstm_gates
from ..ops.quant import (UNIT_SCALE, QuantConv, apply_quant_conv,
                         dynamic_scale, quantize_conv)


class Int8Cell0(NamedTuple):
    """First cell, linearity-split: x-side conv (frame input, no bias) and
    h-side conv (carries the cell bias)."""
    conv_x: QuantConv
    conv_h: QuantConv


class Int8Forecaster(NamedTuple):
    """Quantized forecaster weights: the split first cell, the fused cells
    above it (one conv over concat(h_below, h_own) each) and the head."""
    cell0: Int8Cell0
    cells: Tuple[QuantConv, ...]
    head: QuantConv


def prepare_int8_forecaster(weights) -> Int8Forecaster:
    """Quantize a forecaster (or a GAN's generator) for int8 serving.

    ``weights``: a ``ConvLSTMForecaster`` or its ``state_dict``
    (``core.cell_<i>.weight`` OIHW, ``core.cell_<i>.bias``, ``core.head``).
    The quantized tensors lie on the weights' device. One-time cost at
    load."""
    sd = weights.state_dict() if isinstance(weights, nn.Module) else weights
    if not isinstance(sd, Mapping):
        raise TypeError("expected a ConvLSTMForecaster or its state_dict")
    n = sum(1 for k in sd if k.startswith("core.cell_")
            and k.endswith(".weight"))
    if n < 1:
        raise ValueError("not a forecaster state_dict (no core.cell_<i> "
                         "entries)")
    w0, b0 = sd["core.cell_0.weight"], sd["core.cell_0.bias"]
    ch = w0.shape[0] // 4
    cin_x = w0.shape[1] - ch
    cell0 = Int8Cell0(
        conv_x=quantize_conv(w0[:, :cin_x], None, act_scale=None),
        conv_h=quantize_conv(w0[:, cin_x:], b0))
    cells = tuple(quantize_conv(sd[f"core.cell_{i}.weight"],
                                sd[f"core.cell_{i}.bias"])
                  for i in range(1, n))
    head = quantize_conv(sd["core.head.weight"], sd["core.head.bias"])
    return Int8Forecaster(cell0, cells, head)


def _int8_step(q: Int8Forecaster, states, x):
    """One quantized stacked-cell step: x [B,H,W,C] float32 -> (new_states,
    out [B,H,W,C] float32). Every conv input takes its per-sample dynamic
    scale."""
    h0, c0 = states[0]
    zx = apply_quant_conv(q.cell0.conv_x, x, act_scale=dynamic_scale(x))
    zh = apply_quant_conv(q.cell0.conv_h, h0,      # carries the bias
                          act_scale=dynamic_scale(h0))
    h, c = convlstm_gates(zx + zh, c0)
    new_states = [(h, c)]
    for li, qc in enumerate(q.cells):
        hi, ci = states[li + 1]
        xc = torch.cat([h, hi], dim=-1)
        z = apply_quant_conv(qc, xc, act_scale=dynamic_scale(xc))
        hi, ci = convlstm_gates(z, ci)
        new_states.append((hi, ci))
        h = hi
    out = apply_quant_conv(q.head, h, act_scale=dynamic_scale(h))
    return tuple(new_states), out


def _zero_states(q: Int8Forecaster, b: int, hgt: int, wid: int, device):
    widths = [q.cell0.conv_h.wq.shape[1]]
    widths += [qc.wq.shape[0] // 4 for qc in q.cells]
    zeros = lambda f: torch.zeros((b, hgt, wid, f), dtype=torch.float32,
                                  device=device)
    return tuple((zeros(f), zeros(f)) for f in widths)


def rollout_int8(q: Int8Forecaster, frames: torch.Tensor, t_out: int):
    """frames [B, T_in, C, H, W] -> predictions [B, t_out, C, H, W] float32:
    encode the observed window, then decode ``t_out`` steps
    autoregressively."""
    b, t_in, c, hgt, wid = frames.shape
    x_seq = frames.permute(1, 0, 3, 4, 2).float()
    states = _zero_states(q, b, hgt, wid, frames.device)
    prev = None
    outs = []
    for t in range(t_in + t_out - 1):
        x = x_seq[t] if t < t_in else prev
        states, prev = _int8_step(q, states, x)
        if t >= t_in - 1:
            outs.append(prev)
    return torch.stack(outs, dim=1).permute(0, 1, 4, 2, 3)


def rollout_int8_from_state(q: Int8Forecaster, prev_out, states,
                            horizon: int):
    """Warm-start decode for streaming serving: ``horizon`` steps from the
    carried state. prev_out [B,H,W,C], states ((h, c), ...) NHWC, any float
    dtype (cast to float32). Returns (predictions [B, horizon, C, H, W]
    float32, prev_out', states'); the inputs are not written."""
    states = tuple((h.float(), c.float()) for h, c in states)
    prev = prev_out.float()
    outs = []
    for _ in range(horizon):
        states, prev = _int8_step(q, states, prev)
        outs.append(prev)
    return (torch.stack(outs, dim=1).permute(0, 1, 4, 2, 3), prev,
            states)


class Int8Weights(nn.Module):
    """An ``Int8Forecaster`` as buffers (``cell0_x_*``, ``cell0_h_*``,
    ``cell_<i>_*``, ``head_*``: ``wq``, ``wscale``, ``bias``), so that an
    exported program carries the int8 kernels and their scales."""

    def __init__(self, q: Int8Forecaster):
        super().__init__()
        self.n_cells = 1 + len(q.cells)
        layers = {"cell0_x": q.cell0.conv_x, "cell0_h": q.cell0.conv_h,
                  "head": q.head}
        layers.update({f"cell_{i + 1}": qc for i, qc in enumerate(q.cells)})
        for name, qc in layers.items():
            self.register_buffer(f"{name}_wq", qc.wq)
            self.register_buffer(f"{name}_wscale", qc.wscale)
            if qc.bias is not None:
                self.register_buffer(f"{name}_bias", qc.bias)

    def _layer(self, name: str, act_scale) -> QuantConv:
        return QuantConv(getattr(self, f"{name}_wq"),
                         getattr(self, f"{name}_wscale"),
                         getattr(self, f"{name}_bias", None), act_scale)

    def forecaster(self) -> Int8Forecaster:
        return Int8Forecaster(
            Int8Cell0(self._layer("cell0_x", None),
                      self._layer("cell0_h", UNIT_SCALE)),
            tuple(self._layer(f"cell_{i}", UNIT_SCALE)
                  for i in range(1, self.n_cells)),
            self._layer("head", UNIT_SCALE))
