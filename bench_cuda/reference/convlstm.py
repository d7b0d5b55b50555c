"""Plain PyTorch reference of the ConvLSTM forecaster, written from the
architecture alone (Shi et al. 2015, arXiv:1506.04214; gate order i|f|o|g,
one conv over concat(x, h) per cell, a 3x3 conv head), in float32.

Parameters are a dict of float32 tensors named as the benchmark names them
(``core.cell_<i>.weight`` OIHW [4F, Cin + F, K, K], ``core.cell_<i>.bias``,
``core.head.weight``, ``core.head.bias``). Activations are NHWC.

``rounding(prec)`` makes the reference compute in a lower precision than
float32, for the control that a check has to fail: every conv's operands
and every stored state are rounded to bfloat16, or to fp8 (e4m3 with a
per-tensor scale, the backward's gradients in e5m2), with the gradient
passed straight through the rounding.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Round = Callable[[torch.Tensor], torch.Tensor]
_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2,
                                                        57344.0)}


def _round_to(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    dtype, top = _FP8[prec]
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round_to(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round_to(g, ctx.bwd), None, None


def rounding(prec: str) -> Round:
    """The rounding applied to conv operands and stored states: "f32" (none),
    "bf16", or "fp8"."""
    if prec == "f32":
        return lambda x: x
    fwd, bwd = ("bf16", "bf16") if prec == "bf16" else ("e4m3", "e5m2")
    return lambda x: _Rounded.apply(x, fwd, bwd)


def conv(x: torch.Tensor, w: torch.Tensor, b, q: Round,
         padding="same") -> torch.Tensor:
    """NHWC conv with an OIHW kernel; float32 result."""
    out = F.conv2d(q(x).permute(0, 3, 1, 2), q(w),
                   None if b is None else q(b), padding=padding)
    return out.permute(0, 2, 3, 1)


def cell(x, h, c, w, b, q: Round) -> Tuple[torch.Tensor, torch.Tensor]:
    z = conv(torch.cat([x, h], dim=-1), w, b, q)
    zi, zf, zo, zg = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
    h_new = torch.sigmoid(zo) * torch.tanh(c_new)
    return q(h_new), q(c_new)


def forecaster_param_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the forecaster's parameters."""
    k, cx = model.get("kernel_size", 3), model["in_channels"]
    shapes = {}
    for i, f in enumerate(model["hidden_dims"]):
        shapes[f"core.cell_{i}.weight"] = (4 * f, cx + f, k, k)
        shapes[f"core.cell_{i}.bias"] = (4 * f,)
        cx = f
    shapes["core.head.weight"] = (model["in_channels"], cx, 3, 3)
    shapes["core.head.bias"] = (model["in_channels"],)
    return shapes


State = List[Tuple[torch.Tensor, torch.Tensor]]


def zero_state(model: dict, b: int, hgt: int, wid: int, device) -> State:
    return [(torch.zeros(b, hgt, wid, f, device=device),
             torch.zeros(b, hgt, wid, f, device=device))
            for f in model["hidden_dims"]]


def step(params, n_cells: int, state: State, x: torch.Tensor, q: Round
         ) -> Tuple[State, torch.Tensor]:
    """One step of the stack on x [B, H, W, C], then the head: (new state,
    head output [B, H, W, C])."""
    new = []
    for i in range(n_cells):
        h, c = cell(x, *state[i], params[f"core.cell_{i}.weight"],
                    params[f"core.cell_{i}.bias"], q)
        new.append((h, c))
        x = h
    out = conv(x, params["core.head.weight"], params["core.head.bias"], q)
    return new, q(out)


def forecaster_forward(params, model: dict, frames: torch.Tensor,
                       q: Round) -> torch.Tensor:
    """frames [B, T_in, C, H, W] -> predictions [B, T_out, C, H, W]: encode
    T_in frames, then feed each prediction back for T_out - 1 steps."""
    b, t_in, _, hgt, wid = frames.shape
    n = len(model["hidden_dims"])
    state = zero_state(model, b, hgt, wid, frames.device)
    preds: List[torch.Tensor] = []
    x = None
    for s in range(t_in + model["output_frames"] - 1):
        x = frames[:, s].permute(0, 2, 3, 1) if s < t_in else x
        state, out = step(params, n, state, x, q)
        if s >= t_in - 1:
            preds.append(out)
            x = out
    return torch.stack(preds, dim=1).permute(0, 1, 4, 2, 3)


def stream_observe(params, model: dict, state: State, frame: torch.Tensor,
                   q: Round) -> Tuple[State, torch.Tensor]:
    """Fold one frame [B, C, H, W] into the state; (state, nowcast NHWC)."""
    return step(params, len(model["hidden_dims"]), state,
                frame.permute(0, 2, 3, 1), q)


def stream_forecast(params, model: dict, state: State, prev: torch.Tensor,
                    horizon: int, q: Round) -> torch.Tensor:
    """``horizon`` free-running steps from (state, prev NHWC) -> [B,
    horizon, C, H, W]; the state is not changed."""
    outs = []
    n = len(model["hidden_dims"])
    for _ in range(horizon):
        state, prev = step(params, n, state, prev, q)
        outs.append(prev)
    return torch.stack(outs, dim=1).permute(0, 1, 4, 2, 3)


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def init_params(shapes: Dict[str, Sequence[int]], uniform: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """Parameters from one flat draw of U[0, 1): each leaf scaled to
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), PyTorch's conv default, where the
    bias takes its weight's fan-in."""
    params, at, fan = {}, 0, 1
    for name, shape in shapes.items():
        n = 1
        for d in shape:
            n *= d
        if name.endswith(".weight"):
            fan = n // shape[0]
        bound = fan ** -0.5
        params[name] = ((uniform[at:at + n] * 2 - 1) * bound).reshape(shape)
        at += n
    return params


def numel(shapes: Dict[str, Sequence[int]]) -> int:
    total = 0
    for shape in shapes.values():
        n = 1
        for d in shape:
            n *= d
        total += n
    return total
