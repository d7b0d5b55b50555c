"""Free-running forecaster rollout on the hand-written CUDA kernels.

Counterpart of the JAX package's ``ops/pallas/rollout_kernel.py``. The TPU
kernel there runs the whole rollout in one launch per batch item, with about
9 MB of recurrent state resident in VMEM. A Hopper SM has 227 KB of shared
memory, so that design does not carry over. Here the rollout is a host loop
that launches, per step, K1 (``csrc/convlstm_cell.cu``) once per cell and,
once predictions start, K2 (``csrc/conv_head.cu``) for the head; the state
stays in device memory (and mostly in the 50 MB L2) between launches.

At nowcast_128 (3 cells, 5 frames in, 20 out) a request is 72 K1 and 20 K2
launches. Capturing the loop in a CUDA graph, or one persistent kernel,
would remove the per-launch host cost; that is left to a later change.

This module holds:
- K2's wrapper ``conv_head_fwd``, its plain version ``conv_head_plain`` and
  its launch count ``conv_head_fwd.launches``;
- ``pack_weights``: the model's state_dict -> the kernels' HWIO layout;
- ``rollout_kernel`` (the counterpart of ``rollout_pallas``) and
  ``rollout_plain``: the same loop through the wrappers or the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..nn import conv2d_nhwc_f32, hwio_from_oihw, oihw_from_hwio
from . import build
from .convlstm_kernel import convlstm_cell_fwd, convlstm_cell_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_P]
_SYMBOLS = {torch.float32: "conv_head_fwd_f32",
            torch.bfloat16: "conv_head_fwd_bf16"}


def conv_head_plain(h, weight, bias, out=None):
    """Plain PyTorch version of K2: SAME conv of h [B,H,W,Cin] with the HWIO
    ``weight`` [K,K,Cin,Cout] and ``bias``, float32 accumulation, result in
    h's dtype. Writes into ``out`` when given and returns it."""
    res = conv2d_nhwc_f32(h, oihw_from_hwio(weight), bias).to(h.dtype)
    if out is None:
        return res
    return out.copy_(res)


def conv_head_fwd(h, weight, bias, out=None):
    """The head conv. h [B,H,W,Cin], weight HWIO [K,K,Cin,Cout] (odd K), bias
    [Cout], one dtype (float32 or bfloat16). Writes [B,H,W,Cout] into ``out``
    (allocated when None; it must not alias ``h``) and returns it."""
    if all(t.device.type == "cpu" for t in (h, weight, bias, out)
           if t is not None):
        return conv_head_plain(h, weight, bias, out)
    b, hgt, wid, cin = h.shape
    k, cout = weight.shape[0], weight.shape[-1]
    if out is None:
        out = torch.empty((b, hgt, wid, cout), dtype=h.dtype, device=h.device)
    tensors = (h, weight, bias, out)
    if any(t.device != h.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("head kernel operands must all lie on one CUDA device")
    if h.dtype not in _SYMBOLS or any(t.dtype != h.dtype for t in tensors):
        raise ValueError("head kernel operands must all be float32 or all "
                         "bfloat16")
    if k % 2 == 0 or weight.shape != (k, k, cin, cout):
        raise ValueError(f"head kernel needs an odd-sized HWIO weight "
                         f"[K, K, {cin}, Cout], got {tuple(weight.shape)}")
    if bias.shape != (cout,) or out.shape != (b, hgt, wid, cout):
        raise ValueError(f"bias must be [{cout}] and out {(b, hgt, wid, cout)}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("head kernel operands must be contiguous")
    if out.data_ptr() == h.data_ptr():
        raise ValueError("out must not alias h")
    fn = build.load_function("conv_head", _SYMBOLS[h.dtype], _ARGTYPES)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), b, hgt, wid, cin, cout, k,
                 stream)
    build.check(err, "conv_head", "conv_head_fwd launch")
    conv_head_fwd.launches += 1
    return out


conv_head_fwd.launches = 0


class RolloutWeights(NamedTuple):
    """Forecaster weights in the kernels' layout and the compute dtype:
    ``cells`` = ((HWIO [K,K,Cin,4Ch], bias [4Ch]), ...) bottom-up, ``head`` =
    (HWIO [3,3,Ch_top,C], bias [C])."""
    cells: tuple
    head: tuple


def pack_weights(state_dict, compute_dtype=torch.bfloat16) -> RolloutWeights:
    """A ConvLSTMForecaster state_dict (``core.cell_<i>.weight`` OIHW, ...)
    -> RolloutWeights. Weights AND biases are cast to the compute dtype, as
    the TPU kernel's ``_pack_weights`` does. Raises on what K1 and K2 do not
    take (an even kernel size)."""
    n = sum(1 for k in state_dict if k.startswith("core.cell_")
            and k.endswith(".weight"))
    if n == 0:
        raise ValueError("state_dict holds no core.cell_<i>.weight entries")

    def conv(prefix):
        w = state_dict[f"{prefix}.weight"]
        if w.shape[-1] % 2 == 0 or w.shape[-1] != w.shape[-2]:
            raise ValueError(f"the CUDA kernels need square odd-sized conv "
                             f"kernels, {prefix} has {tuple(w.shape[-2:])}")
        return (hwio_from_oihw(w).to(compute_dtype).contiguous(),
                state_dict[f"{prefix}.bias"].to(compute_dtype).contiguous())

    return RolloutWeights(tuple(conv(f"core.cell_{i}") for i in range(n)),
                          conv("core.head"))


def _rollout(weights: RolloutWeights, frames, t_out: int, compute_dtype,
             cell_fn, head_fn):
    """The per-step loop shared by the kernel and plain rollouts.

    frames [B,T_in,C,H,W] -> [B,t_out,C,H,W] float32. Step t feeds
    x = frames[t] while t < T_in, else the previous prediction out[t - T_in];
    each cell reads its h from one ping-pong buffer and writes the other
    (neighbours read the halo), and updates its c in place."""
    b, t_in, c, hgt, wid = frames.shape
    if t_in < 1 or t_out < 1:
        raise ValueError(f"need t_in >= 1 and t_out >= 1, got {t_in}, {t_out}")
    w1 = weights.cells[0][0]
    if w1.shape[2] - w1.shape[3] // 4 != c:
        raise ValueError(f"frames have {c} channels, the first cell takes "
                         f"{w1.shape[2] - w1.shape[3] // 4}")
    dev = frames.device
    fr = frames.permute(1, 0, 3, 4, 2).to(compute_dtype).contiguous()
    out = torch.empty((t_out, b, hgt, wid, c), dtype=compute_dtype, device=dev)
    hs, cs = [], []
    for w, _ in weights.cells:
        ch = w.shape[-1] // 4
        hs.append(torch.zeros((2, b, hgt, wid, ch), dtype=compute_dtype,
                              device=dev))
        cs.append(torch.zeros((b, hgt, wid, ch), dtype=compute_dtype,
                              device=dev))
    for t in range(t_in + t_out - 1):
        cur, nxt = t % 2, 1 - t % 2
        x = fr[t] if t < t_in else out[t - t_in]
        for k, (w, bias) in enumerate(weights.cells):
            cell_fn(x, hs[k][cur], cs[k], w, bias, hs[k][nxt], cs[k])
            x = hs[k][nxt]
        if t >= t_in - 1:
            head_fn(x, weights.head[0], weights.head[1], out[t - (t_in - 1)])
    return out.permute(1, 0, 4, 2, 3).float()


def rollout_kernel(weights: RolloutWeights, frames, t_out: int,
                   compute_dtype=torch.bfloat16):
    """Free-running rollout through K1 and K2: frames [B,T_in,C,H,W] ->
    [B,t_out,C,H,W] float32, the contract of the JAX ``rollout_pallas``.
    ``weights`` come from ``pack_weights`` in the same ``compute_dtype``."""
    return _rollout(weights, frames, t_out, compute_dtype, convlstm_cell_fwd,
                    conv_head_fwd)


def rollout_plain(weights: RolloutWeights, frames, t_out: int,
                  compute_dtype=torch.bfloat16):
    """The same loop as ``rollout_kernel`` through the plain versions."""
    return _rollout(weights, frames, t_out, compute_dtype, convlstm_cell_plain,
                    conv_head_plain)
