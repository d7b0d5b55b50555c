"""K1: the fused ConvLSTM cell step as a hand-written CUDA kernel.

Counterpart of the JAX package's ``ops/pallas/convlstm_kernel.py`` (forward,
``save_z=False``). The kernel is ``csrc/convlstm_cell.cu``; its source note
says what bounds it and how it is laid out. Here are its wrapper
``convlstm_cell_fwd``, its plain PyTorch version ``convlstm_cell_plain`` and
its launch count ``convlstm_cell_fwd.launches``.

On CUDA tensors the wrapper launches the kernel or raises; it takes the plain
version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from ..convlstm import convlstm_step_torch
from ..nn import oihw_from_hwio
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 6 + [_P]
_SYMBOLS = {torch.float32: "convlstm_cell_fwd_f32",
            torch.bfloat16: "convlstm_cell_fwd_bf16"}


def convlstm_cell_plain(x, h, c, weight, bias, h_out=None, c_out=None):
    """Plain PyTorch version of K1 with the same arguments and rounding points
    (``ops.convlstm.convlstm_step_torch``). ``weight`` is HWIO
    [K, K, Cx+Ch, 4Ch]. Writes into ``h_out``/``c_out`` when given (``c_out``
    may be ``c``) and returns (h', c')."""
    h_new, c_new = convlstm_step_torch(x, h, c, oihw_from_hwio(weight), bias)
    if h_out is None:
        return h_new, c_new
    h_out.copy_(h_new)
    c_out.copy_(c_new)
    return h_out, c_out


def _check_args(x, h, c, weight, bias, h_out, c_out):
    b, hgt, wid, cx = x.shape
    ch = h.shape[-1]
    k = weight.shape[0]
    if k % 2 == 0 or weight.shape != (k, k, cx + ch, 4 * ch):
        raise ValueError(f"cell kernel needs an odd-sized HWIO weight "
                         f"[K, K, {cx + ch}, {4 * ch}], got {tuple(weight.shape)}")
    if bias.shape != (4 * ch,):
        raise ValueError(f"bias must be [{4 * ch}], got {tuple(bias.shape)}")
    for name, t, shape in (("h", h, (b, hgt, wid, ch)), ("c", c, (b, hgt, wid, ch)),
                           ("h_out", h_out, (b, hgt, wid, ch)),
                           ("c_out", c_out, (b, hgt, wid, ch))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    tensors = (x, h, c, weight, bias, h_out, c_out)
    if any(t.dtype != x.dtype for t in tensors):
        raise ValueError("cell kernel operands must share one dtype, got "
                         f"{sorted({str(t.dtype) for t in tensors})}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("cell kernel operands must be contiguous")
    if h_out.data_ptr() in (h.data_ptr(), x.data_ptr()):
        raise ValueError("h_out must not alias h or x: neighbours read h's halo")


def convlstm_cell_fwd(x, h, c, weight, bias, h_out=None, c_out=None):
    """One ConvLSTM step. x [B,H,W,Cx], h/c [B,H,W,Ch], weight HWIO
    [K,K,Cx+Ch,4Ch] (odd K), bias [4Ch], all one dtype (float32 or bfloat16).

    Writes h' into ``h_out`` and c' into ``c_out`` (allocated when None;
    ``c_out`` may be ``c`` for an in-place update, ``h_out`` must not alias
    ``h`` or ``x``) and returns (h_out, c_out)."""
    if (h_out is None) != (c_out is None):
        raise ValueError("pass both h_out and c_out, or neither")
    tensors = (x, h, c, weight, bias)
    if all(t.device.type == "cpu" for t in tensors + (h_out, c_out)
           if t is not None):
        return convlstm_cell_plain(x, h, c, weight, bias, h_out, c_out)
    if h_out is None:
        h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    tensors += (h_out, c_out)
    if any(t.device != x.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("cell kernel operands must all lie on one CUDA device")
    if x.dtype not in _SYMBOLS:
        raise ValueError(f"cell kernel takes float32 or bfloat16, got {x.dtype}")
    _check_args(x, h, c, weight, bias, h_out, c_out)
    b, hgt, wid, cx = x.shape
    fn = build.load_function("convlstm_cell", _SYMBOLS[x.dtype], _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), b, hgt, wid, cx,
                 h.shape[-1], weight.shape[0], stream)
    build.check(err, "convlstm_cell", "convlstm_cell_fwd launch")
    convlstm_cell_fwd.launches += 1
    return h_out, c_out


convlstm_cell_fwd.launches = 0
