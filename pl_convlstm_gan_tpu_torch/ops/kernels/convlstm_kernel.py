"""K1: the fused ConvLSTM cell step as a hand-written CUDA kernel, and its
custom backward.

Counterpart of the JAX package's ``ops/pallas/convlstm_kernel.py``: the
forward in both its forms (``save_z=False`` for serving, ``save_z=True`` for
training, where the kernel also writes the conv pre-activation ``z``) and the
custom VJP ``convlstm_step_pallas_core`` (``_fwd`` / ``_bwd``). The kernel is
``csrc/convlstm_cell.cu``; its source note says what bounds it and how it is
laid out. Here are its wrapper ``convlstm_cell_fwd``, its plain PyTorch
version ``convlstm_cell_plain``, its launch counts
(``convlstm_cell_fwd.launches`` without ``z``, ``convlstm_cell_fwd.launches_z``
with it) and ``ConvLSTMCellFn``, the training step as a
``torch.autograd.Function``.

On CUDA tensors the wrapper launches the kernel or raises; it takes the plain
version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from ..convlstm import convlstm_gates
from ..nn import conv2d_nhwc_f32, oihw_from_hwio
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 6 + [_P]
_SYMBOLS = {torch.float32: "convlstm_cell_fwd_f32",
            torch.bfloat16: "convlstm_cell_fwd_bf16"}


def convlstm_cell_plain(x, h, c, weight, bias, h_out=None, c_out=None,
                        z_out=None):
    """Plain PyTorch version of K1 with the same arguments and rounding points
    (those of ``ops.convlstm.convlstm_step_torch``): the conv and bias in
    float32, the gates in float32, h' and c' (and z) rounded once to x's
    type. ``weight`` is HWIO [K, K, Cx+Ch, 4Ch]. Writes into
    ``h_out``/``c_out`` when given (``c_out`` may be ``c``) and z into
    ``z_out`` when given; returns (h', c')."""
    z = conv2d_nhwc_f32(torch.cat([x, h], dim=-1), oihw_from_hwio(weight),
                        bias)
    h_new, c_new = convlstm_gates(z, c.float())
    if z_out is not None:
        z_out.copy_(z)
    h_new, c_new = h_new.to(x.dtype), c_new.to(x.dtype)
    if h_out is None:
        return h_new, c_new
    h_out.copy_(h_new)
    c_out.copy_(c_new)
    return h_out, c_out


def _check_args(x, h, c, weight, bias, h_out, c_out, z_out):
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
    if z_out is not None:
        if tuple(z_out.shape) != (b, hgt, wid, 4 * ch):
            raise ValueError(f"z_out must be {(b, hgt, wid, 4 * ch)}, got "
                             f"{tuple(z_out.shape)}")
        if z_out.data_ptr() in {t.data_ptr() for t in tensors}:
            raise ValueError("z_out must not alias another operand")
        tensors += (z_out,)
    if any(t.dtype != x.dtype for t in tensors):
        raise ValueError("cell kernel operands must share one dtype, got "
                         f"{sorted({str(t.dtype) for t in tensors})}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("cell kernel operands must be contiguous")
    if h_out.data_ptr() in (h.data_ptr(), x.data_ptr()):
        raise ValueError("h_out must not alias h or x: neighbours read h's halo")


def convlstm_cell_fwd(x, h, c, weight, bias, h_out=None, c_out=None,
                      z_out=None):
    """One ConvLSTM step. x [B,H,W,Cx], h/c [B,H,W,Ch], weight HWIO
    [K,K,Cx+Ch,4Ch] (odd K), bias [4Ch], all one dtype (float32 or bfloat16).

    Writes h' into ``h_out`` and c' into ``c_out`` (allocated when None;
    ``c_out`` may be ``c`` for an in-place update, ``h_out`` must not alias
    ``h`` or ``x``) and returns (h_out, c_out). With ``z_out``
    [B,H,W,4Ch] (the training form, save_z=True) the kernel also writes the
    pre-activation z there; such launches count in ``launches_z``, the
    others in ``launches``."""
    if (h_out is None) != (c_out is None):
        raise ValueError("pass both h_out and c_out, or neither")
    tensors = (x, h, c, weight, bias)
    if all(t.device.type == "cpu" for t in tensors + (h_out, c_out, z_out)
           if t is not None):
        return convlstm_cell_plain(x, h, c, weight, bias, h_out, c_out, z_out)
    if h_out is None:
        h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    tensors += (h_out, c_out)
    if any(t.device != x.device or t.device.type != "cuda"
           for t in tensors + (z_out,) if t is not None):
        raise ValueError("cell kernel operands must all lie on one CUDA device")
    if x.dtype not in _SYMBOLS:
        raise ValueError(f"cell kernel takes float32 or bfloat16, got {x.dtype}")
    _check_args(x, h, c, weight, bias, h_out, c_out, z_out)
    b, hgt, wid, cx = x.shape
    fn = build.load_function("convlstm_cell", _SYMBOLS[x.dtype], _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors),
                 None if z_out is None else z_out.data_ptr(), b, hgt, wid, cx,
                 h.shape[-1], weight.shape[0], stream)
    build.check(err, "convlstm_cell", "convlstm_cell_fwd launch")
    if z_out is None:
        convlstm_cell_fwd.launches += 1
    else:
        convlstm_cell_fwd.launches_z += 1
    return h_out, c_out


convlstm_cell_fwd.launches = 0
convlstm_cell_fwd.launches_z = 0


class ConvLSTMCellFn(torch.autograd.Function):
    """One training cell step: forward on K1 with ``z`` (save_z=True), the
    hand-written backward of the JAX package's ``convlstm_step_pallas_core``
    (``_fwd`` / ``_bwd``, ``ops/pallas/convlstm_kernel.py:325-388``).

    apply(weight HWIO [K,K,Cx+Ch,4Ch], bias [4Ch], x [B,H,W,Cx], h, c
    [B,H,W,Ch]) -> (h', c'). On CUDA tensors the forward launches K1 (all
    operands one dtype); on CPU tensors it runs K1's plain version, which
    also takes mixed dtypes, and the backward is the same code either way.

    The residuals are those of ``_fwd``: (weight, bias, x, h, c, z, c'). The
    backward recomputes the gates from the stored z in float32 and tanh from
    the stored c', builds dz, and runs both convs in float32 on float32 dz
    and a float32 copy of the weight (cuDNN on the card): the input gradient
    as a SAME conv with the spatially flipped, in/out-swapped kernel, the
    weight gradient as the patch correlation, both by aten's
    ``convolution_backward``. Each gradient is cast to its primal's dtype
    only at the end. The forward allocates fresh h', c' and
    z: c is a residual here, so it is never updated in place."""

    @staticmethod
    def forward(ctx, weight, bias, x, h, c):
        if weight.shape[0] % 2 == 0:
            raise ValueError(f"the cell's custom backward needs an odd kernel "
                             f"size, got {tuple(weight.shape[:2])}")
        b, hgt, wid, _ = x.shape
        z = torch.empty((b, hgt, wid, 4 * h.shape[-1]), dtype=x.dtype,
                        device=x.device)
        h_next, c_next = convlstm_cell_fwd(x, h, c, weight, bias, z_out=z)
        ctx.save_for_backward(weight, bias, x, h, c, z, c_next)
        return h_next, c_next

    @staticmethod
    def backward(ctx, dh_next, dc_next):
        weight, bias, x, h, c, z, c_next = ctx.saved_tensors
        cx = x.shape[-1]
        k = weight.shape[0]

        i, f, o, g = torch.chunk(z.float(), 4, dim=-1)
        i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), \
            torch.tanh(g)
        tc = torch.tanh(c_next.float())
        dh = dh_next.float()
        dc_tot = dc_next.float() + dh * o * (1.0 - tc * tc)
        do = dh * tc
        df = dc_tot * c.float()
        dc_prev = dc_tot * f
        di = dc_tot * g
        dg = dc_tot * i
        dz = torch.cat([di * i * (1 - i), df * f * (1 - f), do * o * (1 - o),
                        dg * (1 - g * g)], dim=-1).permute(0, 3, 1, 2)

        # Both convs in one call of aten's convolution_backward (the op of
        # autograd's conv backward and of torch.nn.grad): cuDNN's dgrad is
        # the SAME conv of dz with the flipped, in/out-swapped kernel and
        # its wgrad the patch correlation of concat(x, h) with dz, the two
        # convs of _bwd. Written as a forward F.conv2d of the flipped
        # kernel, the input gradient of the (64, 64) cells went to an FFT
        # algorithm that cuDNN's heuristics chose, and a nowcast_128 train
        # step took ~14 s on an H100.
        need_dxh = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        need_dw = ctx.needs_input_grad[0]
        xh = torch.cat([x, h], dim=-1).float().permute(0, 3, 1, 2)
        w32 = oihw_from_hwio(weight).float().contiguous()  # [4Ch, Cin, K, K]
        dxh, dw, _ = torch.ops.aten.convolution_backward(
            dz, xh, w32, None, (1, 1), (k // 2, k // 2), (1, 1), False,
            (0, 0), 1, (need_dxh, need_dw, False))
        dx = dh_prev = None
        if need_dxh:
            dxh = dxh.permute(0, 2, 3, 1)
            dx = dxh[..., :cx].to(x.dtype)
            dh_prev = dxh[..., cx:].to(h.dtype)
        if need_dw:
            dw = dw.permute(2, 3, 1, 0).to(weight.dtype)  # OIHW -> HWIO
        db = dz.sum(dim=(0, 2, 3)).to(bias.dtype)
        return dw, db, dx, dh_prev, dc_prev.to(c.dtype)
