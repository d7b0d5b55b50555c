"""K7: the gate passes of PredRNN-V2's spatiotemporal LSTM cell
(``models/predrnn.py``) as hand-written CUDA kernels, with their backward.

The kernel is ``csrc/st_lstm_gates.cu``; its source note gives the
equations, what bounds it and how it is laid out. Two passes a cell and
step, between which cuDNN runs the convs of ``mem`` (NHWC, ``P`` pixels,
``F`` hidden channels):

- pass A (``st_gates``): from conv_x's, conv_h's and conv_m's outputs
  (``x_cat`` [..., 7F] i f g i' f' g' o, ``h_cat`` [..., 4F] i f g o,
  ``m_cat`` [..., 3F] i f g) and the carried ``c`` and ``m``, it writes
  ``mem`` = c' | m', c' and m' again, the decoupling loss's ``delta_c`` and
  ``delta_m``, and ``oxh`` = o_x + o_h in float32;
- pass B (``st_hidden``): h' = sigmoid(oxh + conv_o(mem)) *
  tanh(conv_last(mem)).

Each pass is a ``torch.autograd.Function`` (``STGatesA``, ``STGatesB``)
whose backward is one launch too. ``oxh`` carries the output gate's x and h
terms from pass A to pass B, so that every tensor has one consumer among
the two Functions and autograd adds no gradients of its own; c' and m' are
written apart from ``mem`` for the same reason (``mem`` goes to two convs,
c' to the next step, m' to the next layer). A gradient that autograd leaves
absent (an output nothing read) is zero, and the kernel reads nothing for
it.

On CPU tensors each wrapper runs its plain version (``*_plain``: eager
float32 ops, the kernel's arithmetic in its order), which is also the
kernel's oracle in the card's tests; on CUDA tensors it launches the kernel
or raises. Every launch, forward or backward, counts in
``st_gates.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ...utils import profiling
from . import build

_P = ctypes.c_void_p
_LL, _I = ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {"a_fwd": [_P] * 11 + [_LL, _I, _P],
             "a_bwd": [_P] * 16 + [_LL, _I, _P],
             "b_fwd": [_P] * 4 + [_LL, _I, _P],
             "b_bwd": [_P] * 7 + [_LL, _I, _P]}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

profiling.declare("st_gates.launches")


def _path_plain(xs, xf, xg, ys, yf, yg, prev):
    """One gate path of pass A in float32: (delta, new state)."""
    i = torch.sigmoid(xs + ys)
    f = torch.sigmoid((xf + yf) + 1.0)
    g = torch.tanh(xg + yg)
    d = i * g
    return d, f * prev + d


def st_gates_plain(x_cat, h_cat, m_cat, c, m):
    """Pass A's plain version: (mem, c', m', delta_c, delta_m, oxh), the
    first five in c's dtype, oxh in float32."""
    fw = c.shape[-1]
    xi, xf, xg, xi2, xf2, xg2, xo = x_cat.float().split(fw, dim=-1)
    hi, hf, hg, ho = h_cat.float().split(fw, dim=-1)
    mi, mf, mg = m_cat.float().split(fw, dim=-1)
    dc, cn = _path_plain(xi, xf, xg, hi, hf, hg, c.float())
    dm, mn = _path_plain(xi2, xf2, xg2, mi, mf, mg, m.float())
    dt = c.dtype
    return (torch.cat([cn, mn], dim=-1).to(dt), cn.to(dt), mn.to(dt),
            dc.to(dt), dm.to(dt), xo + ho)


def _path_bwd_plain(xs, xf, xg, ys, yf, yg, prev, g_mem, g_out, g_d):
    """One gate path of pass A's backward in float32: (d_s, d_f, d_g,
    d_prev); absent gradients are zero."""
    i = torch.sigmoid(xs + ys)
    f = torch.sigmoid((xf + yf) + 1.0)
    g = torch.tanh(xg + yg)
    dout = torch.zeros_like(prev)
    for t in (g_mem, g_out):          # left to right, as the kernel adds
        if t is not None:
            dout = dout + t.float()
    dd = dout if g_d is None else g_d.float() + dout
    return (((dd * g) * i) * (1.0 - i), ((dout * prev) * f) * (1.0 - f),
            (dd * i) * (1.0 - g * g), dout * f)


def st_gates_bwd_plain(x_cat, h_cat, m_cat, c, m, g_mem=None, g_cn=None,
                       g_mn=None, g_dc=None, g_dm=None, g_oxh=None):
    """Pass A's backward, plain: (dx_cat [.., 7F], dh_cat [.., 4F], dm_cat
    [.., 3F], dc_prev, dm_prev), all in c's dtype; a gradient given as None
    is zero."""
    fw = c.shape[-1]
    xi, xf, xg, xi2, xf2, xg2, _ = x_cat.float().split(fw, dim=-1)
    hi, hf, hg, _ = h_cat.float().split(fw, dim=-1)
    mi, mf, mg = m_cat.float().split(fw, dim=-1)
    gm_c = gm_m = None
    if g_mem is not None:
        gm_c, gm_m = g_mem.float().split(fw, dim=-1)
    di, df, dg, dc = _path_bwd_plain(xi, xf, xg, hi, hf, hg, c.float(),
                                     gm_c, g_cn, g_dc)
    di2, df2, dg2, dm = _path_bwd_plain(xi2, xf2, xg2, mi, mf, mg, m.float(),
                                        gm_m, g_mn, g_dm)
    do = torch.zeros_like(dc) if g_oxh is None else g_oxh.float()
    dt = c.dtype
    return (torch.cat([di, df, dg, di2, df2, dg2, do], dim=-1).to(dt),
            torch.cat([di, df, dg, do], dim=-1).to(dt),
            torch.cat([di2, df2, dg2], dim=-1).to(dt), dc.to(dt), dm.to(dt))


def st_hidden_plain(oxh, om, last):
    """Pass B's plain version: h' in om's dtype."""
    return (torch.sigmoid(oxh.float() + om.float())
            * torch.tanh(last.float())).to(om.dtype)


def st_hidden_bwd_plain(gh, oxh, om, last):
    """Pass B's backward, plain: (d_oxh float32, d_om, d_last in om's
    dtype)."""
    o = torch.sigmoid(oxh.float() + om.float())
    tl = torch.tanh(last.float())
    gv = gh.float()
    do = ((gv * tl) * o) * (1.0 - o)
    dl = (gv * o) * (1.0 - tl * tl)
    return do, do.to(om.dtype), dl.to(om.dtype)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(what: str, dtype, f32: Sequence = (), **named) -> torch.device:
    """Raise ValueError unless the named tensors (None: absent) hold
    ``dtype`` (those in ``f32``: float32), are contiguous and lie on one
    CUDA device; returns the device."""
    if dtype not in _DTYPES:
        raise ValueError(f"{what} takes float32 or bfloat16, got {dtype}")
    present = {n: t for n, t in named.items() if t is not None}
    for name, t in present.items():
        want = torch.float32 if name in f32 else dtype
        if t.dtype != want:
            raise ValueError(f"{what}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    devices = {t.device for t in present.values()}
    dev = next(iter(devices))
    if len(devices) != 1 or dev.type != "cuda":
        raise ValueError(f"{what}: every operand on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    return dev


def _launch(kind: str, dtype, dev, *args) -> None:
    build.launch("st_lstm_gates", f"st_gates_{kind}_{_DTYPES[dtype]}",
                 _ARGTYPES[kind], dev, *args, what=f"st_gates {kind} launch")
    profiling.count("st_gates.launches")


def _shapes(x_cat, h_cat, m_cat, c, m):
    fw = c.shape[-1]
    lead = tuple(c.shape[:-1])
    for name, t, w in (("x_cat", x_cat, 7 * fw), ("h_cat", h_cat, 4 * fw),
                       ("m_cat", m_cat, 3 * fw), ("m", m, fw)):
        if tuple(t.shape) != lead + (w,):
            raise ValueError(f"{name} must be {lead + (w,)}, got "
                             f"{tuple(t.shape)}")
    return c.numel() // fw, fw


def st_gates_fwd(x_cat, h_cat, m_cat, c, m, deltas: bool = True):
    """Pass A: (mem, c', m', delta_c, delta_m, oxh); without ``deltas``
    (serving) delta_c and delta_m are None. K7 on CUDA tensors, the plain
    version on CPU tensors."""
    n, fw = _shapes(x_cat, h_cat, m_cat, c, m)
    if c.device.type == "cpu":
        out = st_gates_plain(x_cat, h_cat, m_cat, c, m)
        return out if deltas else out[:3] + (None, None, out[5])
    ops = [t.contiguous() for t in (x_cat, h_cat, m_cat, c, m)]
    dev = _check("st_gates", c.dtype, x_cat=ops[0], h_cat=ops[1],
                 m_cat=ops[2], c=ops[3], m=ops[4])
    mem = torch.empty(c.shape[:-1] + (2 * fw,), dtype=c.dtype, device=dev)
    cn, mn = torch.empty_like(ops[3]), torch.empty_like(ops[3])
    dc = torch.empty_like(ops[3]) if deltas else None
    dm = torch.empty_like(ops[3]) if deltas else None
    oxh = torch.empty(c.shape, dtype=torch.float32, device=dev)
    _launch("a_fwd", c.dtype, dev, *(t.data_ptr() for t in ops),
            mem.data_ptr(), cn.data_ptr(), mn.data_ptr(), _ptr(dc), _ptr(dm),
            oxh.data_ptr(), n, fw)
    return mem, cn, mn, dc, dm, oxh


def st_gates_bwd(x_cat, h_cat, m_cat, c, m, g_mem=None, g_cn=None, g_mn=None,
                 g_dc=None, g_dm=None, g_oxh=None, need_c: bool = True,
                 need_m: bool = True):
    """Pass A's backward: (dx_cat, dh_cat, dm_cat, dc_prev, dm_prev), where
    dc_prev / dm_prev are None unless ``need_c`` / ``need_m``. K7 on CUDA
    tensors, the plain version on CPU tensors."""
    n, fw = _shapes(x_cat, h_cat, m_cat, c, m)
    grads = (g_mem, g_cn, g_mn, g_dc, g_dm, g_oxh)
    if c.device.type == "cpu":
        out = st_gates_bwd_plain(x_cat, h_cat, m_cat, c, m, *grads)
        return out[:3] + (out[3] if need_c else None,
                          out[4] if need_m else None)
    grads = [None if g is None else g.contiguous() for g in grads]
    dev = _check("st_gates backward", c.dtype, f32=("g_oxh",), x_cat=x_cat,
                 h_cat=h_cat, m_cat=m_cat, c=c, m=m, g_mem=grads[0],
                 g_cn=grads[1], g_mn=grads[2], g_dc=grads[3], g_dm=grads[4],
                 g_oxh=grads[5])
    dxc, dhc = torch.empty_like(x_cat), torch.empty_like(h_cat)
    dmc = torch.empty_like(m_cat)
    dcp = torch.empty_like(c) if need_c else None
    dmp = torch.empty_like(m) if need_m else None
    _launch("a_bwd", c.dtype, dev, x_cat.data_ptr(), h_cat.data_ptr(),
            m_cat.data_ptr(), c.data_ptr(), m.data_ptr(),
            *(_ptr(g) for g in grads), dxc.data_ptr(), dhc.data_ptr(),
            dmc.data_ptr(), _ptr(dcp), _ptr(dmp), n, fw)
    return dxc, dhc, dmc, dcp, dmp


def st_hidden_fwd(oxh, om, last):
    """Pass B: h' = sigmoid(oxh + om) * tanh(last), in om's dtype. K7 on
    CUDA tensors, the plain version on CPU tensors."""
    if om.device.type == "cpu":
        return st_hidden_plain(oxh, om, last)
    ops = [t.contiguous() for t in (oxh, om, last)]
    dev = _check("st_hidden", om.dtype, f32=("oxh",), oxh=ops[0], om=ops[1],
                 last=ops[2])
    h = torch.empty_like(ops[1])
    _launch("b_fwd", om.dtype, dev, *(t.data_ptr() for t in ops),
            h.data_ptr(), om.numel() // om.shape[-1], om.shape[-1])
    return h


def st_hidden_bwd(gh, oxh, om, last):
    """Pass B's backward: (d_oxh float32, d_om, d_last). K7 on CUDA tensors,
    the plain version on CPU tensors."""
    if om.device.type == "cpu":
        return st_hidden_bwd_plain(gh, oxh, om, last)
    gh = gh.contiguous()
    dev = _check("st_hidden backward", om.dtype, f32=("oxh",), gh=gh,
                 oxh=oxh, om=om, last=last)
    d_oxh = torch.empty_like(oxh)
    d_om, d_last = torch.empty_like(om), torch.empty_like(om)
    _launch("b_bwd", om.dtype, dev, gh.data_ptr(), oxh.data_ptr(),
            om.data_ptr(), last.data_ptr(), d_oxh.data_ptr(),
            d_om.data_ptr(), d_last.data_ptr(), om.numel() // om.shape[-1],
            om.shape[-1])
    return d_oxh, d_om, d_last


class STGatesA(torch.autograd.Function):
    """Pass A with its backward: apply(x_cat, h_cat, m_cat, c, m) -> (mem,
    c', m', delta_c, delta_m, oxh). Saves its five operands; the backward
    recomputes the gates from them."""

    @staticmethod
    def forward(ctx, x_cat, h_cat, m_cat, c, m):
        ctx.set_materialize_grads(False)
        ops = [t.contiguous() for t in (x_cat, h_cat, m_cat, c, m)]
        ctx.save_for_backward(*ops)
        return st_gates_fwd(*ops)

    @staticmethod
    def backward(ctx, g_mem, g_cn, g_mn, g_dc, g_dm, g_oxh):
        return st_gates_bwd(*ctx.saved_tensors, g_mem, g_cn, g_mn, g_dc,
                            g_dm, g_oxh, need_c=ctx.needs_input_grad[3],
                            need_m=ctx.needs_input_grad[4])


class STGatesB(torch.autograd.Function):
    """Pass B with its backward: apply(oxh, om, last) -> h'."""

    @staticmethod
    def forward(ctx, oxh, om, last):
        ops = [t.contiguous() for t in (oxh, om, last)]
        ctx.save_for_backward(*ops)
        return st_hidden_fwd(*ops)

    @staticmethod
    def backward(ctx, gh):
        return st_hidden_bwd(gh, *ctx.saved_tensors)


def _grad_on(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def st_gates(x_cat, h_cat, m_cat, c, m, deltas: bool = True):
    """Pass A of one cell-step: (mem, c', m', delta_c, delta_m, oxh), through
    ``STGatesA`` where gradients are wanted, else one forward launch (the
    deltas None unless ``deltas``). ``st_gates.launches`` counts every K7
    launch, pass A and B, forward and backward."""
    if _grad_on(x_cat, h_cat, m_cat, c, m):
        return STGatesA.apply(x_cat, h_cat, m_cat, c, m)
    return st_gates_fwd(x_cat, h_cat, m_cat, c, m, deltas=deltas)


def st_hidden(oxh, om, last):
    """Pass B of one cell-step: h', through ``STGatesB`` where gradients are
    wanted."""
    if _grad_on(oxh, om, last):
        return STGatesB.apply(oxh, om, last)
    return st_hidden_fwd(oxh, om, last)
