"""K8: TrajGRU's learned-flow warp of the hidden state
(``models/trajgru.py``) as a hand-written CUDA kernel, with its backward.

The kernel is ``csrc/traj_warp.cu``; its source note gives the equations,
what bounds it and how it is laid out. For a hidden state h [B, H, W, C]
and flows [B, H, W, 2L] ((u_l, v_l) at channels 2l and 2l + 1) it writes
the stack S [B, H, W, L C], link-major: S[..., l C + c] samples h
bilinearly at (x + u_l, y + v_l), a tap outside the frame reading 0
(``F.grid_sample`` with ``align_corners=True`` and zero padding, at pixel
coordinates). The 1x1 link conv reads S as it is.

``traj_warp`` is the entry of the model: on CUDA tensors ``TrajWarp``, one
K8 launch forward and one backward (the backward adds dh and the flows'
gradient, a reduction over channels, into float32 buffers the wrapper
zeroes, with atomics, and the wrapper casts each to its operand's dtype
once); on CPU tensors the plain version ``traj_warp_plain``, a
pure-torch gather with the same semantics and the same float32 operations
in the same order, through which autograd differentiates. Every launch,
forward or backward, counts in ``traj_warp.launches``. The kernel
allocates nothing: the wrapper's outputs come from the caching allocator,
so a CUDA graph's capture needs nothing reserved for it.
"""
from __future__ import annotations

import ctypes

import torch

from ...utils import profiling
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {"fwd": [_P] * 3 + [_I] * 5 + [_P],
             "bwd": [_P] * 5 + [_I] * 5 + [_P]}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

profiling.declare("traj_warp.launches")


def _shapes(h: torch.Tensor, flows: torch.Tensor):
    """(B, H, W, C, L) of h [B, H, W, C] and flows [B, H, W, 2L]; raises
    ValueError on anything else."""
    if h.dim() != 4 or flows.dim() != 4 or tuple(flows.shape[:3]) != tuple(
            h.shape[:3]) or flows.shape[3] % 2 or not flows.shape[3]:
        raise ValueError(f"traj_warp takes h [B, H, W, C] and flows [B, H, "
                         f"W, 2L], got {tuple(h.shape)} and "
                         f"{tuple(flows.shape)}")
    return (*h.shape, flows.shape[3] // 2)


def _taps(h: torch.Tensor, flows: torch.Tensor):
    """The four taps of every (pixel, link) pair: [(weight [B, H, W, L],
    values [B, H, W, L, C])] for 00, 10, 01, 11, in the accumulation dtype,
    a tap outside the frame reading 0."""
    b, hgt, wid, c, links = _shapes(h, flows)
    acc = torch.promote_types(h.dtype, torch.float32)
    f = flows.to(acc).reshape(b, hgt, wid, links, 2)
    xs = torch.arange(wid, dtype=acc, device=h.device).view(1, 1, wid, 1)
    ys = torch.arange(hgt, dtype=acc, device=h.device).view(1, hgt, 1, 1)
    sx, sy = xs + f[..., 0], ys + f[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    x1, y1 = x0 + 1.0, y0 + 1.0
    fx, fy = sx - x0, sy - y0
    gx, gy = 1.0 - fx, 1.0 - fy
    rows = h.to(acc).reshape(b, hgt * wid, c)
    batch = torch.arange(b, device=h.device).view(b, 1, 1, 1)
    out = []
    for w, xi, yi in ((gx * gy, x0, y0), (fx * gy, x1, y0),
                      (gx * fy, x0, y1), (fx * fy, x1, y1)):
        inside = (xi >= 0) & (xi <= wid - 1) & (yi >= 0) & (yi <= hgt - 1)
        idx = torch.where(inside, yi * wid + xi, 0).long()
        vals = rows[batch, idx]
        out.append((w, torch.where(inside[..., None], vals,
                                   vals.new_zeros(()))))
    return out


def traj_warp_plain(h: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """K8's plain version: S [B, H, W, L C] in h's dtype, accumulated in
    float32 (float64 for a float64 h) in the kernel's order, rounded once.
    Differentiable by autograd in h and the flows."""
    b, hgt, wid, c, links = _shapes(h, flows)
    (w00, t00), (w10, t10), (w01, t01), (w11, t11) = _taps(h, flows)
    s = w00[..., None] * t00 + w10[..., None] * t10
    s = s + w01[..., None] * t01
    s = s + w11[..., None] * t11
    return s.to(h.dtype).reshape(b, hgt, wid, links * c)


def traj_warp_bwd_plain(h: torch.Tensor, flows: torch.Tensor,
                        gs: torch.Tensor):
    """The backward's plain version: (dh in h's dtype, dflows in the flows'
    dtype) from gS [B, H, W, L C], by autograd through ``traj_warp_plain``
    in float32 (the card's oracle for K8's backward)."""
    acc = torch.promote_types(h.dtype, torch.float32)
    hf = h.detach().to(acc).requires_grad_(True)
    ff = flows.detach().to(acc).requires_grad_(True)
    with torch.enable_grad():
        s = traj_warp_plain(hf, ff)
        dh, df = torch.autograd.grad(s, (hf, ff), gs.to(acc))
    return dh.to(h.dtype), df.to(flows.dtype)


def _check(what: str, **named) -> torch.device:
    """Raise ValueError unless the named tensors share one dtype K8 takes,
    are contiguous and lie on one CUDA device; returns the device."""
    dtypes = {t.dtype for t in named.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPES:
        raise ValueError(f"{what}: every operand float32 or bfloat16 alike, "
                         f"got {sorted(map(str, dtypes))}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    devices = {t.device for t in named.values()}
    dev = next(iter(devices))
    if len(devices) != 1 or dev.type != "cuda":
        raise ValueError(f"{what}: every operand on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    return dev


def _launch(kind: str, dtype, dev, *args) -> None:
    build.launch("traj_warp", f"traj_warp_{kind}_{_DTYPES[dtype]}",
                 _ARGTYPES[kind], dev, *args, what=f"traj_warp {kind} launch")
    profiling.count("traj_warp.launches")


def traj_warp_fwd(h: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """S [B, H, W, L C]: one K8 launch on CUDA tensors, the plain version on
    CPU tensors."""
    b, hgt, wid, c, links = _shapes(h, flows)
    if h.device.type == "cpu":
        return traj_warp_plain(h, flows)
    h, flows = h.contiguous(), flows.contiguous()
    dev = _check("traj_warp", h=h, flows=flows)
    s = torch.empty((b, hgt, wid, links * c), dtype=h.dtype, device=dev)
    _launch("fwd", h.dtype, dev, h.data_ptr(), flows.data_ptr(),
            s.data_ptr(), b, hgt, wid, c, links)
    return s


def traj_warp_bwd(h: torch.Tensor, flows: torch.Tensor, gs: torch.Tensor):
    """(dh, dflows) from gS: one K8 launch on CUDA tensors (both accumulated
    in float32 and cast to their operand's dtype once), the plain version
    on CPU tensors."""
    b, hgt, wid, c, links = _shapes(h, flows)
    if h.device.type == "cpu":
        return traj_warp_bwd_plain(h, flows, gs)
    h, flows, gs = h.contiguous(), flows.contiguous(), gs.contiguous()
    dev = _check("traj_warp backward", h=h, flows=flows, gs=gs)
    if tuple(gs.shape) != (b, hgt, wid, links * c):
        raise ValueError(f"traj_warp backward: gS must be "
                         f"{(b, hgt, wid, links * c)}, got {tuple(gs.shape)}")
    dh = torch.zeros(h.shape, dtype=torch.float32, device=dev)
    dflows = torch.zeros(flows.shape, dtype=torch.float32, device=dev)
    _launch("bwd", h.dtype, dev, h.data_ptr(), flows.data_ptr(),
            gs.data_ptr(), dh.data_ptr(), dflows.data_ptr(), b, hgt, wid, c,
            links)
    return dh.to(h.dtype), dflows.to(flows.dtype)


class TrajWarp(torch.autograd.Function):
    """apply(h, flows) -> S, K8 both ways. Saves its two operands."""

    @staticmethod
    def forward(ctx, h, flows):
        h, flows = h.contiguous(), flows.contiguous()
        ctx.save_for_backward(h, flows)
        return traj_warp_fwd(h, flows)

    @staticmethod
    def backward(ctx, gs):
        return traj_warp_bwd(*ctx.saved_tensors, gs)


def traj_warp(h: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """The warp of one cell-step, S [B, H, W, L C]: on CUDA tensors K8
    (``TrajWarp`` where gradients are wanted, else one forward launch), on
    CPU tensors the plain version, differentiable by autograd.
    ``traj_warp.launches`` counts every K8 launch, forward and backward."""
    if h.device.type == "cpu":
        return traj_warp_plain(h, flows)
    if torch.is_grad_enabled() and (h.requires_grad or flows.requires_grad):
        return TrajWarp.apply(h, flows)
    return traj_warp_fwd(h, flows)
