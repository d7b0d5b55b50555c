"""Low-level NN helpers: HWIO <-> OIHW kernel layouts, the PyTorch-default init
bound, and an NHWC conv computed in float32.

The JAX package keeps conv kernels HWIO ([Kh, Kw, Cin, Cout]) and activations
NHWC; the port keeps its parameters in torch's OIHW ([Cout, Cin, Kh, Kw]) and
its activations NHWC, so the layouts meet only in these helpers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def torch_init_bound(fan_in: int) -> float:
    """Bound of torch Conv2d's default init, U(+-1/sqrt(fan_in)), for both the
    kernel (kaiming_uniform(a=sqrt(5)) reduces to it) and the bias."""
    return 1.0 / math.sqrt(fan_in)


def hwio_from_oihw(kernel_oihw):
    """torch Conv2d weight [O, I, Kh, Kw] -> HWIO. numpy arrays or tensors."""
    if isinstance(kernel_oihw, torch.Tensor):
        return kernel_oihw.permute(2, 3, 1, 0)
    return kernel_oihw.transpose(2, 3, 1, 0)


def oihw_from_hwio(kernel_hwio):
    """Inverse of ``hwio_from_oihw``: HWIO -> OIHW. numpy arrays or tensors."""
    if isinstance(kernel_hwio, torch.Tensor):
        return kernel_hwio.permute(3, 2, 0, 1)
    return kernel_hwio.transpose(3, 2, 0, 1)


def conv2d_nhwc_f32(x: torch.Tensor, weight_oihw: torch.Tensor,
                    bias: torch.Tensor | None, padding="same",
                    stride: int | tuple[int, int] = 1) -> torch.Tensor:
    """Conv of NHWC ``x`` with an OIHW kernel, computed in float32 whatever
    the operands' type (the products of bf16 values are exact in f32, so
    bf16 operands give f32 accumulation). Returns NHWC float32.

    ``padding="same"`` (stride 1 only) pads (K-1)//2 before and the rest
    after, which is the JAX 'SAME' rule for even kernels too; an int pads
    that many pixels on every side, torch-style, as the JAX ``conv2d`` does
    with an int padding."""
    out = F.conv2d(x.permute(0, 3, 1, 2).float(), weight_oihw.float(),
                   None if bias is None else bias.float(), stride=stride,
                   padding=padding)
    return out.permute(0, 2, 3, 1)
