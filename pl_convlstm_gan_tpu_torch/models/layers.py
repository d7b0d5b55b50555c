"""Building blocks as ``nn.Module``s: the torch-default-init conv and the
ConvLSTM cell, counterparts of the JAX package's ``models/layers.py``.

Activations are NHWC, as in the JAX package. Parameters are held in float32
and torch's OIHW layout (``weights.py`` maps them to and from the flax HWIO
tree); the forward casts them to the compute ``dtype`` (float32 or bfloat16),
or to the input's type when ``dtype`` is None.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.convlstm import convlstm_step, pack_step_weight
from ..ops.nn import conv2d_nhwc_f32, torch_init_bound


def _init_uniform(param: torch.Tensor, fan_in: int) -> None:
    bound = torch_init_bound(fan_in)
    nn.init.uniform_(param, -bound, bound)


class Conv2dTorch(nn.Module):
    """NHWC conv with PyTorch Conv2d's default init, U(+-1/sqrt(fan_in)) on
    kernel and bias. ``strides`` and an int ``padding`` (pixels on every
    side) as in the JAX ``Conv2dTorch``; ``"same"`` needs stride 1.
    Accumulates in float32 and returns the compute type."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), padding="same",
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        fan_in = kh * kw * in_features
        _init_uniform(self.weight.data, fan_in)
        if self.bias is not None:
            _init_uniform(self.bias.data, fan_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        return conv2d_nhwc_f32(x.to(dtype), self.weight.to(dtype), bias,
                               self.padding, self.strides).to(dtype)


class ConvLSTMCell(nn.Module):
    """One ConvLSTM cell: weight [4F, Cin+F, K, K] (OIHW), bias [4F], gate order
    i|f|o|g, input channels ordered concat(x, h). ``impl`` picks the plain step
    ('torch') or the fused CUDA kernel ('kernel')."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 impl: str = "torch", dtype: Optional[torch.dtype] = None):
        super().__init__()
        cin = in_features + features
        self.impl = impl
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(4 * features, cin, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(4 * features))
        fan_in = kernel_size * kernel_size * cin
        _init_uniform(self.weight.data, fan_in)
        _init_uniform(self.bias.data, fan_in)

    def pack(self, dtype: torch.dtype):
        """K1's packed weight at the compute ``dtype`` (``pack_step_weight``;
        None when this cell launches no K1), for a loop over a sequence to
        make once per forward pass and hand to every step."""
        return pack_step_weight(self.weight.detach().to(dtype), self.impl)

    def forward(self, x, h, c, packed=None):
        dtype = self.dtype or x.dtype
        return convlstm_step(x.to(dtype), h.to(dtype), c.to(dtype),
                             self.weight.to(dtype), self.bias.to(dtype),
                             impl=self.impl, packed=packed)
