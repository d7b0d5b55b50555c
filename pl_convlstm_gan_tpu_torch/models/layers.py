"""Building blocks as ``nn.Module``s, counterparts of the JAX package's
``models/layers.py``: the torch-default-init conv, the ConvLSTM cell, and
the Generator's split-input cell, upsample block and covariate gate.

Activations are NHWC, as in the JAX package. Parameters are held in float32
and torch's OIHW layout (``weights.py`` maps them to and from the flax HWIO
tree); the forward casts them to the compute ``dtype`` (float32 or bfloat16),
or to the input's type when ``dtype`` is None.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..ops.convlstm import (convlstm_precompute_x, convlstm_step,
                            convlstm_step_precomputed, convlstm_step_tp,
                            pack_step_weight)
from ..ops.kernels.convlstm_kernel import pass_weight
from ..ops.nn import conv2d_nhwc_f32, torch_init_bound
from ..ops.pixel_shuffle import pixel_shuffle
from ..parallel.tensor_parallel import local_shard, shard_cell_params


class CellPass(NamedTuple):
    """A cell's weights for one forward pass (``ConvLSTMCell.for_pass``):
    K1's packed weight, and where the pass's weight gradient is one
    convolution, the compute-dtype weight of every step and its
    ``CellWgrad``. None: made at each step (the weight cast from the
    parameter)."""
    packed: Optional[torch.Tensor] = None
    weight: Optional[torch.Tensor] = None
    wgrad: object = None


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
    ('torch') or the fused CUDA kernel ('kernel').

    ``tp_group`` (a model group of n ranks) shards the cell's channels
    (``parallel/tensor_parallel.py``): the parameters are this rank's
    blocks of the shard-major layout, weight [4F/n, Cin+F, K, K] and bias
    [4F/n] (marked ``tp_sharded``), sliced from the full init that every
    rank draws from the same generator state, so a TP model starts from the
    weights of one process. The forward then takes the full h and this
    rank's c [..., F/n] and returns the full h' (one all-gather) and the
    local c' (``ops.convlstm.convlstm_step_tp``). The kernel cell computes
    the full width's gates and is refused, as the JAX package refuses its
    Pallas cell under tensor parallelism."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 impl: str = "torch", dtype: Optional[torch.dtype] = None,
                 tp_group=None):
        super().__init__()
        cin = in_features + features
        self.impl = impl
        self.dtype = dtype
        self.tp_group = tp_group
        weight = torch.empty(4 * features, cin, kernel_size, kernel_size)
        bias = torch.empty(4 * features)
        fan_in = kernel_size * kernel_size * cin
        _init_uniform(weight, fan_in)
        _init_uniform(bias, fan_in)
        if tp_group is not None:
            if impl == "kernel":
                raise ValueError(
                    "tensor parallelism requires the plain cell "
                    "(convlstm_impl 'xla'/'auto'): the kernel cell computes "
                    "the full width's gates")
            n = dist.get_world_size(tp_group)
            rank = dist.get_rank(tp_group)
            weight, bias = (local_shard(t, rank, n).clone()
                            for t in shard_cell_params(weight, bias, n))
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)
        if tp_group is not None:
            self.weight.tp_sharded = self.bias.tp_sharded = True

    def for_pass(self, dtype: torch.dtype, remat: bool = False) -> CellPass:
        """This cell's weights at the compute ``dtype`` for one forward pass
        over a sequence, for the loop to make once and hand to every step:
        K1's packed weight (``pack_step_weight``; None when this cell
        launches no K1) and, where a kernel cell's weight takes a gradient
        outside ``remat`` (whose recompute would stash every step again),
        the weight cast once and its ``CellWgrad``
        (``convlstm_kernel.pass_weight``): the pass's weight gradient is
        then one convolution over all its steps."""
        weight = wgrad = None
        if (self.impl == "kernel" and not remat and torch.is_grad_enabled()
                and self.weight.requires_grad):
            weight, wgrad = pass_weight(self.weight, dtype)
        cast = (self.weight.detach().to(dtype) if weight is None
                else weight.detach())
        return CellPass(pack_step_weight(cast, self.impl), weight, wgrad)

    def forward(self, x, h, c, weights: Optional[CellPass] = None):
        dtype = self.dtype or x.dtype
        if self.tp_group is not None:
            return convlstm_step_tp(x.to(dtype), h.to(dtype), c.to(dtype),
                                    self.weight.to(dtype),
                                    self.bias.to(dtype), self.tp_group)
        packed, weight, wgrad = weights or CellPass()
        if weight is None:
            weight = self.weight.to(dtype)
        return convlstm_step(x.to(dtype), h.to(dtype), c.to(dtype), weight,
                             self.bias.to(dtype), impl=self.impl,
                             packed=packed, wgrad=wgrad)


class SplitInputConvLSTMCell(ConvLSTMCell):
    """A ConvLSTM cell whose input-side conv runs apart from the recurrence.

    Its parameters, names and init are ``ConvLSTMCell``'s (one weight [4Ch,
    Cx+Ch, K, K] and bias [4Ch]), so checkpoints interchange; only the
    schedule differs: ``precompute_x`` runs once over every step's input
    merged (T*B), ``step`` does the h-side conv and the gates. Plain PyTorch
    only (K1 has no h-only form)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, features, kernel_size, "torch", dtype)

    def precompute_x(self, x):
        """[N, H, W, Cx] -> x-side pre-activations [N, H, W, 4Ch], float32."""
        dtype = self.dtype or x.dtype
        return convlstm_precompute_x(x.to(dtype), self.weight.to(dtype),
                                     self.bias.to(dtype))

    def step(self, z_x, h, c):
        dtype = self.dtype or h.dtype
        return convlstm_step_precomputed(z_x, h.to(dtype), c.to(dtype),
                                         self.weight.to(dtype))


class UpsampleBlock(nn.Module):
    """conv(C -> C*r^2, 3x3) -> PixelShuffle(r) -> ReLU."""

    def __init__(self, features: int, upscale: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.upscale = upscale
        self.conv = Conv2dTorch(features, features * upscale ** 2, (3, 3),
                                padding=1, dtype=dtype)

    def forward(self, x):
        return torch.relu(pixel_shuffle(self.conv(x), self.upscale))


class GatedCovariateAttention(nn.Module):
    """x * sigmoid(conv1x1(relu(conv3x3(cov)))), the DEM and LUCC gates.

    The gate depends only on the covariate, so for time-major features
    [T, B, H, W, C] against a per-sample covariate [B, H, W, Cc] it is
    computed once over B and broadcast over T, never over a covariate tiled
    T-fold (exact: the convs are per sample)."""

    def __init__(self, cov_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_reduce = Conv2dTorch(cov_features, features // 2, (3, 3),
                                       padding=1, dtype=dtype)
        self.conv_gate = Conv2dTorch(features // 2, features, (1, 1),
                                     padding=0, dtype=dtype)

    def forward(self, x, cov):
        gate = torch.sigmoid(self.conv_gate(torch.relu(self.conv_reduce(cov))))
        if x.dim() == cov.dim() + 1:     # time-major features
            gate = gate[None]
        return x * gate
