"""The downscaling Generator: CoordConv stem -> stacked ConvLSTM cells at low
resolution -> PixelShuffle x2 blocks -> DEM / LUCC gated attention -> conv
head. Counterpart of the JAX package's ``models/generator.py``.

The schedule is the JAX package's:
- the stem (coordinate channels, ``init_conv``, ReLU) runs once over the
  merged T*B batch;
- a Python loop over T at low resolution carries every cell's (h, c)
  (``split_precompute``: cell 1's input-side conv hoisted out of the loop as
  one conv over T*B, the plain step only);
- the high-resolution decode (upsample blocks, the remainder bilinear, the
  resize to a target grid, the attention gates, the head) runs once over the
  merged T*B batch after the loop; the gates are computed once over B and
  broadcast over T.

Sizing modes: ``scale_factor``, or ``target_grid_size`` with
``input_grid_size`` (grid spacings; scale = max(input/target) over the two
axes, output size int(H * scale_h) x int(W * scale_w)). The block count,
floor(log2(int(scale))), is fixed at construction: the JAX package gives
``input_grid_size`` at call time, the port at construction. A scale that
is not a power of two finishes with a bilinear resize (scale 6 = two
blocks and 1.5x).

``convlstm_impl`` picks the cells' step as in the forecaster: 'torch'
(plain) or 'kernel' (K1; under autograd ``ConvLSTMCellFn``, K1 writing
z). With 'kernel' on the card each cell's weight is packed for K1 once per
forward pass. Module names follow the flax tree (``init_conv``,
``recurrence.cell1``, ``upsample_0.conv``, ``dem_attn.conv_reduce``, ...),
so ``weights.flax_to_state_dict`` maps a JAX checkpoint as it is.

Tensors cross the boundary as rain_lr [B, T, C, H, W], dem [B, Cd, Hd, Wd],
lu [B, Cl, Hl, Wl]; the output is [B, T, 1, H', W'] in float32.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.coords import add_coord_channels
from ..ops.resize import resize_bilinear, resize_nearest
from .layers import (Conv2dTorch, ConvLSTMCell, GatedCovariateAttention,
                     SplitInputConvLSTMCell, UpsampleBlock)


def resolve_scale(scale_factor: Optional[float],
                  target_grid_size: Optional[Tuple[float, float]],
                  input_grid_size: Optional[Tuple[float, float]]):
    """(scale, (scale_h, scale_w) or None) of the two sizing modes: a target
    grid with an input grid gives the per-axis scales, whose max sets the
    block count; else ``scale_factor``; else 1."""
    if target_grid_size is not None and input_grid_size is not None:
        input_gx, input_gy = input_grid_size
        target_gx, target_gy = target_grid_size
        scale_h, scale_w = input_gy / target_gy, input_gx / target_gx
        return max(scale_h, scale_w), (scale_h, scale_w)
    if scale_factor is not None:
        return float(scale_factor), None
    return 1.0, None


def num_upsample_blocks(scale: float) -> int:
    """floor(log2(int(scale))) x2 blocks; the rest is bilinear."""
    s, n = int(scale), 0
    while s >= 2:
        n += 1
        s //= 2
    return n


class _Recurrence(nn.Module):
    """The stacked cells, named ``cell1``, ``cell2``, ... as in the flax
    tree; with ``split`` cell 1 is a ``SplitInputConvLSTMCell``."""

    def __init__(self, hidden_dims, kernel_size, impl, dtype, split):
        super().__init__()
        self.n_cells = len(hidden_dims)
        cin = hidden_dims[0]
        for i, feat in enumerate(hidden_dims):
            if i == 0 and split:
                cell = SplitInputConvLSTMCell(cin, feat, kernel_size, dtype)
            else:
                cell = ConvLSTMCell(cin, feat, kernel_size, impl=impl,
                                    dtype=dtype)
            self.add_module(f"cell{i + 1}", cell)
            cin = feat

    def cells(self):
        return [getattr(self, f"cell{i + 1}") for i in range(self.n_cells)]


class Generator(nn.Module):
    """rain_lr [B,T,C,H,W], dem [B,Cd,Hd,Wd], lu [B,Cl,Hl,Wl] ->
    [B,T,1,H',W'] float32. ``dtype`` is the compute type (None: the
    input's); ``lu_channels`` must be known (a dataset's class count)."""

    def __init__(self, in_channels: int = 1, dem_channels: int = 1,
                 lu_channels: int = 0, hidden_dims: Sequence[int] = (16, 32),
                 target_grid_size: Optional[Tuple[float, float]] = None,
                 scale_factor: Optional[float] = None,
                 input_grid_size: Optional[Tuple[float, float]] = None,
                 kernel_size: int = 3, convlstm_impl: str = "torch",
                 split_precompute: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if lu_channels <= 0:
            raise ValueError("the Generator needs lu_channels > 0 (the LUCC "
                             "class count of the data)")
        if split_precompute and convlstm_impl != "torch":
            raise ValueError("split_precompute runs the plain step only: the "
                             "split-input cell has no kernel form")
        hd = tuple(hidden_dims)
        self.hidden_dims = hd
        self.in_channels = in_channels
        self.convlstm_impl = convlstm_impl
        self.split_precompute = split_precompute
        self.dtype = dtype
        self.scale, self.axis_scales = resolve_scale(
            scale_factor, target_grid_size, input_grid_size)
        self.n_blocks = num_upsample_blocks(self.scale)

        self.init_conv = Conv2dTorch(in_channels + 2, hd[0], (3, 3),
                                     padding=1, dtype=dtype)
        self.recurrence = _Recurrence(hd, kernel_size, convlstm_impl, dtype,
                                      split_precompute)
        for i in range(self.n_blocks):
            self.add_module(f"upsample_{i}", UpsampleBlock(hd[-1], 2, dtype))
        self.dem_attn = GatedCovariateAttention(dem_channels, hd[-1], dtype)
        self.lu_attn = GatedCovariateAttention(lu_channels, hd[-1], dtype)
        self.post_conv1 = Conv2dTorch(hd[-1], 32, (3, 3), padding=1,
                                      dtype=dtype)
        self.post_conv2 = Conv2dTorch(32, 1, (3, 3), padding=1, dtype=dtype)

    def output_size(self, h: int, w: int) -> Tuple[int, int]:
        if self.axis_scales is not None:
            return int(h * self.axis_scales[0]), int(w * self.axis_scales[1])
        return int(h * self.scale), int(w * self.scale)

    def _recur(self, xm, t, b):
        """The loop over T at low resolution: xm [T*B, H, W, hd0] -> the last
        cell's h at every step, [T*B, H, W, hd-1]."""
        _, h, w, _ = xm.shape
        cdtype = xm.dtype
        cells = self.recurrence.cells()
        states = [(xm.new_zeros((b, h, w, f)), xm.new_zeros((b, h, w, f)))
                  for f in self.hidden_dims]
        packed = [None if self.split_precompute and i == 0 else
                  cell.pack(cdtype) for i, cell in enumerate(cells)]
        if self.split_precompute:
            seq = cells[0].precompute_x(xm).reshape(t, b, h, w, -1)
        else:
            seq = xm.reshape(t, b, h, w, -1)
        tops = []
        for s in range(t):
            x = seq[s]
            for i, cell in enumerate(cells):
                if i == 0 and self.split_precompute:
                    hn, cn = cell.step(x, *states[0])
                else:
                    hn, cn = cell(x, *states[i], packed=packed[i])
                states[i] = (hn, cn)
                x = hn
            tops.append(x)
        return torch.stack(tops).reshape(t * b, h, w, -1)

    def forward(self, rain_lr: torch.Tensor, dem: torch.Tensor,
                lu: torch.Tensor) -> torch.Tensor:
        b, t, c, h, w = rain_lr.shape
        hd = self.hidden_dims
        cdtype = self.dtype or rain_lr.dtype
        final_h, final_w = self.output_size(h, w)

        # stem over the merged (T*B) batch, time-major
        xm = rain_lr.permute(1, 0, 3, 4, 2).reshape(t * b, h, w, c).to(cdtype)
        xm = torch.relu(self.init_conv(add_coord_channels(xm)))

        feat = self._recur(xm, t, b)

        # decode once over the merged (T*B) batch
        for i in range(self.n_blocks):
            feat = getattr(self, f"upsample_{i}")(feat)
        remaining = self.scale / (2 ** self.n_blocks)
        if remaining > 1:
            feat = resize_bilinear(feat, int(feat.shape[1] * remaining),
                                   int(feat.shape[2] * remaining))
        if self.axis_scales is not None:
            feat = resize_bilinear(feat, final_h, final_w)

        # covariates to the final size: DEM bilinear, LUCC nearest
        dem_hr = resize_bilinear(dem.permute(0, 2, 3, 1).to(cdtype), final_h,
                                 final_w)
        lu_hr = resize_nearest(lu.permute(0, 2, 3, 1).to(cdtype), final_h,
                               final_w)
        feat = feat.reshape(t, b, final_h, final_w, hd[-1])
        feat = self.lu_attn(self.dem_attn(feat, dem_hr), lu_hr)
        feat = feat.reshape(t * b, final_h, final_w, hd[-1])

        out = self.post_conv2(torch.relu(self.post_conv1(feat)))
        return out.reshape(t, b, final_h, final_w, 1).permute(
            1, 0, 4, 2, 3).float()
