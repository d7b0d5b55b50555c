"""CoordConv channels, counterpart of the JAX package's ``ops/coords.py``:
two planes of normalized coordinates, ``linspace(0, 1, H)`` down the rows
and ``linspace(0, 1, W)`` along the columns, appended after the data
channels of an NHWC tensor."""
from __future__ import annotations

import torch


def add_coord_channels(x: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, C] -> [B, H, W, C+2] with row/col coordinate channels
    appended, in x's dtype."""
    b, h, w, _ = x.shape
    row = torch.linspace(0.0, 1.0, h, dtype=x.dtype, device=x.device)
    col = torch.linspace(0.0, 1.0, w, dtype=x.dtype, device=x.device)
    coords = torch.stack([row[:, None].expand(h, w),
                          col[None, :].expand(h, w)], dim=-1)
    return torch.cat([x, coords.expand(b, h, w, 2)], dim=-1)
