"""PixelShuffle (depth-to-space) in NHWC with ``torch.nn.PixelShuffle``'s
channel order, counterpart of the JAX package's ``ops/pixel_shuffle.py``:
out[b, h*r+i, w*r+j, c] = in[b, h, w, c*r*r + i*r + j]."""
from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, upscale_factor: int) -> torch.Tensor:
    """x: [B, H, W, C*r*r] -> [B, H*r, W*r, C]."""
    r = upscale_factor
    b, h, w, crr = x.shape
    c = crr // (r * r)
    if c * r * r != crr:
        raise ValueError(f"Channel dim {crr} not divisible by r^2={r * r}")
    y = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)  # [B,H,r,W,r,C]
    return y.reshape(b, h * r, w * r, c)
