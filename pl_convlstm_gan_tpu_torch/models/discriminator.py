"""The GAN family's patch discriminator, counterpart of the JAX package's
``models/discriminator.py``.

Frames [B, T, C, H, W] are merged into one (B*T) NHWC batch and scored per
frame: ``conv_{i}`` 4x4 convs with stride 2 and padding 1, each followed by
``leaky_relu(0.2)``, then ``conv_out`` (4x4, stride 1, padding 1, one
channel). The output is the patch logits [B, T, 1, H', W'] in float32.
Module names are those of the flax tree, so ``weights.flax_to_state_dict``
maps its params as they are (``conv_0.weight``, ``conv_out.bias``, ...).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2dTorch


class Discriminator(nn.Module):
    """frames [B, T, C, H, W] -> patch logits [B, T, 1, H', W'] float32
    (pre-sigmoid). ``dtype`` is the compute type (None: the input's)."""

    def __init__(self, in_channels: int = 1,
                 features: Sequence[int] = (64, 128, 256),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = tuple(features)
        self.dtype = dtype
        cin = in_channels
        for i, feat in enumerate(self.features):
            self.add_module(f"conv_{i}", Conv2dTorch(
                cin, feat, (4, 4), strides=(2, 2), padding=1, dtype=dtype))
            cin = feat
        self.conv_out = Conv2dTorch(cin, 1, (4, 4), padding=1, dtype=dtype)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        b, t, c, hgt, wid = frames.shape
        x = frames.permute(0, 1, 3, 4, 2).reshape(b * t, hgt, wid, c)
        x = x.to(self.dtype or x.dtype)
        for i in range(len(self.features)):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), 0.2)
        x = self.conv_out(x)
        hp, wp = x.shape[1], x.shape[2]
        return x.reshape(b, t, hp, wp, 1).permute(0, 1, 4, 2, 3).float()
