"""Spatial resizes of NHWC tensors with PyTorch ``F.interpolate``'s edge
semantics, counterpart of the JAX package's ``ops/resize.py``:

- ``resize_bilinear``: bilinear, ``align_corners=False`` (the Generator's
  DEM and its remainder upscaling);
- ``resize_nearest``: PyTorch's legacy ``nearest`` indexing,
  src = floor(i * in / out), not half-pixel (the LUCC covariate);
- ``resize_area``: ``mode='area'`` (adaptive average pooling; the
  conservation loss).

Bilinear and area apply the same separable per-axis matrices as the JAX
package (built in numpy in float64, applied in float32, the result cast
back to the input's type), so bfloat16 inputs round once, as there; an
integer area downscale is a reshape-mean accumulated in float32. Nearest is
an index gather. All take [..., H, W, C] and resize H and W.
"""
from __future__ import annotations

import numpy as np
import torch


def _bilinear_matrix(out_size: int, in_size: int) -> np.ndarray:
    """[out, in] weights of torch bilinear, align_corners=False: source
    coordinate (i + 0.5) * in/out - 0.5 clamped below at 0, a linear blend of
    its floor and ceil neighbours (clamped at the edge)."""
    scale = in_size / out_size
    i = np.arange(out_size, dtype=np.float64)
    src = np.maximum((i + 0.5) * scale - 0.5, 0.0)
    x0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    frac = src - x0
    a = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(a, (rows, x0), 1.0 - frac)
    np.add.at(a, (rows, x1), frac)
    return a


def _area_matrix(out_size: int, in_size: int) -> np.ndarray:
    """[out, in] averaging weights of torch mode='area': output i averages
    the window [floor(i*in/out), ceil((i+1)*in/out))."""
    a = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)
        a[i, start:end] = 1.0 / (end - start)
    return a


def _nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    """torch legacy 'nearest': src = floor(i * in/out), at most in - 1."""
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def _apply_separable(x: torch.Tensor, a_h: np.ndarray,
                     a_w: np.ndarray) -> torch.Tensor:
    """x: [..., H, W, C]; the per-axis matrices applied in float32, the
    result cast back to x's type."""
    mh = torch.from_numpy(a_h.astype(np.float32)).to(x.device)
    mw = torch.from_numpy(a_w.astype(np.float32)).to(x.device)
    y = torch.einsum("ph,...hwc->...pwc", mh, x.float())
    y = torch.einsum("qw,...pwc->...pqc", mw, y)
    return y.to(x.dtype)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[..., H, W, C] -> [..., out_h, out_w, C]; torch bilinear,
    align_corners=False."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    return _apply_separable(x, _bilinear_matrix(out_h, h),
                            _bilinear_matrix(out_w, w))


def resize_area(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[..., H, W, C] -> [..., out_h, out_w, C]; torch mode='area'. An
    integer-factor downscale is a reshape-mean in float32."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    if h % out_h == 0 and w % out_w == 0:
        fh, fw = h // out_h, w // out_w
        y = x.reshape(*x.shape[:-3], out_h, fh, out_w, fw, x.shape[-1])
        return y.float().mean(dim=(-4, -2)).to(x.dtype)
    return _apply_separable(x, _area_matrix(out_h, h), _area_matrix(out_w, w))


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[..., H, W, C] -> [..., out_h, out_w, C]; torch legacy 'nearest'."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    ih = torch.from_numpy(_nearest_indices(out_h, h)).to(x.device)
    iw = torch.from_numpy(_nearest_indices(out_w, w)).to(x.device)
    return x.index_select(-3, ih).index_select(-2, iw)

