"""Plain PyTorch reference of the downscaling Generator and its four-term
loss, written from the upstream model (github.com/Tomzhuiowewie/
Pl-ConvLSTM-GAN, ``configs/default.yaml``): a CoordConv stem, stacked
ConvLSTM cells at the low resolution, PixelShuffle x2 blocks, DEM and LUCC
gated attention, a two-conv head; the loss is intensity-weighted L1 at the
stations + mass conservation + spatial smoothness + temporal smoothness.

Float32, NHWC; ``q`` is the rounding of ``reference.convlstm.rounding``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .convlstm import Round, cell, conv


def param_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    hd, k = model["hidden_dims"], model.get("kernel_size", 3)
    shapes = {"init_conv.weight": (hd[0], model["in_channels"] + 2, 3, 3),
              "init_conv.bias": (hd[0],)}
    cin = hd[0]
    for i, f in enumerate(hd):
        shapes[f"recurrence.cell{i + 1}.weight"] = (4 * f, cin + f, k, k)
        shapes[f"recurrence.cell{i + 1}.bias"] = (4 * f,)
        cin = f
    top = hd[-1]
    scale, n = int(model["scale_factor"]), 0
    while scale >= 2:
        shapes[f"upsample_{n}.conv.weight"] = (4 * top, top, 3, 3)
        shapes[f"upsample_{n}.conv.bias"] = (4 * top,)
        scale //= 2
        n += 1
    for name, cov in (("dem_attn", model["dem_channels"]),
                      ("lu_attn", model["lu_channels"])):
        shapes[f"{name}.conv_reduce.weight"] = (top // 2, cov, 3, 3)
        shapes[f"{name}.conv_reduce.bias"] = (top // 2,)
        shapes[f"{name}.conv_gate.weight"] = (top, top // 2, 1, 1)
        shapes[f"{name}.conv_gate.bias"] = (top,)
    shapes["post_conv1.weight"] = (32, top, 3, 3)
    shapes["post_conv1.bias"] = (32,)
    shapes["post_conv2.weight"] = (1, 32, 3, 3)
    shapes["post_conv2.bias"] = (1,)
    return shapes


def _shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC pixel shuffle in torch.nn.PixelShuffle's channel order."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def _resize(x: torch.Tensor, size, mode: str) -> torch.Tensor:
    """NHWC resize with F.interpolate (bilinear: align_corners False)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    kw = {"align_corners": False} if mode == "bilinear" else {}
    return F.interpolate(x.permute(0, 3, 1, 2), size=size, mode=mode,
                         **kw).permute(0, 2, 3, 1)


def _gate(p, name, feat, cov, q):
    g = torch.relu(conv(cov, p[f"{name}.conv_reduce.weight"],
                        p[f"{name}.conv_reduce.bias"], q, padding=1))
    g = torch.sigmoid(conv(g, p[f"{name}.conv_gate.weight"],
                           p[f"{name}.conv_gate.bias"], q, padding=0))
    return feat * g[None]


def forward(p, model: dict, rain_lr, dem, lu, q: Round) -> torch.Tensor:
    """rain_lr [B, T, 1, h, w], dem [B, 1, H, W], lu [B, L, H, W] ->
    [B, T, 1, h * s, w * s]."""
    b, t, c, h, w = rain_lr.shape
    hd, s = model["hidden_dims"], int(model["scale_factor"])
    xm = rain_lr.permute(1, 0, 3, 4, 2).reshape(t * b, h, w, c)
    rows = torch.linspace(0, 1, h, device=xm.device)[:, None].expand(h, w)
    cols = torch.linspace(0, 1, w, device=xm.device)[None, :].expand(h, w)
    coords = torch.stack([rows, cols], -1).expand(t * b, h, w, 2)
    xm = torch.relu(conv(torch.cat([xm, coords], -1), p["init_conv.weight"],
                         p["init_conv.bias"], q, padding=1))
    seq = xm.reshape(t, b, h, w, -1)
    state = [(torch.zeros(b, h, w, f, device=xm.device),
              torch.zeros(b, h, w, f, device=xm.device)) for f in hd]
    tops = []
    for step in range(t):
        x = seq[step]
        for i in range(len(hd)):
            state[i] = cell(x, *state[i], p[f"recurrence.cell{i + 1}.weight"],
                            p[f"recurrence.cell{i + 1}.bias"], q)
            x = state[i][0]
        tops.append(x)
    feat = torch.stack(tops).reshape(t * b, h, w, hd[-1])
    n = 0
    while f"upsample_{n}.conv.weight" in p:
        feat = torch.relu(_shuffle(conv(feat, p[f"upsample_{n}.conv.weight"],
                                        p[f"upsample_{n}.conv.bias"], q,
                                        padding=1), 2))
        n += 1
    size = (h * s, w * s)
    feat = _resize(feat, size, "bilinear")
    dem_hr = _resize(dem.permute(0, 2, 3, 1), size, "bilinear")
    lu_hr = _resize(lu.permute(0, 2, 3, 1), size, "nearest")
    feat = feat.reshape(t, b, *size, hd[-1])
    feat = _gate(p, "lu_attn", _gate(p, "dem_attn", feat, dem_hr, q),
                 lu_hr, q)
    feat = feat.reshape(t * b, *size, hd[-1])
    out = conv(torch.relu(conv(feat, p["post_conv1.weight"],
                               p["post_conv1.bias"], q, padding=1)),
               p["post_conv2.weight"], p["post_conv2.bias"], q, padding=1)
    return q(out).reshape(t, b, *size, 1).permute(1, 0, 4, 2, 3)


def _per_sample_mean(err):
    return err.reshape(err.shape[0], -1).mean(dim=1).mean()


def combined_loss(pred, rain_lr, s_coords, s_values, loss_cfg: dict):
    """lp * point + lc * conserve + ls * smooth + lt * temporal."""
    b, t, _, hgt, wid = pred.shape
    scale = hgt / rain_lr.shape[-2]
    coords = s_coords[0]
    rc = ((coords.float() + 0.5) * scale - 0.5).to(torch.int32)
    rows, cols = rc[:, 0], rc[:, 1]
    inside = (rows >= 0) & (rows < hgt) & (cols >= 0) & (cols < wid)
    idx = (rows.clamp(0, hgt - 1) * wid + cols.clamp(0, wid - 1)).long()
    at = pred[:, :, 0].reshape(b, t, hgt * wid)[..., idx]
    mask = (~torch.isnan(s_values) & inside[None, None]).float()
    obs = torch.nan_to_num(s_values, nan=0.0)
    if not loss_cfg["use_weighted_loss"]:
        weight = torch.ones_like(obs)
    elif loss_cfg["weight_strategy"] == "log":
        weight = 1.0 + torch.log1p(obs)
    else:
        raise ValueError(f"weight_strategy {loss_cfg['weight_strategy']!r}")
    cnt = mask.sum()
    point = torch.where(cnt > 0, ((at - obs).abs() * weight * mask).sum()
                        / cnt.clamp(min=1), 0.0)
    fh, fw = hgt // rain_lr.shape[-2], wid // rain_lr.shape[-1]
    p_lr = pred.reshape(b, t, 1, rain_lr.shape[-2], fh, rain_lr.shape[-1],
                        fw).mean(dim=(4, 6))
    conserve = _per_sample_mean((p_lr - rain_lr).abs())
    smooth = (_per_sample_mean((pred[..., :, :-1] - pred[..., :, 1:]).abs())
              + _per_sample_mean((pred[..., :-1, :] - pred[..., 1:, :]).abs()))
    temporal = _per_sample_mean((pred[:, :-1] - pred[:, 1:]).abs())
    return (loss_cfg["lambda_point"] * point
            + loss_cfg["lambda_conserve"] * conserve
            + loss_cfg["lambda_smooth"] * smooth
            + loss_cfg["lambda_temporal"] * temporal)
