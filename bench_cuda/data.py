"""Inputs and weights made from ``--seed``, on the device, in a few large
calls of a ``torch.Generator``: the same seed gives the same tensors, which
the program and the reference both receive.

Each kind of draw takes a generator of its own (``gen(seed, name)``), so
that adding a draw never shifts another. The amounts depend on the mix and
the window alone, never on the seed: every seed gives the same sizes.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .reference.convlstm import init_params, numel


def gen(seed: int, name: str, device) -> torch.Generator:
    """A generator on ``device`` for the draws called ``name`` of ``seed``
    (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def weights(seed: int, shapes: Dict[str, Sequence[int]], device
            ) -> Dict[str, torch.Tensor]:
    """Float32 parameters: one draw of U[0, 1) for all of them, scaled per
    leaf to PyTorch's conv default init."""
    flat = torch.rand(numel(shapes), generator=gen(seed, "weights", device),
                      device=device)
    return init_params(shapes, flat)


def smooth_fields(n: int, size: int, g: torch.Generator, device,
                  coarse: int = 8) -> torch.Tensor:
    """[n, 1, size, size] fields in [0, 1): uniform noise at size / coarse,
    resized bilinearly (echo-like blobs)."""
    low = torch.rand(n, 1, max(size // coarse, 2), max(size // coarse, 2),
                     generator=g, device=device)
    return F.interpolate(low, size=(size, size), mode="bilinear",
                         align_corners=False)


def stream_frames(seed: int, n: int, size: int, channels: int, device
                  ) -> torch.Tensor:
    """[n, 1, C, size, size]: a frame per request (index i % n)."""
    g = gen(seed, "stream_frames", device)
    frames = smooth_fields(n * channels, size, g, device)
    return frames.reshape(n, 1, channels, size, size)


def sequence_batches(seed: int, pool: int, batch: int, t_in: int,
                     t_out: int, size: int, device
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``pool`` batches of (inputs [B, T_in, 1, S, S], targets [B, T_out, 1,
    S, S]): each row a field drifting by its own whole-pixel velocity, so
    that every row of every batch differs."""
    g = gen(seed, "sequence_batches", device)
    n, t = pool * batch, t_in + t_out
    base = smooth_fields(n, size, g, device)
    vel = torch.randint(-3, 4, (n, 2), generator=g, device=device).tolist()
    frames = torch.stack([torch.roll(base[i], (vel[i][0] * s, vel[i][1] * s),
                                     dims=(-2, -1))
                          for i in range(n) for s in range(t)])
    frames = frames.reshape(pool, batch, t, 1, size, size)
    return [(frames[p, :, :t_in].contiguous(), frames[p, :, t_in:].contiguous())
            for p in range(pool)]


def downscaling_batches(seed: int, pool: int, batch: int, t: int, size: int,
                        scale: int, lu_classes: int, stations: int, device):
    """``pool`` batches of the Fenhe-shaped downscaling data: (rain_lr [B,
    T, 1, s, s] mm/day: smooth fields x 8 plus rare heavy cells, dem [B, 1,
    S, S], one-hot LUCC [B, L, S, S], station coords [B, N, 2] (the same
    stations in every row), station values [B, T, N]: the rain at the
    station's cell x U(0.8, 1.2), a tenth missing (NaN))."""
    g = gen(seed, "downscaling_batches", device)
    n, hi = pool * batch, size * scale
    rain = smooth_fields(n * t, size, g, device, coarse=4) * 8.0
    heavy = (torch.rand(rain.shape, generator=g, device=device) > 0.97) * (
        -torch.log1p(-torch.rand(rain.shape, generator=g, device=device))
        * 30.0)
    rain = (rain + heavy).reshape(pool, batch, t, 1, size, size)
    dem = smooth_fields(n, hi, g, device, coarse=16).reshape(
        pool, batch, 1, hi, hi)
    cls = torch.randint(0, lu_classes, (n, hi, hi), generator=g,
                        device=device)
    lu = F.one_hot(cls, lu_classes).permute(0, 3, 1, 2).float().reshape(
        pool, batch, lu_classes, hi, hi)
    coords = torch.randint(0, size, (pool, stations, 2), generator=g,
                           device=device)
    out = []
    for p in range(pool):
        at = rain[p, :, :, 0][:, :, coords[p, :, 0], coords[p, :, 1]]
        vals = at * (0.8 + 0.4 * torch.rand(at.shape, generator=g,
                                            device=device))
        miss = torch.rand(at.shape, generator=g, device=device) < 0.1
        vals = torch.where(miss, torch.full_like(vals, float("nan")), vals)
        out.append((rain[p].contiguous(), dem[p].contiguous(),
                    lu[p].contiguous(),
                    coords[p][None].expand(batch, stations, 2).contiguous(),
                    vals.contiguous()))
    return out
