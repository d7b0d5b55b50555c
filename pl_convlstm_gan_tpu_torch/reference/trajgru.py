"""Plain float32 reference of TrajGRU's encoder-forecaster, written from the
paper (Shi et al., "Deep Learning for Precipitation Nowcasting: A Benchmark
and A New Model", NeurIPS 2017, arXiv:1706.03458) and the layout of the
HKO-7 benchmark code (github.com/sxjscience/HKO-7) and its PyTorch port. It
imports nothing of the port's models, ops or kernels.

A TrajGRU layer with C hidden channels and L links at step t, ``*`` a
convolution, ``s`` the sigmoid and ``f`` a leaky ReLU of slope 0.2:

    U, V  = flows_conv * f(i2f_conv1 * X_t + h2f_conv1 * H_{t-1})
            (5x5 convs: X -> 32, H -> 32, then 32 -> 2L: L flow fields)
    W_l   = warp(H_{t-1}, u_l, v_l)  bilinear sample of H at (x + u_l,
            y + v_l), zero outside the frame (``F.grid_sample``,
            align_corners=True, zero padding)
    S_t   = concat_l W_l             (channel l C + c)
    r, z, n = split(i2h * X_t (k x k, -> 3C)) + split(ret * S_t (1x1,
            L C -> 3C))              (order r|z|n)
    R = s(r_x + r_h)   Z = s(z_x + z_h)   H' = f(n_x + R n_h)
    H_t = Z H_{t-1} + (1 - Z) H'

A layer with no input (the forecaster's top) drops the X terms. The
encoder runs, level by level from the frames up, a strided conv and a leaky
ReLU (``traj_stems[i]``: [out, kernel, stride, padding]) over every input
frame, then its TrajGRU from a zero state over the input steps. The
forecaster runs from the top level down, each level from the encoder's last
state of that level for ``output_frames`` steps: the top layer has no
input, a lower layer reads the transposed conv and leaky ReLU
(``traj_deconvs[i + 1]``) of the outputs of the layer above; after the
bottom layer come its transposed conv and leaky ReLU, a 3x3 conv and leaky
ReLU, and a 1x1 conv to the frame's channels. No prediction is fed back.

The loss is HKO-7's balanced MSE plus balanced MAE: each pixel weighted by
its target's rain rate (1, 1, 2, 5, 10, 30 below 0.5 mm/h and at or above
0.5, 2, 5, 10 and 30 mm/h, a rate R being the pixel (dBZ + 10) / 70 with
Z = 58.53 R^1.56), the weighted squared and absolute errors each summed
over a frame's pixels and averaged over frames and rows, added, times
5e-5.

Parameters are a dict of float32 tensors under the port's state-dict names
(``encoder.stage<i>.conv<i>_leaky_1``, ``encoder.rnn<i>.<conv>``,
``forecaster.rnn<i>.<conv>``, ``forecaster.stage<i>.deconv<n + 1 - i>_
leaky_1``, the bottom stage's ``conv<n>_leaky_2`` and ``conv<n>_3``; every
conv with a bias). ``model`` is a dict of the port's ``model`` config keys.
Activations are NCHW.

Where it departs from the HKO-7 code: frames come as [B, T, C, H, W]; the
forecaster's top layer has no ``i2h`` or ``i2f_conv1`` (the PyTorch port
builds them and never reads them); the flows are used as ``flows_conv``
gives them, where that port warps by their negative; the loss has no mask
(every pixel valid). A level one pixel wide or high is not taken (the
normalized grid has no extent there).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

SLOPE = 0.2
FLOW_KERNEL = 5
FLOW_CHANNELS = 32
THRESHOLDS = (0.5, 2.0, 5.0, 10.0, 30.0)       # mm/h
WEIGHTS = (1.0, 1.0, 2.0, 5.0, 10.0, 30.0)
LOSS_SCALE = 5e-5


def _cell_shapes(pre: str, cin: int, c: int, links: int, k: int
                 ) -> Dict[str, Tuple[int, ...]]:
    fc = FLOW_CHANNELS
    shapes = {}
    if cin:
        shapes[pre + "i2h.weight"] = (3 * c, cin, k, k)
        shapes[pre + "i2h.bias"] = (3 * c,)
        shapes[pre + "i2f_conv1.weight"] = (fc, cin, FLOW_KERNEL, FLOW_KERNEL)
        shapes[pre + "i2f_conv1.bias"] = (fc,)
    shapes[pre + "h2f_conv1.weight"] = (fc, c, FLOW_KERNEL, FLOW_KERNEL)
    shapes[pre + "h2f_conv1.bias"] = (fc,)
    shapes[pre + "flows_conv.weight"] = (2 * links, fc, FLOW_KERNEL,
                                         FLOW_KERNEL)
    shapes[pre + "flows_conv.bias"] = (2 * links,)
    shapes[pre + "ret.weight"] = (3 * c, links * c, 1, 1)
    shapes[pre + "ret.bias"] = (3 * c,)
    return shapes


def param_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the parameters, in the port's order."""
    hidden, k = model["hidden_dims"], model.get("kernel_size", 3)
    cin0 = model["in_channels"]
    stems, deconvs = model["traj_stems"], model["traj_deconvs"]
    n = len(hidden)
    shapes = {}
    for i in range(n):
        out, sk = stems[i][0], stems[i][1]
        pre = f"encoder.stage{i + 1}.conv{i + 1}_leaky_1."
        shapes[pre + "weight"] = (out, cin0 if i == 0 else hidden[i - 1],
                                  sk, sk)
        shapes[pre + "bias"] = (out,)
        shapes.update(_cell_shapes(f"encoder.rnn{i + 1}.", out, hidden[i],
                                   model["traj_links"][i], k))
    for i in reversed(range(n)):
        cin = 0 if i == n - 1 else deconvs[i + 1][0]
        shapes.update(_cell_shapes(f"forecaster.rnn{i + 1}.", cin, hidden[i],
                                   model["traj_forecast_links"][i], k))
        out, dk = deconvs[i][0], deconvs[i][1]
        pre = f"forecaster.stage{i + 1}."
        shapes[pre + f"deconv{n - i}_leaky_1.weight"] = (hidden[i], out, dk,
                                                         dk)
        shapes[pre + f"deconv{n - i}_leaky_1.bias"] = (out,)
        if i == 0:
            shapes[pre + f"conv{n}_leaky_2.weight"] = (out, out, 3, 3)
            shapes[pre + f"conv{n}_leaky_2.bias"] = (out,)
            shapes[pre + f"conv{n}_3.weight"] = (cin0, out, 1, 1)
            shapes[pre + f"conv{n}_3.bias"] = (cin0,)
    return shapes


def warp(h: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """h [B, C, H, W] sampled bilinearly at (x + u, y + v), flow [B, 2, H,
    W] = (u, v), zero outside the frame."""
    b, _, hgt, wid = h.shape
    xs = torch.arange(wid, dtype=h.dtype, device=h.device).view(1, 1, wid)
    ys = torch.arange(hgt, dtype=h.dtype, device=h.device).view(1, hgt, 1)
    gx = 2.0 * (xs + flow[:, 0]) / (wid - 1) - 1.0
    gy = 2.0 * (ys + flow[:, 1]) / (hgt - 1) - 1.0
    return F.grid_sample(h, torch.stack([gx, gy], dim=-1), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def _conv(params, name, x, stride=1, padding=0):
    return F.conv2d(x, params[name + ".weight"], params[name + ".bias"],
                    stride, padding)


def cell(params: Dict[str, torch.Tensor], pre: str, x, h: torch.Tensor,
         links: int) -> torch.Tensor:
    """One TrajGRU cell-step, NCHW: H_t from ``h`` and the input ``x`` (or
    None)."""
    c = h.shape[1]
    f = _conv(params, pre + "h2f_conv1", h, padding=FLOW_KERNEL // 2)
    if x is not None:
        f = _conv(params, pre + "i2f_conv1", x, padding=FLOW_KERNEL // 2) + f
    flows = _conv(params, pre + "flows_conv", F.leaky_relu(f, SLOPE),
                  padding=FLOW_KERNEL // 2)
    stack = torch.cat([warp(h, flows[:, 2 * l:2 * l + 2])
                       for l in range(links)], dim=1)
    h_r, h_z, h_n = torch.split(_conv(params, pre + "ret", stack), c, dim=1)
    if x is None:
        reset, update = torch.sigmoid(h_r), torch.sigmoid(h_z)
        new = reset * h_n
    else:
        k = params[pre + "i2h.weight"].shape[-1]
        x_r, x_z, x_n = torch.split(
            _conv(params, pre + "i2h", x, padding=k // 2), c, dim=1)
        reset, update = torch.sigmoid(x_r + h_r), torch.sigmoid(x_z + h_z)
        new = x_n + reset * h_n
    return update * h + (1.0 - update) * F.leaky_relu(new, SLOPE)


def forward(params: Dict[str, torch.Tensor], model: dict,
            inputs: torch.Tensor) -> torch.Tensor:
    """The predictions [B, T_out, C, H, W] after ``inputs`` [B, T_in, C, H,
    W]."""
    hidden, stems = model["hidden_dims"], model["traj_stems"]
    deconvs, n = model["traj_deconvs"], len(model["hidden_dims"])
    t_out = model["output_frames"]
    b, t_in = inputs.shape[:2]
    seq = [inputs[:, t] for t in range(t_in)]
    states: List[torch.Tensor] = []
    for i in range(n):
        _, _, s, p = stems[i]
        name = f"encoder.stage{i + 1}.conv{i + 1}_leaky_1"
        seq = [F.leaky_relu(_conv(params, name, x, s, p), SLOPE) for x in seq]
        h = seq[0].new_zeros((b, hidden[i]) + seq[0].shape[2:])
        outs = []
        for x in seq:
            h = cell(params, f"encoder.rnn{i + 1}.", x, h,
                     model["traj_links"][i])
            outs.append(h)
        states.append(h)
        seq = outs
    seq = [None] * t_out
    for i in reversed(range(n)):
        h, outs = states[i], []
        for x in seq:
            h = cell(params, f"forecaster.rnn{i + 1}.", x, h,
                     model["traj_forecast_links"][i])
            outs.append(h)
        _, _, s, p = deconvs[i]
        pre = f"forecaster.stage{i + 1}."
        name = pre + f"deconv{n - i}_leaky_1"
        seq = [F.leaky_relu(F.conv_transpose2d(
            x, params[name + ".weight"], params[name + ".bias"], s, p),
            SLOPE) for x in outs]
    seq = [_conv(params, pre + f"conv{n}_3", F.leaky_relu(
        _conv(params, pre + f"conv{n}_leaky_2", x, 1, 1), SLOPE))
        for x in seq]
    return torch.stack(seq, dim=1)


def rainfall_to_pixel(rate: float) -> float:
    """A rain rate (mm/h) as a pixel value: Z = 58.53 R^1.56, (dBZ + 10) /
    70."""
    return (1.56 * 10.0 * math.log10(rate) + 10.0 * math.log10(58.53)
            + 10.0) / 70.0


def balancing_weights(target: torch.Tensor) -> torch.Tensor:
    """1, 1, 2, 5, 10, 30 by the target's rain rate (module docstring)."""
    w = torch.ones_like(target) * WEIGHTS[0]
    for i, rate in enumerate(THRESHOLDS):
        w = w + (WEIGHTS[i + 1] - WEIGHTS[i]) * (
            target >= rainfall_to_pixel(rate)).float()
    return w


def balanced_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The balanced MSE plus the balanced MAE, times 5e-5."""
    w = balancing_weights(target)
    mse = torch.sum(w * (pred - target) ** 2, (2, 3, 4))
    mae = torch.sum(w * torch.abs(pred - target), (2, 3, 4))
    return LOSS_SCALE * (torch.mean(mse) + torch.mean(mae))


def loss(params: Dict[str, torch.Tensor], model: dict, inputs: torch.Tensor,
         targets: torch.Tensor):
    """(the balanced loss, the predictions)."""
    pred = forward(params, model, inputs)
    return balanced_loss(pred, targets), pred


def train_step(params: Dict[str, torch.Tensor], exp_avg, exp_avg_sq,
               step: int, grads: Dict[str, torch.Tensor], lr: float,
               max_norm: float, betas=(0.9, 0.999), eps: float = 1e-8):
    """The port's update from ``grads``: clip by global norm (scaled by
    max_norm / norm when norm >= max_norm), then bias-corrected Adam.
    Returns (params, exp_avg, exp_avg_sq, clipped grads), new dicts."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    scale = 1.0 if float(norm) < max_norm else max_norm / float(norm)
    t = step + 1
    b1, b2 = betas
    new_p, new_m, new_v, clipped = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k] * scale
        m = b1 * exp_avg[k] + (1 - b1) * g
        v = b2 * exp_avg_sq[k] + (1 - b2) * g.square()
        new_p[k] = p - lr * (m / (1 - b1 ** t)) / (
            (v / (1 - b2 ** t)).sqrt() + eps)
        new_m[k], new_v[k], clipped[k] = m, v, g
    return new_p, new_m, new_v, clipped
