"""Plain PyTorch reference of TrajGRU's encoder-forecaster, the benchmark's
own copy, written from the paper (Shi et al., NeurIPS 2017,
arXiv:1706.03458) and the layout of the HKO-7 benchmark code
(github.com/sxjscience/HKO-7) and its PyTorch port, in float32. It imports
nothing of the program.

A TrajGRU layer with C hidden channels and L links at step t, ``*`` a
convolution, ``s`` the sigmoid and ``f`` a leaky ReLU of slope 0.2:

    U, V  = flows_conv * f(i2f_conv1 * X_t + h2f_conv1 * H_{t-1})
    W_l   = warp(H_{t-1}, u_l, v_l)  (``F.grid_sample``, bilinear,
            align_corners=True, zero padding, at x + u_l, y + v_l)
    S_t   = concat_l W_l
    r, z, n = split(i2h * X_t) + split(ret * S_t)   (order r|z|n)
    R = s(r_x + r_h)   Z = s(z_x + z_h)   H' = f(n_x + R n_h)
    H_t = Z H_{t-1} + (1 - Z) H'

The encoder: at each level from the frames up, a strided conv and a leaky
ReLU (``traj_stems``), then its TrajGRU over the input steps from zero. The
forecaster: from the top level down, each from the encoder's last state of
its level, ``output_frames`` steps; the top layer has no input, a lower one
reads the transposed conv and leaky ReLU (``traj_deconvs``) of the outputs
above; then the bottom's transposed conv, a 3x3 conv, a 1x1 conv. The loss
is HKO-7's balanced MSE plus balanced MAE (weights 1, 1, 2, 5, 10, 30 at
0.5, 2, 5, 10, 30 mm/h, Z = 58.53 R^1.56, pixel (dBZ + 10) / 70), summed
over a frame's pixels, averaged over frames and rows, times 5e-5.

Parameters are a dict of float32 tensors named as the program's state dict.
Activations are NCHW. Where it departs from the HKO-7 code: frames come as
[B, T, C, H, W]; the forecaster's top layer has no ``i2h`` or
``i2f_conv1`` (built and never read there); the flows are used as
``flows_conv`` gives them (that code warps by their negative); no mask.
- ``q`` rounds every conv's operands, the warped stack and every stored
  state (h, the stems' and transposed convs' outputs, the predictions) as
  ``convlstm.rounding`` does, for the control that computes in a lower
  precision; ``rounding("f32")`` is none;
- ``train_step`` runs the batch in blocks of ``rows`` rows (the loss is a
  mean over rows, so the blocks' losses weighted by their share of the
  rows add up to it), then the program's clip by global norm and Adam.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .convlstm import Round
from .train import BETAS, EPS, TrainState

SLOPE = 0.2
FLOW_KERNEL = 5
FLOW_CHANNELS = 32
THRESHOLDS = (0.5, 2.0, 5.0, 10.0, 30.0)
WEIGHTS = (1.0, 1.0, 2.0, 5.0, 10.0, 30.0)
LOSS_SCALE = 5e-5


def _cell_shapes(pre, cin, c, links, k) -> Dict[str, Tuple[int, ...]]:
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
    """Names and shapes of TrajGRU's parameters, in the program's order."""
    hidden, k = model["hidden_dims"], model["kernel_size"]
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
    W], zero outside the frame."""
    b, _, hgt, wid = h.shape
    xs = torch.arange(wid, dtype=h.dtype, device=h.device).view(1, 1, wid)
    ys = torch.arange(hgt, dtype=h.dtype, device=h.device).view(1, hgt, 1)
    gx = 2.0 * (xs + flow[:, 0]) / (wid - 1) - 1.0
    gy = 2.0 * (ys + flow[:, 1]) / (hgt - 1) - 1.0
    return F.grid_sample(h, torch.stack([gx, gy], dim=-1), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def _conv(params, name, x, q: Round, stride=1, padding=0):
    return F.conv2d(q(x), q(params[name + ".weight"]),
                    q(params[name + ".bias"]), stride, padding)


def cell(params, pre: str, x, h: torch.Tensor, links: int, q: Round):
    """One TrajGRU cell-step, NCHW: H_t (rounded by q) from ``h`` and the
    input ``x`` (or None)."""
    c = h.shape[1]
    f = _conv(params, pre + "h2f_conv1", h, q, padding=FLOW_KERNEL // 2)
    if x is not None:
        f = _conv(params, pre + "i2f_conv1", x, q,
                  padding=FLOW_KERNEL // 2) + f
    flows = _conv(params, pre + "flows_conv", F.leaky_relu(f, SLOPE), q,
                  padding=FLOW_KERNEL // 2)
    stack = q(torch.cat([warp(h, flows[:, 2 * l:2 * l + 2])
                         for l in range(links)], dim=1))
    h_r, h_z, h_n = torch.split(_conv(params, pre + "ret", stack, q), c,
                                dim=1)
    if x is None:
        reset, update = torch.sigmoid(h_r), torch.sigmoid(h_z)
        new = reset * h_n
    else:
        k = params[pre + "i2h.weight"].shape[-1]
        x_r, x_z, x_n = torch.split(
            _conv(params, pre + "i2h", x, q, padding=k // 2), c, dim=1)
        reset, update = torch.sigmoid(x_r + h_r), torch.sigmoid(x_z + h_z)
        new = x_n + reset * h_n
    return q(update * h + (1.0 - update) * F.leaky_relu(new, SLOPE))


def forward(params, model: dict, inputs: torch.Tensor, q: Round
            ) -> torch.Tensor:
    """The predictions [B, T_out, C, H, W] after ``inputs`` [B, T_in, C, H,
    W]."""
    hidden, stems = model["hidden_dims"], model["traj_stems"]
    deconvs, n = model["traj_deconvs"], len(model["hidden_dims"])
    b, t_in = inputs.shape[:2]
    seq = [inputs[:, t] for t in range(t_in)]
    states: List[torch.Tensor] = []
    for i in range(n):
        _, _, s, p = stems[i]
        name = f"encoder.stage{i + 1}.conv{i + 1}_leaky_1"
        seq = [q(F.leaky_relu(_conv(params, name, x, q, s, p), SLOPE))
               for x in seq]
        h = seq[0].new_zeros((b, hidden[i]) + seq[0].shape[2:])
        outs = []
        for x in seq:
            h = cell(params, f"encoder.rnn{i + 1}.", x, h,
                     model["traj_links"][i], q)
            outs.append(h)
        states.append(h)
        seq = outs
    seq = [None] * model["output_frames"]
    for i in reversed(range(n)):
        h, outs = states[i], []
        for x in seq:
            h = cell(params, f"forecaster.rnn{i + 1}.", x, h,
                     model["traj_forecast_links"][i], q)
            outs.append(h)
        _, _, s, p = deconvs[i]
        pre = f"forecaster.stage{i + 1}."
        name = pre + f"deconv{n - i}_leaky_1"
        seq = [q(F.leaky_relu(F.conv_transpose2d(
            q(x), q(params[name + ".weight"]), q(params[name + ".bias"]), s,
            p), SLOPE)) for x in outs]
    seq = [q(_conv(params, pre + f"conv{n}_3", q(F.leaky_relu(
        _conv(params, pre + f"conv{n}_leaky_2", x, q, 1, 1), SLOPE)), q))
        for x in seq]
    return torch.stack(seq, dim=1)


def rainfall_to_pixel(rate: float) -> float:
    return (1.56 * 10.0 * math.log10(rate) + 10.0 * math.log10(58.53)
            + 10.0) / 70.0


def balanced_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """HKO-7's balanced MSE plus balanced MAE, times 5e-5."""
    w = torch.ones_like(target) * WEIGHTS[0]
    for i, rate in enumerate(THRESHOLDS):
        w = w + (WEIGHTS[i + 1] - WEIGHTS[i]) * (
            target >= rainfall_to_pixel(rate)).float()
    mse = torch.sum(w * (pred - target) ** 2, (2, 3, 4))
    mae = torch.sum(w * torch.abs(pred - target), (2, 3, 4))
    return LOSS_SCALE * (torch.mean(mse) + torch.mean(mae))


def loss(params, model: dict, inputs: torch.Tensor, targets: torch.Tensor,
         q: Round) -> torch.Tensor:
    return balanced_loss(forward(params, model, inputs, q), targets)


def train_step(model: dict, state: TrainState, batch, lr: float,
               max_norm: float, q: Round, rows: Optional[int] = None):
    """One step from ``state`` on batch = (inputs, targets): (loss, clipped
    gradients, the state after the step), as ``reference.train.train_step``
    (clip by global norm, then Adam)."""
    inputs, targets = batch
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in state.params.items()}
    names = list(params)
    size = inputs.shape[0]
    rows = rows or size
    total, grads = 0.0, None
    for lo in range(0, size, rows):
        part = (inputs[lo:lo + rows], targets[lo:lo + rows])
        block = loss(params, model, *part, q) * (part[0].shape[0] / size)
        g = torch.autograd.grad(block, [params[k] for k in names])
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        total += float(block.detach())
    with torch.no_grad():
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        scale = 1.0 if float(norm) < max_norm else max_norm / float(norm)
        grads = {k: g * scale for k, g in zip(names, grads)}
        t = state.step + 1
        b1, b2 = BETAS
        new = TrainState({}, {}, {}, t)
        for k in names:
            m = b1 * state.exp_avg[k] + (1 - b1) * grads[k]
            v = b2 * state.exp_avg_sq[k] + (1 - b2) * grads[k].square()
            new.params[k] = state.params[k] - lr * (m / (1 - b1 ** t)) / (
                (v / (1 - b2 ** t)).sqrt() + EPS)
            new.exp_avg[k], new.exp_avg_sq[k] = m, v
    return total, grads, new
