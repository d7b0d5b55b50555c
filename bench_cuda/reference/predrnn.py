"""Plain PyTorch reference of PredRNN-V2, the benchmark's own copy, written
from thuml's public code (github.com/thuml/predrnn-pytorch:
``core/models/predrnn_v2.py``, ``core/layers/SpatioTemporalLSTMCell_v2.py``)
and the paper (Wang et al., TPAMI 2022, arXiv:2103.09504), in float32. It
imports nothing of the program.

Parameters are a dict of float32 OIHW kernels named as the program's state
dict (thuml's names without the ``nn.Sequential``'s ``.0``). Activations
are NCHW, as thuml keeps them. Where it departs from thuml's code:
- frames come as [B, T, C, H, W] and are patched here, thuml's channel
  order (py p + px) C + c;
- the reverse-scheduled-sampling mask is [T - 2, B] bool, one choice a row
  and step (thuml's is a float tensor of ones and zeros, equal over a
  frame), applied with ``torch.where``;
- only the ``layer_norm`` 0 branch (the KTH and Moving MNIST V2 scripts');
- ``q`` rounds every conv's operands and every stored value (h, c, m, the
  deltas, the head's output) as ``convlstm.rounding`` does, for the control
  that computes in a lower precision; ``rounding("f32")`` is none;
- ``train_step`` runs the batch in blocks of ``rows`` rows (the loss is a
  mean over equal blocks of rows, the decoupling term too), then the
  program's clip by global norm and Adam.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .convlstm import Round
from .train import BETAS, EPS, TrainState

CELL_CONVS = ("conv_x", "conv_h", "conv_m", "conv_o", "conv_last")
FORGET_BIAS = 1.0


def param_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    """Names and OIHW shapes of PredRNN-V2's parameters."""
    fw, k, p = model["hidden_dims"][0], model["kernel_size"], \
        model["patch_size"]
    frame_channel = p * p * model["in_channels"]
    shapes = {}
    for i in range(len(model["hidden_dims"])):
        cin = frame_channel if i == 0 else fw
        for name, shape in (("conv_x", (7 * fw, cin, k, k)),
                            ("conv_h", (4 * fw, fw, k, k)),
                            ("conv_m", (3 * fw, fw, k, k)),
                            ("conv_o", (fw, 2 * fw, k, k)),
                            ("conv_last", (fw, 2 * fw, 1, 1))):
            shapes[f"cell_list.{i}.{name}.weight"] = shape
    shapes["conv_last.weight"] = (frame_channel, fw, 1, 1)
    shapes["adapter.weight"] = (fw, fw, 1, 1)
    return shapes


def patch(frames: torch.Tensor, p: int) -> torch.Tensor:
    """[B, T, C, H, W] -> [B, T, p*p*C, H/p, W/p] (thuml's
    ``reshape_patch`` of the NHWC frames, channels first)."""
    b, t, c, hgt, wid = frames.shape
    a = frames.permute(0, 1, 3, 4, 2).reshape(b, t, hgt // p, p, wid // p,
                                               p, c)
    a = a.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, hgt // p, wid // p,
                                               p * p * c)
    return a.permute(0, 1, 4, 2, 3)


def unpatch(x: torch.Tensor, p: int, c: int) -> torch.Tensor:
    """The inverse of ``patch``: [B, T, p*p*C, h, w] -> [B, T, C, h p,
    w p]."""
    b, t, _, hh, ww = x.shape
    a = x.permute(0, 1, 3, 4, 2).reshape(b, t, hh, ww, p, p, c)
    a = a.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, hh * p, ww * p, c)
    return a.permute(0, 1, 4, 2, 3)


def _conv(x, w, q: Round):
    return F.conv2d(q(x), q(w), padding=w.shape[-1] // 2)


def cell(params, i: int, x_t, h_t, c_t, m_t, q: Round):
    """``SpatioTemporalLSTMCell.forward`` (v2, no layer norm): (h_new,
    c_new, m_new, delta_c, delta_m), NCHW, each stored value rounded by
    q."""
    w = {n: params[f"cell_list.{i}.{n}.weight"] for n in CELL_CONVS}
    num_hidden = h_t.shape[1]
    i_x, f_x, g_x, i_xp, f_xp, g_xp, o_x = torch.split(
        _conv(x_t, w["conv_x"], q), num_hidden, dim=1)
    i_h, f_h, g_h, o_h = torch.split(_conv(h_t, w["conv_h"], q), num_hidden,
                                     dim=1)
    i_m, f_m, g_m = torch.split(_conv(m_t, w["conv_m"], q), num_hidden,
                                dim=1)
    i_t = torch.sigmoid(i_x + i_h)
    f_t = torch.sigmoid(f_x + f_h + FORGET_BIAS)
    g_t = torch.tanh(g_x + g_h)
    delta_c = i_t * g_t
    c_new = q(f_t * c_t + delta_c)
    i_tp = torch.sigmoid(i_xp + i_m)
    f_tp = torch.sigmoid(f_xp + f_m + FORGET_BIAS)
    g_tp = torch.tanh(g_xp + g_m)
    delta_m = i_tp * g_tp
    m_new = q(f_tp * m_t + delta_m)
    mem = torch.cat((c_new, m_new), 1)
    o_t = torch.sigmoid(o_x + o_h + _conv(mem, w["conv_o"], q))
    h_new = q(o_t * torch.tanh(_conv(mem, w["conv_last"], q)))
    return h_new, c_new, m_new, q(delta_c), q(delta_m)


def forward(params, model: dict, frames: torch.Tensor,
            mask: Optional[torch.Tensor], q: Round):
    """``RNN.forward`` of ``predrnn_v2.py``: (next_frames [B, T - 1, C, H,
    W], decouple_loss) on frames [B, T, C, H, W], T = input + output
    frames, with ``mask`` [T - 2, B] bool, or None (the input frames, then
    the model's own predictions)."""
    p, n_layers = model["patch_size"], len(model["hidden_dims"])
    t_in = model["input_frames"]
    total = t_in + model["output_frames"]
    net_frames = patch(frames, p)
    b, _, _, hh, ww = net_frames.shape
    num_hidden = model["hidden_dims"][0]
    zeros = torch.zeros(b, num_hidden, hh, ww, device=frames.device)
    h_t, c_t = [zeros] * n_layers, [zeros] * n_layers
    memory = zeros
    adapter = q(params["adapter.weight"])
    next_frames, decouple = [], []
    x_gen = None
    for t in range(total - 1):
        if t == 0:
            net = net_frames[:, 0]
        elif mask is not None:
            net = torch.where(mask[t - 1][:, None, None, None],
                              net_frames[:, t], x_gen)
        else:
            net = net_frames[:, t] if t < t_in else x_gen
        for i in range(n_layers):
            h_t[i], c_t[i], memory, delta_c, delta_m = cell(
                params, i, net if i == 0 else h_t[i - 1], h_t[i], c_t[i],
                memory, q)
            dc = F.normalize(F.conv2d(delta_c, adapter).view(
                b, num_hidden, -1), dim=2)
            dm = F.normalize(F.conv2d(delta_m, adapter).view(
                b, num_hidden, -1), dim=2)
            decouple.append(torch.mean(torch.abs(torch.cosine_similarity(
                dc, dm, dim=2))))
        x_gen = q(F.conv2d(q(h_t[n_layers - 1]),
                           q(params["conv_last.weight"])))
        next_frames.append(x_gen)
    out = unpatch(torch.stack(next_frames, dim=1), p, frames.shape[2])
    return out, torch.mean(torch.stack(decouple))


def loss(params, model: dict, frames: torch.Tensor,
         mask: Optional[torch.Tensor], q: Round) -> torch.Tensor:
    """MSE(next_frames, frames[:, 1:]) + decouple_beta x decouple_loss."""
    next_frames, decouple = forward(params, model, frames, mask, q)
    return F.mse_loss(next_frames, frames[:, 1:]) + \
        model["decouple_beta"] * decouple


def train_step(model: dict, state: TrainState, batch, lr: float,
               max_norm: float, q: Round, rows: Optional[int] = None):
    """One step from ``state`` on batch = (inputs, targets, mask [T - 2,
    B]): (loss, clipped gradients, the state after the step), as
    ``reference.train.train_step`` (clip by global norm, then Adam)."""
    inputs, targets, mask = batch
    frames = torch.cat([inputs, targets], dim=1)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in state.params.items()}
    names = list(params)
    size = frames.shape[0]
    rows = rows or size
    total, grads = 0.0, None
    for lo in range(0, size, rows):
        part = frames[lo:lo + rows]
        block = loss(params, model, part, mask[:, lo:lo + rows], q) * (
            part.shape[0] / size)
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
