"""Plain float32 reference of PredRNN-V2, written from thuml's public code
(github.com/thuml/predrnn-pytorch: ``core/models/predrnn_v2.py``,
``core/layers/SpatioTemporalLSTMCell_v2.py``, ``core/utils/preprocess.py``)
and the paper (Wang et al., TPAMI 2022, arXiv:2103.09504). It imports
nothing of the port's models, ops or kernels.

Parameters are a dict of float32 OIHW kernels under the port's state-dict
names (thuml's without the ``nn.Sequential``'s ``.0``):
``cell_list.<i>.conv_x|conv_h|conv_m|conv_o|conv_last.weight``,
``conv_last.weight``, ``adapter.weight``. Activations are NCHW, as thuml
keeps them.

Where it departs from thuml's code:
- frames come as [B, T, C, H, W] and are patched here (thuml patches NHWC
  numpy batches before the model; the channel order is the same);
- the reverse-scheduled-sampling mask is [T - 2, B] bool, one choice a row
  and step (thuml's is a [B, T - 2, h, w, p^2 C] float tensor of ones and
  zeros, equal over a frame); the input is ``torch.where`` of the two
  frames, which equals thuml's ``mask * frame + (1 - mask) * x_gen``
  wherever both are finite;
- ``mask`` None stands for thuml's test mask: the first ``input_frames``
  frames, then the model's own predictions;
- only the ``layer_norm`` 0 branch (the KTH and Moving MNIST V2 scripts');
- the decoupling term is computed as thuml writes it (each step's and
  layer's ``F.normalize`` of the adapter's output, then
  ``cosine_similarity``), step by step.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

CELL_CONVS = ("conv_x", "conv_h", "conv_m", "conv_o", "conv_last")
FORGET_BIAS = 1.0


def param_shapes(hidden_dims: Sequence[int], in_channels: int,
                 kernel_size: int, patch_size: int
                 ) -> Dict[str, Tuple[int, ...]]:
    """Names and OIHW shapes of the parameters, in the port's order."""
    fw, k = hidden_dims[0], kernel_size
    frame_channel = patch_size * patch_size * in_channels
    shapes = {}
    for i in range(len(hidden_dims)):
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


def reshape_patch(img: torch.Tensor, p: int) -> torch.Tensor:
    """thuml's ``reshape_patch`` on [B, T, H, W, C]: -> [B, T, H/p, W/p,
    p*p*C]."""
    b, t, hgt, wid, c = img.shape
    a = img.reshape(b, t, hgt // p, p, wid // p, p, c)
    return a.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, hgt // p, wid // p,
                                                  p * p * c)


def reshape_patch_back(patch: torch.Tensor, p: int) -> torch.Tensor:
    """thuml's ``reshape_patch_back``: [B, T, h, w, p*p*C] -> [B, T, h p,
    w p, C]."""
    b, t, hh, ww, pc = patch.shape
    c = pc // (p * p)
    a = patch.reshape(b, t, hh, ww, p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
    return a.reshape(b, t, hh * p, ww * p, c)


def _conv(x, w):
    return F.conv2d(x, w, padding=w.shape[-1] // 2)


def cell(params: Dict[str, torch.Tensor], i: int, x_t, h_t, c_t, m_t):
    """``SpatioTemporalLSTMCell.forward`` (v2, no layer norm): (h_new, c_new,
    m_new, delta_c, delta_m), NCHW."""
    w = {n: params[f"cell_list.{i}.{n}.weight"] for n in CELL_CONVS}
    num_hidden = h_t.shape[1]
    x_concat = _conv(x_t, w["conv_x"])
    h_concat = _conv(h_t, w["conv_h"])
    m_concat = _conv(m_t, w["conv_m"])
    i_x, f_x, g_x, i_x_prime, f_x_prime, g_x_prime, o_x = torch.split(
        x_concat, num_hidden, dim=1)
    i_h, f_h, g_h, o_h = torch.split(h_concat, num_hidden, dim=1)
    i_m, f_m, g_m = torch.split(m_concat, num_hidden, dim=1)
    i_t = torch.sigmoid(i_x + i_h)
    f_t = torch.sigmoid(f_x + f_h + FORGET_BIAS)
    g_t = torch.tanh(g_x + g_h)
    delta_c = i_t * g_t
    c_new = f_t * c_t + delta_c
    i_t_prime = torch.sigmoid(i_x_prime + i_m)
    f_t_prime = torch.sigmoid(f_x_prime + f_m + FORGET_BIAS)
    g_t_prime = torch.tanh(g_x_prime + g_m)
    delta_m = i_t_prime * g_t_prime
    m_new = f_t_prime * m_t + delta_m
    mem = torch.cat((c_new, m_new), 1)
    o_t = torch.sigmoid(o_x + o_h + _conv(mem, w["conv_o"]))
    h_new = o_t * torch.tanh(_conv(mem, w["conv_last"]))
    return h_new, c_new, m_new, delta_c, delta_m


def forward(params: Dict[str, torch.Tensor], num_layers: int,
            input_frames: int, total_length: int, patch_size: int,
            frames: torch.Tensor, mask: Optional[torch.Tensor] = None,
            zigzag: bool = True):
    """``RNN.forward`` of ``predrnn_v2.py``: (next_frames [B, total_length -
    1, C, H, W], decouple_loss). ``frames`` [B, T, C, H, W] (T >=
    total_length with a mask, else at least ``input_frames``); ``mask``
    [total_length - 2, B] bool or None (the test mask). ``zigzag`` False
    starts every step's layer 0 from a zero memory (a fault the tests
    plant)."""
    b, _, c, hgt, wid = frames.shape
    net_frames = reshape_patch(frames.permute(0, 1, 3, 4, 2), patch_size
                               ).permute(0, 1, 4, 2, 3)   # [B, T, pC, h, w]
    num_hidden = params["adapter.weight"].shape[0]
    zeros = torch.zeros(b, num_hidden, hgt // patch_size, wid // patch_size,
                        device=frames.device)
    h_t, c_t = [zeros] * num_layers, [zeros] * num_layers
    delta_c_list, delta_m_list = [zeros] * num_layers, [zeros] * num_layers
    memory = zeros
    adapter = params["adapter.weight"]
    next_frames: List[torch.Tensor] = []
    decouple_loss = []
    x_gen = None
    for t in range(total_length - 1):
        if t == 0:
            net = net_frames[:, 0]
        elif mask is not None:
            net = torch.where(mask[t - 1].to(frames.device)[:, None, None,
                                                              None],
                              net_frames[:, t], x_gen)
        else:
            net = net_frames[:, t] if t < input_frames else x_gen
        if not zigzag:
            memory = zeros
        for i in range(num_layers):
            h_t[i], c_t[i], memory, delta_c, delta_m = cell(
                params, i, net if i == 0 else h_t[i - 1], h_t[i], c_t[i],
                memory)
            delta_c_list[i] = F.normalize(
                F.conv2d(delta_c, adapter).view(b, num_hidden, -1), dim=2)
            delta_m_list[i] = F.normalize(
                F.conv2d(delta_m, adapter).view(b, num_hidden, -1), dim=2)
        x_gen = F.conv2d(h_t[num_layers - 1], params["conv_last.weight"])
        next_frames.append(x_gen)
        for i in range(num_layers):
            decouple_loss.append(torch.mean(torch.abs(torch.cosine_similarity(
                delta_c_list[i], delta_m_list[i], dim=2))))
    decouple = torch.mean(torch.stack(decouple_loss, dim=0))
    out = torch.stack(next_frames, dim=1).permute(0, 1, 3, 4, 2)
    out = reshape_patch_back(out, patch_size).permute(0, 1, 4, 2, 3)
    return out, decouple


def loss(params: Dict[str, torch.Tensor], num_layers: int,
         input_frames: int, total_length: int, patch_size: int,
         decouple_beta: float, frames: torch.Tensor,
         mask: Optional[torch.Tensor] = None, zigzag: bool = True):
    """thuml's training loss: MSE(next_frames, frames[:, 1:]) +
    decouple_beta x decouple_loss; (loss, next_frames)."""
    next_frames, decouple = forward(params, num_layers, input_frames,
                                    total_length, patch_size, frames, mask,
                                    zigzag)
    mse = F.mse_loss(next_frames, frames[:, 1:total_length])
    return mse + decouple_beta * decouple, next_frames


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
