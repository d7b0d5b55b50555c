"""Stacked ConvLSTM sequence-to-sequence forecaster (video / radar nowcasting).

Counterpart of the JAX package's ``models/forecaster.py``: N stacked ConvLSTM
cells consume ``input_frames`` frames, then roll out ``output_frames`` future
frames autoregressively through a 3x3 conv head, with optional scheduled
sampling. The JAX scan of ``T_in + T_out - 1`` steps is a Python loop here.

Scheduled sampling takes its Bernoulli draws as an argument
(``teacher_draws``, [steps, B] bool): ``jax.random`` streams cannot be
replayed in torch, so a caller (or a test) supplies the draws.

``convlstm_impl`` picks each cell's step: 'torch' (plain, autograd) or
'kernel' (K1; under autograd ``ConvLSTMCellFn``: K1 writing z and the custom
backward), the port's meaning of the config's ``xla`` and ``pallas``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import Conv2dTorch, ConvLSTMCell


class _Core(nn.Module):
    """The per-step modules, named as in the flax tree (``core.cell_<i>``,
    ``core.head``) so that state_dict keys mirror the flax params."""

    def __init__(self, in_channels, hidden_dims, kernel_size, dtype, impl):
        super().__init__()
        cin = in_channels
        self.n_cells = len(hidden_dims)
        for i, feat in enumerate(hidden_dims):
            self.add_module(f"cell_{i}", ConvLSTMCell(cin, feat, kernel_size,
                                                      impl=impl, dtype=dtype))
            cin = feat
        self.head = Conv2dTorch(cin, in_channels, (3, 3), padding=1,
                                dtype=dtype)

    def cells(self):
        return [getattr(self, f"cell_{i}") for i in range(self.n_cells)]


class ConvLSTMForecaster(nn.Module):
    """frames [B, T_in, C, H, W] -> predictions [B, T_out, C, H, W] float32."""

    def __init__(self, hidden_dims: Sequence[int] = (64, 64, 64),
                 input_frames: int = 5, output_frames: int = 20,
                 in_channels: int = 1, kernel_size: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 convlstm_impl: str = "torch"):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        self.input_frames = input_frames
        self.output_frames = output_frames
        self.in_channels = in_channels
        self.dtype = dtype
        self.convlstm_impl = convlstm_impl
        self.core = _Core(in_channels, self.hidden_dims, kernel_size, dtype,
                          convlstm_impl)

    def forward(self, frames: torch.Tensor, targets: torch.Tensor | None = None,
                teacher_draws: torch.Tensor | None = None) -> torch.Tensor:
        """``targets`` [B, T_out, C, H, W] with ``teacher_draws`` [steps, B]
        bool enable scheduled sampling: at a decode step s whose draw is
        true, the input is the ground truth of the previous frame instead of
        the model's own prediction. At inference leave both unset."""
        b, t_in, c, hgt, wid = frames.shape
        if t_in != self.input_frames:
            raise ValueError(f"expected a {self.input_frames}-frame input "
                             f"window (input_frames), got {t_in}")
        t_out = self.output_frames
        steps = t_in + t_out - 1
        cdtype = self.dtype or frames.dtype
        x_seq = frames.permute(1, 0, 3, 4, 2).to(cdtype)       # [T_in,B,H,W,C]

        teacher_seq = None
        if targets is not None and teacher_draws is not None:
            if tuple(teacher_draws.shape) != (steps, b):
                raise ValueError(f"teacher_draws must be [{steps}, {b}], got "
                                 f"{tuple(teacher_draws.shape)}")
            tgt = targets.permute(1, 0, 3, 4, 2).to(cdtype)
            # Step s emits the prediction of target[s - t_in + 1], so the
            # teacher-forced input at step s is the ground truth of the
            # PREVIOUS frame, target[s - t_in]: t_in leading zeros.
            tpad = torch.zeros((t_in,) + tuple(tgt.shape[1:]), dtype=cdtype,
                               device=frames.device)
            teacher_seq = torch.cat([tpad, tgt], dim=0)[:steps]
            teacher_draws = teacher_draws.to(frames.device)

        zeros = lambda f: torch.zeros((b, hgt, wid, f), dtype=cdtype,
                                      device=frames.device)
        states = [(zeros(f), zeros(f)) for f in self.hidden_dims]
        prev_out = None       # set by the head at step t_in - 1, read after
        cells = self.core.cells()
        preds = []
        for s in range(steps):
            if s < t_in:
                x = x_seq[s]
            elif teacher_seq is not None:
                use = teacher_draws[s][:, None, None, None]
                x = torch.where(use, teacher_seq[s], prev_out)
            else:
                x = prev_out
            for li, cell in enumerate(cells):
                h, cst = cell(x, *states[li])
                states[li] = (h, cst)
                x = h
            # the head's output is read only from step t_in - 1 on
            if s >= t_in - 1:
                prev_out = self.core.head(x)
                preds.append(prev_out)
        return torch.stack(preds).permute(1, 0, 4, 2, 3).float()
