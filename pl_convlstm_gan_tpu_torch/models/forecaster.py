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
backward), the port's meaning of the config's ``xla`` and ``pallas``. With
'kernel' on the card each cell's weight is packed for K1 once per forward
pass, not once per step. With gradients and without remat, a kernel cell's
weight is also cast once per pass and its weight gradient computed once,
after the backward of all its steps, as one convolution over them
(``ConvLSTMCell.for_pass``; under remat each step computes its own).

Training on the card (``loss`` with gradients on CUDA tensors) replays CUDA
graphs (``models/loss_graphs.py``, shared with PredRNN): from the second
call at a shape on, the rollout with its loss and the backward to the
parameters' gradients are replayed, so a step no longer waits on the host's
~2,000 launches. Remat and tensor parallelism stay eager.

``remat`` (JAX's ``nn.remat`` over the scan body) runs each step of the
recurrence, the cell stack and the head, under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward keeps
a step's inputs (the frame it reads and the carried (h, c)) and the backward
runs the step again. ``remat_policy`` picks what the step keeps besides:
``""`` nothing; ``"save_z"`` each cell's conv pre-activation (the plain
cell's z, tagged ``ops.convlstm.Z_NAME``; JAX's ``save_only_these_names``),
so the backward recomputes only the gates; ``"dots"`` the output of every
convolution and matrix product (JAX's ``dots_saveable``). K1 is a launch
the dispatcher never sees, so on the kernel path no policy keeps what it
writes: the backward launches K1 with z again for every cell and step, and
``save_z`` is refused there as JAX refuses it for its Pallas cell. The packed
weights are made once per forward pass, outside the checkpointed steps. The
step draws no random numbers, so no RNG state is kept for the recompute.

``tp_group`` (a model group of n ranks; ``parallel/mesh.py``) shards every
cell's channels over the group (``models/layers.ConvLSTMCell``): each cell
carries the full h and this rank's c [..., F/n], and gathers its new h once
a step; the full h goes to the next cell, to the head and to the cell's own
next step. The head stays replicated, so every rank of the group computes
the same predictions. Every hidden width must divide by n.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..losses import l1_loss
from ..ops.convlstm import Z_NAME, current_checkpoint_name
from .layers import Conv2dTorch, ConvLSTMCell
from .loss_graphs import loss_graphs

REMAT_POLICIES = ("", "save_z", "dots")
_aten = torch.ops.aten
# the ops whose outputs "dots" keeps, as jax.checkpoint_policies.dots_saveable
_DOT_OPS = frozenset({_aten.convolution.default, _aten.mm.default,
                      _aten.addmm.default, _aten.bmm.default,
                      _aten.baddbmm.default})


def _keep(policy: str, op) -> bool:
    if policy == "dots":
        return op in _DOT_OPS
    return (op is _aten.convolution.default
            and current_checkpoint_name() == Z_NAME)


def _policy_fn(policy, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if _keep(policy, op)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context_fn(policy: str):
    """``checkpoint``'s ``context_fn`` for a ``remat_policy`` (None for
    ``""``: keep nothing)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"Unknown remat_policy: {policy!r} (valid: "
                         f"{sorted(REMAT_POLICIES)})")
    if not policy:
        return None
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_policy_fn, policy))


class _Core(nn.Module):
    """The per-step modules, named as in the flax tree (``core.cell_<i>``,
    ``core.head``) so that state_dict keys mirror the flax params."""

    def __init__(self, in_channels, hidden_dims, kernel_size, dtype, impl,
                 tp_group=None):
        super().__init__()
        cin = in_channels
        self.n_cells = len(hidden_dims)
        for i, feat in enumerate(hidden_dims):
            self.add_module(f"cell_{i}", ConvLSTMCell(
                cin, feat, kernel_size, impl=impl, dtype=dtype,
                tp_group=tp_group))
            cin = feat
        self.head = Conv2dTorch(cin, in_channels, (3, 3), padding=1,
                                dtype=dtype)

    def cells(self):
        return [getattr(self, f"cell_{i}") for i in range(self.n_cells)]


class ConvLSTMForecaster(nn.Module):
    """frames [B, T_in, C, H, W] -> predictions [B, T_out, C, H, W] float32."""

    loss_name = "L1"            # what ``loss`` computes, for the logs

    def __init__(self, hidden_dims: Sequence[int] = (64, 64, 64),
                 input_frames: int = 5, output_frames: int = 20,
                 in_channels: int = 1, kernel_size: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 convlstm_impl: str = "torch", remat: bool = False,
                 remat_policy: str = "", tp_group=None):
        super().__init__()
        n_tp = 1 if tp_group is None else dist.get_world_size(tp_group)
        bad = [f for f in hidden_dims if f % n_tp]
        if bad:
            raise ValueError(f"hidden_dims {bad} not divisible by the "
                             f"{n_tp} ranks of the model group")
        self.n_tp = n_tp
        context_fn = remat_context_fn(remat_policy)
        if remat and remat_policy == "save_z" and convlstm_impl == "kernel":
            raise ValueError(
                "remat_policy 'save_z' requires the plain cell (convlstm_impl "
                "'xla'/'auto'): K1 writes z outside the dispatcher, so the "
                "policy could keep nothing of it")
        self.remat = remat
        self.remat_policy = remat_policy
        self._remat_kwargs = dict(use_reentrant=False,
                                  preserve_rng_state=False)
        if context_fn is not None:
            self._remat_kwargs["context_fn"] = context_fn
        self.hidden_dims = tuple(hidden_dims)
        self.input_frames = input_frames
        self.output_frames = output_frames
        self.in_channels = in_channels
        self.dtype = dtype
        self.convlstm_impl = convlstm_impl
        self.core = _Core(in_channels, self.hidden_dims, kernel_size, dtype,
                          convlstm_impl, tp_group)

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
        # the full h and this rank's c (all of it without a model group)
        states = [(zeros(f), zeros(f // self.n_tp)) for f in self.hidden_dims]
        prev_out = None       # set by the head at step t_in - 1, read after
        cells = self.core.cells()
        remat = self.remat and torch.is_grad_enabled()
        weights = [cell.for_pass(cdtype, remat) for cell in cells]
        preds = []
        for s in range(steps):
            if s < t_in:
                x = x_seq[s]
            elif teacher_seq is not None:
                use = teacher_draws[s][:, None, None, None]
                x = torch.where(use, teacher_seq[s], prev_out)
            else:
                x = prev_out
            # the head's output is read only from step t_in - 1 on
            with_head = s >= t_in - 1
            flat = [t for st in states for t in st]
            if remat:
                out = checkpoint(self._step, x, weights, with_head, *flat,
                                 **self._remat_kwargs)
            else:
                out = self._step(x, weights, with_head, *flat)
            states = [(out[2 * i], out[2 * i + 1]) for i in range(len(cells))]
            if with_head:
                prev_out = out[-1]
                preds.append(prev_out)
        return torch.stack(preds).permute(1, 0, 4, 2, 3).float()

    def loss(self, inputs: torch.Tensor, targets: torch.Tensor,
             teacher_draws: Optional[torch.Tensor] = None):
        """(L1 of the rollout with scheduled sampling against ``targets``,
        the predictions). With gradients on CUDA tensors, from the second
        call at a shape on, replayed from CUDA graphs
        (``models/loss_graphs.py``)."""
        return loss_graphs(self, list(self.parameters()), self._loss,
                           inputs, targets, teacher_draws)

    def _loss(self, inputs, targets, teacher_draws, weights=None):
        """``loss``, eagerly: on the parameters, or on ``weights`` in
        ``parameters()``'s order in their place (``functional_call``: the
        one forward, on other leaves)."""
        if weights is None:
            pred = self(inputs, targets, teacher_draws)
        else:
            names = [name for name, _ in self.named_parameters()]
            pred = functional_call(self, dict(zip(names, weights)),
                                   (inputs, targets, teacher_draws))
        return l1_loss(pred, targets), pred

    def teacher_probs(self, p: float) -> torch.Tensor:
        """Each scheduled-sampling draw's probability of the true frame at
        teacher-forcing probability ``p``: [steps], p at every step."""
        return torch.full((self.input_frames + self.output_frames - 1,), p)

    def _step(self, x, weights, with_head, *flat):
        """One step of the recurrence, a function of its tensor inputs alone:
        the cells on input x and the carried (h, c) of each cell (``flat``:
        h0, c0, h1, c1, ...), with each cell's weights of the pass
        (``weights``), then, when ``with_head``, the head. Returns the new
        (h, c) of each cell, flattened, and the head's output last."""
        out = []
        for li, cell in enumerate(self.core.cells()):
            h, c = cell(x, flat[2 * li], flat[2 * li + 1],
                        weights=weights[li])
            out += [h, c]
            x = h
        if with_head:
            out.append(self.core.head(x))
        return tuple(out)
