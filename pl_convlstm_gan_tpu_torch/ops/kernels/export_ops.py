"""The kernel path of serving as registered PyTorch ops, for ``torch.export``.

K1, K2 and K5 are ctypes launches (``build.load_function``), which
``torch.export`` cannot trace. Each rollout of ``rollout_kernel.py`` that
serving runs is therefore registered whole as one functional op
(``torch.library.custom_op``, namespace ``plcg_torch``) with a fake
implementation that gives only the output's shape and type:

- ``plcg_torch::rollout``: ``rollout_kernel``, the counterpart of the JAX
  ``rollout_pallas`` (TPU kernel P3), a cold rollout from zero state;
- ``plcg_torch::rollout_from_state``: ``rollout_kernel_from_state``, the
  counterpart of ``rollout_pallas_from_state`` (P4), a warm rollout from a
  carried state;
- ``plcg_torch::observe``: ``observe_kernel``, streaming's assimilation of
  new frames.

An exported program that holds one of these ops is one node per call, as a
JAX program embeds one Pallas custom call, and keeps everything the eager
kernel path has: the phase table and buffers of ``_steps``, the launch
counts (in bfloat16 one K5 a call; in float32 72 K1 + 20 K2 a nowcast_128
request, 3h K1 + h K2 a ``forecast(h)``), and the choice of K5, K1/K2 or
their plain versions, made before any launch by the model's widths and
dtype (``persistent_misfit``) and the tensors' device (CUDA: the kernels,
which raise on what they refuse; CPU: the plain versions). No op catches an
error of a build or a launch. A program holding these ops is deserialized
only after this module is imported (``serve.load_exported`` imports it).

Each op takes the weights as lists: the cells' HWIO weights, their biases,
K1's packed weights (``kernel_pack``, one per cell, on every device: the
plain versions do not read them, K1 reads nothing else), and the head's
weight and bias, all in the compute dtype, which is the head weight's dtype.
``KernelWeights`` holds a ``RolloutWeights`` as registered buffers, so that
``torch.export`` saves them inside the program, and calls the three ops. It
packs weights that come unpacked (``packed_for_card``, after the card's
rules of ``rollout_kernel_misfit``), so that a program exported on the CPU
is the one exported on the card: it carries K1's packed weights and holds
only a model that K1 and K2 take.
"""
from typing import List

import torch
from torch import nn

from .rollout_kernel import (RolloutWeights, observe_kernel, packed_for_card,
                             rollout_kernel, rollout_kernel_from_state)

NAMESPACE = "plcg_torch"


def _rollout_weights(cell_weights, cell_biases, packed, head_weight,
                     head_bias) -> RolloutWeights:
    n = len(cell_weights)
    if len(cell_biases) != n or len(packed) != n:
        raise ValueError(f"{n} cell weights with {len(cell_biases)} biases "
                         f"and {len(packed)} packed weights")
    return RolloutWeights(tuple(zip(cell_weights, cell_biases)),
                          (head_weight, head_bias), tuple(packed))


def _pairs(flat):
    if len(flat) % 2:
        raise ValueError(f"the state is (h, c) per cell: {len(flat)} tensors")
    return tuple((flat[i], flat[i + 1]) for i in range(0, len(flat), 2))


@torch.library.custom_op(f"{NAMESPACE}::rollout", mutates_args=())
def rollout(frames: torch.Tensor, cell_weights: List[torch.Tensor],
            cell_biases: List[torch.Tensor], packed: List[torch.Tensor],
            head_weight: torch.Tensor, head_bias: torch.Tensor,
            t_out: int) -> torch.Tensor:
    """frames [B,T_in,C,H,W] -> [B,t_out,C,H,W] float32 (``rollout_kernel``)."""
    return rollout_kernel(_rollout_weights(cell_weights, cell_biases, packed,
                                           head_weight, head_bias),
                          frames, t_out, head_weight.dtype)


@rollout.register_fake
def _(frames, cell_weights, cell_biases, packed, head_weight, head_bias,
      t_out):
    b, _, c, hgt, wid = frames.shape
    return frames.new_empty((b, t_out, c, hgt, wid), dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::rollout_from_state", mutates_args=())
def rollout_from_state(cells: List[torch.Tensor], prev_out: torch.Tensor,
                       cell_weights: List[torch.Tensor],
                       cell_biases: List[torch.Tensor],
                       packed: List[torch.Tensor], head_weight: torch.Tensor,
                       head_bias: torch.Tensor,
                       horizon: int) -> torch.Tensor:
    """cells [h0, c0, h1, c1, ...] NHWC and prev_out [B,H,W,C] ->
    [B,horizon,C,H,W] float32 (``rollout_kernel_from_state``)."""
    return rollout_kernel_from_state(
        _rollout_weights(cell_weights, cell_biases, packed, head_weight,
                         head_bias),
        _pairs(cells), prev_out, horizon, head_weight.dtype)


@rollout_from_state.register_fake
def _(cells, prev_out, cell_weights, cell_biases, packed, head_weight,
      head_bias, horizon):
    b, hgt, wid, c = prev_out.shape
    return prev_out.new_empty((b, horizon, c, hgt, wid), dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::observe", mutates_args=())
def observe(cells: List[torch.Tensor], frames: torch.Tensor,
            cell_weights: List[torch.Tensor], cell_biases: List[torch.Tensor],
            packed: List[torch.Tensor], head_weight: torch.Tensor,
            head_bias: torch.Tensor) -> List[torch.Tensor]:
    """cells [h0, c0, ...] and frames [B,T,C,H,W] -> [h0', c0', ...,
    prev_out [B,H,W,C]], in the compute dtype (``observe_kernel``)."""
    state, prev = observe_kernel(
        _rollout_weights(cell_weights, cell_biases, packed, head_weight,
                         head_bias),
        _pairs(cells), frames, head_weight.dtype)
    return [t for pair in state for t in pair] + [prev]


@observe.register_fake
def _(cells, frames, cell_weights, cell_biases, packed, head_weight,
      head_bias):
    b, _, c, hgt, wid = frames.shape
    dtype = head_weight.dtype
    return ([frames.new_empty((b, hgt, wid, w.shape[-1] // 4), dtype=dtype)
             for w in cell_weights for _ in range(2)]
            + [frames.new_empty((b, hgt, wid, c), dtype=dtype)])


class KernelWeights(nn.Module):
    """A ``RolloutWeights`` as buffers (``cell_<i>_weight``, ``_bias``,
    ``_packed``, ``head_weight``, ``head_bias``), packed for K1 on any
    device (``packed_for_card``), and the three ops on them. ``cells`` are
    ((h, c), ...) NHWC in the compute dtype."""

    def __init__(self, weights: RolloutWeights):
        super().__init__()
        weights = packed_for_card(weights)
        self.n_cells = len(weights.cells)
        for i, ((w, b), p) in enumerate(zip(weights.cells, weights.packed)):
            self.register_buffer(f"cell_{i}_weight", w)
            self.register_buffer(f"cell_{i}_bias", b)
            self.register_buffer(f"cell_{i}_packed", p)
        self.register_buffer("head_weight", weights.head[0])
        self.register_buffer("head_bias", weights.head[1])

    def _args(self):
        get = lambda i, part: getattr(self, f"cell_{i}_{part}")
        cells = range(self.n_cells)
        return ([get(i, "weight") for i in cells],
                [get(i, "bias") for i in cells],
                [get(i, "packed") for i in cells],
                self.head_weight, self.head_bias)

    def rollout(self, frames, t_out: int):
        return torch.ops.plcg_torch.rollout(frames, *self._args(), t_out)

    def rollout_from_state(self, cells, prev_out, horizon: int):
        return torch.ops.plcg_torch.rollout_from_state(
            [t for pair in cells for t in pair], prev_out, *self._args(),
            horizon)

    def observe(self, cells, frames):
        """-> (((h, c), ...), prev_out)"""
        out = torch.ops.plcg_torch.observe(
            [t for pair in cells for t in pair], frames, *self._args())
        return _pairs(out[:-1]), out[-1]
