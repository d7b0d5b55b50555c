"""Tensor parallelism: the channel-sharded layout of the ConvLSTM cells.

Counterpart of the JAX package's ``parallel/tensor_parallel.py`` (its layout
half; the collectives are ``tp_collectives.py``). A cell's conv emits 4*Ch
channels in gate order i|f|o|g. Under tensor parallelism over a model group
of n ranks, the 4*Ch axis (axis 0 of the OIHW ``weight`` [4Ch, Cin+Ch, K, K],
the only axis of the ``bias`` [4Ch]) is stored permuted shard-major per gate,
[i_0|f_0|o_0|g_0 | i_1|f_1|o_1|g_1 | ...], with Ch/n channels in each block,
so that rank s holds one contiguous block of 4*Ch/n rows (``local_shard``):
the complete i, f, o and g pre-activations of hidden channels
[s*Ch/n, (s+1)*Ch/n). Its gate math is then the canonical one on its own
block, and its (h, c) are those channels.

Checkpoints are always canonical ([i|f|o|g]), so they interchange with
one-process runs and with other model-group sizes: ``tp_permute_state_dict``
converts the cell entries of a state dict or of an Adam state dict (its
``exp_avg`` / ``exp_avg_sq``); ``shard_state_dict`` makes a rank's shards
from a canonical dict, ``canonical_state_dict`` gathers the shards of the
model group back into one.
"""
from __future__ import annotations

import re
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the sharded entries of a forecaster's state dict (a GAN's generator too)
_CELL_KEY = re.compile(r"(^|\.)cell_\d+\.(weight|bias)$")
_MOMENTS = ("exp_avg", "exp_avg_sq")


def is_cell_param(name: str) -> bool:
    """Whether ``name`` is a ConvLSTM cell's weight or bias
    (``core.cell_<i>.weight`` / ``.bias``): the entries TP shards."""
    return _CELL_KEY.search(name) is not None


def _check(ch4: int, n: int) -> int:
    if ch4 % 4 or (ch4 // 4) % n:
        raise ValueError(f"hidden dim {ch4 // 4} not divisible by {n} shards")
    return ch4 // 4


def pergate_permutation(ch: int, n: int) -> np.ndarray:
    """Indices taking the canonical [i|f|o|g] 4*Ch axis to the shard-major
    per-gate layout [i_0|f_0|o_0|g_0 | i_1|...] (Ch/n channels a block)."""
    _check(4 * ch, n)
    per = ch // n
    return np.asarray([g * ch + s * per + j for s in range(n)
                       for g in range(4) for j in range(per)])


def _permute(t: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    perm = pergate_permutation(_check(t.shape[0], n), n)
    if inverse:
        perm = np.argsort(perm)
    return t[torch.from_numpy(perm).to(t.device)]


def shard_cell_params(weight: torch.Tensor, bias: torch.Tensor, n: int):
    """A cell's canonical ``weight`` [4Ch, Cin+Ch, K, K] and ``bias`` [4Ch]
    in the shard-major per-gate layout (the permutation on axis 0)."""
    return _permute(weight, n, False), _permute(bias, n, False)


def unshard_cell_params(weight: torch.Tensor, bias: torch.Tensor, n: int):
    """Inverse of ``shard_cell_params``: back to the canonical layout."""
    return _permute(weight, n, True), _permute(bias, n, True)


def local_shard(t: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous block of 4*Ch/n rows of a permuted 4*Ch
    axis (axis 0)."""
    _check(t.shape[0], n)
    rows = t.shape[0] // n
    return t[rank * rows:(rank + 1) * rows]


def _map_cells(sd: Mapping, fn: Callable[[torch.Tensor], torch.Tensor],
               param_names: Optional[Sequence[str]] = None) -> dict:
    """A copy of ``sd`` with ``fn`` applied to every cell entry: of a module
    state dict, the cell weights and biases; of an optimizer state dict
    (``state`` and ``param_groups``), the Adam moments of the cell
    parameters, whose names in the optimizer's order ``param_names`` gives.
    Every other entry passes through (the same objects)."""
    if "state" in sd and "param_groups" in sd:
        if param_names is None:
            raise ValueError("an optimizer state dict needs param_names (the "
                             "parameters' names in the optimizer's order)")
        state = {}
        for idx, st in sd["state"].items():
            if is_cell_param(param_names[idx]):
                st = {k: fn(v) if k in _MOMENTS else v for k, v in st.items()}
            state[idx] = st
        return {**sd, "state": state}
    return {k: fn(v) if is_cell_param(k) else v for k, v in sd.items()}


def tp_permute_state_dict(sd: Mapping, n: int, inverse: bool = False,
                          param_names: Optional[Sequence[str]] = None) -> dict:
    """Permute every cell weight/bias of a state dict, or the Adam moments of
    those parameters in an optimizer state dict (``param_names``: see
    ``_map_cells``), between the canonical [i|f|o|g] layout and the
    shard-major one (``inverse``: back to canonical). Shapes do not change.
    A width ``n`` does not divide raises (a short permutation would
    silently truncate the axis)."""
    return _map_cells(sd, lambda t: _permute(t, n, inverse), param_names)


def shard_state_dict(sd: Mapping, rank: int, n: int,
                     param_names: Optional[Sequence[str]] = None) -> dict:
    """Rank ``rank``'s state dict (or optimizer state dict) from a canonical
    one: every cell entry permuted, then its local block."""
    return _map_cells(sd, lambda t: local_shard(_permute(t, n, False),
                                                rank, n).clone(), param_names)


def gather_shards(t: torch.Tensor, group) -> torch.Tensor:
    """The model group's shards of a sharded tensor, in rank order along
    axis 0 (the full permuted tensor)."""
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def canonical_state_dict(sd: Mapping, group,
                         param_names: Optional[Sequence[str]] = None) -> dict:
    """The canonical state dict (or optimizer state dict) of the model
    group's shards: every cell entry gathered over ``group`` and permuted
    back. A collective: every rank of the group calls it."""
    n = dist.get_world_size(group)
    return _map_cells(sd, lambda t: _permute(gather_shards(t, group), n, True),
                      param_names)
