"""Free-running forecaster rollout on the hand-written CUDA kernels.

Counterpart of the JAX package's ``ops/pallas/rollout_kernel.py``. The TPU
kernel there runs the whole rollout in one launch per batch item, with about
9 MB of recurrent state resident in VMEM. A Hopper SM has 227 KB of shared
memory, so that design does not carry over. Here the rollout is a host loop
that launches, per step, K1 (``csrc/convlstm_cell.cu``) once per cell and,
once predictions start, K2 (``csrc/conv_head.cu``) for the head; the state
stays in device memory (and mostly in the 50 MB L2) between launches.

At nowcast_128 (3 cells, 5 frames in, 20 out) a request is 72 K1 and 20 K2
launches. Capturing the loop in a CUDA graph, or one persistent kernel,
would remove the per-launch host cost; that is left to a later change.

The warm-start launch of the TPU kernel (``rollout_pallas_from_state``, run
by ``StreamingForecaster.forecast``) is the same loop seeded from a carried
``(h, c)`` state instead of zeros, with t_in = 1: step 0 feeds the stream's
last emitted frame and the head emits at every step, so a horizon-h forecast
is h x n_cells K1 and h K2 launches. Streaming's ``observe`` runs the loop
too, one step per frame. Three parts of the TPU kernel have no counterpart:
- the 128-lane padding of the packed seeds, a Mosaic tile artifact: each
  cell's state is its own [B,H,W,Ch] tensor here;
- the resident/streamed ``io_mode`` choice, a VMEM budget, and with it the
  streamed-I/O variant (double-buffered frame and output DMAs);
- ``cell_pass_looped``, a traced row-tile loop that bounds Mosaic code size.
The state, frames and outputs already live in device memory between
launches and nvcc's code size does not grow with the frame, so one code
path serves 128 px and 256 px frames alike.

This module holds:
- K2's wrapper ``conv_head_fwd``, its plain version ``conv_head_plain`` and
  its launch count ``conv_head_fwd.launches``;
- ``pack_weights``: the model's state_dict -> the kernels' HWIO layout;
- ``rollout_kernel`` (the counterpart of ``rollout_pallas``) and
  ``rollout_plain``: the same loop through the wrappers or the plain versions;
- ``rollout_kernel_from_state`` (the counterpart of
  ``rollout_pallas_from_state``) and ``rollout_plain_from_state``;
- ``observe_kernel``: streaming's assimilation of new frames on K1 and K2.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..nn import conv2d_nhwc_f32, hwio_from_oihw, oihw_from_hwio
from . import build
from .convlstm_kernel import convlstm_cell_fwd, convlstm_cell_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_P]
_SYMBOLS = {torch.float32: "conv_head_fwd_f32",
            torch.bfloat16: "conv_head_fwd_bf16"}


def conv_head_plain(h, weight, bias, out=None):
    """Plain PyTorch version of K2: SAME conv of h [B,H,W,Cin] with the HWIO
    ``weight`` [K,K,Cin,Cout] and ``bias``, float32 accumulation, result in
    h's dtype. Writes into ``out`` when given and returns it."""
    res = conv2d_nhwc_f32(h, oihw_from_hwio(weight), bias).to(h.dtype)
    if out is None:
        return res
    return out.copy_(res)


def conv_head_fwd(h, weight, bias, out=None):
    """The head conv. h [B,H,W,Cin], weight HWIO [K,K,Cin,Cout] (odd K), bias
    [Cout], one dtype (float32 or bfloat16). Writes [B,H,W,Cout] into ``out``
    (allocated when None; it must not alias ``h``) and returns it."""
    if all(t.device.type == "cpu" for t in (h, weight, bias, out)
           if t is not None):
        return conv_head_plain(h, weight, bias, out)
    b, hgt, wid, cin = h.shape
    k, cout = weight.shape[0], weight.shape[-1]
    if out is None:
        out = torch.empty((b, hgt, wid, cout), dtype=h.dtype, device=h.device)
    tensors = (h, weight, bias, out)
    if any(t.device != h.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("head kernel operands must all lie on one CUDA device")
    if h.dtype not in _SYMBOLS or any(t.dtype != h.dtype for t in tensors):
        raise ValueError("head kernel operands must all be float32 or all "
                         "bfloat16")
    if k % 2 == 0 or weight.shape != (k, k, cin, cout):
        raise ValueError(f"head kernel needs an odd-sized HWIO weight "
                         f"[K, K, {cin}, Cout], got {tuple(weight.shape)}")
    if bias.shape != (cout,) or out.shape != (b, hgt, wid, cout):
        raise ValueError(f"bias must be [{cout}] and out {(b, hgt, wid, cout)}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("head kernel operands must be contiguous")
    if out.data_ptr() == h.data_ptr():
        raise ValueError("out must not alias h")
    fn = build.load_function("conv_head", _SYMBOLS[h.dtype], _ARGTYPES)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), b, hgt, wid, cin, cout, k,
                 stream)
    build.check(err, "conv_head", "conv_head_fwd launch")
    conv_head_fwd.launches += 1
    return out


conv_head_fwd.launches = 0


class RolloutWeights(NamedTuple):
    """Forecaster weights in the kernels' layout and the compute dtype:
    ``cells`` = ((HWIO [K,K,Cin,4Ch], bias [4Ch]), ...) bottom-up, ``head`` =
    (HWIO [3,3,Ch_top,C], bias [C])."""
    cells: tuple
    head: tuple


def pack_weights(state_dict, compute_dtype=torch.bfloat16) -> RolloutWeights:
    """A ConvLSTMForecaster state_dict (``core.cell_<i>.weight`` OIHW, ...)
    -> RolloutWeights. Weights AND biases are cast to the compute dtype, as
    the TPU kernel's ``_pack_weights`` does. Raises on what K1 and K2 do not
    take (an even kernel size)."""
    n = sum(1 for k in state_dict if k.startswith("core.cell_")
            and k.endswith(".weight"))
    if n == 0:
        raise ValueError("state_dict holds no core.cell_<i>.weight entries")

    def conv(prefix):
        w = state_dict[f"{prefix}.weight"]
        if w.shape[-1] % 2 == 0 or w.shape[-1] != w.shape[-2]:
            raise ValueError(f"the CUDA kernels need square odd-sized conv "
                             f"kernels, {prefix} has {tuple(w.shape[-2:])}")
        return (hwio_from_oihw(w).to(compute_dtype).contiguous(),
                state_dict[f"{prefix}.bias"].to(compute_dtype).contiguous())

    return RolloutWeights(tuple(conv(f"core.cell_{i}") for i in range(n)),
                          conv("core.head"))


def _time_major(weights: RolloutWeights, frames, compute_dtype):
    """frames [B,T,C,H,W] -> [T,B,H,W,C] contiguous in the compute dtype,
    after checking C against the first cell's input width."""
    c = frames.shape[2]
    w1 = weights.cells[0][0]
    if w1.shape[2] - w1.shape[3] // 4 != c:
        raise ValueError(f"frames have {c} channels, the first cell takes "
                         f"{w1.shape[2] - w1.shape[3] // 4}")
    return frames.permute(1, 0, 3, 4, 2).to(compute_dtype).contiguous()


def _seeds(weights: RolloutWeights, cells, b, hgt, wid, compute_dtype,
           device):
    """A carried state ((h, c), ...) as the loop's seeds: checked against the
    weights and the frames, contiguous, in the compute dtype (a copy only
    where a tensor is not already so; the loop never writes a seed)."""
    if len(cells) != len(weights.cells):
        raise ValueError(f"{len(cells)} state pairs for "
                         f"{len(weights.cells)} cells")
    seeds = []
    for k, ((h, c), (w, _)) in enumerate(zip(cells, weights.cells)):
        want = (b, hgt, wid, w.shape[-1] // 4)
        if tuple(h.shape) != want or tuple(c.shape) != want:
            raise ValueError(f"cell {k} state must be {want}, got "
                             f"{tuple(h.shape)} and {tuple(c.shape)}")
        seeds.append(tuple(t.to(device, compute_dtype).contiguous()
                           for t in (h, c)))
    return seeds


def _steps(weights: RolloutWeights, fr, steps: int, emit_from: int, seeds,
           cell_fn, head_fn):
    """The per-step loop shared by the cold and warm rollouts and ``observe``.

    fr [T_in,B,H,W,C] holds the frames, time-major NHWC in the compute dtype.
    Step t feeds x = fr[t] while t < T_in, else the head's output of the step
    before. The head runs from step ``emit_from`` (<= T_in - 1) on and writes
    out[t - emit_from]. ``seeds`` ((h, c) per cell) is the state before step
    0 and is only read: each cell writes its h into the other buffer of a
    ping-pong pair of its own (neighbouring blocks read the halo of the h
    they read) and its c into a buffer of its own, in place from step 1 on.
    Returns (out [steps - emit_from,B,H,W,C], the state after the last step:
    ((h, c), ...), none of it aliasing a seed)."""
    t_in, b, hgt, wid, c = fr.shape
    out = torch.empty((steps - emit_from, b, hgt, wid, c), dtype=fr.dtype,
                      device=fr.device)
    state = list(seeds)
    h_bufs = [[torch.empty_like(h) for _ in range(min(steps, 2))]
              for h, _ in seeds]
    c_bufs = [torch.empty_like(c_seed) for _, c_seed in seeds]
    for t in range(steps):
        x = fr[t] if t < t_in else out[t - 1 - emit_from]
        for k, (w, bias) in enumerate(weights.cells):
            h_new = h_bufs[k][t % 2]
            cell_fn(x, *state[k], w, bias, h_new, c_bufs[k])
            state[k] = (h_new, c_bufs[k])
            x = h_new
        if t >= emit_from:
            head_fn(x, weights.head[0], weights.head[1], out[t - emit_from])
    return out, tuple(state)


def _rollout(weights: RolloutWeights, frames, t_out: int, compute_dtype,
             cell_fn, head_fn):
    """Cold rollout: frames [B,T_in,C,H,W] -> [B,t_out,C,H,W] float32 from
    zero state; T_in encode steps, the head from the last of them on."""
    b, t_in, _, hgt, wid = frames.shape
    if t_in < 1 or t_out < 1:
        raise ValueError(f"need t_in >= 1 and t_out >= 1, got {t_in}, {t_out}")
    fr = _time_major(weights, frames, compute_dtype)
    # one zero tensor per cell seeds both h and c: the loop only reads seeds
    zeros = [torch.zeros((b, hgt, wid, w.shape[-1] // 4), dtype=compute_dtype,
                         device=frames.device) for w, _ in weights.cells]
    out, _ = _steps(weights, fr, t_in + t_out - 1, t_in - 1,
                    [(z, z) for z in zeros], cell_fn, head_fn)
    return out.permute(1, 0, 4, 2, 3).float()


def _rollout_from_state(weights: RolloutWeights, cells, prev_out, horizon: int,
                        compute_dtype, cell_fn, head_fn):
    """Warm rollout (t_in = 1): step 0 feeds ``prev_out`` [B,H,W,C] against
    the carried ``cells`` and the head emits at every step."""
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    b, hgt, wid, _ = prev_out.shape
    fr = _time_major(weights, prev_out.permute(0, 3, 1, 2)[:, None],
                     compute_dtype)
    seeds = _seeds(weights, cells, b, hgt, wid, compute_dtype, fr.device)
    out, _ = _steps(weights, fr, horizon, 0, seeds, cell_fn, head_fn)
    return out.permute(1, 0, 4, 2, 3).float()


def rollout_kernel(weights: RolloutWeights, frames, t_out: int,
                   compute_dtype=torch.bfloat16):
    """Free-running rollout through K1 and K2: frames [B,T_in,C,H,W] ->
    [B,t_out,C,H,W] float32, the contract of the JAX ``rollout_pallas``.
    ``weights`` come from ``pack_weights`` in the same ``compute_dtype``."""
    return _rollout(weights, frames, t_out, compute_dtype, convlstm_cell_fwd,
                    conv_head_fwd)


def rollout_plain(weights: RolloutWeights, frames, t_out: int,
                  compute_dtype=torch.bfloat16):
    """The same loop as ``rollout_kernel`` through the plain versions."""
    return _rollout(weights, frames, t_out, compute_dtype, convlstm_cell_plain,
                    conv_head_plain)


def rollout_kernel_from_state(weights: RolloutWeights, cells, prev_out,
                              horizon: int, compute_dtype=torch.bfloat16):
    """Free-running rollout branched from a warm state through K1 and K2,
    the contract of the JAX ``rollout_pallas_from_state``: ``cells`` =
    ((h, c), ...) NHWC [B,H,W,Ch] per cell, ``prev_out`` [B,H,W,C] the last
    emitted frame; returns [B,horizon,C,H,W] float32. horizon x n_cells K1
    launches and horizon K2 launches; the state is not written."""
    return _rollout_from_state(weights, cells, prev_out, horizon,
                               compute_dtype, convlstm_cell_fwd, conv_head_fwd)


def rollout_plain_from_state(weights: RolloutWeights, cells, prev_out,
                             horizon: int, compute_dtype=torch.bfloat16):
    """The same loop as ``rollout_kernel_from_state`` through the plain
    versions."""
    return _rollout_from_state(weights, cells, prev_out, horizon,
                               compute_dtype, convlstm_cell_plain,
                               conv_head_plain)


def observe_kernel(weights: RolloutWeights, cells, frames,
                   compute_dtype=torch.bfloat16):
    """Fold frames [B,T,C,H,W] into the carried ``cells`` through K1 and K2:
    one step per frame (n_cells K1 launches, then K2 for the head). Returns
    (the new cells, prev_out [B,H,W,C] in the compute dtype: the head's
    output at the last frame). The given state is not written."""
    b, t, _, hgt, wid = frames.shape
    if t < 1:
        raise ValueError("observe needs at least one frame")
    fr = _time_major(weights, frames, compute_dtype)
    seeds = _seeds(weights, cells, b, hgt, wid, compute_dtype, fr.device)
    out, state = _steps(weights, fr, t, 0, seeds, convlstm_cell_fwd,
                        conv_head_fwd)
    return state, out[-1]
