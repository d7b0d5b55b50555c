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
- K2's wrapper ``conv_head_fwd``, its plain version ``conv_head_plain``, its
  launch count ``conv_head_fwd.launches`` and ``head_kernel_misfit`` (the
  shapes K2 does not take);
- ``rollout_kernel_misfit``: why K1 and K2 do not take a model at a
  compute dtype (None when they do), a pure function of the config's
  widths, by which ``rollout_impl: auto`` picks the kernels or the plain path
  before any launch;
- ``pack_weights``: the model's state_dict -> the kernels' HWIO layout, and
  on the card each cell's weight packed once for K1 (``kernel_pack``);
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
from .convlstm_kernel import (cell_kernel_misfit, convlstm_cell_fwd,
                             convlstm_cell_plain, kernel_pack)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_P]
_SYMBOLS = {torch.float32: "conv_head_fwd_f32",
            torch.bfloat16: "conv_head_fwd_bf16"}
_TILE = 8               # K2's tile: 8 x 8 pixels
_SMEM_LIMIT = 232448    # shared memory one Hopper block may use (227 KB)


def conv_head_plain(h, weight, bias, out=None):
    """Plain PyTorch version of K2: SAME conv of h [B,H,W,Cin] with the HWIO
    ``weight`` [K,K,Cin,Cout] and ``bias``, float32 accumulation, result in
    h's dtype. Writes into ``out`` when given and returns it."""
    res = conv2d_nhwc_f32(h, oihw_from_hwio(weight), bias).to(h.dtype)
    if out is None:
        return res
    return out.copy_(res)


def head_kernel_misfit(cin: int, cout: int, k: int, dtype):
    """Why K2 of ``dtype`` does not take a KxK head conv of Cin -> Cout
    channels, or None when it does. Each rule is stated here once."""
    if k % 2 == 0:
        return f"K2 needs an odd kernel size, got {k}"
    if dtype not in _SYMBOLS:
        return f"K2 takes float32 or bfloat16, got {dtype}"
    size = 2 if dtype == torch.bfloat16 else 4
    vec = 16 // size
    if cin % vec != 0:
        return (f"K2 in {str(dtype).split('.')[-1]} reads h in 16-byte "
                f"vectors: Cin must be a multiple of {vec}, got {cin}")
    side = _TILE + k - 1
    smem = -(-side * side * cin * size // 16) * 16 + 4 * k * k * cin * cout
    if smem > _SMEM_LIMIT:
        return (f"K2's tile of h and its weights take {smem} bytes of shared "
                f"memory, beyond {_SMEM_LIMIT}")
    return None


def conv_head_fwd(h, weight, bias, out=None):
    """The head conv. h [B,H,W,Cin], weight HWIO [K,K,Cin,Cout] (odd K), bias
    [Cout], one dtype (float32 or bfloat16). Writes [B,H,W,Cout] into ``out``
    (allocated when None; it must not alias ``h``) and returns it. On CUDA
    tensors h must be 16-byte aligned; ``head_kernel_misfit`` states the
    shapes K2 refuses."""
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
    if weight.shape != (k, k, cin, cout):
        raise ValueError(f"head kernel needs a square HWIO weight "
                         f"[K, K, {cin}, Cout], got {tuple(weight.shape)}")
    misfit = head_kernel_misfit(cin, cout, k, h.dtype)
    if misfit:
        raise ValueError(misfit)
    if bias.shape != (cout,) or out.shape != (b, hgt, wid, cout):
        raise ValueError(f"bias must be [{cout}] and out {(b, hgt, wid, cout)}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("head kernel operands must be contiguous")
    if h.data_ptr() % 16:
        raise ValueError("the head kernel reads h by 16-byte copies: h must "
                         "be 16-byte aligned")
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


def rollout_kernel_misfit(hidden_dims, in_channels: int, kernel_size: int,
                          compute_dtype, on_card: bool = True):
    """Why the kernel path cannot serve a forecaster of these widths (cells
    ``hidden_dims`` over ``in_channels``-channel frames, KxK cells, the 3x3
    head) at ``compute_dtype``, or None when it can. The host loop's SAME
    padding needs an odd kernel size everywhere; ``on_card`` adds the rules
    of K1 (``cell_kernel_misfit``) for every cell and of K2
    (``head_kernel_misfit``) for the head, which bind only where the kernels
    launch (on CPU tensors the wrappers run their plain versions)."""
    if kernel_size % 2 == 0:
        return (f"the rollout's SAME padding needs odd-sized conv kernels, "
                f"got {kernel_size}x{kernel_size}")
    if not on_card:
        return None
    cx = in_channels
    for i, ch in enumerate(hidden_dims):
        why = cell_kernel_misfit(cx, ch, kernel_size, compute_dtype)
        if why:
            return f"cell {i} ({cx} -> {ch} channels): {why}"
        cx = ch
    why = head_kernel_misfit(cx, in_channels, 3, compute_dtype)
    return f"head ({cx} -> {in_channels} channels): {why}" if why else None


class RolloutWeights(NamedTuple):
    """Forecaster weights in the kernels' layout and the compute dtype:
    ``cells`` = ((HWIO [K,K,Cin,4Ch], bias [4Ch]), ...) bottom-up, ``head`` =
    (HWIO [3,3,Ch_top,C], bias [C]), ``packed`` = per cell the weight K1
    reads (``kernel_pack``: bfloat16 or float32 layout), or None (weights on
    the CPU, where K1's plain version runs)."""
    cells: tuple
    head: tuple
    packed: tuple


def pack_weights(state_dict, compute_dtype=torch.bfloat16) -> RolloutWeights:
    """A ConvLSTMForecaster state_dict (``core.cell_<i>.weight`` OIHW, ...)
    -> RolloutWeights. Weights AND biases are cast to the compute dtype, as
    the TPU kernel's ``_pack_weights`` does; weights on the card are also
    packed for K1, once here (``packed_for_card``). Raises ValueError naming
    the rule of ``rollout_kernel_misfit`` that the model breaks (on the CPU
    only the odd kernel size binds)."""
    n = sum(1 for k in state_dict if k.startswith("core.cell_")
            and k.endswith(".weight"))
    if n == 0:
        raise ValueError("state_dict holds no core.cell_<i>.weight entries")
    shapes = [tuple(state_dict[f"core.cell_{i}.weight"].shape)
              for i in range(n)]
    sizes = {s[-1] for s in shapes} | {s[-2] for s in shapes}
    if len(sizes) != 1:
        raise ValueError(f"the CUDA kernels need square conv kernels of one "
                         f"size, got {[s[-2:] for s in shapes]}")
    hidden = [s[0] // 4 for s in shapes]
    misfit = rollout_kernel_misfit(hidden, shapes[0][1] - hidden[0],
                                   sizes.pop(), compute_dtype, on_card=False)
    if misfit:
        raise ValueError(f"the CUDA kernels do not take this model: {misfit}")

    def conv(prefix):
        return (hwio_from_oihw(state_dict[f"{prefix}.weight"]).to(
                    compute_dtype).contiguous(),
                state_dict[f"{prefix}.bias"].to(compute_dtype).contiguous())

    weights = RolloutWeights(tuple(conv(f"core.cell_{i}") for i in range(n)),
                             conv("core.head"), (None,) * n)
    on_card = state_dict["core.cell_0.weight"].is_cuda
    return packed_for_card(weights) if on_card else weights


def packed_for_card(weights: RolloutWeights) -> RolloutWeights:
    """``weights`` with K1's packed weight for every cell, on whatever device
    they lie (``kernel_pack`` is a layout transform; ``pack_weights`` on the
    CPU leaves ``packed`` None). Raises ValueError naming the rule of
    ``rollout_kernel_misfit`` on the card that the model breaks, so that
    weights packed here are taken by K1 and K2 wherever they are served."""
    if weights.packed[0] is not None:
        return weights
    dtype = weights.head[0].dtype
    w1 = weights.cells[0][0]
    hidden = [w.shape[-1] // 4 for w, _ in weights.cells]
    misfit = rollout_kernel_misfit(hidden, w1.shape[2] - hidden[0],
                                   w1.shape[0], dtype)
    if misfit:
        raise ValueError(f"the CUDA kernels do not take this model: {misfit}")
    return weights._replace(packed=tuple(kernel_pack(w, dtype)
                                         for w, _ in weights.cells))


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
        for k, ((w, bias), packed) in enumerate(zip(weights.cells,
                                                    weights.packed)):
            h_new = h_bufs[k][t % 2]
            cell_fn(x, *state[k], w, bias, h_new, c_bufs[k], packed=packed)
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
