"""Free-running forecaster rollout on the hand-written CUDA kernels.

Counterpart of the JAX package's ``ops/pallas/rollout_kernel.py``. The TPU
kernel there (``_launch_rollout``) runs the whole rollout in one launch per
batch item, with about 9 MB of recurrent state resident in VMEM. A Hopper SM
has 227 KB of shared memory, so the state lives in device memory (and mostly
in the 50 MB L2) here.

Every rollout is one **schedule** (``rollout_schedule``): an int32 table of
phases, one row a phase, cell k at step t or the head at step t, naming
where x comes from (a frame, an output slot of the head, the h of cell
k - 1), which h and c buffers are read and written (the seed, two
ping-pong h buffers a cell, one c buffer a cell) and the output slot. Step t
feeds frame t while t < T_in, else the head's output of the step before;
the head runs from step ``emit_from`` on. Three executors walk the table:
- CPU tensors: the plain versions, ``convlstm_cell_plain`` and
  ``conv_head_plain``, phase by phase (``walk_schedule``);
- float32 on the card: K1 (``csrc/convlstm_cell.cu``) for each cell phase
  and K2 (``csrc/conv_head.cu``) for each head phase, launched from this
  host loop: a nowcast_128 request (3 cells, 5 frames in, 20 out) is 72 K1
  and 20 K2 launches, a ``forecast(h)`` 3h K1 and h K2;
- bfloat16 on the card: **K5** (``csrc/rollout_persistent.cu``), one
  cooperative launch per call that walks the same table on the device, its
  cell phases on K1's bf16 tile body and its head phases on K2's tile, with
  a grid-wide barrier between phases (``rollout_persistent_fwd``; its plain
  version, for CPU tensors, is the walk through the plain versions).
  ``persistent_misfit`` states the models K5 does not take, which keep the
  K1/K2 host loop: a static choice, made before any launch.
The three give the same bits where they share a dtype and device: K5 runs
K1's and K2's arithmetic in their order.

The warm-start launch of the TPU kernel (``rollout_pallas_from_state``, run
by ``StreamingForecaster.forecast``) is the same schedule seeded from a
carried ``(h, c)`` state instead of zeros, with t_in = 1: step 0 feeds the
stream's last emitted frame and the head emits at every step. Streaming's
``observe`` walks it too, one step per frame. Three parts of the TPU kernel
have no counterpart:
- the 128-lane padding of the packed seeds, a Mosaic tile artifact: each
  cell's state is its own [B,H,W,Ch] tensor here;
- the resident/streamed ``io_mode`` choice, a VMEM budget, and with it the
  streamed-I/O variant (double-buffered frame and output DMAs);
- ``cell_pass_looped``, a traced row-tile loop that bounds Mosaic code size.
The state, frames and outputs already live in device memory and nvcc's code
size does not grow with the frame, so one code path serves 128 px and
256 px frames alike.

This module holds:
- K2's wrapper ``conv_head_fwd``, its plain version ``conv_head_plain``, its
  launch count ``conv_head_fwd.launches`` and ``head_kernel_misfit`` (the
  shapes K2 does not take);
- ``rollout_kernel_misfit``: why K1 and K2 do not take a model at a
  compute dtype (None when they do), a pure function of the config's
  widths, by which ``rollout_impl: auto`` picks the kernels or the plain path
  before any launch; ``persistent_misfit``: why K5 does not take it;
- ``rollout_schedule`` and ``walk_schedule``: the phase table and its walk;
- K5's wrapper ``rollout_persistent_fwd`` (``.launches``, ``.flops``, the
  operations it ran, and ``.last_launch``, its grid) and its plain version
  ``rollout_persistent_plain``; ``stamp_phases``, which splits a launch's
  per-phase clock (its ``stamps``) into cell tiles, head tiles and barriers;
- ``pack_weights``: the model's state_dict -> the kernels' HWIO layout, and
  on the card each cell's weight packed once for K1 and K5 (``kernel_pack``);
- ``rollout_kernel`` (the counterpart of ``rollout_pallas``) and
  ``rollout_plain``: the schedule on the kernels or the plain versions;
- ``rollout_kernel_from_state`` (the counterpart of
  ``rollout_pallas_from_state``) and ``rollout_plain_from_state``;
- ``observe_kernel``: streaming's assimilation of new frames.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...utils import profiling
from ..nn import conv2d_nhwc_f32, hwio_from_oihw, oihw_from_hwio
from . import build
from .convlstm_kernel import (cell_kernel_misfit, convlstm_cell_fwd,
                             convlstm_cell_plain, k_blocks, kernel_pack,
                             packed_shape)

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


# The phase table's columns (csrc/rollout_persistent.cu reads them so)
(KIND, CELL, STEP, X_FROM, X_INDEX, H_READ, H_WRITE, C_READ, C_WRITE,
 OUT_SLOT) = range(10)
CELL_PHASE, HEAD_PHASE = 0, 1          # KIND
FROM_FRAME, FROM_OUT, FROM_H = 0, 1, 2  # X_FROM
SEED, PING0, PING1 = 0, 1, 2           # h buffers (H_READ, H_WRITE, X_INDEX)
C_BUF = 1                              # c: SEED or the cell's buffer


def rollout_schedule(n_cells: int, steps: int, emit_from: int, t_in: int):
    """The phases of a rollout of ``steps`` steps through ``n_cells`` cells:
    an int32 tensor [n_phases, 10], one row a phase, in order.

    Step t runs cells 0 .. n_cells - 1, then, from step ``emit_from`` on
    (``emit_from`` <= ``t_in`` - 1), the head, which writes output slot
    t - emit_from. Cell 0 reads frame t while t < ``t_in``, else the output
    slot of the step before; cell k > 0 reads the h that cell k - 1 wrote
    at the same step. A cell row (KIND = CELL_PHASE) names its cell and step,
    x (X_FROM: FROM_FRAME with the frame in X_INDEX, FROM_OUT with the slot,
    or FROM_H with the buffer of cell k - 1's h), the h it reads and writes
    (SEED, PING0, PING1), the c it reads and writes (SEED or C_BUF) and
    OUT_SLOT -1. A head row (KIND = HEAD_PHASE) has CELL = n_cells, reads
    FROM_H buffer X_INDEX of the top cell and writes OUT_SLOT; its h and c
    columns are -1. The rules of the loop it replaces hold: a seed is never
    written; h is written into the ping-pong buffer that the cell does not
    read (neighbouring tiles read the halo of the h they read); c is written
    into the cell's buffer, in place from step 1 on; the state after the
    last step (each cell's last h and c written) aliases no seed."""
    if not (steps >= 1 and 0 <= emit_from < min(t_in, steps)):
        raise ValueError(f"need steps >= 1 and 0 <= emit_from < min(t_in, "
                         f"steps); got steps {steps}, emit_from {emit_from}, "
                         f"t_in {t_in}")
    if n_cells < 1:
        raise ValueError(f"need at least one cell, got {n_cells}")
    rows = []
    for t in range(steps):
        h_write = PING0 + t % 2
        h_read = SEED if t == 0 else PING0 + (t - 1) % 2
        c_read = SEED if t == 0 else C_BUF
        for k in range(n_cells):
            if k > 0:
                x_from, x_index = FROM_H, h_write
            elif t < t_in:
                x_from, x_index = FROM_FRAME, t
            else:
                x_from, x_index = FROM_OUT, t - 1 - emit_from
            rows.append((CELL_PHASE, k, t, x_from, x_index, h_read, h_write,
                         c_read, C_BUF, -1))
        if t >= emit_from:
            rows.append((HEAD_PHASE, n_cells, t, FROM_H, h_write, -1, -1, -1,
                         -1, t - emit_from))
    return torch.tensor(rows, dtype=torch.int32)


def final_buffers(table) -> list:
    """The h buffer (PING0 or PING1) each cell wrote last in ``table``: with
    each cell's c buffer, the state after the rollout."""
    last = {}
    for row in table.tolist():
        if row[KIND] == CELL_PHASE:
            last[row[CELL]] = row[H_WRITE]
    return [last[k] for k in range(len(last))]


def _buffers(fr, seeds, steps: int, emit_from: int):
    """The walk's outputs and state buffers: out [steps - emit_from, B, H,
    W, C], per cell min(steps, 2) ping-pong h buffers and one c buffer."""
    t_in, b, hgt, wid, c = fr.shape
    out = torch.empty((steps - emit_from, b, hgt, wid, c), dtype=fr.dtype,
                      device=fr.device)
    h_bufs = [[torch.empty_like(h) for _ in range(min(steps, 2))]
              for h, _ in seeds]
    c_bufs = [torch.empty_like(c_seed) for _, c_seed in seeds]
    return out, h_bufs, c_bufs


def walk_schedule(table, weights: RolloutWeights, fr, seeds, out, h_bufs,
                  c_bufs, cell_fn, head_fn):
    """Run ``table``'s phases in order through ``cell_fn`` (K1's arguments)
    and ``head_fn`` (K2's), on the frames ``fr`` [T_in,B,H,W,C] and the
    ``seeds`` ((h, c) per cell, only read), into ``out``, ``h_bufs`` and
    ``c_bufs`` (``_buffers``). Returns the state after the last step."""
    h = [[h_seed, *bufs] for (h_seed, _), bufs in zip(seeds, h_bufs)]
    c = [[c_seed, buf] for (_, c_seed), buf in zip(seeds, c_bufs)]
    for row in table.tolist():
        k = row[CELL]
        if row[KIND] == HEAD_PHASE:
            head_fn(h[k - 1][row[X_INDEX]], weights.head[0], weights.head[1],
                    out[row[OUT_SLOT]])
            continue
        x_from, xi = row[X_FROM], row[X_INDEX]
        x = (fr[xi] if x_from == FROM_FRAME else
             out[xi] if x_from == FROM_OUT else h[k - 1][xi])
        (w, bias), packed = weights.cells[k], weights.packed[k]
        cell_fn(x, h[k][row[H_READ]], c[k][row[C_READ]], w, bias,
                h[k][row[H_WRITE]], c[k][row[C_WRITE]], packed=packed)
    return tuple((h[k][i], c[k][C_BUF])
                 for k, i in enumerate(final_buffers(table)))


def _widths(weights: RolloutWeights):
    """(hidden widths, frame channels, kernel size) of the weights."""
    w1 = weights.cells[0][0]
    hidden = tuple(w.shape[-1] // 4 for w, _ in weights.cells)
    return hidden, w1.shape[2] - hidden[0], w1.shape[0]


def _steps(weights: RolloutWeights, fr, steps: int, emit_from: int, seeds,
           cell_fn=None, head_fn=None):
    """The rollout shared by the cold and warm rollouts and ``observe``.

    fr [T_in,B,H,W,C] holds the frames, time-major NHWC in the compute dtype;
    ``seeds`` ((h, c) per cell) is the state before step 0 and is only read.
    The phases are ``rollout_schedule(n_cells, steps, emit_from, T_in)``.
    With ``cell_fn`` / ``head_fn`` they are walked through those (K1/K2 or
    the plain versions); without, on the kernel path: K5 where
    ``persistent_misfit`` admits the model at fr's dtype (one launch on the
    card; its plain version on CPU tensors), else K1/K2 step by step (on CPU
    tensors their plain versions). Returns (out [steps - emit_from,B,H,W,C],
    the state after the last step: ((h, c), ...), none of it aliasing a
    seed)."""
    if cell_fn is None:
        if persistent_misfit(*_widths(weights), fr.dtype) is None:
            return rollout_persistent_fwd(weights, fr, steps, emit_from, seeds)
        cell_fn, head_fn = convlstm_cell_fwd, conv_head_fwd
    table = rollout_schedule(len(weights.cells), steps, emit_from, fr.shape[0])
    out, h_bufs, c_bufs = _buffers(fr, seeds, steps, emit_from)
    state = walk_schedule(table, weights, fr, seeds, out, h_bufs, c_bufs,
                          cell_fn, head_fn)
    return out, state


# K5: its rules and its wrapper
K5_MAX_CELLS = 4        # 4 TMA maps a cell in one 4 KB kernel parameter
_A_BYTES = 128 * 64 * 2                  # one k-block of A (folded x)
_STAGE_BYTES = _A_BYTES + 256 * 64 * 2   # A + B of one ring stage
_K5_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                ctypes.c_void_p] + [ctypes.c_int] * 5 + [
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ctypes.c_void_p]


def _k5_smem(hidden_dims, in_channels: int, kernel_size: int) -> int:
    """K5's shared memory with a ring of 2 stages (its least), as
    ``csrc/rollout_persistent.cu`` lays it out: the ring (which also holds
    each cell tile's epilogue, and the head's tiles where two fit a stage),
    the folded x of cell 0, a scratch region for one tile of a wider head,
    the mbarriers and the alignment slack."""
    n_fold = k_blocks(in_channels, hidden_dims[0], kernel_size)[0]
    top = hidden_dims[-1]
    tile = -(-(-(-10 * 10 * top * 2 // 16) * 16 + 4 * 9 * top * in_channels)
             // 16) * 16                    # a head tile: h and the weights
    rest = 1024 + n_fold * _A_BYTES + 16 * 4 + 2 * _STAGE_BYTES
    return rest if 2 * tile <= _STAGE_BYTES else rest + tile


@functools.lru_cache(maxsize=256)
def _persistent_misfit(hidden_dims: tuple, in_channels: int,
                       kernel_size: int, compute_dtype):
    if compute_dtype != torch.bfloat16:
        return (f"K5 runs bfloat16; {str(compute_dtype).split('.')[-1]} "
                f"takes K1/K2 step by step")
    why = rollout_kernel_misfit(hidden_dims, in_channels, kernel_size,
                                compute_dtype)
    if why:
        return why
    if len(hidden_dims) > K5_MAX_CELLS:
        return (f"K5 passes 4 TMA maps a cell in one kernel parameter, for at "
                f"most {K5_MAX_CELLS} cells; got {len(hidden_dims)}")
    if in_channels % 8 == 0:
        return (f"K5 gathers cell 0's x (the frames and its own predictions) "
                f"folded, which needs frames of a channel count not a "
                f"multiple of 8 (a multiple would need a TMA map a frame and "
                f"output slot); got {in_channels}")
    smem = _k5_smem(hidden_dims, in_channels, kernel_size)
    if smem > _SMEM_LIMIT:
        return (f"K5's ring of 2 stages, folded x and a head tile take "
                f"{smem} bytes of shared memory, beyond {_SMEM_LIMIT}")
    return None


def persistent_misfit(hidden_dims, in_channels: int, kernel_size: int,
                      compute_dtype):
    """Why K5 does not take a forecaster of these widths (cells
    ``hidden_dims`` over ``in_channels``-channel frames, KxK cells, the 3x3
    head) at ``compute_dtype``, or None when it does: the rules of K1 and K2
    on the card (``rollout_kernel_misfit``), then K5's own. A pure function
    of the widths, decided before any launch; a model it refuses keeps the
    K1/K2 host loop."""
    return _persistent_misfit(tuple(hidden_dims), in_channels, kernel_size,
                              compute_dtype)


@functools.lru_cache(maxsize=64)
def _device_table(n_cells: int, steps: int, emit_from: int, t_in: int,
                  device: torch.device):
    """``rollout_schedule``'s table on ``device``, copied there once, and
    ``final_buffers`` of it."""
    table = rollout_schedule(n_cells, steps, emit_from, t_in)
    return table.to(device), final_buffers(table)


def rollout_persistent_plain(weights: RolloutWeights, fr, steps: int,
                             emit_from: int, seeds):
    """K5's plain version: the same schedule walked through
    ``convlstm_cell_plain`` and ``conv_head_plain``; arguments and result
    as ``rollout_persistent_fwd``."""
    table = rollout_schedule(len(weights.cells), steps, emit_from, fr.shape[0])
    out, h_bufs, c_bufs = _buffers(fr, seeds, steps, emit_from)
    state = walk_schedule(table, weights, fr, seeds, out, h_bufs, c_bufs,
                          convlstm_cell_plain, conv_head_plain)
    return out, state


def _check_persistent(weights: RolloutWeights, fr, seeds, widths):
    """Raise ValueError on what K5 does not take: the rules of
    ``persistent_misfit``, then the operands (one CUDA device, bfloat16,
    contiguous, K1's packed weights, 16-byte aligned where K5 reads by TMA
    or 16-byte loads)."""
    misfit = persistent_misfit(*widths, fr.dtype)
    if misfit:
        raise ValueError(f"K5 does not take this model: {misfit}")
    hidden, cin, k = widths
    tensors = [fr, *weights.head, *(t for pair in seeds for t in pair)]
    for (w, bias), packed, (cx, ch) in zip(
            weights.cells, weights.packed, zip((cin,) + hidden, hidden)):
        if tuple(w.shape) != (k, k, cx + ch, 4 * ch) or tuple(bias.shape) != (
                4 * ch,):
            raise ValueError(f"cell weights must be [{k}, {k}, {cx + ch}, "
                             f"{4 * ch}] and [{4 * ch}], got "
                             f"{tuple(w.shape)} and {tuple(bias.shape)}")
        if packed is None or tuple(packed.shape) != packed_shape(cx, ch, k):
            raise ValueError(f"K5 reads K1's packed weights: each cell needs "
                             f"packed={packed_shape(cx, ch, k)} (kernel_pack)")
        tensors += [bias, packed]
    if tuple(weights.head[0].shape) != (3, 3, hidden[-1], cin) or tuple(
            weights.head[1].shape) != (cin,):
        raise ValueError(f"the head must be [3, 3, {hidden[-1]}, {cin}] and "
                         f"[{cin}], got {tuple(weights.head[0].shape)} and "
                         f"{tuple(weights.head[1].shape)}")
    if any(t.device != fr.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("K5's operands must all lie on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError("K5's operands must all be bfloat16")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("K5's operands must be contiguous")
    aligned = [p for p in weights.packed] + [t for pair in seeds for t in pair]
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError("K5 reads the packed weights and the seeds by TMA "
                         "or 16-byte loads: they must be 16-byte aligned")


def rollout_persistent_fwd(weights: RolloutWeights, fr, steps: int,
                           emit_from: int, seeds, stamps=None):
    """K5: the whole rollout of ``_steps`` (same arguments and result) in one
    cooperative launch of ``csrc/rollout_persistent.cu`` on CUDA tensors,
    which must be bfloat16 with K1's packed weights; on CPU tensors its plain
    version ``rollout_persistent_plain``. Each launch adds one to
    ``rollout_persistent_fwd.launches`` and its operations (every cell's
    and head's conv, as ``convlstm_cell_fwd.flops`` counts K1's) to
    ``.flops``; ``.last_launch`` holds the last launch's grid, blocks an SM,
    shared memory, ring stages, SMs and phases. ``persistent_misfit`` states
    the models it refuses. ``stamps``, a CUDA int64 tensor of at least
    1 + 2 x phases elements, makes the launch record block 0's clock
    (%globaltimer, ns) at its start and, for each phase, when its tiles are
    done and when the barrier after them is passed (``stamp_phases`` reads
    them).

    While the program's trace is on (``utils.profiling.tracing``), the
    host's issue, from here to the return of the launch, is the span
    ``plcg.k5.issue``, and a launch given no ``stamps`` records them into a
    buffer of its own that the trace's log keeps on the device
    (``profiling.k5_stamps`` / ``log_k5``; made before the span opens)."""
    if all(t.device.type == "cpu" for t in (fr, weights.head[0], *(
            t for pair in seeds for t in pair))):
        return rollout_persistent_plain(weights, fr, steps, emit_from, seeds)
    logged = None
    if stamps is None and profiling.tracing():
        n_cells = len(weights.cells)
        logged = stamps = profiling.k5_stamps(
            steps * n_cells + steps - emit_from, fr.device)
    with profiling.span("k5.issue"):
        out, state = _launch_persistent(weights, fr, steps, emit_from, seeds,
                                        stamps)
    if logged is not None:
        profiling.log_k5(logged, (n_cells, steps, emit_from, fr.shape[0]))
    return out, state


def _launch_persistent(weights: RolloutWeights, fr, steps: int,
                       emit_from: int, seeds, stamps):
    """``rollout_persistent_fwd``'s launch on CUDA tensors: checks,
    buffers, the launch and its counts."""
    widths = _widths(weights)
    _check_persistent(weights, fr, seeds, widths)
    hidden, cin, k = widths
    n = len(hidden)
    t_in, b, hgt, wid, _ = fr.shape
    table, final = _device_table(n, steps, emit_from, t_in, fr.device)
    out, h_bufs, c_bufs = _buffers(fr, seeds, steps, emit_from)
    ptrs, dims = [], []
    for ((w, bias), packed, (h_seed, c_seed), hb, cb, cx, ch) in zip(
            weights.cells, weights.packed, seeds, h_bufs, c_bufs,
            (cin,) + hidden, hidden):
        ping1 = hb[1] if len(hb) > 1 else hb[0]   # one step: never written
        ptrs += [t.data_ptr() for t in (packed, bias, h_seed, hb[0], ping1,
                                        c_seed, cb)]
        dims += [cx, ch]
    if stamps is not None and (
            stamps.device != fr.device or stamps.dtype != torch.int64 or
            not stamps.is_contiguous() or
            stamps.numel() < 1 + 2 * table.shape[0]):
        raise ValueError(f"stamps must be a contiguous int64 tensor of at "
                         f"least {1 + 2 * table.shape[0]} elements on "
                         f"{fr.device}")
    counter = torch.empty(1, dtype=torch.int32, device=fr.device)
    info = (ctypes.c_int * 5)()
    fn = build.load_function("rollout_persistent", "rollout_persistent_bf16",
                             _K5_ARGTYPES)
    with torch.cuda.device(fr.device):
        stream = torch.cuda.current_stream(fr.device).cuda_stream
        err = fn(table.data_ptr(), table.shape[0], n, fr.data_ptr(),
                 out.data_ptr(), (ctypes.c_void_p * len(ptrs))(*ptrs),
                 (ctypes.c_int * len(dims))(*dims),
                 weights.head[0].data_ptr(), weights.head[1].data_ptr(), b,
                 hgt, wid, cin, k, counter.data_ptr(), info,
                 None if stamps is None else stamps.data_ptr(), stream)
    build.check(err, "rollout_persistent", "rollout_persistent_fwd launch")
    rollout_persistent_fwd.launches += 1
    px = b * hgt * wid
    cell_ops = sum(2 * px * k * k * (cx + ch) * 4 * ch
                   for cx, ch in zip((cin,) + hidden, hidden))
    n_heads = steps - emit_from
    rollout_persistent_fwd.flops += (steps * cell_ops
                                     + n_heads * 2 * px * 9 * hidden[-1] * cin)
    rollout_persistent_fwd.last_launch = dict(
        zip(("grid", "blocks_per_sm", "smem_bytes", "stages", "sms"), info),
        phases=table.shape[0])
    return out, tuple((hb[i - 1], cb) for hb, cb, i in zip(h_bufs, c_bufs,
                                                           final))


rollout_persistent_fwd.launches = 0
rollout_persistent_fwd.flops = 0
rollout_persistent_fwd.last_launch = None


def stamp_phases(stamps, table) -> dict:
    """Block 0's clock of one K5 launch (``rollout_persistent_fwd``'s
    ``stamps``, %globaltimer in ns) split by the phases of its ``table``
    (``rollout_schedule``), in µs: ``total_us`` from block 0's start to its
    exit from the last phase; ``work_us``, by ``cell_<k>`` and ``head`` in
    the table's order, block 0's time in that phase's tiles (from the exit
    of the barrier before it, or the start); ``barrier_us``, from block 0's
    last tile of a phase to its exit from the barrier after it (block 0's
    wait for the slowest block included; no barrier follows the last
    phase, whose work runs to block 0's exit); ``phases`` (by the same
    keys) and ``barriers``, their counts. The work and the barriers sum to
    the total."""
    s = torch.as_tensor(stamps).reshape(-1).tolist()
    rows = torch.as_tensor(table).tolist()
    last = len(rows) - 1
    work, count, barrier = {}, {}, 0
    for ph, row in enumerate(rows):
        key = "head" if row[KIND] == HEAD_PHASE else f"cell_{row[CELL]}"
        done = s[1 + 2 * ph] if ph < last else s[2 + 2 * ph]
        work[key] = work.get(key, 0) + done - s[2 * ph]
        count[key] = count.get(key, 0) + 1
        if ph < last:
            barrier += s[2 + 2 * ph] - s[1 + 2 * ph]
    return dict(total_us=(s[2 + 2 * last] - s[0]) / 1e3,
                work_us={k: v / 1e3 for k, v in work.items()},
                barrier_us=barrier / 1e3, phases=count, barriers=last)


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
    """Free-running rollout on the kernels: frames [B,T_in,C,H,W] ->
    [B,t_out,C,H,W] float32, the contract of the JAX ``rollout_pallas``.
    ``weights`` come from ``pack_weights`` in the same ``compute_dtype``. On
    the card one K5 launch in bfloat16 (where ``persistent_misfit`` admits
    the model), else (T_in + t_out - 1) x n_cells K1 and t_out K2 launches;
    on CPU tensors the plain versions."""
    return _rollout(weights, frames, t_out, compute_dtype, None, None)


def rollout_plain(weights: RolloutWeights, frames, t_out: int,
                  compute_dtype=torch.bfloat16):
    """The same loop as ``rollout_kernel`` through the plain versions."""
    return _rollout(weights, frames, t_out, compute_dtype, convlstm_cell_plain,
                    conv_head_plain)


def rollout_kernel_from_state(weights: RolloutWeights, cells, prev_out,
                              horizon: int, compute_dtype=torch.bfloat16):
    """Free-running rollout branched from a warm state on the kernels,
    the contract of the JAX ``rollout_pallas_from_state``: ``cells`` =
    ((h, c), ...) NHWC [B,H,W,Ch] per cell, ``prev_out`` [B,H,W,C] the last
    emitted frame; returns [B,horizon,C,H,W] float32. One K5 launch in
    bfloat16 (as ``rollout_kernel``), else horizon x n_cells K1 launches and
    horizon K2 launches; the state is not written."""
    return _rollout_from_state(weights, cells, prev_out, horizon,
                               compute_dtype, None, None)


def rollout_plain_from_state(weights: RolloutWeights, cells, prev_out,
                             horizon: int, compute_dtype=torch.bfloat16):
    """The same loop as ``rollout_kernel_from_state`` through the plain
    versions."""
    return _rollout_from_state(weights, cells, prev_out, horizon,
                               compute_dtype, convlstm_cell_plain,
                               conv_head_plain)


def observe_kernel(weights: RolloutWeights, cells, frames,
                   compute_dtype=torch.bfloat16):
    """Fold frames [B,T,C,H,W] into the carried ``cells`` on the kernels: one
    step per frame, the head at every step; one K5 launch in bfloat16 (as
    ``rollout_kernel``), else n_cells K1 and one K2 launch a frame. Returns
    (the new cells, prev_out [B,H,W,C] in the compute dtype: the head's
    output at the last frame). The given state is not written."""
    b, t, _, hgt, wid = frames.shape
    if t < 1:
        raise ValueError("observe needs at least one frame")
    fr = _time_major(weights, frames, compute_dtype)
    seeds = _seeds(weights, cells, b, hgt, wid, compute_dtype, fr.device)
    out, state = _steps(weights, fr, t, 0, seeds)
    return state, out[-1]
