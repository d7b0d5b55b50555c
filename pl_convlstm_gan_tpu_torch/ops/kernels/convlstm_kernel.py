"""K1: the fused ConvLSTM cell step as a hand-written CUDA kernel, and its
custom backward.

Counterpart of the JAX package's ``ops/pallas/convlstm_kernel.py``: the
forward in both its forms (``save_z=False`` for serving, ``save_z=True`` for
training, where the kernel also writes the conv pre-activation ``z``) and the
custom VJP ``convlstm_step_pallas_core`` (``_fwd`` / ``_bwd``). The kernel is
``csrc/convlstm_cell.cu``; its source note says what bounds it and how it is
laid out. Here are its wrapper ``convlstm_cell_fwd``, its plain PyTorch
version ``convlstm_cell_plain``, its launch counts
(``convlstm_cell_fwd.launches`` without ``z``, ``convlstm_cell_fwd.launches_z``
with it) and the operations of those launches (``convlstm_cell_fwd.flops``,
2*B*H*W*K^2*Cin*4Ch a launch, which ``utils.profiling.compiled_cost`` adds to
aten's count), the kernels' weight layouts ``pack_cell_weight`` (bfloat16) and
``pack_cell_weight_f32`` (float32), made once per predictor, stream or
training forward pass, ``cell_kernel_misfit`` (the shapes K1 does not take,
each rule stated once) and ``ConvLSTMCellFn``, the training step as a
``torch.autograd.Function``, whose gate backward is K6
(``csrc/cell_backward.cu``): its wrapper ``cell_backward``, its plain
version ``cell_backward_plain`` and its launch count
(``cell_backward.launches``). ``pass_weight`` gives a cell's weight for one
training forward pass and a ``CellWgrad``, through which that pass's weight
gradient is one convolution over all its steps (``cell_wgrad.calls``: one
a cell and pass, one a step where each step computes its own).

On CUDA tensors the wrappers launch their kernel or raise; they take the
plain version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils import profiling
from ..convlstm import convlstm_gates
from ..nn import conv2d_nhwc_f32, oihw_from_hwio
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 6 + [_P]
_SYMBOLS = {torch.float32: "convlstm_cell_fwd_f32",
            torch.bfloat16: "convlstm_cell_fwd_bf16"}
_BWD_ARGTYPES = [_P] * 13 + [ctypes.c_longlong, _I, _I, _I, _P]
_BWD_SYMBOLS = {torch.float32: "cell_backward_f32",
                torch.bfloat16: "cell_backward_bf16"}
# K6's grid cap, blocks an SM: its partial sums of db have that many rows
_BWD_BLOCKS_PER_SM = 2
BK = 64                 # k-block of the bfloat16 kernel: 64 input channels
_SMEM_LIMIT = 232448    # shared memory one Hopper block may use (227 KB)
_STAGE_BYTES = 128 * BK * 2 + 256 * BK * 2   # A tile + B tile of one k-block
_FOLD_BYTES = 128 * BK * 2                  # one k-block of folded x
F32_CK = 8              # chunk of the float32 kernel: 8 input channels
F32_BN = 128            # packed columns of a float32 block: 32 channels
F32_KERNEL_SIZES = (1, 3, 5)   # the float32 kernel's template instances

profiling.declare("convlstm_cell_fwd.launches", "convlstm_cell_fwd.launches_z",
                  "convlstm_cell_fwd.flops", "cell_backward.launches",
                  "cell_wgrad.calls")


def k_blocks(cx: int, ch: int, k: int):
    """The bfloat16 kernel's k-blocks of 64: (n_fold, n_x, n_h).

    x whose rows are not a multiple of 16 bytes (``cx % 8 != 0``, e.g. the
    1-channel frames of cell 1) cannot be read by TMA; it is folded over all
    K*K taps (tap-major, channel-minor) into ``n_fold`` k-blocks that the
    kernel gathers itself. Otherwise each tap has ``n_x`` k-blocks of x and,
    always, ``n_h`` of h (channels zero-padded to 64)."""
    fold = cx % 8 != 0
    n_fold = -(-(k * k * cx) // BK) if fold else 0
    return n_fold, 0 if fold else -(-cx // BK), -(-ch // BK)


def packed_shape(cx: int, ch: int, k: int):
    """Shape of ``pack_cell_weight``'s result: [4Ch, K_total]."""
    n_fold, n_x, n_h = k_blocks(cx, ch, k)
    return 4 * ch, BK * (n_fold + k * k * (n_x + n_h))


def pack_cell_weight(weight):
    """HWIO [K, K, Cx+Ch, 4Ch] -> the bfloat16 kernel's B operand
    [4Ch, K_total], K-major, in ``weight``'s dtype, not differentiable.

    Rows (GEMM columns) are gate-interleaved in groups of 32: row
    ``32q + 8g + e`` holds gate g (i|f|o|g) of hidden channel ``8q + e``, so a
    thread of the kernel's ``wgmma`` accumulator holds all four gates of its
    (pixel, channel) pairs. K runs over the k-blocks of ``k_blocks``: the
    folded x of every tap first (when ``Cx % 8 != 0``), then per tap (row
    major over (di, dj)) x's channels padded to a multiple of 64 (when x is
    not folded) and h's channels padded to a multiple of 64. Padding is
    zero. Raises ValueError when Ch is not a multiple of 8."""
    k, _, cin, n = weight.shape
    ch = n // 4
    cx = cin - ch
    if ch % 8 != 0 or n != 4 * ch:
        raise ValueError(f"the bfloat16 cell kernel needs Ch a multiple of 8, "
                         f"got weight {tuple(weight.shape)} (Ch {n / 4:g})")
    n_fold, n_x, n_h = k_blocks(cx, ch, k)
    w = weight.detach().reshape(k * k, cin, 4, ch // 8, 8).transpose(2, 3)
    w = w.reshape(k * k, cin, n).permute(2, 0, 1)          # [N, taps, Cin]
    out = weight.new_zeros(packed_shape(cx, ch, k))
    taps = out[:, BK * n_fold:].view(n, k * k, BK * (n_x + n_h))
    if n_fold:
        out[:, :k * k * cx] = w[:, :, :cx].reshape(n, k * k * cx)
    else:
        taps[:, :, :cx] = w[:, :, :cx]
    taps[:, :, BK * n_x:BK * n_x + ch] = w[:, :, cx:]
    return out


def f32_chunks(cx: int, ch: int, k: int):
    """The float32 kernel's chunks of 8 rows: (n_fold, n_x, n_h).

    x whose channels are not a multiple of 8 (e.g. cell 1's 1 channel) is
    folded over all K*K taps (tap-major, channel-minor) into ``n_fold``
    chunks of 8 rows; otherwise x takes ``n_x`` chunks of 8 channels. h
    takes ``n_h`` chunks of 8 channels (zero-padded). A chunk of x or h
    holds the K*K taps' rows of its 8 channels, tap-major."""
    fold = cx % F32_CK != 0
    return (-(-(k * k * cx) // F32_CK) if fold else 0,
            0 if fold else cx // F32_CK, -(-ch // F32_CK))


def packed_shape_f32(cx: int, ch: int, k: int):
    """Shape of ``pack_cell_weight_f32``'s result: [K_rows, N_pad], N_pad =
    4Ch rounded up to whole blocks of 128 columns (32 channels)."""
    n_fold, n_x, n_h = f32_chunks(cx, ch, k)
    return (F32_CK * (n_fold + k * k * (n_x + n_h)),
            F32_BN * -(-4 * ch // F32_BN))


def pack_cell_weight_f32(weight):
    """HWIO [K, K, Cx+Ch, 4Ch] -> the float32 kernel's B operand [K_rows,
    N_pad], K-major, in ``weight``'s dtype, not differentiable.

    Column ``4j + g`` holds gate g (i|f|o|g) of hidden channel j: one
    16-byte load gives a thread all four gates of a channel. Rows run over
    the chunks of ``f32_chunks``: the folded x rows ``tap * Cx + ci`` first
    (when ``Cx % 8 != 0``), then per chunk of 8 channels of x, then of h,
    its K*K taps (row major over (di, dj)) x 8 channels. Padding (rows past
    the folded values or past Ch, columns past 4Ch) is zero. Where nothing
    is padded (Cx and Ch multiples of 8, Ch of 32) it is one permute-copy."""
    k, _, cin, n = weight.shape
    ch = n // 4
    cx = cin - ch
    if n != 4 * ch:
        raise ValueError(f"a cell weight has 4Ch columns, got weight "
                         f"{tuple(weight.shape)}")
    n_fold, n_x, n_h = f32_chunks(cx, ch, k)
    n_pad = packed_shape_f32(cx, ch, k)[1]
    # [taps, Cin, gate, Ch], h's channels zero-padded to whole chunks and Ch
    # to whole blocks of 32
    w = weight.detach().reshape(k * k, cin, 4, ch)
    if n_pad != n or F32_CK * n_h != ch:
        w = F.pad(w, (0, n_pad // 4 - ch, 0, 0, 0, F32_CK * n_h - ch))
    # gate-major columns g*Ch + j -> gate-interleaved 4j + g, chunk-major rows
    chunked = w[:, cx:] if n_fold else w
    body = chunked.reshape(k * k, n_x + n_h, F32_CK, 4, n_pad // 4).permute(
        1, 0, 2, 4, 3).reshape(-1, n_pad)
    if not n_fold:
        return body
    fold = w[:, :cx].permute(0, 1, 3, 2).reshape(k * k * cx, n_pad)
    return torch.cat([F.pad(fold, (0, 0, 0, F32_CK * n_fold - k * k * cx)),
                      body])


def kernel_pack(weight, dtype):
    """The packed weight that K1 of ``dtype`` reads in place of the HWIO
    ``weight``: ``pack_cell_weight`` (bfloat16), ``pack_cell_weight_f32``
    (float32)."""
    return (pack_cell_weight(weight) if dtype == torch.bfloat16
            else pack_cell_weight_f32(weight))


def cell_kernel_misfit(cx: int, ch: int, k: int, dtype):
    """Why K1 of ``dtype`` does not take a cell of Cx input and Ch hidden
    channels with a KxK kernel, or None when it does. Each rule is stated
    here once; the wrapper raises with it and ``rollout_kernel_misfit``
    routes ``rollout_impl: auto`` around it."""
    if k % 2 == 0:
        return f"K1 needs an odd kernel size, got {k}"
    if dtype == torch.float32:
        if k not in F32_KERNEL_SIZES:
            return (f"the float32 K1 takes kernel sizes {F32_KERNEL_SIZES} "
                    f"(two stages of K*K*8 weight rows in shared memory), "
                    f"got {k}")
        return None
    if dtype != torch.bfloat16:
        return f"K1 takes float32 or bfloat16, got {dtype}"
    if ch % 8 != 0:
        return f"the bfloat16 K1 needs Ch a multiple of 8, got Ch {ch}"
    n_fold = k_blocks(cx, ch, k)[0]
    if n_fold and 2 * _STAGE_BYTES + n_fold * _FOLD_BYTES + 2048 > _SMEM_LIMIT:
        return (f"x of {cx} channels folded over {k}x{k} taps takes {n_fold} "
                f"k-blocks; the bfloat16 K1 holds 8")
    return None


def convlstm_cell_plain(x, h, c, weight, bias, h_out=None, c_out=None,
                        z_out=None, packed=None):
    """Plain PyTorch version of K1 with the same arguments and rounding points
    (those of ``ops.convlstm.convlstm_step_torch``): the conv and bias in
    float32, the gates in float32, h' and c' (and z) rounded once to x's
    type. ``weight`` is HWIO [K, K, Cx+Ch, 4Ch]; ``packed`` (the kernel's
    layout of the same weight) is not read. Writes into ``h_out``/``c_out``
    when given (``c_out`` may be ``c``) and z into ``z_out`` when given;
    returns (h', c')."""
    z = conv2d_nhwc_f32(torch.cat([x, h], dim=-1), oihw_from_hwio(weight),
                        bias)
    h_new, c_new = convlstm_gates(z, c.float())
    if z_out is not None:
        z_out.copy_(z)
    h_new, c_new = h_new.to(x.dtype), c_new.to(x.dtype)
    if h_out is None:
        return h_new, c_new
    h_out.copy_(h_new)
    c_out.copy_(c_new)
    return h_out, c_out


def _check_args(x, h, c, weight, bias, h_out, c_out, z_out, packed=None):
    """Raise ValueError on what the kernel of x's dtype does not take: the
    rules of ``cell_kernel_misfit``, then the operands. The kernel reads
    ``packed`` (``kernel_pack(weight, x.dtype)``) in place of ``weight``,
    which it then needs neither contiguous nor one dtype with the rest. The
    packed weight is read by 16-byte copies (float32) or TMA (bfloat16);
    the bfloat16 kernel also reads or writes every operand but ``bias``
    (and x when it is folded) by TMA or 16-byte accesses, so those must be
    16-byte aligned."""
    b, hgt, wid, cx = x.shape
    ch = h.shape[-1]
    k = weight.shape[0]
    if k % 2 == 0 or weight.shape != (k, k, cx + ch, 4 * ch):
        raise ValueError(f"cell kernel needs an odd-sized HWIO weight "
                         f"[K, K, {cx + ch}, {4 * ch}], got {tuple(weight.shape)}")
    misfit = cell_kernel_misfit(cx, ch, k, x.dtype)
    if misfit:
        raise ValueError(misfit)
    if bias.shape != (4 * ch,):
        raise ValueError(f"bias must be [{4 * ch}], got {tuple(bias.shape)}")
    for name, t, shape in (("h", h, (b, hgt, wid, ch)), ("c", c, (b, hgt, wid, ch)),
                           ("h_out", h_out, (b, hgt, wid, ch)),
                           ("c_out", c_out, (b, hgt, wid, ch))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if z_out is not None and tuple(z_out.shape) != (b, hgt, wid, 4 * ch):
        raise ValueError(f"z_out must be {(b, hgt, wid, 4 * ch)}, got "
                         f"{tuple(z_out.shape)}")
    bf16 = x.dtype == torch.bfloat16
    if packed is None:
        raise ValueError("the cell kernel reads the packed weight: pass "
                         "packed=kernel_pack(weight, x.dtype)")
    want = packed_shape(cx, ch, k) if bf16 else packed_shape_f32(cx, ch, k)
    if tuple(packed.shape) != want:
        raise ValueError(f"packed must be {want}, got {tuple(packed.shape)}")
    tensors = (x, h, c, packed, bias, h_out, c_out)
    if z_out is not None:
        if z_out.data_ptr() in {t.data_ptr() for t in tensors}:
            raise ValueError("z_out must not alias another operand")
        tensors += (z_out,)
    if any(t.dtype != x.dtype for t in tensors):
        raise ValueError("cell kernel operands must share one dtype, got "
                         f"{sorted({str(t.dtype) for t in tensors})}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("cell kernel operands must be contiguous")
    if h_out.data_ptr() in (h.data_ptr(), x.data_ptr()):
        raise ValueError("h_out must not alias h or x: neighbours read h's halo")
    aligned = [packed]
    if bf16:
        aligned = [t for t in tensors if t is not bias and
                   (t is not x or cx % 8 == 0)]
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError("the cell kernel needs 16-byte aligned operands (the "
                         "packed weight; in bfloat16 also TMA and 16-byte "
                         "stores)")


def convlstm_cell_fwd(x, h, c, weight, bias, h_out=None, c_out=None,
                      z_out=None, packed=None):
    """One ConvLSTM step. x [B,H,W,Cx], h/c [B,H,W,Ch], weight HWIO
    [K,K,Cx+Ch,4Ch] (odd K), bias [4Ch], all one dtype (float32 or bfloat16).

    Writes h' into ``h_out`` and c' into ``c_out`` (allocated when None;
    ``c_out`` may be ``c`` for an in-place update, ``h_out`` must not alias
    ``h`` or ``x``) and returns (h_out, c_out). With ``z_out``
    [B,H,W,4Ch] (the training form, save_z=True) the kernel also writes the
    pre-activation z there; such launches count in ``launches_z``, the
    others in ``launches``, and each adds its operations to ``flops``. The
    kernel reads ``packed`` (``kernel_pack(weight, x.dtype)``, made here
    when None: callers that launch repeatedly pack once).
    ``cell_kernel_misfit`` states the shapes it refuses."""
    if (h_out is None) != (c_out is None):
        raise ValueError("pass both h_out and c_out, or neither")
    tensors = (x, h, c, weight, bias)
    if all(t.device.type == "cpu" for t in tensors + (h_out, c_out, z_out)
           if t is not None):
        return convlstm_cell_plain(x, h, c, weight, bias, h_out, c_out, z_out)
    if h_out is None:
        h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    if any(t.device != x.device or t.device.type != "cuda"
           for t in tensors + (h_out, c_out, z_out, packed) if t is not None):
        raise ValueError("cell kernel operands must all lie on one CUDA device")
    if x.dtype not in _SYMBOLS:
        raise ValueError(f"cell kernel takes float32 or bfloat16, got {x.dtype}")
    if packed is None:
        packed = kernel_pack(weight, x.dtype)
    _check_args(x, h, c, weight, bias, h_out, c_out, z_out, packed)
    b, hgt, wid, cx = x.shape
    ch, k = h.shape[-1], weight.shape[0]
    build.launch("convlstm_cell", _SYMBOLS[x.dtype], _ARGTYPES, x.device,
                 *(t.data_ptr() for t in (x, h, c, packed, bias, h_out,
                                          c_out)),
                 None if z_out is None else z_out.data_ptr(), b, hgt, wid, cx,
                 ch, k, what="convlstm_cell_fwd launch")
    profiling.count("convlstm_cell_fwd.launches" if z_out is None
                    else "convlstm_cell_fwd.launches_z")
    profiling.count("convlstm_cell_fwd.flops",
                    2 * b * hgt * wid * k * k * (cx + ch) * 4 * ch)
    return h_out, c_out


def cell_backward_plain(z, c, c_next, dh_next, dc_next, x, h, db_dtype):
    """Plain PyTorch version of K6 with the same arguments and outputs: the
    gate algebra of the JAX package's ``_bwd`` as eager ops in float32.
    z [B,H,W,4Ch] (gate-major i|f|o|g, as K1 writes it), c, c' (``c_next``),
    dh', dc' and h [B,H,W,Ch], x [B,H,W,Cx]. Returns (dz [B,H,W,4Ch] float32,
    dc_prev in c's dtype, xh = concat(x, h) [B,H,W,Cx+Ch] float32, db [4Ch]
    in ``db_dtype``): dc_prev and db are rounded once, at the end."""
    i, f, o, g = torch.chunk(z.float(), 4, dim=-1)
    i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), \
        torch.tanh(g)
    tc = torch.tanh(c_next.float())
    dh = dh_next.float()
    dc_tot = dc_next.float() + dh * o * (1.0 - tc * tc)
    do = dh * tc
    df = dc_tot * c.float()
    dc_prev = dc_tot * f
    di = dc_tot * g
    dg = dc_tot * i
    dz = torch.cat([di * i * (1 - i), df * f * (1 - f), do * o * (1 - o),
                    dg * (1 - g * g)], dim=-1)
    xh = torch.cat([x, h], dim=-1).float()
    db = dz.sum(dim=(0, 1, 2)).to(db_dtype)
    return dz, dc_prev.to(c.dtype), xh, db


def _check_backward_args(z, c, c_next, dh_next, dc_next, x, h, db_dtype,
                         one_dtype=True):
    """Raise ValueError on operands K6 does not take: shapes always (x
    [B,H,W,Cx], z [B,H,W,4Ch], the rest [B,H,W,Ch]); with ``one_dtype``
    (the card's rule) also a dtype other than float32 / bfloat16 or shared
    by all operands and ``db_dtype``, and residuals that are not
    contiguous. The incoming gradients may be strided: the wrapper makes
    them contiguous. Written as plain comparisons: the host runs it for
    every call of a train step."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, Cx], got {tuple(x.shape)}")
    b, hgt, wid, _ = x.shape
    ch = c.shape[-1]
    s = (b, hgt, wid, ch)
    for name, t, shape in (("z", z, (b, hgt, wid, 4 * ch)), ("c", c, s),
                           ("c_next", c_next, s), ("dh_next", dh_next, s),
                           ("dc_next", dc_next, s), ("h", h, s)):
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not one_dtype:
        return
    dt = z.dtype
    if dt not in _BWD_SYMBOLS:
        raise ValueError(f"the cell backward takes float32 or bfloat16, got "
                         f"{dt}")
    if not (c.dtype == c_next.dtype == dh_next.dtype == dc_next.dtype
            == x.dtype == h.dtype == db_dtype == dt):
        raise ValueError("the cell backward's operands and db must share one "
                         "dtype, got " + str(sorted(
                             {str(t.dtype) for t in (z, c, c_next, dh_next,
                                                     dc_next, x, h)}
                             | {str(db_dtype)})))
    if not (z.is_contiguous() and c.is_contiguous() and c_next.is_contiguous()
            and x.is_contiguous() and h.is_contiguous()):
        raise ValueError("the cell backward's residuals must be contiguous")


# per (device index, stream, whether the stream is capturing): the
# last-block counter (zero between launches: K6's last block resets it),
# the float32 buffer of partial sums and the grid's cap, used in turn by
# K6's launches on that stream. An eager launch never reads a capture's
# entry, which is made before its capture (reserve_capture_workspace).
_bwd_workspace: dict = {}


def _workspace(device, cols: int):
    """(counter, partials, max_blocks) for a K6 launch of ``cols`` = 4Ch
    columns on ``device``'s current stream: partials holds max_blocks rows
    of them."""
    with build.device_guard(device):
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        capturing = torch.cuda.is_current_stream_capturing()
    key = (device.index, stream, capturing)
    ws = _bwd_workspace.get(key)
    if ws is None or ws[1].numel() < ws[2] * cols:
        if capturing:
            raise RuntimeError(
                "K6 captured into a CUDA graph without a workspace reserved "
                "before the capture (reserve_capture_workspace)")
        blocks = _BWD_BLOCKS_PER_SM * torch.cuda.get_device_properties(
            device).multi_processor_count
        counter = ws[0] if ws is not None else torch.zeros(
            1, dtype=torch.int32, device=device)
        ws = _bwd_workspace[key] = (
            counter, torch.empty(blocks * cols, dtype=torch.float32,
                                 device=device), blocks)
    return ws


def reserve_capture_workspace(device, stream: int):
    """A fresh K6 workspace for the launches captured on ``stream`` (a raw
    stream handle) from now on, as large as the largest eager one on
    ``device`` (a capture replays a call that ran eagerly first); None where
    K6 has not run there. A graph holds its addresses, so the capture's
    owner keeps it as long as the graph: the next reservation for the
    stream replaces the entry."""
    eager = [ws for (index, _, capturing), ws in _bwd_workspace.items()
             if index == device.index and not capturing]
    if not eager:
        return None
    numel = max(ws[1].numel() for ws in eager)
    ws = _bwd_workspace[(device.index, stream, True)] = (
        torch.zeros(1, dtype=torch.int32, device=device),
        torch.empty(numel, dtype=torch.float32, device=device), eager[0][2])
    return ws


def cell_backward(z, c, c_next, dh_next, dc_next, x, h, db_dtype):
    """K6: the cell's gate backward in one launch; ``cell_backward_plain``
    states what it computes and returns (dz, dc_prev, xh, db). On CPU
    tensors it runs that plain version (which also takes mixed dtypes); on
    CUDA tensors it launches the kernel or raises: every operand one dtype
    (float32 or bfloat16, db's too), one device. Each launch counts in
    ``cell_backward.launches``."""
    tensors = (z, c, c_next, dh_next, dc_next, x, h)
    dev = z.device
    if dev.type == "cpu" and all(t.device.type == "cpu" for t in tensors):
        _check_backward_args(*tensors, db_dtype, one_dtype=False)
        return cell_backward_plain(*tensors, db_dtype)
    _check_backward_args(*tensors, db_dtype)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("the cell backward's operands must all lie on one "
                         "CUDA device")
    return _launch_cell_backward(z, c, c_next, *_contiguous(dh_next, dc_next),
                                 x, h, db_dtype)


def _contiguous(dh_next, dc_next):
    """K6's incoming gradients made contiguous where they are not (autograd
    may hand strided ones): the kernel reads them flat."""
    if not dh_next.is_contiguous():
        dh_next = dh_next.contiguous()
    if not dc_next.is_contiguous():
        dc_next = dc_next.contiguous()
    return dh_next, dc_next


def _launch_cell_backward(z, c, c_next, dh_next, dc_next, x, h, db_dtype,
                          dz=None):
    """K6's launch on operands that meet ``cell_backward``'s rules and are
    contiguous, without testing them again: what ``ConvLSTMCellFn.backward``
    holds on the card (its residuals passed K1's checks in the forward, and
    autograd hands it gradients of h' and c' in their shapes and dtype).
    dz goes into the float32 tensor given (a pass's slot,
    ``CellWgrad.slot``); every other output is an allocation of its own: on
    the H100's host one ``torch.empty`` takes ~2 µs, two views of a shared
    buffer ~6 µs."""
    b, hgt, wid, cx = x.shape
    ch = c.shape[-1]
    dev = z.device
    if dz is None:
        dz = torch.empty(z.shape, dtype=torch.float32, device=dev)
    xh = torch.empty((b, hgt, wid, cx + ch), dtype=torch.float32, device=dev)
    dc_prev = torch.empty_like(c)
    db = torch.empty(4 * ch, dtype=db_dtype, device=dev)
    counter, partials, blocks = _workspace(dev, 4 * ch)
    build.launch("cell_backward", _BWD_SYMBOLS[z.dtype], _BWD_ARGTYPES, dev,
                 z.data_ptr(), c.data_ptr(), c_next.data_ptr(),
                 dh_next.data_ptr(), dc_next.data_ptr(), x.data_ptr(),
                 h.data_ptr(), dz.data_ptr(), dc_prev.data_ptr(),
                 xh.data_ptr(), db.data_ptr(), partials.data_ptr(),
                 counter.data_ptr(), b * hgt * wid, cx, ch, blocks,
                 what="cell_backward launch")
    profiling.count("cell_backward.launches")
    return dz, dc_prev, xh, db


def _conv_backward(dz, xh, w32, mask):
    """aten's ``convolution_backward`` of the cell's SAME conv (stride 1,
    padding K // 2) on NHWC dz [N,H,W,4Ch] and xh [N,H,W,Cin] and the
    float32 OIHW weight ``w32``: (d xh in NCHW, dW in OIHW), each None where
    ``mask`` (input, weight) does not ask for it.

    The op of autograd's conv backward and of torch.nn.grad: cuDNN's dgrad
    is the SAME conv of dz with the flipped, in/out-swapped kernel and its
    wgrad the patch correlation of concat(x, h) with dz, the two convs of
    _bwd. Written as a forward F.conv2d of the flipped kernel, the input
    gradient of the (64, 64) cells went to an FFT algorithm that cuDNN's
    heuristics chose, and a nowcast_128 train step took ~14 s on an H100."""
    k = w32.shape[-1]
    dxh, dw, _ = torch.ops.aten.convolution_backward(
        dz.permute(0, 3, 1, 2), xh.permute(0, 3, 1, 2), w32, None, (1, 1),
        (k // 2, k // 2), (1, 1), False, (0, 0), 1, (*mask, False))
    return dxh, dw


class CellWgrad:
    """One kernel cell's weight gradient over one training forward pass,
    computed once: dW = sum over steps t of corr(xh_t, dz_t) is one
    convolution backward over the steps stacked along the batch.

    ``pass_weight`` makes it with the pass's weight. Each ``ConvLSTMCellFn``
    step of the pass takes a slot in the forward (``join``); its backward
    has K6 write dz, float32, into that slot (``slot``), keeps the xh =
    concat(x, h), float32, that K6 writes into a tensor of its own
    (``keep``), and computes no weight gradient of its own. The backward of
    ``pass_weight``'s node, which autograd runs after every step's, stacks
    the kept xh, makes the one call (``weight_grad``) and frees everything.
    The dz slots are allocated by the pass's first backward step, like any
    tensor of the backward (inside a CUDA graph's capture, in its pool):
    B*T*H*W*4Ch*4 bytes a cell, held beside every residual of the forward.
    The xh, B*T*H*W*(Cx + Ch)*4 bytes a cell, are kept one a step while the
    steps' residuals are freed, so they do not add to that peak; stacking
    them costs one copy at the end. The float32 weight that each step's
    input gradient reads is cast once, by that first step, too."""

    def __init__(self):
        self.steps = 0          # the slots: steps that joined in the forward
        self.geometry = None    # (B, H, W, Cx, Ch), one for every step
        self.dz = self.w32 = self.kept = None

    def join(self, x, h) -> int:
        """A slot for a step on x [B,H,W,Cx] and h [B,H,W,Ch]."""
        geometry = (*x.shape, h.shape[-1])
        if self.geometry is None:
            self.geometry = geometry
        elif geometry != self.geometry:
            raise ValueError(f"the steps of one pass share a shape: "
                             f"{geometry} after {self.geometry}")
        self.steps += 1
        return self.steps - 1

    def slot(self, t: int, weight):
        """The float32 dz [B,H,W,4Ch] view of slot ``t``, to be written; the
        first call of a backward allocates the slots and casts ``weight``
        (HWIO) to the float32 OIHW ``w32``."""
        if self.dz is None:
            b, hgt, wid, _, ch = self.geometry
            self.dz = torch.empty((self.steps, b, hgt, wid, 4 * ch),
                                  dtype=torch.float32, device=weight.device)
            self.w32 = oihw_from_hwio(weight).float().contiguous()
            self.kept = [None] * self.steps
        return self.dz[t]

    def keep(self, t: int, xh):
        """Slot ``t``'s float32 xh [B,H,W,Cx+Ch], kept until
        ``weight_grad``."""
        self.kept[t] = xh

    def weight_grad(self):
        """dW (OIHW, float32) over every slot written since the last call,
        or None where none was; frees the slots. A slot that no step's
        backward reached (its outputs did not reach the loss) counts zero."""
        if self.dz is None:
            return None
        n, b, hgt, wid, _ = self.dz.shape
        for t, kept in enumerate(self.kept):
            if kept is None:
                self.dz[t].zero_()
                self.kept[t] = self.dz.new_zeros(
                    (b, hgt, wid, sum(self.geometry[3:])))
        xh = torch.cat(self.kept)
        self.kept = None
        _, dw = _conv_backward(self.dz.view(n * b, hgt, wid, -1),
                               xh.view(n * b, hgt, wid, -1), self.w32,
                               (False, True))
        profiling.count("cell_wgrad.calls")
        self.dz = self.w32 = None
        return dw


class _PassWeight(torch.autograd.Function):
    """apply(weight, dtype, wgrad) -> ``weight`` in ``dtype``: the weight
    every step of a pass reads. Its backward returns ``wgrad``'s one
    weight gradient in the weight's dtype, plus any gradient the pass's
    steps sent back themselves."""

    @staticmethod
    def forward(ctx, weight, dtype, wgrad):
        ctx.set_materialize_grads(False)
        ctx.wgrad, ctx.dtype = wgrad, weight.dtype
        return weight.to(dtype)

    @staticmethod
    def backward(ctx, grad):
        dw = ctx.wgrad.weight_grad()
        if grad is not None:
            dw = grad if dw is None else dw + grad
        return None if dw is None else dw.to(ctx.dtype), None, None


def pass_weight(weight, dtype):
    """(``weight`` in ``dtype``, a fresh ``CellWgrad``) for one training
    forward pass of a kernel cell: hand both to each of the pass's
    ``ConvLSTMCellFn`` steps, and the weight's gradient is computed once,
    after every step's backward, as one convolution over all the steps.
    ``weight`` (OIHW) is cast once a pass, not once a step."""
    wgrad = CellWgrad()
    return _PassWeight.apply(weight, dtype, wgrad), wgrad


class ConvLSTMCellFn(torch.autograd.Function):
    """One training cell step: forward on K1 with ``z`` (save_z=True), the
    hand-written backward of the JAX package's ``convlstm_step_pallas_core``
    (``_fwd`` / ``_bwd``, ``ops/pallas/convlstm_kernel.py:325-388``).

    apply(weight HWIO [K,K,Cx+Ch,4Ch], bias [4Ch], x [B,H,W,Cx], h, c
    [B,H,W,Ch], packed=None, wgrad=None) -> (h', c'). On CUDA tensors the
    forward launches K1 (all operands one dtype; it reads ``packed``, the
    non-differentiable ``kernel_pack(weight, x.dtype)``, made by the caller
    once per forward pass, while ``weight`` itself, which may be a view, is
    kept for the backward); on CPU tensors it runs K1's plain version, which
    also takes mixed dtypes.

    The residuals are those of ``_fwd``: (weight, bias, x, h, c, z, c'). The
    backward's gate algebra is K6 (on CPU tensors its plain version; on the
    card the launch behind ``cell_backward``, without its checks, which K1's
    forward made of the residuals): one launch reads z, c, c', dh', dc', x
    and h and writes dz [B,H,W,4Ch] in float32 (the gates recomputed from
    the stored z in float32, tanh from the stored c'), dc_prev in c's dtype,
    xh = concat(x, h) in float32, and db in the bias's dtype. The convs then
    run in float32 on that dz and xh and a float32 copy of the weight
    (cuDNN on the card, ``_conv_backward``): the input gradient as a SAME
    conv with the spatially flipped, in/out-swapped kernel, and the weight
    gradient as the patch correlation. With ``wgrad`` (``pass_weight``'s,
    ``weight`` being that pass's weight) the step takes a slot of the pass:
    K6 writes dz there, its xh is kept, the float32 weight is the pass's,
    and the weight gradient waits for ``CellWgrad.weight_grad``'s one call over all
    the steps; without it each step computes its own. dx and dh_prev (and a
    step's own dw) are cast to their primals' dtypes only at the end. The
    forward allocates fresh h', c' and z: c is a residual here, so it is
    never updated in place."""

    @staticmethod
    def forward(ctx, weight, bias, x, h, c, packed=None, wgrad=None):
        if weight.shape[0] % 2 == 0:
            raise ValueError(f"the cell's custom backward needs an odd kernel "
                             f"size, got {tuple(weight.shape[:2])}")
        b, hgt, wid, _ = x.shape
        z = torch.empty((b, hgt, wid, 4 * h.shape[-1]), dtype=x.dtype,
                        device=x.device)
        h_next, c_next = convlstm_cell_fwd(x, h, c, weight, bias, z_out=z,
                                           packed=packed)
        ctx.save_for_backward(weight, bias, x, h, c, z, c_next)
        ctx.wgrad = wgrad
        if wgrad is not None:
            ctx.slot = wgrad.join(x, h)
        return h_next, c_next

    @staticmethod
    def backward(ctx, dh_next, dc_next):
        weight, bias, x, h, c, z, c_next = ctx.saved_tensors
        cx = x.shape[-1]
        need_dxh = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        need_dw = ctx.needs_input_grad[0]
        wgrad = ctx.wgrad if need_dw else None
        dz = None
        if wgrad is not None:
            dz = wgrad.slot(ctx.slot, weight)
        if z.device.type == "cuda":
            dz, dc_prev, xh, db = _launch_cell_backward(
                z, c, c_next, *_contiguous(dh_next, dc_next), x, h,
                bias.dtype, dz)
        else:
            outs = cell_backward_plain(z, c, c_next, dh_next, dc_next, x, h,
                                       bias.dtype)
            _, dc_prev, xh, db = outs
            if dz is None:
                dz = outs[0]
            else:
                dz.copy_(outs[0])
        if wgrad is not None:
            wgrad.keep(ctx.slot, xh)
        own_dw = need_dw and wgrad is None
        dx = dh_prev = dw = None
        if need_dxh or own_dw:
            w32 = (wgrad.w32 if wgrad is not None else
                   oihw_from_hwio(weight).float().contiguous())
            dxh, dw = _conv_backward(dz, xh, w32, (need_dxh, own_dw))
        if need_dxh:
            dxh = dxh.permute(0, 2, 3, 1)
            dx = dxh[..., :cx].to(x.dtype)
            dh_prev = dxh[..., cx:].to(h.dtype)
        if own_dw:
            profiling.count("cell_wgrad.calls")
            dw = dw.permute(2, 3, 1, 0).to(weight.dtype)  # OIHW -> HWIO
        return dw, db, dx, dh_prev, dc_prev, None, None
