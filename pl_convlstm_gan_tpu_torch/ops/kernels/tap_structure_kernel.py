"""K3 / K4: the tap-structure experiment's contractions as hand-written CUDA
kernels (``csrc/tap_structure.cu``), each beside its plain PyTorch version.

Counterparts of the TPU kernels of ``experiments/pallas_tap_structure.py``:
``taps_kernel`` (REPS repetitions of the 9 products a9[t] @ w9[t], K = 128
each) and ``big_kernel`` (REPS repetitions of abig @ wbig, K = 9 * 128 =
1152), bf16 operands, float32 accumulation, bf16 output. The source note
says what bounds them and how they are laid out.

- ``tap_loop(a9, w9, reps)`` (K3) and ``tap_k1152(abig, wbig, reps)`` (K4):
  the wrappers; each counts its launches in ``.launches``;
- ``taps_plain`` / ``big_plain``: the plain versions, a float32
  ``torch.matmul`` sum times ``reps``, cast to bf16.

On CUDA tensors a wrapper launches its kernel or raises; it takes the plain
version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

TAPS = 9
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 3 + [_I] * 4 + [_P]
_SOURCE = "tap_structure"
# the kernels' tiling (csrc/tap_structure.cu): 64 x 32 output tiles, k16
# steps, both operand slices of a block in its 232,448 bytes of shared memory
_BM, _BN, _PAD, _MAX_SMEM = 64, 32, 8, 232448


def taps_plain(a9: torch.Tensor, w9: torch.Tensor, reps: int) -> torch.Tensor:
    """bf16(reps * sum_t a9[t] @ w9[t]) with float32 products and sum."""
    return (torch.matmul(a9.float(), w9.float()).sum(0) * reps).to(a9.dtype)


def big_plain(abig: torch.Tensor, wbig: torch.Tensor, reps: int
              ) -> torch.Tensor:
    """bf16(reps * abig @ wbig) with a float32 product."""
    return (torch.matmul(abig.float(), wbig.float()) * reps).to(abig.dtype)


def _check(a, w, m, kt, seg, n, reps):
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"tap kernels take bfloat16, got {a.dtype}, {w.dtype}")
    if a.device != w.device or a.device.type != "cuda":
        raise ValueError("tap kernel operands must lie on one CUDA device")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("tap kernel operands must be contiguous")
    smem = 2 * (_BM + _BN) * (kt + _PAD)
    if (m % _BM or n % _BN or seg % 16 or reps < 0 or smem > _MAX_SMEM):
        raise ValueError(
            f"tap kernels need M % {_BM} == 0, N % {_BN} == 0, a contraction "
            f"segment that is a multiple of 16, reps >= 0 and 2*(M tile + N "
            f"tile)*(9K + {_PAD}) <= {_MAX_SMEM} bytes of shared memory; got "
            f"M {m}, N {n}, segment {seg}, 9K {kt}, reps {reps}")


def _launch(symbol, what, a, w, m, n, ints):
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    fn = build.load_function(_SOURCE, symbol, _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), *ints, stream)
    build.check(err, _SOURCE, what)
    return out


def tap_loop(a9: torch.Tensor, w9: torch.Tensor, reps: int) -> torch.Tensor:
    """K3: a9 [9, M, K], w9 [9, K, N] bf16 -> out [M, N] bf16, reps
    repetitions of the 9 tap products, each added to a float32 accumulator."""
    if a9.device.type == "cpu" and w9.device.type == "cpu":
        return taps_plain(a9, w9, reps)
    taps, m, k = a9.shape
    n = w9.shape[-1]
    if taps != TAPS or tuple(w9.shape) != (TAPS, k, n):
        raise ValueError(f"tap_loop needs a9 [{TAPS}, M, K] and w9 "
                         f"[{TAPS}, K, N], got {tuple(a9.shape)}, "
                         f"{tuple(w9.shape)}")
    _check(a9, w9, m, TAPS * k, k, n, reps)
    out = _launch("tap_loop_bf16", "tap_loop launch", a9, w9, m, n,
                  (m, k, n, reps))
    tap_loop.launches += 1
    return out


def tap_k1152(abig: torch.Tensor, wbig: torch.Tensor, reps: int
              ) -> torch.Tensor:
    """K4: abig [M, KT], wbig [KT, N] bf16 -> out [M, N] bf16, reps
    repetitions of the one product, each added to a float32 accumulator."""
    if abig.device.type == "cpu" and wbig.device.type == "cpu":
        return big_plain(abig, wbig, reps)
    m, kt = abig.shape
    n = wbig.shape[-1]
    if tuple(wbig.shape) != (kt, n):
        raise ValueError(f"tap_k1152 needs abig [M, KT] and wbig [KT, N], "
                         f"got {tuple(abig.shape)}, {tuple(wbig.shape)}")
    _check(abig, wbig, m, kt, kt, n, reps)
    out = _launch("tap_k1152_bf16", "tap_k1152 launch", abig, wbig, m, n,
                  (m, kt, n, reps))
    tap_k1152.launches += 1
    return out


tap_loop.launches = 0
tap_k1152.launches = 0
