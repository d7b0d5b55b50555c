"""int8 post-training quantization primitives for the serving path.

Counterpart of the JAX package's ``ops/quant.py``: symmetric
(zero-point-free) quantization, int8 weights with one scale per output
channel, int8 activations with a per-tensor or per-sample scale, and an int8
conv that accumulates exactly in int32.

The port keeps conv weights OIHW (``[Cout, Cin, Kh, Kw]``) and activations
NHWC, so the per-output-channel absmax runs over axes (1, 2, 3).
``torch.round`` rounds half to even, as ``jnp.round`` does.

``conv2d_int8`` is an im2col of the int8 input followed by ``torch._int_mm``
(s8 x s8 -> s32; cuBLASLt on the card, an exact integer product on the CPU).
A float conv would not do: a 3x3 conv over 128 channels sums 1152 products
of up to 127^2, past float32's 2^24 of exact integers. JAX computes its int8
conv in XLA, outside any Pallas kernel, so this is a library call with no
TPU kernel behind it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

# symmetric int8 range: +-127 (not -128) keeps |q| * scale <= absmax exactly
# and the negation symmetric
QMAX = 127.0

# analytic activation scale for tanh/sigmoid-bounded tensors (|x| < 1)
UNIT_SCALE = 1.0 / QMAX

# torch._int_mm's shape rules on CUDA: more than 16 rows, K and N multiples
# of 8. Zero rows and columns are exact in the symmetric scheme.
_MM_MIN_ROWS = 17
_MM_ALIGN = 8


def quantize_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8 quantization of an OIHW kernel.

    w: [Cout, Cin, Kh, Kw] float. Returns ``(wq int8, scale float32
    [Cout])`` with ``w ~= wq * scale[:, None, None, None]``. Scales are
    floored at 1e-12 / 127, so an all-zero channel dequantizes to zeros,
    never NaN."""
    w = w.float()
    absmax = w.abs().amax(dim=(1, 2, 3))
    scale = torch.clamp(absmax, min=1e-12) / QMAX
    wq = torch.clamp(torch.round(w / scale[:, None, None, None]), -QMAX, QMAX)
    return wq.to(torch.int8), scale


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization: round(x / scale), clipped to +-127.
    ``scale`` is a float or a tensor broadcastable to ``x``
    (``dynamic_scale``'s per-sample scale)."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-sample activation scale of ``x [B, ...]``: absmax over the
    non-batch axes / 127, shape ``[B, 1, ...]``, floored at 1e-12 / 127.

    Per sample, so that a sample's grid does not depend on its batchmates:
    serving is the same at any batch and in any data-parallel split."""
    dims = tuple(range(1, x.ndim))
    absmax = x.float().abs().amax(dim=dims, keepdim=True)
    return torch.clamp(absmax, min=1e-12) / QMAX


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def conv2d_int8(xq: torch.Tensor, wq: torch.Tensor,
                stride: int | Sequence[int] = 1, padding="SAME"):
    """NHWC int8 conv with exact int32 accumulation.

    xq: [B, H, W, Cin] int8, wq: OIHW [Cout, Cin, Kh, Kw] int8 ->
    [B, H', W', Cout] int32. ``padding`` is "SAME" (JAX's rule: (K-1)//2
    before, the rest after; stride 1), an int (that many pixels on every
    side) or ((top, bottom), (left, right)), as JAX's ``conv2d_int8``."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"conv2d_int8 takes int8 operands, got {xq.dtype} "
                         f"and {wq.dtype}")
    cout, cin, kh, kw = wq.shape
    if xq.shape[-1] != cin:
        raise ValueError(f"input has {xq.shape[-1]} channels, the kernel "
                         f"takes {cin}")
    sh, sw = (stride, stride) if isinstance(stride, int) else tuple(stride)
    if padding == "SAME":
        pads = ((kh - 1) // 2, kh - 1 - (kh - 1) // 2,
                (kw - 1) // 2, kw - 1 - (kw - 1) // 2)
    elif isinstance(padding, int):
        pads = (padding,) * 4
    else:
        (top, bottom), (left, right) = padding
        pads = (top, bottom, left, right)
    b, hgt, wid, _ = xq.shape
    xp = F.pad(xq, (0, 0, pads[2], pads[3], pads[0], pads[1]))
    ho = (hgt + pads[0] + pads[1] - kh) // sh + 1
    wo = (wid + pads[2] + pads[3] - kw) // sw + 1
    k = kh * kw * cin
    k_pad, n_pad = _pad_to(k, _MM_ALIGN), _pad_to(cout, _MM_ALIGN)
    # im2col as strided windows of the padded input, [B, H', W', Cin, Kh,
    # Kw], copied to rows in OIHW's (Cin, Kh, Kw) order: [B*H'*W', K]
    cols = xp.unfold(1, kh, sh).unfold(2, kw, sw).reshape(b * ho * wo, k)
    # K zero-padded; rows decided on the frame alone, so that an exported
    # program with a symbolic batch holds no guard on it (B >= 1)
    rows = _MM_MIN_ROWS if ho * wo < _MM_MIN_ROWS else 0
    if k_pad > k or rows:
        cols = F.pad(cols, (0, k_pad - k, 0, rows))
    # the kernel as [N, K] rows; _int_mm takes its transpose (the
    # column-major operand of cuBLASLt's int8 GEMM)
    wmat = wq.reshape(cout, k)
    if k_pad > k or n_pad > cout:
        wmat = F.pad(wmat, (0, k_pad - k, 0, n_pad - cout))
    z = torch._int_mm(cols, wmat.t())
    return z[:b * ho * wo, :cout].reshape(b, ho, wo, cout)


class QuantConv(NamedTuple):
    """A quantized conv layer: int8 OIHW kernel, per-Cout dequant scale,
    float32 bias. ``act_scale`` is the static activation scale the layer
    was paired with (None: the caller passes a dynamic scale)."""
    wq: torch.Tensor                # [Cout, Cin, Kh, Kw] int8
    wscale: torch.Tensor            # [Cout] float32
    bias: Optional[torch.Tensor]    # [Cout] float32 or None
    act_scale: Optional[float] = UNIT_SCALE


def quantize_conv(weight: torch.Tensor, bias: Optional[torch.Tensor],
                  act_scale: Optional[float] = UNIT_SCALE) -> QuantConv:
    """Package a float conv layer (OIHW weight) for int8 serving."""
    wq, wscale = quantize_weight(weight)
    b = None if bias is None else bias.float()
    return QuantConv(wq, wscale, b, act_scale)


def apply_quant_conv(qc: QuantConv, x: torch.Tensor, act_scale=None,
                     stride: int | Sequence[int] = 1, padding="SAME"):
    """Quantize ``x`` [B, H, W, Cin], run the int8 conv, dequantize, add the
    bias. Returns float32 NHWC. ``act_scale`` overrides the layer's static
    scale (dynamic quantization)."""
    s = qc.act_scale if act_scale is None else act_scale
    z = conv2d_int8(quantize_act(x, s), qc.wq, stride, padding)
    out = z.float() * (s * qc.wscale)
    return out if qc.bias is None else out + qc.bias
