"""Functional ConvLSTM cell primitives (NHWC).

One conv over ``concat(x, h)`` emits ``4*hidden`` channels, split into
(i, f, o, g) in that order, then

    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

Rounding points, the same in the plain step and in the CUDA kernel
(``ops/kernels/convlstm_kernel.py``): the conv accumulates in float32, the bias
is added in float32, the gates run in float32, and ``h'`` and ``c'`` are
stored in the operands' type (float32 or bfloat16).
"""
from __future__ import annotations

import torch

from .nn import conv2d_nhwc_f32, hwio_from_oihw


def convlstm_gates(z: torch.Tensor, c: torch.Tensor):
    """Elementwise gate math. z: [..., 4*Ch] pre-activations (i|f|o|g order),
    c: [..., Ch]. Returns (h_next, c_next) in the type of the operands."""
    zi, zf, zo, zg = torch.chunk(z, 4, dim=-1)
    i = torch.sigmoid(zi)
    f = torch.sigmoid(zf)
    o = torch.sigmoid(zo)
    g = torch.tanh(zg)
    c_next = f * c + i * g
    h_next = o * torch.tanh(c_next)
    return h_next, c_next


def convlstm_step_torch(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                        weight: torch.Tensor, bias: torch.Tensor):
    """One ConvLSTM step in plain PyTorch. x: [B,H,W,Cx], h/c: [B,H,W,Ch],
    weight: OIHW [4Ch, Cx+Ch, K, K], bias [4Ch]. Returns (h', c') in x's type."""
    z = conv2d_nhwc_f32(torch.cat([x, h], dim=-1), weight, bias)
    h_next, c_next = convlstm_gates(z, c.float())
    return h_next.to(x.dtype), c_next.to(x.dtype)


def pack_step_weight(weight: torch.Tensor, impl: str = "torch"):
    """K1's packed form of the OIHW ``weight`` (``kernel_pack`` in the
    weight's dtype), or None where ``convlstm_step`` launches no K1 (impl
    'torch', a weight on the CPU). A cell's weight is the same at every step
    of a forward pass, so a loop over a sequence packs once and hands the
    result to every step."""
    if impl != "kernel" or not weight.is_cuda:
        return None
    from .kernels.convlstm_kernel import kernel_pack
    return kernel_pack(hwio_from_oihw(weight), weight.dtype)


def convlstm_step(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor, impl: str = "torch",
                  packed=None):
    """Impl-dispatching cell step: 'torch' (plain, differentiated by
    autograd) or 'kernel' (the fused CUDA cell on CUDA tensors, its plain
    version on CPU tensors). With 'kernel', a step that needs gradients runs
    ``ConvLSTMCellFn`` (K1 writing z, then the custom backward); a step
    under ``no_grad`` / ``inference_mode`` launches K1 without z. K1 on the
    card reads ``packed`` (``pack_step_weight(weight, impl)``, made here
    when None) in place of an HWIO copy; the HWIO view of the weight goes to
    the backward."""
    if impl == "torch":
        return convlstm_step_torch(x, h, c, weight, bias)
    if impl == "kernel":
        from .kernels.convlstm_kernel import ConvLSTMCellFn, convlstm_cell_fwd
        w = hwio_from_oihw(weight)
        if x.is_cuda:
            if packed is None:
                packed = pack_step_weight(weight, impl)
        else:
            w = w.contiguous()
        operands = (w, bias.contiguous(), x.contiguous(), h.contiguous(),
                    c.contiguous())
        if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
            return ConvLSTMCellFn.apply(*operands, packed)
        w, b, x, h, c = operands
        return convlstm_cell_fwd(x, h, c, w, b, packed=packed)
    raise ValueError(f"Unknown convlstm impl: {impl!r} (valid: 'torch', 'kernel')")
