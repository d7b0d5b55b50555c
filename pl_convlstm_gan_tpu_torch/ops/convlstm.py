"""Functional ConvLSTM cell primitives (NHWC).

One conv over ``concat(x, h)`` emits ``4*hidden`` channels, split into
(i, f, o, g) in that order, then

    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

Rounding points, the same in the plain step and in the CUDA kernel
(``ops/kernels/convlstm_kernel.py``): the conv accumulates in float32, the bias
is added in float32, the gates run in float32, and ``h'`` and ``c'`` are
stored in the operands' type (float32 or bfloat16).

``checkpoint_name`` tags the ops run inside it, as ``jax.ad_checkpoint.
checkpoint_name`` names a value: the plain step computes z under the name
``"convlstm_z"``, which the forecaster's ``save_z`` remat policy keeps
(``models/forecaster.py``). Outside a checkpointed region the tag does
nothing.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..parallel.tp_collectives import copy_in, gather_h
from .nn import conv2d_nhwc_f32, hwio_from_oihw

Z_NAME = "convlstm_z"
_TAG = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Tag the ops run inside the block with ``name`` (read by a selective
    checkpoint policy through ``current_checkpoint_name``)."""
    prev = getattr(_TAG, "name", None)
    _TAG.name = name
    try:
        yield
    finally:
        _TAG.name = prev


def current_checkpoint_name():
    """The name of the innermost ``checkpoint_name`` block, or None."""
    return getattr(_TAG, "name", None)


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
    xh = torch.cat([x, h], dim=-1)
    with checkpoint_name(Z_NAME):
        z = conv2d_nhwc_f32(xh, weight, bias)
    h_next, c_next = convlstm_gates(z, c.float())
    return h_next.to(x.dtype), c_next.to(x.dtype)


# Tensor parallelism (``parallel/tensor_parallel.py``): a cell's 4*Ch conv
# outputs are stored shard-major per gate ([i_0|f_0|o_0|g_0 | i_1|...]), so
# that rank s of a model group of n holds the complete gates of hidden
# channels [s*Ch/n, (s+1)*Ch/n) and runs the canonical gate math on them.

def convlstm_gates_tp(z: torch.Tensor, c: torch.Tensor, n_shards: int):
    """Gate math on the full shard-major z [..., 4*Ch] and the canonical c
    [..., Ch] (the JAX package's ``convlstm_gates_tp``). Returns (h', c') in
    the canonical channel order; a reshape away from ``convlstm_gates`` on
    the un-permuted z."""
    ch = c.shape[-1]
    chl = ch // n_shards
    zr = z.reshape(*z.shape[:-1], n_shards, 4, chl)
    cr = c.reshape(*c.shape[:-1], n_shards, chl)
    i = torch.sigmoid(zr[..., 0, :])
    f = torch.sigmoid(zr[..., 1, :])
    o = torch.sigmoid(zr[..., 2, :])
    g = torch.tanh(zr[..., 3, :])
    c_next = f * cr + i * g
    h_next = o * torch.tanh(c_next)
    return h_next.reshape(c.shape), c_next.reshape(c.shape)


def convlstm_step_tp(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor, group):
    """One ConvLSTM step of this rank of a model group: x [B,H,W,Cx] and the
    full h [B,H,W,Ch] (both replicated over the group), this rank's c
    [B,H,W,Ch/n], and its shards ``weight`` [4Ch/n, Cx+Ch, K, K] and
    ``bias`` [4Ch/n]. The conv input, in float32, goes through ``copy_in``
    (its gradient is summed over the group in float32, then rounded once to
    the operands' type, as one process rounds the whole sum), the local
    z [B,H,W,4Ch/n] is computed under ``Z_NAME`` (remat's ``save_z`` keeps
    it) and the canonical gates run on it. Returns the full h' (one
    all-gather, ``gather_h``) and the local c', in x's type."""
    xh = copy_in(torch.cat([x, h], dim=-1).float(), group)
    with checkpoint_name(Z_NAME):
        z = conv2d_nhwc_f32(xh, weight, bias)
    h_next, c_next = convlstm_gates(z, c.float())
    return gather_h(h_next.to(x.dtype), group), c_next.to(x.dtype)


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
                  packed=None, wgrad=None):
    """Impl-dispatching cell step: 'torch' (plain, differentiated by
    autograd) or 'kernel' (the fused CUDA cell on CUDA tensors, its plain
    version on CPU tensors). With 'kernel', a step that needs gradients runs
    ``ConvLSTMCellFn`` (K1 writing z, then the custom backward); a step
    under ``no_grad`` / ``inference_mode`` launches K1 without z. K1 on the
    card reads ``packed`` (``pack_step_weight(weight, impl)``, made here
    when None) in place of an HWIO copy; the HWIO view of the weight goes to
    the backward. ``wgrad`` (``convlstm_kernel.pass_weight``'s, ``weight``
    being that pass's weight) has the weight gradient of the pass's steps
    computed once, after all of them."""
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
            return ConvLSTMCellFn.apply(*operands, packed, wgrad)
        w, b, x, h, c = operands
        return convlstm_cell_fwd(x, h, c, w, b, packed=packed)
    raise ValueError(f"Unknown convlstm impl: {impl!r} (valid: 'torch', 'kernel')")


# The split-input cell: conv(concat(x, h)) = conv_x(x) + conv_h(h) by
# linearity. When every step's input is known before the recurrence (the
# Generator's encode), the x side of all steps is one conv over the merged
# T*B batch, and each step does only the h-side conv and the gates. Plain
# PyTorch only: K1 has no h-only form.

def convlstm_precompute_x(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """x-side pre-activations of any batch of inputs. x: [N, H, W, Cx] (N may
    be T*B merged), weight OIHW [4Ch, Cx+Ch, K, K]; returns z_x [N, H, W,
    4Ch] in float32, with the bias folded in so that the step needs none."""
    return conv2d_nhwc_f32(x, weight[:, :x.shape[-1]], bias)


def convlstm_step_precomputed(z_x: torch.Tensor, h: torch.Tensor,
                              c: torch.Tensor, weight: torch.Tensor):
    """One step given the precomputed x side ``z_x`` [B, H, W, 4Ch]: the
    h-side conv (float32) added to it, then the gates. Returns (h', c') in
    h's type."""
    cx = weight.shape[1] - h.shape[-1]
    z = z_x.float() + conv2d_nhwc_f32(h, weight[:, cx:], None)
    h_next, c_next = convlstm_gates(z, c.float())
    return h_next.to(h.dtype), c_next.to(h.dtype)
