"""The bfloat16 K1's packed weight layout and its wrapper's shape rules.

``pack_cell_weight`` lays an HWIO weight out as the kernel's B operand
[4Ch, K_total]: gate-interleaved rows, K in the kernel's k-block order. A
plain "GEMM form" of the cell written here runs explicit im2col over the
taps in that order, multiplies by the packed matrix and un-interleaves the
gate columns; it must give the cell step itself.

Inputs are made with numpy from a seed as small dyadic numbers (x, h, c in
eighths of [-1, 1], weights and bias in 64ths of [-1/4, 1/4]): every product
and every partial sum is exact in float32 and every operand exact in
bfloat16, so the GEMM form and ``convlstm_cell_plain`` (which sum in other
orders) agree exactly in float32, and in bfloat16 to at most one bf16 ulp
(both round the same float32 values once). Against the JAX package
(``convlstm_step_xla``, and ``convlstm_step_pallas`` / ``_run_kernel`` in
interpret mode, as tests/test_torch_cell.py runs them): atol=rtol=1e-5 in
float32, the tolerance tests/test_pallas.py holds the Pallas cell to."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pl_convlstm_gan_tpu.ops.convlstm import ConvLSTMParams, convlstm_step_xla
from pl_convlstm_gan_tpu.ops.pallas.convlstm_kernel import (
    _run_kernel, convlstm_step_pallas)
from pl_convlstm_gan_tpu_torch.ops.convlstm import convlstm_gates
from pl_convlstm_gan_tpu_torch.ops.kernels import convlstm_kernel as k1
from pl_convlstm_gan_tpu_torch.ops.kernels.convlstm_kernel import (
    BK, ConvLSTMCellFn, convlstm_cell_plain, k_blocks, pack_cell_weight,
    packed_shape)

TOL = dict(atol=1e-5, rtol=1e-5)
CASES = [(1, 8, 3), (3, 40, 5), (16, 16, 3)]     # (Cx, Ch, K)


def _dyadic_inputs(seed, cx, ch, k, b=2, size=12):
    rng = np.random.default_rng(seed)

    def grid(shape, steps, scale):
        return (rng.integers(-steps, steps + 1, shape) * scale).astype(np.float32)
    x = grid((b, size, size, cx), 8, 1 / 8)
    h = grid((b, size, size, ch), 8, 1 / 8)
    c = grid((b, size, size, ch), 8, 1 / 8)
    kern = grid((k, k, cx + ch, 4 * ch), 16, 1 / 64)
    bias = grid((4 * ch,), 16, 1 / 64)
    return x, h, c, kern, bias


def _gemm_form(x, h, c, packed, bias, k):
    """The cell as the bfloat16 kernel computes it: im2col of concat(x, h)
    in the k-block order (folded x of all taps first when Cx % 8 != 0, then
    per tap x and h, each zero-padded to a multiple of 64 channels), times
    packed^T, plus the bias, gate columns un-interleaved
    (32q + 8g + e -> g*Ch + 8q + e). Returns (h', c', z) in x's dtype."""
    b, hgt, wid, cx = x.shape
    ch = h.shape[-1]
    pad = k // 2
    n_fold, n_x, n_h = k_blocks(cx, ch, k)
    xp, hp = (F.pad(t.float(), (0, 0, pad, pad, pad, pad)) for t in (x, h))
    offsets = [(di, dj) for di in range(k) for dj in range(k)]

    def shifted(t, di, dj, width):
        return F.pad(t[:, di:di + hgt, dj:dj + wid, :],
                     (0, width - t.shape[-1]))
    cols = []
    if n_fold:
        folded = torch.cat([xp[:, di:di + hgt, dj:dj + wid, :]
                            for di, dj in offsets], dim=-1)
        cols.append(F.pad(folded, (0, BK * n_fold - k * k * cx)))
    for di, dj in offsets:
        if n_x:
            cols.append(shifted(xp, di, dj, BK * n_x))
        cols.append(shifted(hp, di, dj, BK * n_h))
    a = torch.cat(cols, dim=-1).reshape(b * hgt * wid, packed.shape[1])
    zi = a @ packed.float().t()
    z = zi.reshape(-1, ch // 8, 4, 8).transpose(1, 2).reshape(
        b, hgt, wid, 4 * ch) + bias.float()
    h_new, c_new = convlstm_gates(z, c.float())
    return h_new.to(x.dtype), c_new.to(x.dtype), z.to(x.dtype)


def _bf16_ulp(t):
    """One bf16 ulp at each element of ``t`` (at least the smallest
    normal's)."""
    mag = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cx,ch,k", CASES)
def test_gemm_form_of_packed_weight_equals_plain(cx, ch, k, dtype):
    x, h, c, kern, bias = (torch.from_numpy(a).to(dtype)
                           for a in _dyadic_inputs(cx + ch + k, cx, ch, k))
    packed = pack_cell_weight(kern)
    assert packed.dtype == dtype and packed.is_contiguous()
    assert tuple(packed.shape) == packed_shape(cx, ch, k)
    z_ref = torch.empty(x.shape[:-1] + (4 * ch,), dtype=dtype)
    h_ref, c_ref = convlstm_cell_plain(x, h, c, kern, bias, z_out=z_ref)
    got = _gemm_form(x, h, c, packed, bias, k)
    for name, g, r in zip(("h'", "c'", "z"), got, (h_ref, c_ref, z_ref)):
        assert g.dtype == dtype, name
        if dtype == torch.float32:
            assert torch.equal(g, r), name
        else:
            diff = (g.float() - r.float()).abs()
            assert bool((diff <= _bf16_ulp(r)).all()), name


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("cx,ch,k", CASES)
def test_gemm_form_of_packed_weight_matches_jax(cx, ch, k, reference):
    arrays = _dyadic_inputs(cx * ch + k, cx, ch, k)
    x, h, c, kern, bias = arrays
    params = ConvLSTMParams(jnp.asarray(kern), jnp.asarray(bias))
    step = convlstm_step_xla if reference == "xla" else convlstm_step_pallas
    h_ref, c_ref = step(params, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    tx, th, tc, tk, tb = (torch.from_numpy(a) for a in arrays)
    hn, cn, z = _gemm_form(tx, th, tc, pack_cell_weight(tk), tb, k)
    np.testing.assert_allclose(hn.numpy(), np.asarray(h_ref), **TOL)
    np.testing.assert_allclose(cn.numpy(), np.asarray(c_ref), **TOL)
    if reference == "pallas":    # z against the TPU kernel's save_z form
        z_ref = _run_kernel(*(jnp.asarray(a) for a in (kern, bias, x, h, c)),
                            True)[2]
        np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **TOL)


@pytest.mark.parametrize("cx,ch,k,blocks,k_total", [
    (1, 64, 3, (1, 0, 1), 640),        # nowcast_128 cell 1: x folded
    (64, 64, 3, (0, 1, 1), 1152),      # cells 2-3: 18 k-blocks
    (3, 40, 5, (2, 0, 1), 1728),       # the ragged shape
    (256, 256, 3, (0, 4, 4), 4608),    # tp_nowcast_128
])
def test_k_blocks_of_the_configs(cx, ch, k, blocks, k_total):
    assert k_blocks(cx, ch, k) == blocks
    assert packed_shape(cx, ch, k) == (4 * ch, k_total)


def test_pack_places_each_weight():
    """Spot entries: row 32q + 8g + e is gate g of channel 8q + e; x of tap
    t channel ci sits at t*Cx + ci when folded, else at its tap's x slot;
    h channel j at its tap's h slot; padding is zero."""
    k, cx, ch = 3, 1, 16
    w = torch.arange(k * k * (cx + ch) * 4 * ch, dtype=torch.float32).reshape(
        k, k, cx + ch, 4 * ch)
    p = pack_cell_weight(w)
    for (di, dj, g, j) in [(0, 0, 0, 0), (1, 2, 3, 13), (2, 1, 2, 7)]:
        row = 32 * (j // 8) + 8 * g + j % 8
        tap = di * k + dj
        assert p[row, tap * cx] == w[di, dj, 0, g * ch + j]          # folded x
        h_slot = BK + tap * BK + 5                                 # h channel 5
        assert p[row, h_slot] == w[di, dj, cx + 5, g * ch + j]
    assert not p[:, k * k * cx:BK].any()        # folded x padding
    assert not p[:, BK + ch:2 * BK].any()       # h padding of tap 0
    cx = 8                                      # x not folded: per-tap slots
    w = torch.randn(k, k, cx + ch, 4 * ch)
    p = pack_cell_weight(w)
    assert p[32 + 8 * 2 + 3, 4 * 2 * BK + 6] == w[1, 1, 6, 2 * ch + 11]
    assert p[32 + 8 * 2 + 3, 4 * 2 * BK + BK + 6] == w[1, 1, cx + 6, 2 * ch + 11]


def test_pack_is_not_differentiable_and_refuses_ragged_hidden():
    w = torch.randn(3, 3, 9, 32, requires_grad=True)
    assert not pack_cell_weight(w).requires_grad
    with pytest.raises(ValueError, match="multiple of 8"):
        pack_cell_weight(torch.zeros(3, 3, 7, 24))      # Ch 6


def _bf16_operands(cx=1, ch=16, k=3, b=2, size=8):
    x, h, c, kern, bias = (torch.from_numpy(a).to(torch.bfloat16)
                           for a in _dyadic_inputs(1, cx, ch, k, b, size))
    return x, h, c, kern, bias, torch.empty_like(h), torch.empty_like(c)


def test_check_args_bf16_shape_and_alignment_rules():
    """The bfloat16 kernel's rules, through the wrapper's checking function
    on CPU tensors: Ch a multiple of 8, the packed weight present and of its
    shape, every TMA or 16-byte operand 16-byte aligned (folded x and the
    bias are exempt); float32 takes none of these rules."""
    x, h, c, kern, bias, h_out, c_out = _bf16_operands()
    packed = pack_cell_weight(kern)
    k1._check_args(x, h, c, kern, bias, h_out, c_out, None, packed)
    with pytest.raises(ValueError, match="packed weight"):
        k1._check_args(x, h, c, kern, bias, h_out, c_out, None)
    with pytest.raises(ValueError, match="packed must be"):
        k1._check_args(x, h, c, kern, bias, h_out, c_out, None, packed[:, :-64])
    # Ch 12: not a multiple of 8
    x12, h12, c12, kern12, bias12, ho12, co12 = _bf16_operands(ch=12)
    with pytest.raises(ValueError, match="multiple of 8"):
        k1._check_args(x12, h12, c12, kern12, bias12, ho12, co12, None)
    # h starting one element (2 bytes) into its buffer
    buf = torch.empty(h.numel() + 8, dtype=torch.bfloat16)
    h_odd = buf[1:1 + h.numel()].view(h.shape).copy_(h)
    assert h_odd.is_contiguous() and h_odd.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned"):
        k1._check_args(x, h_odd, c, kern, bias, h_out, c_out, None, packed)
    z_buf = torch.empty(h.numel() * 4 + 8, dtype=torch.bfloat16)
    z_odd = z_buf[4:4 + 4 * h.numel()].view(x.shape[:-1] + (64,))
    with pytest.raises(ValueError, match="16-byte aligned"):
        k1._check_args(x, h, c, kern, bias, h_out, c_out, z_odd, packed)
    # folded x (Cx 1) and the bias may sit anywhere
    x_buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16)
    x_odd = x_buf[1:].view(x.shape).copy_(x)
    b_buf = torch.empty(bias.numel() + 1, dtype=torch.bfloat16)
    b_odd = b_buf[1:].copy_(bias)
    k1._check_args(x_odd, h, c, kern, b_odd, h_out, c_out, None, packed)
    # x read by TMA (Cx 8) must be aligned
    x8, h8, c8, kern8, bias8, ho8, co8 = _bf16_operands(cx=8)
    x8_buf = torch.empty(x8.numel() + 8, dtype=torch.bfloat16)
    x8_odd = x8_buf[1:1 + x8.numel()].view(x8.shape).copy_(x8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        k1._check_args(x8_odd, h8, c8, kern8, bias8, ho8, co8, None,
                       pack_cell_weight(kern8))
    # float32 with Ch 12 passes on its own packed layout (none of the
    # bfloat16 rules); without a packed weight it is refused too
    f32 = [t.float() for t in (x12, h12, c12, kern12, bias12, ho12, co12)]
    k1._check_args(*f32, None, k1.pack_cell_weight_f32(f32[3]))
    with pytest.raises(ValueError, match="packed weight"):
        k1._check_args(*f32, None)


def test_check_args_refuses_folded_x_beyond_shared_memory():
    """Folded x takes ceil(K*K*Cx / 64) k-blocks of shared memory beside
    the ring; the kernel holds 8 (K*K*Cx <= 512)."""
    ch, k = 8, 7
    for cx, ok in ((10, True), (11, False)):     # 490 and 539 values
        x = torch.zeros(1, 8, 8, cx, dtype=torch.bfloat16)
        h = torch.zeros(1, 8, 8, ch, dtype=torch.bfloat16)
        kern = torch.zeros(k, k, cx + ch, 4 * ch, dtype=torch.bfloat16)
        args = (x, h, torch.zeros_like(h), kern,
                torch.zeros(4 * ch, dtype=torch.bfloat16), torch.empty_like(h),
                torch.empty_like(h), None, pack_cell_weight(kern))
        if ok:
            k1._check_args(*args)
        else:
            with pytest.raises(ValueError, match="holds 8"):
                k1._check_args(*args)


def test_function_ignores_packed_on_cpu():
    """ConvLSTMCellFn hands the packed weight to the kernel; on CPU tensors
    the plain forward does not read it, and no gradient flows to it."""
    x, h, c, kern, bias = (torch.from_numpy(a)
                           for a in _dyadic_inputs(3, 1, 8, 3, 2, 8))
    leaves = [t.clone().requires_grad_(True) for t in (kern, bias, x, h, c)]
    hn, cn = ConvLSTMCellFn.apply(*leaves, pack_cell_weight(kern))
    (hn.sum() + cn.sum()).backward()
    h_ref, c_ref = convlstm_cell_plain(x, h, c, kern, bias)
    assert torch.equal(hn.detach(), h_ref) and torch.equal(cn.detach(), c_ref)
    assert all(t.grad is not None for t in leaves)
