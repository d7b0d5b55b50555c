"""The float32 K1's packed weight layout.

``pack_cell_weight_f32`` lays an HWIO weight out as the float32 kernel's B
operand [K_rows, N_pad]: column ``4j + g`` is gate g of hidden channel j
(Ch padded to a multiple of 32), rows in the kernel's chunk order (folded x
of every tap first when ``Cx % 8 != 0``, then per chunk of 8 channels of x,
then of h, its K*K taps x 8 channels). A plain "GEMM form" written here
walks the chunks in that order as the kernel does (a halo tile per chunk,
shifted per tap; the folded x as im2col rows), multiplies by the packed
matrix chunk by chunk into one float32 accumulator seeded with the bias,
and un-interleaves the gate columns; it must give the cell step itself.

Inputs are the small dyadic numbers of tests/test_torch_cell_packed.py:
every product and partial sum is exact in float32, so the GEMM form and
``convlstm_cell_plain`` (which sum in other orders) agree exactly
(atol=rtol=1e-6 stated, 0 reached). Against the JAX package
(``convlstm_step_xla``, and ``convlstm_step_pallas`` / ``_run_kernel`` in
interpret mode for z): atol=rtol=1e-5, the tolerance tests/test_pallas.py
holds the Pallas cell to.

The forecaster packs each cell's weight once per forward pass, not once
per step: checked here with a counting stand-in for the pack."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pl_convlstm_gan_tpu.ops.convlstm import ConvLSTMParams, convlstm_step_xla
from pl_convlstm_gan_tpu.ops.pallas.convlstm_kernel import (
    _run_kernel, convlstm_step_pallas)
from pl_convlstm_gan_tpu_torch.models import ConvLSTMForecaster, layers
from pl_convlstm_gan_tpu_torch.ops.convlstm import (convlstm_gates,
                                                    pack_step_weight)
from pl_convlstm_gan_tpu_torch.ops.kernels import convlstm_kernel as k1
from pl_convlstm_gan_tpu_torch.ops.kernels.convlstm_kernel import (
    F32_CK, cell_kernel_misfit, convlstm_cell_plain, f32_chunks, kernel_pack,
    pack_cell_weight, pack_cell_weight_f32, packed_shape_f32)
from test_torch_cell_packed import _dyadic_inputs

CASES = [(1, 8, 3), (8, 16, 3), (3, 40, 5)]     # (Cx, Ch, K)
PLAIN_TOL = dict(atol=1e-6, rtol=1e-6)
JAX_TOL = dict(atol=1e-5, rtol=1e-5)


def _gemm_form_f32(x, h, c, packed, bias, k):
    """The cell as the float32 kernel computes it, chunk by chunk. Returns
    (h', c', z) float32."""
    b, hgt, wid, cx = x.shape
    ch = h.shape[-1]
    pad = k // 2
    n_fold, n_x, n_h = f32_chunks(cx, ch, k)
    xp, hp = (F.pad(t, (0, 0, pad, pad, pad, pad)) for t in (x, h))
    taps = [(di, dj) for di in range(k) for dj in range(k)]
    n_pad = packed.shape[1]
    cols = torch.arange(4 * ch)
    # seed: column 4j + g holds bias[g*Ch + j]
    seed = torch.zeros(n_pad)
    seed[:4 * ch] = bias.reshape(4, ch).t().reshape(-1)
    acc = seed.expand(b * hgt * wid, n_pad).clone()
    row = 0
    if n_fold:
        folded = torch.cat([xp[:, di:di + hgt, dj:dj + wid, :]
                            for di, dj in taps], dim=-1)
        folded = F.pad(folded, (0, F32_CK * n_fold - k * k * cx))
        for q in range(n_fold):
            a = folded[..., F32_CK * q:F32_CK * (q + 1)].reshape(-1, F32_CK)
            acc += a @ packed[row:row + F32_CK]
            row += F32_CK
    for src, n_chunks in ((xp, n_x), (hp, n_h)):
        src = F.pad(src, (0, F32_CK * n_chunks - src.shape[-1]))
        for q in range(n_chunks):
            halo = src[..., F32_CK * q:F32_CK * (q + 1)]
            for di, dj in taps:
                a = halo[:, di:di + hgt, dj:dj + wid, :].reshape(-1, F32_CK)
                acc += a @ packed[row:row + F32_CK]
                row += F32_CK
    assert row == packed.shape[0]
    assert not acc[:, 4 * ch:].any()                 # padded columns
    z = acc[:, cols].reshape(-1, ch, 4).transpose(1, 2).reshape(
        b, hgt, wid, 4 * ch)
    h_new, c_new = convlstm_gates(z, c)
    return h_new, c_new, z


@pytest.mark.parametrize("cx,ch,k", CASES)
def test_gemm_form_of_f32_packed_weight_equals_plain(cx, ch, k):
    x, h, c, kern, bias = (torch.from_numpy(a) for a in
                           _dyadic_inputs(cx + 2 * ch + k, cx, ch, k))
    packed = pack_cell_weight_f32(kern)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert tuple(packed.shape) == packed_shape_f32(cx, ch, k)
    assert packed.shape[1] % 128 == 0               # whole blocks of columns
    z_ref = torch.empty(x.shape[:-1] + (4 * ch,))
    h_ref, c_ref = convlstm_cell_plain(x, h, c, kern, bias, z_out=z_ref)
    for name, g, r in zip(("h'", "c'", "z"),
                          _gemm_form_f32(x, h, c, packed, bias, k),
                          (h_ref, c_ref, z_ref)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **PLAIN_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("cx,ch,k", CASES)
def test_gemm_form_of_f32_packed_weight_matches_jax(cx, ch, k, reference):
    arrays = _dyadic_inputs(cx * ch + 2 * k, cx, ch, k)
    x, h, c, kern, bias = arrays
    params = ConvLSTMParams(jnp.asarray(kern), jnp.asarray(bias))
    step = convlstm_step_xla if reference == "xla" else convlstm_step_pallas
    h_ref, c_ref = step(params, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    tx, th, tc, tk, tb = (torch.from_numpy(a) for a in arrays)
    hn, cn, z = _gemm_form_f32(tx, th, tc, pack_cell_weight_f32(tk), tb, k)
    np.testing.assert_allclose(hn.numpy(), np.asarray(h_ref), **JAX_TOL)
    np.testing.assert_allclose(cn.numpy(), np.asarray(c_ref), **JAX_TOL)
    if reference == "pallas":    # z against the TPU kernel's save_z form
        z_ref = _run_kernel(*(jnp.asarray(a) for a in (kern, bias, x, h, c)),
                            True)[2]
        np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **JAX_TOL)


@pytest.mark.parametrize("cx,ch,k,chunks,shape", [
    (1, 64, 3, (2, 0, 8), (16 + 8 * 9 * 8, 256)),   # nowcast_128 cell 1: folded
    (64, 64, 3, (0, 8, 8), (9 * 128, 256)),         # cells 2-3
    (3, 40, 5, (10, 0, 5), (80 + 25 * 40, 256)),    # the ragged shape: Ch 40 -> 64
    (8, 12, 1, (0, 1, 2), (24, 128)),
])
def test_f32_chunks_of_the_configs(cx, ch, k, chunks, shape):
    assert f32_chunks(cx, ch, k) == chunks
    assert packed_shape_f32(cx, ch, k) == shape


def test_f32_pack_places_each_weight():
    """Spot entries: column 4j + g is gate g of channel j; folded x of tap t
    channel ci at row t*Cx + ci; h channel 8q + e of tap t at row
    rows_before + q*K*K*8 + t*8 + e; padding is zero."""
    k, cx, ch = 3, 1, 12
    w = torch.arange(k * k * (cx + ch) * 4 * ch, dtype=torch.float32).reshape(
        k, k, cx + ch, 4 * ch) + 1
    p = pack_cell_weight_f32(w)
    fold_rows = 16
    for (di, dj, g, j) in [(0, 0, 0, 0), (1, 2, 3, 11), (2, 1, 2, 7)]:
        tap = di * k + dj
        assert p[tap * cx, 4 * j + g] == w[di, dj, 0, g * ch + j]
        for hc in (0, 9):                          # h channels 0 and 9
            row = fold_rows + (hc // 8) * k * k * 8 + tap * 8 + hc % 8
            assert p[row, 4 * j + g] == w[di, dj, cx + hc, g * ch + j]
    assert not p[k * k * cx:fold_rows].any()      # folded x padding
    assert not p[:, 4 * ch:].any()                # columns past 4Ch
    last = p[fold_rows + k * k * 8:].view(k * k, 8, -1)
    assert not last[:, ch - 8:].any()             # h channels 12..15
    cx = 8                                        # x not folded
    w = torch.randn(k, k, cx + ch, 4 * ch)
    p = pack_cell_weight_f32(w)
    assert p[4 * 8 + 6, 4 * 11 + 2] == w[1, 1, 6, 2 * ch + 11]
    assert p[k * k * 8 + 4 * 8 + 6, 4 * 11 + 2] == w[1, 1, cx + 6, 2 * ch + 11]


def test_kernel_pack_by_dtype_and_f32_rules():
    """kernel_pack picks the layout of K1's dtype; the float32 K1 takes
    kernel sizes 1, 3 and 5 and no bfloat16 rule (Ch 12, any Cx)."""
    w = torch.randn(3, 3, 20, 64, requires_grad=True)      # Cx 4, Ch 16
    assert torch.equal(kernel_pack(w, torch.float32), pack_cell_weight_f32(w))
    assert torch.equal(kernel_pack(w.to(torch.bfloat16), torch.bfloat16),
                       pack_cell_weight(w.to(torch.bfloat16)))
    assert not kernel_pack(w, torch.float32).requires_grad
    for k in (1, 3, 5):
        assert cell_kernel_misfit(3, 12, k, torch.float32) is None
    assert "kernel sizes" in cell_kernel_misfit(8, 16, 7, torch.float32)
    assert "odd" in cell_kernel_misfit(8, 16, 4, torch.float32)
    kern = torch.zeros(7, 7, 24, 64)
    x, h = torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError, match="kernel sizes"):
        k1._check_args(x, h, h, kern, torch.zeros(64), h, h.clone(), None,
                       torch.zeros(1, 1))


def test_pack_step_weight_only_where_k1_launches():
    """``pack_step_weight`` packs an OIHW weight for K1 only on the card with
    impl 'kernel'; the plain step and CPU weights get None. The float32 pack
    refuses a weight whose columns are not 4Ch."""
    w = torch.randn(64, 20, 3, 3)                          # OIHW, Cx 4, Ch 16
    assert pack_step_weight(w, "kernel") is None           # on the CPU
    assert pack_step_weight(w, "torch") is None
    with pytest.raises(ValueError, match="4Ch"):
        pack_cell_weight_f32(torch.zeros(3, 3, 20, 66))


@pytest.mark.parametrize("grad", [False, True])
def test_forecaster_packs_each_cell_once_per_forward(monkeypatch, grad):
    """The forecaster packs every cell's weight once per forward pass and
    hands that pack to each of the cell's steps, with and without autograd;
    the output is the same as with no pack handed down (on the CPU the
    wrappers do not read it)."""
    model = ConvLSTMForecaster(hidden_dims=(8, 8), input_frames=2,
                               output_frames=3, convlstm_impl="kernel")
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 2, 1, 8, 8)).astype(np.float32))
    with torch.no_grad():
        want = model(frames)
    packs, seen = [], []
    real_step = layers.convlstm_step

    def fake_pack(weight, impl):
        packs.append(torch.zeros(1))
        return packs[-1]

    def spy_step(*args, packed=None, **kw):
        seen.append(packed)
        return real_step(*args, **kw)

    monkeypatch.setattr(layers, "pack_step_weight", fake_pack)
    monkeypatch.setattr(layers, "convlstm_step", spy_step)
    with torch.set_grad_enabled(grad):
        got = model(frames)
    steps = 2 + 3 - 1
    assert len(packs) == 2 and len(seen) == 2 * steps
    assert all(p is packs[i % 2] for i, p in enumerate(seen))
    assert torch.equal(got.detach(), want)
