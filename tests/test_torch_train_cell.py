"""The port's training cell step against the JAX package: K1's plain version
with z (the save_z=True form) and ``ConvLSTMCellFn``'s hand-written
backward.

Inputs and weights are made with numpy from a seed and handed to both
packages. The JAX Pallas kernels run as tests/test_pallas.py runs them, in
interpret mode on the CPU. Tolerances:
- float32 forward: atol 1e-5, as tests/test_pallas.py holds the Pallas cell
  to the XLA step (the two sides sum the conv in different orders);
- bfloat16 forward: one bf16 ulp of the largest value compared (both sides
  accumulate in float32 and round once at the store, so a stored value can
  land one ulp apart where the float32 sums straddle a rounding point);
- float32 gradients: atol=rtol=1e-5 against JAX (the same formulas in
  float32, summed in other orders; test_pallas.py allows 2e-4 between the
  custom VJP and XLA autodiff, which differ in formulas too).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_convlstm_gan_tpu.ops.convlstm import ConvLSTMParams
from pl_convlstm_gan_tpu.ops.pallas.convlstm_kernel import (
    _run_kernel, _run_kernel_tiled, convlstm_step_pallas)
from pl_convlstm_gan_tpu_torch.ops.convlstm import (convlstm_step,
                                                    convlstm_step_torch)
from pl_convlstm_gan_tpu_torch.ops.kernels import convlstm_kernel as k1
from pl_convlstm_gan_tpu_torch.ops.kernels.convlstm_kernel import (
    ConvLSTMCellFn, convlstm_cell_fwd, convlstm_cell_plain)
from pl_convlstm_gan_tpu_torch.ops.nn import oihw_from_hwio
from pl_convlstm_gan_tpu_torch.utils.profiling import counters

F32_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_NAMES = ("dweight", "dbias", "dx", "dh", "dc")


def _inputs(seed, b=2, hgt=8, wid=8, cx=3, ch=4, k=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hgt, wid, cx), dtype=np.float32)
    h = rng.standard_normal((b, hgt, wid, ch), dtype=np.float32)
    c = rng.standard_normal((b, hgt, wid, ch), dtype=np.float32)
    kern = rng.standard_normal((k, k, cx + ch, 4 * ch), dtype=np.float32) * 0.1
    bias = rng.standard_normal(4 * ch, dtype=np.float32) * 0.1
    return kern, bias, x, h, c


def _bf16_ulp(values: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude in ``values`` (8 bits of
    mantissa: 2^(e - 7) for values in [2^e, 2^(e+1)))."""
    return 2.0 ** (np.floor(np.log2(np.abs(values).max())) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant,shape", [
    ("full", dict(cx=3, ch=4, k=3)),
    ("full", dict(cx=2, ch=4, k=5)),
    ("tiled", dict(hgt=16, wid=8, cx=3, ch=4, k=3)),
])
def test_plain_with_z_matches_jax_save_z_kernel(variant, shape, dtype):
    """K1's plain version with z_out against the TPU kernel's save_z=True
    form: _run_kernel (P1) and _run_kernel_tiled (P2), interpret mode."""
    arrays = _inputs(7, **shape)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    run = _run_kernel if variant == "full" else _run_kernel_tiled
    refs = [np.asarray(a, np.float32) for a in
            run(*(jnp.asarray(a, jdt) for a in arrays), True)]
    kern, bias, x, h, c = (torch.from_numpy(a).to(tdt) for a in arrays)
    z = torch.empty(x.shape[:-1] + (bias.shape[0],), dtype=tdt)
    hn, cn = convlstm_cell_plain(x, h, c, kern, bias, z_out=z)
    for name, got, ref in zip(("h'", "c'", "z"), (hn, cn, z), refs):
        assert got.dtype == tdt
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, atol=_bf16_ulp(ref), rtol=0,
                                       err_msg=name)


def _jax_grads(arrays, loss_of_outputs):
    def loss(kern, bias, x, h, c):
        hn, cn = convlstm_step_pallas(ConvLSTMParams(kern, bias), x, h, c)
        return loss_of_outputs(hn, cn)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrays))


def _port_grads(step, arrays, loss_of_outputs):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    hn, cn = step(*leaves)
    loss_of_outputs(hn, cn).backward()
    return [t.grad for t in leaves]


def _mixed_loss(hn, cn):
    """test_pallas.py's loss: h and c gradients with different weights."""
    return (hn * 1.3).sum() + (cn * cn).sum() * 0.7


@pytest.mark.parametrize("k", [3, 5])
def test_function_gradients_match_jax_grad(k):
    """ConvLSTMCellFn on CPU tensors (plain forward with z, the custom
    backward) against jax.grad of convlstm_step_pallas (Pallas _fwd with
    save_z in interpret mode, XLA _bwd), and against torch autograd through
    convlstm_step_torch as a second oracle."""
    arrays = _inputs(11 + k, k=k, cx=2 if k == 5 else 3)
    ref = _jax_grads(arrays, lambda hn, cn: jnp.sum(hn * 1.3)
                     + jnp.sum(jnp.square(cn)) * 0.7)
    got = _port_grads(ConvLSTMCellFn.apply, arrays, _mixed_loss)
    for name, g, r in zip(GRAD_NAMES, got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32_TOL,
                                   err_msg=name)
    autograd = _port_grads(
        lambda w, b, x, h, c: convlstm_step_torch(x, h, c, oihw_from_hwio(w),
                                                  b), arrays, _mixed_loss)
    for name, g, r in zip(GRAD_NAMES, got, autograd):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **F32_TOL,
                                   err_msg=name)


def test_function_mixed_dtypes_match_jax():
    """float32 params with bfloat16 activations (test_pallas.py's mixed
    case): each gradient comes back in its primal's dtype, and matches JAX's.
    Both sides store z and c' in bf16 and run the backward in float32 from
    them; the stored values may land one bf16 ulp apart (see the bf16
    forward tolerance), which moves a gradient element by the same relative
    amount: bound 2^-7 of each gradient's largest magnitude."""
    kern, bias, x, h, c = _inputs(21)

    def loss(hn, cn):
        return hn.float().sum() + cn.float().sum()

    ref = jax.grad(
        lambda kk, bb, xx, hh, cc: jnp.sum(convlstm_step_pallas(
            ConvLSTMParams(kk, bb), xx, hh, cc)[0].astype(jnp.float32))
        + jnp.sum(convlstm_step_pallas(ConvLSTMParams(kk, bb), xx, hh,
                                       cc)[1].astype(jnp.float32)),
        argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(kern), jnp.asarray(bias),
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, h, c)))
    leaves = [torch.from_numpy(kern).requires_grad_(True),
              torch.from_numpy(bias).requires_grad_(True)] + [
        torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
        for a in (x, h, c)]
    loss(*ConvLSTMCellFn.apply(*leaves)).backward()
    dtypes = [torch.float32, torch.float32] + [torch.bfloat16] * 3
    for name, leaf, want, r in zip(GRAD_NAMES, leaves, dtypes, ref):
        assert leaf.grad.dtype == want, name
        r = np.asarray(r, np.float32)
        got = leaf.grad.float().numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, r, rtol=0,
                                   atol=2.0 ** -7 * np.abs(r).max(),
                                   err_msg=name)


def test_kernel_impl_runs_the_function_under_grad_only():
    """impl='kernel': with gradients the step is ConvLSTMCellFn; under
    no_grad it is the forward without z. On CPU tensors neither counts a
    kernel launch. The Function leaves c untouched (c is a residual)."""
    kern, bias, x, h, c = (torch.from_numpy(a) for a in _inputs(3))
    weight = oihw_from_hwio(kern).contiguous().requires_grad_(True)
    c_before = c.clone()
    launches = ("convlstm_cell_fwd.launches", "convlstm_cell_fwd.launches_z")
    counts = [counters()[k] for k in launches]
    hn, cn = convlstm_step(x, h, c, weight, bias, impl="kernel")
    assert type(hn.grad_fn).__name__ == "ConvLSTMCellFnBackward"
    with torch.no_grad():
        hp, cp = convlstm_step(x, h, c, weight, bias, impl="kernel")
    assert hp.grad_fn is None
    assert torch.equal(hn.detach(), hp) and torch.equal(cn.detach(), cp)
    assert torch.equal(c, c_before)
    assert [counters()[k] for k in launches] == counts


def test_z_out_checks_and_plain_write():
    kern, bias, x, h, c = (torch.from_numpy(a) for a in _inputs(5))
    z = torch.empty(2, 8, 8, 16)
    hn, cn = convlstm_cell_fwd(x, h, c, kern, bias, z_out=z)
    want = torch.nn.functional.conv2d(
        torch.cat([x, h], -1).permute(0, 3, 1, 2), oihw_from_hwio(kern), bias,
        padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(z, want, atol=1e-5, rtol=1e-5)
    meta = [t.to("meta") for t in (x, h, c, kern, bias)]
    with pytest.raises(ValueError, match="CUDA device"):
        convlstm_cell_fwd(*meta, z_out=torch.empty(2, 8, 8, 16, device="meta"))
    outs = [torch.empty_like(t) for t in meta[1:3]]
    with pytest.raises(ValueError, match="z_out must be"):
        k1._check_args(meta[0], meta[1], meta[2], meta[3], meta[4], *outs,
                       torch.empty(2, 8, 8, 12, device="meta"))
    with pytest.raises(ValueError, match="odd kernel"):
        ConvLSTMCellFn.apply(torch.zeros(2, 2, 7, 16, requires_grad=True),
                             bias, x, h, c)
