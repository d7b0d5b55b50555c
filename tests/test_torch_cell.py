"""The port's ConvLSTM cell step and kernel wrappers against the JAX package.

Inputs and weights are made with numpy from a seed and handed to both
packages. The JAX Pallas cell runs as tests/test_pallas.py runs it, in
interpret mode on the CPU. Tolerance: atol=rtol=1e-5 in float32, the
tolerance tests/test_pallas.py holds the Pallas kernel to against the scan
(the two sides sum the conv in different orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_convlstm_gan_tpu.ops.convlstm import ConvLSTMParams, convlstm_step_xla
from pl_convlstm_gan_tpu.ops.pallas.convlstm_kernel import convlstm_step_pallas
from pl_convlstm_gan_tpu_torch.config import Config, load_config, rollout_path
from pl_convlstm_gan_tpu_torch.ops.convlstm import convlstm_step, convlstm_step_torch
from pl_convlstm_gan_tpu_torch.ops.kernels.convlstm_kernel import (
    convlstm_cell_fwd, convlstm_cell_plain)
from pl_convlstm_gan_tpu_torch.ops.kernels.rollout_kernel import (
    conv_head_fwd, conv_head_plain)
from pl_convlstm_gan_tpu_torch.ops.nn import hwio_from_oihw, oihw_from_hwio

TOL = dict(atol=1e-5, rtol=1e-5)


def _cell_inputs(seed, cx, ch, k, b=2, size=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, size, size, cx), dtype=np.float32)
    h = rng.standard_normal((b, size, size, ch), dtype=np.float32)
    c = rng.standard_normal((b, size, size, ch), dtype=np.float32)
    kern = rng.standard_normal((k, k, cx + ch, 4 * ch), dtype=np.float32) * 0.1
    bias = rng.standard_normal(4 * ch, dtype=np.float32) * 0.1
    return x, h, c, kern, bias


def _port_step(x, h, c, kern, bias):
    t = [torch.from_numpy(a) for a in (x, h, c)]
    hn, cn = convlstm_step_torch(*t, torch.from_numpy(oihw_from_hwio(kern).copy()),
                                 torch.from_numpy(bias))
    return hn.numpy(), cn.numpy()


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("cx,k", [(1, 3), (8, 3), (1, 5), (8, 5)])
def test_cell_step_matches_jax(reference, cx, k):
    x, h, c, kern, bias = _cell_inputs(cx * 10 + k, cx, 8, k)
    ref_fn = convlstm_step_xla if reference == "xla" else convlstm_step_pallas
    h_ref, c_ref = ref_fn(ConvLSTMParams(jnp.asarray(kern), jnp.asarray(bias)),
                          jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    h_pt, c_pt = _port_step(x, h, c, kern, bias)
    np.testing.assert_allclose(h_pt, np.asarray(h_ref), **TOL)
    np.testing.assert_allclose(c_pt, np.asarray(c_ref), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cell_wrapper_on_cpu_is_plain_and_writes_in_place(dtype):
    """On CPU tensors the K1 wrapper runs its plain version, writes h' into
    the given buffer and updates c in place; no kernel launch is counted."""
    x, h, c, kern, bias = (torch.from_numpy(a).to(dtype)
                           for a in _cell_inputs(3, 1, 8, 3))
    h_ref, c_ref = convlstm_cell_plain(x, h, c, kern, bias)
    h_out, c_buf = torch.empty_like(h), c.clone()
    before = convlstm_cell_fwd.launches
    res = convlstm_cell_fwd(x, h, c_buf, kern, bias, h_out, c_buf)
    assert res[0] is h_out and res[1] is c_buf
    assert convlstm_cell_fwd.launches == before
    assert torch.equal(h_out, h_ref) and torch.equal(c_buf, c_ref)
    # the impl-dispatching step takes OIHW weights and gives the same result
    hk, ck = convlstm_step(x, h, c, oihw_from_hwio(kern), bias, impl="kernel")
    assert torch.equal(hk, h_ref) and torch.equal(ck, c_ref)
    with pytest.raises(ValueError, match="impl"):
        convlstm_step(x, h, c, oihw_from_hwio(kern), bias, impl="pallas")


def test_cell_bf16_rounding_points():
    """bf16 operands: f32 accumulation and gates, one rounding at the store
    (the TPU rollout kernel's rounding points): equal to the f32 step on the
    bf16-rounded inputs, rounded once."""
    x, h, c, kern, bias = (torch.from_numpy(a).to(torch.bfloat16)
                           for a in _cell_inputs(4, 8, 8, 3))
    hb, cb = convlstm_cell_plain(x, h, c, kern, bias)
    hf, cf = convlstm_cell_plain(*(t.float() for t in (x, h, c, kern, bias)))
    assert hb.dtype == cb.dtype == torch.bfloat16
    assert torch.equal(hb, hf.to(torch.bfloat16))
    assert torch.equal(cb, cf.to(torch.bfloat16))


def test_head_matches_jax_conv():
    from pl_convlstm_gan_tpu.ops.nn import conv2d
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 16, 16, 8), dtype=np.float32)
    kern = rng.standard_normal((3, 3, 8, 1), dtype=np.float32) * 0.1
    bias = rng.standard_normal(1, dtype=np.float32)
    ref = conv2d(jnp.asarray(h), jnp.asarray(kern), jnp.asarray(bias), padding=1)
    out = conv_head_plain(*(torch.from_numpy(a) for a in (h, kern, bias)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    buf = torch.empty_like(out)
    before = conv_head_fwd.launches
    assert conv_head_fwd(*(torch.from_numpy(a) for a in (h, kern, bias)),
                         buf) is buf
    assert conv_head_fwd.launches == before
    assert torch.equal(buf, out)


def test_cell_wrapper_rejects_bad_operands():
    """CUDA-side argument checks run before any launch. Tensors on the meta
    device stand in for tensors that are not on the CPU."""
    x, h, c, kern, bias = (torch.from_numpy(a) for a in _cell_inputs(6, 1, 8, 3))
    meta = [t.to("meta") for t in (x, h, c, kern, bias)]
    with pytest.raises(ValueError, match="CUDA device"):
        convlstm_cell_fwd(*meta)
    with pytest.raises(ValueError, match="CUDA device"):
        conv_head_fwd(h.to("meta"), torch.zeros(3, 3, 8, 1, device="meta"),
                      torch.zeros(1, device="meta"))


def test_hwio_oihw_round_trip():
    w = np.arange(3 * 3 * 5 * 7, dtype=np.float32).reshape(3, 3, 5, 7)
    assert oihw_from_hwio(w).shape == (7, 5, 3, 3)
    np.testing.assert_array_equal(hwio_from_oihw(oihw_from_hwio(w)), w)
    t = torch.from_numpy(w)
    assert torch.equal(hwio_from_oihw(oihw_from_hwio(t)), t)


def test_config_reads_repo_yaml_and_validates_port_impls():
    cfg = load_config("nowcast_128")
    assert cfg.model.family == "forecaster"
    assert cfg.model.hidden_dims == [64, 64, 64]
    assert (cfg.model.input_frames, cfg.model.output_frames) == (5, 20)
    assert cfg.training.batch_size == 4
    # the port's values and the JAX package's (xla -> torch, pallas ->
    # kernel) validate; int8 is refused by name; anything else is unknown
    for impl, path in (("auto", "auto"), ("torch", "torch"),
                       ("kernel", "kernel"), ("xla", "torch"),
                       ("pallas", "kernel")):
        cfg.model.rollout_impl = impl
        cfg.validate()
        assert rollout_path(impl) == path
    cfg.model.rollout_impl = "int8"
    with pytest.raises(ValueError, match="'int8'.*A13"):
        cfg.validate()
    cfg.model.rollout_impl = "mosaic"
    with pytest.raises(ValueError, match="Unknown rollout_impl"):
        cfg.validate()
    assert not hasattr(Config, "apply_debug_flags")
