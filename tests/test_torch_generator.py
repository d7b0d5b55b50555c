"""The port's downscaling Generator and its ops against the JAX package, on
the CPU: CoordConv channels, pixel shuffle, the three resizes, the
split-input cell step, the covariate gate, the whole ``Generator`` forward
in its sizing modes and schedules, the weight bridges (flax tree, reference
``.pth`` names) and ``load_predictor``.

Inputs are made with numpy from seeds; the JAX Generator's params are its
own ``init`` (PRNGKey), carried into the port by ``weights.py``. Each
tolerance is stated where it is used.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pl_convlstm_gan_tpu.models import Generator as JaxGenerator
from pl_convlstm_gan_tpu.models.layers import \
    GatedCovariateAttention as JaxGate
from pl_convlstm_gan_tpu.ops import convlstm as jax_convlstm
from pl_convlstm_gan_tpu.ops.coords import add_coord_channels as jax_coords
from pl_convlstm_gan_tpu.ops.pixel_shuffle import pixel_shuffle as jax_shuffle
from pl_convlstm_gan_tpu.tools.import_torch_checkpoint import \
    convert_state_dict
from pl_convlstm_gan_tpu_torch.config import load_config
from pl_convlstm_gan_tpu_torch.models import Generator
from pl_convlstm_gan_tpu_torch.models.generator import (num_upsample_blocks,
                                                        resolve_scale)
from pl_convlstm_gan_tpu_torch.models.layers import (GatedCovariateAttention,
                                                     SplitInputConvLSTMCell)
from pl_convlstm_gan_tpu_torch.ops import resize
from pl_convlstm_gan_tpu_torch.ops.convlstm import (convlstm_precompute_x,
                                                    convlstm_step_precomputed,
                                                    convlstm_step_torch)
from pl_convlstm_gan_tpu_torch.ops.coords import add_coord_channels
from pl_convlstm_gan_tpu_torch.ops.nn import oihw_from_hwio
from pl_convlstm_gan_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from pl_convlstm_gan_tpu_torch.predict import build_model, load_predictor
from pl_convlstm_gan_tpu_torch.weights import (flax_to_state_dict,
                                               load_reference_pth,
                                               reference_to_flax,
                                               state_dict_to_flax)

# the module; the JAX package's ops/__init__ binds the name to a function
jax_resize = importlib.import_module("pl_convlstm_gan_tpu.ops.resize")
HIDDEN = (8, 16)
B, T, LR = 2, 3, 8
LU = 3
# float32, port against JAX: the same ops, sums taken in other orders
F32 = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, lr_hw=(LR, LR), cov_hw=(20, 20), b=B, t=T):
    rng = np.random.default_rng(seed)
    return (rng.random((b, t, 1) + lr_hw, dtype=np.float32) * 4.0,
            rng.random((b, 1) + cov_hw, dtype=np.float32),
            rng.random((b, LU) + cov_hw, dtype=np.float32))


def _pair(seed=0, jax_kwargs=None, port_kwargs=None, call_kwargs=None,
          inputs=None, dtype=None):
    """(JAX Generator, its params, port Generator with those params, the
    inputs, the JAX call's kwargs)."""
    jm = JaxGenerator(hidden_dims=HIDDEN, lu_channels=LU,
                      dtype=None if dtype is None else jnp.bfloat16,
                      **(jax_kwargs or {}))
    inputs = inputs or _inputs(seed)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), *inputs,
                                    **(call_kwargs or {})))
    pm = Generator(hidden_dims=HIDDEN, lu_channels=LU, dtype=dtype,
                   **(port_kwargs or jax_kwargs or {}))
    pm.load_state_dict(flax_to_state_dict(params))
    return jm, params, pm, inputs


def _run_both(jm, params, pm, inputs, call_kwargs=None):
    want = np.asarray(jm.apply(params, *map(jnp.asarray, inputs),
                               **(call_kwargs or {})))
    with torch.no_grad():
        got = pm(*map(torch.from_numpy, inputs)).numpy()
    return got, want


# --------------------------------------------------------------------- ops

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coord_channels_match_jax(dtype):
    """linspace planes appended after the data channel, in the input's
    dtype. The data channels pass exactly; torch and jnp compute linspace by
    other formulas, which land up to one ulp apart at values <= 1: 2^-24 in
    float32, 2^-8 in bfloat16."""
    x = np.random.default_rng(1).random((2, 5, 7, 3), dtype=np.float32)
    want = np.asarray(jax_coords(jnp.asarray(x, dtype)).astype(jnp.float32))
    got = add_coord_channels(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 5, 7, 5)
    got = got.float().numpy()
    np.testing.assert_array_equal(got[..., :3], want[..., :3])
    atol = 2.0 ** -24 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got[..., 3:], want[..., 3:], atol=atol, rtol=0)


def test_pixel_shuffle_matches_jax_and_torch_order():
    """Exact (pure data movement): the JAX NHWC op, and torch's
    F.pixel_shuffle through NCHW."""
    x = np.random.default_rng(2).random((2, 3, 4, 12), dtype=np.float32)
    got = pixel_shuffle(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_shuffle(jnp.asarray(x), 2)))
    nchw = F.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.numpy(), nchw.permute(0, 2, 3, 1).numpy())
    with pytest.raises(ValueError, match="divisible"):
        pixel_shuffle(torch.zeros(1, 2, 2, 6), 2)


@pytest.mark.parametrize("method", ["bilinear", "area", "nearest"])
@pytest.mark.parametrize("in_hw,out_hw", [
    ((8, 8), (32, 32)),       # integer upscale x4
    ((8, 6), (12, 15)),       # non-integer factors 1.5 and 2.5
    ((24, 20), (6, 5)),       # integer downscale x4
    ((20, 15), (6, 4)),       # non-integer downscale
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_matches_jax(method, in_hw, out_hw, dtype):
    """Against the JAX package's separable matrices / gather on [B, T, H, W,
    C] (leading dims kept). float32: 1e-6 (the same float32 matrix products,
    sums in other orders). bfloat16: both round one float32 result to
    bfloat16, so they may land one ulp apart where it straddles a rounding
    point: rtol 2^-7 at values in [0, 1). Nearest is a gather: exact."""
    x = np.random.default_rng(3).random((2, 3) + in_hw + (2,),
                                        dtype=np.float32)
    fn = getattr(jax_resize, f"resize_{method}")
    want = np.asarray(fn(jnp.asarray(x, dtype), *out_hw).astype(jnp.float32))
    got = getattr(resize, f"resize_{method}")(
        torch.from_numpy(x).to(getattr(torch, dtype)), *out_hw)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, 3) + out_hw + (2,)
    if method == "nearest":
        np.testing.assert_array_equal(got.float().numpy(), want)
    elif dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=0,
                                   rtol=2.0 ** -7)


def test_resize_matches_torch_interpolate_float32():
    """The edge semantics the module names: F.interpolate bilinear
    (align_corners False), legacy nearest, area, at non-integer factors;
    float32, 1e-6."""
    x = np.random.default_rng(4).random((2, 7, 9, 3), dtype=np.float32)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    for method, mode, size in (("bilinear", "bilinear", (17, 12)),
                               ("nearest", "nearest", (17, 12)),
                               ("area", "area", (3, 4))):
        kw = {"align_corners": False} if mode == "bilinear" else {}
        want = F.interpolate(nchw, size=size, mode=mode, **kw)
        got = getattr(resize, f"resize_{method}")(torch.from_numpy(x), *size)
        np.testing.assert_allclose(got.numpy(),
                                   want.permute(0, 2, 3, 1).numpy(),
                                   atol=1e-6, rtol=1e-6)


def test_split_input_step_matches_fused_step_and_jax():
    """precompute_x over the merged batch + the precomputed step equals the
    fused plain step (linearity of the conv; float32 sums in other orders:
    1e-6), and JAX's convlstm_precompute_x / convlstm_step_precomputed
    (1e-5)."""
    rng = np.random.default_rng(5)
    cx, ch, k = 4, 8, 3
    x = rng.random((2, 6, 6, cx), dtype=np.float32) - 0.5
    h = rng.random((2, 6, 6, ch), dtype=np.float32) - 0.5
    c = rng.random((2, 6, 6, ch), dtype=np.float32) - 0.5
    w = (rng.random((k, k, cx + ch, 4 * ch), dtype=np.float32) - 0.5) * 0.3
    bias = rng.random(4 * ch, dtype=np.float32) - 0.5
    tw, tb = torch.from_numpy(oihw_from_hwio(w).copy()), torch.from_numpy(bias)
    tx, th, tc = map(torch.from_numpy, (x, h, c))
    zx = convlstm_precompute_x(tx, tw, tb)
    got = convlstm_step_precomputed(zx, th, tc, tw)
    fused = convlstm_step_torch(tx, th, tc, tw, tb)
    params = jax_convlstm.ConvLSTMParams(jnp.asarray(w), jnp.asarray(bias))
    jzx = jax_convlstm.convlstm_precompute_x(params, jnp.asarray(x), cx)
    want = jax_convlstm.convlstm_step_precomputed(params, jzx, jnp.asarray(h),
                                                  jnp.asarray(c), cx)
    np.testing.assert_allclose(zx.numpy(), np.asarray(jzx), **F32)
    for g, f, j in zip(got, fused, want):
        np.testing.assert_allclose(g.numpy(), f.numpy(), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **F32)
    cell = SplitInputConvLSTMCell(cx, ch, k)
    assert [n for n, _ in cell.named_parameters()] == ["weight", "bias"]


def test_gate_once_over_batch_equals_tiled_covariate():
    """The gate computed once over B and broadcast over T equals the gate of
    the covariate tiled T-fold (exact: the convs are per sample), and the
    JAX layer (1e-5)."""
    rng = np.random.default_rng(6)
    feat = rng.random((T, B, 10, 10, 16), dtype=np.float32)
    cov = rng.random((B, 10, 10, 3), dtype=np.float32)
    jm = JaxGate(16)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(feat),
                                    jnp.asarray(cov)))
    gate = GatedCovariateAttention(3, 16)
    gate.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = gate(torch.from_numpy(feat), torch.from_numpy(cov))
        tiled = gate(torch.from_numpy(feat.reshape(T * B, 10, 10, 16)),
                     torch.from_numpy(np.tile(cov, (T, 1, 1, 1))))
    np.testing.assert_array_equal(got.numpy().reshape(T * B, 10, 10, 16),
                                  tiled.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(
        params, jnp.asarray(feat), jnp.asarray(cov))), **F32)


# --------------------------------------------------------------- Generator

def test_resolve_scale_and_blocks():
    assert resolve_scale(8, None, None) == (8.0, None)
    assert resolve_scale(None, None, None) == (1.0, None)
    # target grid: per-axis scales (y from the second entry), max of them
    assert resolve_scale(8, (500, 1000), (2000, 3000)) == (4.0, (3.0, 4.0))
    assert [num_upsample_blocks(s) for s in (1, 2, 3, 6, 8, 8.5)] == \
        [0, 1, 1, 2, 3, 3]


@pytest.mark.parametrize("case", ["scale8", "scale6", "target_sym",
                                  "target_asym", "split", "scale2"])
def test_generator_forward_matches_jax(case):
    """The whole forward, float32, atol = rtol = 1e-5 (measured ~1e-8 at
    outputs ~0.02): scale 8 (three x2 blocks), scale 6 (two blocks and the
    1.5x bilinear remainder), target_grid_size mode with equal and unequal
    axis scales (blocks by max(scale_h, scale_w), then the resize to the
    target size), split_precompute (cell 1's x side over T*B) and its
    unsplit twin at scale 2."""
    jax_kw, port_kw, call_kw = {}, None, None
    if case == "scale8":
        jax_kw = {"scale_factor": 8}
    elif case == "scale6":
        jax_kw = {"scale_factor": 6}
    elif case in ("target_sym", "target_asym"):
        grid = (1000, 1000) if case == "target_sym" else (2000, 3000)
        jax_kw = {"target_grid_size": (500, 500 if case == "target_sym"
                                       else 1000)}
        call_kw = {"input_grid_size": grid}
        port_kw = {**jax_kw, "input_grid_size": grid}
    elif case == "split":
        jax_kw = {"scale_factor": 2, "split_precompute": True}
    else:
        jax_kw = {"scale_factor": 2}
    inputs = _inputs(10, lr_hw=(LR, 10) if case == "target_asym" else
                     (LR, LR))
    jm, params, pm, inputs = _pair(10, jax_kw, port_kw, call_kw, inputs)
    got, want = _run_both(jm, params, pm, inputs, call_kw)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **F32)


def test_generator_kernel_impl_on_cpu_equals_plain_step():
    """convlstm_impl 'kernel' on CPU tensors (K1's plain version) gives the
    plain step's bits, in the forward and the gradients (ConvLSTMCellFn's
    backward against autograd: float32, 1e-5 of each tensor's largest
    gradient)."""
    jm, params, pm, inputs = _pair(11, {"scale_factor": 2})
    pk = Generator(hidden_dims=HIDDEN, lu_channels=LU, scale_factor=2,
                   convlstm_impl="kernel")
    pk.load_state_dict(pm.state_dict())
    ts = [torch.from_numpy(a) for a in inputs]
    outs = [m(*ts) for m in (pm, pk)]
    assert torch.equal(outs[0], outs[1])
    for m, o in zip((pm, pk), outs):
        o.square().mean().backward()
    for (n, a), b in zip(pm.named_parameters(), pk.parameters()):
        scale = float(a.grad.abs().max())
        np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(),
                                   atol=1e-5 * scale, rtol=0, err_msg=n)


def test_generator_bf16_matches_jax():
    """compute dtype bfloat16 against JAX's bfloat16 Generator (the JAX
    bench's parity model), scale 8. JAX rounds every conv's output and each
    gate op to bfloat16, the port rounds a conv once after a float32
    accumulation and bias add, so outputs (below 0.0625 here) may land some
    ulps apart: 1e-3 absolute, four bf16 ulps at these magnitudes (2^-12;
    measured 2.4e-4). Against the port's own float32 forward, bf16's
    rounding through the whole network: 2e-3 (measured 3.5e-4)."""
    jm, params, pm, inputs = _pair(12, {"scale_factor": 8},
                                   dtype=torch.bfloat16)
    got, want = _run_both(jm, params, pm, inputs)
    assert got.dtype == np.float32 and np.abs(want).max() < 0.0625
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    p32 = Generator(hidden_dims=HIDDEN, lu_channels=LU, scale_factor=8)
    p32.load_state_dict(pm.state_dict())
    with torch.no_grad():
        f32 = p32(*map(torch.from_numpy, inputs)).numpy()
    np.testing.assert_allclose(got, f32, atol=2e-3, rtol=0)


def test_generator_refusals():
    with pytest.raises(ValueError, match="lu_channels"):
        Generator(hidden_dims=HIDDEN, lu_channels=0, scale_factor=2)
    with pytest.raises(ValueError, match="split_precompute"):
        Generator(hidden_dims=HIDDEN, lu_channels=LU, scale_factor=2,
                  split_precompute=True, convlstm_impl="kernel")


# ------------------------------------------------------------------ weights

def test_generator_tree_round_trips():
    """flax tree -> state_dict -> flax tree is exact, and names every port
    parameter (module names follow the flax tree)."""
    _, params, pm, _ = _pair(13, {"scale_factor": 8, "split_precompute": True})
    sd = flax_to_state_dict(params)
    assert set(sd) == set(pm.state_dict())
    back = state_dict_to_flax(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)


def _reference_state_dict(params):
    """The reference PyTorch Generator's state_dict names for a flax tree
    (the inverse of the JAX tool's map, written out here)."""
    p = params["params"]
    sd = {}

    def put(name, leaf):
        sd[f"{name}.weight"] = oihw_from_hwio(np.asarray(leaf["kernel"]))
        sd[f"{name}.bias"] = np.asarray(leaf["bias"])
    put("init_conv", p["init_conv"])
    for cell, leaf in p["recurrence"].items():
        put(f"{cell}.conv", leaf)
    for attn in ("dem_attn", "lu_attn"):
        put(f"{attn}.conv.0", p[attn]["conv_reduce"])
        put(f"{attn}.conv.2", p[attn]["conv_gate"])
    i = 0
    while f"upsample_{i}" in p:
        put(f"upsample_blocks.{i}.conv", p[f"upsample_{i}"]["conv"])
        i += 1
    put("post_process.0", p["post_conv1"])
    put("post_process.2", p["post_conv2"])
    return sd


def test_reference_pth_map_matches_jax_tool(tmp_path):
    """reference_to_flax equals the JAX tool's convert_state_dict on a
    reference-named dict, exactly; a .pth bundle of it loads through
    load_predictor and serves the JAX Generator's outputs (1e-5)."""
    jm, params, pm, inputs = _pair(14, {"scale_factor": 4})
    ref_sd = _reference_state_dict(params)
    got = reference_to_flax(ref_sd)
    want = convert_state_dict(ref_sd)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    pth = tmp_path / "best_model.pth"
    torch.save({"epoch": 3, "model_state_dict": {
        k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
        ref_sd.items()}}, pth)
    assert set(load_reference_pth(str(pth))) == set(pm.state_dict())
    cfg = load_config("ci_smoke")
    cfg.model.hidden_dims, cfg.model.scale_factor = list(HIDDEN), 4
    pred = load_predictor(cfg, str(pth), device="cpu")(*inputs)
    want_out = np.asarray(jm.apply(params, *map(jnp.asarray, inputs)))
    np.testing.assert_allclose(pred.numpy(), want_out, **F32)


# ------------------------------------------------------------------ predict

def test_load_predictor_generator_matches_jax(tmp_path):
    """load_predictor on an .npz of the JAX params, in the config's sizing
    modes: scale_factor (lu_channels from the checkpoint, or given) and
    target_grid_size with input_grid_size (passed to the model as JAX's
    predict passes it to apply); float32 1e-5."""
    cfg = load_config("ci_smoke")
    cfg.model.hidden_dims = list(HIDDEN)
    for mode in ("scale", "target"):
        call_kw, jax_kw = None, {"scale_factor": 2}
        if mode == "target":
            cfg.model.scale_factor = None
            cfg.model.target_grid_size = [1000, 1000]
            cfg.model.input_grid_size = [3000, 3000]
            jax_kw = {"target_grid_size": (1000, 1000)}
            call_kw = {"input_grid_size": (3000, 3000)}
        jm, params, _, inputs = _pair(15, jax_kw, {"scale_factor": 2},
                                      call_kw)
        path = tmp_path / f"{mode}.npz"
        np.savez(path, **{"/".join(k): v for k, v in
                          _flat(params).items()})
        want = np.asarray(jm.apply(params, *map(jnp.asarray, inputs),
                                   **(call_kw or {})))
        for lu in (0, LU):
            pred = load_predictor(cfg, str(path), device="cpu",
                                  lu_channels=lu)(*inputs)
            assert pred.dtype == torch.float32
            np.testing.assert_allclose(pred.numpy(), want, **F32)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_build_model_generator_from_default_config():
    """configs/default.yaml builds the Generator at its full width: hidden
    (16, 32), three x2 blocks (scale 8), float32 or bfloat16 compute, the
    cells on K1 under convlstm_impl pallas."""
    cfg = load_config("default")
    m = build_model(cfg, lu_channels=5)
    assert isinstance(m, Generator) and m.n_blocks == 3
    assert m.hidden_dims == (16, 32) and m.convlstm_impl == "torch"
    assert m.recurrence.cell2.weight.shape == (128, 48, 3, 3)
    cfg.model.convlstm_impl = "pallas"
    cfg.precision.compute_dtype = "bfloat16"
    m = build_model(cfg, lu_channels=5)
    assert m.convlstm_impl == "kernel" and m.dtype == torch.bfloat16
    assert all(c.impl == "kernel" for c in m.recurrence.cells())
