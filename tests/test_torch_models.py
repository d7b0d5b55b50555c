"""The port's forecaster, rollout and weight bridge against the JAX package.

Weights are a flax params tree made with numpy from a seed; the JAX model
takes it as is and the port takes it through ``weights.py``. Frames are
numpy too. The JAX rollout kernel runs in interpret mode on the CPU, as
tests/test_pallas.py runs it. float32 tolerance: atol=rtol=1e-5, the one
tests/test_pallas.py uses between the Pallas rollout and the scan."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_convlstm_gan_tpu.models import ConvLSTMForecaster as JaxForecaster
from pl_convlstm_gan_tpu.ops.pallas.rollout_kernel import rollout_pallas
from pl_convlstm_gan_tpu_torch.models import ConvLSTMForecaster
from pl_convlstm_gan_tpu_torch.ops.kernels.rollout_kernel import (
    pack_weights, rollout_kernel, rollout_plain)
from pl_convlstm_gan_tpu_torch.weights import (flax_to_state_dict,
                                               state_dict_to_flax)

TOL = dict(atol=1e-5, rtol=1e-5)
T_IN, T_OUT, SIZE, B = 3, 4, 16, 2


def flax_params(seed, hidden_dims, in_channels=1, k=3):
    """A ConvLSTMForecaster flax params tree with torch-default-init ranges,
    from numpy."""
    rng = np.random.default_rng(seed)

    def conv(kk, cin, cout):
        bound = 1.0 / np.sqrt(kk * kk * cin)
        return {"kernel": rng.uniform(-bound, bound, (kk, kk, cin, cout)
                                      ).astype(np.float32),
                "bias": rng.uniform(-bound, bound, cout).astype(np.float32)}

    core, cin = {}, in_channels
    for i, ch in enumerate(hidden_dims):
        core[f"cell_{i}"] = conv(k, cin + ch, 4 * ch)
        cin = ch
    core["head"] = conv(3, cin, in_channels)
    return {"params": {"core": core}}


def frames_np(seed, b=B, t=T_IN, c=1, size=SIZE):
    return np.random.default_rng(seed).random((b, t, c, size, size),
                                              dtype=np.float32)


def port_model(params, hidden_dims, t_in=T_IN, t_out=T_OUT, dtype=None, k=3):
    model = ConvLSTMForecaster(hidden_dims, t_in, t_out, kernel_size=k,
                               dtype=dtype)
    model.load_state_dict(flax_to_state_dict(params))
    return model.eval()


def jax_apply(params, hidden_dims, frames, t_in=T_IN, t_out=T_OUT, k=3, **kw):
    model = JaxForecaster(hidden_dims=tuple(hidden_dims), input_frames=t_in,
                          output_frames=t_out, kernel_size=k)
    return np.asarray(model.apply(params, jnp.asarray(frames), **kw))


@pytest.mark.parametrize("hidden_dims,t_in", [((8, 8), T_IN), ((8, 8, 8), T_IN),
                                              ((8, 8), 2)])
def test_forecaster_free_running_matches_jax(hidden_dims, t_in):
    """2 and 3 cells; t_in=2 gives an odd step count (2 + 4 - 1 = 5)."""
    params = flax_params(1, hidden_dims)
    frames = frames_np(2, t=t_in)
    ref = jax_apply(params, hidden_dims, frames, t_in=t_in)
    with torch.no_grad():
        out = port_model(params, hidden_dims, t_in=t_in)(torch.from_numpy(frames))
    assert out.shape == ref.shape == (B, T_OUT, 1, SIZE, SIZE)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_forecaster_mixed_widths_and_k5_match_jax():
    params = flax_params(3, (8, 4), k=5)
    frames = frames_np(4)
    ref = jax_apply(params, (8, 4), frames, k=5)
    with torch.no_grad():
        out = port_model(params, (8, 4), k=5)(torch.from_numpy(frames))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_forecaster_teacher_forcing_alignment_matches_jax():
    """All-true draws (JAX teacher_forcing_prob=1.0) feed every decode step
    the previous frame's ground truth: pins the teacher alignment."""
    hidden_dims = (8, 8)
    params = flax_params(5, hidden_dims)
    frames, targets = frames_np(6), frames_np(7, t=T_OUT)
    ref = jax_apply(params, hidden_dims, frames, targets=jnp.asarray(targets),
                    teacher_forcing_prob=1.0, rng=jax.random.PRNGKey(0))
    free = jax_apply(params, hidden_dims, frames)
    assert not np.allclose(ref, free)       # the targets really were fed
    steps = T_IN + T_OUT - 1
    with torch.no_grad():
        out = port_model(params, hidden_dims)(
            torch.from_numpy(frames), torch.from_numpy(targets),
            torch.ones(steps, B, dtype=torch.bool))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    with pytest.raises(ValueError, match="teacher_draws"):
        port_model(params, hidden_dims)(torch.from_numpy(frames),
                                        torch.from_numpy(targets),
                                        torch.ones(steps - 1, B, dtype=torch.bool))


@pytest.mark.parametrize("hidden_dims", [(8, 8), (8, 8, 8)])
def test_rollout_plain_matches_jax_rollout_kernel(hidden_dims):
    params = flax_params(8, hidden_dims)
    frames = frames_np(9)
    ref = np.asarray(rollout_pallas(params, jnp.asarray(frames), T_OUT,
                                    compute_dtype=jnp.float32))
    weights = pack_weights(flax_to_state_dict(params), torch.float32)
    out = rollout_plain(weights, torch.from_numpy(frames), T_OUT, torch.float32)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # on CPU tensors the kernel rollout runs the wrappers' plain versions
    assert torch.equal(rollout_kernel(weights, torch.from_numpy(frames), T_OUT,
                                      torch.float32), out)


def test_rollout_plain_bf16_matches_jax_rollout_kernel():
    """bf16 compute with the TPU kernel's rounding points (bf16 weights,
    frames and state; f32 accumulation and gates). Tolerance 1e-3 absolute:
    the outputs here are below 0.07, where one bf16 ulp is 2^-12 = 2.4e-4;
    the two sides sum in different orders, so a stored value can land an
    ulp apart and be carried through the 6 recurrent steps (measured: one
    ulp)."""
    hidden_dims = (8, 8, 8)
    params = flax_params(10, hidden_dims)
    frames = frames_np(11)
    ref = np.asarray(rollout_pallas(params, jnp.asarray(frames), T_OUT,
                                    compute_dtype=jnp.bfloat16))
    assert np.abs(ref).max() < 0.0625
    weights = pack_weights(flax_to_state_dict(params), torch.bfloat16)
    out = rollout_plain(weights, torch.from_numpy(frames), T_OUT, torch.bfloat16)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=0)
    # the plain forecaster in bf16 has the same rounding points and the
    # same convs, so it gives the same bits
    with torch.no_grad():
        fwd = port_model(params, hidden_dims, dtype=torch.bfloat16)(
            torch.from_numpy(frames))
    assert torch.equal(fwd, out)


def test_pack_weights_rejects_even_kernel():
    params = flax_params(12, (8, 8), k=4)
    with pytest.raises(ValueError, match="odd"):
        pack_weights(flax_to_state_dict(params), torch.float32)


def test_weights_round_trip_is_exact():
    params = flax_params(13, (8, 4, 8))
    state = flax_to_state_dict(params)
    assert state["core.cell_0.weight"].shape == (32, 9, 3, 3)      # OIHW
    assert state["core.cell_1.weight"].shape == (16, 12, 3, 3)
    assert state["core.head.weight"].shape == (1, 8, 3, 3)
    np.testing.assert_array_equal(
        state["core.cell_0.weight"].numpy(),
        params["params"]["core"]["cell_0"]["kernel"].transpose(3, 2, 0, 1))
    back = state_dict_to_flax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # a flat '/'-keyed tree (flatten_dict(sep='/')) maps to the same state
    flat = {"/".join(str(k.key) for k in path): leaf for path, leaf in flat_a}
    assert "params/core/cell_0/kernel" in flat
    flat_state = flax_to_state_dict(flat)
    assert flat_state.keys() == state.keys()
    assert all(torch.equal(flat_state[k], state[k]) for k in state)
    # and the port's modules take it
    model = ConvLSTMForecaster((8, 4, 8), T_IN, T_OUT)
    model.load_state_dict(state)
    assert all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
