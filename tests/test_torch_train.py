"""The port's forecaster train and eval steps, losses, data and Adam-state
bridge against the JAX package.

Both packages start from one state: a flax params tree made with numpy from
a seed, its optax Adam state carried into ``torch.optim.Adam`` by
``weights.py``. Scheduled-sampling draws are JAX's own
(``jax.random.bernoulli(rng, p, (steps, B))``, the draws the JAX forecaster
makes from the step's rng), passed to the port as ``teacher_draws``. The
JAX Pallas cell runs in interpret mode, as tests/test_pallas.py runs it.
Everything is float32; each tolerance is stated where it is used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pl_convlstm_gan_tpu.data import (SyntheticSequenceDataset as JaxSynth,
                                      batch_iterator as jax_batch_iterator,
                                      eval_batches as jax_eval_batches,
                                      split_dataset_random as jax_split)
from pl_convlstm_gan_tpu.losses.adversarial import l1_loss as jax_l1
from pl_convlstm_gan_tpu.losses.ssim import ssim_per_sample as jax_ssim
from pl_convlstm_gan_tpu.models import ConvLSTMForecaster as JaxForecaster
from pl_convlstm_gan_tpu.train import steps as jax_steps
from pl_convlstm_gan_tpu_torch import data as port_data
from pl_convlstm_gan_tpu_torch.losses import ssim_per_sample
from pl_convlstm_gan_tpu_torch.models import ConvLSTMForecaster
from pl_convlstm_gan_tpu_torch.train.steps import (
    TrainState, aggregate_epoch_metrics, aggregate_sequence_eval,
    clip_by_global_norm_, forecaster_eval_step, forecaster_loss,
    forecaster_train_step, make_optimizer)
from pl_convlstm_gan_tpu_torch.weights import (flax_to_state_dict,
                                               load_optax_adam_state,
                                               optax_adam_state)
from test_torch_models import flax_params

HIDDEN = (8,)
T_IN, T_OUT, SIZE, B = 3, 4, 8, 2
STEPS = T_IN + T_OUT - 1
LR = 1e-3


def _batch(seed, n=B):
    ds = JaxSynth(num_sequences=n, input_frames=T_IN, output_frames=T_OUT,
                  image_size=SIZE, seed=seed)
    return tuple(np.stack(a) for a in zip(*(ds[i] for i in range(n))))


def _jax_side(params, impl, clip=0.5):
    model = JaxForecaster(hidden_dims=HIDDEN, input_frames=T_IN,
                          output_frames=T_OUT, convlstm_impl=impl)
    tx = jax_steps.make_optimizer(clip)
    state = jax_steps.TrainState(params, tx.init(params),
                                 jnp.zeros((), jnp.int32))
    return model, jax_steps.make_forecaster_train_step(model.apply, tx), state


def _port_side(params, opt_state, impl):
    model = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT, convlstm_impl=impl)
    model.load_state_dict(flax_to_state_dict(params))
    optimizer = make_optimizer(model)
    load_optax_adam_state(optimizer, model, opt_state)
    return TrainState(model, optimizer, 0)


def _max_rel(got, want):
    """max |got - want| relative to max |want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("impl,port_impl,tf_prob,clip", [
    ("pallas", "kernel", 0.0, 0.5), ("pallas", "kernel", 0.5, 0.5),
    ("xla", "torch", 0.0, 0.5), ("xla", "torch", 0.5, 0.5),
    ("xla", "torch", 0.0, 5.0)])
def test_train_step_matches_jax(impl, port_impl, tf_prob, clip):
    """Three steps from one state: loss, gradients, params and Adam moments
    after each step. The gradients' global norm here is ~1.15, so clip 0.5
    scales every step and clip 5.0 none.

    Bounds, float32 on both sides:
    - loss: rtol 1e-5 (the same rollout, sums in other orders; measured
      3.6e-7);
    - gradients: 1e-4 of each tensor's largest magnitude (the rollout's
      recurrence and the convs' sums in other orders; measured 1.4e-6);
    - Adam moments: 1e-4 of each tensor's largest magnitude, from the
      gradient bound (mu is linear in g, nu quadratic; measured 1.1e-6);
    - params: Adam's first update is g / (|g| + eps) ~ sign(g), so an
      element whose gradient lies within the gradient bound of 0 may take
      the other sign and land up to 2 lr away per step; everywhere else the
      update is sign-stable and the params agree to 1e-6 absolute (values
      below 0.5, updates of lr; measured 9e-8)."""
    params = flax_params(31, HIDDEN)
    model_j, step_j, state_j = _jax_side(params, impl, clip)
    state_p = _port_side(params, state_j.opt_state, port_impl)
    flagged = {k: np.zeros(v.shape, bool) for k, v in
               state_p.model.state_dict().items()}
    for i in range(3):
        inputs, targets = _batch(40 + i)
        rng = jax.random.PRNGKey(100 + i)
        draws = np.array(jax.random.bernoulli(rng, tf_prob, (STEPS, B)))
        tin, ttg = torch.from_numpy(inputs), torch.from_numpy(targets)

        def loss_j(p):
            return jax_l1(model_j.apply(p, jnp.asarray(inputs),
                                        targets=jnp.asarray(targets),
                                        teacher_forcing_prob=tf_prob,
                                        rng=rng), jnp.asarray(targets))
        grads_j = flax_to_state_dict(jax.grad(loss_j)(state_j.params))
        state_p.optimizer.zero_grad(set_to_none=True)
        forecaster_loss(state_p.model, tin, ttg,
                        torch.from_numpy(draws))[0].backward()
        for name, p in state_p.model.named_parameters():
            want = grads_j[name].numpy()
            assert _max_rel(p.grad.numpy(), want) <= 1e-4, (i, name)
            flagged[name] |= np.abs(want) <= 1e-4 * np.abs(want).max()

        state_j, m_j = step_j(state_j, (jnp.asarray(inputs),
                                        jnp.asarray(targets)),
                              jnp.asarray(LR, jnp.float32),
                              jnp.asarray(tf_prob, jnp.float32), rng)
        m_p = forecaster_train_step(state_p, (tin, ttg), LR,
                                    torch.from_numpy(draws), clip)
        assert m_p["skipped"] == int(m_j["skipped"]) == 0
        np.testing.assert_allclose(m_p["total"], float(m_j["total"]),
                                   rtol=1e-5)
        assert state_p.step == int(state_j.step) == i + 1

        params_j = flax_to_state_dict(jax.device_get(state_j.params))
        for name, p in state_p.model.state_dict().items():
            diff = np.abs(p.numpy() - params_j[name].numpy())
            bound = np.where(flagged[name], 2 * LR * (i + 1) + 1e-6, 1e-6)
            assert (diff <= bound).all(), (i, name, float(diff.max()))
        adam_p = optax_adam_state(state_p.optimizer, state_p.model)
        adam_j = state_j.opt_state[1]
        assert int(adam_p["count"]) == int(adam_j.count) == i + 1
        for key in ("mu", "nu"):
            got = flax_to_state_dict(adam_p[key])
            want = flax_to_state_dict(jax.device_get(getattr(adam_j, key)))
            for name in got:
                assert _max_rel(got[name].numpy(), want[name].numpy()) \
                    <= 1e-4, (i, key, name)


@pytest.mark.parametrize("norm", [0.3, 0.7])
def test_clip_matches_optax_on_both_sides_of_the_bound(norm):
    """The hand-written clip against optax.clip_by_global_norm(0.5), below
    and above the bound (float32: 1e-7 relative, one rounding apart)."""
    rng = np.random.default_rng(int(norm * 10))
    grads = [rng.standard_normal(s).astype(np.float32) for s in
             ((4, 3, 3, 3), (4,), (2, 5))]
    total = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    grads = [g * np.float32(norm / total) for g in grads]
    want, _ = optax.clip_by_global_norm(0.5).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    out_norm = clip_by_global_norm_(got, 0.5)
    np.testing.assert_allclose(float(out_norm), norm, rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-8)
    clipped = np.sqrt(sum((g.numpy().astype(np.float64) ** 2).sum()
                          for g in got))
    assert clipped == pytest.approx(min(norm, 0.5), rel=1e-6)


def test_nan_skip_keeps_params_and_adam_state():
    """A non-finite loss: params, exp_avg, exp_avg_sq and Adam's own step
    stay as they were; the state's step still advances; skipped == 1."""
    params = flax_params(33, HIDDEN)
    opt_state = optax.chain(optax.clip_by_global_norm(0.5),
                            optax.scale_by_adam()).init(params)
    state = _port_side(params, opt_state, "kernel")
    inputs, targets = (torch.from_numpy(a) for a in _batch(50))
    forecaster_train_step(state, (inputs, targets), LR)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    adam_before = {k: {n: v.clone() for n, v in s.items()}
                   for k, s in state.optimizer.state_dict()["state"].items()}
    bad = inputs.clone()
    bad[0, 0, 0, 0, 0] = float("nan")
    m = forecaster_train_step(state, (bad, targets), LR)
    assert m["skipped"] == 1 and not np.isfinite(m["total"])
    assert state.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, s in state.optimizer.state_dict()["state"].items():
        for n, v in s.items():
            assert torch.equal(v, adam_before[k][n]), (k, n)
    assert int(state.optimizer.state_dict()["state"][0]["step"]) == 1


def test_epoch_metrics_leave_out_skipped_batches():
    acc = [{"total": 1.0, "skipped": 0}, {"total": float("nan"), "skipped": 1},
           {"total": 3.0, "skipped": 0}]
    want = jax_steps.aggregate_epoch_metrics(
        [{k: jnp.asarray(v) for k, v in m.items()} for m in acc])
    got = aggregate_epoch_metrics(acc)
    assert got == pytest.approx(want) and got["total"] == 2.0
    assert got["skipped"] == 1.0
    all_skipped = aggregate_epoch_metrics([acc[1]])
    assert np.isnan(all_skipped["total"]) and all_skipped["skipped"] == 1.0


def test_eval_step_and_aggregate_match_jax():
    """Free rollout metrics over a dataset of 5 sequences at B 2: the last
    batch is wrap-padded (n_valid 1). l1, ssim and the sharpness ratios to
    rtol 1e-5 (float32 sums in other orders; the host sums in float64 on
    both sides); POD/FAR/CSI/HSS at two thresholds from contingency counts
    (the head bias puts the predictions around the thresholds)."""
    params = flax_params(35, HIDDEN)
    params["params"]["core"]["head"]["bias"][:] = 0.35
    model_j = JaxForecaster(hidden_dims=HIDDEN, input_frames=T_IN,
                            output_frames=T_OUT)
    thresholds = (0.2, 0.4)
    eval_j = jax_steps.make_forecaster_eval_step(model_j.apply, thresholds,
                                                 sharpness=True)
    model_p = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT, convlstm_impl="kernel")
    model_p.load_state_dict(flax_to_state_dict(params))
    ds = port_data.SyntheticSequenceDataset(5, T_IN, T_OUT, SIZE, seed=3)
    acc_j, acc_p = [], []
    for (batch, n_valid) in port_data.eval_batches(ds, B):
        acc_j.append(eval_j(params, tuple(jnp.asarray(a) for a in batch),
                            jnp.asarray(n_valid, jnp.int32)))
        acc_p.append(forecaster_eval_step(
            model_p, tuple(torch.from_numpy(a) for a in batch), n_valid,
            thresholds, sharpness=True))
    assert n_valid == 1
    want = jax_steps.aggregate_sequence_eval(acc_j)
    got = aggregate_sequence_eval(acc_p)
    assert set(got) == set(want)
    assert 0 < want["csi@0.2"] < 1 and 0 < want["far@0.4"] < 1
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k


def test_ssim_matches_jax_with_blank_and_small_frames():
    """SSIM with a blank (zero-variance) target, where the clamps of the
    variance and the covariance act, and the effective window of frames
    smaller than 11 px (rtol 1e-5: float32 blurs summed in other
    orders)."""
    rng = np.random.default_rng(9)
    for size in (16, 8, 6):
        pred = rng.random((2, 3, 1, size, size), dtype=np.float32)
        tgt = rng.random((2, 3, 1, size, size), dtype=np.float32)
        tgt[0] = 0.25                                   # a blank sample
        want = np.asarray(jax_ssim(jnp.asarray(pred), jnp.asarray(tgt)))
        got = ssim_per_sample(torch.from_numpy(pred), torch.from_numpy(tgt))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_data_is_bit_identical_to_jax():
    """SyntheticSequenceDataset items, split_dataset_random membership and
    batch_iterator / eval_batches batches equal the JAX copies bit for
    bit."""
    args = dict(num_sequences=11, input_frames=2, output_frames=3,
                image_size=24, seed=4)
    ds_j, ds_p = JaxSynth(**args), port_data.SyntheticSequenceDataset(**args)
    for i in (0, 5, 10):
        for a, b in zip(ds_j[i], ds_p[i]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for sj, sp in zip(jax_split(ds_j, seed=42), port_data.split_dataset_random(
            ds_p, seed=42)):
        assert sj.indices == sp.indices
    for kw in (dict(shuffle=True, seed=3, epoch=2), dict(shuffle=False)):
        bj = list(jax_batch_iterator(ds_j, 4, **kw))
        bp = list(port_data.batch_iterator(ds_p, 4, **kw))
        assert len(bj) == len(bp) == 2
        for x, y in zip(bj, bp):
            assert all(np.array_equal(a, b) for a, b in zip(x, y))
    for (xj, nj), (xp, np_) in zip(jax_eval_batches(ds_j, 4),
                                   port_data.eval_batches(ds_p, 4)):
        assert nj == np_ and all(np.array_equal(a, b) for a, b in zip(xj, xp))
    assert np_ == 3


def test_adam_state_round_trip_optax_torch_optax_is_exact():
    """optax -> torch.optim.Adam -> optax after two JAX steps (non-zero
    moments, count 2): every moment and the count come back exactly."""
    params = flax_params(37, HIDDEN)
    model_j, step_j, state_j = _jax_side(params, "xla")
    for i in range(2):
        inputs, targets = _batch(60 + i)
        state_j, _ = step_j(state_j, (jnp.asarray(inputs),
                                      jnp.asarray(targets)),
                            jnp.asarray(LR, jnp.float32),
                            jnp.asarray(0.0, jnp.float32),
                            jax.random.PRNGKey(i))
    state_p = _port_side(jax.device_get(state_j.params),
                         jax.device_get(state_j.opt_state), "torch")
    st = state_p.optimizer.state_dict()["state"]
    assert len(st) == 4 and all(float(s["step"]) == 2.0 for s in st.values())
    back = optax_adam_state(state_p.optimizer, state_p.model)
    adam_j = state_j.opt_state[1]
    rebuilt = optax.ScaleByAdamState(
        count=jnp.asarray(back["count"]), mu=back["mu"], nu=back["nu"])
    assert int(rebuilt.count) == int(adam_j.count) == 2
    assert (jax.tree_util.tree_structure(rebuilt.mu)
            == jax.tree_util.tree_structure(jax.device_get(adam_j.mu)))
    for key in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(getattr(rebuilt, key)),
                        jax.tree_util.tree_leaves(getattr(adam_j, key))):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(b))
