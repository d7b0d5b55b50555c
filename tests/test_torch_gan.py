"""The port's GAN pieces against the JAX package: the discriminator, the
adversarial losses and the GAN train step.

Both packages start from one state: flax params trees made with numpy from
a seed (torch-default-init ranges), a JAX ``GANTrainState`` carried into the
port's by ``weights.load_gan_train_state``. Scheduled-sampling draws are
JAX's own (``jax.random.bernoulli(rng, p, (steps, B))``, the draws the JAX
forecaster makes from the step's rng), passed to the port as
``teacher_draws``. The JAX Pallas cell runs in interpret mode, as
tests/test_torch_train.py runs it. Each tolerance is stated where it is
used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_convlstm_gan_tpu.data import SyntheticSequenceDataset as JaxSynth
from pl_convlstm_gan_tpu.losses import adversarial as jax_adv
from pl_convlstm_gan_tpu.models import ConvLSTMForecaster as JaxForecaster
from pl_convlstm_gan_tpu.models import Discriminator as JaxDiscriminator
from pl_convlstm_gan_tpu.train import steps as jax_steps
from pl_convlstm_gan_tpu_torch import losses
from pl_convlstm_gan_tpu_torch.models import (ConvLSTMForecaster,
                                              Discriminator)
from pl_convlstm_gan_tpu_torch.train.steps import (GANTrainState,
                                                   gan_train_step,
                                                   make_optimizer)
from pl_convlstm_gan_tpu_torch.weights import (flax_to_state_dict,
                                               gan_train_state_to_jax,
                                               load_gan_train_state)
from test_torch_models import flax_params

HIDDEN = (8,)
FEATURES = (8, 16)
T_IN, T_OUT, SIZE, B = 2, 3, 16, 2
STEPS = T_IN + T_OUT - 1
G_LR, D_LR = 1e-3, 2e-3
LAMBDA_ADV = 0.1        # above the configs' 0.001, so the adversarial term
                        # moves G's gradient visibly
BF16_ULP = 2.0 ** -7    # bfloat16 spacing relative to the leading power of 2


def _batch(seed, n=B):
    ds = JaxSynth(num_sequences=n, input_frames=T_IN, output_frames=T_OUT,
                  image_size=SIZE, seed=seed)
    return tuple(np.stack(a) for a in zip(*(ds[i] for i in range(n))))


def disc_params(seed, features=FEATURES, in_channels=1):
    """A Discriminator flax params tree with torch-default-init ranges."""
    rng = np.random.default_rng(seed)

    def conv(cin, cout):
        bound = 1.0 / np.sqrt(16 * cin)
        return {"kernel": rng.uniform(-bound, bound, (4, 4, cin, cout)
                                      ).astype(np.float32),
                "bias": rng.uniform(-bound, bound, cout).astype(np.float32)}

    tree, cin = {}, in_channels
    for i, feat in enumerate(features):
        tree[f"conv_{i}"] = conv(cin, feat)
        cin = feat
    tree["conv_out"] = conv(cin, 1)
    return {"params": tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_discriminator_matches_jax(dtype):
    """Patch logits [B, T, 1, 3, 3] of 16 px frames on the same weights.
    float32: atol=rtol=1e-5 (sums in other orders). bfloat16: both round
    each layer's output to bf16, JAX after the conv and again after its
    bias add, the port once after both, so a layer's values may sit one
    ulp apart and the last layer adds its own: within 2 bf16 ulps of the
    largest logit."""
    params = disc_params(3)
    frames = np.random.default_rng(4).random((B, 3, 1, SIZE, SIZE),
                                             dtype=np.float32)
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else None
    want = np.asarray(JaxDiscriminator(features=FEATURES, dtype=jdtype)
                      .apply(params, jnp.asarray(frames)))
    disc = Discriminator(1, FEATURES, getattr(torch, dtype)
                         if dtype == "bfloat16" else None)
    disc.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = disc(torch.from_numpy(frames))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert tuple(got.shape) == want.shape == (B, 3, 1, 3, 3)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        top = 2.0 ** np.floor(np.log2(np.abs(want).max()))
        assert np.abs(got.numpy() - want).max() <= 2 * BF16_ULP * top


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_gan_losses_match_jax(smoothing):
    """bce_with_logits, discriminator_loss (with and without one-sided
    label smoothing), generator_adversarial_loss, gan_generator_loss and
    l2_loss on logits that reach |x| ~ 30 (the log-sum-exp form's range),
    at 1e-6 relative (float32, one mean in another order)."""
    rng = np.random.default_rng(int(smoothing * 10) + 5)
    real = (rng.standard_normal((2, 3, 1, 4, 4)) * 10).astype(np.float32)
    fake = (rng.standard_normal((2, 3, 1, 4, 4)) * 10).astype(np.float32)
    fake.flat[0], real.flat[1] = 30.0, -30.0
    pred = rng.random((2, 3, 1, 8, 8), dtype=np.float32)
    tgt = rng.random((2, 3, 1, 8, 8), dtype=np.float32)
    t = lambda a: torch.from_numpy(a)
    j = lambda a: jnp.asarray(a)
    close = lambda got, want: np.testing.assert_allclose(
        float(got), float(want), rtol=1e-6)

    close(losses.bce_with_logits(t(real), 1.0 - smoothing),
          jax_adv.bce_with_logits(j(real), jnp.full_like(j(real),
                                                          1.0 - smoothing)))
    got, parts = losses.discriminator_loss(t(real), t(fake), smoothing)
    want, want_parts = jax_adv.discriminator_loss(j(real), j(fake), smoothing)
    close(got, want)
    assert set(parts) == set(want_parts) == {"d_real", "d_fake"}
    for k in parts:
        close(parts[k], want_parts[k])
    close(losses.generator_adversarial_loss(t(fake)),
          jax_adv.generator_adversarial_loss(j(fake)))
    got, parts = losses.gan_generator_loss(t(fake), t(pred), t(tgt), 0.01, 1.0)
    want, want_parts = jax_adv.gan_generator_loss(j(fake), j(pred), j(tgt),
                                                  0.01, 1.0)
    close(got, want)
    assert set(parts) == set(want_parts) == {"g_adv", "g_l1"}
    for k in parts:
        close(parts[k], want_parts[k])
    close(losses.l2_loss(t(pred), t(tgt)), jax_adv.l2_loss(j(pred), j(tgt)))


def _jax_gan(impl, step_impl, seed):
    gen = JaxForecaster(hidden_dims=HIDDEN, input_frames=T_IN,
                        output_frames=T_OUT, convlstm_impl=impl)
    disc = JaxDiscriminator(features=FEATURES)
    gp, dp = flax_params(seed, HIDDEN), disc_params(seed + 1)
    gtx, dtx = jax_steps.make_optimizer(0.5), jax_steps.make_optimizer(0.5)
    state = jax_steps.GANTrainState(gp, dp, gtx.init(gp), dtx.init(dp),
                                    jnp.zeros((), jnp.int32))
    step = jax_steps.make_gan_train_step(gen.apply, disc.apply, gtx, dtx,
                                         LAMBDA_ADV, 1.0, impl=step_impl)
    return step, state


def _port_gan(jax_state, port_impl):
    gen = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT, convlstm_impl=port_impl)
    disc = Discriminator(1, FEATURES)
    state = GANTrainState(gen, disc, make_optimizer(gen),
                          make_optimizer(disc))
    load_gan_train_state(state, jax.device_get(jax_state))
    return state


def _check_tree(got, want, what):
    """Every leaf of two flax-style trees at atol=rtol=1e-5."""
    got, want = flax_to_state_dict(got), flax_to_state_dict(want)
    assert set(got) == set(want), what
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-5,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("jax_impl,port_impl,step_impl,tf_prob", [
    ("xla", "torch", "default", 0.0),
    ("xla", "torch", "vjp", 1.0),
    ("pallas", "kernel", "default", 0.5),
    ("pallas", "kernel", "vjp", 0.0),
])
def test_gan_step_matches_jax(jax_impl, port_impl, step_impl, tf_prob):
    """Three GAN steps from one carried GANTrainState, against
    make_gan_train_step, checked after every step (so after 1 and after 3):
    the metrics (d_total, g_total and their parts, skipped) to 1e-5
    relative; G and D params and both Adam states (mu, nu to atol=rtol=
    1e-5; count and step exactly), all float32. Adam's first updates are
    ~lr * sign(g); no gradient element here lies within the gradient error
    of 0, so every update agrees."""
    step_j, state_j = _jax_gan(jax_impl, step_impl, 41)
    state_p = _port_gan(state_j, port_impl)
    for i in range(3):
        inputs, targets = _batch(70 + i)
        rng = jax.random.PRNGKey(200 + i)
        draws = np.array(jax.random.bernoulli(rng, tf_prob, (STEPS, B)))
        state_j, m_j = step_j(state_j, (jnp.asarray(inputs),
                                        jnp.asarray(targets)),
                              jnp.asarray(G_LR, jnp.float32),
                              jnp.asarray(D_LR, jnp.float32),
                              jnp.asarray(tf_prob, jnp.float32), rng)
        m_p = gan_train_step(state_p, (torch.from_numpy(inputs),
                                       torch.from_numpy(targets)),
                             G_LR, D_LR, torch.from_numpy(draws),
                             LAMBDA_ADV, 1.0, impl=step_impl)
        m_j = jax.device_get(m_j)
        assert set(m_p) == set(m_j)
        assert m_p["skipped"] == int(m_j["skipped"]) == 0
        for k in m_j:
            np.testing.assert_allclose(m_p[k], float(m_j[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        want = jax.device_get(state_j)
        got = gan_train_state_to_jax(state_p)
        assert int(got["step"]) == int(want.step) == i + 1
        _check_tree(got["gen_params"], want.gen_params, f"step {i} G")
        _check_tree(got["disc_params"], want.disc_params, f"step {i} D")
        for side in ("gen", "disc"):
            adam_p = got[f"{side}_opt_state"]
            adam_j = getattr(want, f"{side}_opt_state")[1]
            assert int(adam_p["count"]) == int(adam_j.count) == i + 1
            for key in ("mu", "nu"):
                _check_tree(adam_p[key], getattr(adam_j, key),
                            f"step {i} {side} {key}")


def test_vjp_step_equals_default_step():
    """In the port, impl "vjp" (one G forward, its graph kept across the D
    update) equals "default" (two forwards) over one step on the kernel
    path with scheduled sampling, with the JAX test's own bounds
    (tests/test_sequence_trainer.py:100-107): losses 1e-6 + 1e-5 relative,
    G params rtol 1e-5, atol 1e-6."""
    _, state_j = _jax_gan("xla", "default", 43)
    inputs, targets = (torch.from_numpy(a) for a in _batch(80))
    draws = torch.from_numpy(np.random.default_rng(1).random((STEPS, B))
                             < 0.5)
    out = {}
    for impl in ("default", "vjp"):
        state = _port_gan(state_j, "kernel")
        m = gan_train_step(state, (inputs, targets), G_LR, D_LR, draws,
                           LAMBDA_ADV, 1.0, impl=impl)
        out[impl] = (state, m)
    for k in ("g_total", "d_total"):
        a, b = out["default"][1][k], out["vjp"][1][k]
        assert abs(a - b) <= 1e-6 + 1e-5 * abs(a), (k, a, b)
    for a, b in zip(out["default"][0].gen.parameters(),
                    out["vjp"][0].gen.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def _snapshot(module, optimizer):
    return ({k: v.clone() for k, v in module.state_dict().items()},
            {k: {n: v.clone() for n, v in s.items()}
             for k, s in optimizer.state_dict()["state"].items()})


def _unchanged(module, optimizer, snap):
    params, adam = snap
    return (all(torch.equal(v, params[k])
                for k, v in module.state_dict().items())
            and all(torch.equal(v, adam[k][n])
                    for k, s in optimizer.state_dict()["state"].items()
                    for n, v in s.items()))


@pytest.mark.parametrize("side", ["disc", "gen"])
def test_nan_skip_keeps_that_side_only(side):
    """A non-finite D loss (label smoothing NaN: only D's real targets read
    it) leaves D's params and Adam state, its own step included, as they
    were while G still updates; a non-finite G loss (lambda_adv NaN) the
    same for G while D updates. skipped == 1, the state's step advances."""
    _, state_j = _jax_gan("xla", "default", 45)
    state = _port_gan(state_j, "kernel")
    batch = tuple(torch.from_numpy(a) for a in _batch(90))
    gan_train_step(state, batch, G_LR, D_LR, lambda_adv=LAMBDA_ADV)
    snaps = {"gen": _snapshot(state.gen, state.gen_optimizer),
             "disc": _snapshot(state.disc, state.disc_optimizer)}
    bad = {"label_smoothing": float("nan")} if side == "disc" else \
        {"lambda_adv": float("nan")}
    m = gan_train_step(state, batch, G_LR, D_LR,
                       **{"lambda_adv": LAMBDA_ADV, **bad})
    total = "d_total" if side == "disc" else "g_total"
    other = "gen" if side == "disc" else "disc"
    assert m["skipped"] == 1 and not np.isfinite(m[total])
    assert state.step == 2
    modules = {"gen": (state.gen, state.gen_optimizer),
               "disc": (state.disc, state.disc_optimizer)}
    assert _unchanged(*modules[side], snaps[side])
    assert not _unchanged(*modules[other], snaps[other])
    for s in modules[side][1].state_dict()["state"].values():
        assert int(s["step"]) == 1
    for s in modules[other][1].state_dict()["state"].values():
        assert int(s["step"]) == 2


def test_gan_state_round_trip_is_exact():
    """A JAX GANTrainState after one step -> the port -> back
    (gan_train_state_to_jax) -> a fresh port state (load_gan_train_state
    takes the dict too): params, both Adam moments, counts and the step
    come back exactly, and the tree structure is the JAX one."""
    step_j, state_j = _jax_gan("xla", "default", 47)
    inputs, targets = _batch(95)
    state_j, _ = step_j(state_j, (jnp.asarray(inputs), jnp.asarray(targets)),
                        jnp.asarray(G_LR, jnp.float32),
                        jnp.asarray(D_LR, jnp.float32),
                        jnp.asarray(0.0, jnp.float32), jax.random.PRNGKey(3))
    want = jax.device_get(state_j)
    back = gan_train_state_to_jax(_port_gan(state_j, "torch"))
    again = gan_train_state_to_jax(_port_gan(back, "torch"))
    for got in (back, again):
        assert int(got["step"]) == int(want.step) == 1
        for name in ("gen_params", "disc_params"):
            a, b = got[name], getattr(want, name)
            assert (jax.tree_util.tree_structure(a)
                    == jax.tree_util.tree_structure(b))
            for x, y in zip(jax.tree_util.tree_leaves(a),
                            jax.tree_util.tree_leaves(b)):
                np.testing.assert_array_equal(x, np.asarray(y))
        for side in ("gen", "disc"):
            adam_j = getattr(want, f"{side}_opt_state")[1]
            assert int(got[f"{side}_opt_state"]["count"]) == int(adam_j.count)
            for key in ("mu", "nu"):
                for x, y in zip(
                        jax.tree_util.tree_leaves(got[f"{side}_opt_state"][key]),
                        jax.tree_util.tree_leaves(getattr(adam_j, key))):
                    np.testing.assert_array_equal(x, np.asarray(y))
