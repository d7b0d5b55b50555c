"""Remat (rematerialized recurrence) in the port against the port without
it and against the JAX package's ``ConvLSTMForecaster(remat=True,
remat_policy=p)``.

Small size: 2 cells of 8 channels, 16 px, 3 frames in and 4 out (6 steps),
float32. Weights are a flax params tree made with numpy from a seed (the
JAX model takes it as is, the port through ``weights.py``); frames and
targets come from numpy. Teacher forcing runs at prob 1 (JAX's draws are
then all true, so the port gets the same draws). Each tolerance is stated
where it is used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pl_convlstm_gan_tpu.losses.adversarial import l1_loss as jax_l1
from pl_convlstm_gan_tpu.models import ConvLSTMForecaster as JaxForecaster
from pl_convlstm_gan_tpu.models import Discriminator as JaxDiscriminator
from pl_convlstm_gan_tpu.train import steps as jax_steps
from pl_convlstm_gan_tpu_torch.config import Config, load_config
from pl_convlstm_gan_tpu_torch.models import (ConvLSTMForecaster,
                                              Discriminator)
from pl_convlstm_gan_tpu_torch.predict import build_model
from pl_convlstm_gan_tpu_torch.train import SequenceTrainer
from pl_convlstm_gan_tpu_torch.train.steps import (GANTrainState,
                                                   forecaster_loss,
                                                   gan_train_step,
                                                   make_optimizer)
from pl_convlstm_gan_tpu_torch.weights import (flax_to_state_dict,
                                               gan_train_state_to_jax,
                                               load_gan_train_state)
from test_torch_gan import disc_params
from test_torch_models import flax_params

HIDDEN = (8, 8)
T_IN, T_OUT, SIZE, B = 3, 4, 16, 2
STEPS = T_IN + T_OUT - 1
PLAIN_POLICIES = ("", "save_z", "dots")
KERNEL_POLICIES = ("", "dots")       # save_z is refused on the kernel cell


def _data(seed, t_out=T_OUT, size=SIZE):
    rng = np.random.default_rng(seed)
    return (rng.random((B, T_IN, 1, size, size), dtype=np.float32),
            rng.random((B, t_out, 1, size, size), dtype=np.float32))


def _port(params, impl="torch", remat=False, policy="", hidden=HIDDEN,
          t_out=T_OUT):
    model = ConvLSTMForecaster(hidden, T_IN, t_out, convlstm_impl=impl,
                               remat=remat, remat_policy=policy)
    model.load_state_dict(flax_to_state_dict(params))
    return model


def _port_grads(model, inputs, targets, draws):
    model.zero_grad(set_to_none=True)
    loss, _ = forecaster_loss(model, torch.from_numpy(inputs),
                              torch.from_numpy(targets), draws)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("impl,policy",
                         [("torch", p) for p in PLAIN_POLICIES]
                         + [("kernel", p) for p in KERNEL_POLICIES])
def test_remat_gradients_equal_no_remat(impl, policy):
    """For each policy and cell, the loss and every gradient with remat equal
    those without it exactly: the recompute runs the same ops on the same
    inputs (the CPU's convs are deterministic), and what a policy keeps is
    the forward's own value. impl 'kernel' runs K1's plain version with the
    custom backward (ConvLSTMCellFn), recomputed under remat."""
    params = flax_params(11, HIDDEN)
    inputs, targets = _data(12)
    draws = torch.from_numpy(np.random.default_rng(13).random((STEPS, B))
                             < 0.5)
    loss0, want = _port_grads(_port(params, impl), inputs, targets, draws)
    loss1, got = _port_grads(_port(params, impl, True, policy), inputs,
                             targets, draws)
    assert torch.equal(loss0, loss1)
    for name in want:
        assert torch.equal(got[name], want[name]), name


class _ConvCount(TorchDispatchMode):
    """Counts the forward convolutions and sigmoids the dispatcher runs."""

    def __init__(self):
        super().__init__()
        self.convs = self.sigmoids = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.convs += func is torch.ops.aten.convolution.default
        self.sigmoids += func is torch.ops.aten.sigmoid.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,recomputed", [
    ("", len(HIDDEN) * STEPS),     # every cell's conv
    ("save_z", 0),                 # z kept
    ("dots", 0),                   # every conv output kept
])
def test_policy_keeps_what_it_says(policy, recomputed):
    """The backward of a remat forward runs again the forward convolutions
    whose outputs the policy did not keep: "" every cell's conv at every
    step, "save_z" and "dots" none (the plain cell computes z with one
    convolution, which both keep). The head's conv is not run again under
    any policy: the non-reentrant recompute stops once it has rebuilt what
    the backward reads, and no backward reads the head conv's output. The
    gates are recomputed under every policy (sigmoid 3 times a cell
    step)."""
    model = _port(flax_params(14, HIDDEN), remat=True, policy=policy)
    inputs, targets = _data(15)
    loss, _ = forecaster_loss(model, torch.from_numpy(inputs),
                              torch.from_numpy(targets))
    with _ConvCount() as count:
        loss.backward()
    assert count.convs == recomputed
    assert count.sigmoids == 3 * len(HIDDEN) * STEPS


@pytest.mark.parametrize("policy", PLAIN_POLICIES)
def test_remat_gradients_match_jax(policy):
    """The port's gradients with remat against jax.grad of JAX's
    ConvLSTMForecaster(remat=True, remat_policy=policy) on the same weights,
    frames and targets, teacher forcing at prob 1: the loss and every
    gradient at atol=rtol=1e-5 (float32, sums in other orders), the
    tolerance tests/test_models.py:167 holds JAX's remat to."""
    params = flax_params(16, HIDDEN)
    inputs, targets = _data(17)
    model_j = JaxForecaster(hidden_dims=HIDDEN, input_frames=T_IN,
                            output_frames=T_OUT, remat=True,
                            remat_policy=policy)
    rng = jax.random.PRNGKey(3)

    def loss_j(p):
        return jax_l1(model_j.apply(p, jnp.asarray(inputs),
                                    targets=jnp.asarray(targets),
                                    teacher_forcing_prob=1.0, rng=rng),
                      jnp.asarray(targets))
    want_loss, want = jax.value_and_grad(loss_j)(params)
    want = flax_to_state_dict(jax.device_get(want))
    draws = torch.ones((STEPS, B), dtype=torch.bool)
    loss, got = _port_grads(_port(params, remat=True, policy=policy), inputs,
                            targets, draws)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def _check_tree(got, want, what):
    got, want = flax_to_state_dict(got), flax_to_state_dict(want)
    assert set(got) == set(want), what
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-5,
                                   err_msg=f"{what} {name}")


def test_gan_vjp_step_with_remat_matches_jax():
    """gan_train_step (impl "vjp", the G forward's graph kept across the D
    update) with a save_z remat generator, against JAX's
    make_gan_train_step(impl="vjp") with ConvLSTMForecaster(remat=True,
    remat_policy="save_z"), two steps from one state (gan_256_single's
    structure at 16 px, one 8-channel cell, teacher forcing at prob 1):
    the metrics at rtol 1e-5; G and D params and both Adam moments at
    atol=rtol=1e-5 and the counts exactly, as tests/test_torch_gan.py
    holds the step without remat."""
    hidden, features, t_out, lr_g, lr_d = (8,), (8, 16), 2, 1e-3, 2e-3
    steps = T_IN + t_out - 1
    gen_j = JaxForecaster(hidden_dims=hidden, input_frames=T_IN,
                          output_frames=t_out, remat=True,
                          remat_policy="save_z")
    disc_j = JaxDiscriminator(features=features)
    gp, dp = flax_params(18, hidden), disc_params(19, features)
    gtx, dtx = jax_steps.make_optimizer(0.5), jax_steps.make_optimizer(0.5)
    state_j = jax_steps.GANTrainState(gp, dp, gtx.init(gp), dtx.init(dp),
                                      jnp.zeros((), jnp.int32))
    step_j = jax_steps.make_gan_train_step(gen_j.apply, disc_j.apply, gtx,
                                           dtx, 0.1, 1.0, impl="vjp")
    gen = ConvLSTMForecaster(hidden, T_IN, t_out, remat=True,
                             remat_policy="save_z")
    disc = Discriminator(1, features)
    state_p = GANTrainState(gen, disc, make_optimizer(gen),
                            make_optimizer(disc))
    load_gan_train_state(state_p, jax.device_get(state_j))
    draws = torch.ones((steps, B), dtype=torch.bool)
    for i in range(2):
        inputs, targets = _data(20 + i, t_out)
        state_j, m_j = step_j(state_j, (jnp.asarray(inputs),
                                        jnp.asarray(targets)),
                              jnp.asarray(lr_g, jnp.float32),
                              jnp.asarray(lr_d, jnp.float32),
                              jnp.asarray(1.0, jnp.float32),
                              jax.random.PRNGKey(30 + i))
        m_p = gan_train_step(state_p, (torch.from_numpy(inputs),
                                       torch.from_numpy(targets)),
                             lr_g, lr_d, draws, 0.1, 1.0, impl="vjp")
        m_j = jax.device_get(m_j)
        assert m_p["skipped"] == int(m_j["skipped"]) == 0
        for k in m_j:
            np.testing.assert_allclose(m_p[k], float(m_j[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        want = jax.device_get(state_j)
        got = gan_train_state_to_jax(state_p)
        _check_tree(got["gen_params"], want.gen_params, f"step {i} G")
        _check_tree(got["disc_params"], want.disc_params, f"step {i} D")
        for side in ("gen", "disc"):
            adam_p = got[f"{side}_opt_state"]
            adam_j = getattr(want, f"{side}_opt_state")[1]
            assert int(adam_p["count"]) == int(adam_j.count) == i + 1
            for key in ("mu", "nu"):
                _check_tree(adam_p[key], getattr(adam_j, key),
                            f"step {i} {side} {key}")


def test_save_z_on_the_kernel_cell_and_unknown_policies_are_refused():
    """save_z with the kernel cell is refused, as JAX refuses it for its
    Pallas cell (forecaster.py:148-152): by the model and by the config
    (convlstm_impl pallas); an unknown policy is refused by both."""
    with pytest.raises(ValueError, match="save_z"):
        ConvLSTMForecaster(HIDDEN, T_IN, T_OUT, convlstm_impl="kernel",
                           remat=True, remat_policy="save_z")
    with pytest.raises(ValueError, match="remat_policy"):
        ConvLSTMForecaster(HIDDEN, T_IN, T_OUT, remat=True,
                           remat_policy="names")
    cfg = load_config("gan_256_single")
    cfg.model.convlstm_impl = "pallas"
    with pytest.raises(ValueError, match="save_z"):
        cfg.validate(training=True)
    cfg = load_config("gan_256_single")
    cfg.model.remat_policy = "names"
    with pytest.raises(ValueError, match="remat_policy"):
        cfg.validate()


def test_remat_configs_validate_for_training_and_tp_stays_refused():
    """gan_256_single and dp_v5e16 (remat save_z; dp_v5e16 data_axis 0)
    pass validate(training=True) and build a remat save_z generator;
    tp_nowcast_128 (A10, ported) passes validate(training=True) too, and
    stays refused by a one-process trainer, which has no second rank for
    its model axis (ValueError naming torchrun; it trains under torchrun:
    tests/test_torch_tp.py)."""
    for name in ("gan_256_single", "dp_v5e16"):
        cfg = load_config(name)
        cfg.validate(training=True)
        model = build_model(cfg)
        assert model.remat and model.remat_policy == "save_z"
    cfg = load_config("tp_nowcast_128")
    cfg.validate(training=True)
    with pytest.raises(ValueError, match="2 ranks: launch with torchrun"):
        SequenceTrainer(config=cfg, device="cpu")


def test_remat_forward_without_grad_equals_the_plain_forward():
    """Without autograd (serving, eval) the steps run unwrapped: the outputs
    equal the model's without remat bit for bit."""
    params = flax_params(22, HIDDEN)
    inputs, _ = _data(23)
    with torch.no_grad():
        a = _port(params)(torch.from_numpy(inputs))
        b = _port(params, remat=True, policy="save_z")(
            torch.from_numpy(inputs))
    assert torch.equal(a, b)


def _config(out_dir, epochs):
    return Config.from_dict({
        "data": {"source": "synthetic", "synthetic_num_sequences": 16,
                 "synthetic_image_size": 16},
        "model": {"family": "gan", "hidden_dims": [8], "input_frames": 2,
                  "output_frames": 2, "disc_features": [8, 16],
                  "remat": True, "remat_policy": "save_z"},
        "training": {"batch_size": 4, "epochs": epochs, "learning_rate": 1e-3,
                     "gan_step_impl": "vjp", "use_split": True,
                     "use_early_stopping": False, "scheduled_sampling": True,
                     "sampling_decay_epochs": 4},
        "output": {"output_dir": str(out_dir), "log_interval": 100,
                   "save_model_interval": 1},
    })


def test_sequence_trainer_with_remat_trains_and_resumes(tmp_path):
    """gan_256_single's settings (GAN, vjp step, remat save_z, scheduled
    sampling) at 16 px: 2 epochs, then a resume from latest to 3 that
    starts at epoch 2, with finite losses, and equals a straight 3-epoch
    run's history (the resume restores params, both Adam states and the
    step)."""
    first = SequenceTrainer(config=_config(tmp_path / "a", 2), device="cpu")
    h2 = first.train()
    assert h2["epoch"] == [0, 1]
    cfg = _config(tmp_path / "a", 3)
    cfg.training.resume_from = str(tmp_path / "a" / "latest")
    resumed = SequenceTrainer(config=cfg, device="cpu")
    h3 = resumed.train()
    assert resumed.start_epoch == 2 and h3["epoch"] == [0, 1, 2]
    assert all(np.isfinite(h3["g_loss"])) and all(np.isfinite(h3["d_loss"]))
    straight = SequenceTrainer(config=_config(tmp_path / "b", 3),
                               device="cpu").train()
    np.testing.assert_allclose(h3["g_loss"], straight["g_loss"], rtol=1e-6)
    np.testing.assert_allclose(h3["d_loss"], straight["d_loss"], rtol=1e-6)
