"""PredRNN-V2 on the port's normal path (``models/predrnn.py``, family
``predrnn``) against its plain float32 reference
(``pl_convlstm_gan_tpu_torch/reference/predrnn.py``, thuml's code) on
seeded weights, at a size the CPU holds: 16 x 16 frames of one channel,
patch 4, two layers of 8, 3 frames in and 3 out (5 steps, [4, B] masks).

Tolerances, each with its reason:
- float32: the loss within 1e-5 relative, the predictions within 1e-5 of
  their largest magnitude, each gradient leaf within 1e-4 of its norm:
  the same float32 operations in other orders (the gates in K7's plain
  version, the convs as NHWC views, the decoupling term batched), a few
  roundings of each value over 5 steps;
- bfloat16 (float32 parameters, bf16 convs and states): the loss within
  2e-3 relative, and each gradient leaf of the MSE term within 5e-2 of its
  norm (the reference computes in float32): bf16 keeps 8 bits, every conv
  operand and state is rounded once a step, and the gradients run back
  through 5 steps of such roundings (~2^-8 each, a few percent after the
  backward's sums); measured under 1e-2 on three seeds. The decoupling
  term's gradient is compared in float32 only: it is sign(cos) times the
  cosine's gradient, and a cosine within bf16 rounding of zero flips sign
  between the two precisions (one of the 160 here moved a small leaf's
  gradient by 20 %).
Both faults of the new mechanism, planted in the program (the memory reset
at every step instead of passed from the top layer; the decoupling weight
0), fail the float32 comparison by far more than its tolerances."""
import math

import pytest
import torch

from pl_convlstm_gan_tpu_torch.config import Config
from pl_convlstm_gan_tpu_torch.models import loss_graphs
from pl_convlstm_gan_tpu_torch.models import predrnn as pmod
from pl_convlstm_gan_tpu_torch.models.predrnn import (
    PredRNN, decoupling_loss, reshape_patch, reshape_patch_back)
from pl_convlstm_gan_tpu_torch.predict import build_model, load_predictor
from pl_convlstm_gan_tpu_torch.reference import predrnn as ref
from pl_convlstm_gan_tpu_torch.train import SequenceTrainer
from pl_convlstm_gan_tpu_torch.train import steps
from pl_convlstm_gan_tpu_torch.utils import profiling

T_IN, T_OUT, LAYERS, WIDTH, PATCH, SIZE, B = 3, 3, 2, 8, 4, 16, 2
TOTAL = T_IN + T_OUT
BETA = 0.1
LOSS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _model(dtype=None, seed=0, beta=BETA):
    torch.manual_seed(seed)
    return PredRNN(hidden_dims=(WIDTH,) * LAYERS, input_frames=T_IN,
                   output_frames=T_OUT, in_channels=1, kernel_size=5,
                   patch_size=PATCH, decouple_beta=beta, dtype=dtype)


def _data(seed=1):
    g = torch.Generator().manual_seed(seed)
    frames = torch.rand(B, TOTAL, 1, SIZE, SIZE, generator=g)
    mask = torch.rand(TOTAL - 2, B, generator=g) < 0.5
    return frames, mask


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _ref_loss(params, frames, mask, beta=BETA, zigzag=True):
    return ref.loss(params, LAYERS, T_IN, TOTAL, PATCH, beta, frames, mask,
                    zigzag)


def _ref_grads(params, frames, mask):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, nxt = _ref_loss(leaves, frames, mask)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), nxt.detach(), dict(zip(leaves, grads))


def _program(model, frames, mask):
    model.zero_grad(set_to_none=True)
    loss, pred = model.loss(frames[:, :T_IN], frames[:, T_IN:], mask)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return float(loss.detach()), pred.detach(), grads


def _gaps(prog, want):
    """(loss gap relative, the worst leaf's gradient gap over its norm)."""
    loss_gap = abs(prog[0] - want[0]) / abs(want[0])
    grad_gap = max(float((prog[2][k] - want[2][k]).norm()
                         / want[2][k].norm()) for k in want[2])
    return loss_gap, grad_gap


@pytest.fixture(scope="module")
def reference():
    frames, mask = _data()
    return frames, mask, _ref_grads(_params(_model()), frames, mask)


def test_names_and_shapes_are_thumls():
    model = _model()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        ref.param_shapes((WIDTH,) * LAYERS, 1, 5, PATCH)
    assert not any(n.endswith(".bias") for n in model.state_dict())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_against_the_reference(reference, dtype):
    """Forward, loss and every gradient against the reference on the same
    seeded weights, frames and masks (in bfloat16 the MSE term's
    gradients: module docstring)."""
    frames, mask, want = reference
    model = _model(None if dtype == torch.float32 else dtype)
    got = _program(model, frames, mask)
    loss_gap, grad_gap = _gaps(got, want)
    if dtype == torch.bfloat16:
        params = _params(_model())
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        mse, _ = _ref_loss(leaves, frames, mask, beta=0.0)
        mse_grads = dict(zip(leaves, torch.autograd.grad(
            mse, list(leaves.values()))))
        grad_gap = _gaps(_program(_model(dtype, beta=0.0), frames, mask),
                         (float(mse.detach()), None, mse_grads))[1]
    assert loss_gap <= LOSS_TOL[dtype] and grad_gap <= GRAD_TOL[dtype], (
        loss_gap, grad_gap)
    pred_err = float((got[1] - want[1][:, -T_OUT:]).abs().max())
    assert pred_err <= math.sqrt(LOSS_TOL[dtype]) * float(
        want[1].abs().max())
    if dtype == torch.float32:
        assert pred_err <= 1e-5 * float(want[1].abs().max())


def _reset_memory(monkeypatch):
    """The fault ``no_zigzag``: every step's layer 0 starts from a zero
    memory (the stack's first cell-step of each step, counted)."""
    calls = [0]
    step = pmod.st_lstm_step

    def reset(w, x, h, c, m, deltas=True):
        if calls[0] % LAYERS == 0:
            m = torch.zeros_like(m)
        calls[0] += 1
        return step(w, x, h, c, m, deltas)
    monkeypatch.setattr(pmod, "st_lstm_step", reset)


@pytest.mark.parametrize("fault", ["no_zigzag", "no_decouple"])
def test_planted_faults_fail_the_comparison(reference, monkeypatch, fault):
    frames, mask, want = reference
    model = _model(beta=0.0 if fault == "no_decouple" else BETA)
    if fault == "no_zigzag":
        _reset_memory(monkeypatch)
    loss_gap, grad_gap = _gaps(_program(model, frames, mask), want)
    assert loss_gap > 10 * LOSS_TOL[torch.float32] or \
        grad_gap > 10 * GRAD_TOL[torch.float32], (loss_gap, grad_gap)
    # the reference with the same fault agrees with the faulty program
    params = _params(_model())
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    f_loss, _ = _ref_loss(leaves, frames, mask,
                          beta=0.0 if fault == "no_decouple" else BETA,
                          zigzag=fault != "no_zigzag")
    f_grads = dict(zip(leaves, torch.autograd.grad(
        f_loss, list(leaves.values()))))
    assert _gaps(_program(model, frames, mask),
                 (float(f_loss.detach()), None, f_grads))[1] \
        <= GRAD_TOL[torch.float32]


def test_reshape_patch_round_trip_and_thuml_order():
    x = torch.rand(2, 3, 2, 8, 12)
    p = reshape_patch(x, 4)
    assert p.shape == (2, 3, 2, 3, 32)
    assert torch.equal(reshape_patch_back(p, 4, 2), x)
    assert torch.equal(p, ref.reshape_patch(x.permute(0, 1, 3, 4, 2), 4))
    # channel (py * p + px) * C + c of patch (0, 1)
    assert float(p[0, 0, 0, 1, (2 * 4 + 3) * 2 + 1]) == float(
        x[0, 0, 1, 2, 4 + 3])


def test_batched_decoupling_equals_the_per_step_form():
    """``decoupling_loss`` on 2N stacked deltas against thuml's form, one
    (step, layer) pair at a time (``F.normalize`` of the adapter's NCHW
    output, ``cosine_similarity``, the mean of the means)."""
    g = torch.Generator().manual_seed(4)
    pairs = [(torch.randn(B, 4, 4, WIDTH, generator=g, dtype=torch.float64),
              torch.randn(B, 4, 4, WIDTH, generator=g, dtype=torch.float64))
             for _ in range(7)]
    adapter = torch.randn(WIDTH, WIDTH, 1, 1, generator=g,
                          dtype=torch.float64)
    per_step = []
    for dc, dm in pairs:
        a = [torch.nn.functional.normalize(torch.nn.functional.conv2d(
            d.permute(0, 3, 1, 2), adapter).reshape(B, WIDTH, -1), dim=2)
            for d in (dc, dm)]
        per_step.append(torch.mean(torch.abs(torch.cosine_similarity(
            a[0], a[1], dim=2))))
    want = torch.mean(torch.stack(per_step))
    got = decoupling_loss(pairs, adapter)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_train_step_against_the_references_clip_and_adam(reference):
    """One ``forecaster_train_step`` of a PredRNN (its own loss, the masks
    as its draws) against the reference's loss, clip and Adam from the same
    state; the clip fires (norm above 0.05)."""
    frames, mask, want = reference
    model = _model()
    params = _params(model)
    state = steps.TrainState(model, steps.make_optimizer(model))
    lr, clip = 1e-3, 0.05
    out = steps.forecaster_train_step(state, (frames[:, :T_IN],
                                              frames[:, T_IN:]), lr,
                                      teacher_draws=mask,
                                      grad_clip_norm=clip)
    assert out["skipped"] == 0
    assert out["total"] == pytest.approx(want[0], rel=1e-5)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _, _, _ = ref.train_step(params, zeros, zeros, 0, want[2], lr, clip)
    for name, p in model.named_parameters():
        step_ref = new[name] - params[name]
        step_got = p.detach() - params[name]
        assert float((step_got - step_ref).norm()) <= 1e-3 * float(
            step_ref.norm()), name


def test_spans_inside_the_train_step():
    """Under ``program_trace`` a PredRNN step logs ``predrnn.rollout`` and
    ``predrnn.decouple`` inside ``train.forward``."""
    frames, mask = _data()
    model = _model()
    state = steps.TrainState(model, steps.make_optimizer(model))
    with profiling.program_trace() as log:
        steps.forecaster_train_step(state, (frames[:, :T_IN],
                                            frames[:, T_IN:]), 1e-4,
                                    teacher_draws=mask)
    by_name = {s.name[len("plcg."):]: s for s in log.spans}
    fwd = by_name["train.forward"]
    for name in ("predrnn.rollout", "predrnn.decouple"):
        assert by_name[name].parent == fwd.id
        assert fwd.start_ns <= by_name[name].start_ns <= \
            by_name[name].end_ns <= fwd.end_ns


def _config(**over):
    cfg = Config.from_dict({
        "data": {"source": "synthetic", "synthetic_num_sequences": 12,
                 "synthetic_image_size": SIZE},
        "model": {"family": "predrnn", "hidden_dims": [WIDTH] * LAYERS,
                  "kernel_size": 5, "patch_size": PATCH, "in_channels": 1,
                  "input_frames": T_IN, "output_frames": T_OUT,
                  "decouple_beta": BETA},
        "training": {"batch_size": 4, "epochs": 1, "learning_rate": 1e-3,
                     "use_early_stopping": False}})
    for key, value in over.items():
        section, name = key.split("__")
        setattr(getattr(cfg, section), name, value)
    return cfg


def test_config_accepts_the_family_and_refuses_what_it_cannot_run():
    cfg = _config()
    cfg.validate(training=True)
    model = build_model(cfg)
    assert isinstance(model, PredRNN) and model.patch_size == PATCH
    assert model.decouple_beta == BETA
    for over, match in (({"model__hidden_dims": [8, 16]}, "equal"),
                        ({"model__patch_size": 3}, "divide"),
                        ({"model__kernel_size": 4}, "odd"),
                        ({"mesh__model_axis": 2}, "tensor-parallel")):
        with pytest.raises(ValueError, match=match):
            _config(**over).validate()
    with pytest.raises(ValueError, match="equal"):
        PredRNN(hidden_dims=(8, 16))


def test_request_through_load_predictor(tmp_path):
    """``load_predictor`` serves a batch of T_in frames: T_out predictions,
    the reference's forward under thuml's test mask (the input frames, then
    its own predictions)."""
    cfg = _config()
    model = _model()
    path = str(tmp_path / "predrnn.pt")
    torch.save(model.state_dict(), path)
    predict = load_predictor(cfg, path, device="cpu")
    frames, _ = _data()
    out = predict(frames[:, :T_IN].numpy())
    want, _ = ref.forward(_params(model), LAYERS, T_IN, TOTAL, PATCH,
                          frames[:, :T_IN])
    assert out.shape == (B, T_OUT, 1, SIZE, SIZE)
    assert float((out - want[:, -T_OUT:]).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_sequence_trainer_trains_the_family(tmp_path, monkeypatch):
    """``SequenceTrainer`` on family predrnn: one epoch with reverse
    scheduled sampling, the masks [T_in + T_out - 2, B] drawn at 1 - p / 2
    in the input phase and p / 2 after it; then the test split's eval."""
    cfg = _config(output__output_dir=str(tmp_path),
                  training__scheduled_sampling=True,
                  training__sampling_decay_epochs=2)
    seen = []
    step = steps.forecaster_train_step

    def spy(state, batch, lr, draws=None, **kw):
        seen.append(draws)
        return step(state, batch, lr, draws, **kw)
    trainer = SequenceTrainer(config=cfg, device="cpu")
    monkeypatch.setattr("pl_convlstm_gan_tpu_torch.train.sequence_trainer."
                        "forecaster_train_step", spy)
    history = trainer.train()
    assert history["epoch"] == [0] and math.isfinite(
        history["total_loss"][0])
    assert seen and all(d.shape == (TOTAL - 2, 4) and d.dtype == torch.bool
                        for d in seen)
    metrics = trainer.evaluate_test()
    assert math.isfinite(metrics["l1"])


def test_cpu_training_never_captures_and_counts_add():
    """``_weights()`` lists every parameter, in their order; on CPU tensors
    ``PredRNN.loss`` runs eagerly at every call (CUDA graphs are the card's
    train path); ``profiling.add_counts`` raises the named counters by what
    a replayed capture counted and no other."""
    frames, mask = _data()
    model = _model()
    # the captured step reads every parameter through _weights()
    assert [id(w) for w in model._weights()] == \
        [id(p) for p in model.parameters()]
    for _ in range(3):
        model.loss(frames[:, :T_IN], frames[:, T_IN:], mask)[0].backward()
    assert model not in loss_graphs._GRAPHS
    before = profiling.counters()
    profiling.add_counts({"st_gates.launches": 304, "host_syncs": 0})
    after = profiling.counters()
    profiling.add_counts({"st_gates.launches": -304})
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"st_gates.launches": 304}
