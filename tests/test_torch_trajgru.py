"""TrajGRU's encoder-forecaster on the port's normal path
(``models/trajgru.py``, family ``trajgru``) against its plain float32
reference (``pl_convlstm_gan_tpu_torch/reference/trajgru.py``) on seeded
weights, at a size the CPU holds: two levels of 8 and 16 channels, L 3,
40 x 40 frames of one channel through a 7x7 stride-5 stem to 8 x 8 and a
3x3 stride-2 stem to 4 x 4 (the HKO-7 stems and transposed convs scaled
down: a 7x7 stride-5 and a 4x4 stride-2 transposed conv back), 2 frames in
and 3 out; and K8's plain warp (``ops/kernels/traj_warp_kernel.py``).

Tolerances, each with its reason:
- float32: the loss within 1e-5 relative, the predictions within 1e-5 of
  their largest magnitude, each gradient leaf within 1e-4 of its norm: the
  same float32 operations in other orders (the convs as NHWC views, the
  warp as K8's gather instead of ``grid_sample``'s normalised grid);
  measured under 1e-6;
- bfloat16 (float32 parameters, bf16 convs, states, flows and stacks): the
  loss within 5e-3 relative, the predictions within 7e-2 of their largest
  magnitude, the flow generator's leaves (``i2f_conv1``, ``h2f_conv1``,
  ``flows_conv``) within 0.5 of their norm and every other leaf within
  0.1: bf16 keeps 8 bits, every conv operand and state is rounded once a
  step, and the flows themselves are bf16, so a sample point several
  pixels away moves by up to 2^-5 of a pixel; the flow generator's
  gradient is the stack's gradient times the difference of neighbouring
  taps of h, two bf16 values that agree in most of their bits, so its
  relative error is many bf16 ulps. Measured on four seeds (the tests run
  the first): the loss 6e-5 to 8e-4, the predictions 3e-3 to 3.4e-2, the
  other leaves 7e-3 to 4.6e-2, the flow generator's 0.06 to 0.24.
A fault of the new mechanism planted in the program (every warp with zero
flows) fails the float32 comparison by far more than its tolerances.

The tests marked ``cuda`` need the card and skip without one: K8's forward
equal to its plain version bit for bit (the same float32 operations in the
same order, rounded once); its backward within float32 rounding of the
plain version's autograd (dh within 1e-5 of its largest magnitude: the
atomics add the taps' terms in an order that changes from run to run; the
flows' gradient within 1e-4: a sum over C channels in another order, and
in bf16 one bf16 ulp more); 150 K8 launches a train step at the HKO-7
widths; a replayed train step equal to an eager one. Run there with
``python -m pytest --noconftest -m cuda tests/test_torch_trajgru.py``.
"""
import math

import pytest
import torch

from pl_convlstm_gan_tpu_torch import losses
from pl_convlstm_gan_tpu_torch.config import Config
from pl_convlstm_gan_tpu_torch.models import loss_graphs
from pl_convlstm_gan_tpu_torch.models import trajgru as tmod
from pl_convlstm_gan_tpu_torch.models.trajgru import TrajGRU, level_sizes
from pl_convlstm_gan_tpu_torch.ops.kernels import traj_warp_kernel as k8
from pl_convlstm_gan_tpu_torch.predict import build_model, load_predictor
from pl_convlstm_gan_tpu_torch.reference import trajgru as ref
from pl_convlstm_gan_tpu_torch.train import SequenceTrainer, steps
from pl_convlstm_gan_tpu_torch.utils import profiling

T_IN, T_OUT, SIZE, B = 2, 3, 40, 2
MODEL = {"hidden_dims": [8, 16], "traj_links": [3, 3],
         "traj_forecast_links": [3, 3],
         "traj_stems": [[4, 7, 5, 1], [16, 3, 2, 1]],
         "traj_deconvs": [[4, 7, 5, 1], [8, 4, 2, 1]],
         "kernel_size": 3, "in_channels": 1,
         "input_frames": T_IN, "output_frames": T_OUT}
FLOW_LEAVES = ("i2f_conv1", "h2f_conv1", "flows_conv")
LOSS_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
PRED_TOL = {torch.float32: 1e-5, torch.bfloat16: 7e-2}
GRAD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (0.1, 0.5)}
# the flows' scale: flows_conv's init gives flows well under a pixel; the
# tests scale its weights up so that the warps reach whole pixels and cross
# the frame's edge
FLOW_SCALE = 30.0


def _model(dtype=None, seed=0, **over):
    torch.manual_seed(seed)
    m = {**MODEL, **over}
    model = TrajGRU(hidden_dims=m["hidden_dims"], links=m["traj_links"],
                    forecast_links=m["traj_forecast_links"],
                    stems=m["traj_stems"], deconvs=m["traj_deconvs"],
                    input_frames=m["input_frames"],
                    output_frames=m["output_frames"],
                    in_channels=m["in_channels"],
                    kernel_size=m["kernel_size"], dtype=dtype)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "flows_conv" in name:
                p.mul_(FLOW_SCALE)
    return model


def _data(seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(B, T_IN, 1, SIZE, SIZE, generator=g),
            torch.rand(B, T_OUT, 1, SIZE, SIZE, generator=g))


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _ref_grads(params, inputs, targets):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, pred = ref.loss(leaves, MODEL, inputs, targets)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), pred.detach(), dict(zip(leaves, grads))


def _program(model, inputs, targets):
    model.zero_grad(set_to_none=True)
    loss, pred = model.loss(inputs, targets)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return float(loss.detach()), pred.detach(), grads


def _leaf_gaps(got, want):
    return {k: float((got[k] - want[k]).norm() / want[k].norm())
            for k in want}


@pytest.fixture(scope="module")
def reference():
    inputs, targets = _data()
    return inputs, targets, _ref_grads(_params(_model()), inputs, targets)


def test_names_and_shapes_are_the_reference_s():
    model = _model()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        ref.param_shapes(MODEL)
    assert list(ref.param_shapes(MODEL)) == [
        n for n, _ in model.named_parameters()]
    # the HKO-7 port's layout; the forecaster's top layer reads no input
    names = set(model.state_dict())
    assert {"encoder.stage1.conv1_leaky_1.weight", "encoder.rnn2.ret.bias",
            "forecaster.stage2.deconv1_leaky_1.weight",
            "forecaster.stage1.deconv2_leaky_1.bias",
            "forecaster.stage1.conv2_leaky_2.weight",
            "forecaster.stage1.conv2_3.bias"} <= names
    assert "forecaster.rnn2.i2h.weight" not in names
    assert "forecaster.rnn1.i2h.weight" in names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_against_the_reference(reference, dtype):
    """Predictions, the balanced loss and every gradient against the
    reference on the same seeded weights and frames (tolerances: module
    docstring)."""
    inputs, targets, want = reference
    got = _program(_model(None if dtype == torch.float32 else dtype),
                   inputs, targets)
    assert abs(got[0] - want[0]) <= LOSS_TOL[dtype] * abs(want[0])
    assert float((got[1] - want[1]).abs().max()) <= PRED_TOL[dtype] * float(
        want[1].abs().max())
    other, flow = GRAD_TOL[dtype]
    for name, gap in _leaf_gaps(got[2], want[2]).items():
        tol = flow if any(f in name for f in FLOW_LEAVES) else other
        assert gap <= tol, (name, gap)


def test_zero_flows_fail_the_comparison(reference, monkeypatch):
    """The fault ``zero_flows`` (every warp samples h in place): the
    program's gradients leave the float32 reference's by far more than the
    tolerance, and the flow generator takes no gradient."""
    inputs, targets, want = reference
    warp = tmod.traj_warp
    monkeypatch.setattr(tmod, "traj_warp",
                        lambda h, flows: warp(h, flows * 0))
    got = _program(_model(), inputs, targets)
    gaps = _leaf_gaps(got[2], want[2])
    assert max(gaps.values()) > 100 * GRAD_TOL[torch.float32][0]
    assert all(float(got[2][k].abs().max()) == 0 for k in gaps
               if "flows_conv" in k)


def test_train_step_against_the_references_clip_and_adam(reference):
    """One ``forecaster_train_step`` of a TrajGRU (its own loss) against the
    reference's loss, clip and Adam from the same state; the clip fires."""
    inputs, targets, want = reference
    model = _model()
    params = _params(model)
    state = steps.TrainState(model, steps.make_optimizer(model))
    lr, clip = 1e-3, 0.05
    out = steps.forecaster_train_step(state, (inputs, targets), lr,
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


# ------------------------------------------------------------------ K8, plain


def _warp_operands(b=2, hgt=9, wid=11, c=5, links=4, scale=3.0, seed=3,
                   dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(b, hgt, wid, c, generator=g, dtype=dtype)
    flows = torch.randn(b, hgt, wid, 2 * links, generator=g,
                        dtype=dtype) * scale
    return h, flows


def _grid_sample_warp(h, flows):
    """The stack by ``F.grid_sample`` (align_corners=True, zero padding),
    link by link, NHWC."""
    b, hgt, wid, c = h.shape
    links = flows.shape[-1] // 2
    nchw = h.permute(0, 3, 1, 2)
    out = []
    for l in range(links):
        flow = flows[..., 2 * l:2 * l + 2].permute(0, 3, 1, 2)
        out.append(ref.warp(nchw, flow).permute(0, 2, 3, 1))
    return torch.cat(out, dim=-1)


@pytest.mark.parametrize("scale", [0.4, 3.0, 40.0])
def test_plain_warp_is_grid_sample(scale):
    """Fractional flows (0.4), flows across the frame's edge (3 on a 9 x 11
    frame) and flows far outside it (40: every tap reads 0): the plain
    warp against ``F.grid_sample`` in float64 within 1e-12 (the grid's
    normalisation round trip)."""
    h, flows = _warp_operands(scale=scale, dtype=torch.float64)
    got = k8.traj_warp_plain(h, flows)
    assert got.shape == (2, 9, 11, 20)
    want = _grid_sample_warp(h, flows)
    assert float((got - want).abs().max()) <= 1e-12
    if scale == 40.0:
        assert float(got.abs().max()) < float(h.abs().max())


def test_plain_warp_of_zero_flows_is_the_identity():
    h, flows = _warp_operands()
    got = k8.traj_warp_plain(h, torch.zeros_like(flows))
    assert torch.equal(got, h.repeat(1, 1, 1, 4))
    hb = h.to(torch.bfloat16)
    assert torch.equal(k8.traj_warp_plain(hb, torch.zeros_like(
        flows, dtype=torch.bfloat16)), hb.repeat(1, 1, 1, 4))


def test_plain_warp_gradcheck():
    """``torch.autograd.gradcheck`` of the plain warp in float64, for h and
    the flows (fractional flows, none on a whole pixel)."""
    h, flows = _warp_operands(b=1, hgt=4, wid=5, c=3, links=2, scale=1.3,
                              dtype=torch.float64)
    h.requires_grad_(True)
    flows.requires_grad_(True)
    assert torch.autograd.gradcheck(k8.traj_warp_plain, (h, flows),
                                    eps=1e-6, atol=1e-6)


def test_plain_backward_is_grid_sample_s():
    """``traj_warp_bwd_plain`` (the card's oracle for K8's backward) against
    autograd through ``F.grid_sample`` in float64."""
    h, flows = _warp_operands(scale=2.0, dtype=torch.float64)
    gs = torch.randn(2, 9, 11, 20, generator=torch.Generator().manual_seed(9),
                     dtype=torch.float64)
    dh, df = k8.traj_warp_bwd_plain(h, flows, gs)
    hh, ff = h.clone().requires_grad_(True), flows.clone().requires_grad_(True)
    want = torch.autograd.grad(_grid_sample_warp(hh, ff), (hh, ff), gs)
    assert float((dh - want[0]).abs().max()) <= 1e-10
    assert float((df - want[1]).abs().max()) <= 1e-9


def test_wrapper_runs_plain_on_the_cpu_and_refuses_off_it():
    """On CPU tensors ``traj_warp`` is the plain version and counts no
    launch; its checks refuse operands K8 does not take before a launch
    (meta tensors reach them as a CUDA tensor would)."""
    h, flows = _warp_operands()
    before = profiling.counters()["traj_warp.launches"]
    assert torch.equal(k8.traj_warp(h, flows), k8.traj_warp_plain(h, flows))
    assert profiling.counters()["traj_warp.launches"] == before
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        k8.traj_warp_fwd(h.to(meta), flows.to(meta))
    with pytest.raises(ValueError, match="alike"):
        k8.traj_warp_fwd(h.to(meta), flows.to(meta, torch.bfloat16))
    with pytest.raises(ValueError, match="2L"):
        k8.traj_warp_fwd(h, flows[..., :3])


# ------------------------------------------------------------------ the loss


def test_balancing_weights_at_each_threshold():
    """Each threshold's pixel value (as float32) takes the next weight, the
    value just below it the one before."""
    pixels = [losses.rainfall_to_pixel(r) for r in losses.HKO_THRESHOLDS]
    assert pixels == pytest.approx([0.328253, 0.462426, 0.551110, 0.618197,
                                    0.724527], abs=1e-6)
    at = torch.tensor(pixels, dtype=torch.float32)
    below = torch.nextafter(at, torch.zeros_like(at))
    assert losses.balancing_weights(at).tolist() == [1.0, 2.0, 5.0, 10.0,
                                                     30.0]
    assert losses.balancing_weights(below).tolist() == [1.0, 1.0, 2.0, 5.0,
                                                        10.0]
    assert losses.balancing_weights(torch.zeros(1)).tolist() == [1.0]
    assert torch.equal(ref.balancing_weights(at),
                       losses.balancing_weights(at))


def test_balanced_loss_is_hko7_s():
    """Weighted squared and absolute errors summed over a frame's pixels,
    averaged over frames and rows, added, times 5e-5: against a loop over
    frames in float64."""
    g = torch.Generator().manual_seed(2)
    pred = torch.rand(2, 3, 1, 6, 5, generator=g, dtype=torch.float64)
    target = torch.rand(2, 3, 1, 6, 5, generator=g, dtype=torch.float64)
    frames = []
    for b in range(2):
        for t in range(3):
            w = losses.balancing_weights(target[b, t])
            err = pred[b, t] - target[b, t]
            frames.append(float((w * err * err).sum() + (w * err.abs()).sum()))
    want = 5e-5 * sum(frames) / len(frames)
    assert float(losses.balanced_mse_mae(pred, target)) == pytest.approx(
        want, rel=1e-12)
    assert float(ref.balanced_loss(pred, target)) == pytest.approx(
        want, rel=1e-12)


# ------------------------------------------------------- the model and paths


def test_level_sizes_and_the_hko7_geometry():
    """480^2 frames go to 96^2, 32^2 and 16^2 through the HKO-7 stems and
    come back through the transposed convs; a size they do not undo is
    refused."""
    stems = [[8, 7, 5, 1], [192, 5, 3, 1], [192, 3, 2, 1]]
    deconvs = [[8, 7, 5, 1], [64, 5, 3, 1], [192, 4, 2, 1]]
    assert level_sizes(480, 480, stems, deconvs) == [(96, 96), (32, 32),
                                                     (16, 16)]
    assert level_sizes(SIZE, SIZE, MODEL["traj_stems"],
                       MODEL["traj_deconvs"]) == [(8, 8), (4, 4)]
    with pytest.raises(ValueError, match="level 1"):
        level_sizes(485, 485, stems, deconvs)


def test_hko7_widths_count():
    """At the HKO-7 widths the model holds about 11.6 M parameters."""
    n = sum(p.numel() for p in TrajGRU().parameters())
    assert 11.5e6 < n < 11.7e6, n


def test_spans_inside_the_train_step():
    """Under ``program_trace`` a TrajGRU step logs ``trajgru.encode`` and
    then ``trajgru.forecast``, both inside ``train.forward``."""
    inputs, targets = _data()
    model = _model()
    state = steps.TrainState(model, steps.make_optimizer(model))
    with profiling.program_trace() as log:
        steps.forecaster_train_step(state, (inputs, targets), 1e-4)
    by_name = {s.name[len("plcg."):]: s for s in log.spans}
    fwd = by_name["train.forward"]
    enc, fc = by_name["trajgru.encode"], by_name["trajgru.forecast"]
    for s in (enc, fc):
        assert s.parent == fwd.id
        assert fwd.start_ns <= s.start_ns <= s.end_ns <= fwd.end_ns
    assert enc.end_ns <= fc.start_ns


def _config(**over):
    cfg = Config.from_dict({
        "data": {"source": "synthetic", "synthetic_num_sequences": 12,
                 "synthetic_image_size": SIZE},
        "model": {"family": "trajgru", **MODEL},
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
    assert isinstance(model, TrajGRU)
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == \
        list(ref.param_shapes(MODEL).items())
    for over, match in (
            ({"model__traj_links": [3]}, "one entry a level"),
            ({"model__traj_stems": [[4, 7, 5], [16, 3, 2, 1]]},
             "out_channels, kernel"),
            ({"data__synthetic_image_size": 45}, "level 1"),
            ({"model__kernel_size": 4}, "odd"),
            ({"mesh__model_axis": 2}, "tensor-parallel"),
            ({"model__remat": True}, "remat"),
            ({"training__scheduled_sampling": True}, "scheduled sampling")):
        with pytest.raises(ValueError, match=match):
            _config(**over).validate()


def test_request_through_load_predictor(tmp_path):
    """``load_predictor`` serves a batch of T_in frames: T_out predictions,
    the reference's forward."""
    cfg = _config()
    model = build_model(cfg)
    path = str(tmp_path / "trajgru.pt")
    torch.save(model.state_dict(), path)
    predict = load_predictor(cfg, path, device="cpu")
    inputs, _ = _data()
    out = predict(inputs.numpy())
    want = ref.forward(_params(model), MODEL, inputs)
    assert out.shape == (B, T_OUT, 1, SIZE, SIZE)
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_family_s_refusals(tmp_path):
    """Streaming, export, scheduled-sampling draws and the TP and remat
    configurations each refuse the family with a stated message."""
    from pl_convlstm_gan_tpu_torch.serve import export_model
    from pl_convlstm_gan_tpu_torch.streaming import StreamingForecaster
    cfg = _config()
    model = build_model(cfg)
    with pytest.raises(ValueError, match="streaming inference needs"):
        StreamingForecaster(cfg, model.state_dict(), device="cpu")
    path = str(tmp_path / "trajgru.pt")
    torch.save(model.state_dict(), path)
    with pytest.raises(ValueError, match="family trajgru has no serving"):
        export_model(cfg, path, (torch.zeros(1, T_IN, 1, SIZE, SIZE),),
                     device="cpu")
    inputs, targets = _data()
    with pytest.raises(ValueError, match="no scheduled-sampling draws"):
        model.loss(inputs, targets, torch.ones(4, B, dtype=torch.bool))
    assert model.teacher_probs(0.5).numel() == 0


def test_sequence_trainer_trains_the_family(tmp_path):
    """``SequenceTrainer`` on family trajgru: one epoch on the synthetic
    frames, then the test split's eval."""
    cfg = _config(output__output_dir=str(tmp_path))
    trainer = SequenceTrainer(config=cfg, device="cpu")
    history = trainer.train()
    assert history["epoch"] == [0] and math.isfinite(
        history["total_loss"][0])
    metrics = trainer.evaluate_test()
    assert math.isfinite(metrics["l1"]) and math.isfinite(metrics["ssim"])


def test_cpu_training_never_captures():
    """``_weights()`` lists every parameter in their order; on CPU tensors
    ``TrajGRU.loss`` runs eagerly at every call."""
    inputs, targets = _data()
    model = _model()
    assert [id(w) for w in model._weights()] == \
        [id(p) for p in model.parameters()]
    for _ in range(3):
        model.loss(inputs, targets)[0].backward()
    assert model not in loss_graphs._GRAPHS


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_operands(card, b, hgt, wid, c, links, dtype, scale, seed=5):
    g = torch.Generator(device=card).manual_seed(seed)
    h = torch.randn(b, hgt, wid, c, device=card, generator=g).to(dtype)
    flows = (torch.randn(b, hgt, wid, 2 * links, device=card, generator=g)
             * scale).to(dtype)
    gs = torch.randn(b, hgt, wid, links * c, device=card,
                     generator=g).to(dtype)
    return h, flows, gs


CARD_SHAPES = {
    # the HKO-7 layers at B 4: 96^2 x 64 (L 13), 32^2 x 192 (L 13),
    # 16^2 x 192 (L 9)
    "96_bf16": (4, 96, 96, 64, 13, torch.bfloat16),
    "32_bf16": (4, 32, 32, 192, 13, torch.bfloat16),
    "16_bf16": (4, 16, 16, 192, 9, torch.bfloat16),
    "32_f32": (4, 32, 32, 192, 13, torch.float32),
    # C not a multiple of 8: one channel a lane
    "scalar_bf16": (2, 13, 21, 12, 3, torch.bfloat16),
    "scalar_f32": (2, 13, 21, 20, 3, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_k8_matches_plain(card, name):
    """K8's forward equals the plain version bit for bit; its backward is
    within float32 rounding of the plain version's autograd (module
    docstring); one launch each way."""
    b, hgt, wid, c, links, dtype = CARD_SHAPES[name]
    for scale in (0.7, 6.0):
        h, flows, gs = _card_operands(card, b, hgt, wid, c, links, dtype,
                                      scale)
        before = profiling.counters()["traj_warp.launches"]
        got = k8.traj_warp_fwd(h, flows)
        assert torch.equal(got, k8.traj_warp_plain(h, flows)), scale
        dh, df = k8.traj_warp_bwd(h, flows, gs)
        assert profiling.counters()["traj_warp.launches"] - before == 2
        want_dh, want_df = k8.traj_warp_bwd_plain(h, flows, gs)
        ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
        for what, a, w, tol in (("dh", dh, want_dh, 1e-5),
                                ("dflows", df, want_df, 1e-4)):
            a, w = a.float(), w.float()
            bound = tol * w.abs().max() + ulp * w.abs()
            assert bool(((a - w).abs() <= bound).all()), (name, scale, what)


def _hko7_model(card, seed=0):
    torch.manual_seed(seed)
    return TrajGRU(dtype=torch.bfloat16).to(card)


def _hko7_batch(card, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return (torch.rand(4, 5, 1, 480, 480, device=card, generator=g),
            torch.rand(4, 20, 1, 480, 480, device=card, generator=g))


@pytest.mark.cuda
def test_hko7_step_launches_k8_150_times_and_replays(card):
    """At the HKO-7 widths (B 4, 5 -> 20 frames of 480^2, bf16), three
    train steps' losses and gradients: the first eager, the second
    captured, the third replayed; each launches K8 150 times (75
    cell-steps, one launch each way), replayed or not; the replayed step's
    loss and predictions equal an eager step's from the same state within
    1e-6, its gradients within 2e-2 of each leaf's norm (K8's atomics sum
    dh in another order, and the bf16 recurrence carries the last bit)."""
    graphed, eager = _hko7_model(card), _hko7_model(card)
    for step in range(3):
        x, y = _hko7_batch(card, 10 + step)
        got = []
        for model in (graphed, eager):
            model.zero_grad(set_to_none=True)
            before = profiling.counters()
            total, pred = (model.loss(x, y) if model is graphed
                           else model._loss(x, y))
            total.backward()
            after = profiling.counters()
            assert after["traj_warp.launches"] - \
                before["traj_warp.launches"] == 150, step
            got.append((total.detach(), pred.detach(),
                        [p.grad.clone() for p in model.parameters()]))
        (lg, pg, gg), (le, pe, ge) = got
        assert float((lg - le).abs()) <= 1e-6 * float(le.abs()), step
        assert float((pg - pe).norm() / pe.norm()) <= 1e-6, step
        for a, w in zip(gg, ge):
            assert float((a - w).norm()) <= 2e-2 * float(w.norm()), step
    assert any(v is not None for v in loss_graphs._GRAPHS[graphed].values())
