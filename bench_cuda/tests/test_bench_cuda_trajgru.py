"""The ``trajgru_hko7_bf16.train_hko`` cell's files at a size the CPU holds
(40 x 40 frames, two levels of 8 and 16 channels, L 3, 2 -> 3 frames, B 4)
on the program's plain paths: the driver's control flow and readings;
``correct`` coming out false under the cell's own limits with each planted
fault and with the fp8 control in the program's place; ``flops_trajgru``
against ``FlopCounterMode`` on a tiny forward and against a hand count of
K8's bytes; the reference's blocked step equal to the unblocked one; the
benchmark's reference equal to the program repository's; the cell's files
found by name; the new reader on records made by hand."""
import copy
import time

import pytest
import torch

from bench_cuda import calibrate_trajgru, checks, flops_trajgru, harness
from bench_cuda.reference import convlstm as ref_convlstm
from bench_cuda.reference import train as ref_train
from bench_cuda.reference import trajgru as ref_trajgru
from bench_cuda.trace import Records

CELL = "trajgru_hko7_bf16.train_hko"
SEED = 2 ** 31 + 12345
TINY = {"hidden_dims": [8, 16], "traj_links": [3, 3],
        "traj_forecast_links": [3, 3],
        "traj_stems": [[4, 7, 5, 1], [16, 3, 2, 1]],
        "traj_deconvs": [[4, 7, 5, 1], [8, 4, 2, 1]], "image_size": 40,
        "input_frames": 2, "output_frames": 3}


def tiny_cell() -> harness.Cell:
    c = copy.deepcopy(harness.find_cell(CELL, harness.load_manifest()))
    c.config["model"].update(TINY)
    c.mix.update(pool=4, warmup_steps=1, trace_steps=2, ref_rows=2)
    return c


def run(fault=None, seed=SEED):
    return calibrate_trajgru.program(tiny_cell(), seed, 0.5, fault=fault,
                                     device="cpu")[0]


@pytest.fixture(scope="module")
def sound():
    return run()


def test_cell_files_are_found_by_name():
    cell = harness.find_cell(CELL, harness.load_manifest())
    assert cell.chips == 1 and cell.config["family"] == "trajgru"
    assert cell.mix["driver"] == "train_trajgru"
    assert harness.driver(cell.mix).__name__.endswith("train_trajgru")
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "train_samples_per_s", "train_peak_mem_gib"}
    assert "traj_warp_roofline.train_hko" in {m["name"]
                                              for m in cell.per_layer}
    # the loss and the gap of gradient norms are read but have no limit:
    # the fp8 control moves them by no more than the program's own seeds
    # spread (PERF.md)
    assert set(checks.limits(CELL)) == {"grad_diff_gap", "change_median_gap"}


def test_sound_run():
    c = tiny_cell()
    out = calibrate_trajgru.train_trajgru.run(
        c, SEED, 0.5, False, harness.Clock(time.perf_counter()), "cpu")
    assert out.attempted > 0 and out.failed == 0
    assert set(out.readings) == set(checks.limits(CELL)) | {
        "loss_rel_gap", "grad_gap"}
    assert set(out.e2e) == {"setup_s", "train_samples_per_s",
                            "train_peak_mem_gib"}
    assert all(v < 0.1 for v in out.readings.values()), out.readings


@pytest.mark.parametrize("fault", calibrate_trajgru.FAULTS)
def test_fault_is_not_correct(sound, fault):
    got = run(fault)
    assert not checks.judge(got, checks.limits(CELL)), got
    worst = max(got[k] / sound[k] for k in got if sound[k] > 0)
    assert worst > 10, (got, sound)


def test_control_is_not_correct():
    readings = calibrate_trajgru.control(tiny_cell(), SEED, device="cpu")
    assert not checks.judge(readings, checks.limits(CELL)), readings


def test_forward_flops_against_the_flop_counter():
    """Every conv, transposed conv and link GEMM of a tiny forward, as
    PyTorch's flop counter sees them on the program's plain path."""
    from torch.utils.flop_counter import FlopCounterMode
    from pl_convlstm_gan_tpu_torch.predict import build_model
    c = tiny_cell()
    model = build_model(harness.program_config(c.config))
    frames = torch.rand(4, 5, 1, 40, 40)
    with FlopCounterMode(display=False) as counter:
        model.loss(frames[:, :2], frames[:, 2:])
    assert flops_trajgru.forward_flops(c.config["model"], 4) == \
        counter.get_total_flops()


def test_full_size_counts():
    """1.396 TFLOP a forward at the HKO-7 widths and B 4 (49.2 GFLOP an
    encoder step, 57.5 a forecaster step), 4.19 a train step; K8's bytes a
    step 4.37 GB, of which the stacks written 1.79 GB."""
    model = harness.find_cell(CELL, harness.load_manifest()).config["model"]
    assert flops_trajgru.forward_flops(model, 4) == 1395567820800
    assert flops_trajgru.train_step_flops(model, 4) == 3 * 1395567820800
    assert flops_trajgru.level_pixels(model, 4) == [4 * 96 * 96, 4 * 32 * 32,
                                                    4 * 16 * 16]
    stacks = sum(px * c * links * steps * 2 for px, c, links, steps
                 in flops_trajgru.cell_steps(model, 4))
    assert stacks == 1787166720
    assert flops_trajgru.k8_step_bytes(model, 4, "bfloat16") == 4370903040


def test_k8_bytes_by_hand():
    """One cell-step at 2 x 3 x 3 pixels, C 8, L 2 in bf16: forward h (8),
    flows (4) and S (16) a pixel, 2 bytes each; backward gS (16), h (8),
    flows (4) and dflows (4) at 2 bytes and dh (8) at 4."""
    px = 2 * 3 * 3
    assert flops_trajgru.k8_launch_bytes("fwd", px, 8, 2, "bfloat16") == \
        px * 2 * (8 + 4 + 16)
    assert flops_trajgru.k8_launch_bytes("bwd", px, 8, 2, "bfloat16") == \
        px * (2 * (16 + 8 + 4 + 4) + 4 * 8)


def _params(model, seed=3):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.rand(s, generator=g) - 0.5) * 0.4
            for k, s in ref_trajgru.param_shapes(model).items()}


def test_blocked_train_step_equals_the_unblocked_one():
    """The reference's step in blocks of one row equals its step over the
    whole batch: the loss, the clipped gradients and Adam's moments after
    it to float32 rounding; the parameters within 2 lr (Adam's first step
    moves an element by lr times the sign of its gradient, which rounding
    flips for an element near zero)."""
    model = {**tiny_cell().config["model"]}
    params = _params(model)
    g = torch.Generator().manual_seed(4)
    batch = (torch.rand(2, 2, 1, 40, 40, generator=g),
             torch.rand(2, 3, 1, 40, 40, generator=g))
    q = ref_convlstm.rounding("f32")
    whole = ref_trajgru.train_step(model, ref_train.TrainState.fresh(params),
                                   batch, 1e-3, 0.5, q)
    blocks = ref_trajgru.train_step(model, ref_train.TrainState.fresh(params),
                                    batch, 1e-3, 0.5, q, rows=1)
    assert blocks[0] == pytest.approx(whole[0], rel=1e-6)
    for k in whole[1]:
        assert torch.allclose(blocks[1][k], whole[1][k], rtol=1e-5,
                              atol=1e-9), k
        assert torch.allclose(blocks[2].exp_avg[k], whole[2].exp_avg[k],
                              rtol=1e-5, atol=1e-10), k
        assert float((blocks[2].params[k] - whole[2].params[k]).abs().max()
                     ) <= 2e-3, k


def test_references_agree():
    """The benchmark's reference (no rounding) and the program
    repository's give the same loss and gradients on the same weights and
    frames."""
    from pl_convlstm_gan_tpu_torch.reference import trajgru as port_ref
    model = tiny_cell().config["model"]
    params = _params(model)
    g = torch.Generator().manual_seed(5)
    inputs = torch.rand(2, 2, 1, 40, 40, generator=g)
    targets = torch.rand(2, 3, 1, 40, 40, generator=g)
    a = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    b = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    la = ref_trajgru.loss(a, model, inputs, targets,
                          ref_convlstm.rounding("f32"))
    lb, _ = port_ref.loss(b, model, inputs, targets)
    assert float(la.detach()) == pytest.approx(float(lb.detach()), rel=1e-6)
    for x, y in zip(torch.autograd.grad(la, list(a.values())),
                    torch.autograd.grad(lb, list(b.values()))):
        assert torch.allclose(x, y, rtol=1e-5, atol=1e-9)


def _records():
    """Two steps: four K8 kernels (10 and 30 µs), a cuBLAS kernel and a
    copy; the program counted four K8 launches."""
    return Records(
        device=[("void traj_warp_fwd_kernel<bf16, 8>", 0.0, 10.0, True),
                ("nvjet_tst_128x96", 10.0, 110.0, True),
                ("void traj_warp_bwd_kernel<bf16, 8>", 110.0, 140.0, True),
                ("Memcpy DtoD", 140.0, 150.0, False),
                ("void traj_warp_fwd_kernel<bf16, 8>", 200.0, 210.0, True),
                ("void traj_warp_bwd_kernel<bf16, 8>", 210.0, 240.0, True)],
        unit_s=[0.010, 0.012, 0.011],
        info={"units": 2, "wall_s": 0.001, "unit_flops": 1e12,
              "peak_flops": 1e15, "chips": 1, "k8_launches": 4,
              "k8_unit_bytes": 3.35e12 * 20e-6})


def test_reader():
    rec = _records()
    read = harness.metric_reader("traj_warp_roofline.train_hko")
    assert read(rec) == pytest.approx(100.0 * 20.0 / 40.0)
    rec.info["k8_launches"] = 5
    assert read(rec) is None
    del rec.info["k8_launches"]
    assert read(rec) is None
    assert read(Records(info={"units": 0, "wall_s": 0.0})) is None
