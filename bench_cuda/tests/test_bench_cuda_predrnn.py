"""The ``predrnn_v2_kth_bf16.train_rss`` cell's files at a size the CPU
holds (16 x 16 frames, two layers of 8, 3 -> 6 frames, B 4) on the
program's plain paths: the driver's control flow and readings; ``correct``
coming out false under the cell's own limits with each planted fault and
with the fp8 control in the program's place; ``flops_predrnn`` against
``FlopCounterMode`` on a tiny forward; the benchmark's reference equal to
the program repository's; the readers the cell reports on records made by
hand."""
import copy
import time

import pytest
import torch

from bench_cuda import calibrate_predrnn, checks, flops_predrnn, harness
from bench_cuda.reference import convlstm as ref_convlstm
from bench_cuda.reference import predrnn as ref_predrnn
from bench_cuda.trace import Records

CELL = "predrnn_v2_kth_bf16.train_rss"
SEED = 2 ** 31 + 12345


def tiny_cell() -> harness.Cell:
    c = copy.deepcopy(harness.find_cell(CELL, harness.load_manifest()))
    c.config["model"].update(hidden_dims=[8, 8], image_size=16,
                             input_frames=3, output_frames=3)
    c.config["training"]["batch_size"] = 4
    c.mix.update(pool=4, warmup_steps=1, trace_steps=2, ref_rows=2)
    return c


def run(fault=None, seed=SEED):
    return calibrate_predrnn.program(tiny_cell(), seed, 0.5, fault=fault,
                                     device="cpu")[0]


@pytest.fixture(scope="module")
def sound():
    return run()


def test_sound_run():
    c = tiny_cell()
    out = calibrate_predrnn.train_predrnn.run(
        c, SEED, 0.5, False, harness.Clock(time.perf_counter()), "cpu")
    assert out.attempted > 0 and out.failed == 0
    assert set(out.readings) == set(checks.limits(CELL))
    assert set(out.e2e) == {"setup_s", "train_samples_per_s",
                            "train_peak_mem_gib"}
    assert all(v < 0.01 for v in out.readings.values()), out.readings


@pytest.mark.parametrize("fault", calibrate_predrnn.FAULTS)
def test_fault_is_not_correct(sound, fault):
    got = run(fault)
    assert not checks.judge(got, checks.limits(CELL)), got
    worst = max(got[k] / sound[k] for k in got if sound[k] > 0)
    assert worst > 10, (got, sound)


def test_control_is_not_correct():
    readings = calibrate_predrnn.control(tiny_cell(), SEED, device="cpu")
    assert not checks.judge(readings, checks.limits(CELL)), readings


def test_forward_flops_against_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode
    from pl_convlstm_gan_tpu_torch.predict import build_model
    c = tiny_cell()
    model = build_model(harness.program_config(c.config))
    frames = torch.rand(4, 6, 1, 16, 16)
    mask = torch.rand(4, 4) < 0.5
    with FlopCounterMode(display=False) as counter:
        model.loss(frames[:, :3], frames[:, 3:], mask)
    assert flops_predrnn.forward_flops(c.config["model"], 4) == \
        counter.get_total_flops()


def test_full_size_counts():
    """7.46 TFLOP a forward at the KTH widths and B 8; K7's bytes a step
    11.77 GB (3.51 ms at 3.35 TB/s; pass A's second c' and m' not counted)."""
    model = harness.find_cell(CELL, harness.load_manifest()).config["model"]
    assert flops_predrnn.forward_flops(model, 8) / 1e12 == pytest.approx(
        7.4617, abs=1e-4)
    px, fw = 8 * 32 * 32, 128
    per_step = sum(flops_predrnn.k7_launch_bytes(k, px, fw, "bfloat16")
                   for k in ("a_fwd", "b_fwd", "a_bwd", "b_bwd"))
    assert flops_predrnn.k7_step_bytes(model, 8, "bfloat16") == \
        76 * per_step - 10 * px * fw * 2


@pytest.mark.parametrize("kind", ["a_fwd", "b_fwd", "a_bwd", "b_bwd"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k7_bytes_match_chip_smoke(kind, dtype):
    """``chip_smoke.st_gates_bytes`` (the smoke script's own copy of K7's
    byte count) equals ``flops_predrnn.k7_launch_bytes``."""
    chip_smoke = pytest.importorskip("chip_smoke")
    assert flops_predrnn.k7_launch_bytes(kind, 8192, 128, dtype) == \
        chip_smoke.st_gates_bytes(kind, 8192, 128, getattr(torch, dtype))


def test_references_agree():
    """The benchmark's reference (no rounding) and the program
    repository's give the same loss and gradients on the same weights,
    frames and masks."""
    from pl_convlstm_gan_tpu_torch.reference import predrnn as port_ref
    model = tiny_cell().config["model"]
    g = torch.Generator().manual_seed(3)
    shapes = ref_predrnn.param_shapes(model)
    params = {k: (torch.rand(s, generator=g) - 0.5) * 0.4
              for k, s in shapes.items()}
    frames = torch.rand(2, 6, 1, 16, 16, generator=g)
    mask = torch.rand(4, 2, generator=g) < 0.5
    a = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    b = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    la = ref_predrnn.loss(a, model, frames, mask,
                          ref_convlstm.rounding("f32"))
    lb, _ = port_ref.loss(b, 2, 3, 6, 4, model["decouple_beta"], frames,
                          mask)
    assert float(la.detach()) == pytest.approx(float(lb.detach()), rel=1e-6)
    ga = torch.autograd.grad(la, list(a.values()))
    gb = torch.autograd.grad(lb, list(b.values()))
    for x, y in zip(ga, gb):
        assert torch.allclose(x, y, rtol=1e-5, atol=1e-7)


def _records():
    """Two steps: four K7 kernels (two passes of each unit, 10 and 30 µs),
    a cuDNN kernel and a copy; the program counted four K7 launches."""
    rec = Records(
        device=[("void st_gates_a_fwd_kernel<bf16, 8>", 0.0, 10.0, True),
                ("sm90_xmma_fprop", 10.0, 110.0, True),
                ("void st_gates_a_bwd_kernel<bf16, 8>", 110.0, 140.0, True),
                ("Memcpy DtoD", 140.0, 150.0, False),
                ("void st_gates_a_fwd_kernel<bf16, 8>", 200.0, 210.0, True),
                ("void st_gates_a_bwd_kernel<bf16, 8>", 210.0, 240.0, True)],
        unit_s=[0.010, 0.012, 0.011],
        info={"units": 2, "wall_s": 0.001, "unit_flops": 1e12,
              "peak_flops": 1e15, "chips": 1, "k7_launches": 4,
              "k7_unit_bytes": 3.35e12 * 20e-6})
    return rec


def test_readers():
    rec = _records()
    read = harness.metric_reader
    assert read("step_mfu.train")(rec) == pytest.approx(
        100.0 * 1e12 / (0.011 * 1e15))
    assert read("st_gates_roofline.train_rss")(rec) == pytest.approx(
        100.0 * 20.0 / 40.0)
    assert read("launches_per_step.train")(rec) == pytest.approx(2.5)
    assert read("conv_device_ms.train_rss")(rec) == pytest.approx(0.05)
    rec.info["k7_launches"] = 5
    assert read("st_gates_roofline.train_rss")(rec) is None
    del rec.info["k7_launches"]
    assert read("st_gates_roofline.train_rss")(rec) is None


@pytest.mark.parametrize("name", ["step_mfu.train",
                                  "st_gates_roofline.train_rss",
                                  "launches_per_step.train",
                                  "idle_in_program.train",
                                  "conv_device_ms.train_rss"])
def test_reader_with_nothing_to_read(name):
    assert harness.metric_reader(name)(Records(
        info={"units": 0, "wall_s": 0.0})) is None
