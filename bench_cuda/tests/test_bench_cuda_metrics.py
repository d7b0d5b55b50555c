"""Each per-layer metric's reader on records made by hand: what it reads,
and that it returns nothing where there is nothing to read."""
import os

import pytest

from bench_cuda import harness
from bench_cuda.trace import Records, breakdown

MANIFEST = harness.load_manifest()


def _records():
    """Two units: device work 0-3 and 5-6 ms in unit 1 (a K5 launch and a
    copy), 10-13 ms in unit 2 (a K5 launch and an NCCL kernel), over a
    20 ms stretch; the host stretch: one unit, 4 ms under
    convolution_backward, a gap during a host op."""
    rec = Records(
        device=[("rollout_persistent_kernel", 0.0, 3000.0, True),
                ("Memcpy DtoD", 5000.0, 6000.0, False),
                ("rollout_persistent_kernel", 10000.0, 12000.0, True),
                ("ncclDevKernel_AllReduce_Sum_f32", 12000.0, 13000.0, True)],
        event_ms={"observe": [0.5, 0.7, 0.6], "forecast": [2.0, 3.0, 4.0]},
        unit_s=[0.010, 0.012],
        info={"units": 2, "wall_s": 0.020, "unit_flops": 1e12,
              "unit_bound_ms": 1.0, "peak_flops": 1e15, "chips": 2})
    rec.host = Records(
        device=[("k", 100.0, 200.0, True), ("k", 900.0, 1000.0, True)],
        cpu=[("aten::mul", 150.0, 800.0)],
        op_device_us={"aten::convolution_backward": 4000.0},
        info={"units": 1, "t0_us": 0.0, "t1_us": 1000.0})
    return rec


EXPECTED = {
    "observe_ms.stream": 0.6,
    "forecast_ms.stream": 3.0,
    "rollout_roofline.stream": 100.0 * 1000.0 / 3500.0,
    "request_mfu.stream": 100.0 * 1e12 / (0.011 * 1e15),
    "idle_share.stream": 100.0 * (1 - 7.0 / 20.0),
    "idle_share.train": 100.0 * (1 - 7.0 / 20.0),
    "step_mfu.train": 100.0 * 1e12 / (0.011 * 2 * 1e15),
    "conv_backward_ms.train": 4.0,
    "launches_per_step.train": 1.5,
}


def test_every_metric_has_an_expectation():
    readers = {f[:-3] for f in os.listdir(os.path.join(harness.BENCH_DIR,
                                                      "metrics"))
               if f.endswith(".py") and not f.startswith("_")}
    assert {m["name"] for m in MANIFEST["per_layer"]} <= readers
    assert readers == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    assert harness.metric_reader(name)(_records()) == pytest.approx(
        EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_with_nothing_to_read(name):
    assert harness.metric_reader(name)(Records(
        info={"units": 0, "wall_s": 0.0})) is None


def test_breakdown():
    got = breakdown(_records())
    assert got["device_ops"][0] == ["rollout_persistent_kernel", 0.005]
    assert len(got["device_ops"]) == 3
    assert got["idle_gaps"][0] == ["aten::mul", pytest.approx(0.0007)]
