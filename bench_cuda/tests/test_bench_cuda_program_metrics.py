"""The readers of the program's own spans and counters (``program.py`` and
its metrics) on records and a program log made by hand; each returns
nothing where the program keeps no log (as a program before its trace
existed); the readers that were there read as before with a log present."""
import pytest

from bench_cuda import harness, program
from bench_cuda.tests.test_bench_cuda_metrics import EXPECTED, _records
from bench_cuda.trace import Records
from pl_convlstm_gan_tpu_torch.ops.kernels.rollout_kernel import (
    rollout_schedule, stamp_phases)
from pl_convlstm_gan_tpu_torch.utils import profiling

B = 1e9          # µs: where the device stretch starts
H = B + 50000.0  # µs: where the host stretch's window opens
K5_KEY = (3, 30, 0, 1)
NEW = ("k5_issue_us.stream", "k5_barrier_share.stream",
       "k5_head_share.stream", "idle_in_program.stream",
       "host_syncs_per_step.train", "sync_wait_ms.train",
       "idle_in_program.train", "backward_device_ms.train")


def _stamps(seed):
    import torch
    table = rollout_schedule(*K5_KEY)
    gaps = torch.randint(1, 5000, (2 * table.shape[0],),
                         generator=torch.Generator().manual_seed(seed))
    return torch.cat([torch.zeros(1, dtype=torch.int64),
                      torch.cumsum(gaps, 0)]) + 10 ** 15


class _Log:
    """A program log made by hand: spans (name, start µs, end µs, parent
    index or None, counts) and K5 launches (µs, seed of the stamps)."""

    def __init__(self, spans, k5=()):
        self.log = profiling.ProgramLog()
        made = []
        for name, s, e, parent, counts in spans:
            p = made[parent] if parent is not None else None
            sid = len(made)
            sp = profiling.Span("plcg." + name, int(s * 1e3), sid,
                                -1 if p is None else p.id,
                                sid if p is None else p.root)
            sp.end_ns = int(e * 1e3)
            if counts is not None:
                keys = list(profiling.counters())
                sp.c0 = [0] * len(keys)
                sp.c1 = [counts.get(k, 0) for k in keys]
            made.append(sp)
        self.log.spans = made
        self.log.k5 = [(t * 1e3, _stamps(seed), K5_KEY) for t, seed in k5]


def _stream_log():
    """Device stretch: observe 0-200 µs (inside it K5's issue, 50 µs),
    forecast 150-3200 µs (its issue 70 µs); two K5 launches. Host stretch:
    one observe and one K5 launch, which the device stretch's readers
    leave out."""
    return _Log([("stream.observe", B, B + 200, None, None),
                 ("k5.issue", B + 20, B + 70, 0, None),
                 ("stream.forecast", B + 150, B + 3200, None, None),
                 ("k5.issue", B + 160, B + 230, 2, None),
                 ("stream.observe", H + 100, H + 900, None, None),
                 ("k5.issue", H + 200, H + 700, 4, None)],
                k5=[(B + 100, 1), (B + 3100, 2), (H + 800, 3)])


def _stream_records():
    """Device work 100-3000 and 3100-6000 µs of a 20 ms stretch."""
    rec = Records(device=[("rollout_persistent_kernel", B + 100, B + 3000,
                           True),
                          ("rollout_persistent_kernel", B + 3100, B + 6000,
                           True)],
                  info={"units": 1, "wall_s": 0.020})
    rec.host = Records(info={"units": 1, "t0_us": H, "t1_us": H + 10000})
    return rec


def _train_log():
    """Device stretch: two steps with 2 host syncs each (waits 1 + 3 ms and
    2 + 2 ms); host stretch: one step whose backward runs 18-40 µs."""
    two = {"host_syncs": 2}
    return _Log([("train.step", B, B + 10000, None, two),
                 ("train.forward", B + 100, B + 2000, 0, None),
                 ("train.backward", B + 2000, B + 3000, 0, None),
                 ("sync.finite_check", B + 3000, B + 4000, 0, None),
                 ("train.update", B + 4000, B + 5000, 0, None),
                 ("sync.loss_value", B + 5000, B + 8000, 0, None),
                 ("train.step", B + 10500, B + 19000, None, two),
                 ("sync.finite_check", B + 11000, B + 13000, 6, None),
                 ("sync.loss_value", B + 14000, B + 16000, 6, None),
                 ("train.step", H + 1, H + 500, None, two),
                 ("train.backward", H + 18, H + 40, 9, None)])


def _train_records():
    """Device stretch: work 0-9000 and 11000-18000 µs of 20 ms. Host
    stretch: four launch calls (two inside the backward: a kernel of 200
    µs and a copy) and their work, in order, with the backward's device
    shadow, which the pairing leaves out."""
    rec = Records(device=[("k", B, B + 9000, True),
                          ("k", B + 11000, B + 18000, True)],
                  info={"units": 2, "wall_s": 0.020})
    rec.host = Records(
        cpu=[("cudaLaunchKernel", H + 10, H + 15),
             ("cudaLaunchKernel", H + 20, H + 25),
             ("cudaMemcpyAsync", H + 30, H + 35),
             ("aten::mul", H + 41, H + 49),
             ("cuLaunchKernel", H + 50, H + 55)],
        device=[("k1", H + 12, H + 100, True),
                ("k2", H + 100, H + 300, True),
                ("plcg.train.backward", H + 100, H + 310, True),
                ("Memcpy DtoD", H + 300, H + 310, False),
                ("k3", H + 310, H + 400, True)],
        info={"units": 1, "t0_us": H, "t1_us": H + 1000})
    return rec


def _phases(seeds):
    table = rollout_schedule(*K5_KEY)
    return [stamp_phases(_stamps(s), table) for s in seeds]


def _expected():
    ph = _phases((1, 2))
    total = sum(p["total_us"] for p in ph)
    return {
        "k5_issue_us.stream": 60.0,
        "k5_barrier_share.stream": 100.0 * sum(p["barrier_us"] for p in ph)
        / total,
        "k5_head_share.stream": 100.0 * sum(p["work_us"]["head"] for p in ph)
        / total,
        # spans cover 0-3200 µs, the device 100-3000 and 3100-3200 of it
        "idle_in_program.stream": 100.0 * 200.0 / 20000.0,
        "host_syncs_per_step.train": 2.0,
        "sync_wait_ms.train": 4.0,
        # the steps span 0-10000 and 10500-19000 µs; the device is idle
        # in 9000-10000, 10500-11000 and 18000-19000 of them
        "idle_in_program.train": 100.0 * 2500.0 / 20000.0,
        "backward_device_ms.train": 0.2,
    }


@pytest.fixture
def with_log(monkeypatch):
    def use(fake):
        monkeypatch.setattr(program, "log", lambda: fake.log)
    return use


@pytest.mark.parametrize("name", NEW)
def test_new_reader(with_log, name):
    stream = name.endswith(".stream")
    with_log(_stream_log() if stream else _train_log())
    rec = _stream_records() if stream else _train_records()
    got = harness.metric_reader(name)(rec)
    assert got == pytest.approx(_expected()[name])


@pytest.mark.parametrize("name", ("idle_in_program.stream",
                                  "idle_in_program.train"))
def test_idle_in_program_within_idle_share(with_log, name):
    stream = name.endswith(".stream")
    with_log(_stream_log() if stream else _train_log())
    rec = _stream_records() if stream else _train_records()
    share = harness.metric_reader(name.replace("idle_in_program",
                                               "idle_share"))(rec)
    assert 0 < harness.metric_reader(name)(rec) <= share


@pytest.mark.parametrize("name", NEW)
def test_new_reader_without_the_programs_log(monkeypatch, name):
    """A program without ``program_log`` (the parent of the trace): the
    readers find nothing and raise nothing."""
    monkeypatch.delattr(profiling, "program_log")
    assert program.log() is None
    rec = _stream_records() if name.endswith(".stream") else \
        _train_records()
    assert harness.metric_reader(name)(rec) is None


@pytest.mark.parametrize("name", NEW)
def test_new_reader_with_an_empty_log(with_log, name):
    with_log(_Log([]))
    assert harness.metric_reader(name)(Records(
        info={"units": 0, "wall_s": 0.0})) is None


def test_backward_pairing_by_order():
    """Work is paired with launch calls by rank; counts that differ by more
    than one in a thousand calls give nothing rather than a wrong sum; a
    difference within that moves a window's work by at most that many
    intervals at each end."""
    host = _train_records().host
    assert program.launched_device_us(host, [(H + 18, H + 40)]) == 200.0
    assert program.launched_device_us(host, [(H, H + 60)]) == 88 + 200 + 90
    host.cpu.append(("cudaLaunchKernel", H + 60, H + 61))
    assert program.launched_device_us(host, [(H + 18, H + 40)]) is None
    host = _train_records().host
    host.cpu = host.cpu * 400                     # 1600 calls, 4 intervals
    host.device = host.device * 400
    host.device.append(("untraced", H + 401, H + 402, True))
    assert program.launched_device_us(host, [(H + 18, H + 40)]) is not None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_existing_reader_unchanged_with_a_program_log(with_log, name):
    """The readers that were there read the same records as before while
    the program's log holds spans of both stretches and K5 launches."""
    with_log(_stream_log() if name.endswith(".stream") else _train_log())
    rec = _records()
    rec.host.cpu.append(("plcg.train.backward", 150.0, 700.0))
    assert harness.metric_reader(name)(rec) == pytest.approx(EXPECTED[name])
