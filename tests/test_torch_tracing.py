"""The port's own trace (``utils/profiling.py``: ``span``, ``host_sync``,
``program_trace``, ``program_log``, ``counters``, K5's stamps) on the CPU:
off by default and then free of ``record_function``, the spans a train
step and a stream request log, the host syncs each train step counts,
``profile_trace``'s file, the profiler's flag the gate reads, and
``stamp_phases``. One test needs the card (marker ``cuda``): a span and a
kernel from one ``torch.profiler`` stretch on one clock. This file imports
no JAX, so that the card runs it:
``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py``."""
import glob
import json
import sys
import threading

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from pl_convlstm_gan_tpu_torch import data as port_data
from pl_convlstm_gan_tpu_torch.config import Config
from pl_convlstm_gan_tpu_torch.models import ConvLSTMForecaster
from pl_convlstm_gan_tpu_torch.models.discriminator import Discriminator
from pl_convlstm_gan_tpu_torch.models.generator import Generator
from pl_convlstm_gan_tpu_torch.ops.kernels.rollout_kernel import (
    rollout_schedule, stamp_phases)
from pl_convlstm_gan_tpu_torch.streaming import StreamingForecaster
from pl_convlstm_gan_tpu_torch.train.steps import (GANTrainState, TrainState,
                                                   forecaster_train_step,
                                                   gan_train_step,
                                                   generator_train_step,
                                                   make_optimizer)
from pl_convlstm_gan_tpu_torch.utils import profiling

HIDDEN, T_IN, T_OUT, SIZE, B = (8, 8), 2, 3, 16, 2
LOSS_CFG = dict(lambda_point=1.0, lambda_conserve=1.0, lambda_smooth=0.1,
                lambda_temporal=0.05, use_weighted_loss=True,
                weight_strategy="log")
FORECASTER_STEP = ["train.step", "train.forward", "train.backward",
                   "sync.finite_check", "train.update", "sync.loss_value"]


def _forecaster_state(impl="torch"):
    torch.manual_seed(0)
    model = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT, convlstm_impl=impl)
    return TrainState(model, make_optimizer(model))


def _sequence_batch(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.random((B, t, 1, SIZE, SIZE),
                                             dtype=np.float32))
                 for t in (T_IN, T_OUT))


def _forecaster_step(state):
    return forecaster_train_step(state, _sequence_batch(), 1e-3)


def _generator_step():
    torch.manual_seed(0)
    model = Generator(hidden_dims=(8,), lu_channels=3, scale_factor=2)
    state = TrainState(model, make_optimizer(model))
    ds = port_data.SyntheticDownscalingDataset(
        num_days=8, T=3, lr_size=8, scale_factor=2, num_stations=4,
        num_lu_classes=3, seed=0)
    batch = tuple(torch.from_numpy(np.stack(a))
                  for a in zip(*(ds[i] for i in range(B))))
    return lambda: generator_train_step(state, batch, 5e-4, LOSS_CFG)


def _gan_step(impl):
    torch.manual_seed(0)
    gen = ConvLSTMForecaster((8,), T_IN, T_OUT)
    disc = Discriminator(1, (8, 16))
    state = GANTrainState(gen, disc, make_optimizer(gen),
                          make_optimizer(disc))
    return lambda: gan_train_step(state, _sequence_batch(), 1e-3, 1e-3,
                                  impl=impl)


def _streaming():
    cfg = Config.from_dict({
        "model": {"family": "forecaster", "hidden_dims": list(HIDDEN),
                  "input_frames": T_IN, "output_frames": T_OUT},
        "output": {"output_dir": "/tmp/unused_torch_tracing"}})
    torch.manual_seed(0)
    model = ConvLSTMForecaster(HIDDEN, T_IN, T_OUT)
    return StreamingForecaster(cfg, model.state_dict(), device="cpu")


def _request(sf):
    frames = torch.rand(1, 3, 1, SIZE, SIZE, generator=torch.Generator()
                        .manual_seed(1))
    state, _ = sf.observe_window(sf.init_state(1, SIZE, SIZE), frames[:, :2])
    state, _ = sf.observe(state, frames[:, 2])
    return sf.forecast(state, 4)


def _delta(before, after):
    return {k: after[k] - before[k] for k in before}


@pytest.fixture
def no_record_function(monkeypatch):
    """Every ``record_function`` raises when the port calls it: its own
    (``profiling._record_range``) and torch's public ones, whose calls by
    torch itself (``Optimizer.zero_grad``'s) pass through."""
    def patched(real):
        def record_function(*a, **k):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            if caller.startswith("pl_convlstm_gan_tpu_torch"):
                raise AssertionError(f"record_function called by {caller} "
                                     f"with tracing off")
            return real(*a, **k)
        return record_function
    monkeypatch.setattr(autograd_profiler, "record_function",
                        patched(autograd_profiler.record_function))
    monkeypatch.setattr(torch.profiler, "record_function",
                        patched(torch.profiler.record_function))
    monkeypatch.setattr(profiling, "_record_range",
                        patched(profiling._record_range))


@pytest.mark.parametrize("work", ["forecaster_step", "stream_request"])
def test_off_logs_nothing_and_calls_no_record_function(no_record_function,
                                                       work):
    """Tracing off (the default): a train step and a stream request run
    with ``record_function`` raising, log no span, and count what the same
    work counts with tracing on."""
    assert not profiling.tracing()
    sf = _streaming() if work == "stream_request" else None
    run = ((lambda: _request(sf)) if sf else
           (lambda: _forecaster_step(_forecaster_state())))
    log = profiling.program_log()
    n_spans, n_k5 = len(log.spans), len(log.k5)
    before = profiling.counters()
    run()
    off = _delta(before, profiling.counters())
    assert (len(log.spans), len(log.k5)) == (n_spans, n_k5)
    assert profiling.span("x") is profiling.span("y")   # the shared null
    with profiling.program_trace() as on_log:
        before = profiling.counters()
        run()
        on = _delta(before, profiling.counters())
    assert on_log.spans and on == off


def test_forecaster_step_spans_in_order_with_one_id():
    """A forecaster step under ``program_trace`` logs step > forward,
    backward, sync.finite_check, update, sync.loss_value, in that order,
    each closed inside its parent, all with the step's id as root."""
    state = _forecaster_state()
    with profiling.program_trace() as log:
        _forecaster_step(state)
    names = [s.name for s in log.spans]
    assert names == [profiling.SPAN_PREFIX + n for n in FORECASTER_STEP]
    step, *inner = log.spans
    assert step.parent == -1 and step.root == step.id
    assert all(s.parent == step.id and s.root == step.id for s in inner)
    assert all(step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
               for s in inner)
    assert all(a.end_ns <= b.start_ns for a, b in zip(inner, inner[1:]))
    assert step.counts["host_syncs"] == 2


def test_stream_request_spans_are_top_level_one_id_a_call():
    """``observe_window``, ``observe`` and ``forecast`` each log one
    top-level span with its own id; on the CPU no K5 launch is logged."""
    sf = _streaming()
    with profiling.program_trace() as log:
        _request(sf)
    assert [s.name for s in log.spans] == [
        "plcg.stream.observe", "plcg.stream.observe", "plcg.stream.forecast"]
    assert all(s.parent == -1 and s.root == s.id for s in log.spans)
    assert len({s.id for s in log.spans}) == 3 and not log.k5


@pytest.mark.parametrize("step,syncs,sites", [
    ("forecaster", 2, ["finite_check", "loss_value"]),
    ("generator", 2, ["finite_check", "metrics"]),
    ("gan_default", 3, ["finite_check", "finite_check", "metrics"]),
    ("gan_vjp", 3, ["finite_check", "finite_check", "metrics"]),
])
def test_host_syncs_a_step(step, syncs, sites):
    """``host_syncs`` rises by the syncs the step's docstring counts, with
    tracing off and on, and each is a ``plcg.sync.<site>`` span while on."""
    run = {"forecaster": lambda: _forecaster_step(_forecaster_state()),
           "generator": _generator_step(),
           "gan_default": _gan_step("default"),
           "gan_vjp": _gan_step("vjp")}[step]
    before = profiling.counters()["host_syncs"]
    run()
    assert profiling.counters()["host_syncs"] - before == syncs
    with profiling.program_trace() as log:
        run()
    assert [s.name[len("plcg.sync."):] for s in log.spans
            if s.name.startswith("plcg.sync.")] == sites
    (step_span,) = [s for s in log.spans if s.parent == -1]
    assert step_span.name == "plcg.train.step"
    assert step_span.counts["host_syncs"] == syncs


def test_gan_step_spans_two_updates():
    with profiling.program_trace() as log:
        _gan_step("default")()
    names = [s.name[len("plcg."):] for s in log.spans]
    assert names == ["train.step", "train.forward", "train.backward",
                     "sync.finite_check", "train.update", "train.forward",
                     "train.backward", "sync.finite_check", "train.update",
                     "sync.metrics"]


def test_profile_trace_file_holds_the_program_spans(tmp_path):
    """``profile_trace`` on the CPU: the trace file has the ``plcg.*``
    ranges of a step (``record_function`` while a profiler runs), and
    the program's log has the same spans."""
    state = _forecaster_state()
    with profiling.profile_trace(str(tmp_path)):
        _forecaster_step(state)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    want = {profiling.SPAN_PREFIX + n for n in FORECASTER_STEP}
    assert want <= names
    assert {s.name for s in profiling.program_log().spans} == want


def test_profilers_flag_flips():
    """The gate reads ``torch.autograd.profiler._is_profiler_enabled``,
    which ``torch.profiler.profile`` sets and clears, and the ranges are
    torch's ``_RecordFunctionFast``: a torch that drops either fails here
    (or at import) instead of leaving spans off under a profiler."""
    assert profiling._record_range is \
        torch._C._profiler._RecordFunctionFast
    assert autograd_profiler._is_profiler_enabled is False
    assert not profiling.tracing()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert profiling.tracing()
        with profiling.span("inside") as sp:
            pass
    assert autograd_profiler._is_profiler_enabled is False
    assert not profiling.tracing()
    assert sp.name == "plcg.inside" and sp.end_ns >= sp.start_ns > 0
    assert sp in profiling.program_log().spans


def test_profile_clock_is_the_logs():
    """The log stamps on the clock of the profiler's events: a span's
    logged interval lies inside its ``record_function`` range (the span's
    own cost left out), and the ops of the block inside the logged one."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("clock") as sp:
            torch.ones(64).sum()
    events = prof.profiler.kineto_results.events()
    (ev,) = [e for e in events if e.name() == "plcg.clock"]
    ops = [e for e in events if e.name().startswith("aten::")]
    assert ops and ev.start_ns() <= sp.start_ns <= min(
        e.start_ns() for e in ops)
    assert max(e.end_ns() for e in ops) <= sp.end_ns <= ev.end_ns()


def test_program_trace_is_not_reentrant_and_threads_keep_own_parents():
    with profiling.program_trace() as log:
        with pytest.raises(RuntimeError):
            with profiling.program_trace():
                pass
        with profiling.span("outer"):
            done = []

            def other():
                with profiling.span("other"):
                    done.append(True)
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive() and done
    outer, other_span = log.spans
    assert other_span.parent == -1 and other_span.root == other_span.id
    assert not profiling.tracing()


def test_counters_hold_every_counter():
    """Each module that counts declares its keys when it is imported; with
    every owner imported, ``counters()`` holds the program's 18."""
    import importlib
    for owner in ("ops.kernels.convlstm_kernel", "ops.kernels.rollout_kernel",
                  "ops.kernels.st_gates_kernel",
                  "ops.kernels.tap_structure_kernel",
                  "ops.kernels.traj_warp_kernel",
                  "parallel.tp_collectives", "models.loss_graphs"):
        importlib.import_module(f"pl_convlstm_gan_tpu_torch.{owner}")
    got = profiling.counters()
    assert set(got) == {
        "convlstm_cell_fwd.launches", "convlstm_cell_fwd.launches_z",
        "convlstm_cell_fwd.flops", "cell_backward.launches",
        "cell_wgrad.calls", "conv_head_fwd.launches",
        "rollout_persistent_fwd.launches", "rollout_persistent_fwd.flops",
        "tap_loop.launches", "tap_k1152.launches", "st_gates.launches",
        "traj_warp.launches", "gather_h.calls", "copy_in.calls", "loss_graphs.captures",
        "loss_graphs.replays", "loss_graphs.eager", "host_syncs"}
    assert all(isinstance(v, int) for v in got.values())


def _stamps(table, seed=0):
    """Synthetic stamps of a launch of ``table``: rising clocks."""
    gaps = torch.randint(1, 5000, (2 * table.shape[0],),
                         generator=torch.Generator().manual_seed(seed))
    return torch.cat([torch.zeros(1, dtype=torch.int64),
                      torch.cumsum(gaps, 0)]) + 10 ** 18


@pytest.mark.parametrize("n_cells,steps,emit_from,t_in", [
    (3, 30, 0, 1), (3, 1, 0, 1), (2, 7, 2, 3)])
def test_stamp_phases_split_sums_to_the_total(n_cells, steps, emit_from,
                                              t_in):
    table = rollout_schedule(n_cells, steps, emit_from, t_in)
    stamps = _stamps(table)
    got = stamp_phases(stamps, table)
    n = table.shape[0]
    assert got["total_us"] == pytest.approx(
        float(stamps[-1] - stamps[0]) / 1e3)
    assert sum(got["work_us"].values()) + got["barrier_us"] == \
        pytest.approx(got["total_us"])
    assert list(got["phases"]) == [f"cell_{k}" for k in range(n_cells)] + [
        "head"]
    assert sum(got["phases"].values()) == n and got["barriers"] == n - 1
    assert got["phases"]["head"] == steps - emit_from
    s = stamps.tolist()
    assert got["barrier_us"] == pytest.approx(sum(
        s[2 + 2 * p] - s[1 + 2 * p] for p in range(n - 1)) / 1e3)


def test_k5_stamps_logged_and_read_back():
    """While tracing, ``k5_stamps`` hands out a buffer and ``log_k5`` keeps
    it with its schedule; ``k5_phases`` reads each launch back through
    ``stamp_phases``, only within the given times. Off, no buffer."""
    assert profiling.k5_stamps(4, "cpu") is None
    key = (3, 30, 0, 1)
    table = rollout_schedule(*key)
    with profiling.program_trace() as log:
        for seed in range(3):
            buf = profiling.k5_stamps(table.shape[0], "cpu")
            assert buf.dtype == torch.int64 and buf.numel() == 1 + 2 * \
                table.shape[0]
            buf.copy_(_stamps(table, seed))
            profiling.log_k5(buf, key)
    got = log.k5_phases()
    assert [g["total_us"] for g in got] == [
        stamp_phases(_stamps(table, s), table)["total_us"] for s in range(3)]
    assert log.k5_phases(t0_ns=log.k5[-1][0] + 1) == []


@pytest.mark.cuda
def test_span_and_kernel_share_the_profilers_clock():
    """On the card: a span around a ``torch.cuda._sleep`` launch and a
    synchronize, under one ``torch.profiler`` stretch with CUDA activity.
    The sleep kernel's device interval lies within the span's logged host
    interval, to 20 µs at each end; and so do the launch call and the
    synchronize that the profiler records on its own clock, which bound the
    kernel: the log and the trace share one clock at both ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with profiling.span("clock") as sp:
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    # the sleep kernel: the one long device interval of the stretch
    k = max((e for e in events
             if e.device_type() == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.end_ns() - e.start_ns())
    launch = [e for e in events if e.name().startswith("cudaLaunchKernel")
              and e.start_ns() <= k.start_ns()]
    sync = [e for e in events if e.name().endswith("Synchronize")
            and e.end_ns() >= k.end_ns()]
    slack = 20_000
    assert sp.start_ns - slack <= k.start_ns() <= k.end_ns() <= \
        sp.end_ns + slack, (k.start_ns() - sp.start_ns, sp.end_ns - k.end_ns())
    assert launch and sync
    assert sp.start_ns - slack <= launch[-1].start_ns() <= k.start_ns()
    assert k.end_ns() <= sync[0].end_ns() <= sp.end_ns + slack
