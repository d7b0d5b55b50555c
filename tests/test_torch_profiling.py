"""The port's profiling helpers (``utils/profiling.py``) on the CPU: the JAX
package's ``tests/test_utils.py`` cases of ``Timer``, ``benchmark_fn`` and
``benchmark_chained``; ``compiled_cost`` of a plain forecaster train step
against the analytic count of its convs; ``debug.log_compiled_cost`` in
both trainers; ``profile_trace``'s trace file. On the card, ``chip_smoke.py``
(profiling) holds the kernel path's count (K1's ``flops`` counter) against
the plain path's."""
import glob
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pl_convlstm_gan_tpu_torch.config import load_config
from pl_convlstm_gan_tpu_torch.models import ConvLSTMForecaster
from pl_convlstm_gan_tpu_torch.train import SequenceTrainer, Trainer
from pl_convlstm_gan_tpu_torch.train.steps import (TrainState,
                                                   forecaster_train_step,
                                                   make_optimizer)
from pl_convlstm_gan_tpu_torch.utils import (Timer, benchmark_chained,
                                             benchmark_fn)
from pl_convlstm_gan_tpu_torch.utils.profiling import (compiled_cost,
                                                       cost_line, counters,
                                                       log_compiled_cost,
                                                       profile_trace)


def test_benchmark_fn_returns_stats():
    stats = benchmark_fn(lambda x: x * 2 + 1, torch.ones((8, 8)), warmup=1,
                         iters=3)
    assert set(stats) == {"p50", "mean", "min"}
    assert stats["min"] <= stats["p50"] >= 0


def test_timer_accumulates():
    t = Timer()
    assert np.isnan(t.p50)
    with t.measure():
        _ = sum(range(1000))
    # the holder lets the block register its own output for the sync
    with t.measure() as m:
        m["block_on"] = (torch.ones(4) * 2, {"x": [torch.zeros(2)]})
    assert len(t.times) == 2
    assert t.p50 == t.median >= 0


def test_benchmark_chained():
    """chain * iters dependent steps after the warm-up, one fetch a
    chain; returns the final state."""
    res = benchmark_chained(lambda s: s + 1.0, torch.zeros(()), fetch=float,
                            chain=3, iters=2, warmup=1)
    assert res["p50"] > 0 and res["min"] <= res["mean"]
    assert float(res["state"]) == 7.0   # 1 warm-up + 2 * 3 chained


def _conv(b, size, cin, cout, k=3):
    return 2 * b * size * size * k * k * cin * cout


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_compiled_cost_of_a_train_step_is_its_convs(impl):
    """compiled_cost runs the step once and counts its convs: forward, the
    weight gradient of every conv, and the input gradient wherever the
    input needs one (not cell 0 at step 0, whose frame and zero state need
    none), 2*B*H*W*K^2*Cin*Cout each; the kernel path's cells on CPU
    tensors (K1's plain version, ConvLSTMCellFn's backward) count the
    same. Without CUDA there is no peak."""
    b, size, t_in, t_out, hidden = 2, 16, 2, 3, (8, 12)
    torch.manual_seed(0)
    model = ConvLSTMForecaster(hidden, t_in, t_out, convlstm_impl=impl)
    state = TrainState(model, make_optimizer(model))
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.random((b, t_in, 1, size, size),
                                         dtype=np.float32)),
             torch.from_numpy(rng.random((b, t_out, 1, size, size),
                                         dtype=np.float32)))
    k1_before = counters()["convlstm_cell_fwd.flops"]
    cost = compiled_cost(forecaster_train_step, state, batch, 1e-3)
    assert counters()["convlstm_cell_fwd.flops"] == k1_before   # no launch
    steps = t_in + t_out - 1
    cells = [_conv(b, size, 1 + hidden[0], 4 * hidden[0]),
             _conv(b, size, hidden[0] + hidden[1], 4 * hidden[1])]
    head = _conv(b, size, hidden[1], 1)
    forward = steps * sum(cells) + t_out * head
    input_grads = (steps - 1) * cells[0] + steps * cells[1] + t_out * head
    assert cost["flops"] == 2 * forward + input_grads
    assert cost["peak_bytes"] is None
    assert set(cost["out"]) == {"total", "skipped"} and state.step == 1
    assert "GFLOP" in cost_line("x", cost) and "not measured" in \
        cost_line("x", cost)


def test_log_compiled_cost_never_raises_and_returns_the_call(capsys,
                                                             monkeypatch):
    out, cost = log_compiled_cost("conv", F.conv2d, torch.ones(1, 2, 4, 4),
                                  torch.ones(3, 2, 3, 3), padding=1)
    assert out.shape == (1, 3, 4, 4) and cost["flops"] == _conv(1, 4, 2, 3)
    assert capsys.readouterr().out.startswith("[cost] conv: 0.000")

    import torch.utils.flop_counter as fc

    class Broken:
        def __init__(self, *a, **k):
            raise RuntimeError("no counter")
    monkeypatch.setattr(fc, "FlopCounterMode", Broken)
    out, cost = log_compiled_cost("conv", lambda: 5)
    assert (out, cost) == (5, None)
    assert "cost model unavailable (no counter)" in capsys.readouterr().out
    with pytest.raises(ZeroDivisionError):      # fn's own error propagates
        log_compiled_cost("conv", lambda: 1 / 0)


def _seq_config(out_dir, cost):
    cfg = load_config("ci_smoke_seq")
    cfg.output.output_dir = str(out_dir)
    cfg.training.epochs = 1
    cfg.debug.log_compiled_cost = cost
    return cfg


def _gen_config(out_dir, cost):
    cfg = load_config("ci_smoke")
    cfg.output.output_dir = str(out_dir)
    cfg.training.epochs = 1
    cfg.debug.log_compiled_cost = cost
    return cfg


@pytest.mark.parametrize("trainer,config,label", [
    (SequenceTrainer, _seq_config, "forecaster train step"),
    (Trainer, _gen_config, "generator train step"),
])
def test_trainers_log_compiled_cost(tmp_path, capsys, trainer, config,
                                    label):
    """debug.log_compiled_cost: one [cost] line from the first step of the
    run, which is the run's own step (the history equals a run without
    the flag)."""
    h_cost = trainer(config=config(tmp_path / "a", True), device="cpu").train()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[cost]")]
    assert len(lines) == 1 and lines[0].startswith(f"[cost] {label}: ")
    assert float(lines[0].split(": ")[1].split()[0]) > 0
    h_plain = trainer(config=config(tmp_path / "b", False),
                      device="cpu").train()
    assert "[cost]" not in capsys.readouterr().out
    assert h_cost == h_plain


def test_profile_trace_writes_a_trace(tmp_path):
    """A Chrome / Perfetto trace of the block lands in logdir."""
    x = torch.randn(2, 3, 16, 16)
    w = torch.randn(4, 3, 3, 3)
    with profile_trace(str(tmp_path / "trace")) as prof:
        F.conv2d(x, w, padding=1)
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::conv2d" in names
    assert any(ev.key == "aten::conv2d" for ev in prof.key_averages())
