"""The training losses replayed as CUDA graphs (``models/loss_graphs.py``),
shared by ``ConvLSTMForecaster`` and ``PredRNN``.

On the CPU: the rule that decides when the graphs engage, on operands that
say they lie on the card (everything but the device is observed for real:
gradient mode, the inputs' ``requires_grad``, a capture under way, a
tensor-parallel model's shards, remat); CPU tensors never capture; the
forecaster's loss on leaves of its own (what the capture runs) equals its
loss on the parameters and sends the gradients to those leaves; the new
counters sit in ``counters()`` and ``add_counts`` raises exactly them.

The tests marked ``cuda`` need the card and skip without one. Four
nowcast-shaped train steps replayed equal four eager ones from the same
state, in bfloat16 and float32, with and without scheduled-sampling draws:
the loss and the predictions within 1e-6 relative (the same kernels on the
same operands; cuDNN may sum in another order), each gradient leaf within
1e-3 of its norm; K1 with z and K6 launch 3 x 24 = 72 times a step, replayed
or not, and the cells' weight gradients are 3 calls, one a cell over its 24
steps; an eager K6 launch after a capture uses no buffer of the graph's
and still equals its plain version. Run there with
``python -m pytest --noconftest -m cuda tests/test_torch_loss_graphs.py``.
"""
import types

import pytest
import torch

from pl_convlstm_gan_tpu_torch.models import loss_graphs as lg
from pl_convlstm_gan_tpu_torch.models.forecaster import ConvLSTMForecaster
from pl_convlstm_gan_tpu_torch.models.predrnn import PredRNN
from pl_convlstm_gan_tpu_torch.ops.kernels import convlstm_kernel as ck
from pl_convlstm_gan_tpu_torch.utils import profiling

GRAPH_KEYS = ("loss_graphs.captures", "loss_graphs.replays",
              "loss_graphs.eager")
CELLS, WIDTH, T_IN, T_OUT = 3, 16, 5, 20
STEPS = T_IN + T_OUT - 1
PER_STEP = CELLS * STEPS                # K1 with z and K6, a train step


def _forecaster(dtype=None, impl="torch", seed=0, **kw):
    torch.manual_seed(seed)
    return ConvLSTMForecaster(hidden_dims=(WIDTH,) * CELLS,
                              input_frames=T_IN, output_frames=T_OUT,
                              dtype=dtype, convlstm_impl=impl, **kw)


def _on_card():
    """Operands that say they lie on the card and need no gradient."""
    return types.SimpleNamespace(is_cuda=True, requires_grad=False)


def _tp_forecaster(monkeypatch):
    """A forecaster built for a model group of 2 ranks (rank 0): its cells
    hold their shards, marked ``tp_sharded``. The group is never used."""
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda g: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda g: 0)
    return _forecaster(tp_group=object())


@pytest.mark.parametrize("case", ["engages", "no_grad", "inputs_need_grad",
                                  "capture_under_way", "tp", "remat",
                                  "cpu", "predrnn"])
def test_engage_rule(monkeypatch, case):
    """The graphs engage with gradients on card operands that need none,
    outside a capture, for a model without shards or remat, of either
    family; every other case runs eagerly."""
    capturing = case == "capture_under_way"
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    model = {"tp": lambda: _tp_forecaster(monkeypatch),
             "remat": lambda: _forecaster(remat=True),
             "predrnn": lambda: PredRNN(hidden_dims=(8, 8), input_frames=3,
                                        output_frames=3, kernel_size=3)
             }.get(case, _forecaster)()
    weights = list(model.parameters())
    x = y = _on_card()
    if case == "inputs_need_grad":
        x = types.SimpleNamespace(is_cuda=True, requires_grad=True)
    if case == "cpu":
        x, y = torch.zeros(1), torch.zeros(1)
    with torch.set_grad_enabled(case != "no_grad"):
        got = lg.engages(model, weights, x, y)
    assert got == (case in ("engages", "predrnn"))


def test_cpu_training_never_captures():
    """On CPU tensors the forecaster's loss runs eagerly at every call,
    keeps no graphs and counts no eager call (the counter counts card
    calls)."""
    model = _forecaster()
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, T_IN, 1, 8, 8, generator=g)
    y = torch.rand(2, T_OUT, 1, 8, 8, generator=g)
    draws = torch.rand(STEPS, 2, generator=g) < 0.5
    before = profiling.counters()
    for _ in range(3):
        model.loss(x, y, draws)[0].backward()
    after = profiling.counters()
    assert model not in lg._GRAPHS
    assert all(after[k] == before[k] for k in GRAPH_KEYS)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_forecaster_loss_on_leaves_equals_loss_on_params(impl):
    """What the capture runs: ``_loss`` on leaves that share the
    parameters' storage gives the eager loss and predictions exactly, and
    its gradients go to those leaves (equal to the parameters' eager
    gradients), none to the parameters."""
    model = _forecaster(impl=impl)
    g = torch.Generator().manual_seed(2)
    x = torch.rand(2, T_IN, 1, 8, 8, generator=g)
    y = torch.rand(2, T_OUT, 1, 8, 8, generator=g)
    draws = torch.rand(STEPS, 2, generator=g) < 0.5
    params = list(model.parameters())
    leaves = [p.detach().requires_grad_() for p in params]
    total, pred = model._loss(x, y, draws, leaves)
    grads = torch.autograd.grad(total, leaves)
    assert all(p.grad is None for p in params)
    want, want_pred = model.loss(x, y, draws)
    want.backward()
    assert torch.equal(total, want) and torch.equal(pred, want_pred)
    for got, p in zip(grads, params):
        assert torch.allclose(got, p.grad, rtol=1e-6, atol=1e-9)


def test_counters_and_add_counts():
    """The graphs' counters are in ``counters()``, and ``add_counts``
    raises exactly the ones it names."""
    before = profiling.counters()
    assert set(GRAPH_KEYS) <= set(before)
    add = {"loss_graphs.captures": 1, "loss_graphs.replays": 3,
           "loss_graphs.eager": 2}
    profiling.add_counts(add)
    after = profiling.counters()
    profiling.add_counts({k: -v for k, v in add.items()})
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == add
    assert profiling.counters() == before


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(card, seed, size=32, b=2):
    g = torch.Generator(device=card).manual_seed(seed)
    return (torch.rand(b, T_IN, 1, size, size, device=card, generator=g),
            torch.rand(b, T_OUT, 1, size, size, device=card, generator=g))


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("draws", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_replayed_steps_equal_eager_ones(card, dtype, draws):
    """Four train steps of a nowcast-shaped forecaster (3 x 16 cells on K1,
    5 -> 20 frames): the first eager, the second captured, then replays,
    each on a new batch (and new draws, made on the host as the trainer
    makes them), each followed by Adam on the graphed model's parameters in
    place. The eager model takes the graphed one's state before each step.
    Loss and predictions within 1e-6, gradients within 1e-3; 72 K1 with z
    and 72 K6 a step, and each cell's weight gradient one call over its 24
    steps (3 calls); one eager call, then a capture and a replay, then
    replays."""
    graphed = _forecaster(dtype, "kernel").to(card)
    eager = _forecaster(dtype, "kernel").to(card)
    opt = torch.optim.Adam(graphed.parameters(), lr=1e-3)
    host = torch.Generator().manual_seed(5)
    want_graphs = [(0, 0, 1), (1, 1, 0), (0, 1, 0), (0, 1, 0)]
    for step in range(4):
        x, y = _batch(card, 10 + step)
        d = (torch.rand(STEPS, 4, generator=host) < 0.5)[:, ::2] \
            if draws else None
        eager.load_state_dict(graphed.state_dict())
        got = []
        for model in (graphed, eager):
            model.zero_grad(set_to_none=True)
            before = profiling.counters()
            total, pred = (model.loss(x, y, d) if model is graphed
                           else model._loss(x, y, d))
            total.backward()
            after = profiling.counters()
            delta = {k: after[k] - before[k] for k in after}
            assert delta["convlstm_cell_fwd.launches_z"] == PER_STEP, step
            assert delta["cell_backward.launches"] == PER_STEP, step
            assert delta["cell_wgrad.calls"] == CELLS, step
            if model is graphed:
                assert tuple(delta[k] for k in GRAPH_KEYS) == \
                    want_graphs[step], step
            got.append((total.detach(), pred.detach(),
                        [p.grad.clone() for p in model.parameters()]))
        (lg_, pg, gg), (le, pe, ge) = got
        assert _rel(lg_, le) <= 1e-6, step
        assert _rel(pg, pe) <= 1e-6, step
        for a, b in zip(gg, ge):
            assert _rel(a, b) <= 1e-3, step
        opt.step()
    assert any(v is not None for v in lg._GRAPHS[graphed].values())


def _k6_operands(card, seed=3):
    b, hgt, wid, cx, ch = 2, 32, 32, WIDTH, WIDTH
    g = torch.Generator(device=card).manual_seed(seed)

    def draw(c, scale=1.0):
        return torch.randn(b, hgt, wid, c, device=card, generator=g) * scale
    return (draw(4 * ch, 2.0), draw(ch), draw(ch), draw(ch, 1e-2),
            draw(ch, 1e-2), draw(cx), draw(ch))


@pytest.mark.cuda
def test_eager_k6_after_a_capture_shares_no_workspace(card):
    """After a capture, an eager K6 launch on the default stream and one on
    the capture's own stream read none of the graph's buffers: each equals
    the launch made before the capture bit for bit and the plain version
    within the K6 tests' float32 bounds; the graph, replayed after them,
    still gives the eager loss."""
    ops = _k6_operands(card)
    before = ck.cell_backward(*ops, torch.float32)
    model = _forecaster(torch.float32, "kernel").to(card)
    x, y = _batch(card, 20)
    for _ in range(2):                  # the warm-up, then the capture
        model.zero_grad(set_to_none=True)
        model.loss(x, y)[0].backward()
    graphs = next(v for v in lg._GRAPHS[model].values() if v is not None)
    kept = {t.data_ptr() for t in graphs.workspace[:2]}
    eager_ws = {t.data_ptr() for key, ws in ck._bwd_workspace.items()
                if not key[2] for t in ws[:2]}
    assert kept and not kept & eager_ws
    side = graphs.stream
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        on_side = ck.cell_backward(*ops, torch.float32)
    torch.cuda.current_stream(card).wait_stream(side)
    after = ck.cell_backward(*ops, torch.float32)
    plain = ck.cell_backward_plain(*ops, torch.float32)
    for got in (on_side, after):
        assert all(torch.equal(a, b) for a, b in zip(got, before))
    for name, a, b in zip(("dz", "dc_prev", "xh"), before[:3], plain[:3]):
        bound = 2.0 ** -20 * (b.abs() + b.abs().max())
        assert bool(((a - b).abs() <= bound).all()), name
    db_bound = 2.0 ** -15 * plain[0].abs().sum(dim=(0, 1, 2))
    assert bool(((before[3] - plain[3]).abs() <= db_bound).all())
    model.zero_grad(set_to_none=True)
    total, _ = model.loss(x, y)
    total.backward()
    want, _ = model._loss(x, y, None)
    assert _rel(total.detach(), want.detach()) <= 1e-6
