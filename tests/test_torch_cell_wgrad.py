"""A kernel cell's weight gradient once a training pass
(``convlstm_kernel.pass_weight``, ``CellWgrad``, ``ConvLSTMCell.for_pass``):
one convolution over all the steps of a pass, in place of one a step.

On the CPU the kernel path runs the plain versions of K1 and K6 under
``ConvLSTMCellFn``, with the same slots and the same one call. A small
nowcast forecaster (2 cells, the first with Cx + Ch = 9 odd, 5 steps, the
frames needing gradients) is held against the per-step path from the same
weights: remat, whose recompute gives each step its own weight gradient,
rounded to the compute dtype, as before the batching. Tolerances:
- the cells' weights: float32 1e-5 relative (the same float32 terms summed
  in another order); bfloat16 2^-7 of the largest magnitude, the parity
  bound of ``tests/test_torch_train_cell.py`` (the per-step path rounds each
  step's gradient to bfloat16, the batched one sums in float32);
- the biases, the head and the frames' gradients: bit for bit (the batching
  changes nothing of their computation);
- the batched call itself: bit for bit the one ``convolution_backward``
  over the per-step dz and concat(x, h) stacked by hand;
- the counter: ``cell_wgrad.calls`` one a cell and pass; one a step under
  remat.

The tests marked ``cuda`` need the card and skip without one: the batched
weight gradients of a nowcast-shaped forecaster equal the per-step ones
(TF32 off; the other leaves are not bit for bit there, see the test), and
at the nowcast_128 widths the batched call runs an implicit-GEMM wgrad
kernel, no FFT. Run there with
``python -m pytest --noconftest -m cuda tests/test_torch_cell_wgrad.py``.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pl_convlstm_gan_tpu_torch.models import layers
from pl_convlstm_gan_tpu_torch.models.forecaster import ConvLSTMForecaster
from pl_convlstm_gan_tpu_torch.models.layers import ConvLSTMCell
from pl_convlstm_gan_tpu_torch.ops.kernels import convlstm_kernel
from pl_convlstm_gan_tpu_torch.utils import profiling

DTYPES = [torch.float32, torch.bfloat16]
CELLS, T_IN, T_OUT = 2, 3, 3
STEPS = T_IN + T_OUT - 1
KEYS = ("cell_wgrad.calls",)
ROOT = Path(__file__).resolve().parents[1]


def _forecaster(dtype, remat=False, widths=(8, 8), t=(T_IN, T_OUT)):
    torch.manual_seed(0)
    return ConvLSTMForecaster(hidden_dims=widths, input_frames=t[0],
                              output_frames=t[1], dtype=dtype,
                              convlstm_impl="kernel", remat=remat)


def _batch(seed=1, b=2, size=8, t=(T_IN, T_OUT), device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand(b, t[0], 1, size, size, generator=g, device=device),
            torch.rand(b, t[1], 1, size, size, generator=g, device=device))


def _grads(model, x, y):
    """(parameter gradients by name, the frames' gradient, counter rises)
    of one loss and backward."""
    x = x.clone().requires_grad_(True)
    before = profiling.counters()
    model._loss(x, y, None)[0].backward()
    after = profiling.counters()
    return ({n: p.grad for n, p in model.named_parameters()}, x.grad,
            {k: after[k] - before[k] for k in KEYS})


def _assert_weight_close(got, want, dtype, name):
    if dtype == torch.float32:
        rel = float((got - want).norm() / want.norm())
        assert rel <= 1e-5, (name, rel)
    else:
        bound = 2.0 ** -7 * float(want.abs().max())
        assert float((got - want).abs().max()) <= bound, name


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_weight_gradients_equal_per_step_ones(dtype):
    """The batched path's cell weight gradients equal the per-step path's
    (remat) to the module's tolerances; every other gradient, the frames'
    included, is the same bit for bit."""
    x, y = _batch()
    got, gx, _ = _grads(_forecaster(dtype), x, y)
    want, wx, _ = _grads(_forecaster(dtype, remat=True), x, y)
    assert torch.equal(gx, wx)
    for name, g in got.items():
        assert g.dtype == torch.float32, name
        if name.startswith("core.cell_") and name.endswith(".weight"):
            _assert_weight_close(g, want[name], dtype, name)
        else:
            assert torch.equal(g, want[name]), name


def test_batched_float32_gradients_match_the_plain_cell():
    """In float32 the batched kernel path's weight gradients equal those of
    the plain cell, differentiated by autograd step by step, to 1e-5
    relative (the same algebra in other orders)."""
    x, y = _batch(seed=3)
    got, _, _ = _grads(_forecaster(torch.float32), x, y)
    plain = _forecaster(torch.float32)
    for cell in plain.core.cells():
        cell.impl = "torch"
    want, _, _ = _grads(plain, x, y)
    for name in got:
        rel = float((got[name] - want[name]).norm() / want[name].norm())
        assert rel <= 1e-5, (name, rel)


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_call_is_one_convolution_over_the_stacked_steps(
        monkeypatch, dtype):
    """Four steps of one cell (Cx + Ch = 11, odd): its weight gradient is,
    bit for bit, aten's ``convolution_backward`` (weight only) over the
    steps' dz, from the gate backward, and their concat(x, h) in float32,
    stacked along the batch in step order by hand."""
    torch.manual_seed(6)
    cell = ConvLSTMCell(3, 8, impl="kernel", dtype=dtype)
    g = torch.Generator().manual_seed(7)
    xs = torch.randn(4, 2, 6, 6, 3, generator=g)
    seen = []
    real = convlstm_kernel.cell_backward_plain

    def spy(z, c, c_next, dh_next, dc_next, x, h, db_dtype):
        out = real(z, c, c_next, dh_next, dc_next, x, h, db_dtype)
        seen.append((out[0].clone(), torch.cat((x, h), -1).float()))
        return out

    monkeypatch.setattr(convlstm_kernel, "cell_backward_plain", spy)
    weights = cell.for_pass(dtype)
    h = c = torch.zeros(2, 6, 6, 8)
    loss = 0
    for t in range(4):
        h, c = cell(xs[t], h, c, weights=weights)
        loss = loss + (h.float() * (t + 1)).sum()
    loss.backward()
    assert len(seen) == 4
    dz, xh = (torch.cat(parts) for parts in zip(*reversed(seen)))
    w32 = cell.weight.detach().to(dtype).float()
    _, want, _ = torch.ops.aten.convolution_backward(
        dz.permute(0, 3, 1, 2), xh.permute(0, 3, 1, 2), w32, None, (1, 1),
        (1, 1), (1, 1), False, (0, 0), 1, (False, True, False))
    assert torch.equal(cell.weight.grad, want)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_counters(dtype, remat):
    """One weight-gradient call a cell covering its 5 steps; under remat
    one call a cell-step. A forward without gradients counts nothing."""
    model = _forecaster(dtype, remat=remat)
    x, y = _batch()
    _, _, counts = _grads(model, x, y)
    want_calls = CELLS * STEPS if remat else CELLS
    assert counts == {"cell_wgrad.calls": want_calls}
    before = profiling.counters()
    with torch.no_grad():
        model(x)
    assert all(profiling.counters()[k] == before[k] for k in KEYS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_cast_weight_for_every_step(monkeypatch, dtype):
    """With gradients every step of a kernel cell reads the one weight its
    pass cast, with the pass's ``CellWgrad``; under ``no_grad`` and remat
    each step casts its own and none is handed down."""
    model = _forecaster(dtype)
    x, _ = _batch()
    seen = []
    real_step = layers.convlstm_step

    def spy_step(x, h, c, weight, bias, **kw):
        seen.append((weight, kw["wgrad"]))
        return real_step(x, h, c, weight, bias, **kw)

    monkeypatch.setattr(layers, "convlstm_step", spy_step)
    model(x)
    assert len(seen) == CELLS * STEPS
    for li in range(CELLS):
        mine = seen[li::CELLS]
        assert all(w is mine[0][0] and g is mine[0][1] for w, g in mine)
        assert mine[0][1] is not None and mine[0][0].dtype == dtype
    assert seen[0][0] is not seen[1][0]
    seen.clear()
    with torch.no_grad():
        model(x)
    model.remat = True
    model(x)
    assert len(seen) == 2 * CELLS * STEPS
    assert all(g is None for _, g in seen)
    if dtype == torch.bfloat16:
        assert len({id(w) for w, _ in seen}) == len(seen)


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_step_the_loss_does_not_reach_counts_zero(dtype):
    """Three steps of one cell, the loss on the second step's h alone: the
    third step's backward never runs, its slot adds nothing, and the
    weight gradient equals the per-step path's: one call, or one for each
    of the two steps that ran."""
    torch.manual_seed(4)
    cell = ConvLSTMCell(3, 8, impl="kernel", dtype=dtype)
    g = torch.Generator().manual_seed(5)
    xs = torch.randn(3, 2, 6, 6, 3, generator=g)
    grads, counts = [], []
    for remat in (False, True):
        cell.weight.grad = None
        weights = cell.for_pass(dtype, remat)
        h = c = torch.zeros(2, 6, 6, 8)
        hs = []
        before = profiling.counters()
        for t in range(3):
            h, c = cell(xs[t], h, c, weights=weights)
            hs.append(h)
        (hs[1].float() ** 2).sum().backward()
        after = profiling.counters()
        grads.append(cell.weight.grad.clone())
        counts.append({k: after[k] - before[k] for k in KEYS})
    _assert_weight_close(grads[0], grads[1], dtype, "weight")
    assert counts == [{"cell_wgrad.calls": 1}, {"cell_wgrad.calls": 2}]


def test_retained_graph_runs_its_backward_twice():
    """A pass whose graph is kept computes its weight gradient again on a
    second backward (the slots are made anew): twice the first."""
    model = _forecaster(torch.float32)
    x, y = _batch()
    total = model._loss(x, y, None)[0]
    total.backward(retain_graph=True)
    first = {n: p.grad.clone() for n, p in model.named_parameters()}
    before = profiling.counters()
    total.backward()
    after = profiling.counters()
    for n, p in model.named_parameters():
        assert torch.allclose(p.grad, 2 * first[n], rtol=1e-6, atol=0), n
    assert {k: after[k] - before[k] for k in KEYS} == {
        "cell_wgrad.calls": CELLS}


def test_steps_of_one_pass_share_a_shape():
    """A pass's slots are one buffer: a step of another shape is refused."""
    cell = ConvLSTMCell(3, 8, impl="kernel")
    weights = cell.for_pass(torch.float32)
    h = c = torch.zeros(2, 6, 6, 8)
    cell(torch.zeros(2, 6, 6, 3), h, c, weights=weights)
    with pytest.raises(ValueError, match="share a shape"):
        cell(torch.zeros(1, 6, 6, 3), h[:1], c[:1], weights=weights)


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    keep = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = keep


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_batched_weight_gradients_equal_per_step_ones(card, no_tf32,
                                                           dtype):
    """A nowcast-shaped forecaster (3 x 16 cells on K1 and K6, 5 -> 20
    frames, B 2, 32^2) on the card: the batched path's gradients against
    remat's per-step ones; one call a cell covering its 24 steps, and one a
    cell-step under remat. The cells' weights to the module's tolerances;
    the other leaves within 1e-6 in float32 and, in bfloat16, within 1e-3,
    the bound ``tests/test_torch_loss_graphs.py`` holds a replayed step's
    gradients to: there cuDNN's float32 dgrad is not the same bit for bit
    from run to run, and where its sum lands on the other side of a
    bfloat16 rounding point dh' moves by an ulp (two runs of one path read
    up to 1.1e-5 apart on a bias, 9e-4 on the frames, on an H100)."""
    t = (5, 20)
    x, y = _batch(seed=7, size=32, t=t, device=card)
    got = _grads(_forecaster(dtype, widths=(16,) * 3, t=t).to(card), x, y)
    want = _grads(_forecaster(dtype, True, (16,) * 3, t).to(card), x, y)
    assert got[2] == {"cell_wgrad.calls": 3}
    assert want[2] == {"cell_wgrad.calls": 72}
    for name, g in got[0].items():
        if name.startswith("core.cell_") and name.endswith(".weight"):
            _assert_weight_close(g, want[0][name], dtype, name)
        else:
            rel = float((g - want[0][name]).norm() / want[0][name].norm())
            assert rel <= (1e-6 if dtype == torch.float32 else 1e-3), \
                (name, rel)


def _backward_kernels():
    """(the kernel names of each batched weight-gradient call, every device
    kernel's name) of one profiled eager backward on the card at the
    nowcast_128 widths (3 x 64, B 4, 128^2, 5 -> 20, bfloat16, TF32 as
    found), after a backward that warms every algorithm."""
    from torch.profiler import ProfilerActivity, profile
    t = (5, 20)
    card = torch.device("cuda")
    model = _forecaster(torch.bfloat16, widths=(64,) * 3, t=t).to(card)
    x, y = _batch(seed=9, b=4, size=128, t=t, device=card)
    model._loss(x, y, None)[0].backward()
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        model._loss(x, y, None)[0].backward()
        torch.cuda.synchronize()

    def kernels(ev):
        return [k.name for k in ev.kernels] + [
            n for child in ev.cpu_children for n in kernels(child)]
    batched = [kernels(ev) for ev in prof.events()
               if ev.name == "aten::convolution_backward"
               and ev.input_shapes and ev.input_shapes[0]
               and ev.input_shapes[0][0] == 4 * 24]
    every = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    return batched, every


@pytest.mark.cuda
def test_card_batched_wgrad_is_no_fft(card):
    """At the nowcast_128 widths each cell's one weight-gradient call runs
    cuDNN's implicit-GEMM wgrad, no FFT algorithm, and no kernel of the
    backward is an FFT (``_backward_kernels``). The profile runs in a child
    process: run in the test process, it left a later ``torch.profiler``
    stretch there without device events (``tests/test_torch_tracing.py``'s
    clock test failed in 2 of 3 runs of the card's test files on an
    H100)."""
    code = ("import json, sys; sys.path.insert(0, 'tests'); "
            "import test_torch_cell_wgrad as t; "
            "print(json.dumps(t._backward_kernels()))")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    batched, every = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(batched) == 3
    for names in batched:
        assert any("wgrad" in n for n in names), names
    assert not [n for n in every if "fft" in n.lower()]
