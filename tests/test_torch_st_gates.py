"""K7, the ST-LSTM cell's gate passes (``csrc/st_lstm_gates.cu``), their
wrappers and their plain versions (``ops/kernels/st_gates_kernel.py``).

On the CPU: the plain passes against the cell's equations written out in
float64 (thuml's ``SpatioTemporalLSTMCell_v2`` arithmetic; float32 against
float64 within 2e-6 of the largest magnitude: a handful of float32 roundings
of values below ~10); the plain backward passes against autograd through
the plain forward (the same float32 algebra differentiated by ATen, within
1e-5 of each output's largest magnitude: sums of a few float32 roundings
taken in other orders); an absent gradient read as zero; the wrappers run
the plain versions on CPU tensors and count no launch; the wrappers'
refusals, also on meta tensors, which reach every rule the card applies
before a launch (a tensor off the CPU reaches K7 or raises).

The tests marked ``cuda`` need the card and skip without one. They compare
K7 with the plain version run on the same CUDA tensors: both do the same
float32 operations in the same order (K7 keeps nvcc from fusing a*b+c), and
may differ only where expf / tanhf of the two builds differ by an ulp,
which the following operations carry at most a few ulps further: 2^-18 of
the largest magnitude in float32; in bfloat16 one bf16 ulp (2^-7 relative),
since values a float32 ulp apart may round apart. Run there with
``python -m pytest --noconftest -m cuda tests/test_torch_st_gates.py``."""
import pytest
import torch

from pl_convlstm_gan_tpu_torch.ops.kernels import st_gates_kernel as k7
from pl_convlstm_gan_tpu_torch.ops.kernels.st_gates_kernel import (
    STGatesA, STGatesB, st_gates, st_gates_bwd, st_gates_bwd_plain,
    st_gates_fwd, st_gates_plain, st_hidden, st_hidden_bwd,
    st_hidden_bwd_plain, st_hidden_plain)
from pl_convlstm_gan_tpu_torch.utils.profiling import counters

F64_TOL = 2e-6
GRAD_TOL = 1e-5
F32_ULPS = 2.0 ** -18
BF16_ULP = 2.0 ** -7


def _k7_launches() -> int:
    return counters()["st_gates.launches"]


def _operands(p, fw, dtype=torch.float32, device="cpu", seed=0):
    """x_cat, h_cat, m_cat ~ 2 N(0, 1) (gates from saturated to linear), c,
    m ~ N(0, 1), as [2, p // 2, 1, C]."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(width, scale):
        return (torch.randn((2, p // 2, 1, width), generator=g, device=device)
                * scale).to(dtype)
    return (draw(7 * fw, 2.0), draw(4 * fw, 2.0), draw(3 * fw, 2.0),
            draw(fw, 1.0), draw(fw, 1.0))


def _grads(ops, dtype=torch.float32, device="cpu", seed=1):
    """Gradients of mem, c', m', dc, dm (dtype) and oxh (float32)."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = ops[3]

    def draw(shape, dt):
        return torch.randn(shape, generator=g, device=device).to(dt)
    wide = c.shape[:-1] + (2 * c.shape[-1],)
    return (draw(wide, dtype), draw(c.shape, dtype), draw(c.shape, dtype),
            draw(c.shape, dtype), draw(c.shape, dtype),
            draw(c.shape, torch.float32))


def _equations(xc, hc, mc, c, m):
    """The cell's gate algebra in float64, thuml's order of terms."""
    fw = c.shape[-1]
    i_x, f_x, g_x, i_xp, f_xp, g_xp, o_x = xc.double().split(fw, -1)
    i_h, f_h, g_h, o_h = hc.double().split(fw, -1)
    i_m, f_m, g_m = mc.double().split(fw, -1)
    i_t = torch.sigmoid(i_x + i_h)
    f_t = torch.sigmoid(f_x + f_h + 1.0)
    g_t = torch.tanh(g_x + g_h)
    delta_c = i_t * g_t
    c_new = f_t * c.double() + delta_c
    i_tp = torch.sigmoid(i_xp + i_m)
    f_tp = torch.sigmoid(f_xp + f_m + 1.0)
    g_tp = torch.tanh(g_xp + g_m)
    delta_m = i_tp * g_tp
    m_new = f_tp * m.double() + delta_m
    return (torch.cat([c_new, m_new], -1), c_new, m_new, delta_c, delta_m,
            o_x + o_h)


def _close(got, want, tol):
    want = want.double()
    err = float((got.double() - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1e-30), err


@pytest.mark.parametrize("fw", [8, 5])
def test_pass_a_plain_is_the_equations(fw):
    ops = _operands(12, fw)
    got = st_gates_plain(*ops)
    assert got[5].dtype == torch.float32
    for g, w in zip(got, _equations(*ops)):
        _close(g, w, F64_TOL)


def test_pass_b_plain_is_the_equations():
    oxh, om, last = (torch.randn(3, 4, 8, generator=torch.Generator()
                                 .manual_seed(s)) * 2 for s in (0, 1, 2))
    want = torch.sigmoid(oxh.double() + om.double()) * torch.tanh(
        last.double())
    _close(st_hidden_plain(oxh, om, last), want, F64_TOL)


@pytest.mark.parametrize("absent", [(), (0,), (1, 4), (0, 1, 2, 3, 4, 5)])
def test_pass_a_backward_is_autograds(absent):
    """The explicit backward against autograd through the plain forward,
    with the gradients in ``absent`` left out (None), as autograd leaves
    those of unused outputs."""
    ops = [t.requires_grad_(True) for t in _operands(12, 8)]
    grads = list(_grads(ops))
    for i in absent:
        grads[i] = None
    outs = st_gates_plain(*ops)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    if pairs:
        want = torch.autograd.grad([o for o, _ in pairs],
                                   ops, [g for _, g in pairs])
    else:
        want = [torch.zeros_like(t) for t in ops]
    got = st_gates_bwd_plain(*[t.detach() for t in ops], *grads)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


def test_pass_b_backward_is_autograds():
    gen = torch.Generator().manual_seed(3)
    oxh, om, last, gh = (torch.randn(3, 4, 8, generator=gen) * 2
                         for _ in range(4))
    leaves = [t.requires_grad_(True) for t in (oxh, om, last)]
    want = torch.autograd.grad(st_hidden_plain(*leaves), leaves, gh)
    got = st_hidden_bwd_plain(gh, oxh.detach(), om.detach(), last.detach())
    assert got[0].dtype == torch.float32
    _close(got[0], want[0], GRAD_TOL)
    _close(got[1], want[1], GRAD_TOL)
    _close(got[2], want[2], GRAD_TOL)


def test_bf16_rounds_once():
    """In bfloat16 the plain passes compute in float32 and round each
    output once: the float32 results of the bf16 operands, rounded."""
    ops = _operands(12, 8, torch.bfloat16)
    got = st_gates_plain(*ops)
    want = st_gates_plain(*[t.float() for t in ops])
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))
    assert torch.equal(got[5], want[5])


def test_functions_on_cpu_launch_nothing():
    """STGatesA and STGatesB on CPU tensors: the plain versions forward and
    backward, gradients as autograd's through the plain forward, no K7
    launch counted; under no_grad the deltas are left out."""
    before = _k7_launches()
    ops = [t.requires_grad_(True) for t in _operands(12, 8)]
    grads = _grads(ops)
    outs = STGatesA.apply(*ops)
    got = torch.autograd.grad(outs, ops, grads)
    want = torch.autograd.grad(st_gates_plain(*ops), ops, grads)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)
    oxh = outs[5].detach().requires_grad_(True)
    om = torch.randn_like(oxh).requires_grad_(True)
    last = torch.randn_like(oxh).requires_grad_(True)
    h = STGatesB.apply(oxh, om, last)
    gh = torch.randn_like(h)
    got = torch.autograd.grad(h, (oxh, om, last), gh)
    want = torch.autograd.grad(st_hidden_plain(oxh, om, last),
                               (oxh, om, last), gh)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)
    with torch.no_grad():
        plain = st_gates(*ops, deltas=False)
        assert plain[3] is None and plain[4] is None
        assert torch.equal(plain[0], outs[0])
        assert torch.equal(st_hidden(oxh, om, last), h)
    assert _k7_launches() == before


def test_backward_skips_unneeded_state_grads():
    ops = _operands(12, 8)
    out = st_gates_bwd(*ops, *_grads(ops), need_c=False, need_m=True)
    assert out[3] is None and out[4] is not None
    out = st_gates_bwd(*ops, need_c=True, need_m=False)
    assert out[3] is not None and out[4] is None
    assert not bool(out[0][..., :6 * 8].any())


def test_wrappers_refuse_wrong_shapes():
    xc, hc, mc, c, m = _operands(12, 8)
    with pytest.raises(ValueError, match="h_cat"):
        st_gates_fwd(xc, hc[..., :-1], mc, c, m)
    with pytest.raises(ValueError, match="m_cat"):
        st_gates_bwd(xc, hc, mc[..., :8], c, m)


def _meta(*tensors):
    return [t.to("meta") for t in tensors]


@pytest.mark.parametrize("case", ["float16", "mixed", "f32_oxh", "strided",
                                  "meta"])
def test_meta_tensors_reach_every_rule(case):
    """Tensors off the CPU go to K7's checks, never to a plain fallback:
    a dtype K7 does not take, operands of two dtypes, an oxh not in float32,
    a non-contiguous backward operand, a device that is not CUDA."""
    before = _k7_launches()
    xc, hc, mc, c, m = _operands(12, 8)
    if case == "float16":
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            st_gates_fwd(*_meta(*(t.half() for t in (xc, hc, mc, c, m))))
    elif case == "mixed":
        with pytest.raises(ValueError, match="must be"):
            st_gates_fwd(*_meta(xc, hc.bfloat16(), mc, c, m))
    elif case == "f32_oxh":
        oxh = torch.zeros(2, 6, 1, 8, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="oxh"):
            k7.st_hidden_fwd(*_meta(oxh, oxh, oxh))
    elif case == "strided":
        wide = torch.zeros(2, 6, 1, 16, device="meta")
        c = c.to("meta")
        with pytest.raises(ValueError, match="contiguous"):
            st_hidden_bwd(c, wide[..., :8], c, c)
    else:
        with pytest.raises(ValueError, match="one CUDA device"):
            st_gates_fwd(*_meta(xc, hc, mc, c, m))
    assert _k7_launches() == before


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_close(what, got, want):
    """K7's output against the plain version's on the card (module
    docstring's bounds)."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    w = want.float()
    err = (got.float() - w).abs()
    bound = F32_ULPS * w.abs().max()
    if want.dtype == torch.bfloat16:
        bound = bound + BF16_ULP * w.abs()
    assert bool((err <= bound).all()), (what, float(err.max()))


CARD_SHAPES = {
    # PredRNN-V2 at the KTH widths: B 8, 32 x 32 patched pixels, F 128
    "kth_bf16": (8 * 32 * 32, 128, torch.bfloat16),
    "kth_f32": (8 * 32 * 32, 128, torch.float32),
    # F not a multiple of 8: the scalar variant
    "scalar_bf16": (2 * 13 * 21, 12, torch.bfloat16),
    "scalar_f32": (2 * 13 * 21, 20, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_k7_matches_plain(card, name):
    p, fw, dtype = CARD_SHAPES[name]
    ops = _operands(p, fw, dtype, device="cuda", seed=5)
    grads = _grads(ops, dtype, device="cuda", seed=6)
    before = _k7_launches()
    got = st_gates_fwd(*ops)
    for i, (g, w) in enumerate(zip(got, st_gates_plain(*ops))):
        _card_close(f"pass A output {i}", g, w)
    got = st_gates_bwd(*ops, *grads)
    for i, (g, w) in enumerate(zip(got, st_gates_bwd_plain(*ops, *grads))):
        _card_close(f"pass A gradient {i}", g, w)
    got = st_gates_bwd(*ops, None, grads[1], None, None, grads[4], None,
                       need_c=False)
    want = st_gates_bwd_plain(*ops, None, grads[1], None, None, grads[4])
    assert got[3] is None
    for i in (0, 1, 2, 4):
        _card_close(f"pass A gradient {i}, some absent", got[i], want[i])
    oxh = st_gates_plain(*ops)[5]
    om, last, gh = ops[3], ops[4], grads[1]
    _card_close("pass B", k7.st_hidden_fwd(oxh, om, last),
                st_hidden_plain(oxh, om, last))
    for i, (g, w) in enumerate(zip(st_hidden_bwd(gh, oxh, om, last),
                                   st_hidden_bwd_plain(gh, oxh, om, last))):
        _card_close(f"pass B gradient {i}", g, w)
    assert _k7_launches() - before == 5


@pytest.mark.cuda
def test_predrnn_step_on_k7(card):
    """A PredRNN forward and backward on the card launches K7 four times a
    cell-step (passes A and B, forward and backward): 4 x 76 at 4 layers x
    19 steps, and gives finite gradients."""
    from pl_convlstm_gan_tpu_torch.models.predrnn import PredRNN
    torch.manual_seed(0)
    model = PredRNN(hidden_dims=(16,) * 4, input_frames=10, output_frames=10,
                    kernel_size=5, patch_size=4).to(card)
    frames = torch.rand(2, 20, 1, 32, 32, device=card)
    mask = torch.rand(18, 2, device=card) < 0.5
    before = _k7_launches()
    loss, _ = model.loss(frames[:, :10], frames[:, 10:], mask)
    loss.backward()
    assert _k7_launches() - before == 4 * 76
    assert all(bool(p.grad.isfinite().all()) for p in model.parameters())


def _graph_model(card, seed=0):
    from pl_convlstm_gan_tpu_torch.models.predrnn import PredRNN
    torch.manual_seed(seed)
    return PredRNN(hidden_dims=(16,) * 4, input_frames=10, output_frames=10,
                   kernel_size=5, patch_size=4,
                   dtype=torch.bfloat16).to(card)


@pytest.mark.cuda
def test_predrnn_replayed_steps_equal_eager_ones(card):
    """From the second call at a shape on, ``PredRNN.loss`` with gradients
    replays captured CUDA graphs: on four batches in turn (new frames and
    masks each) its loss and gradients equal those of the eager
    ``_loss`` on a copy of the model, each step counts 4 x 76 K7 launches,
    and the graphs exist from the second step on."""
    from pl_convlstm_gan_tpu_torch.models import loss_graphs
    graphed, eager = _graph_model(card), _graph_model(card)
    g = torch.Generator(device=card).manual_seed(7)
    for step in range(4):
        frames = torch.rand(2, 20, 1, 32, 32, device=card, generator=g)
        mask = torch.rand(18, 2, device=card, generator=g) < 0.5
        got = []
        for model, fn in ((graphed, graphed.loss), (eager, eager._loss)):
            model.zero_grad(set_to_none=True)
            before = _k7_launches()
            loss, pred = fn(frames[:, :10], frames[:, 10:], mask)
            loss.backward()
            assert _k7_launches() - before == 4 * 76, (step, model)
            got.append((loss.detach(), pred,
                        [p.grad.clone() for p in model.parameters()]))
        (lg, pg, gg), (le, pe, ge) = got
        assert float((pg - pe).norm() / pe.norm()) <= 1e-6, step
        assert float((lg - le).abs() / le.abs()) <= 1e-6, step
        for a, b in zip(gg, ge):
            assert float((a - b).norm() / b.norm()) <= 1e-3, step
        graphs = loss_graphs._GRAPHS[graphed]
        assert any(v is not None for v in graphs.values()) == (step >= 1)


@pytest.mark.cuda
def test_predrnn_second_forward_before_backward_runs_eagerly(card):
    """A replayed forward whose backward has not run yet keeps its graphs:
    a second forward meanwhile runs eagerly, and both backwards give the
    eager gradients of their own batch."""
    model, eager = _graph_model(card), _graph_model(card)
    g = torch.Generator(device=card).manual_seed(9)
    batches = [(torch.rand(2, 20, 1, 32, 32, device=card, generator=g),
                torch.rand(18, 2, device=card, generator=g) < 0.5)
               for _ in range(3)]
    for frames, mask in batches[:2]:            # warm-up, then the capture
        model.loss(frames[:, :10], frames[:, 10:], mask)[0].backward()
    frames, mask = batches[2]
    model.zero_grad(set_to_none=True)
    first, _ = model.loss(frames[:, :10], frames[:, 10:], mask)
    second, _ = model.loss(frames[:, :10], frames[:, 10:], mask)
    (first + second).backward()
    eager.load_state_dict(model.state_dict())
    twice, _ = eager._loss(frames[:, :10], frames[:, 10:], mask)
    (2 * twice).backward()
    for a, b in zip(model.parameters(), eager.parameters()):
        assert float((a.grad - b.grad).norm() / b.grad.norm()) <= 1e-3
