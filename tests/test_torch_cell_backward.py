"""K6, the ConvLSTM cell's gate backward (``csrc/cell_backward.cu``), its
wrapper ``cell_backward`` and its plain version ``cell_backward_plain``.

On the CPU: the plain version (the eager sequence ``ConvLSTMCellFn``'s
backward ran before K6) against the JAX package's ``_bwd``, whose algebra
it is, to the card tests' float32 tolerances below (dz, dc_prev, db; JAX's
sigmoid and tanh are not torch's, so they may differ by ulps); the wrapper
runs it on CPU tensors and counts no launch; the wrapper's refusals (shapes,
one dtype, one CUDA device), also on meta tensors, which reach every rule
the card applies before a launch. The JAX-grad tests of ``ConvLSTMCellFn``
are in tests/test_torch_train_cell.py.

The tests marked ``cuda`` need the card and skip without one. They compare
K6 with ``cell_backward_plain`` run on the same CUDA tensors (ATen's
kernels: the pre-K6 backward's ops), at the shapes the main paths use:
- dz (and dc_prev in float32) to float32 ulps: both do the same float32
  operations in the same order (K6 keeps nvcc from fusing a*b+c), and may
  differ only where expf / tanhf of the two builds differ by an ulp; where
  dc' + dh'·o·(1-tc²) cancels, such an ulp is one of the terms', so the
  bound is 2^-20 relative plus 2^-20 of the largest magnitude;
- dc_prev in bfloat16 to one bf16 ulp (2^-7 relative): both round a
  float32 value once, and values an ulp apart in float32 may straddle a
  rounding point;
- xh exactly (a widening copy);
- db per channel to 2^-15 of the sum of |dz| over the pixels: both sum the
  same float32 terms in other orders (K6's longest chain of additions is
  ~110, ATen's tree is shorter; 2^-15 is ~256 float32 ulps of that sum),
  plus one bf16 ulp where db is rounded to bfloat16.
Run there with
``python -m pytest --noconftest -m cuda tests/test_torch_cell_backward.py``
(the card's tests import no JAX)."""
import numpy as np
import pytest
import torch

from pl_convlstm_gan_tpu_torch.config import load_config
from pl_convlstm_gan_tpu_torch.ops.kernels import convlstm_kernel as kmod
from pl_convlstm_gan_tpu_torch.ops.kernels.convlstm_kernel import (
    ConvLSTMCellFn, cell_backward, cell_backward_plain)
from pl_convlstm_gan_tpu_torch.utils import profiling

NAMES = ("z", "c", "c_next", "dh_next", "dc_next", "x", "h")
F32_ULPS = 2.0 ** -20
BF16_ULP = 2.0 ** -7
DB_SUM = 2.0 ** -15


def _operands(b, hgt, wid, cx, ch, dtype, device="cpu", seed=0):
    """z, c, c', dh', dc', x, h as the forward leaves them: z ~ 2 N(0, 1)
    (gates from saturated to linear), states ~ N(0, 1), gradients ~ N(0,
    1e-2)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(
            dtype)
    return (draw(b, hgt, wid, 4 * ch, scale=2.0), draw(b, hgt, wid, ch),
            draw(b, hgt, wid, ch), draw(b, hgt, wid, ch, scale=1e-2),
            draw(b, hgt, wid, ch, scale=1e-2), draw(b, hgt, wid, cx),
            draw(b, hgt, wid, ch))


def _jax_bwd(z, c, c_next, dh_next, dc_next, x, h):
    """dz, dc_prev and db (float32 bias) of the JAX package's ``_bwd`` on
    the same operands. ``_bwd`` returns no dz; with Cx + Ch = 4Ch and a 1x1
    weight that embeds 4Ch in Cx + Ch as the identity, its input gradient
    dxh = dz . W^T is dz itself (each element one product by 1 plus zeros,
    exact in float32), read from dx and dh_prev, which stay float32 when x
    and h are float32."""
    import jax.numpy as jnp
    from pl_convlstm_gan_tpu.ops.pallas.convlstm_kernel import _bwd
    cx, ch = x.shape[-1], c.shape[-1]
    assert cx + ch == 4 * ch and x.dtype == h.dtype == torch.float32
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.dtype(
        str(t.dtype).split(".")[-1]))
    eye = np.eye(4 * ch, dtype=np.float32)[None, None]
    res = (jnp.asarray(eye), jnp.zeros(4 * ch, jnp.float32), j(x), j(h),
           j(c), j(z), j(c_next))
    _, db, dx, dh_prev, dc_prev = _bwd(res, (j(dh_next), j(dc_next)))
    dz = np.concatenate([np.asarray(dx), np.asarray(dh_prev)], axis=-1)
    return (torch.from_numpy(dz), torch.from_numpy(np.array(
        dc_prev, np.float32)), torch.from_numpy(np.array(db)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cx,ch", [(3, 1), (24, 8), (36, 12)])
def test_plain_is_the_eager_backward(dtype, cx, ch):
    """The plain version against ``_bwd``: z, c, c', dh' and dc' in
    ``dtype``, x and h float32 (so that ``_bwd``'s dx and dh_prev carry dz
    unrounded), db in float32; xh is x and h side by side in float32."""
    ops = list(_operands(2, 5, 7, cx, ch, dtype))
    ops[5], ops[6] = ops[5].float(), ops[6].float()
    dz, dc_prev, xh, db = cell_backward_plain(*ops, torch.float32)
    assert [t.dtype for t in (dz, dc_prev, xh, db)] == [
        torch.float32, dtype, torch.float32, torch.float32]
    assert all(t.is_contiguous() for t in (dz, dc_prev, xh, db))
    assert torch.equal(xh, torch.cat([ops[5], ops[6]], dim=-1))
    dz_j, dc_prev_j, db_j = _jax_bwd(*ops)
    _compare_to_ref(dz, dc_prev, db, dz_j, dc_prev_j, db_j, dtype)


def test_wrapper_runs_the_plain_version_on_cpu():
    """CPU tensors: the plain version's bits, no launch counted; mixed
    dtypes (bfloat16 activations, float32 bias) and strided gradients are
    taken as the plain version takes them."""
    ops = list(_operands(2, 6, 5, 3, 8, torch.bfloat16))
    ops[3] = ops[3].float().transpose(1, 2).contiguous().transpose(1, 2)
    assert not ops[3].is_contiguous()
    before = cell_backward.launches
    got = cell_backward(*ops, torch.float32)
    assert cell_backward.launches == before
    for g, w in zip(got, cell_backward_plain(*ops, torch.float32)):
        assert torch.equal(g, w)
    assert got[3].dtype == torch.float32 and got[1].dtype == torch.bfloat16


def test_function_backward_on_cpu_launches_nothing():
    """ConvLSTMCellFn on CPU tensors takes K6's plain version; its launch
    counter is registered with the program's counters."""
    g = torch.Generator().manual_seed(3)
    w = (torch.randn(3, 3, 12, 32, generator=g) * 0.1).requires_grad_(True)
    bias = torch.zeros(32, requires_grad=True)
    x, h, c = (torch.randn(2, 6, 6, n, generator=g).requires_grad_(True)
               for n in (4, 8, 8))
    before = profiling.counters()["cell_backward.launches"]
    hn, cn = ConvLSTMCellFn.apply(w, bias, x, h, c)
    (hn.sum() + cn.square().sum()).backward()
    assert profiling.counters()["cell_backward.launches"] == before
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (w, bias, x, h, c))


def _bad(case):
    """Operands and db's dtype with one fault, and the words of the error."""
    ops = dict(zip(NAMES, _operands(2, 4, 4, 3, 8, torch.bfloat16)))
    db = torch.bfloat16
    if case == "z_without_4ch":
        ops["z"] = ops["z"][..., :24].contiguous()
        return ops, db, "z must be"
    if case == "c_shape":
        ops["c"] = ops["c"][:, :3].contiguous()
        return ops, db, "c must be"
    if case == "dh_channels":
        ops["dh_next"] = ops["dh_next"][..., :4].contiguous()
        return ops, db, "dh_next must be"
    if case == "h_batch":
        ops["h"] = ops["h"][:1]
        return ops, db, "h must be"
    if case == "x_rank":
        ops["x"] = ops["x"][0]
        return ops, db, "x must be"
    if case == "mixed_dtypes":
        ops["dc_next"] = ops["dc_next"].float()
        return ops, db, "one dtype"
    if case == "db_dtype":
        return ops, torch.float32, "one dtype"
    if case == "float16":
        return {k: v.half() for k, v in ops.items()}, torch.float16, \
            "float32 or bfloat16"
    if case == "strided_residual":
        ops["c_next"] = ops["c_next"].transpose(1, 2)
        return ops, db, "contiguous"
    raise AssertionError(case)


SHAPE_CASES = ["z_without_4ch", "c_shape", "dh_channels", "h_batch", "x_rank"]
CARD_CASES = ["mixed_dtypes", "db_dtype", "float16", "strided_residual"]


@pytest.mark.parametrize("case", SHAPE_CASES + CARD_CASES)
def test_refusals(case):
    """The card's rules, on CPU tensors through ``_check_backward_args``; the
    shape rules also hold on the CPU path of the wrapper."""
    ops, db, words = _bad(case)
    with pytest.raises(ValueError, match=words):
        kmod._check_backward_args(*ops.values(), db)
    if case in SHAPE_CASES:
        with pytest.raises(ValueError, match=words):
            cell_backward(*ops.values(), db)


@pytest.mark.parametrize("case", SHAPE_CASES + CARD_CASES + ["well_formed",
                                                              "cpu_and_meta"])
def test_meta_tensors_reach_every_rule(case):
    """Off the CPU the wrapper applies every rule before it loads or
    launches anything: meta tensors raise by the fault's rule, and a
    well-formed set by the device rule."""
    if case in ("well_formed", "cpu_and_meta"):
        ops = dict(zip(NAMES, _operands(2, 4, 4, 3, 8, torch.bfloat16)))
        db, words = torch.bfloat16, "one CUDA device"
    else:
        ops, db, words = _bad(case)
    meta = {k: v.to("meta") for k, v in ops.items()}
    if case == "cpu_and_meta":
        meta["x"] = ops["x"]
    if case == "strided_residual":
        meta["c_next"] = ops["c_next"].contiguous().to("meta").transpose(1, 2)
    before = cell_backward.launches
    with pytest.raises(ValueError, match=words):
        cell_backward(*meta.values(), db)
    assert cell_backward.launches == before


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_f32_close(what, got, want):
    bound = F32_ULPS * (want.abs() + want.abs().max())
    err = (got - want).abs()
    assert bool((err <= bound).all()), (what, float(err.max()))


def _compare_to_ref(dz, dc_prev, db, dz_p, dc_prev_p, db_p, dtype):
    """dz, dc_prev and db against a reference's, by the module's bounds."""
    _assert_f32_close("dz", dz, dz_p)
    if dtype == torch.float32:
        _assert_f32_close("dc_prev", dc_prev.float(), dc_prev_p.float())
    else:
        p = dc_prev_p.float()
        err = (dc_prev.float() - p).abs()
        assert bool((err <= BF16_ULP * p.abs() + F32_ULPS * p.abs().max())
                    .all()), ("dc_prev", float(err.max()))
    bound = DB_SUM * dz_p.abs().sum(dim=(0, 1, 2))
    if db.dtype == torch.bfloat16:
        bound = bound + BF16_ULP * db_p.float().abs()
    err = (db.float() - db_p.float()).abs()
    assert bool((err <= bound).all()), ("db", float(err.max()))


def _compare(got, want, dtype):
    assert [t.dtype for t in got] == [t.dtype for t in want]
    assert torch.equal(got[2], want[2])
    _compare_to_ref(got[0], got[1], got[3], want[0], want[1], want[3], dtype)


CARD_SHAPES = {
    # nowcast_128's cells: B 4, 128^2, bf16, cell 1 (Cx 1) and cells 2-3
    "nowcast_cell1": (4, 128, 128, 1, 64, torch.bfloat16),
    "nowcast_cell2": (4, 128, 128, 64, 64, torch.bfloat16),
    # the Generator's cells (configs/default.yaml): B 8, 16^2, float32
    "generator_16_16": (8, 16, 16, 16, 16, torch.float32),
    "generator_16_32": (8, 16, 16, 16, 32, torch.float32),
    # Ch not a multiple of 8: the scalar variant (the float32 K1 takes it)
    "scalar_f32": (2, 13, 21, 3, 20, torch.float32),
    "scalar_bf16": (2, 13, 21, 5, 12, torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_k6_matches_plain(card, name):
    b, hgt, wid, cx, ch, dtype = CARD_SHAPES[name]
    ops = _operands(b, hgt, wid, cx, ch, dtype, device="cuda", seed=7)
    before = cell_backward.launches
    got = cell_backward(*ops, dtype)
    assert cell_backward.launches == before + 1
    _compare(got, cell_backward_plain(*ops, dtype), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_zero_dc_next_and_strided_grads(card, dtype):
    """A materialised-zero dc' (what autograd hands a step whose c' is
    unused) and a strided dh' (made contiguous by the wrapper), and the
    misaligned operand that sends Ch 64 to the scalar variant."""
    ops = list(_operands(4, 32, 32, 1, 64, dtype, device="cuda", seed=11))
    ops[4] = torch.zeros_like(ops[4])
    _compare(cell_backward(*ops, dtype), cell_backward_plain(*ops, dtype),
             dtype)
    ops[3] = ops[3].transpose(1, 2).contiguous().transpose(1, 2)
    _compare(cell_backward(*ops, dtype), cell_backward_plain(*ops, dtype),
             dtype)
    buf = torch.empty(ops[1].numel() + 1, dtype=dtype, device="cuda")
    shifted = buf[1:].view(ops[1].shape)
    shifted.copy_(ops[1])
    ops[1] = shifted                      # c two bytes (bf16) off 16
    _compare(cell_backward(*ops, dtype), cell_backward_plain(*ops, dtype),
             dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nowcast_cell2", "generator_16_32",
                                  "scalar_f32"])
def test_k6_db_bits_repeat(card, name):
    b, hgt, wid, cx, ch, dtype = CARD_SHAPES[name]
    ops = _operands(b, hgt, wid, cx, ch, dtype, device="cuda", seed=5)
    first = cell_backward(*ops, dtype)
    second = cell_backward(*ops, dtype)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def _nowcast_state():
    from pl_convlstm_gan_tpu_torch.predict import build_model
    from pl_convlstm_gan_tpu_torch.train.steps import (TrainState,
                                                       make_optimizer)
    cfg = load_config("nowcast_128_pallas")
    torch.manual_seed(0)
    model = build_model(cfg).cuda()
    return cfg, TrainState(model, make_optimizer(model))


def _nowcast_batch(cfg, seed):
    mc = cfg.model
    rng = np.random.default_rng(seed)
    size = cfg.data.synthetic_image_size
    return tuple(torch.from_numpy(rng.random(
        (cfg.training.batch_size, t, mc.in_channels, size, size),
        dtype=np.float32)).cuda() for t in (mc.input_frames,
                                            mc.output_frames))


@pytest.mark.cuda
def test_forecaster_step_runs_k6(card, monkeypatch):
    """nowcast_128_pallas at full width (3 x 64, 128^2, B 4, 5 -> 20,
    bf16): a train step launches K6 once a cell and step (72); its
    gradients equal those of the pre-K6 backward (the plain version on the
    card, cuDNN deterministic for both) to 2^-8 of each leaf's norm, a bf16
    ulp (db and dc_prev may land an ulp apart); a stream launches none."""
    from pl_convlstm_gan_tpu_torch.streaming import StreamingForecaster
    from pl_convlstm_gan_tpu_torch.train.steps import (forecaster_loss,
                                                       forecaster_train_step)
    cfg, state = _nowcast_state()
    batch = _nowcast_batch(cfg, 1)
    mc = cfg.model
    per_step = len(mc.hidden_dims) * (mc.input_frames + mc.output_frames - 1)
    before = cell_backward.launches
    forecaster_train_step(state, batch, cfg.training.learning_rate)
    assert cell_backward.launches - before == per_step == 72

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    grads = {}
    for name, fn in (("k6", kmod._launch_cell_backward),
                     ("plain", cell_backward_plain)):
        monkeypatch.setattr(kmod, "_launch_cell_backward", fn)
        state.optimizer.zero_grad(set_to_none=True)
        forecaster_loss(state.model, *batch)[0].backward()
        grads[name] = [p.grad.clone() for p in state.model.parameters()]
    for (pname, _), g, r in zip(state.model.named_parameters(),
                                grads["k6"], grads["plain"]):
        assert bool(torch.isfinite(g).all()), pname
        assert float((g - r).norm()) <= 2.0 ** -8 * float(r.norm()), pname
    monkeypatch.undo()

    sf = StreamingForecaster(cfg, state.model.state_dict())
    frames = batch[0][:1]
    before = cell_backward.launches
    st, _ = sf.observe_window(sf.init_state(1, frames.shape[-2],
                                            frames.shape[-1]), frames)
    sf.forecast(st, 30)
    torch.cuda.synchronize()
    assert cell_backward.launches == before
