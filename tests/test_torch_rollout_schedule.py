"""The rollout's phase table (``rollout_schedule``), its walk, K5's rules and
the executor dispatch, on the CPU.

K5 (``csrc/rollout_persistent.cu``) runs one launch per bfloat16 rollout on
the card and walks the same table there; here the table is walked through
the plain versions of K1 and K2, which is K5's plain version
(``rollout_persistent_plain``). Checked:
- the table's invariants for cold, warm and observe schedules at 2 and 3
  cells (the loop's ping-pong rules);
- the walked table against the per-step loop it replaced (kept below as
  ``loop_reference``), bit for bit, in float32 and bfloat16;
- the walked table against the JAX package at 2 x 8 channels on 16^2:
  ``rollout_pallas`` and ``rollout_pallas_from_state`` in interpret mode (as
  tests/test_pallas.py and tests/test_torch_streaming.py run them) and
  JAX's ``observe`` on its plain (XLA) path. Tolerances are ROADMAP.md
  §C's: 1e-5 (atol = rtol) in float32; 1e-3 absolute on bfloat16 outputs
  (below 0.125 here, where one bf16 ulp is at most 2^-11 = 4.9e-4, so 1e-3
  is two ulps: the two sides share their rounding points and sum in other
  orders, so a stored value can land an ulp apart); the bf16 observe's
  states two ulps of their magnitude (below 0.5: 4e-3), since JAX's XLA step
  rounds z and each gate to bf16 where the port rounds only h' and c';
- ``persistent_misfit``'s rules, and that CPU tensors never reach K5's
  launch while tensors on another device reach its checks (no fallback).
Inputs are made with numpy from fixed seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_convlstm_gan_tpu.ops.pallas.rollout_kernel import (
    rollout_pallas, rollout_pallas_from_state)
from pl_convlstm_gan_tpu_torch.ops.kernels import build
from pl_convlstm_gan_tpu_torch.ops.kernels import rollout_kernel as rk
from pl_convlstm_gan_tpu_torch.ops.kernels.convlstm_kernel import (
    convlstm_cell_fwd, convlstm_cell_plain)
from pl_convlstm_gan_tpu_torch.ops.kernels.rollout_kernel import (
    C_BUF, CELL, CELL_PHASE, C_READ, C_WRITE, FROM_FRAME, FROM_H, FROM_OUT,
    HEAD_PHASE, H_READ, H_WRITE, KIND, OUT_SLOT, PING0, PING1, SEED, STEP,
    X_FROM, X_INDEX, conv_head_fwd, conv_head_plain, final_buffers,
    observe_kernel, pack_weights, persistent_misfit, rollout_kernel,
    rollout_kernel_from_state, rollout_persistent_fwd,
    rollout_persistent_plain, rollout_plain, rollout_schedule)
from pl_convlstm_gan_tpu_torch.weights import flax_to_state_dict
from test_torch_models import flax_params, frames_np
from test_torch_streaming import jax_state_numpy, jax_streaming

TOL = dict(atol=1e-5, rtol=1e-5)
B, SIZE, T_IN, T_OUT, HORIZON = 2, 16, 3, 4, 4
HIDDEN = (8, 8)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def schedules(n_cells):
    """(name, steps, emit_from, t_in) of the three callers: a cold request
    (T_IN frames in, T_OUT out), a warm forecast(HORIZON) and an observe of
    T_IN frames."""
    return [("cold", T_IN + T_OUT - 1, T_IN - 1, T_IN),
            ("warm", HORIZON, 0, 1),
            ("observe", T_IN, 0, T_IN)]


CASES = [(n, *s) for n in (2, 3) for s in schedules(n)]
CASE_IDS = [f"{name}-{n}cells" for n, name, *_ in CASES]


@pytest.mark.parametrize("n_cells,name,steps,emit_from,t_in", CASES,
                         ids=CASE_IDS)
def test_schedule_invariants(n_cells, name, steps, emit_from, t_in):
    table = rollout_schedule(n_cells, steps, emit_from, t_in)
    assert table.dtype == torch.int32 and table.shape[1] == 10
    rows = table.tolist()
    assert len(rows) == steps * n_cells + (steps - emit_from)
    written = {}       # buffer -> the phase that wrote it last
    for p, row in enumerate(rows):
        t = row[STEP]
        if row[KIND] == HEAD_PHASE:
            assert row[CELL] == n_cells and row[X_FROM] == FROM_H
            assert t >= emit_from and row[OUT_SLOT] == t - emit_from
            reads = {("h", n_cells - 1, row[X_INDEX])}
            writes = {("out", row[OUT_SLOT])}
        else:
            assert row[KIND] == CELL_PHASE
            k = row[CELL]
            assert row[OUT_SLOT] == -1
            if k > 0:
                assert row[X_FROM] == FROM_H
                x = ("h", k - 1, row[X_INDEX])
                # x is the h the cell below wrote at this step
                assert rows[written[x]][STEP] == t
            elif t < t_in:
                assert row[X_FROM] == FROM_FRAME and row[X_INDEX] == t
                x = ("frame", t)
            else:
                assert row[X_FROM] == FROM_OUT
                x = ("out", row[X_INDEX])
                assert rows[written[x]][STEP] == t - 1
            reads = {x, ("h", k, row[H_READ]), ("c", k, row[C_READ])}
            writes = {("h", k, row[H_WRITE])}
            # no seed is written; c from step 1 on is read and written in place
            assert row[H_WRITE] in (PING0, PING1) and row[C_WRITE] == C_BUF
            assert row[C_READ] == (SEED if t == 0 else C_BUF)
            assert row[H_READ] == (SEED if t == 0 else PING0 + (t - 1) % 2)
            if t > 0:      # h read is what this cell wrote at the step before
                assert rows[written[("h", k, row[H_READ])]][STEP] == t - 1
                assert rows[written[("c", k, C_BUF)]][STEP] == t - 1
            written[("c", k, C_BUF)] = p
        # no phase writes what it reads (c's in-place update aside)
        assert not writes & reads
        written.update({w: p for w in writes})
    # the final state aliases no seed: each cell's last h is a ping buffer
    assert final_buffers(table) == [PING0 + (steps - 1) % 2] * n_cells
    assert {r[OUT_SLOT] for r in rows if r[KIND] == HEAD_PHASE} == set(
        range(steps - emit_from))


@pytest.mark.parametrize("steps,emit_from,t_in", [(0, 0, 1), (3, 1, 1),
                                                  (3, -1, 2), (2, 2, 3)])
def test_schedule_refuses_bad_arguments(steps, emit_from, t_in):
    with pytest.raises(ValueError, match="emit_from"):
        rollout_schedule(2, steps, emit_from, t_in)


def loop_reference(weights, fr, steps, emit_from, seeds, cell_fn, head_fn):
    """The per-step host loop the schedule replaced, as it was: step t feeds
    fr[t] while t < T_in, else the head's output of the step before; each
    cell writes its h into the other buffer of a ping-pong pair and its c
    into a buffer of its own, in place from step 1 on."""
    t_in, b, hgt, wid, c = fr.shape
    out = torch.empty((steps - emit_from, b, hgt, wid, c), dtype=fr.dtype,
                      device=fr.device)
    state = list(seeds)
    h_bufs = [[torch.empty_like(h) for _ in range(min(steps, 2))]
              for h, _ in seeds]
    c_bufs = [torch.empty_like(c_seed) for _, c_seed in seeds]
    for t in range(steps):
        x = fr[t] if t < t_in else out[t - 1 - emit_from]
        for k, ((w, bias), packed) in enumerate(zip(weights.cells,
                                                    weights.packed)):
            h_new = h_bufs[k][t % 2]
            cell_fn(x, *state[k], w, bias, h_new, c_bufs[k], packed=packed)
            state[k] = (h_new, c_bufs[k])
            x = h_new
        if t >= emit_from:
            head_fn(x, weights.head[0], weights.head[1], out[t - emit_from])
    return out, tuple(state)


def inputs(n_cells, dtype, t_in, seed, warm):
    """Weights, time-major frames and seeds (zeros, or a random warm state
    with |h|, |c| < 0.5) for an n_cells x 8 model on SIZE^2."""
    hidden = (8,) * n_cells
    weights = pack_weights(flax_to_state_dict(flax_params(seed, hidden)),
                           dtype)
    rng = np.random.default_rng(seed + 1)
    fr = torch.from_numpy(rng.random((t_in, B, SIZE, SIZE, 1),
                                     dtype=np.float32)).to(dtype)
    shape = (B, SIZE, SIZE, 8)
    if warm:
        seeds = [tuple(torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(
            np.float32)).to(dtype) for _ in range(2)) for _ in hidden]
    else:
        seeds = [(z, z) for z in (torch.zeros(shape, dtype=dtype)
                                  for _ in hidden)]
    return weights, fr, seeds


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_cells,name,steps,emit_from,t_in", CASES,
                         ids=CASE_IDS)
def test_walked_schedule_equals_the_loop(n_cells, name, steps, emit_from,
                                         t_in, dtype):
    weights, fr, seeds = inputs(n_cells, DTYPES[dtype], t_in, 40 + n_cells,
                                warm=name != "cold")
    before = [tuple(t.clone() for t in pair) for pair in seeds]
    ref_out, ref_state = loop_reference(weights, fr, steps, emit_from, seeds,
                                        convlstm_cell_plain, conv_head_plain)
    for run in (lambda: rollout_persistent_plain(weights, fr, steps,
                                                 emit_from, seeds),
                lambda: rk._steps(weights, fr, steps, emit_from, seeds,
                                  convlstm_cell_plain, conv_head_plain),
                lambda: rk._steps(weights, fr, steps, emit_from, seeds)):
        out, state = run()
        assert torch.equal(out, ref_out)
        assert len(state) == n_cells
        for (h, c), (rh, rc), (sh, sc) in zip(state, ref_state, seeds):
            assert torch.equal(h, rh) and torch.equal(c, rc)
            assert not ({h.data_ptr(), c.data_ptr()}
                        & {sh.data_ptr(), sc.data_ptr()})
    for (h, c), (bh, bc) in zip(seeds, before):   # the seeds are only read
        assert torch.equal(h, bh) and torch.equal(c, bc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cold_schedule_matches_jax_rollout_pallas(dtype):
    params = flax_params(50, HIDDEN)
    frames = frames_np(51, b=B, t=T_IN, size=SIZE)
    ref = np.asarray(rollout_pallas(params, jnp.asarray(frames), T_OUT,
                                    compute_dtype=JAX_DTYPES[dtype]))
    weights = pack_weights(flax_to_state_dict(params), DTYPES[dtype])
    out = rollout_kernel(weights, torch.from_numpy(frames), T_OUT,
                         DTYPES[dtype])
    assert out.shape == ref.shape == (B, T_OUT, 1, SIZE, SIZE)
    assert out.dtype == torch.float32
    if dtype == "bfloat16":
        assert np.abs(ref).max() < 0.125
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=0)
    else:
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert torch.equal(rollout_plain(weights, torch.from_numpy(frames), T_OUT,
                                     DTYPES[dtype]), out)


def warm_jax_state(params, dtype):
    jsf = jax_streaming(params, HIDDEN, dtype)
    js, _ = jsf.observe_window(jsf.init_state(B, SIZE, SIZE),
                               jnp.asarray(frames_np(53, size=SIZE)))
    return jsf, js


def port_cells(js, dtype):
    cells, prev = jax_state_numpy(js)
    to = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype)
    return tuple((to(h), to(c)) for h, c in cells), to(prev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warm_schedule_matches_jax_rollout_pallas_from_state(dtype):
    params = flax_params(52, HIDDEN)
    _, js = warm_jax_state(params, dtype)
    ref = np.asarray(rollout_pallas_from_state(
        params["params"]["core"], js.cells, js.prev_out, HORIZON,
        compute_dtype=JAX_DTYPES[dtype]))
    weights = pack_weights(flax_to_state_dict(params), DTYPES[dtype])
    cells, prev = port_cells(js, DTYPES[dtype])
    out = rollout_kernel_from_state(weights, cells, prev, HORIZON,
                                    DTYPES[dtype])
    assert out.shape == ref.shape == (B, HORIZON, 1, SIZE, SIZE)
    if dtype == "bfloat16":
        assert np.abs(ref).max() < 0.125
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=0)
    else:
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_observe_schedule_matches_jax_observe(dtype):
    params = flax_params(54, HIDDEN)
    jsf, js = warm_jax_state(params, dtype)
    frames = frames_np(55, size=SIZE)
    js2, jnow = jsf.observe_window(js, jnp.asarray(frames))
    weights = pack_weights(flax_to_state_dict(params), DTYPES[dtype])
    cells, _ = port_cells(js, DTYPES[dtype])
    state, prev = observe_kernel(weights, cells, torch.from_numpy(frames),
                                 DTYPES[dtype])
    # prev_out is NHWC, JAX's nowcast NCHW
    now = prev.float().permute(0, 3, 1, 2).numpy()
    want_cells, _ = jax_state_numpy(js2)
    if dtype == "bfloat16":
        assert np.abs(np.asarray(jnow, np.float32)).max() < 0.125
        np.testing.assert_allclose(now, np.asarray(jnow, np.float32),
                                   atol=1e-3, rtol=0)
        state_tol = dict(atol=4e-3, rtol=0)
    else:
        np.testing.assert_allclose(now, np.asarray(jnow), **TOL)
        state_tol = TOL
    for (h, c), (jh, jc) in zip(state, want_cells):
        assert max(np.abs(np.asarray(jh, np.float32)).max(),
                   np.abs(np.asarray(jc, np.float32)).max()) < 0.5
        np.testing.assert_allclose(h.float().numpy(),
                                   np.asarray(jh, np.float32), **state_tol)
        np.testing.assert_allclose(c.float().numpy(),
                                   np.asarray(jc, np.float32), **state_tol)


@pytest.mark.parametrize("hidden,cin,k,dtype,match", [
    ((64, 64, 64), 1, 3, torch.float32, "K5 runs bfloat16"),
    ((12, 12), 1, 3, torch.bfloat16, "multiple of 8, got Ch 12"),
    ((64, 64), 1, 4, torch.bfloat16, "odd-sized"),
    ((8,) * 5, 1, 3, torch.bfloat16, "at most 4 cells"),
    ((64, 64), 8, 3, torch.bfloat16, "folded"),
    ((512,), 1, 3, torch.bfloat16, "shared memory"),
])
def test_persistent_misfit_rules(hidden, cin, k, dtype, match):
    why = persistent_misfit(hidden, cin, k, dtype)
    assert why is not None and match in why
    # K1/K2's own refusals come first and are named as theirs
    k1k2 = rk.rollout_kernel_misfit(hidden, cin, k, dtype)
    if k1k2 is not None and dtype == torch.bfloat16:
        assert why == k1k2


@pytest.mark.parametrize("hidden,cin", [((64, 64, 64), 1), ((64, 64), 1),
                                        ((256, 256, 256), 1), ((8, 8), 3)])
def test_persistent_misfit_admits(hidden, cin):
    """nowcast_128, precip_256, tp_nowcast_128's widths, and 3-channel
    frames (folded over 27 values)."""
    assert persistent_misfit(list(hidden), cin, 3, torch.bfloat16) is None


def test_cpu_tensors_never_reach_k5s_launch(monkeypatch):
    """bfloat16 on CPU tensors: the kernel path takes K5's executor, which
    walks its plain version; nothing is built or launched and no count
    moves. float32 walks K1/K2's wrappers (their plain versions here)."""
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel was built or loaded")
    monkeypatch.setattr(build, "load_function", no_build)
    calls = {"plain": 0, "cell": 0}
    plain = rk.rollout_persistent_plain

    def counted_plain(*args):
        calls["plain"] += 1
        return plain(*args)

    def counted_cell(*args, **kwargs):
        calls["cell"] += 1
        return convlstm_cell_fwd(*args, **kwargs)
    monkeypatch.setattr(rk, "rollout_persistent_plain", counted_plain)
    monkeypatch.setattr(rk, "convlstm_cell_fwd", counted_cell)
    counts = (rollout_persistent_fwd.launches, convlstm_cell_fwd.launches,
              conv_head_fwd.launches)
    params = flax_params(56, HIDDEN)
    frames = torch.from_numpy(frames_np(57, size=SIZE))
    for name, dtype in DTYPES.items():
        weights = pack_weights(flax_to_state_dict(params), dtype)
        out = rollout_kernel(weights, frames, T_OUT, dtype)
        assert torch.equal(out, rollout_plain(weights, frames, T_OUT, dtype))
    assert calls == {"plain": 1, "cell": (T_IN + T_OUT - 1) * len(HIDDEN)}
    assert (rollout_persistent_fwd.launches, convlstm_cell_fwd.launches,
            conv_head_fwd.launches) == counts


def test_k5_takes_non_cpu_tensors_or_raises(monkeypatch):
    """Tensors off the CPU go to K5's checks, which raise on what K5 does not
    take: nothing falls back to the host loop or to the plain path."""
    monkeypatch.setattr(rk, "rollout_persistent_plain", None)
    launches = rollout_persistent_fwd.launches
    weights = pack_weights(flax_to_state_dict(flax_params(58, HIDDEN)),
                           torch.bfloat16)
    meta = rk.RolloutWeights(
        tuple((w.to("meta"), b.to("meta")) for w, b in weights.cells),
        tuple(t.to("meta") for t in weights.head), (None,) * len(HIDDEN))
    fr = torch.empty((T_IN, B, SIZE, SIZE, 1), dtype=torch.bfloat16,
                     device="meta")
    seeds = [(z, z) for z in (torch.empty((B, SIZE, SIZE, 8),
                                          dtype=torch.bfloat16, device="meta")
                              for _ in HIDDEN)]
    with pytest.raises(ValueError, match="packed"):
        rk._steps(meta, fr, T_IN + T_OUT - 1, T_IN - 1, seeds)
    packed = meta._replace(packed=tuple(
        torch.empty(rk.packed_shape(cx, 8, 3), dtype=torch.bfloat16,
                    device="meta") for cx in (1, 8)))
    with pytest.raises(ValueError, match="one CUDA device"):
        rk._steps(packed, fr, T_IN + T_OUT - 1, T_IN - 1, seeds)
    assert rollout_persistent_fwd.launches == launches
