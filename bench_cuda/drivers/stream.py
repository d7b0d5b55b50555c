"""Closed-loop streaming: one client, B 1. Each request folds the newest
frame into the carried state (``StreamingForecaster.observe``) and
forecasts ``horizon`` frames from it (``forecast``), then waits for the
device; the next request is issued when it returns.

Set-up primes the stream with the mix's ``prime_frames`` and runs
``warmup_requests`` requests, which warm every shape the window uses. The
window times every request on the host clock. A seeded sample of the
window's requests (rate ``compare_rate``) and its last request keep their
forecast and the state they carried; once the window has closed and the
program is freed, the reference replays the whole stream (priming,
warm-up, every request's frame) in float32 and is compared with the kept
states, and forecasts from each kept state and is compared with the kept
forecast (``compare``). The window runs with the collector's existing
objects frozen (``gc.freeze``), so that its pauses do not grow with what
set-up left.

Mix keys: ``horizon``, ``prime_frames``, ``warmup_requests``,
``compare_rate``, ``frame_pool`` (a ring of seeded frames on the card:
priming reads the first ``prime_frames``, request j, warm-up first, frame
``(prime_frames + j) % frame_pool``), ``trace_requests`` and ``trace_host_requests`` (the device and the host
stretch of a ``--trace 1`` run, ``trace.traced``).
"""
from __future__ import annotations

import contextlib
import gc
import statistics
import time
import types

from .. import checks, data, flops, harness
from ..reference import convlstm as ref
from ..trace import busy_and_window, span, traced

# requests the seeded sample to compare is drawn over, then repeated (a
# window of 51 s at a thousand requests a second stays inside it)
KEEP_SPAN = 1 << 16


def frames_of(seed: int, model: dict, mix: dict, device):
    """The ring of the mix's ``frame_pool`` seeded frames."""
    return data.stream_frames(seed, mix["frame_pool"], model["image_size"],
                              model["in_channels"], device)


def kept_flags(seed: int, mix: dict) -> list:
    """Whether request i (modulo ``KEEP_SPAN``) keeps its outputs for the
    comparison: a seeded sample at the mix's ``compare_rate``."""
    import torch
    return (torch.rand(KEEP_SPAN, generator=data.gen(seed, "compare", "cpu"))
            < mix["compare_rate"]).tolist()


def run(cell, seed: int, seconds: float, trace: bool, clock,
        device: str = "cuda") -> harness.Outcome:
    import torch
    from pl_convlstm_gan_tpu_torch.streaming import StreamingForecaster
    clock.mark("program imported")
    cfg, mix = cell.config, cell.mix
    model = cfg["model"]
    size, chans, horizon = model["image_size"], model["in_channels"], \
        mix["horizon"]
    shapes = ref.forecaster_param_shapes(model)
    weights = data.weights(seed, shapes, device)
    sf = StreamingForecaster(harness.program_config(cfg), weights,
                             device=device)
    clock.mark("weights made, forecaster built")

    prime = mix["prime_frames"]
    frames = frames_of(seed, model, mix, device)
    pool = frames.shape[0]
    keep = kept_flags(seed, mix)

    def frame(j):                 # request j's frame (warm-up first)
        return frames[(prime + j) % pool]

    state = sf.init_state(1, size, size)
    state, _ = sf.observe_window(state, frames[:prime].reshape(
        1, prime, chans, size, size))
    warm = mix["warmup_requests"]
    for j in range(warm):
        state, _ = sf.observe(state, frame(j))
        sf.forecast(state, horizon)
    harness.sync(device)
    setup_s = clock.mark("stream primed, requests warmed")

    kept, lat = {}, []
    events = {"observe": [], "forecast": []}
    spans = span if trace else (lambda name: contextlib.nullcontext())
    n = 0

    def request(state, timed=False):
        with spans("request"):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
                if timed else None
            if ev:
                ev[0].record()
            with spans("observe"):
                state, _ = sf.observe(state, frame(warm + n))
            if ev:
                ev[1].record()
            with spans("forecast"):
                out = sf.forecast(state, horizon)
            if ev:
                ev[2].record()
            harness.sync(device)
        if ev:
            events["observe"].append(ev[0].elapsed_time(ev[1]))
            events["forecast"].append(ev[1].elapsed_time(ev[2]))
        return state, out

    def keep_outputs(out, state):
        """A kept request's outputs go to the host between requests, so
        that the window's device memory stays as the program leaves it."""
        if keep[n % KEEP_SPAN]:
            kept[n] = to_host(out, state)

    gc.collect()
    gc.freeze()
    start = time.perf_counter()
    if trace:
        def run_units(units, on_unit):
            nonlocal state, out, n
            timed = not events["observe"]
            for _ in range(units):
                state, out = request(state, timed)
                keep_outputs(out, state)
                n += 1
                on_unit()
        out = None
        rec = traced(run_units, mix["trace_requests"],
                     mix["trace_host_requests"])
    else:
        end = start + seconds
        while n < 2 or time.perf_counter() < end:   # two make a quantile
            t0 = time.perf_counter()
            state, out = request(state)
            lat.append(time.perf_counter() - t0)
            keep_outputs(out, state)
            n += 1
    kept[n - 1] = to_host(out, state)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    del sf, state, out
    gc.collect()

    detail = {}
    readings = compare(cfg, weights, frames, prime, warm, n, kept, horizon,
                       device, detail)
    outcome = harness.Outcome(n, 0, readings, peak, detail=detail)
    if trace:
        rec.event_ms = events
        unit_flops, unit_bound = flops.stream_request(model, horizon)
        rec.info.update(unit_flops=unit_flops, unit_bound_ms=unit_bound,
                        peak_flops=flops.PEAK_FLOPS["bfloat16"], chips=1)
        outcome.records = rec
        outcome.busy_s, outcome.window_s = busy_and_window(rec)
    else:
        ms = sorted(x * 1e3 for x in lat)
        outcome.e2e = {"setup_s": setup_s,
                       "request_p50_ms": statistics.median(ms),
                       "request_p95_ms": statistics.quantiles(
                           ms, n=20, method="inclusive")[18]}
    harness.say(f"window: {n} requests in {time.perf_counter() - start:.3f}"
                f" s, {len(kept)} compared")
    return outcome


def replay(cfg: dict, params, frames, prime: int, warm: int, n: int,
           want, q, device):
    """The reference's stream from its start: {request index: (state,
    nowcast NHWC)} after the ``observe`` of each window request in
    ``want``; the state as a list of (h, c)."""
    import torch
    model = cfg["model"]
    size = model["image_size"]
    pool = frames.shape[0]
    out = {}
    with torch.no_grad():
        state = ref.zero_state(model, 1, size, size, device)
        for t in range(prime):
            state, prev = ref.stream_observe(params, model, state,
                                             frames[t], q)
        for j in range(warm + n):
            state, prev = ref.stream_observe(
                params, model, state, frames[(prime + j) % pool], q)
            if j - warm in want:
                out[j - warm] = (state, prev)
    return out


def forecast_from(cfg: dict, params, cells, prev, horizon: int, q):
    """The reference's forecast from a given state (any dtype, taken as
    float32)."""
    import torch
    with torch.no_grad():
        state = [(h.float(), c.float()) for h, c in cells]
        return ref.stream_forecast(params, cfg["model"], state, prev.float(),
                                   horizon, q)


def to_host(out, state):
    return out.cpu(), types.SimpleNamespace(
        cells=[(h.cpu(), c.cpu()) for h, c in state.cells],
        prev_out=state.prev_out.cpu())


def compare(cfg, weights, frames, prime, warm, n, kept, horizon, device,
            detail=None):
    """Worst gaps over the kept requests:

    - ``state_rel_l2``: the relative L2 gap of the carried (h, c) of every
      cell from the float32 reference's own replay of the stream;
    - ``forecast_gap``: the L2 gap of the forecast from the float32
      reference's forecast out of the program's own carried state (so the
      state's rounding, checked apart, does not reach it), in units of the
      gap that the reference's own bfloat16 rounding (the configuration's
      precision) opens from the same state. Random weights leave the
      forecast near the head's bias, whose size differs from seed to seed,
      so a gap relative to the forecast's own norm swings with the seed;
      this unit does not.
    """
    import torch
    f32, bf16 = ref.rounding("f32"), ref.rounding("bf16")
    with harness.reference_numerics():
        refs = replay(cfg, weights, frames, prime, warm, n, set(kept), f32,
                      device)
        fc, st = [], []
        for i, (out, state) in kept.items():
            r_state, _ = refs[i]
            prog = torch.cat([t.float().reshape(-1) for hc in state.cells
                              for t in hc]).to(device)
            want = torch.cat([t.reshape(-1) for hc in r_state for t in hc])
            st.append(checks.rel_l2(prog, want))
            cells = [(h.to(device), c.to(device)) for h, c in state.cells]
            prev = state.prev_out.to(device)
            r32 = forecast_from(cfg, weights, cells, prev, horizon, f32)
            r16 = forecast_from(cfg, weights, cells, prev, horizon, bf16)
            out = out.to(device)
            unit = float(torch.linalg.vector_norm((r16 - r32).double()))
            fc.append(float(torch.linalg.vector_norm((out - r32).double()))
                      / max(unit, 1e-30))
            if detail is not None:
                detail.setdefault("by_frame", []).append(
                    [checks.rel_l2(out[:, t], r32[:, t])
                     for t in range(horizon)])
                detail.setdefault("rel_l2", []).append(
                    checks.rel_l2(out, r32))
    return {"forecast_gap": max(fc), "state_rel_l2": max(st)}
