#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check every kernel.

    python3 chip_smoke.py        # from the repository root, one GPU

It imports nothing of JAX or of the JAX package. Phases, each printed on its
own line:
1. build: nvcc builds the kernels of pl_convlstm_gan_tpu_torch/csrc/ for
   sm_90a (all sources in parallel), with ptxas' register/spill report;
2. cell kernel (K1) against its plain PyTorch version at the nowcast_128 cell
   shapes (B 4, 128x128, (Cx, Ch) = (1, 64) and (64, 64)) in float32 and
   bfloat16, plus a ragged shape (odd H/W, Ch not a multiple of the block's
   channels, K=5); kernel, plain and library (one F.conv2d) times;
3. head kernel (K2) the same way at the head's shape (Ch 64 -> 1 channel);
4. main path: load_predictor on configs/nowcast_128.yaml at full width, with
   weights made from a seed and carried through weights.py, in float32 and
   bfloat16; each serves 3 requests of [4, 5, 1, 128, 128] through the
   kernels, checked against rollout_impl="torch" on the card, with the
   launch counts set to 0 before and read after (72 K1 + 20 K2 a request);
   then torch.profiler over one more bf16 request: device time by kernel
   and the device's idle share;
5. stream: StreamingForecaster on the same checkpoint, in float32 and
   bfloat16. observe_window of the first request's 5 frames + forecast(19)
   against the kernel predictor's output for that request (launch counts
   exactly 3 K1 + 1 K2 per observed frame and 3h K1 + h K2 per forecast(h));
   frame-by-frame observe against the window and two forecasts from one
   state (torch.equal, state unchanged); forecast(30) at B 1 and B 8 against
   rollout_impl="torch" from the same carried state; p50 times of one
   observe and of forecast(30), kernel and plain, beside the forecast's
   bound; torch.profiler over one B 1 forecast(30) (idle share);
6. precip_256 (2x64 cells, 256x256, bf16, B 1): observe_window of 5 frames
   and forecast(30) against the plain path, timed;
7. one JSON line {"kernels": [...]} with each kernel's launches (per path),
   error, and its time beside its bound, its plain version's and the
   library call's;
then the card's name and power limit (nvidia-smi), and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from pl_convlstm_gan_tpu_torch.config import load_config
from pl_convlstm_gan_tpu_torch.ops.kernels import build
from pl_convlstm_gan_tpu_torch.ops.kernels import convlstm_kernel as cell_mod
from pl_convlstm_gan_tpu_torch.ops.kernels import rollout_kernel as head_mod
from pl_convlstm_gan_tpu_torch.ops.kernels.convlstm_kernel import (
    convlstm_cell_fwd, convlstm_cell_plain)
from pl_convlstm_gan_tpu_torch.ops.kernels.rollout_kernel import (
    conv_head_fwd, conv_head_plain)
from pl_convlstm_gan_tpu_torch.predict import load_predictor
from pl_convlstm_gan_tpu_torch.streaming import StreamingForecaster
from pl_convlstm_gan_tpu_torch.weights import flax_to_state_dict

SEED = 0
N_REQUESTS = 3
# published peaks of one H100 SXM (NVIDIA data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # f32 without tensor cores
# kernel vs plain version on the same inputs, per element:
#   float32: both sum the same ~1e3 products in different orders -> ~1e-6;
#   bfloat16: both round the same f32 value once at the store, so they differ
#   by at most one bf16 ulp where the f32 values straddle a rounding point:
#   2^-7 = 7.8e-3 for the |values| < 2 of h and c here.
KERNEL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 0.0)}   # (atol, rtol)
# kernel path vs rollout_impl="torch" over a whole 24-step request, whose
# outputs are below 0.0625 here (checked): float32 differs by sums taken in
# other orders (~1e-7); bfloat16 by stored values an ulp apart (2^-12 =
# 2.4e-4 at these magnitudes) carried through the recurrence: 1e-3 is 4 ulps.
PATH_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 0.0)}
MAX_OUTPUT = 0.0625
K1_SOURCE = "pl_convlstm_gan_tpu_torch/csrc/convlstm_cell.cu"
K2_SOURCE = "pl_convlstm_gan_tpu_torch/csrc/conv_head.cu"
K1_REPLACES = "pl_convlstm_gan_tpu/ops/pallas/convlstm_kernel.py:120"
K2_REPLACES = "pl_convlstm_gan_tpu/ops/pallas/rollout_kernel.py:407"
# every TPU kernel each CUDA kernel stands for (PERF.md's table)
_ROLLOUT = "pl_convlstm_gan_tpu/ops/pallas/rollout_kernel.py"
K1_STANDS_FOR = [
    "P1 pl_convlstm_gan_tpu/ops/pallas/convlstm_kernel.py:120 (save_z=False)",
    "P2 pl_convlstm_gan_tpu/ops/pallas/convlstm_kernel.py:246 (save_z=False)",
    f"P3 cells {_ROLLOUT}:505 via rollout_pallas :672",
    f"P4 cells {_ROLLOUT}:505 via rollout_pallas_from_state :706"]
K2_STANDS_FOR = [f"P3 head_pass {_ROLLOUT}:407 via rollout_pallas :672",
                 f"P4 head_pass {_ROLLOUT}:407 via rollout_pallas_from_state :706"]
# the JAX bench's streaming rows (bench.py:263-298): horizon 30 at B 1 and 8
STREAM_HORIZON = 30
STREAM_BATCHES = (1, 8)
N_TIMED = 5


def say(**fields):
    print(json.dumps(fields), flush=True)


def check_close(what, got, want, atol, rtol):
    diff = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: non-finite values")
    if bool((diff > bound).any()):
        raise AssertionError(f"{what}: max abs error {float(diff.max()):.3e} "
                             f"beyond atol={atol} rtol={rtol}")
    return float(diff.max())


def time_ms(fn, iters):
    """Mean device time of fn over `iters` back-to-back calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def raw_launcher(lib, symbol, argtypes, tensors, ints):
    """The kernel's C entry bound to fixed operands: a launch without the
    wrapper's Python checks (for timing, after the wrapper has checked them
    once). It does not touch the wrapper's launch count."""
    fn = build.load_function(lib, symbol, argtypes)
    ptrs = [t.data_ptr() for t in tensors]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        build.check(fn(*ptrs, *ints, stream), lib, symbol)
    return launch


def bound(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_build():
    t0 = time.perf_counter()
    report = build.build_all()
    seconds = time.perf_counter() - t0
    say(phase="build", seconds=round(seconds, 3),
        per_source={k: round(v["seconds"], 3) for k, v in report.items()})
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)


def cell_inputs(gen, b, hgt, wid, cx, ch, k, dtype):
    dev = "cuda"
    u = lambda shape, lo, hi: torch.empty(shape, device=dev).uniform_(
        lo, hi, generator=gen)
    bnd = 1.0 / (k * k * (cx + ch)) ** 0.5
    return [t.to(dtype).contiguous() for t in (
        u((b, hgt, wid, cx), -1, 1), u((b, hgt, wid, ch), -1, 1),
        u((b, hgt, wid, ch), -1, 1), u((k, k, cx + ch, 4 * ch), -bnd, bnd),
        u((4 * ch,), -bnd, bnd))]


def phase_cell(gen, shapes, dtypes):
    """K1 against its plain version; returns {dtype: [per-shape records]}."""
    out = {}
    for dtype in dtypes:
        name = str(dtype).split(".")[-1]
        atol, rtol = KERNEL_TOL[name]
        recs = []
        for (b, hgt, wid, cx, ch, k, timed) in shapes:
            x, h, c, w, bias = cell_inputs(gen, b, hgt, wid, cx, ch, k, dtype)
            hk, ck = convlstm_cell_fwd(x, h, c, w, bias)
            hp, cp = convlstm_cell_plain(x, h, c, w, bias)
            torch.cuda.synchronize()
            err = max(check_close(f"K1 h' {name} {(cx, ch, k)}", hk, hp, atol, rtol),
                      check_close(f"K1 c' {name} {(cx, ch, k)}", ck, cp, atol, rtol))
            rec = dict(shape=[b, hgt, wid, cx, ch, k], max_abs_err=err)
            if timed:
                h_out, c_out = torch.empty_like(h), torch.empty_like(c)
                launch = raw_launcher(
                    "convlstm_cell", cell_mod._SYMBOLS[dtype], cell_mod._ARGTYPES,
                    (x, h, c, w, bias, h_out, c_out), (b, hgt, wid, cx, ch, k))
                rec["ms"] = time_ms(launch, 5)
                rec["plain_ms"] = time_ms(
                    lambda: convlstm_cell_plain(x, h, c, w, bias), 5)
                xh = torch.cat([x, h], -1).permute(0, 3, 1, 2)  # channels_last
                w_oihw = w.permute(3, 2, 0, 1).contiguous()
                rec["library_ms"] = time_ms(
                    lambda: F.conv2d(xh, w_oihw, bias, padding=k // 2), 5)
                flops = 2 * b * hgt * wid * k * k * (cx + ch) * 4 * ch
                nbytes = x.element_size() * (x.numel() + 4 * h.numel()
                                             + w.numel() + bias.numel())
                rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, name)
            say(phase="cell_kernel", dtype=name, tol=[atol, rtol], **rec)
            recs.append(rec)
        out[name] = recs
    return out


def phase_head(gen, shapes, dtypes):
    out = {}
    for dtype in dtypes:
        name = str(dtype).split(".")[-1]
        atol, rtol = KERNEL_TOL[name]
        recs = []
        for (b, hgt, wid, cin, cout, k, timed) in shapes:
            u = lambda shape, lo, hi: torch.empty(shape, device="cuda").uniform_(
                lo, hi, generator=gen).to(dtype)
            bnd = 1.0 / (k * k * cin) ** 0.5
            h = u((b, hgt, wid, cin), -1, 1)
            w, bias = u((k, k, cin, cout), -bnd, bnd), u((cout,), -bnd, bnd)
            ok = conv_head_fwd(h, w, bias)
            op = conv_head_plain(h, w, bias)
            torch.cuda.synchronize()
            err = check_close(f"K2 {name} {(cin, cout, k)}", ok, op, atol, rtol)
            rec = dict(shape=[b, hgt, wid, cin, cout, k], max_abs_err=err)
            if timed:
                o = torch.empty_like(ok)
                launch = raw_launcher("conv_head", head_mod._SYMBOLS[dtype],
                                      head_mod._ARGTYPES, (h, w, bias, o),
                                      (b, hgt, wid, cin, cout, k))
                rec["ms"] = time_ms(launch, 50)
                rec["plain_ms"] = time_ms(lambda: conv_head_plain(h, w, bias), 50)
                h_nchw = h.permute(0, 3, 1, 2)                    # channels_last
                w_oihw = w.permute(3, 2, 0, 1).contiguous()
                rec["library_ms"] = time_ms(
                    lambda: F.conv2d(h_nchw, w_oihw, bias, padding=k // 2), 50)
                flops = 2 * b * hgt * wid * k * k * cin * cout
                nbytes = h.element_size() * (h.numel() + w.numel() + bias.numel()
                                             + o.numel())
                rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, name)
            say(phase="head_kernel", dtype=name, tol=[atol, rtol], **rec)
            recs.append(rec)
        out[name] = recs
    return out


def nowcast_params(cfg, seed):
    """The nowcast_128 forecaster as a flax params tree of numpy arrays, with
    torch-default-init ranges (the layout a JAX checkpoint exports)."""
    rng = np.random.default_rng(seed)
    k, cin = cfg.model.kernel_size, cfg.model.in_channels

    def conv(kk, ci, co):
        bnd = 1.0 / np.sqrt(kk * kk * ci)
        return {"kernel": rng.uniform(-bnd, bnd, (kk, kk, ci, co)).astype(np.float32),
                "bias": rng.uniform(-bnd, bnd, co).astype(np.float32)}

    core = {}
    for i, ch in enumerate(cfg.model.hidden_dims):
        core[f"cell_{i}"] = conv(k, cin + ch, 4 * ch)
        cin = ch
    core["head"] = conv(3, cin, cfg.model.in_channels)
    return {"params": {"core": core}}


def request_ms(predict, frames):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = predict(frames)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_main_path(ckpt, dtype_name, requests):
    cfg = load_config("nowcast_128")
    cfg.precision.compute_dtype = dtype_name
    cfg.validate()
    steps = cfg.model.input_frames + cfg.model.output_frames - 1
    n_cells = len(cfg.model.hidden_dims)
    expect_k1 = N_REQUESTS * steps * n_cells
    expect_k2 = N_REQUESTS * cfg.model.output_frames
    kernel_predict = load_predictor(cfg, ckpt)           # rollout_impl: auto
    cfg_torch = load_config("nowcast_128")
    cfg_torch.precision.compute_dtype = dtype_name
    cfg_torch.model.rollout_impl = "torch"
    torch_predict = load_predictor(cfg_torch, ckpt)

    convlstm_cell_fwd.launches = 0
    conv_head_fwd.launches = 0
    outs, k_ms = zip(*(request_ms(kernel_predict, f) for f in requests))
    launches = {"convlstm_cell_fwd": convlstm_cell_fwd.launches,
                "conv_head_fwd": conv_head_fwd.launches}
    if launches != {"convlstm_cell_fwd": expect_k1, "conv_head_fwd": expect_k2}:
        raise AssertionError(f"main path {dtype_name}: launches {launches}, "
                             f"expected {expect_k1} K1 and {expect_k2} K2")
    refs, t_ms = zip(*(request_ms(torch_predict, f) for f in requests))
    atol, rtol = PATH_TOL[dtype_name]
    want = (requests[0].shape[0], cfg.model.output_frames,
            cfg.model.in_channels) + tuple(requests[0].shape[-2:])
    errs = []
    for i, (o, r) in enumerate(zip(outs, refs)):
        if tuple(o.shape) != want or o.dtype != torch.float32:
            raise AssertionError(f"request {i}: got {tuple(o.shape)} {o.dtype}")
        if float(o.std()) == 0.0:
            raise AssertionError(f"request {i}: constant output")
        if float(r.abs().max()) >= MAX_OUTPUT:
            raise AssertionError(f"request {i}: outputs reach "
                                 f"{float(r.abs().max())}, beyond the range "
                                 f"PATH_TOL was set for")
        errs.append(check_close(f"main path {dtype_name} request {i}", o, r,
                                atol, rtol))
    rec = dict(dtype=dtype_name, requests=N_REQUESTS, launches=launches,
               kernel_p50_ms=statistics.median(k_ms), kernel_ms=list(k_ms),
               torch_p50_ms=statistics.median(t_ms), torch_ms=list(t_ms),
               max_abs_err=max(errs), tol=[atol, rtol],
               max_abs_output=max(float(r.abs().max()) for r in refs))
    say(phase="main_path", **rec)
    return rec, kernel_predict


def profile_request(predict, frames, phase="profile"):
    """torch.profiler over one request: device time by kernel name. One
    traced warm-up request comes first and is discarded: the first launches
    after tracing starts can be missing from the trace."""
    from torch.profiler import ProfilerActivity, profile, schedule
    predict(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        predict(frames)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        predict(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        # aten:: rows repeat the device time of the kernels they launch, and
        # the ProfilerStep# row that of the whole step
        if dev_us > 0 and not ev.key.startswith(("aten::", "ProfilerStep")):
            rows.append((ev.key, ev.count, dev_us / 1e3))
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    traced = {name: sum(n for k, n, _ in rows if name in k)
              for name in ("convlstm_cell", "conv_head")}
    say(phase=phase, wall_ms=wall * 1e3, device_busy_ms=busy,
        idle_share=max(0.0, 1 - busy / (wall * 1e3)), traced_launches=traced,
        top=[[k[:100], n, round(ms, 4)] for k, n, ms in rows[:8]])


def reset_counts():
    convlstm_cell_fwd.launches = 0
    conv_head_fwd.launches = 0


def expect_counts(what, k1, k2):
    """Raise unless K1 and K2 launched exactly k1 and k2 times since the
    last reset_counts(); returns the counts."""
    got = {"convlstm_cell_fwd": convlstm_cell_fwd.launches,
           "conv_head_fwd": conv_head_fwd.launches}
    if got != {"convlstm_cell_fwd": k1, "conv_head_fwd": k2}:
        raise AssertionError(f"{what}: launches {got}, expected {k1} K1 "
                             f"and {k2} K2")
    return got


def p50_ms(fns, n=N_TIMED):
    """{name: (p50 ms, [ms...])} of each fn over n calls taken in turns,
    after one warm-up call each. A call's time runs from an event recorded
    before it to one after its last launch, so it holds the host's launch
    cost wherever the device waits for it."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(n):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: (statistics.median(ts), ts) for name, ts in times.items()}


def steps_bound_ms(b, hgt, wid, cin, hidden, dtype_name, steps, k=3):
    """bound() summed over `steps` steps of K1 per cell and K2 for the head,
    counted as phase_cell and phase_head count one launch."""
    elem = 2 if dtype_name == "bfloat16" else 4
    px = b * hgt * wid
    per_step, cx = 0.0, cin
    for ch in hidden:
        flops = 2 * px * k * k * (cx + ch) * 4 * ch
        nbytes = elem * (px * cx + 4 * px * ch + k * k * (cx + ch) * 4 * ch
                         + 4 * ch)
        per_step += bound(flops, nbytes, dtype_name)[0]
        cx = ch
    flops = 2 * px * 9 * cx * cin
    nbytes = elem * (px * cx + 9 * cx * cin + cin + px * cin)
    per_step += bound(flops, nbytes, dtype_name)[0]
    return steps * per_step


def conv_step_fn(b, hgt, wid, cin, hidden, dtype, k=3):
    """One step's convs as library calls (one F.conv2d per cell over
    concat(x, h) and one for the head, channels-last, without the gates):
    the yardstick beside a rollout, which no one PyTorch call computes."""
    convs, cx = [], cin
    for ch in hidden:
        xh = torch.randn(b, hgt, wid, cx + ch, device="cuda", dtype=dtype)
        convs.append((xh.permute(0, 3, 1, 2),
                      torch.randn(4 * ch, cx + ch, k, k, device="cuda",
                                  dtype=dtype),
                      torch.randn(4 * ch, device="cuda", dtype=dtype), k // 2))
        cx = ch
    h = torch.randn(b, hgt, wid, cx, device="cuda", dtype=dtype)
    convs.append((h.permute(0, 3, 1, 2),
                  torch.randn(cin, cx, 3, 3, device="cuda", dtype=dtype),
                  torch.randn(cin, device="cuda", dtype=dtype), 1))
    return lambda: [F.conv2d(x, w, bias, padding=p) for x, w, bias, p in convs]


def states_equal(a, b):
    return (len(a.cells) == len(b.cells) and torch.equal(a.prev_out, b.prev_out)
            and all(torch.equal(x, y) for pa, pb in zip(a.cells, b.cells)
                    for x, y in zip(pa, pb)))


def clone_state(state):
    return type(state)(tuple((h.clone(), c.clone()) for h, c in state.cells),
                       state.prev_out.clone())


def stream_pair(name, dtype_name, ckpt):
    """(the config with rollout_impl auto, the streaming forecaster on the
    kernels, the one on the plain modules: rollout_impl torch)."""
    cfgs = []
    for impl in ("auto", "torch"):
        cfg = load_config(name)
        cfg.precision.compute_dtype = dtype_name
        cfg.model.rollout_impl = impl
        cfg.validate()
        cfgs.append(cfg)
    return (cfgs[0], StreamingForecaster.from_checkpoint(cfgs[0], ckpt),
            StreamingForecaster.from_checkpoint(cfgs[1], ckpt))


def check_forecast_vs_plain(what, sf, sf_plain, state, horizon, dtype_name):
    """forecast(horizon) on the kernels against the plain modules from the
    same carried state; checks the launch counts; returns the max error."""
    n_cells = len(state.cells)
    reset_counts()
    out = sf.forecast(state, horizon)
    expect_counts(f"{what} forecast({horizon})", n_cells * horizon, horizon)
    ref = sf_plain.forecast(state, horizon)
    b, hgt, wid, chans = state.prev_out.shape
    want = (b, horizon, chans, hgt, wid)
    if tuple(out.shape) != want or out.dtype != torch.float32:
        raise AssertionError(f"{what}: got {tuple(out.shape)} {out.dtype}")
    if float(out.std()) == 0.0:
        raise AssertionError(f"{what}: constant output")
    if float(ref.abs().max()) >= MAX_OUTPUT:
        raise AssertionError(f"{what}: outputs reach {float(ref.abs().max())}"
                             f", beyond the range PATH_TOL was set for")
    return check_close(what, out, ref, *PATH_TOL[dtype_name])


def phase_stream(ckpt, dtype_name, request, frames8):
    """The streaming path on nowcast_128 (see the module docstring, 5).
    Returns its record; the launch counts of the stream path's own run (the
    first request observed and forecast to the batch horizon) under
    "launches"."""
    cfg, sf, sf_plain = stream_pair("nowcast_128", dtype_name, ckpt)
    n_cells = len(cfg.model.hidden_dims)
    t_in, t_out = cfg.model.input_frames, cfg.model.output_frames
    b, _, cin, hgt, wid = request.shape
    batch = load_predictor(cfg, ckpt)(request)
    atol, rtol = PATH_TOL[dtype_name]

    reset_counts()
    state, nowcast = sf.observe_window(sf.init_state(b, hgt, wid), request)
    expect_counts("observe_window", n_cells * t_in, t_in)
    rest = sf.forecast(state, t_out - 1)
    launches = expect_counts("observe_window + forecast",
                             n_cells * (t_in + t_out - 1), t_in + t_out - 1)
    rollout = torch.cat([nowcast[:, None], rest], 1)
    err_batch = check_close(f"stream {dtype_name} vs batch", rollout, batch,
                            atol, rtol)

    frame_state = sf.init_state(b, hgt, wid)
    for t in range(t_in):
        reset_counts()
        frame_state, frame_now = sf.observe(frame_state, request[:, t])
        expect_counts(f"observe frame {t}", n_cells, 1)
    if not (torch.equal(frame_now, nowcast)
            and states_equal(frame_state, state)):
        raise AssertionError(f"stream {dtype_name}: frame-by-frame observe "
                             f"differs from observe_window")

    before = clone_state(state)
    reset_counts()
    again = sf.forecast(state, t_out - 1)
    expect_counts(f"forecast({t_out - 1})", n_cells * (t_out - 1), t_out - 1)
    if not torch.equal(again, rest):
        raise AssertionError(f"stream {dtype_name}: two forecasts from one "
                             f"state differ")
    if not states_equal(state, before):
        raise AssertionError(f"stream {dtype_name}: forecast wrote its state")

    per_batch = []
    horizon = STREAM_HORIZON
    for nb in STREAM_BATCHES:
        warm, _ = sf.observe_window(sf.init_state(nb, hgt, wid), frames8[:nb])
        err = check_forecast_vs_plain(f"stream {dtype_name} B {nb}", sf,
                                      sf_plain, warm, horizon, dtype_name)
        frame = frames8[:nb, -1]
        times = p50_ms({
            "observe": lambda: sf.observe(warm, frame),
            "observe_plain": lambda: sf_plain.observe(warm, frame),
            "forecast": lambda: sf.forecast(warm, horizon),
            "forecast_plain": lambda: sf_plain.forecast(warm, horizon),
            "conv_step": conv_step_fn(nb, hgt, wid, cin, cfg.model.hidden_dims,
                                      warm.prev_out.dtype)})
        per_batch.append(dict(
            batch=nb, horizon=horizon, max_abs_err=err,
            forecast_ms=times["forecast"][0],
            forecast_plain_ms=times["forecast_plain"][0],
            forecast_bound_ms=steps_bound_ms(nb, hgt, wid, cin,
                                             cfg.model.hidden_dims,
                                             dtype_name, horizon),
            forecast_launches=[n_cells * horizon, horizon],
            forecast_library_ms=horizon * times["conv_step"][0],
            observe_ms=times["observe"][0],
            observe_plain_ms=times["observe_plain"][0],
            observe_bound_ms=steps_bound_ms(nb, hgt, wid, cin,
                                            cfg.model.hidden_dims,
                                            dtype_name, 1),
            forecast_ms_all=times["forecast"][1],
            forecast_plain_ms_all=times["forecast_plain"][1]))
        if nb == 1:
            warm_b1 = warm
    rec = dict(dtype=dtype_name, launches=launches,
               max_abs_err_vs_batch=err_batch,
               bit_identical_to_batch=bool(torch.equal(rollout, batch)),
               frame_by_frame_equal=True, forecast_pure=True,
               tol=[atol, rtol], per_batch=per_batch)
    say(phase="stream", **rec)
    return rec, sf, warm_b1


def phase_precip_256(tmp, seed):
    """precip_256 through the same streaming code: bf16, B 1, 256x256."""
    dtype_name = "bfloat16"
    cfg = load_config("precip_256")
    ckpt = write_checkpoint(os.path.join(tmp, "precip_256_seed.npz"), cfg,
                            seed)
    cfg, sf, sf_plain = stream_pair("precip_256", dtype_name, ckpt)
    n_cells = len(cfg.model.hidden_dims)
    size, t_in = cfg.data.synthetic_image_size, cfg.model.input_frames
    frames = torch.from_numpy(np.random.default_rng(seed).random(
        (1, t_in, cfg.model.in_channels, size, size),
        dtype=np.float32)).cuda()
    reset_counts()
    warm, _ = sf.observe_window(sf.init_state(1, size, size), frames)
    expect_counts("precip_256 observe_window", n_cells * t_in, t_in)
    err = check_forecast_vs_plain("precip_256 B 1", sf, sf_plain, warm,
                                  STREAM_HORIZON, dtype_name)
    times = p50_ms({"forecast": lambda: sf.forecast(warm, STREAM_HORIZON),
                    "forecast_plain": lambda: sf_plain.forecast(
                        warm, STREAM_HORIZON)})
    say(phase="precip_256", dtype=dtype_name, batch=1, size=size,
        hidden=list(cfg.model.hidden_dims), horizon=STREAM_HORIZON,
        max_abs_err=err, tol=list(PATH_TOL[dtype_name]),
        forecast_ms=times["forecast"][0],
        forecast_plain_ms=times["forecast_plain"][0],
        forecast_bound_ms=steps_bound_ms(1, size, size, cfg.model.in_channels,
                                         cfg.model.hidden_dims, dtype_name,
                                         STREAM_HORIZON),
        forecast_ms_all=times["forecast"][1],
        forecast_plain_ms_all=times["forecast_plain"][1])


def write_checkpoint(path, cfg, seed):
    """nowcast_params(cfg, seed) as the README's .npz of flattened flax
    params; checks that weights.py maps every entry."""
    params = nowcast_params(cfg, seed)
    flat = {f"params/core/{m}/{leaf}": v
            for m, d in params["params"]["core"].items()
            for leaf, v in d.items()}
    np.savez(path, **flat)
    if set(flax_to_state_dict(flat)) != {
            f"core.{m}.{leaf}" for m in params["params"]["core"]
            for leaf in ("weight", "bias")}:
        raise AssertionError("weights.py does not map every parameter")
    return path


def kernel_entries(cell, head, paths, streams, n_cells):
    """The {"kernels": [...]} records, one per kernel and compute dtype. K1's
    times and bound are per launch, averaged over one request's mix of cell
    shapes (cell 1: (1, 64); cells 2-3: (64, 64))."""
    entries = []
    for name, path in paths.items():
        c_recs = [r for r in cell[name] if "ms" in r]
        weights = [1, n_cells - 1]
        mix = lambda key: sum(w * r[key] for w, r in zip(weights, c_recs)) / sum(weights)
        entries.append(dict(
            name="convlstm_cell_fwd", dtype=name, route="cuda", source=K1_SOURCE,
            replaces=K1_REPLACES, stands_for=K1_STANDS_FOR,
            launches=path["launches"]["convlstm_cell_fwd"],
            launches_by_path={
                "predict": path["launches"]["convlstm_cell_fwd"],
                "stream": streams[name]["launches"]["convlstm_cell_fwd"]},
            max_abs_err=max(r["max_abs_err"] for r in cell[name]),
            ms=mix("ms"), plain_ms=mix("plain_ms"), bound_ms=mix("bound_ms"),
            bound_by=c_recs[0]["bound_by"], library_ms=mix("library_ms"),
            per_shape=c_recs))
        h = [r for r in head[name] if "ms" in r][0]
        entries.append(dict(
            name="conv_head_fwd", dtype=name, route="cuda", source=K2_SOURCE,
            replaces=K2_REPLACES, stands_for=K2_STANDS_FOR,
            launches=path["launches"]["conv_head_fwd"],
            launches_by_path={
                "predict": path["launches"]["conv_head_fwd"],
                "stream": streams[name]["launches"]["conv_head_fwd"]},
            max_abs_err=max(r["max_abs_err"] for r in head[name]),
            ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=h["library_ms"]))
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1
    # float32 references in full float32 (cuDNN convs default to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(phase="env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dtypes = (torch.float32, torch.bfloat16)
    cfg = load_config("nowcast_128")
    b, size = cfg.training.batch_size, 128
    hidden = cfg.model.hidden_dims
    cell_shapes = [(b, size, size, cfg.model.in_channels, hidden[0], 3, True),
                   (b, size, size, hidden[0], hidden[1], 3, True),
                   (2, 13, 21, 3, 40, 5, False)]           # ragged, K=5
    head_shapes = [(b, size, size, hidden[-1], cfg.model.in_channels, 3, True),
                   (2, 13, 21, 40, 5, 3, False)]           # ragged, Cout=5
    cell = phase_cell(gen, cell_shapes, dtypes)
    head = phase_head(gen, head_shapes, dtypes)

    rng = np.random.default_rng(SEED)
    requests = [torch.from_numpy(rng.random(
        (b, cfg.model.input_frames, cfg.model.in_channels, size, size),
        dtype=np.float32)).cuda() for _ in range(N_REQUESTS)]
    frames8 = torch.from_numpy(rng.random(
        (max(STREAM_BATCHES), cfg.model.input_frames, cfg.model.in_channels,
         size, size), dtype=np.float32)).cuda()
    paths, streams = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = write_checkpoint(os.path.join(tmp, "nowcast_128_seed.npz"),
                                cfg, SEED)
        for dtype_name in ("float32", "bfloat16"):
            paths[dtype_name], predict = phase_main_path(ckpt, dtype_name,
                                                         requests)
        profile_request(predict, requests[0])
        for dtype_name in ("float32", "bfloat16"):
            streams[dtype_name], sf, warm_b1 = phase_stream(
                ckpt, dtype_name, requests[0], frames8)
        profile_request(lambda st: sf.forecast(st, STREAM_HORIZON), warm_b1,
                        phase="stream_profile")
        phase_precip_256(tmp, SEED)

    print(json.dumps({"kernels": kernel_entries(cell, head, paths, streams,
                                                 len(hidden))}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
