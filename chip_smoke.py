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
5. one JSON line {"kernels": [...]} with each kernel's launches, error, and
   its time beside its bound, its plain version's and the library call's;
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


def profile_request(predict, frames):
    """torch.profiler over one request: device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    predict(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        # aten:: rows repeat the device time of the kernels they launch
        if dev_us > 0 and not ev.key.startswith("aten::"):
            rows.append((ev.key, ev.count, dev_us / 1e3))
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    say(phase="profile", wall_ms=wall * 1e3, device_busy_ms=busy,
        idle_share=max(0.0, 1 - busy / (wall * 1e3)),
        top=[[k[:100], n, round(ms, 4)] for k, n, ms in rows[:8]])


def kernel_entries(cell, head, paths, n_cells):
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
            replaces=K1_REPLACES, launches=path["launches"]["convlstm_cell_fwd"],
            max_abs_err=max(r["max_abs_err"] for r in cell[name]),
            ms=mix("ms"), plain_ms=mix("plain_ms"), bound_ms=mix("bound_ms"),
            bound_by=c_recs[0]["bound_by"], library_ms=mix("library_ms"),
            per_shape=c_recs))
        h = [r for r in head[name] if "ms" in r][0]
        entries.append(dict(
            name="conv_head_fwd", dtype=name, route="cuda", source=K2_SOURCE,
            replaces=K2_REPLACES, launches=path["launches"]["conv_head_fwd"],
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
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "nowcast_128_seed.npz")
        params = nowcast_params(cfg, SEED)
        flat = {f"params/core/{m}/{leaf}": v
                for m, d in params["params"]["core"].items()
                for leaf, v in d.items()}
        np.savez(ckpt, **flat)
        assert set(flax_to_state_dict(flat)) == {
            f"core.{m}.{leaf}" for m in params["params"]["core"]
            for leaf in ("weight", "bias")}
        for dtype_name in ("float32", "bfloat16"):
            paths[dtype_name], predict = phase_main_path(ckpt, dtype_name,
                                                         requests)
        profile_request(predict, requests[0])

    print(json.dumps({"kernels": kernel_entries(cell, head, paths,
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
