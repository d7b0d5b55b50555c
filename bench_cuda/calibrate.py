"""The readings each limit is set from, on the chip at a cell's own size
(``limits/<cell>.json``; the benchmark's runs never run this):

- ``program``: the program's sound runs, a dozen seeds or more, each a
  short window at the cell's own load (the run's own driver and compare);
- ``control``: the reference put in the program's place and computed in
  the precision below the configuration's (bf16 -> fp8, float32 ->
  bf16; ``reference.convlstm.rounding``), held against the float32
  reference the same way;
- ``int8`` (streaming): the program's own int8 serving path;
- ``fault.<name>``: the program with a fault of ``faults`` planted.

    python -m bench_cuda.calibrate --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --fault-seeds 7,8,9 --seconds 10

One JSON line a reading on standard output.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
import time
import types

from bench_cuda import checks, data, faults, harness
from bench_cuda.drivers import stream, train
from bench_cuda.reference import convlstm as ref_convlstm
from bench_cuda.reference import train as ref_train

LOWER = {"bfloat16": "fp8", "float32": "bf16"}


def _say(role, cell, seed, readings, **extra):
    print(json.dumps({"workload": cell.name, "role": role, "seed": seed,
                      "readings": readings, **extra}), flush=True)


def program(cell, seed, seconds, fault=None):
    clock = harness.Clock(time.perf_counter())
    with faults.planted(fault):
        out = harness.driver(cell.mix).run(cell, seed, seconds, False, clock)
    return out.readings, out.attempted, summary(out.detail or {})


def summary(detail: dict) -> dict:
    """The worst leaves of a training comparison, or the stream's gap by
    forecast frame (the worst request's, and the worst of each frame)."""
    out = {}
    for key in ("change_by_leaf", "grad_by_leaf"):
        if key in detail:
            worst = sorted(detail[key].items(), key=lambda kv: -kv[1])[:3]
            out[key] = worst + [("median", statistics.median(
                detail[key].values()))]
    if "rel_l2" in detail:
        out["rel_l2_max"] = max(detail["rel_l2"])
    if "by_frame" in detail:
        rows = detail["by_frame"]
        out["worst_request_by_frame"] = max(rows, key=lambda r: max(r))[::3]
        out["frame_worst"] = [max(r[t] for r in rows)
                              for t in range(0, len(rows[0]), 3)]
    if "losses" in detail:
        out["losses"] = detail["losses"]
    return out


def control(cell, seed, seconds, n_requests, device="cuda", detail=None):
    """The reference in the program's place, in the precision below."""
    cfg, mix = cell.config, cell.mix
    q = ref_convlstm.rounding(LOWER[cfg["precision"]["compute_dtype"]])
    if mix["driver"] == "stream":
        model = cfg["model"]
        prime, warm = mix["prime_frames"], mix["warmup_requests"]
        frames = stream.frames_of(seed, model, mix, device)
        weights = data.weights(
            seed, ref_convlstm.forecaster_param_shapes(model), device)
        keep = stream.kept_flags(seed, mix)
        want = {i for i in range(n_requests)
                if keep[i % stream.KEEP_SPAN]} | {n_requests - 1}
        with harness.reference_numerics():
            low = stream.replay(cfg, weights, frames, prime, warm,
                                n_requests, want, q, device)
            kept = {i: stream.to_host(
                stream.forecast_from(cfg, weights, st, prev, mix["horizon"],
                                     q),
                types.SimpleNamespace(cells=st, prev_out=prev))
                    for i, (st, prev) in low.items()}
        return stream.compare(cfg, weights, frames, prime, warm, n_requests,
                              kept, mix["horizon"], device)
    weights = data.weights(seed, train.param_shapes(cfg), device)
    pool = train.make_pool(cfg, mix, seed, device)
    t = cfg["training"]
    state = ref_train.TrainState.fresh(weights)
    snaps, losses = [], []
    with harness.reference_numerics():
        for k in range(train.CHECKED_STEPS):
            snaps.append({"params": state.params, "exp_avg": state.exp_avg,
                          "exp_avg_sq": state.exp_avg_sq,
                          "step": state.step})
            loss, _, state = ref_train.train_step(
                cfg["family"], cfg["model"], train.loss_cfg(cfg), state,
                pool[k], t["learning_rate"], t["grad_clip_norm"], q,
                rows=mix.get("ref_rows"))
            losses.append(loss)
    snaps.append({"params": state.params, "exp_avg": state.exp_avg,
                  "exp_avg_sq": state.exp_avg_sq, "step": state.step})
    refs = train.reference_steps(cfg, mix, snaps, pool,
                                 ref_convlstm.rounding("f32"))
    return checks.train_readings(snaps, losses, refs, detail)


def int8_cell(cell):
    c = copy.deepcopy(cell)
    c.config["model"]["rollout_impl"] = "int8"
    return c


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    harness.cache_dirs()
    cell = harness.find_cell(args.workload, harness.load_manifest())
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    n_requests = None
    for seed in seeds(args.seeds):
        readings, n, detail = program(cell, seed, args.seconds)
        n_requests = n_requests or n
        _say("program", cell, seed, readings, attempted=n, detail=detail)
    for seed in seeds(args.control_seeds):
        detail = {}
        readings = control(cell, seed, args.seconds, n_requests or 1000,
                           detail=detail)
        _say("control", cell, seed, readings, detail=summary(detail))
        if cell.mix["driver"] == "stream":
            readings, _, _ = program(int8_cell(cell), seed, args.seconds)
            _say("int8", cell, seed, readings)
    names = faults.STREAM if cell.mix["driver"] == "stream" else faults.TRAIN
    for seed in seeds(args.fault_seeds):
        for name in names:
            readings, _, detail = program(cell, seed, args.seconds,
                                          fault=name)
            _say(f"fault.{name}", cell, seed, readings, detail=detail)
    return 0


if __name__ == "__main__":
    sys.exit(main())
