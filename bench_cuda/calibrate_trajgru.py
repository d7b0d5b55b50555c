"""The readings the limits of ``trajgru_hko7_bf16.train_hko`` are set from,
on the chip at the cell's own size (``limits/<cell>.json``; the
benchmark's runs never run this), as ``calibrate`` does for the other cells:

- ``program``: the program's sound runs, one short window a seed;
- ``control``: the reference put in the program's place and computed in
  fp8 (``reference.convlstm.rounding``: e4m3 operands and stored values,
  e5m2 gradients; the precision below the configuration's bf16), held
  against the float32 reference the same way;
- ``fault.<name>``: the program with a fault planted (``FAULTS``):
  ``unchanged`` (no update of the parameters or of Adam's state),
  ``half_batch`` (the loss of half the batch), ``zero_flows`` (every warp
  with zero flows: L copies of the state, the learned links gone) and
  ``nearest_warp`` (every warp at the flows rounded to whole pixels: no
  bilinear weights, no gradient to the flows).

    python -m bench_cuda.calibrate_trajgru --workload \
        trajgru_hko7_bf16.train_hko --seeds 1,2,3 --control-seeds 4,5 \
        --fault-seeds 7,8 --seconds 5

One JSON line a reading on standard output.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

from bench_cuda import checks, data, faults, harness
from bench_cuda.calibrate import _say, summary
from bench_cuda.drivers import train_trajgru
from bench_cuda.reference import convlstm as ref_convlstm
from bench_cuda.reference import train as ref_train
from bench_cuda.reference import trajgru as ref_trajgru

FAULTS = ("unchanged", "half_batch", "zero_flows", "nearest_warp")


@contextlib.contextmanager
def planted(name):
    """Within: the program with fault ``name`` (None: as it is)."""
    if name in (None, "unchanged", "half_batch"):
        with faults.planted(name):
            yield
        return
    from pl_convlstm_gan_tpu_torch.models import trajgru
    warp = trajgru.traj_warp
    if name == "zero_flows":
        trajgru.traj_warp = lambda h, flows: warp(h, flows * 0)
    elif name == "nearest_warp":
        trajgru.traj_warp = lambda h, flows: warp(h, flows.round())
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        trajgru.traj_warp = warp


def program(cell, seed, seconds, fault=None, device="cuda"):
    clock = harness.Clock(time.perf_counter())
    with planted(fault):
        out = train_trajgru.run(cell, seed, seconds, False, clock, device)
    return out.readings, out.attempted, summary(out.detail or {})


def control(cell, seed, device="cuda", detail=None):
    """The reference in fp8 in the program's place, from the seed's
    weights, three steps, each held against the float32 reference from the
    control's own state."""
    cfg, mix = cell.config, cell.mix
    q = ref_convlstm.rounding("fp8")
    weights = data.weights(seed, train_trajgru.param_shapes(cfg), device)
    pool = train_trajgru.make_pool(cfg, mix, seed, device)
    t = cfg["training"]
    state = ref_train.TrainState.fresh(weights)
    snaps, losses = [], []
    with harness.reference_numerics():
        for k in range(train_trajgru.CHECKED_STEPS):
            snaps.append({"params": state.params, "exp_avg": state.exp_avg,
                          "exp_avg_sq": state.exp_avg_sq,
                          "step": state.step})
            loss, _, state = ref_trajgru.train_step(
                cfg["model"], state, pool[k], t["learning_rate"],
                t["grad_clip_norm"], q, rows=mix.get("ref_rows"))
            losses.append(loss)
    snaps.append({"params": state.params, "exp_avg": state.exp_avg,
                  "exp_avg_sq": state.exp_avg_sq, "step": state.step})
    refs = train_trajgru.reference_steps(cfg, mix, snaps, pool,
                                         ref_convlstm.rounding("f32"))
    return checks.train_readings(snaps, losses, refs, detail)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="trajgru_hko7_bf16.train_hko")
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    harness.cache_dirs()
    cell = harness.find_cell(args.workload, harness.load_manifest())
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    for seed in seeds(args.seeds):
        readings, n, detail = program(cell, seed, args.seconds)
        _say("program", cell, seed, readings, attempted=n, detail=detail)
    for seed in seeds(args.control_seeds):
        detail = {}
        readings = control(cell, seed, detail=detail)
        _say("control", cell, seed, readings, detail=summary(detail))
    for seed in seeds(args.fault_seeds):
        for name in FAULTS:
            readings, _, detail = program(cell, seed, args.seconds,
                                          fault=name)
            _say(f"fault.{name}", cell, seed, readings, detail=detail)
    return 0


if __name__ == "__main__":
    sys.exit(main())
