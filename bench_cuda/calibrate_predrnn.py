"""The readings the limits of ``predrnn_v2_kth_bf16.train_rss`` are set
from, on the chip at the cell's own size (``limits/<cell>.json``; the
benchmark's runs never run this), as ``calibrate`` does for the other cells:

- ``program``: the program's sound runs, one short window a seed;
- ``control``: the reference put in the program's place and computed in
  fp8 (``reference.convlstm.rounding``: e4m3 operands and stored values,
  e5m2 gradients; the precision below the configuration's bf16), held
  against the float32 reference the same way;
- ``fault.<name>``: the program with a fault planted (``FAULTS``):
  ``unchanged`` (no update of the parameters or of Adam's state),
  ``half_batch`` (the loss of half the batch), ``no_zigzag`` (every step's
  layer 0 starts from a zero memory instead of the top layer's) and
  ``no_decouple`` (the decoupling weight 0).

    python -m bench_cuda.calibrate_predrnn --workload \
        predrnn_v2_kth_bf16.train_rss --seeds 1,2,3 --control-seeds 4,5 \
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
from bench_cuda.drivers import train_predrnn
from bench_cuda.reference import convlstm as ref_convlstm
from bench_cuda.reference import predrnn as ref_predrnn
from bench_cuda.reference import train as ref_train

FAULTS = ("unchanged", "half_batch", "no_zigzag", "no_decouple")


@contextlib.contextmanager
def planted(name):
    """Within: the program with fault ``name`` (None: as it is)."""
    if name in (None, "unchanged"):
        with faults.planted(name):
            yield
        return
    from pl_convlstm_gan_tpu_torch.models import predrnn
    from pl_convlstm_gan_tpu_torch.train import steps
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "half_batch":
        loss = steps.forecaster_loss

        def half(model, inputs, targets, draws=None):
            h = max(inputs.shape[0] // 2, 1)
            return loss(model, inputs[:h], targets[:h],
                        None if draws is None else draws[:, :h])
        patch(steps, "forecaster_loss", half)
    elif name == "no_zigzag":
        step, rollout = predrnn.st_lstm_step, predrnn.PredRNN.rollout
        at = {"call": 0, "layers": 1}

        def counted(self, *a, **k):
            at.update(call=0, layers=len(self.hidden_dims))
            return rollout(self, *a, **k)

        def reset(w, x, h, c, m, deltas=True):
            # a rollout's cell-steps come a step at a time, in layer order
            if at["call"] % at["layers"] == 0:
                m = m.new_zeros(m.shape)
            at["call"] += 1
            return step(w, x, h, c, m, deltas)
        patch(predrnn.PredRNN, "rollout", counted)
        patch(predrnn, "st_lstm_step", reset)
    elif name == "no_decouple":
        loss = predrnn.PredRNN.loss

        def without(self, *a, **k):
            beta, self.decouple_beta = self.decouple_beta, 0.0
            try:
                return loss(self, *a, **k)
            finally:
                self.decouple_beta = beta
        patch(predrnn.PredRNN, "loss", without)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def program(cell, seed, seconds, fault=None, device="cuda"):
    clock = harness.Clock(time.perf_counter())
    with planted(fault):
        out = train_predrnn.run(cell, seed, seconds, False, clock, device)
    return out.readings, out.attempted, summary(out.detail or {})


def control(cell, seed, device="cuda", detail=None):
    """The reference in fp8 in the program's place, from the seed's
    weights, three steps, each held against the float32 reference from the
    control's own state."""
    cfg, mix = cell.config, cell.mix
    q = ref_convlstm.rounding("fp8")
    weights = data.weights(seed, train_predrnn.param_shapes(cfg), device)
    pool = train_predrnn.make_pool(cfg, mix, seed, device)
    t = cfg["training"]
    state = ref_train.TrainState.fresh(weights)
    snaps, losses = [], []
    with harness.reference_numerics():
        for k in range(train_predrnn.CHECKED_STEPS):
            snaps.append({"params": state.params, "exp_avg": state.exp_avg,
                          "exp_avg_sq": state.exp_avg_sq,
                          "step": state.step})
            loss, _, state = ref_predrnn.train_step(
                cfg["model"], state, pool[k], t["learning_rate"],
                t["grad_clip_norm"], q, rows=mix.get("ref_rows"))
            losses.append(loss)
    snaps.append({"params": state.params, "exp_avg": state.exp_avg,
                  "exp_avg_sq": state.exp_avg_sq, "step": state.step})
    refs = train_predrnn.reference_steps(cfg, mix, snaps, pool,
                                         ref_convlstm.rounding("f32"))
    return checks.train_readings(snaps, losses, refs, detail)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="predrnn_v2_kth_bf16.train_rss")
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
