"""Run one cell of the benchmark once and print its result line.

    python -m bench_cuda.run --workload <config>.<mix> --seed <n> \
        --seconds <s> --trace <0|1>

from the checkout root (``python bench_cuda/run.py ...`` works too). The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
which also end standard error. Exits 2 without a result when the card or
the cell's number of cards is missing, 3 when a module of the JAX stack or
of the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    __package__ = "bench_cuda"

from bench_cuda import checks, harness  # noqa: E402

START = time.perf_counter() - harness.process_age_s()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, outcome: harness.Outcome, lim: dict, correct: bool,
                trace: bool) -> dict:
    if trace:
        from bench_cuda.trace import breakdown
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"])(outcome.records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    line = {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics,
            "device": harness.device_facts(cell.chips,
                                           outcome.memory_peak_bytes,
                                           outcome.busy_s, outcome.window_s)}
    if trace:
        line["breakdown"] = breakdown(outcome.records)
    line["checks"] = checks.check_lines(outcome.readings, lim)
    return line


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_dirs()
    clock = harness.Clock(START)
    cell = harness.find_cell(args.workload, harness.load_manifest())
    lim = checks.limits(cell.name)
    drv = harness.driver(cell.mix)
    import torch
    clock.mark("torch imported")
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        harness.say(f"{cell.name} needs {cell.chips} CUDA device(s); found "
                    f"{torch.cuda.device_count()}")
        return 2
    harness.say("numerics flags as found: " + " ".join(
        f"{k}={v}" for k, v in harness.numerics_flags().items()))
    outcome = drv.run(cell, args.seed, args.seconds, bool(args.trace), clock)
    found = harness.forbidden_modules()
    if found:
        harness.say(f"modules of the JAX stack or package loaded: {found}")
        return 3
    correct = checks.judge(outcome.readings, lim) and outcome.failed == 0
    line = result_line(cell, outcome, lim, correct, bool(args.trace))
    for name, c in line["checks"].items():
        harness.say(f"check {name}: {c['value']} (limit {c['limit']}) "
                    f"{'ok' if c['value'] is not None and c['value'] <= c['limit'] else 'FAILED'}")
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
