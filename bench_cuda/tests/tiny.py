"""The benchmark's cells at sizes a CPU test holds: the same configuration,
precision, mix and driver, with narrower cells, smaller frames and fewer
frames, run on the program's plain paths on CPU tensors."""
from __future__ import annotations

import copy
import time

from bench_cuda import faults, harness

SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold

# a cell whose files are kept while BENCHMARK.json leaves it out (PERF.md,
# Open questions): its configuration and mix found by its name alone
KEPT = {"generator_default.train"}


def _cell(name: str) -> harness.Cell:
    if name not in KEPT:
        return harness.find_cell(name, harness.load_manifest())
    config, mix = name.split(".", 1)
    return harness.Cell(name, harness._read("configs", f"{config}.json"),
                        harness._read("mixes", f"{mix}.json"), 1, [], [])


def cell(name: str) -> harness.Cell:
    c = copy.deepcopy(_cell(name))
    m, mix = c.config["model"], c.mix
    if c.config["family"] == "forecaster":
        m.update(hidden_dims=[8, 8], image_size=32, output_frames=4)
        if mix["driver"] == "stream":
            mix.update(horizon=3, warmup_requests=2, compare_rate=0.25,
                       frame_pool=8, trace_requests=4)
        else:
            c.config["training"]["batch_size"] = 2
            mix.update(pool=4, warmup_steps=1, trace_steps=2, ref_rows=2)
    else:
        m.update(hidden_dims=[8, 8], image_size=4, T=3)
        c.config["training"]["batch_size"] = 4
        mix.update(pool=4, warmup_steps=1, trace_steps=2)
    return c


def run(name: str, seconds: float = 0.5, fault=None, seed: int = SEED
        ) -> harness.Outcome:
    """One tiny run on the CPU, with ``fault`` planted."""
    c = cell(name)
    clock = harness.Clock(time.perf_counter())
    with faults.planted(fault):
        return harness.driver(c.mix).run(c, seed, seconds, False, clock,
                                         device="cpu")
