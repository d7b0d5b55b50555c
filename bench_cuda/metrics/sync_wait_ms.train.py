"""The host's wait at a train step's syncs (the summed durations of the
program's ``plcg.sync.*`` spans of a ``plcg.train.step``), median over the
steps of the device stretch, ms."""
import statistics

from bench_cuda import program


def read(rec):
    spans = program.device_spans(rec) or []
    steps = {s.id: 0.0 for s in program.named(spans, "train.step")}
    for s in spans:
        if s.name.startswith(program.PREFIX + "sync.") and s.root in steps:
            steps[s.root] += s.duration_ns / 1e6
    return statistics.median(steps.values()) if steps else None
