"""Host syncs a train step (the program's counter ``host_syncs``, as it
rose over each ``plcg.train.step`` span of the device stretch), median over
the steps."""
import statistics

from bench_cuda import program


def read(rec):
    steps = program.named(program.device_spans(rec) or [], "train.step")
    counts = [s.counts["host_syncs"] for s in steps
              if getattr(s, "counts", None) and "host_syncs" in s.counts]
    return float(statistics.median(counts)) if counts else None
