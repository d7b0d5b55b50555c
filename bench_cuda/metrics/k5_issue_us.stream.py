"""Median time of the host's issue of K5 (the program's span
``plcg.k5.issue``: ``rollout_persistent_fwd`` from its entry to the
return of the launch) in the device stretch, µs."""
from bench_cuda import program


def read(rec):
    return program.median_us(program.device_spans(rec), "k5.issue")
