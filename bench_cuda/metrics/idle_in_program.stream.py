"""% of the device stretch's wall time in which the device is idle while
the host is inside a top-level program span (``plcg.stream.observe`` or
``plcg.stream.forecast``): the part of ``idle_share.stream`` that is the
program's own host path."""
from bench_cuda import program


def read(rec):
    return program.idle_in_program(rec)
