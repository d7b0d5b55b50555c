"""1 - (the union of device intervals / the traced window), %."""
from bench_cuda.trace import idle_share


def read(rec):
    return idle_share(rec)
