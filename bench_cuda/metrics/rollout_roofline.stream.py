"""The request's least time (``flops.stream_request``: observe of a frame
and forecast(30), each bounded as one function at 989 TFLOP/s against its
bytes at 3.35 TB/s) over the device time a request in the device stretch
(the union of all device intervals over the requests run), %."""
from bench_cuda.trace import device_us_per_unit


def read(rec):
    us = device_us_per_unit(rec)
    return 100.0 * rec.info["unit_bound_ms"] * 1e3 / us if us else None
