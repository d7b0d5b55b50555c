"""The request's operations (``flops.stream_request``) over its median wall
time on the host clock (issue to the synchronize that ends it) x 989
TFLOP/s, %."""
from bench_cuda.trace import median_unit_s


def read(rec):
    wall = median_unit_s(rec)
    if not wall:
        return None
    return 100.0 * rec.info["unit_flops"] / (wall * rec.info["peak_flops"])
