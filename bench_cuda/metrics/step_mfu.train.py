"""The train step's model operations (``flops.train_step_flops``: the
forward's convolutions x 3, global batch) over its median wall time on the
host clock x chips x the peak of the step's matrix work (989 TFLOP/s for
bf16; 495 for float32, run as TF32 where cuDNN may), %."""
from bench_cuda.trace import median_unit_s


def read(rec):
    wall = median_unit_s(rec)
    if not wall:
        return None
    return 100.0 * rec.info["unit_flops"] / (
        wall * rec.info["chips"] * rec.info["peak_flops"])
