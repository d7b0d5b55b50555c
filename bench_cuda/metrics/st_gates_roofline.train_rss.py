"""K7 (the ST-LSTM gate passes, ``csrc/st_lstm_gates.cu``): its bytes a
step (``flops_predrnn.k7_step_bytes``) at 3.35 TB/s over its device time a
step, %. K7's kernels are found by name in the device stretch; nothing is
read where their count differs from the program's ``st_gates.launches``
over the stretch's steps (a program without that counter, or launches the
trace missed)."""
from bench_cuda.flops import HBM_BYTES_PER_S

NAME = "st_gates_"


def read(rec):
    launches, units = rec.info.get("k7_launches"), rec.info.get("units")
    kernels = [e - s for name, s, e, kernel in rec.device
               if kernel and NAME in name]
    if not kernels or not units or launches != len(kernels):
        return None
    bound_us = rec.info["k7_unit_bytes"] / HBM_BYTES_PER_S * 1e6
    return 100.0 * bound_us / (sum(kernels) / units)
