"""K8 (TrajGRU's warp, ``csrc/traj_warp.cu``): its bytes a step
(``flops_trajgru.k8_step_bytes``) at 3.35 TB/s over its device time a
step, %. K8's kernels are found by name in the device stretch; nothing is
read where their count differs from the program's ``traj_warp.launches``
over the stretch's steps (a program without that counter, or launches the
trace missed)."""
from bench_cuda.flops import HBM_BYTES_PER_S

NAME = "traj_warp_"


def read(rec):
    launches, units = rec.info.get("k8_launches"), rec.info.get("units")
    kernels = [e - s for name, s, e, kernel in rec.device
               if kernel and NAME in name]
    if not kernels or not units or launches != len(kernels):
        return None
    bound_us = rec.info["k8_unit_bytes"] / HBM_BYTES_PER_S * 1e6
    return 100.0 * bound_us / (sum(kernels) / units)
