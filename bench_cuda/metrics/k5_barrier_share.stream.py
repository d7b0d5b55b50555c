"""Block 0's time at K5's grid barriers (from its last tile of a phase to
its exit from the barrier) over its stamped time, summed over the device
stretch's K5 launches (``rollout_kernel.stamp_phases``), %."""
from bench_cuda import program


def read(rec):
    phases = program.device_k5_phases(rec)
    if not phases:
        return None
    total = sum(p["total_us"] for p in phases)
    return 100.0 * sum(p["barrier_us"] for p in phases) / total if total \
        else None
