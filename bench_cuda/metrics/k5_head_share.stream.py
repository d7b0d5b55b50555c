"""Block 0's time in K5's head tiles over its stamped time, summed over
the device stretch's K5 launches (``rollout_kernel.stamp_phases``), %."""
from bench_cuda import program


def read(rec):
    phases = program.device_k5_phases(rec)
    if not phases:
        return None
    total = sum(p["total_us"] for p in phases)
    return 100.0 * sum(p["work_us"].get("head", 0.0) for p in phases) / \
        total if total else None
