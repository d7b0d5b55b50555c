"""The program's own trace, as the readers of its spans and counters
(``metrics/<name>.py``) find it in a ``--trace 1`` run.

The program logs its spans (``plcg.*``) and K5's per-phase stamps in
memory while any ``torch.profiler`` runs (``pl_convlstm_gan_tpu_torch.
utils.profiling``), so both stretches of ``trace.traced`` fill its log,
stamped on the clock of the profiler's events. A span belongs to the
device stretch when it lies within that stretch's wall time before its
last device interval ends and ends before the host stretch's window opens
(``rec.host.info["t0_us"]``), to the host stretch when it lies inside that
window. A program that keeps no such log (``program_log`` missing) gives
every reader here nothing to read: None, never an error.
"""
from __future__ import annotations

import bisect
import statistics
from typing import List, Optional, Tuple

PREFIX = "plcg."
# the host calls that each put one piece of work on the device: a kernel,
# a copy or a set (runtime and driver API)
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                "cudaMemset", "cuMemset")
# device work and launch calls may differ in count by one in this many
# calls for the pairing by order (``launched_device_us``)
MISMATCH_PER = 1000


def log():
    """The program's log of this process, or None."""
    try:
        from pl_convlstm_gan_tpu_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, "program_log", None)
    return get() if get else None


def _host_window_ns(rec) -> Optional[Tuple[float, float]]:
    host = rec.host
    if host is None or "t0_us" not in host.info:
        return None
    return host.info["t0_us"] * 1e3, host.info["t1_us"] * 1e3


def _device_window_ns(rec) -> Tuple[Optional[float], Optional[float]]:
    """(from, to) of the device stretch in ns: from its wall time before
    its last device interval's end (less a millisecond), to the host
    stretch's opening; None where the records do not say."""
    host, wall = _host_window_ns(rec), rec.info.get("wall_s")
    lo = None
    if rec.device and wall:
        lo = (max(e for _, _, e, _ in rec.device) - wall * 1e6 - 1e3) * 1e3
    return lo, host[0] if host else None


def device_spans(rec):
    """The program's spans of the device stretch, or None."""
    lg = log()
    if lg is None:
        return None
    return lg.between(*_device_window_ns(rec))


def host_spans(rec):
    """The program's spans of the host stretch, or None."""
    lg, win = log(), _host_window_ns(rec)
    if lg is None or win is None:
        return None
    return lg.between(*win)


def device_k5_phases(rec):
    """``stamp_phases`` of each K5 launch of the device stretch, or None."""
    lg = log()
    if lg is None or not hasattr(lg, "k5_phases"):
        return None
    return lg.k5_phases(*_device_window_ns(rec)) or None


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == PREFIX + name]


def median_us(spans, name: str) -> Optional[float]:
    """Median duration of the spans ``plcg.<name>``, µs."""
    ds = [s.duration_ns / 1e3 for s in named(spans or [], name)]
    return statistics.median(ds) if ds else None


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted unions of intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_program(rec) -> Optional[float]:
    """% of the device stretch's wall time in which no device interval is
    active (the same intervals as ``idle_share``) while the host is inside
    a top-level program span."""
    spans, wall = device_spans(rec), rec.info.get("wall_s")
    if not spans or not rec.device or not wall:
        return None
    inside = _union((s.start_ns / 1e3, s.end_ns / 1e3) for s in spans
                    if s.parent == -1)
    busy = _union((s, e) for _, s, e, _ in rec.device)
    idle_us = sum(e - s for s, e in inside) - _overlap(inside, busy)
    return 100.0 * idle_us / (wall * 1e6)


def launched_device_us(rec, windows) -> Optional[float]:
    """Device µs of the kernels (not copies or sets) of ``rec`` whose
    launch call started inside one of ``windows`` (µs, on any thread).

    Records keep no link from a call to its work, so they are paired by
    order, which holds on one stream: the work of window [lo, hi) is the
    device intervals ranked from the number of calls before lo to the
    number before hi. Work whose call the trace lacks (a launch by an API
    it does not record) shifts the ranks by at most the difference of the
    two counts, so at most that many intervals are misplaced at each end
    of a window; None where the counts differ by more than one in a
    thousand calls."""
    calls = sorted(s for n, s, _ in rec.cpu if n.startswith(LAUNCH_CALLS))
    work = sorted((d for d in rec.device if not d[0].startswith(PREFIX)),
                  key=lambda d: d[1])
    if not calls or abs(len(work) - len(calls)) * MISMATCH_PER > len(calls):
        return None
    total = 0.0
    for lo, hi in windows:
        first, last = bisect.bisect_left(calls, lo), bisect.bisect_left(
            calls, hi)
        total += sum(e - s for _, s, e, kernel in work[first:last] if kernel)
    return total
