"""The traced run's records, read by the per-layer metric readers
(``metrics/<name>.py``).

A ``--trace 1`` run traces two stretches of the steady state:

1. the device stretch: ``torch.profiler`` with CUDA activity alone, which
   adds little to the host's work, over the mix's ``trace_*`` units, with
   the host's clock around each unit: device busy time and idle share,
   kernels by name and count, device time a unit, wall time a unit;
2. the host stretch: CPU and CUDA activity over a few units, with the
   benchmark's spans around its calls into the program (``span``): the
   device time the profiler attributes to each operator of interest, and
   what the host was doing in each idle gap. Tracing every host operator
   slows the host several-fold, so stretch 2 gives no time or share.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "bench."
OPS_OF_INTEREST = ("aten::convolution_backward",)


@contextlib.contextmanager
def span(name: str):
    """A host span ``bench.<name>`` on the trace."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclass
class Records:
    """A traced stretch: device intervals (name, start us, end us, is a
    kernel), host spans by name, host operators (name, start, end), device
    us by operator, CUDA-event times by name (ms), host seconds a unit, the
    host stretch's records (``host``), and the facts (``info``: units,
    wall seconds, operations and bound of a unit, the peak, chips)."""
    device: List[Tuple[str, float, float, bool]] = field(default_factory=list)
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    cpu: List[Tuple[str, float, float]] = field(default_factory=list)
    op_device_us: Dict[str, float] = field(default_factory=dict)
    event_ms: Dict[str, List[float]] = field(default_factory=dict)
    unit_s: List[float] = field(default_factory=list)
    host: Optional["Records"] = None
    info: Dict[str, float] = field(default_factory=dict)

    def busy_us(self) -> float:
        """Length of the union of device intervals."""
        total, end = 0.0, float("-inf")
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            s = max(s, end)
            if e > s:
                total += e - s
                end = e
        return total

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle stretches between device intervals inside the traced
        window, longest first."""
        out, end = [], self.info.get("t0_us")
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        hi = self.info.get("t1_us")
        if end is not None and hi is not None and hi > end:
            out.append((end, hi))
        return sorted(out, key=lambda g: g[0] - g[1])


def _us(ev, which: str) -> float:
    ns = getattr(ev, f"{which}_ns", None)
    if ns is not None:
        return ns() / 1e3
    start = ev.start_us()
    return start if which == "start" else start + ev.duration_us()


def _under(ev, name: str) -> bool:
    parent = ev.cpu_parent
    while parent is not None:
        if parent.name == name:
            return True
        parent = parent.cpu_parent
    return False


class Tracer:
    """Profile a stretch: ``with Tracer(host) as t: ...``, then
    ``t.records()``; ``host`` adds CPU activity (stretch 2)."""

    def __init__(self, host: bool = False):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if host:
            acts.insert(0, torch.profiler.ProfilerActivity.CPU)
        self.host = host
        self._prof = torch.profiler.profile(activities=acts)
        self.wall_s: Optional[float] = None

    def __enter__(self):
        torch.cuda.synchronize()
        self._prof.__enter__()
        if self.host:
            with span("window_start"):
                pass
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t
        if self.host:
            with span("window_end"):
                pass
        self._prof.__exit__(*exc)
        return False

    def records(self) -> Records:
        rec = Records()
        for ev in self._prof.profiler.kineto_results.events():
            name = ev.name()
            s, e = _us(ev, "start"), _us(ev, "end")
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if not name.startswith(SPAN_PREFIX):   # not a span's shadow
                    rec.device.append((name, s, e, not name.startswith(
                        ("Memcpy", "Memset"))))
            elif name.startswith(SPAN_PREFIX):
                rec.spans.setdefault(name[len(SPAN_PREFIX):], []).append((s, e))
            else:
                rec.cpu.append((name, s, e))
        for ivs in rec.spans.values():
            ivs.sort()
        start, end = rec.spans.pop("window_start", []), rec.spans.pop(
            "window_end", [])
        if start and end:
            rec.info["t0_us"], rec.info["t1_us"] = start[0][1], end[0][0]
        if self.host:
            for ev in self._prof.events():
                if ev.name in OPS_OF_INTEREST and not _under(ev, ev.name):
                    dev = getattr(ev, "device_time_total", None)
                    if dev is None:
                        dev = ev.cuda_time_total
                    rec.op_device_us[ev.name] = rec.op_device_us.get(
                        ev.name, 0.0) + dev
        rec.info["wall_s"] = self.wall_s
        return rec


def traced(run_units, units: int, host_units: int) -> Records:
    """Trace ``run_units(n, on_unit)`` twice: ``units`` units on the device
    stretch, timing each on the host clock (``run_units`` calls
    ``on_unit()`` as each unit ends, after its synchronize), then
    ``host_units`` units on the host stretch."""
    times: List[float] = []
    with Tracer(host=False) as dev:
        last = [time.perf_counter()]

        def on_unit():
            now = time.perf_counter()
            times.append(now - last[0])
            last[0] = now
        run_units(units, on_unit)
    rec = dev.records()
    rec.unit_s = times
    rec.info["units"] = units
    with Tracer(host=True) as host:
        run_units(host_units, lambda: None)
    rec.host = host.records()
    rec.host.info["units"] = host_units
    return rec


def busy_and_window(rec: Records) -> Tuple[float, float]:
    """(device busy s, traced window s) of the device stretch."""
    return rec.busy_us() / 1e6, rec.info["wall_s"]


def idle_share(rec: Records) -> Optional[float]:
    """100 x (1 - device busy / traced window)."""
    busy, window = busy_and_window(rec)
    if not rec.device or not window:
        return None
    return 100.0 * (1.0 - busy / window)


def device_us_per_unit(rec: Records) -> Optional[float]:
    units = rec.info.get("units")
    return rec.busy_us() / units if rec.device and units else None


def median_unit_s(rec: Records) -> Optional[float]:
    return statistics.median(rec.unit_s) if rec.unit_s else None


def breakdown(rec: Records, top: int = 10) -> dict:
    """The device operations that took most time in the device stretch,
    and the longest idle gaps of the host stretch, each named by the
    innermost host operation or span running at its middle."""
    by_name: Dict[str, float] = {}
    for name, s, e, _ in rec.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, host = [], rec.host
    if host is not None:
        for lo, hi in host.gaps()[:top]:
            mid = (lo + hi) / 2
            inside = [(e - s, n) for n, s, e in host.cpu if s <= mid <= e]
            inside += [(e - s, SPAN_PREFIX + n)
                       for n, ivs in host.spans.items()
                       for s, e in ivs if s <= mid <= e]
            label = min(inside)[1] if inside else "no host operation"
            gaps.append([label[:120], (hi - lo) / 1e6])
    return {"device_ops": [[n[:120], v] for n, v in ops], "idle_gaps": gaps}
