"""What every cell shares: finding a cell's files by name, the caches inside
the checkout, the card's facts, the isolation check and the result line.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` is found as
``configs/<config>.json`` (the model and the program's settings),
``mixes/<mix>.json`` (the traffic; its ``driver`` names
``drivers/<driver>.py``), ``limits/<cell>.json`` (what decides ``correct``)
and one ``metrics/<metric>.py`` per per-layer metric.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# modules no process of the benchmark may hold: the JAX stack and the JAX
# package, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "pl_convlstm_gan_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def find_cell(name: str, manifest: dict) -> Cell:
    """The cell ``name`` with its configuration, mix and metrics; raises
    KeyError for a cell the manifest does not hold."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(work)})")
    w = work[name]

    def applies(metric):
        return name in metric.get("workloads", [name])
    e2e = [m for m in manifest["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if applies(m) and m["moves"] in e2e_names]
    return Cell(name, _read("configs", f"{w['config']}.json"),
                _read("mixes", f"{w['traffic']}.json"), int(w["chips"]),
                e2e, per_layer)


def program_config(cfg: dict):
    """The program's ``Config`` of a configuration file's sections."""
    from pl_convlstm_gan_tpu_torch.config import Config
    return Config.from_dict({k: cfg[k] for k in ("data", "model", "training",
                                                 "precision") if k in cfg})


def metric_reader(name: str) -> Callable:
    """``read(records)`` of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_cuda_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(mix: dict):
    return importlib.import_module(f"bench_cuda.drivers.{mix['driver']}")


def cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's nvcc builds already go to ``pl_convlstm_gan_tpu_torch/_build``
    there)."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(base, sub)


def process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules(names=None) -> List[str]:
    """The top-level names of ``names`` (default: the loaded modules) that
    are in ``FORBIDDEN``, compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def numerics_flags() -> Dict[str, object]:
    """The program's numerics as this process found them (never set here)."""
    import torch
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


class reference_numerics:
    """Within: TF32 off for the reference's float32 convs and products;
    the flags as found are restored after."""

    def __enter__(self):
        import torch
        self._saved = (torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        import torch
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self._saved
        return False


def device_facts(chips: int, memory_peak_bytes: int,
                 busy_s: Optional[float] = None,
                 window_s: Optional[float] = None) -> dict:
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": int(memory_peak_bytes)}
    if busy_s is not None:
        out["busy_s"], out["window_s"] = busy_s, window_s
    return out


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    """What a driver hands back: counts, the end-to-end values (untraced
    run) or the traced records, the compared readings, the peak."""
    attempted: int
    failed: int
    readings: Dict[str, float]
    memory_peak_bytes: int
    e2e: Optional[Dict[str, float]] = None
    records: object = None
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    detail: Optional[dict] = None      # how the compared numbers arose


class Clock:
    """Set-up time from the process's start; ``mark`` prints each stage's
    time on standard error."""

    def __init__(self, start: float):
        self.start = start

    def now(self) -> float:
        import time
        return time.perf_counter() - self.start

    def mark(self, what: str) -> float:
        t = self.now()
        say(f"[{t:9.3f} s] {what}")
        return t


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)

