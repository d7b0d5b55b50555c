"""Run artifacts of the trainer as strict JSON, a copy of the JAX package's
``utils/metrics_log.py``: one line per epoch in ``<output_dir>/metrics.jsonl``
and the whole ``history.json``, with non-finite floats written as null (bare
NaN/Infinity tokens break non-Python readers), written by rank 0 alone
under data parallelism (the metrics are the same on every rank). A
checkpoint's ``host_state.json`` keeps exact values instead."""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict

# the JAX package's name: whether this process owns the run's files
from ..parallel.mesh import is_primary as is_primary_host


def sanitize_json(obj: Any) -> Any:
    """Recursively replace non-finite floats with None."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    return obj


def append_metrics_line(output_dir: str, record: Dict[str, Any]) -> None:
    """Append one strict-JSON line to <output_dir>/metrics.jsonl (rank 0)."""
    if not is_primary_host():
        return
    with open(os.path.join(output_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(sanitize_json(record)) + "\n")


def dump_history(output_dir: str, history: Dict[str, Any]) -> None:
    """Write <output_dir>/history.json as strict JSON (rank 0)."""
    if not is_primary_host():
        return
    with open(os.path.join(output_dir, "history.json"), "w") as f:
        json.dump(sanitize_json(history), f)
