"""One reader per per-layer metric, ``<metric name>.py``, each with
``read(records) -> float | None`` (None: nothing to read in this run)."""
