"""Median device time of ``StreamingForecaster.observe`` in the traced
stretch: CUDA events around each call, ms."""
import statistics


def read(rec):
    times = rec.event_ms.get("observe")
    return statistics.median(times) if times else None
