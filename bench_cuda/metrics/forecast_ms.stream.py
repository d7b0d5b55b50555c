"""Median device time of ``StreamingForecaster.forecast`` in the traced
stretch: CUDA events around each call, ms."""
import statistics


def read(rec):
    times = rec.event_ms.get("forecast")
    return statistics.median(times) if times else None
