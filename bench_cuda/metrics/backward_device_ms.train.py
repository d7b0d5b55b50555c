"""Device time a step of the kernels whose launch call lies inside the
program's ``plcg.train.backward`` span, on any thread (the autograd engine
launches from its own), in the host stretch, ms. Kernel durations are not
slowed by the host stretch's CPU tracing."""
from bench_cuda import program


def read(rec):
    host, spans = rec.host, program.host_spans(rec)
    if host is None or not spans or not host.info.get("units"):
        return None
    windows = [(s.start_ns / 1e3, s.end_ns / 1e3)
               for s in program.named(spans, "train.backward")]
    if not windows:
        return None
    us = program.launched_device_us(host, windows)
    return us / 1e3 / host.info["units"] if us is not None else None
