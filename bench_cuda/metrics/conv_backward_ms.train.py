"""Device time the profiler attributes to ``aten::convolution_backward`` a
step in the host stretch (the cells' ``ConvLSTMCellFn.backward`` and the
decode's backward on cuDNN), ms."""


def read(rec):
    host = rec.host
    us = host.op_device_us.get("aten::convolution_backward") if host else None
    if not us or not host.info.get("units"):
        return None
    return us / 1e3 / host.info["units"]
