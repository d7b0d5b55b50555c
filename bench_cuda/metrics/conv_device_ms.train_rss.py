"""Device time a step of cuDNN's convolution kernels in the device stretch
(PredRNN's 5x5 and 1x1 convs: their forward, data-gradient and
weight-gradient kernels, named ``..._fprop_...``, ``..._dgrad_...`` and
``..._wgrad_...``), ms."""

KINDS = ("fprop", "dgrad", "wgrad")


def read(rec):
    units = rec.info.get("units")
    us = sum(e - s for name, s, e, kernel in rec.device
             if kernel and any(k in name for k in KINDS))
    return us / 1e3 / units if us and units else None
