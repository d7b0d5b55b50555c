"""Device kernels a step in the device stretch (copies and sets not
counted), a count."""


def read(rec):
    n = sum(1 for _, _, _, kernel in rec.device if kernel)
    return n / rec.info["units"] if n and rec.info.get("units") else None
