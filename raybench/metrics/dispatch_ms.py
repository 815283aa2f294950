"""Device ms per unit of work of the kernels launched in the port's
``morton.*`` ranges (sort keys, sort, gather, unshuffle)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units or t.busy_us <= 0:
        return None
    ms = t.device_ms_prefix("morton.")
    return None if ms is None else ms / t.units
