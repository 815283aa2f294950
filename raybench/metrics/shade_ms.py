"""Device ms per path-traced frame of the kernels launched in the
program's ``wavefront.shade`` spans (surface fetch, the light sample, the
bounce sample and Russian roulette).  None without device time, or where
the program has no such span."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units or t.busy_us <= 0:
        return None
    ms = t.device_ms("wavefront.shade")
    return None if ms is None else ms / t.units
