"""Device ms per path-traced frame outside the casts and the sorts: the
device's busy time less the port's ``cast`` ranges, kernel B1 and the
``morton.*`` ranges (shading, the RNG, path state gathers and scatters)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units or t.busy_us <= 0:
        return None
    rest = (t.busy_us / 1e3 - (t.device_ms("cast") or 0.0) - t.b1_ms
            - (t.device_ms_prefix("morton.") or 0.0))
    return rest / t.units
