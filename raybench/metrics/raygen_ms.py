"""Device ms per frame of the kernels launched in the range
``raybench.raygen`` (camera rays and the block swizzle)."""


def read(ctx):
    t = ctx.trace
    if (t is None or not t.units or t.busy_us <= 0
            or t.device_ms("raybench.raygen") is None):
        return None
    return t.device_ms("raybench.raygen") / t.units
