"""Kernel B1's triangle tests a ray: the program's counters
``b1.tri_tests`` over ``b1.rays``, summed over the traced slice (the
profiler's start-up unit too: a ratio, so it does not bias it).  Beside
the frozen per-ray-exact count of ``b1_frame_roofline.json`` it shows
what B1's cluster granularity adds.  None where the program keeps no
such counters."""


def read(ctx):
    try:
        from messyerraytracer_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    if ctx.trace is None:
        return None
    c = counters()
    if not c.get("b1.rays"):
        return None
    return c.get("b1.tri_tests", 0) / c["b1.rays"]
