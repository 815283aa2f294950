"""Share of the path tracer's wave slots that carry a live ray, %: the
program's counters ``wavefront.live`` (active extend rays plus valid
shadow rays) over ``wavefront.slots`` (rays handed to a cast), summed over
the traced frames (the profiler's start-up frame too: a ratio, so it does
not bias it).  None where the program keeps no such counters."""


def read(ctx):
    try:
        from messyerraytracer_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    if ctx.trace is None:
        return None
    c = counters()
    if not c.get("wavefront.slots"):
        return None
    return 100.0 * c.get("wavefront.live", 0) / c["wavefront.slots"]
