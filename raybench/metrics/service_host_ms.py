"""Host ms per batch inside the service, outside its stream sync: the
mean, over the traced slice's requests (the last ``units`` requests with a
``service.submit`` entry in the program's request log), of the request's
``service.submit`` interval less its ``service.wait`` interval.  None
where the program keeps no request log."""


def intervals(ctx) -> list[float] | None:
    """Each slice request's submit ms less its wait ms, oldest first."""
    try:
        from messyerraytracer_tpu_torch.utils.trace import requests
    except ImportError:
        return None
    t = ctx.trace
    if t is None or not t.units:
        return None
    spans = {}
    for rid, name, a, b in requests():
        spans.setdefault(rid, {})[name] = (b - a) / 1e6
    got = [s["service.submit"] - s.get("service.wait", 0.0)
           for s in spans.values() if "service.submit" in s]
    return got[-t.units:] or None


def read(ctx):
    ms = intervals(ctx)
    return None if ms is None else sum(ms) / len(ms)
