"""Device ms per cast call in the port's range ``cast`` other than
kernel B1's: the buffers B1 writes into and the hit assembly after it."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.count("cast") or not t.b1_us:
        return None
    return t.device_ms("cast") / t.count("cast")
