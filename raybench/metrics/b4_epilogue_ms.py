"""Device ms per cast call in the port's range ``cast`` other than
kernel B4's launches (range ``b4.launch``): the hit assembly after B4.
None where the slice holds no B4 launch."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.count("cast") or not t.count("b4.launch"):
        return None
    b4 = t.device_ms("b4.launch")
    if not b4:
        return None
    return (t.device_ms("cast") - b4) / t.count("cast")
