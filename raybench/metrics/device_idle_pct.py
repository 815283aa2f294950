"""Share of the traced slice's wall time in which no kernel or copy ran
on the card: 100 * (1 - union of device intervals / wall), %."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_us <= 0 or t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
