"""All rays delivered in the window over all the window's seconds."""


def read(ctx):
    return ctx.rays / ctx.seconds / 1e6 if ctx.units else None
