"""The window's seconds over the frames completed in it, ms."""


def read(ctx):
    return ctx.seconds / ctx.units * 1e3 if ctx.units else None
