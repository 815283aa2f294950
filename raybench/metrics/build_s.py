"""Host clock around the program's scene build in set-up (tables and
kernel B1's cluster tables, waited for), s."""


def read(ctx):
    return ctx.build_s
